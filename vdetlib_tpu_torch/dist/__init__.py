"""Distribution layer — device meshes, video-set sharding, metric reduction,
over ``torch.distributed``."""

from vdetlib_tpu_torch.dist.sharding import (  # noqa: F401
    make_mesh,
    psum_metrics,
    replicate,
    shard_batch,
    shard_videos,
)
