"""JSON protocol layer of the port: the codec, accessors and array bridges,
copied from ``vdetlib_tpu.protos`` so the port imports nothing of the JAX
package."""

from vdetlib_tpu_torch.protos.accessors import (  # noqa: F401
    boxes_at_frame,
    det_boxes_at_frame,
    det_class_indices,
    det_score,
    det_scores_at_frame,
    dets_at_frame,
    empty_det_from_box,
    frame_ids,
    frame_path_after,
    frame_path_at,
    frame_path_before,
    score_proto_from_track_proto,
    top_detections,
    track_box_at_frame,
    tracks_at_frame,
    tracks_proto_from_boxes,
)
from vdetlib_tpu_torch.protos.arrays import (  # noqa: F401
    arrays_to_det_proto,
    arrays_to_track_proto,
    box_proto_to_arrays,
    det_proto_to_arrays,
    track_proto_to_arrays,
)
from vdetlib_tpu_torch.protos.codec import proto_dump, proto_exists, proto_load  # noqa: F401
