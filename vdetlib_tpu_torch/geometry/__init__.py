from vdetlib_tpu_torch.geometry.boxes import (  # noqa: F401
    LEGACY_OFFSET,
    apply_deltas,
    box_area,
    box_center,
    box_wh,
    clip_boxes,
    elementwise_iou,
    encode_deltas,
    pairwise_iou,
    shift_boxes,
)
