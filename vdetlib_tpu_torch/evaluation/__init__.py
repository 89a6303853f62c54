"""Detection evaluation (numpy, host side): the VID mAP and the submission writer."""

from vdetlib_tpu_torch.evaluation.submission import (  # noqa: F401
    submission_lines,
    write_submission,
)
from vdetlib_tpu_torch.evaluation.vid_map import per_class_ap, vid_map  # noqa: F401
