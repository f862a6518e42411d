"""Point-cloud operators and the fused set abstraction."""

from eda_tpu_torch.ops.boxes import (  # noqa: F401
    box_center_to_corner,
    box_cxcyczwhd_to_xyzxyz,
    box_iou_3d,
    box_volume,
    generalized_box_iou_3d,
    pairwise_box_iou_3d,
)
