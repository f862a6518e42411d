"""Axis-aligned 3D box geometry (counterpart of ``eda_tpu/ops/boxes.py``).

Boxes come as ``cxcyczwhd`` (center and extents, the network's output) or as
``xyzxyz`` (min corner, max corner), where the IoU math happens. Degenerate
extents are clamped to 1e-6, as the JAX package does.
"""

from __future__ import annotations

import torch

MIN_EXTENT = 1e-6


def box_cxcyczwhd_to_xyzxyz(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 6) center/extent boxes -> (..., 6) min/max corners."""
    center = boxes[..., 0:3]
    extent = torch.clamp(boxes[..., 3:6], min=MIN_EXTENT)
    return torch.cat([center - 0.5 * extent, center + 0.5 * extent], -1)


def box_volume(boxes: torch.Tensor) -> torch.Tensor:
    extent = boxes[..., 3:6] - boxes[..., 0:3]
    return extent[..., 0] * extent[..., 1] * extent[..., 2]


def _prod3(whd: torch.Tensor) -> torch.Tensor:
    return whd[..., 0] * whd[..., 1] * whd[..., 2]


def pairwise_box_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """(iou, union), each (..., N, M), of xyzxyz boxes (..., N, 6) and (..., M, 6)."""
    lo = torch.maximum(boxes1[..., :, None, 0:3], boxes2[..., None, :, 0:3])
    hi = torch.minimum(boxes1[..., :, None, 3:6], boxes2[..., None, :, 3:6])
    inter = _prod3(torch.clamp(hi - lo, min=0.0))
    union = box_volume(boxes1)[..., :, None] + box_volume(boxes2)[..., None, :] - inter
    return inter / torch.clamp(union, min=MIN_EXTENT), union


def generalized_box_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU = IoU - (hull - union) / hull of xyzxyz boxes, (..., N, M)."""
    iou, union = pairwise_box_iou_3d(boxes1, boxes2)
    lo = torch.minimum(boxes1[..., :, None, 0:3], boxes2[..., None, :, 0:3])
    hi = torch.maximum(boxes1[..., :, None, 3:6], boxes2[..., None, :, 3:6])
    hull = _prod3(torch.clamp(hi - lo, min=0.0))
    return iou - (hull - union) / torch.clamp(hull, min=MIN_EXTENT)
