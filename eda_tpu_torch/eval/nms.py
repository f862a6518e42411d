"""Axis-aligned 3D NMS (host-side numpy, used by the detection-AP path).

The port's copy of ``eda_tpu/eval/nms.py``.

Vectorized equivalents of ``utils/nms.py:62-163`` (``nms_3d_faster`` and the
class-aware ``nms_3d_faster_samecls``): greedy suppression in score order
where suppression uses IoU against the running box's volume-normalized
overlap. ``old_type=False`` semantics (true IoU), the configuration the
reference uses from ``models/ap_helper.py:192-213``.
"""

from __future__ import annotations

import numpy as np


def _iou_one_vs_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """box (6,) [x0 y0 z0 x1 y1 z1] vs boxes (N, 6) -> IoU (N,)."""
    lo = np.maximum(box[:3], boxes[:, :3])
    hi = np.minimum(box[3:], boxes[:, 3:])
    whd = np.clip(hi - lo, 0, None)
    inter = whd.prod(-1)
    va = np.prod(box[3:] - box[:3])
    vb = np.prod(boxes[:, 3:] - boxes[:, :3], -1)
    return inter / np.maximum(va + vb - inter, 1e-9)


def _iou_2d_one_vs_many(
    box: np.ndarray, boxes: np.ndarray, old_type: bool
) -> np.ndarray:
    """box (4,) [x0 y0 x1 y1] vs boxes (N, 4) -> overlap (N,)."""
    lo = np.maximum(box[:2], boxes[:, :2])
    hi = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh.prod(-1)
    vb = np.prod(boxes[:, 2:] - boxes[:, :2], -1)
    if old_type:
        # legacy mode: intersection over the CANDIDATE's area
        # (utils/nms.py:12-41 nms_2d and nms_2d_faster old_type=True)
        return inter / np.maximum(vb, 1e-9)
    va = np.prod(box[2:] - box[:2])
    return inter / np.maximum(va + vb - inter, 1e-9)


def nms_2d(
    boxes: np.ndarray,
    scores: np.ndarray,
    overlap_threshold: float,
    old_type: bool = False,
) -> np.ndarray:
    """Greedy 2D NMS (``utils/nms.py:12-84``: nms_2d / nms_2d_faster).

    boxes (N, 4) corner-format [x0 y0 x1 y1]; returns kept indices in
    descending score order. ``old_type=True`` reproduces the legacy
    candidate-area normalization; ``False`` is true IoU. The reference never
    calls either from its eval path (``ap_helper.py`` uses the 3D variants);
    provided for surface completeness.
    """
    order = np.argsort(-scores)
    keep = []
    alive = np.ones(len(boxes), bool)
    for idx in order:
        if not alive[idx]:
            continue
        keep.append(idx)
        alive[idx] = False
        if not alive.any():
            break
        cand = np.where(alive)[0]
        o = _iou_2d_one_vs_many(boxes[idx], boxes[cand], old_type)
        alive[cand[o > overlap_threshold]] = False
    return np.asarray(keep, np.int64)


def nms_3d(
    boxes: np.ndarray,
    scores: np.ndarray,
    iou_threshold: float,
    classes: np.ndarray | None = None,
) -> np.ndarray:
    """Greedy 3D NMS. boxes (N, 6) corner-format; returns kept indices.

    With ``classes`` given, only same-class boxes suppress each other
    (``nms_3d_faster_samecls``, utils/nms.py:120-163).
    """
    order = np.argsort(-scores)
    keep = []
    alive = np.ones(len(boxes), bool)
    for idx in order:
        if not alive[idx]:
            continue
        keep.append(idx)
        alive[idx] = False
        if not alive.any():
            break
        cand = np.where(alive)[0]
        iou = _iou_one_vs_many(boxes[idx], boxes[cand])
        suppress = iou > iou_threshold
        if classes is not None:
            suppress &= classes[cand] == classes[idx]
        alive[cand[suppress]] = False
    return np.asarray(keep, np.int64)
