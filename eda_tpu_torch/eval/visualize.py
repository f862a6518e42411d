"""Scene exports for viewing: the coloured cloud and boxes in one PLY.

The port's copy of ``eda_tpu/eval/visualize.py``: the scene's points (grey
without colours) and each box drawn as points along its 12 edges, the GT
boxes green and the predicted boxes red, written by ``data/ply.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from eda_tpu_torch.data.ply import write_ply_vertices

_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),
    (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _box_edge_points(box: np.ndarray, samples: int = 32) -> np.ndarray:
    """cxcyczwhd box -> points sampled along its 12 edges."""
    center, half = box[:3], box[3:] / 2
    signs = np.array(
        [[x, y, z] for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)],
        np.float32,
    )
    corners = center + half * signs
    pts = []
    for a, b in _EDGES:
        t = np.linspace(0, 1, samples)[:, None]
        pts.append(corners[a] * (1 - t) + corners[b] * t)
    return np.concatenate(pts)


def export_scene(
    path: str,
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    gt_boxes: Optional[Sequence[np.ndarray]] = None,
    pred_boxes: Optional[Sequence[np.ndarray]] = None,
):
    """Write the scene and its boxes to one coloured binary PLY; returns ``path``.

    Args:
        xyz: (N, 3); rgb: (N, 3) in [0, 1] (grey by default).
        gt_boxes: cxcyczwhd boxes drawn green; pred_boxes drawn red.
    """
    xyz = np.asarray(xyz, np.float32)
    if rgb is None:
        rgb = np.full_like(xyz, 0.6)
    rgb = np.asarray(rgb, np.float32)

    all_xyz = [xyz]
    all_rgb = [rgb]
    for boxes, color in ((gt_boxes, (0, 1, 0)), (pred_boxes, (1, 0, 0))):
        for box in boxes or []:
            pts = _box_edge_points(np.asarray(box, np.float32))
            all_xyz.append(pts)
            all_rgb.append(np.tile(np.asarray(color, np.float32), (len(pts), 1)))

    pts = np.concatenate(all_xyz)
    cols = (np.clip(np.concatenate(all_rgb), 0, 1) * 255).astype(np.uint8)
    write_ply_vertices(
        path,
        {
            "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
            "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2],
        },
    )
    return path
