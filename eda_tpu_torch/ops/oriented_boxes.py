"""Oriented (heading-angle) 3D box IoU via polygon clipping.

The port's copy of ``eda_tpu/ops/oriented_boxes.py``: a numpy port of the reference ``utils/box_util.py`` capabilities
(Sutherland-Hodgman polygon clipping, convex polygon area, oriented
``box3d_iou``, ``get_3d_box`` corner expansion). The grounding pipeline is
axis-aligned (heading is always 0 — see ``models/ap_helper.py``'s
``heading_angle = 0``), so these are used by detection evaluation only when
oriented boxes appear.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def polygon_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clipping of a 2D polygon by a convex polygon.

    Args:
        subject: (N, 2) polygon vertices; clip: (M, 2) convex clip polygon
        (counter-clockwise).

    Returns:
        (K, 2) clipped polygon vertices (possibly empty).
    """
    output: List[np.ndarray] = list(subject)
    cp1 = clip[-1]
    for cp2 in clip:
        if not output:
            return np.zeros((0, 2))
        input_list = output
        output = []
        s = input_list[-1]

        def inside(p):
            # inclusive (boundary counts as inside): exact self-overlap and
            # shared edges clip cleanly instead of emitting degenerate
            # intersection points
            return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) - (cp2[1] - cp1[1]) * (
                p[0] - cp1[0]
            ) >= -1e-9

        def intersection(a, b):
            dc = cp1 - cp2
            dp = a - b
            n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
            n2 = a[0] * b[1] - a[1] * b[0]
            n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0] + 1e-12)
            return np.array(
                [(n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3]
            )

        for e in input_list:
            if inside(e):
                if not inside(s):
                    output.append(intersection(s, e))
                output.append(e)
            elif inside(s):
                output.append(intersection(s, e))
            s = e
        cp1 = cp2
    return np.asarray(output)


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of a 2D polygon."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(
        np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))
    )


def get_3d_box(
    box_size: Sequence[float], heading_angle: float, center: Sequence[float]
) -> np.ndarray:
    """(8, 3) corners of an oriented box (z-up, heading about z)."""
    l, w, h = box_size
    c, s = np.cos(heading_angle), np.sin(heading_angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    x = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * l / 2
    y = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * w / 2
    z = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * h / 2
    corners = (rot @ np.stack([x, y, z])).T + np.asarray(center)
    return corners


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray) -> Tuple[float, float]:
    """(IoU 3D, IoU of the BEV footprint) for oriented boxes.

    corners: (8, 3) in get_3d_box order (first four = top face).
    """
    rect1 = corners1[:4, :2]
    rect2 = corners2[:4, :2]
    inter_poly = polygon_clip(rect1, rect2[::-1])
    inter_area = polygon_area(inter_poly)
    area1 = polygon_area(rect1)
    area2 = polygon_area(rect2)
    iou_2d = inter_area / max(area1 + area2 - inter_area, 1e-9)

    zmax = min(corners1[0, 2], corners2[0, 2])
    zmin = max(corners1[4, 2], corners2[4, 2])
    inter_vol = inter_area * max(0.0, zmax - zmin)
    vol1 = area1 * abs(corners1[0, 2] - corners1[4, 2])
    vol2 = area2 * abs(corners2[0, 2] - corners2[4, 2])
    iou = inter_vol / max(vol1 + vol2 - inter_vol, 1e-9)
    return float(iou), float(iou_2d)
