"""Train-time point-cloud augmentation on the host (numpy).

The port's own copy of ``eda_tpu/data/augment.py``: a z-rotation (multiples
of 90 degrees within 5 degrees, with x and y flips) where the utterance is not
view-dependent, small x and y rotations (2.5 degrees), positive noise of
5e-3, a shift of up to 0.5, a scale of 0.98-1.02, and per-point colour jitter
around the dataset's mean RGB. Boxes follow the same rigid transform.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from eda_tpu_torch.data.vocab import VIEW_DEP_RELS, find_rel

MEAN_RGB = np.array([109.8, 97.2, 83.8], np.float32) / 256.0

VIEW_DEP_WORDS = (
    "front", "behind", "back", "right", "left", "facing", "leftmost",
    "rightmost", "looking", "across",
)


def is_view_dependent(utterance: str) -> bool:
    """The evaluation's view-dependence flag: a view word among the utterance's words."""
    words = set(utterance.split())
    return any(w in words for w in VIEW_DEP_WORDS)


def rotate_natural(utterance: str) -> bool:
    """The nr3d / scanrefer rotation gate, a substring test (an utterance that
    starts with a view word still rotates)."""
    padded = utterance + " "
    return not any(f" {w} " in padded for w in VIEW_DEP_WORDS)


def rotate_sr3d(utterance: str) -> bool:
    """The sr3d rotation gate: the utterance's relation is not view-dependent."""
    return find_rel(utterance) not in VIEW_DEP_RELS


def _rot(theta_deg: float, axis: int) -> np.ndarray:
    t = np.deg2rad(theta_deg)
    c, s = np.cos(t), np.sin(t)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s if axis != 1 else s
    m[j, i] = s if axis != 1 else -s
    return m


@dataclasses.dataclass
class Augmentation:
    """A sampled rigid transform, applicable to points and boxes."""

    rotation: np.ndarray  # (3, 3), Ry @ Rx @ Rz
    flip_x: bool
    flip_y: bool
    shift: np.ndarray  # (3,)
    scale: float

    def apply_points(self, xyz: np.ndarray, noise: Optional[np.ndarray] = None) -> np.ndarray:
        """Flips, rotation, noise, shift, scale, in that order (the noise is scaled too)."""
        out = xyz.copy()
        if self.flip_x:
            out[:, 0] = -out[:, 0]
        if self.flip_y:
            out[:, 1] = -out[:, 1]
        out = out @ self.rotation.T
        if noise is not None:
            out = out + noise
        return (out + self.shift) * self.scale

    def apply_boxes(self, boxes: np.ndarray) -> np.ndarray:
        """cxcyczwhd boxes through the points' transform: the axis-aligned box
        of the eight transformed corners."""
        out = boxes.copy()
        centers, sizes = out[:, :3], out[:, 3:]
        corners = np.stack(
            [
                centers + sizes / 2 * np.array(sgn)
                for sgn in [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
            ],
            axis=1,
        )  # (N, 8, 3)
        flat = corners.reshape(-1, 3)
        if self.flip_x:
            flat[:, 0] = -flat[:, 0]
        if self.flip_y:
            flat[:, 1] = -flat[:, 1]
        flat = (flat @ self.rotation.T + self.shift) * self.scale
        corners = flat.reshape(-1, 8, 3)
        mn, mx = corners.min(1), corners.max(1)
        return np.concatenate([(mn + mx) / 2, mx - mn], -1)


def sample_augmentation(rng: np.random.Generator, rotate: bool) -> Augmentation:
    """Draw one transform from ``rng`` (the draws' order is part of the contract)."""
    if rotate:
        theta_z = 90 * rng.integers(0, 4) + (2 * rng.random() - 1) * 5
        flip_x = rng.random() > 0.5
        flip_y = rng.random() > 0.5
    else:
        theta_z = (2 * rng.random() - 1) * 5
        flip_x = flip_y = False
    theta_x = (2 * rng.random() - 1) * 2.5
    theta_y = (2 * rng.random() - 1) * 2.5
    rotation = _rot(theta_y, 1) @ _rot(theta_x, 0) @ _rot(float(theta_z), 2)
    return Augmentation(
        rotation=rotation,
        flip_x=bool(flip_x),
        flip_y=bool(flip_y),
        shift=rng.random(3) - 0.5,
        scale=0.98 + 0.04 * rng.random(),
    )


def augment_scene(
    rng: np.random.Generator,
    xyz: np.ndarray,
    color: Optional[np.ndarray],
    boxes: np.ndarray,
    rotate: bool,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, Augmentation]:
    """Augment points, colours and boxes together; the transform is returned
    too, for other box streams (the detected boxes)."""
    aug = sample_augmentation(rng, rotate)
    new_xyz = aug.apply_points(xyz, noise=rng.random((len(xyz), 3)) * 5e-3)
    new_boxes = aug.apply_boxes(boxes)
    new_color = color
    if color is not None:
        new_color = (color + MEAN_RGB) * (0.98 + 0.04 * rng.random((len(color), 3))) - MEAN_RGB
    return new_xyz.astype(np.float32), new_color, new_boxes.astype(np.float32), aug
