"""Host-side Morton presorting of point clouds.

The fused SA layer wants points in Z-order so that ball neighbourhoods are
contiguous windows (``ops/fused_sa.py``). The cloud is static per example, so
the input pipeline sorts it once on the host and the model runs with
``points_presorted=True``. Any per-point array (colours, instance labels) is
permuted together with the coordinates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def morton_keys_np(xyz: np.ndarray, cell_size: float, origin: float = -50.0) -> np.ndarray:
    """Z-order key per point: interleaved 10-bit cell coordinates, (..., 3) -> (...,) int32."""
    cells = np.clip(
        np.floor((xyz - origin) / cell_size).astype(np.uint32), 0, 1023
    )

    def spread(v):
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    key = (
        spread(cells[..., 0])
        | (spread(cells[..., 1]) << 1)
        | (spread(cells[..., 2]) << 2)
    )
    return key.astype(np.int32)


def morton_sort(
    xyz: np.ndarray, *arrays: np.ndarray, cell_size: float = 0.2
) -> Tuple[np.ndarray, ...]:
    """Sort a point cloud (N, 3) and aligned (N, ...) arrays into Morton order."""
    order = np.argsort(morton_keys_np(xyz, cell_size), kind="stable")
    return (xyz[order],) + tuple(a[order] for a in arrays)
