"""Spatial reordering of point clouds: cell keys, a sort by cell, center ranks, window starts.

The port's counterpart of ``eda_tpu/ops/spatial.py``. Points sorted by their
spatial cell put the neighbourhood of radius r of most points into a
contiguous window of the sorted array, so a neighbourhood op can read slices
instead of scattered rows. ``sort_by_cell`` sorts stably, as the reference's
multi-operand ``lax.sort`` orders equal keys on the CPU; ``center_ranks`` is
the reference's joint sort as ``torch.searchsorted``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eda_tpu_torch.ops.pointops import gather_points


class SortedScene(NamedTuple):
    """A spatially sorted point set.

    keys: (B, N) int32 cell keys, ascending per row.
    xyz: (B, N, 3) coordinates in sorted order.
    features: (B, N, C) features in sorted order (C may be 0).
    perm: (B, N) int32 original index of each sorted position.
    """

    keys: torch.Tensor
    xyz: torch.Tensor
    features: torch.Tensor
    perm: torch.Tensor


def cell_keys(xyz: torch.Tensor, cell_size: float, origin: float = -50.0,
              grid: int = 1024) -> torch.Tensor:
    """Row-major cell key per point, x the major digit: (..., 3) -> (...,) int32.

    The cell coordinate is ``floor((xyz - origin) / cell_size)`` as XLA
    compiles it (a product with the f32 reciprocal of ``cell_size``, as
    ``fused_sa.morton_keys``), clipped to [0, grid - 1].
    """
    inv = torch.tensor(cell_size, dtype=torch.float32).reciprocal().to(xyz.device)
    cells = torch.floor((xyz.float() - origin) * inv).clamp(0, grid - 1).long()
    return ((cells[..., 0] * grid + cells[..., 1]) * grid + cells[..., 2]).int()


def sort_by_cell(xyz: torch.Tensor, features: torch.Tensor, cell_size: float) -> SortedScene:
    """Sort points and their features by cell key, stably.

    Args:
        xyz: (B, N, 3); features: (B, N, C) (C may be 0).
    """
    keys, perm = torch.sort(cell_keys(xyz, cell_size), dim=1, stable=True)
    return SortedScene(keys, gather_points(xyz, perm), gather_points(features, perm), perm.int())


def center_ranks(point_keys: torch.Tensor, center_keys: torch.Tensor) -> torch.Tensor:
    """(B, M) int32: for each center key, the number of sorted point keys
    strictly below it (its insertion rank, ``searchsorted`` left).

    Args:
        point_keys: (B, N) ascending keys of the sorted points.
        center_keys: (B, M) keys of the centers.
    """
    return torch.searchsorted(point_keys.contiguous(), center_keys.contiguous(),
                              side="left").int()


def window_starts(ranks: torch.Tensor, n_points: int, window: int) -> torch.Tensor:
    """Start of a ``window``-long slice centered on each rank, clamped to the cloud."""
    return torch.clamp(ranks - window // 2, 0, max(n_points - window, 0)).int()
