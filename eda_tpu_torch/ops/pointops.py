"""Point-cloud primitives of the backbone, channels-last (``(B, N, C)``).

Counterpart of ``eda_tpu/ops/pointops.py``: furthest point sampling, batched
gathers and the three-nearest-neighbour interpolation of the FP layers.
"""

from __future__ import annotations

import torch

from eda_tpu_torch.ops.cuda.fps import fps as furthest_point_sample  # noqa: F401


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m] = points[b, idx[b, m]]: (B, N, C), (B, M) -> (B, M, C)."""
    idx = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return points.gather(1, idx)


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (B, n, 3) x (B, m, 3) -> (B, n, m), in f32.

    The ``|a|^2 + |b|^2 - 2ab`` expansion of the JAX package; the cross term is
    a full-f32 matmul (TF32 must be off on the card).
    """
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    cross = a @ b.transpose(-1, -2)
    return torch.clamp(a2 + b2 - 2.0 * cross, min=0.0)


def three_nn(unknown: torch.Tensor, known: torch.Tensor, k: int = 3):
    """k nearest known points of each unknown point.

    Returns (dist2, idx): (B, n, k) squared distances, ascending, and int32
    indices; ties go to the lowest index.
    """
    d2 = sq_dist(unknown.float(), known.float())
    m = d2.shape[-1]
    if m < k:
        raise ValueError(f"three-NN needs at least k={k} known points, got m={m}")
    cols = torch.arange(m, device=d2.device).expand_as(d2)
    big = torch.full_like(cols, m)
    inf = torch.full_like(d2, float("inf"))
    dists, idxs = [], []
    for _ in range(k):
        dmin = d2.amin(-1, keepdim=True)
        imin = torch.where(d2 <= dmin, cols, big).amin(-1, keepdim=True)
        dists.append(dmin)
        idxs.append(imin)
        d2 = torch.where(cols == imin, inf, d2)
    return torch.cat(dists, -1), torch.cat(idxs, -1).int()


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor):
    """Weighted k-point interpolation: (B, m, C), (B, n, k), (B, n, k) -> (B, n, C)."""
    B, n, k = idx.shape
    gathered = gather_points(features, idx.reshape(B, n * k)).view(B, n, k, -1)
    return (gathered * weight[..., None]).sum(2)


def interpolation_weights(dist2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights ``1 / (sqrt(d2) + eps)``, normalized over k."""
    recip = 1.0 / (torch.sqrt(dist2) + eps)
    return recip / recip.sum(-1, keepdim=True)
