"""Point-cloud primitives of the backbone, channels-last (``(B, N, C)``).

Counterpart of ``eda_tpu/ops/pointops.py``: furthest point sampling, batched
gathers, the gather SA's ball queries (``ball_query``: the first ``nsample``
in-radius points in index order, the reference's; ``ball_query_nearest``: the
``nsample`` nearest) and the three-nearest-neighbour interpolation of the FP
layers.
"""

from __future__ import annotations

import contextlib

import torch

from eda_tpu_torch.ops.cuda.fps import fps as furthest_point_sample  # noqa: F401


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m] = points[b, idx[b, m]]: (B, N, C), (B, M) -> (B, M, C)."""
    idx = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return points.gather(1, idx)


BIG = 1e10  # the squared distance of an out-of-radius point in ball_query_nearest
NEAREST_CHUNK = 4096  # points a ball_query_nearest pass takes, as the JAX package's chunk
FIRST_ELEMS = 1 << 24  # (center, point) pairs a ball_query pass holds at once


@contextlib.contextmanager
def _deterministic_kernels():
    """PyTorch's deterministic kernels inside the block (restored after)."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


class _GatherShared(torch.autograd.Function):
    """``gather_points`` whose backward adds the rows of a repeated index in a
    fixed order. PyTorch's gather backward adds them with atomics on CUDA, in
    an order that changes from run to run; its deterministic ``index_add_``
    sorts the indices first."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.shape = points.shape
        return gather_points(points, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, N, C = ctx.shape
        rows = (idx.long() + N * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
        with _deterministic_kernels():
            d = g.new_zeros((B * N, C)).index_add_(0, rows, g.reshape(-1, C))
        return d.view(B, N, C), None


def gather_shared(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``gather_points`` for indices that repeat (neighbourhoods, interpolation):
    the same values; the gradient summed in a fixed order."""
    if not (torch.is_grad_enabled() and points.requires_grad):
        return gather_points(points, idx)
    return _GatherShared.apply(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m, s] = points[b, idx[b, m, s]]: (B, N, C), (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather_shared(points, idx.reshape(B, M * S)).view(B, M, S, points.shape[-1])


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """The first ``nsample`` points in index order with squared distance below
    r^2 (``ball_query_gpu.cu:14-49``); slots past the hits repeat the first
    hit; a center with no hit gets index 0 throughout.

    One cumulative count and one scatter over the points, in chunks of
    centers (the JAX package takes ``nsample`` argmax passes instead).

    Returns:
        (B, M, nsample) int32.
    """
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    r2 = radius * radius
    out = torch.zeros((B, M, nsample), dtype=torch.int64, device=xyz.device)
    chunk = max(1, FIRST_ELEMS // max(1, B * N))
    cols = torch.arange(N, device=xyz.device)
    for m0 in range(0, M, chunk):
        m1 = min(M, m0 + chunk)
        hit = sq_dist(new_xyz[:, m0:m1], xyz) < r2  # (B, mc, N)
        slot = torch.cumsum(hit, -1) - 1
        keep = hit & (slot < nsample)
        # the kept hits to their slots; the others to a spare slot, dropped
        found = torch.zeros((B, m1 - m0, nsample + 1), dtype=torch.int64, device=xyz.device)
        found.scatter_(-1, torch.where(keep, slot, nsample), cols.expand_as(slot))
        count = keep.sum(-1, keepdim=True)  # (B, mc, 1)
        first = found[..., :1]
        pos = torch.arange(nsample, device=xyz.device)
        out[:, m0:m1] = torch.where(pos < count, found[..., :nsample], first)
    return out.int()


def _nearest_keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (d2, idx): d2 >= 0, so its f32 bits are monotone."""
    return (d2.contiguous().view(torch.int32).long() << 32) | idx


def ball_query_nearest(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                       nsample: int, chunk: int = NEAREST_CHUNK) -> torch.Tensor:
    """The ``nsample`` nearest points with squared distance below r^2, nearest
    first; equal distances go to the lower index, as ``lax.top_k`` orders
    them. Slots past the hits repeat the nearest hit; a center with no hit
    gets index 0 throughout (``eda_tpu/ops/pointops.py:ball_query_nearest``).

    The points are taken ``chunk`` at a time, a running best merged with
    each; the (d2, index) keys are unique, so every chunking gives the same
    indices.

    Returns:
        (B, M, nsample) int32.
    """
    B, N, _ = xyz.shape
    r2 = radius * radius
    best = None
    for n0 in range(0, N, chunk):
        n1 = min(N, n0 + chunk)
        d2 = sq_dist(new_xyz, xyz[:, n0:n1])
        d2 = torch.where(d2 < r2, d2, torch.full_like(d2, BIG))
        idx = torch.arange(n0, n1, device=xyz.device).expand_as(d2)
        keys = _nearest_keys(d2, idx)
        if best is not None:
            keys = torch.cat([best, keys], -1)
        best = torch.topk(keys, min(nsample, keys.shape[-1]), dim=-1, largest=False).values
    if best.shape[-1] < nsample:  # fewer points than nsample: the rest are out of radius
        best = torch.cat([best, best[..., :1].expand(-1, -1, nsample - best.shape[-1])], -1)
    d2 = (best >> 32).int().view(torch.float32)
    idx = best & 0xFFFFFFFF
    return torch.where(d2 < r2, idx, idx[..., :1]).int()


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
    gathered = gather_shared(features, idx.reshape(B, n * k)).view(B, n, k, -1)
    return (gathered * weight[..., None]).sum(2)


def interpolation_weights(dist2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights ``1 / (sqrt(d2) + eps)``, normalized over k."""
    recip = 1.0 / (torch.sqrt(dist2) + eps)
    return recip / recip.sum(-1, keepdim=True)
