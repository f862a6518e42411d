"""The pair pool kernel's parallel max and winner combine, mirrored in torch on the CPU.

``csrc/sa_pair_pool.cu`` reduces each (center, channel)'s window in no window
order: a thread's two GEMM rows, then the 8 lanes of a column group (a
butterfly over lane bits 16, 8, 4), then the 64-point chunks as a running
value, then the 4 warps. Every combine keeps the larger (value, position) pair
under the TPU kernel's tie rule as a total order: the larger value, then the
earlier tile of ``min(128, W)`` points, then the later position. This file
mirrors that combine and runs it in the kernel's order and in random orders
(axes in any order, each axis reduced by a random tree over a random
permutation). On inputs quantized so that exact ties are common, every order
must give the plain version's values and winners exactly
(``sa_pair_pool_winners_plain``), for a window of two 128-point tiles, a
window under 128 points (the tiny config's last layers), a ragged one, and one
cut in stages as the kernel cuts a window wider than its shared memory holds.
"""

import numpy as np
import pytest
import torch

from eda_tpu_torch.ops.cuda import sa_kernel
from eda_tpu_torch.ops.cuda.sa_prep import bf16_round, ln_one_pass

ROWS = 64  # window points per GEMM tile
RADIUS = float(np.sqrt(0.0913))
T = torch.from_numpy


def _inputs(seed, W, B=2, N=512, M=64, c1=16, c2=16, c3=32):
    """Pool inputs whose pair values repeat: h1 = bf16(LN * 2^-6 + 1) takes a
    few values per channel, and each output channel sums one or two of them.
    Every sum is exact, so the plain version and ``_pair_values`` agree."""
    rng = np.random.default_rng(seed)
    xyz = np.sort((rng.integers(-20, 20, (B, N, 3)) * 0.05).astype(np.float32), axis=1)
    ranks = np.stack([np.sort(rng.permutation(N)[:M]) for _ in range(B)])
    cen = np.take_along_axis(xyz, ranks[..., None], 1)
    cen[:, 16:32] += 100.0  # block 1 out of reach: -1e9 rows, rank 0
    starts = np.clip(ranks.reshape(B, M // 16, 16)[:, :, 8] - W // 2, 0, N - W).astype(np.int32)
    w3 = np.zeros((c2, c3), np.float32)
    for j in range(c3):
        w3[rng.choice(c2, size=1 + j % 2, replace=False), j] = 1.0
    return (T(rng.integers(-8, 8, (B, N, c1)).astype(np.float32) / 8).bfloat16(), T(xyz),
            T(rng.integers(-8, 8, (B, M, c1)).astype(np.float32) / 8).bfloat16(), T(cen),
            T(starts), T(rng.integers(-2, 3, (c1, c2)).astype(np.float32)),
            T(rng.integers(-4, 4, c2).astype(np.float32) / 4), torch.full((c2,), 2.0 ** -6),
            torch.ones(c2), T(w3), T(rng.integers(-4, 4, c3).astype(np.float32) / 16))


def _pair_values(args, window):
    """(B, M, W, c3) z of every (center, window point) pair, -inf out of
    radius, computed as the plain version computes it (one chunk)."""
    A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3 = args
    B, N, c1 = A.shape
    M = b_c.shape[1]
    nb = M // 16
    starts = sa_kernel.window_starts(starts.long(), N, window)
    pos = (starts[..., None] + torch.arange(window)).reshape(B, nb * window, 1)
    a_w = A.float().gather(1, pos.expand(-1, -1, c1)).view(B, nb, 1, window, c1)
    h = bf16_round(torch.relu(a_w + b_c.float().view(B, nb, 16, 1, c1)))
    h = bf16_round(torch.relu(ln_one_pass(h @ bf16_round(w2) + b2, s2, lb2)))
    z = h @ bf16_round(w3) + b3
    x_w = xyz.gather(1, pos.expand(-1, -1, 3)).view(B, nb, 1, window, 3)
    r2 = torch.tensor(RADIUS * RADIUS, dtype=torch.float32).item()
    keep = sa_kernel._in_radius(x_w, cen_xyz.view(B, nb, 16, 1, 3), r2, "pair")
    z = torch.where(keep[..., None], z, torch.tensor(float("-inf")))
    return z.reshape(B, M, window, -1), starts.repeat_interleave(16, dim=1)


def _rank(pos, window):
    """The kernel's position rank q: larger is better among equal values."""
    wc = min(128, window)
    nt = -(-window // wc)
    return (nt - 1 - pos // wc) * wc + pos % wc


def _combine(a, b):
    (va, qa), (vb, qb) = a, b
    take = (vb > va) | ((vb == va) & (qb > qa))
    return torch.where(take, vb, va), torch.where(take, qb, qa)


def _reduce(items, rng):
    """Combine a list of (v, q) in a random tree over a random permutation;
    ``rng`` None folds them in order (the kernel's running chunk and warp
    combines)."""
    if rng is None:
        out = items[0]
        for item in items[1:]:
            out = _combine(out, item)
        return out
    items = [items[i] for i in rng.permutation(len(items))]
    while len(items) > 1:
        i = int(rng.integers(len(items) - 1))
        items[i:i + 2] = [_combine(items[i], items[i + 1])]
    return items[0]


def _butterfly(v, q, axis):
    """The lanes' transposing butterfly over g: pairs at xor 4, then 2, then 1."""
    for m in (4, 2, 1):
        idx = torch.arange(v.shape[axis])
        lo = idx[(idx & m) == 0]
        v, q = _combine((v.index_select(axis, lo), q.index_select(axis, lo)),
                        (v.index_select(axis, lo + m), q.index_select(axis, lo + m)))
    return v, q


def _mirror(z, window, rng=None, stage=None):
    """(best (B, M, c3), window position (B, M, c3)) of the kernel's combine;
    ``rng`` None runs it in the kernel's order. ``stage`` (a multiple of 64)
    cuts the window into the kernel's shared-memory stages, each reduced on its
    own and carried into the next."""
    wp = -(-window // ROWS) * ROWS
    v = torch.nn.functional.pad(z, (0, 0, 0, wp - window), value=float("-inf"))
    q = _rank(torch.arange(wp), window)[:, None].expand_as(v)
    stages = []
    for s0 in range(0, wp, stage or wp):
        n = min(stage or wp, wp - s0)
        # (B, M, chunk, warp, half, g, c3): GEMM row r = 16 warp + 8 half + g of chunk k
        vs = v[:, :, s0:s0 + n].unflatten(2, (n // ROWS, 4, 2, 8))
        qs = q[:, :, s0:s0 + n].unflatten(2, (n // ROWS, 4, 2, 8))
        # the kernel: a thread's two rows (half), the lanes (g), the chunks in
        # window order, the warps in order; every reduced axis is kept as size 1
        axes = [4, 5, 2, 3] if rng is None else [int(a) for a in rng.permutation([2, 3, 4, 5])]
        for axis in axes:
            if axis == 5 and rng is None:
                vs, qs = _butterfly(vs, qs, axis)
            else:
                items = [(vs.narrow(axis, i, 1), qs.narrow(axis, i, 1))
                         for i in range(vs.shape[axis])]
                vs, qs = _reduce(items, rng)
        stages.append((vs.flatten(2, 5).squeeze(2), qs.flatten(2, 5).squeeze(2)))
    v, q = _reduce(stages, rng)  # the kernel: the stages in window order
    wc = min(128, window)
    nt = -(-window // wc)
    return v, (nt - 1 - q // wc) * wc + q % wc


@pytest.mark.parametrize("window,stage", [(256, None), (64, None), (200, None), (448, 192)])
def test_parallel_combine_gives_the_plain_winners(window, stage):
    args = _inputs(0, window)
    kw = {"radius": RADIUS, "window": window, "d2_mode": "pair"}
    want_v, want_w = sa_kernel.sa_pair_pool_winners_plain(*args, **kw)
    z, starts = _pair_values(args, window)
    hit = torch.isfinite(z).any(2)
    best = z.amax(2)
    ties = ((z == best[:, :, None]) & hit[:, :, None]).sum(2) > 1
    assert ties.float().mean() > 0.3 and (~hit).any() and hit.any()  # ties are common
    for seed in (None, 1, 2, 3, 4):
        rng = None if seed is None else np.random.default_rng(seed)
        v, pos = _mirror(z, window, rng, stage)
        got_v = torch.where(torch.isfinite(v), v, torch.tensor(sa_kernel.NEG))
        got_w = torch.where(torch.isfinite(v), starts[..., None] + pos, 0).int()
        assert torch.equal(got_v, want_v), seed
        assert torch.equal(got_w, want_w), seed

