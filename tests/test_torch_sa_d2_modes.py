"""The radius-test modes ``mxu`` (K8) and ``pre`` (K9a mask, K9b pool) of the
port against the JAX Pallas kernels in interpret mode.

* ``resolve_d2_mode`` resolves as ``eda_tpu``'s ``_resolve_d2_mode``: the
  keyword, then ``EDA_SA_D2``, then ``pair``, on every call.
* The plain pool under ``mxu`` and ``pre`` (the latter fed the port's own
  mask), with and without winners, against ``sa_pair_pool_pallas(d2_mode=...,
  interpret=True)``: values within 0.03 (``tests/test_sa_kernel_interpret.py:57``),
  identical -1e9 rows and identical winners. Some points are copies of
  others, in the same 128-row tile and in the next, so pooled values tie
  exactly and the winners' tie rule is exercised.
* The plain mask against ``sa_radius_mask(interpret=True)``, bit for bit
  through the TPU layout's offsets: ``port[b, j, w] == pen[b, j, offs[b, j] + w]``,
  with windows that start at ``N - W``, at 0 and at multiples of 16 that are
  not multiples of 128; also on unquantized coordinates with pairs within
  1e-5 of the flagship radii.
* At exact ties (r^2 equal to a pair's f32 expansion) the mask and the
  ``mxu`` test decide by the sum in the stated order, without fused
  multiply-adds, as the CUDA kernels do. (XLA's CPU dot, which the
  interpreted Pallas kernels use, accumulates with fused multiply-adds.)

Unless stated otherwise, coordinates sit on a 0.05 grid and r^2 = 0.4113 is
off the grid's d2 values, so no pair lies within rounding of the radius and
every mode decides every pair alike.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bf16, compiled

from eda_tpu.ops.pallas import sa_kernel as SK
from eda_tpu.ops.pallas.sa_mask import sa_radius_mask as jax_mask
from eda_tpu_torch.ops.cuda import sa_kernel as port_pool
from eda_tpu_torch.ops.cuda import sa_mask as port_mask

R2 = 0.4113
RADIUS = float(np.sqrt(R2))
T = torch.from_numpy


def test_resolve_d2_mode_matches_jax(monkeypatch):
    cases = [(None, None), ("mxu", None), ("pre", None), (None, "mxu"), ("pair", "mxu"),
             (None, "pre"), ("mxu", "pre")]
    for keyword, env in cases:
        if env is None:
            monkeypatch.delenv("EDA_SA_D2", raising=False)
        else:
            monkeypatch.setenv("EDA_SA_D2", env)
        assert port_pool.resolve_d2_mode(keyword) == SK._resolve_d2_mode(keyword)
    monkeypatch.delenv("EDA_SA_D2", raising=False)
    assert port_pool.resolve_d2_mode() == "pair"
    monkeypatch.setenv("EDA_SA_D2", "pre")
    assert port_pool.resolve_d2_mode() == "pre"  # read anew, nothing cached
    for bad_env, bad_keyword in (("bogus", None), (None, "MXU")):
        if bad_env:
            monkeypatch.setenv("EDA_SA_D2", bad_env)
        with pytest.raises(ValueError):
            port_pool.resolve_d2_mode(bad_keyword)
        with pytest.raises(ValueError):
            SK._resolve_d2_mode(bad_keyword)


def _inputs(seed, N, M, W, widths, extent):
    rng = np.random.default_rng(seed)
    B = 2
    c1, c2, c3 = widths
    xyz = np.sort((rng.integers(-extent, extent, (B, N, 3)) * 0.05).astype(np.float32), axis=1)
    A = bf16(rng.normal(size=(B, N, c1)))
    # exact copies: ties inside a 128-row tile (+3) and across tiles (+130)
    for src in range(0, N - 130, 37):
        for dst in (src + 3, src + 130):
            xyz[:, dst], A[:, dst] = xyz[:, src], A[:, src]
    ranks = np.stack([np.sort(rng.permutation(N)[:M]) for _ in range(B)])
    cen = np.take_along_axis(xyz, ranks[..., None], 1)
    b_c = bf16(rng.normal(size=(B, M, c1)))
    params = [(rng.normal(size=(c1, c2)) * 0.4), rng.normal(size=c2) * 0.1,
              1 + 0.1 * rng.normal(size=c2), 0.1 * rng.normal(size=c2),
              rng.normal(size=(c2, c3)) * 0.4, rng.normal(size=c3) * 0.1]
    params = [p.astype(np.float32) for p in params]
    mids = ranks.reshape(B, M // 16, 16)[:, :, 8]
    starts = np.clip(mids - W // 2, 0, N - W).astype(np.int32)
    return A, xyz, b_c, cen, starts, params


@pytest.mark.parametrize("winners", [False, True], ids=["values", "winners"])
@pytest.mark.parametrize("mode", ["mxu", "pre"])
@pytest.mark.parametrize("N,M,W,widths,extent", [
    (512, 32, 256, (16, 16, 32), 30),   # windowed, two 128-row tiles
    (512, 64, 64, (16, 16, 32), 200),   # sparse: centers with nothing in range
])
def test_pool_mode_matches_pallas(mode, winners, N, M, W, widths, extent):
    A, xyz, b_c, cen, starts, params = _inputs(N + W + extent, N, M, W, widths, extent)
    c1, c2, c3 = widths
    w2, b2, s2, lb2, w3, b3 = params
    layer_params = [
        (jnp.zeros((1, 1)), jnp.zeros(c1), jnp.ones(c1), jnp.zeros(c1)),
        (w2, b2, s2, lb2),
        (w3, b3, jnp.ones(c3), jnp.zeros(c3)),
    ]
    want = compiled(
        functools.partial(SK._sa_pair_pool_impl, layer_params=layer_params, radius=RADIUS,
                          window=W, block=16, wc=min(128, W), interpret=True, d2_mode=mode,
                          with_winners=winners),
        *(jnp.asarray(v) for v in (A, xyz, b_c, cen, starts)),
    )
    args = (T(A).bfloat16(), T(xyz), T(b_c).bfloat16(), T(cen), T(starts),
            *(T(v) for v in params))
    mask = None
    if mode == "pre":
        mask = port_mask.sa_radius_mask(T(xyz), T(cen), T(starts), radius=RADIUS, window=W)
    fn = port_pool.sa_pair_pool_winners if winners else port_pool.sa_pair_pool
    got = fn(*args, radius=RADIUS, window=W, d2_mode=mode, mask=mask)
    if winners:
        (got, got_win), (want, want_win) = got, want
        np.testing.assert_array_equal(got_win.numpy(), np.asarray(want_win))
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got < -1e8, want < -1e8)
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0)
    # every mode decides these pairs as the direct test does
    pair = port_pool.sa_pair_pool(*args, radius=RADIUS, window=W, d2_mode="pair")
    np.testing.assert_array_equal(got, pair.numpy())
    if extent == 200:
        assert (want < -1e8).any(), "the sparse case must leave some centers empty"


def test_pre_pool_reads_only_the_mask():
    """Under ``pre`` the pool takes its radius test from the mask alone."""
    A, xyz, b_c, cen, starts, params = _inputs(5, 512, 32, 256, (16, 16, 32), 30)
    args = (T(A).bfloat16(), T(xyz), T(b_c).bfloat16(), T(cen), T(starts),
            *(T(v) for v in params))
    mask = port_mask.sa_radius_mask(T(xyz), T(cen), T(starts), radius=RADIUS, window=256)
    want = port_pool.sa_pair_pool(*args, radius=RADIUS, window=256, d2_mode="pre", mask=mask)
    moved = list(args)
    moved[1], moved[3] = torch.zeros_like(moved[1]), torch.full_like(moved[3], 99.0)
    got = port_pool.sa_pair_pool(*moved, radius=RADIUS, window=256, d2_mode="pre", mask=mask)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="mask"):
        port_pool.sa_pair_pool(*args, radius=RADIUS, window=256, d2_mode="pre")


@pytest.mark.parametrize("N,W,extent", [(512, 256, 30), (1024, 256, 30), (512, 64, 200)])
def test_mask_matches_pallas(N, W, extent):
    rng = np.random.default_rng(N + W)
    B, n_blocks = 2, 6
    xyz = np.sort((rng.integers(-extent, extent, (B, N, 3)) * 0.05).astype(np.float32), axis=1)
    starts16 = np.stack([rng.integers(0, (N - W) // 16 + 1, n_blocks) * 16
                         for _ in range(B)]).astype(np.int32)
    starts16[0, 0], starts16[0, 1], starts16[1, 0] = N - W, 0, 144  # 144: 16k, not 128k
    assert (starts16 % 128).any()
    # each block's centers are points of its window (a center lies in its own ball)
    picks = np.repeat(starts16, 16, axis=1) + rng.integers(0, W, (B, n_blocks * 16))
    cen = np.take_along_axis(xyz, picks[..., None], 1)
    pen, offs = jax_mask(jnp.asarray(xyz), jnp.asarray(cen), jnp.asarray(starts16),
                         radius=RADIUS, window=W, block=16, interpret=True)
    pen, offs = np.asarray(pen), np.asarray(offs)
    rows = offs[..., None] + np.arange(W)  # (B, n_blocks, W)
    want = np.take_along_axis(pen, rows[..., None], 2)
    # the port takes unfloored starts and floors them as the pool does
    unfloored = starts16 + rng.integers(0, 16, starts16.shape).astype(np.int32)
    unfloored = np.minimum(unfloored, N - W)
    got = port_mask.sa_radius_mask(T(xyz), T(cen), T(unfloored), radius=RADIUS, window=W)
    assert got.dtype == torch.uint8 and got.shape == (B, n_blocks, W, 16)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    assert 0 < want.sum() < want.size


def test_mask_bitexact_near_the_radius():
    """Unquantized coordinates with pairs within 1e-5 of the radius: the mask
    decides every pair as the interpreted Pallas kernel does, at the flagship
    radii. (At an exact tie the two may differ: XLA's CPU dot accumulates the
    expansion with fused multiply-adds, the port and its CUDA kernel do not;
    the next test pins the port's order.)"""
    rng = np.random.default_rng(0)
    B, N, W, n_blocks = 2, 2048, 256, 16
    xyz = np.sort(rng.uniform(-3, 3, (B, N, 3)).astype(np.float32), axis=1)
    starts16 = np.stack([rng.integers(0, (N - W) // 16 + 1, n_blocks) * 16
                         for _ in range(B)]).astype(np.int32)
    picks = np.repeat(starts16, 16, axis=1) + rng.integers(0, W, (B, n_blocks * 16))
    cen = (np.take_along_axis(xyz, picks[..., None], 1)
           + rng.normal(scale=0.01, size=(B, n_blocks * 16, 3))).astype(np.float32)
    pos = (starts16[..., None] + np.arange(W)).reshape(B, -1, 1)
    p = np.take_along_axis(xyz, pos, 1).reshape(B, n_blocks, W, 1, 3).astype(np.float64)
    d2 = ((p - cen.reshape(B, n_blocks, 1, 16, 3)) ** 2).sum(-1)
    near = 0
    for radius in (0.2, 0.4, 0.8, 1.2):
        pen, offs = jax_mask(jnp.asarray(xyz), jnp.asarray(cen), jnp.asarray(starts16),
                             radius=radius, window=W, block=16, interpret=True)
        rows = np.asarray(offs)[..., None] + np.arange(W)
        want = np.take_along_axis(np.asarray(pen), rows[..., None], 2).astype(np.uint8)
        got = port_mask.sa_radius_mask(T(xyz), T(cen), T(starts16), radius=radius, window=W)
        np.testing.assert_array_equal(got.numpy(), want)
        near += int((np.abs(d2 - radius * radius) < 1e-5).sum())
    assert near > 10, near


def _radius_for(r2: np.float32) -> float:
    """A radius whose square rounds to the f32 value ``r2``, as the wrappers round it."""
    radius = float(np.sqrt(np.float64(r2)))
    assert np.float32(radius * radius) == r2
    return radius


@pytest.mark.parametrize("mode", ["mask", "mxu"])
def test_radius_tests_decide_exact_ties_by_the_stated_sum(mode):
    """Pairs whose f32 expansion, summed term by term in the stated order (no
    fused multiply-add, as the CUDA kernels build), equals r^2 exactly: in
    radius at that r^2, out of it one ulp lower. Another order or origin moves
    the sum by an ulp up or down and flips one of the two."""
    rng = np.random.default_rng(1)
    B, N, W = 1, 512, 256
    xyz = np.sort(rng.uniform(-1, 1, (B, N, 3)).astype(np.float32), axis=1)
    cen = (xyz[:, 100:116] + rng.normal(scale=0.05, size=(B, 16, 3))).astype(np.float32)
    starts = np.zeros((B, 1), np.int32)
    m2 = np.float32(-2)
    r2_below = lambda r2: np.nextafter(r2, np.float32(-1))  # noqa: E731
    checked = 0
    for w, c in zip(rng.integers(0, W, 32), rng.integers(0, 16, 32)):
        pp, cc = xyz[0, w] - cen[0, 0], cen[0, c] - cen[0, 0]
        psq = pp[0] * pp[0] + pp[1] * pp[1] + pp[2] * pp[2]
        csq = cc[0] * cc[0] + cc[1] * cc[1] + cc[2] * cc[2]
        if mode == "mask":
            tie = pp[0] * (m2 * cc[0]) + pp[1] * (m2 * cc[1]) + pp[2] * (m2 * cc[2]) + psq + csq
        else:  # in radius iff pc <= r^2 - psq: the tie is the least r^2 with r^2 - psq == pc
            pc = (m2 * pp[0]) * cc[0] + (m2 * pp[1]) * cc[1] + (m2 * pp[2]) * cc[2] + csq
            near = [pc + psq]
            for _ in range(4):
                near = [np.nextafter(near[0], np.float32(-1))] + near
            ties = [r2 for r2 in near if r2 - psq == pc]
            if not ties or r2_below(ties[0]) - psq == pc:
                continue
            tie = ties[0]
        for r2, inside in ((tie, 1), (r2_below(tie), 0)):
            radius = _radius_for(r2)
            if mode == "mask":
                got = port_mask.sa_radius_mask(T(xyz), T(cen), T(starts), radius=radius,
                                               window=W)[0, 0, w, c]
            else:
                got = port_pool._in_radius(T(xyz)[:, None, None, :W], T(cen)[:, None, :, None],
                                           np.float32(r2).item(), "mxu")[0, 0, c, w]
            assert int(got) == inside, (mode, w, c, r2, inside)
            checked += 1
    assert checked >= 16, checked
