"""The training kernels' plain versions (K4-K7) vs the JAX Pallas kernels in interpret mode.

* K4, the pair pool with winner export, against ``sa_pair_pool_pallas(
  with_winners=True)``: values within 0.03 (``tests/test_sa_kernel_interpret.py:57``)
  and identical winners. Some points are copies of others, in the same
  128-row tile and in the next one, so pooled values tie exactly and the
  tie rule is exercised.
* K5 / K6, the pair-pool backward, against ``sa_pair_pool_bwd_pallas(compact=
  True / False)`` fed the same winners: dA 2e-4, db_c 1e-4 absolute, weight
  gradients 1% of the leaf's largest value (``tests/test_sa_kernel_interpret.py:429-436``).
  Both sides round dx and dh0 to bf16 after f32 sums taken in different
  orders (the TPU kernel sums over 128 padded lanes), so for some inputs one
  element lands on the other side of a bf16 rounding boundary and moves dA
  by up to ~1e-3 (the reference's own test faces the same). The inputs of
  seed 2 have no such element: there both sides agree to ~1e-6.
* K7, the prep backward, against ``_prep_bwd``: every output within 0.02 of the
  leaf's largest value (``tests/test_sa_prep.py:79-110``, bf16).

Coordinates sit on a 0.05 grid and r^2 = 0.4113 is off the grid's d2 values, so
no pair lies within rounding of the radius.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bf16, compiled

from eda_tpu.ops.pallas import sa_kernel as SK
from eda_tpu.ops.pallas import sa_prep as jax_prep
from eda_tpu.ops.pallas.sa_kernel import _ceil_lane, _pad_lanes
from eda_tpu_torch.ops.cuda import sa_kernel as port_pool
from eda_tpu_torch.ops.cuda import sa_pool_bwd as port_bwd
from eda_tpu_torch.ops.cuda import sa_prep as port_prep

R2 = 0.4113
T = torch.from_numpy


def _pool_inputs(seed, N=512, M=32, W=256, widths=(16, 16, 32), extent=30):
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
    w2 = (rng.normal(size=(c1, c2)) * 0.4).astype(np.float32)
    b2 = (rng.normal(size=c2) * 0.1).astype(np.float32)
    s2 = (1 + 0.1 * rng.normal(size=c2)).astype(np.float32)
    lb2 = (0.1 * rng.normal(size=c2)).astype(np.float32)
    w3 = (rng.normal(size=(c2, c3)) * 0.4).astype(np.float32)
    b3 = (rng.normal(size=c3) * 0.1).astype(np.float32)
    mids = ranks.reshape(B, M // 16, 16)[:, :, 8]
    starts = np.clip(mids - W // 2, 0, N - W).astype(np.int32)
    layer_params = [
        (jnp.zeros((1, 1)), jnp.zeros(c1), jnp.ones(c1), jnp.zeros(c1)),
        (w2, b2, s2, lb2),
        (w3, b3, jnp.ones(c3), jnp.zeros(c3)),
    ]
    return dict(A=A, xyz=xyz, b_c=b_c, cen=cen, starts=starts, W=W, rng=rng,
                params=(w2, b2, s2, lb2, w3, b3), layer_params=layer_params)


def _jax_pool(d):
    return compiled(
        functools.partial(SK._sa_pair_pool_impl, layer_params=d["layer_params"],
                          radius=float(np.sqrt(R2)), window=d["W"], block=16,
                          wc=min(128, d["W"]), interpret=True, d2_mode="pair",
                          with_winners=True),
        *(jnp.asarray(d[k]) for k in ("A", "xyz", "b_c", "cen", "starts")),
    )


@pytest.mark.parametrize("W,extent", [(256, 30), (128, 30), (64, 200)],
                         ids=["two-tiles", "one-tile", "sparse"])
def test_winners_plain_matches_pallas(W, extent):
    d = _pool_inputs(W + extent, W=W, extent=extent)
    out, win = (np.array(v) for v in _jax_pool(d))
    got, got_win = port_pool.sa_pair_pool_winners(
        T(d["A"]).bfloat16(), T(d["xyz"]), T(d["b_c"]).bfloat16(), T(d["cen"]),
        T(d["starts"]), *(T(v) for v in d["params"]), radius=float(np.sqrt(R2)), window=W)
    assert got_win.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy() < -1e8, out < -1e8)
    np.testing.assert_allclose(got.numpy(), out, atol=0.03, rtol=0)
    np.testing.assert_array_equal(got_win.numpy(), win)
    if extent == 200:
        assert (out < -1e8).any() and (win[out < -1e8] == 0).all()


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "windowed"])
def test_pool_backward_plain_matches_pallas(compact):
    d = _pool_inputs(2)
    out, win = (np.array(v) for v in _jax_pool(d))
    rng = d["rng"]
    g = np.where(out < -1e8, 0.0, rng.normal(size=out.shape)).astype(np.float32)
    want = compiled(
        functools.partial(SK.sa_pair_pool_bwd_pallas, layer_params=d["layer_params"],
                          window=d["W"], block=16, wc=128, interpret=True, compact=compact),
        *(jnp.asarray(v) for v in (d["A"], d["b_c"], g, win, d["starts"])),
    )
    dA, dbc, (dw2, dw3), (db2, db3), (ds2,), (dlb2,) = want
    w2, b2, s2, lb2, w3, _ = d["params"]
    got = port_bwd.sa_pool_bwd(
        T(d["A"]).bfloat16(), T(d["b_c"]).bfloat16(), T(g), T(win), T(d["starts"]),
        T(w2), T(b2), T(s2), T(lb2), T(w3), window=d["W"], compact=compact)
    g_dA, g_dbc, g_dw2, g_db2, g_ds2, g_dlb2, g_dw3, g_db3 = (v.numpy() for v in got)
    np.testing.assert_allclose(g_dA, np.asarray(dA), atol=2e-4, rtol=0)
    np.testing.assert_allclose(g_dbc, np.asarray(dbc), atol=1e-4, rtol=0)
    for name, a, b in (("dW2", g_dw2, dw2), ("db2", g_db2, db2), ("ds2", g_ds2, ds2),
                       ("dlb2", g_dlb2, dlb2), ("dW3", g_dw3, dw3), ("db3", g_db3, db3)):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-6) < 0.01, name
    assert np.abs(np.asarray(dA)).max() > 0


def test_compact_choice_follows_the_tpu_rule():
    assert port_bwd.compact_backward(1024, 128)       # SA1
    assert not port_bwd.compact_backward(256, 256)    # SA2-4
    assert port_bwd.compact_backward(256, 32)         # tiny SA1
    assert not port_bwd.compact_backward(128, 64)     # tiny SA2
    assert not port_bwd.compact_backward(64, 64)      # tiny SA3-4


@pytest.mark.parametrize("c1,in_dim", [(16, 6), (64, 6), (32, 67)])
def test_prep_backward_plain_matches_pallas(c1, in_dim):
    radius = 0.4
    rng = np.random.default_rng(c1 + in_dim)
    B, N = 2, 512
    pts = rng.uniform(-2, 2, (B, N, in_dim)).astype(np.float32)
    w1 = (rng.normal(size=(in_dim, c1)) * in_dim ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=c1) * 0.1).astype(np.float32)
    s1 = (1 + 0.1 * rng.normal(size=c1)).astype(np.float32)
    dA = bf16(rng.normal(size=(B, N, c1)))
    c1p = _ceil_lane(c1)
    pad = lambda v: _pad_lanes(jnp.asarray(v).reshape(1, -1), c1p)  # noqa: E731
    want = compiled(
        functools.partial(jax_prep._prep_bwd, c_real=c1, dtype=jnp.bfloat16, radius=radius,
                          interpret=True),
        jnp.asarray(pts), _pad_lanes(jnp.asarray(dA), c1p).astype(jnp.bfloat16),
        _pad_lanes(jnp.asarray(w1), c1p), pad(b1), pad(s1),
    )
    dpts, dw, db, ds, dlb = (np.asarray(v) for v in want)
    got = port_prep.sa_prep_bwd(T(pts), T(dA).bfloat16(), T(w1), T(b1), T(s1), radius=radius)
    for name, a, b in (("dpts", got[0], dpts), ("dW1", got[1], dw[:, :c1]),
                       ("db1", got[2], db[0, :c1]), ("dscale", got[3], ds[0, :c1]),
                       ("dlnb", got[4], dlb[0, :c1])):
        a = a.numpy()
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-6) < 0.02, name
