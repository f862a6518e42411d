"""Where the port's backbone leaves the JAX values, stage by stage, on identical inputs.

The whole-backbone test (``test_torch_backbone.py``) allows a few bf16 steps.
This file feeds each stage the same inputs on both sides and shows that every
remaining difference is f32 summation order, not a rounding point one side
skips: a skipped rounding would move a large share of the outputs, while a
sum taken in another order moves a handful by one step (bf16) or one ulp
(f32). Run with ``-s`` to see the counts.

* SA prep (K2's plain version against ``sa_prep`` interpreted): fewer than
  0.1% of the bf16 outputs differ, each by one bf16 step at most.
* Per-center offsets ``b_c``: equal.
* Pair pool (K3's plain version against the interpreted kernel, the same
  ``A`` and ``b_c``): f32 pre-activations within 4 ulps of the largest value.
* A bf16 ``Dense`` (``torch.nn.functional.linear`` in bf16 against XLA's bf16
  dot): fewer than 0.1% of the outputs differ, and each side lies within one
  bf16 step of the exact product rounded to bf16 (an output much smaller
  than its terms can sit two steps from the other side's).
* 3-NN squared distances (``pointops.three_nn``): the same neighbours,
  distances within 4e-6 of the largest (a few f32 ulps: the cross term's
  three products are summed in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_sa_pool import _fused_setup
from torch_parity import compiled

from eda_tpu.ops import pointops as jax_pointops
from eda_tpu.ops.pallas import sa_kernel as SK
from eda_tpu.ops.pallas import sa_prep as jax_prep
from eda_tpu.ops.pallas.sa_kernel import _ceil_lane, _pad_lanes
from eda_tpu_torch.ops import pointops
from eda_tpu_torch.ops.cuda import sa_kernel as port_pool
from eda_tpu_torch.ops.cuda import sa_prep as port_prep

T = torch.from_numpy
RADIUS = 0.3


def _bf16_steps(got, want):
    """Elements that differ, and each difference in bf16 steps of the value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    differ = got != want
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    step = 2.0 ** (np.floor(np.log2(top)) - 7)  # the bf16 step of the larger of the two
    return int(differ.sum()), float((np.abs(got - want) / step)[differ].max(initial=0.0))


def test_sa_stages_differ_by_summation_order_only(monkeypatch):
    monkeypatch.setattr(jax_prep, "_INTERPRET", True)
    N, M, W, c1 = 1024, 128, 256, 16
    xyz, feats, cidx, (ks, bs, ss, ls) = _fused_setup(N + M, N, M, 4, (c1, 16, 32))
    pts = np.concatenate([xyz, feats], -1)
    pad = lambda v: _pad_lanes(jnp.asarray(v).reshape(1, -1), _ceil_lane(c1))  # noqa: E731
    want_a, _ = compiled(
        lambda p, w, b, s, lb: jax_prep.sa_prep(p, w, b, s, lb, c_real=c1, radius=RADIUS,
                                                compute_dtype=jnp.bfloat16),
        jnp.asarray(pts), _pad_lanes(jnp.asarray(ks[0]), _ceil_lane(c1)), pad(bs[0]),
        pad(ss[0]), pad(ls[0]))
    want_a = np.asarray(want_a[..., :c1].astype(jnp.float32))
    a = port_prep.sa_prep_plain(T(pts), T(ks[0]), T(bs[0]), T(ss[0]), T(ls[0]), radius=RADIUS)
    n_a, steps_a = _bf16_steps(a.float().numpy(), want_a)

    cen = np.take_along_axis(xyz, np.sort(cidx, 1)[..., None], 1)
    want_bc = np.asarray(compiled(
        lambda c, w: (-(c / RADIUS).astype(jnp.bfloat16) @ w[:3].astype(jnp.bfloat16)
                      ).astype(jnp.float32), jnp.asarray(cen), jnp.asarray(ks[0])))
    b_c = (-port_prep.bf16_round(T(cen) / RADIUS) @ port_prep.bf16_round(T(ks[0])[:3]))
    b_c = b_c.bfloat16()
    np.testing.assert_array_equal(b_c.float().numpy(), want_bc)

    ranks = np.sort(cidx, 1)
    starts = np.clip(ranks.reshape(2, M // 16, 16)[:, :, 8] - W // 2, 0, N - W).astype(np.int32)
    layer_params = [(jnp.zeros((1, 1)), jnp.zeros(c1), jnp.ones(c1), jnp.zeros(c1)),
                    (ks[1], bs[1], ss[1], ls[1]), (ks[2], bs[2], jnp.ones(32), jnp.zeros(32))]
    want_z = np.asarray(compiled(
        functools.partial(SK._sa_pair_pool_impl, layer_params=layer_params, radius=RADIUS,
                          window=W, block=16, wc=128, interpret=True, d2_mode="pair"),
        jnp.asarray(a.float().numpy()).astype(jnp.bfloat16), jnp.asarray(xyz),
        jnp.asarray(b_c.float().numpy()).astype(jnp.bfloat16), jnp.asarray(cen),
        jnp.asarray(starts)))
    z = port_pool.sa_pair_pool_plain(a, T(xyz), b_c, T(cen), T(starts),
                                     *(T(v) for v in (ks[1], bs[1], ss[1], ls[1], ks[2], bs[2])),
                                     radius=RADIUS, window=W).numpy()
    ulp = np.spacing(np.float32(np.abs(want_z).max()))
    z_ulps = float(np.abs(z - want_z).max() / ulp)
    print(f"\nSA prep: {n_a} of {a.numel()} bf16 outputs differ (at most {steps_a:.0f} step); "
          f"b_c equal; pool: {int((z != want_z).sum())} of {z.size} f32 outputs differ, "
          f"at most {z_ulps:.1f} ulps of the largest")
    assert n_a < 1e-3 * a.numel() and steps_a <= 1
    assert z_ulps <= 4


def test_fp_stages_differ_by_summation_order_only():
    rng = np.random.default_rng(0)
    unknown = rng.uniform(-2, 2, (2, 128, 3)).astype(np.float32)
    known = rng.uniform(-2, 2, (2, 64, 3)).astype(np.float32)
    want_d2, want_idx = compiled(jax_pointops.three_nn, jnp.asarray(unknown), jnp.asarray(known))
    d2, idx = pointops.three_nn(T(unknown), T(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    d2_rel = float(np.abs(d2.numpy() - np.asarray(want_d2)).max() / np.asarray(want_d2).max())

    x = rng.normal(size=(2, 128, 288)).astype(np.float32)
    k = (rng.normal(size=(288, 256)) * 288 ** -0.5).astype(np.float32)
    want = np.asarray(compiled(
        lambda x_, k_: (x_.astype(jnp.bfloat16) @ k_.astype(jnp.bfloat16)).astype(jnp.float32),
        jnp.asarray(x), jnp.asarray(k)))
    got = torch.nn.functional.linear(T(x).bfloat16(), T(k.T.copy()).bfloat16()).float().numpy()
    exact = (T(x).bfloat16().double() @ T(k).bfloat16().double()).bfloat16().float().numpy()
    n_dense = int((got != want).sum())
    steps_dense = max(_bf16_steps(got, exact)[1], _bf16_steps(want, exact)[1])
    print(f"\n3-NN: same neighbours, squared distances within {d2_rel:.1e} relative; "
          f"bf16 Dense: {n_dense} of {got.size} outputs differ, each side at most "
          f"{steps_dense:.0f} step from the exact product")
    assert d2_rel <= 4e-6
    assert n_dense < 1e-3 * got.size and steps_dense <= 1
