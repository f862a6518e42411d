"""The opt-in ``winner`` pool (``fused_set_abstraction(impl="winner")``), port vs ``eda_tpu``.

The inputs are those of ``tests/test_fused_sa.py::test_winner_backward_matches_scan_gradients``
as they are: 2 unsorted clouds of 256 points, 24 centers, widths (8, 8, 16),
radius 0.4, window 64, blocks of 8 centers, f32, ``presorted=False``. The
gradients of ``impl="winner"`` must match the port's scan path (``impl="xla"``)
and JAX's ``impl="winner"`` to ``rtol=1e-4, atol=1e-5``, the tolerance of that
test; the forward values equal the scan's exactly (one computation). Two
backward passes give every gradient bit for bit: the winners' rows of A repeat,
and their gradients are added in a fixed order. A bf16 layer of the tiny SA2's
shape gives the scan's values and repeats bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401

from eda_tpu.ops import fused_sa as jax_fsa
from eda_tpu_torch.ops import fused_sa as port_fsa

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-4, 1e-5


def jax_test_inputs():
    """``tests/test_fused_sa.py``'s winner test inputs, drawn in its order."""
    rng = np.random.default_rng(0)
    B, N, M, C = 2, 256, 24, 2
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    cidx = np.stack([rng.permutation(N)[:M] for _ in range(B)]).astype(np.int32)
    groups = ([], [], [], [])
    prev = 3 + C
    for c in (8, 8, 16):
        groups[0].append(rng.normal(size=(prev, c)).astype(np.float32) * 0.3)
        groups[1].append(rng.normal(size=(c,)).astype(np.float32) * 0.1)
        groups[2].append(np.ones(c, np.float32))
        groups[3].append(np.zeros(c, np.float32))
        prev = c
    weights = rng.normal(size=(B, M, 16)).astype(np.float32)
    return xyz, feats, cidx, groups, weights


KW = dict(radius=0.4, window=64, block=8)


def port_grads(data, impl, dtype=torch.float32, kw=KW, presorted=False):
    xyz, feats, cidx, groups, weights = data
    params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=True) for v in g)
                                 for g in groups))
    f = torch.tensor(feats, requires_grad=True)
    out = port_fsa.fused_set_abstraction(
        torch.from_numpy(xyz), f, torch.from_numpy(cidx), params, compute_dtype=dtype,
        presorted=presorted, impl=impl, return_rank_order=presorted, **kw)
    if presorted:
        out = out[0]
    (out * torch.from_numpy(weights)).sum().backward()
    return out.detach(), [f.grad] + [p.grad for g in params for p in g]


def test_winner_gradients_match_the_scan_and_jax():
    data = jax_test_inputs()
    xyz, feats, cidx, groups, weights = data
    out_w, g_win = port_grads(data, "winner")
    out_s, g_scan = port_grads(data, "xla")
    assert torch.equal(out_w, out_s)
    for i, (a, b) in enumerate(zip(g_win, g_scan)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL, err_msg=str(i))

    def loss(f, params):
        out = jax_fsa.fused_set_abstraction(
            jnp.asarray(xyz), f, jnp.asarray(cidx), params, compute_dtype=jnp.float32,
            impl="winner", **KW)
        return jnp.sum(out * weights)

    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    df, dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats), params)
    want = [df] + list(dp.kernels) + list(dp.biases) + list(dp.ln_scales) + list(dp.ln_biases)
    for i, (a, b) in enumerate(zip(g_win, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=str(i))
    assert any(float(np.abs(np.asarray(b)).max()) > 0.1 for b in want)


def test_winner_backward_repeats_bit_for_bit():
    data = jax_test_inputs()
    _, first = port_grads(data, "winner")
    _, second = port_grads(data, "winner")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bf16_winner_on_a_tiny_sa2_layer():
    """bf16, presorted, the tiny SA2's widths and window: the winner path
    rounds where the scan rounds, so its values are the scan's, and its
    backward repeats bit for bit. Its gradients are not held to the scan's
    here: bf16 pair values tie often, and at a tie the scan's max splits the
    cotangent among the tied pairs while the winner path gives it to the
    first (``eda_tpu/ops/fused_sa.py:_winner_pool``'s own caveat)."""
    from test_torch_fused_sa_train import _setup

    data = _setup(3, 256, 128, 32, (32, 32, 64))
    kw = dict(radius=0.3, window=128, block=64)
    out_w, g_win = port_grads(data, "winner", torch.bfloat16, kw, presorted=True)
    out_s, _ = port_grads(data, "xla", torch.bfloat16, kw, presorted=True)
    assert torch.equal(out_w, out_s)
    _, again = port_grads(data, "winner", torch.bfloat16, kw, presorted=True)
    assert all(torch.isfinite(a).all() and torch.equal(a, b) for a, b in zip(g_win, again))
