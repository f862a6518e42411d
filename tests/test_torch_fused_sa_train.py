"""The port's fused SA training forward and backward vs ``jax.grad`` of the JAX layer.

The JAX side runs ``fused_set_abstraction(impl="pallas_train")``: the Pallas
prep with its backward kernel, the pair pool with winner export and the
pair-pool backward (compact where the TPU picks it), all interpreted. The port
runs the same layer through ``torch.autograd`` with the kernels' plain
versions. Both get the same cotangent ``G`` of the pooled features.

Tolerances: the pooled features 0.03 abs as in ``test_torch_sa_pool.py``; each
gradient leaf within 2% of its largest value. Both sides round the pair-MLP
cotangents to bf16 after f32 sums in different orders, and the bf16 matmuls of
the self term and b_c round their gradients where XLA and PyTorch each put
them; 2% is twice the reference test's 1% for the pool alone, since here the
leaves also collect the self term's and the prep's bf16 gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled, jax_tpu_training_path  # noqa: F401

from eda_tpu.ops import fused_sa as jax_fsa
from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.ops import fused_sa as port_fsa
from eda_tpu_torch.ops.cuda import build

REL = 0.02


def _setup(seed, N, M, C, widths):
    rng = np.random.default_rng(seed)
    xyz = np.stack([morton_sort(rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32),
                                cell_size=0.3)[0] for _ in range(2)])
    feats = rng.normal(size=(2, N, C)).astype(np.float32)
    groups = ([], [], [], [])
    prev = 3 + C
    for c in widths:
        groups[0].append((rng.normal(size=(prev, c)) * prev ** -0.5).astype(np.float32))
        groups[1].append((rng.normal(size=c) * 0.1).astype(np.float32))
        groups[2].append((1 + 0.1 * rng.normal(size=c)).astype(np.float32))
        groups[3].append((0.1 * rng.normal(size=c)).astype(np.float32))
        prev = c
    cidx = np.stack([rng.permutation(N)[:M] for _ in range(2)]).astype(np.int32)
    G = rng.normal(size=(2, M, widths[-1])).astype(np.float32)
    return xyz, feats, cidx, groups, G


@pytest.mark.parametrize("N,M,window,widths", [
    (1024, 128, 256, (16, 16, 32)),   # compact backward (128-lane c_out < W)
    (512, 64, 128, (32, 32, 64)),     # windowed backward
], ids=["compact", "windowed"])
def test_fused_sa_gradients_match_jax_pallas_train(
        jax_tpu_training_path, N, M, window, widths):  # noqa: F811
    xyz, feats, cidx, groups, G = _setup(N + M, N, M, 4, widths)
    kw = dict(radius=0.3, window=window, block=64, compute_dtype=jnp.bfloat16,
              presorted=True, impl="pallas_train", return_rank_order=True)

    def loss(feats_, params):
        out, _ = jax_fsa.fused_set_abstraction(jnp.asarray(xyz), feats_, jnp.asarray(cidx),
                                               params, **kw)
        return jnp.sum(out * G), out

    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    (_, want), grads = compiled(
        lambda f, p: jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(f, p),
        jnp.asarray(feats), params)
    want_df, want_dp = grads

    port_params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=True) for v in g)
                                      for g in groups))
    f = torch.tensor(feats, requires_grad=True)
    launches = {s: k.launches for s, k in build.KERNELS.items()}
    got, _ = port_fsa.fused_set_abstraction(torch.from_numpy(xyz), f, torch.from_numpy(cidx),
                                            port_params, radius=0.3, window=window, block=64)
    (got * torch.from_numpy(G)).sum().backward()
    assert {s: k.launches for s, k in build.KERNELS.items()} == launches  # CPU: plain only

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=0.03, rtol=0)
    pairs = [("features", f.grad, want_df)]
    for gi, name in enumerate(("kernels", "biases", "ln_scales", "ln_biases")):
        for i, (p, w) in enumerate(zip(port_params[gi], getattr(want_dp, name))):
            pairs.append((f"{name}[{i}]", p.grad, w))
    for name, g, w in pairs:
        w = np.asarray(w)
        assert g is not None and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-6)
        assert err < REL, (name, err)


def test_serving_path_keeps_the_pool_without_winners():
    """With gradients off the layer calls the serving pool, not the training one."""
    xyz, feats, cidx, groups, _ = _setup(0, 256, 32, 4, (16, 16, 32))
    calls = []
    params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=True) for v in g)
                                 for g in groups))
    orig_pool, orig_win = port_fsa.sa_pair_pool, port_fsa.sa_pair_pool_winners
    try:
        port_fsa.sa_pair_pool = functools.partial(_record, calls, "serve", orig_pool)
        port_fsa.sa_pair_pool_winners = functools.partial(_record, calls, "train", orig_win)
        with torch.inference_mode():
            port_fsa.fused_set_abstraction(torch.from_numpy(xyz), torch.from_numpy(feats),
                                           torch.from_numpy(cidx), params, radius=0.3,
                                           window=128)
        port_fsa.fused_set_abstraction(torch.from_numpy(xyz), torch.from_numpy(feats),
                                       torch.from_numpy(cidx), params, radius=0.3, window=128)
    finally:
        port_fsa.sa_pair_pool, port_fsa.sa_pair_pool_winners = orig_pool, orig_win
    assert calls == ["serve", "train"]


def _record(calls, tag, fn, *a, **k):
    calls.append(tag)
    return fn(*a, **k)
