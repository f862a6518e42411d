"""The fused SA layer in f32 (``ModelConfig(use_bf16=False)``) vs ``eda_tpu``'s, forward and gradients.

``eda_tpu`` passes the model's compute dtype through the whole layer
(``eda_tpu/ops/fused_sa.py:600-745``): layer 0 as the f32 prep kernel, b_c,
the self term and the XLA scan in f32, and the pair pools, which take A and
b_c rounded to bf16 (``eda_tpu/ops/pallas/sa_kernel.py:953-954``,
``:1169-1170``) and hand dA and db_c back in f32. The port runs
``fused_set_abstraction(compute_dtype=torch.float32)`` with the kernels'
plain versions; the JAX side runs ``impl="pallas"`` (serving) and
``impl="pallas_train"`` (training), every Pallas kernel interpreted, and
``impl="xla"`` for a window that is no multiple of 128 (the fallback both
packages take there). Both get the same cotangent of the pooled features.

Tolerances:
* kernel windows: the pools compute in bf16, so as ``test_torch_fused_sa_train.py``:
  pooled features 0.03 abs, each gradient leaf within 2% of its largest value;
* the XLA window: all f32, so as ``tests/test_fused_sa.py:92`` holds two f32
  formulations of the same layer: 1e-5 abs + 1e-4 relative, features and
  every gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_sa_train import REL, _setup
from torch_parity import (  # noqa: F401
    compiled, jax_tpu_serving_path, jax_tpu_training_path, one_torch_thread,
)

from eda_tpu.ops import fused_sa as jax_fsa
from eda_tpu_torch.ops import fused_sa as port_fsa

pytestmark = pytest.mark.usefixtures("one_torch_thread")

XLA_ATOL, XLA_RTOL = 1e-5, 1e-4


def _jax_run(xyz, feats, cidx, groups, G, impl, window, grads):
    kw = dict(radius=0.3, window=window, block=64, compute_dtype=jnp.float32,
              presorted=True, impl=impl, return_rank_order=True)

    def loss(feats_, params):
        out, _ = jax_fsa.fused_set_abstraction(jnp.asarray(xyz), feats_, jnp.asarray(cidx),
                                               params, **kw)
        return jnp.sum(out * G), out

    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    if not grads:
        return np.asarray(compiled(lambda f, p: loss(f, p)[1], jnp.asarray(feats), params)), None
    (_, out), (df, dp) = compiled(
        lambda f, p: jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(f, p),
        jnp.asarray(feats), params)
    return np.asarray(out), (df, dp)


def _port_run(xyz, feats, cidx, groups, G, window, grads):
    params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=grads) for v in g)
                                 for g in groups))
    f = torch.tensor(feats, requires_grad=grads)
    with torch.set_grad_enabled(grads):
        out, _ = port_fsa.fused_set_abstraction(
            torch.from_numpy(xyz), f, torch.from_numpy(cidx), params, radius=0.3,
            window=window, block=64, compute_dtype=torch.float32)
    assert out.dtype == torch.float32
    if not grads:
        return out.numpy(), None
    (out * torch.from_numpy(G)).sum().backward()
    return out.detach().numpy(), (f, params)


def _pairs(port_grads, jax_grads):
    f, params = port_grads
    want_df, want_dp = jax_grads
    out = [("features", f.grad, want_df)]
    for gi, name in enumerate(("kernels", "biases", "ln_scales", "ln_biases")):
        for i, (p, w) in enumerate(zip(params[gi], getattr(want_dp, name))):
            out.append((f"{name}[{i}]", p.grad, np.asarray(w)))
    return out


@pytest.mark.parametrize("N,M,window,widths", [
    (1024, 128, 256, (16, 16, 32)),
    (512, 64, 128, (32, 32, 64)),
], ids=["SA1-like", "SA2-like"])
def test_f32_serving_layer_matches_jax_pallas(jax_tpu_serving_path, N, M, window,  # noqa: F811
                                              widths):
    data = _setup(N + M + 1, N, M, 4, widths)
    want, _ = _jax_run(*data, "pallas", window, grads=False)
    with torch.inference_mode():
        got, _ = _port_run(*data, window, grads=False)
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0)


@pytest.mark.parametrize("N,M,window,widths", [
    (1024, 128, 256, (16, 16, 32)),   # compact pool backward
    (512, 64, 128, (32, 32, 64)),     # windowed pool backward
], ids=["compact", "windowed"])
def test_f32_training_layer_matches_jax_pallas_train(jax_tpu_training_path, N, M,  # noqa: F811
                                                     window, widths):
    data = _setup(N + M + 2, N, M, 4, widths)
    want, jax_grads = _jax_run(*data, "pallas_train", window, grads=True)
    got, port_grads = _port_run(*data, window, grads=True)
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0)
    for name, g, w in _pairs(port_grads, jax_grads):
        w = np.asarray(w)
        assert g is not None and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-6)
        assert err < REL, (name, err)


def test_f32_xla_window_matches_jax_forward_and_gradients(jax_tpu_training_path):  # noqa: F811
    """A 192-point window: both packages take the XLA scan, all in f32."""
    data = _setup(5, 512, 64, 4, (16, 16, 32))
    want, jax_grads = _jax_run(*data, "pallas_train", 192, grads=True)
    got, port_grads = _port_run(*data, 192, grads=True)
    np.testing.assert_allclose(got, want, atol=XLA_ATOL, rtol=XLA_RTOL)
    for name, g, w in _pairs(port_grads, jax_grads):
        assert g is not None and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=XLA_ATOL, rtol=XLA_RTOL, err_msg=name)
