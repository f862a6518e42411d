"""Windows that are no multiple of 128: the port takes the reference's fallback.

On its TPU paths ``eda_tpu`` runs the Pallas pool only when the window W =
min(window, N) is a multiple of min(128, W); any other window runs the XLA
scan (``eda_tpu/ops/fused_sa.py:576-581``) with the XLA layer 0. The port
routes such layers to its plain twin (``fused_sa.scan_pool``, ``plain_prep``)
on every device, and keeps the kernels for every other window.

Tolerances are those of ``tests/test_torch_backbone.py`` and
``tests/test_torch_fused_sa_train.py``: indices and coordinates exact; SA
features 0.03 abs, ``fp2_features`` 0.05 abs; one SA layer's pooled features
0.03 abs and each gradient leaf within 2% of its largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_backbone import FP_ATOL, SA_ATOL, _jax_backbone, _port_backbone
from test_torch_fused_sa_train import REL, _setup
from torch_parity import (  # noqa: F401
    compiled, jax_tpu_serving_path, jax_tpu_training_path, perturb, to_numpy,
)

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.ops import fused_sa as jax_fsa
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.ops import fused_sa as port_fsa
from eda_tpu_torch.weights import load_flax

WINDOWS = (192, 128, 64, 64)  # SA1 takes the fallback (192 % 128 != 0), SA2-4 the kernels


def test_backbone_with_a_192_window_matches_jax(jax_tpu_serving_path):  # noqa: F811
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), sa_windows=WINDOWS)
    jcfg = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), sa_windows=WINDOWS)
    clouds = SyntheticScenes(SyntheticConfig(num_points=cfg.num_points, num_objects=4),
                             vocab_size=cfg.text_vocab_size).batch(range(2))["point_clouds"]

    jax_model = _jax_backbone(jcfg)
    variables = jax.jit(lambda x: jax_model.init(jax.random.key(0), x, train=False))(
        jnp.asarray(clouds))
    variables = perturb(to_numpy(variables), seed=2)
    want = compiled(lambda v, x: jax_model.apply(v, x, train=False), variables,
                    jnp.asarray(clouds))

    port = _port_backbone(cfg)
    load_flax(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(clouds))

    keys = [f"sa{i}_{k}" for i in range(1, 5) for k in ("xyz", "features", "inds")]
    keys += ["fp2_features", "fp2_xyz", "fp2_inds"]
    for key in keys:
        w = np.asarray(want[key].astype(jnp.float32) if "features" in key else want[key])
        g = got[key].float().numpy() if "features" in key else got[key].numpy()
        assert g.shape == w.shape, key
        if "features" not in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            atol = FP_ATOL if key.startswith("fp2") else SA_ATOL
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)


def test_sa_layer_gradients_with_a_192_window_match_jax(jax_tpu_training_path):  # noqa: F811
    """``impl="pallas_train"`` falls back to the XLA scan at W = 192; its
    gradients come from JAX autodiff, the port's from autograd."""
    N, M, window, widths = 512, 128, 192, (16, 16, 32)
    xyz, feats, cidx, groups, G = _setup(7, N, M, 4, widths)
    kw = dict(radius=0.3, window=window, block=64, compute_dtype=jnp.bfloat16,
              presorted=True, impl="pallas_train", return_rank_order=True)

    def loss(feats_, params):
        out, _ = jax_fsa.fused_set_abstraction(jnp.asarray(xyz), feats_, jnp.asarray(cidx),
                                               params, **kw)
        return jnp.sum(out * G), out

    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    (_, want), (want_df, want_dp) = compiled(
        lambda f, p: jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(f, p),
        jnp.asarray(feats), params)

    port_params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=True) for v in g)
                                      for g in groups))
    f = torch.tensor(feats, requires_grad=True)
    got, _ = port_fsa.fused_set_abstraction(torch.from_numpy(xyz), f, torch.from_numpy(cidx),
                                            port_params, radius=0.3, window=window, block=64)
    (got * torch.from_numpy(G)).sum().backward()

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


@pytest.mark.parametrize("window,n_points,pool_calls", [
    (192, 512, 0),   # no multiple of 128: the plain scan
    (320, 512, 0),
    (128, 512, 1),   # multiples of min(128, W): the kernel route
    (256, 512, 1),
    (64, 512, 1),
    (1024, 512, 1),  # dense, W = N = 512
    (1024, 500, 0),  # dense, W = N = 500
])
def test_window_picks_the_route_of_the_reference(window, n_points, pool_calls):
    assert port_fsa.runs_kernels(window, n_points) == bool(pool_calls)
    xyz, feats, cidx, groups, _ = _setup(1, n_points, 64, 4, (16, 16, 32))
    params = port_fsa.SAParams(*(tuple(torch.tensor(v) for v in g) for g in groups))
    calls = []
    orig = port_fsa.sa_pair_pool
    try:
        port_fsa.sa_pair_pool = lambda *a, **k: calls.append(1) or orig(*a, **k)
        with torch.inference_mode():
            out, _ = port_fsa.fused_set_abstraction(
                torch.from_numpy(xyz), torch.from_numpy(feats), torch.from_numpy(cidx),
                params, radius=0.3, window=window)
    finally:
        port_fsa.sa_pair_pool = orig
    assert len(calls) == pool_calls
    assert out.shape == (2, 64, 32) and torch.isfinite(out).all()
