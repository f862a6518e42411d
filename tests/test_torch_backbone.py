"""Port PointNet++ backbone vs the JAX backbone on its TPU serving path.

``ModelConfig(use_bf16=True).tiny()`` widths, a Morton-sorted synthetic cloud,
the JAX model's own (perturbed) weights carried over with ``weights.from_flax``.
The JAX side runs the Pallas kernels in interpret mode (``jax_tpu_serving_path``)
so that both sides use the pair kernel's 16-center windows.

Tolerances: indices and coordinates exact; SA features 0.03 abs (the pair
pool's own tolerance, ``tests/test_sa_kernel_interpret.py:57``); ``fp2_features``
0.05 abs: the FP layers' bf16 shared MLPs round products where XLA and PyTorch
each put them, a few bf16 steps at features of magnitude ~2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled, jax_tpu_serving_path, perturb, to_numpy  # noqa: F401

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.models.pointnet2 import PointNetPPBackbone as JaxBackbone
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.pointnet2 import PointNetPPBackbone
from eda_tpu_torch.weights import load_flax

SA_ATOL = 0.03
FP_ATOL = 0.05


def _jax_backbone(cfg):
    return JaxBackbone(
        npoints=tuple(cfg.sa_npoints), radii=tuple(cfg.sa_radii),
        mlps=tuple(tuple(m) for m in cfg.sa_mlps),
        fp_mlps=tuple(tuple(m) for m in cfg.fp_mlps), sa_impl="fused",
        sa_windows=tuple(cfg.sa_windows), points_presorted=True, dtype=jnp.bfloat16,
    )


def _port_backbone(cfg):
    return PointNetPPBackbone(
        input_feature_dim=cfg.input_feature_dim, npoints=tuple(cfg.sa_npoints),
        radii=tuple(cfg.sa_radii), mlps=tuple(tuple(m) for m in cfg.sa_mlps),
        fp_mlps=tuple(tuple(m) for m in cfg.fp_mlps), sa_windows=tuple(cfg.sa_windows),
        dtype=torch.bfloat16,
    )


@pytest.mark.parametrize("windows", [None, (1024, 1024, 1024, 1024)],
                         ids=["windowed", "dense"])
def test_backbone_matches_jax_pallas_path(jax_tpu_serving_path, windows):  # noqa: F811
    cfg = ModelConfig(use_bf16=True).tiny()
    jcfg = JaxConfig(use_bf16=True).tiny()
    if windows is not None:
        cfg = dataclasses.replace(cfg, sa_windows=windows)
        jcfg = dataclasses.replace(jcfg, sa_windows=windows)
    clouds = SyntheticScenes(SyntheticConfig(num_points=cfg.num_points, num_objects=4),
                             vocab_size=cfg.text_vocab_size).batch(range(2))["point_clouds"]

    jax_model = _jax_backbone(jcfg)
    variables = jax.jit(lambda x: jax_model.init(jax.random.key(0), x, train=False))(
        jnp.asarray(clouds))
    variables = perturb(to_numpy(variables), seed=1)
    want = compiled(lambda v, x: jax_model.apply(v, x, train=False), variables,
                    jnp.asarray(clouds))

    port = _port_backbone(cfg)
    load_flax(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(clouds))

    keys = [f"sa{i}_{k}" for i in range(1, 5) for k in ("xyz", "features", "inds")]
    keys += ["fp2_features", "fp2_xyz", "fp2_inds"]
    assert sorted(got) == sorted(keys) and sorted(want) == sorted(keys)
    for key in keys:
        w = np.asarray(want[key].astype(jnp.float32) if "features" in key else want[key])
        g = got[key].float().numpy() if "features" in key else got[key].numpy()
        assert g.shape == w.shape, key
        if "features" not in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            atol = FP_ATOL if key.startswith("fp2") else SA_ATOL
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)
