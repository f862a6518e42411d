"""The gather SA backbone (``sa_impl="gather"``) vs ``eda_tpu``'s, eval and train mode.

``ModelConfig().tiny()`` widths with ``sa_impl="gather"``: per SA layer FPS
over the whole cloud, the ball query in ``sa_ball_mode`` (``nearest`` or
``first``), the grouped neighbourhoods through ``SharedMLP`` (Dense without
bias, BatchNorm, ReLU) and a max over the neighbours
(``eda_tpu/models/pointnet2.py:54-103``); the seeds' indices are
``sa1_inds[:, :num_seed]`` (``:322``). The JAX model's own perturbed
variables (BatchNorm statistics included) are carried over with
``weights.load_flax``: the flax tree's ``SharedMLP_0`` is the port's ``mlp``.
The gather path calls no Pallas kernel, so the JAX side runs as it is.

In train mode both sides normalise with the batch statistics and update the
running ones (flax ``mutable=["batch_stats"]``, the port's ``BatchNorm`` in
``train()``).

Tolerances (measured maxima in brackets):
* indices and coordinates exact;
* f32: SA features within 1e-3 abs + 1e-3 relative (eval 4.8e-7; train
  3.2e-4: four layers of train-mode BatchNorm magnify f32 sums taken in
  other orders); ``fp2_features`` within 1e-3 in eval (9.2e-5) and 0.05 in
  train (8.7e-3), as the bf16 backbone's FP tolerance: the FP layers'
  inverse-distance weights take ``sqrt(d2)`` of the ``|a|^2 + |b|^2 - 2ab``
  expansion, whose cancellation at small d2 both packages' f32 sums round
  differently, and the train-mode BatchNorm magnifies it;
* bf16, eval: the bf16 backbone's tolerances (``test_torch_backbone.py``:
  SA features 0.03, ``fp2_features`` 0.05 abs; measured 1.1e-3 and 2.8e-3);
* bf16, train: each feature tensor within 5% in relative norm, ||port -
  JAX|| / ||JAX||. A batch-statistics BatchNorm turns a flipped bf16
  rounding of a Dense output into several bf16 steps of the normalised
  value, and each layer compounds it (ROADMAP Queue 3 item 1's train-mode
  noise): measured 2.8e-4 / 3.0e-3 / 8.6e-3 / 2.1e-2 / 3.3e-2 at SA1-SA4
  and ``fp2`` (``nearest``; ``first`` up to 4.0e-2), largest single
  differences 0.09 at SA1 to 0.36 at ``fp2``;
* running statistics within 1e-4 of each leaf's largest value in f32, 1% in
  bf16 (as ``torch_parity.BN_REL``).

The bf16 gather grounder's serving forward is held as the bf16 fused one
(``test_torch_grounder.py``, ``torch_parity.assert_grounder_outputs_match``) on
JAX's KPS indices: its bf16 objectness logits differ by up to the same ~0.03,
over near-tied seeds at the KPS boundary, so the port's own KPS is checked to
keep JAX's seeds up to those ties (``assert_kps_matches_up_to_boundary_ties``).
The f32 grounders, fused and gather, are in ``test_torch_f32_model.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_backbone import FP_ATOL, SA_ATOL
from torch_parity import (  # noqa: F401
    assert_grounder_outputs_match,
    assert_kps_matches_up_to_boundary_ties,
    compiled,
    grounder_forwards,
    jax_tpu_serving_path,
    one_torch_thread,
    perturb,
    to_numpy,
)

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.models.pointnet2 import PointNetPPBackbone as JaxBackbone
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.pointnet2 import PointNetPPBackbone, SetAbstraction
from eda_tpu_torch.weights import from_flax, load_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_TOL = 1e-3
BF16_TRAIN_REL = 0.05
BN_REL = {True: 0.01, False: 1e-4}  # by use_bf16


def _backbones(cfg, jcfg):
    dt = jnp.bfloat16 if cfg.use_bf16 else jnp.float32
    jax_model = JaxBackbone(
        npoints=tuple(jcfg.sa_npoints), radii=tuple(jcfg.sa_radii),
        nsamples=tuple(jcfg.sa_nsamples), mlps=tuple(tuple(m) for m in jcfg.sa_mlps),
        fp_mlps=tuple(tuple(m) for m in jcfg.fp_mlps), sa_impl="gather",
        sa_ball_mode=jcfg.sa_ball_mode, sa_windows=tuple(jcfg.sa_windows),
        points_presorted=jcfg.points_presorted, dtype=dt)
    port = PointNetPPBackbone(
        input_feature_dim=cfg.input_feature_dim, npoints=tuple(cfg.sa_npoints),
        radii=tuple(cfg.sa_radii), mlps=tuple(tuple(m) for m in cfg.sa_mlps),
        fp_mlps=tuple(tuple(m) for m in cfg.fp_mlps), sa_windows=tuple(cfg.sa_windows),
        dtype=torch.bfloat16 if cfg.use_bf16 else torch.float32, sa_impl="gather",
        nsamples=tuple(cfg.sa_nsamples), sa_ball_mode=cfg.sa_ball_mode)
    return jax_model, port


@pytest.fixture(scope="module")
def clouds():
    return SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4),
                           vocab_size=512).batch(range(2))["point_clouds"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("ball_mode", ["nearest", "first"])
def test_gather_backbone_matches_jax(clouds, ball_mode, use_bf16, train):
    over = dict(sa_impl="gather", sa_ball_mode=ball_mode)
    cfg = dataclasses.replace(ModelConfig(use_bf16=use_bf16).tiny(), **over)
    jcfg = dataclasses.replace(JaxConfig(use_bf16=use_bf16).tiny(), **over)
    jax_model, port = _backbones(cfg, jcfg)
    x = jnp.asarray(clouds)
    variables = jax.jit(lambda x: jax_model.init(jax.random.key(0), x, train=False))(x)
    variables = perturb(to_numpy(variables), seed=3)
    assert "SharedMLP_0" in variables["params"]["sa1"]
    if train:
        want, new_vars = compiled(
            lambda v, x: jax_model.apply(v, x, train=True, mutable=["batch_stats"]),
            variables, x)
    else:
        want = compiled(lambda v, x: jax_model.apply(v, x, train=False), variables, x)

    load_flax(port, variables)
    assert isinstance(port.sa1, SetAbstraction) and port.sa1.ball_mode == ball_mode
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(clouds))

    keys = [f"sa{i}_{k}" for i in range(1, 5) for k in ("xyz", "features", "inds")]
    keys += ["fp2_features", "fp2_xyz", "fp2_inds"]
    assert sorted(got) == sorted(keys) and sorted(want) == sorted(keys)
    np.testing.assert_array_equal(got["fp2_inds"].numpy(),
                                  got["sa1_inds"][:, :cfg.sa_npoints[1]].numpy())
    for key in keys:
        w = np.asarray(want[key], np.float32 if "features" in key else None)
        g = got[key].float().numpy() if "features" in key else got[key].numpy()
        assert g.shape == w.shape, key
        if "features" not in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif use_bf16 and train:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= BF16_TRAIN_REL, (key, rel)
        elif use_bf16:
            atol = FP_ATOL if key.startswith("fp2") else SA_ATOL
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)
        else:
            tol = FP_ATOL if key.startswith("fp2") and train else F32_TOL
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=key)
    if train:
        stats = from_flax({"batch_stats": to_numpy(new_vars["batch_stats"])})
        state = port.state_dict()
        assert stats and all(k in state for k in stats)
        for k, w in stats.items():
            g = state[k]
            assert (g - w).abs().max() <= BN_REL[use_bf16] * w.abs().max(), k


@pytest.mark.parametrize("ball_mode", ["nearest", "first"])
def test_bf16_gather_grounder_matches_jax(jax_tpu_serving_path, ball_mode):  # noqa: F811
    over = dict(sa_impl="gather", sa_ball_mode=ball_mode)
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), **over)
    jcfg = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), **over)
    inputs = SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                             vocab_size=512).batch(range(2, 4))
    got, want = grounder_forwards(jcfg, cfg, inputs, jax_kps=True)
    assert_grounder_outputs_match(got, want, cfg)
    assert_kps_matches_up_to_boundary_ties(got, want, cfg.num_queries)
