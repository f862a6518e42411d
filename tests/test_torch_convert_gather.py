"""A released-layout EDA state dict, converted for the gather SA, runs in both packages alike.

The reference's PointNet++ is the gather SA in f32: its checkpoints hold each
SA layer's ``mlp_module`` (1x1 convolutions without bias, BatchNorms). A
reference-layout state dict of the tiny two-stage config
(``torch_parity.fabricate_eda_state_dict``) goes through each package's
``convert_eda_checkpoint(cfg)`` with ``sa_impl="gather"`` and
``use_bf16=False``: the trees are equal leaf for leaf (``sa{i}/SharedMLP_0``
with Dense kernels and BatchNorm scale, bias, mean and var), every leaf of
both models comes from the checkpoint, and the two forwards agree at every
prefix (``torch_parity.assert_grounder_outputs_match``, the port's own KPS:
the f32 logits differ by ~1e-4, under the seeds' gaps at the boundary).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_convert_eda import assert_same_tree
from torch_parity import (  # noqa: F401
    assert_grounder_outputs_match,
    fabricate_eda_state_dict,
    grounder_forwards,
    jax_tpu_serving_path,
    one_torch_thread,
    to_numpy,
)

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu.train import convert as jax_convert
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.models.pointnet2 import SetAbstraction
from eda_tpu_torch.train import convert
from eda_tpu_torch.weights import from_flax, load_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GATHER = dict(butd=True, sa_impl="gather")
CFG = dataclasses.replace(ModelConfig().tiny(), **GATHER)
JAX_CFG = dataclasses.replace(JaxConfig().tiny(), **GATHER)


def test_gather_checkpoint_converts_and_runs_as_jax(jax_tpu_serving_path):  # noqa: F811
    sd = fabricate_eda_state_dict(JAX_CFG)
    got = convert.convert_eda_checkpoint(sd, CFG)
    want = jax_convert.convert_eda_checkpoint(sd, JAX_CFG)
    for g, w in zip(got, want):
        assert_same_tree(g, w)
    params, stats = want
    for i in range(1, 5):
        assert set(params["backbone_net"][f"sa{i}"]["SharedMLP_0"]) == {
            f"{m}_{j}" for m in ("Dense", "BatchNorm") for j in range(3)}
        assert set(stats["backbone_net"][f"sa{i}"]["SharedMLP_0"]["BatchNorm_0"]) == {
            "mean", "var"}

    inputs = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                                vocab_size=JAX_CFG.text_vocab_size).batch(range(2), butd=True)
    inputs = inputs["inputs"]
    jax_model = JaxGrounder(JAX_CFG)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    init = to_numpy(jax.jit(lambda x: jax_model.init(jax.random.key(0), x, train=False))(jin))
    merged_p, n_p = jax_convert.merge_into(init["params"], params)
    merged_s, n_s = jax_convert.merge_into(init["batch_stats"], stats)
    merged = {"params": merged_p, "batch_stats": merged_s}

    model = EDAGrounder(CFG)
    load_flax(model, init)
    n = convert.merge_into(model, {"params": got[0]}) + convert.merge_into(
        model, {"batch_stats": got[1]})
    state, want_state = model.state_dict(), from_flax(merged)
    assert n == n_p + n_s == len(want_state)  # every leaf from the checkpoint
    assert all(torch.equal(state[k], want_state[k]) for k in want_state)
    assert isinstance(model.backbone_net.sa1, SetAbstraction)

    ends, ref = grounder_forwards(JAX_CFG, CFG, inputs, variables=merged)
    assert_grounder_outputs_match(ends, ref, CFG)
    assert np.isfinite(ends["last_center"]).all()
