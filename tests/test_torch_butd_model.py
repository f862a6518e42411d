"""The two-stage (butd) grounder of the port against the JAX package's, serving forward.

* The synthetic butd batches (``example``, ``batch``, ``train_batch`` with
  ``butd=True``: the scene's boxes in 132 zero-padded detected-box slots, the
  class ids zero-padded) are byte-identical to JAX's.
* The tiny butd forward (``ModelConfig(use_bf16=True).tiny()`` with ``butd``,
  32-wide box embeddings, the 485 x 768 class table, a ``cross_d`` block in
  every encoder and decoder layer), the JAX model's perturbed weights carried
  over with ``weights.load_flax`` (every new leaf: ``box_embeddings`` with its
  BatchNorm statistics, ``butd_class_embeddings``, ``class_embeddings``, each
  layer's ``cross_d``), eval mode, the JAX side on its TPU serving path with
  every Pallas kernel interpreted. Every prefix within the tolerances of
  ``tests/test_torch_grounder.py`` (absolute: 0.03 for centers, sizes, class
  scores and objectness logits, 0.02 for the contrastive projections, 1e-4
  for the f32 text features). Of the three scenes, one has every detected box
  valid, one none (its ``cross_d`` keys all invalid: flax gives uniform
  weights over the 132 keys, and so must the port, not NaN) and one 3 of 132.
  KPS: at these random weights each scene's objectness logits have near-ties
  at the top-32 boundary (JAX gaps of 5e-4, 8e-4 and 3e-3 between the 32nd
  and 33rd seed) under the packages' ~0.01 logit difference, so the port's
  own top 32 swaps 1-3 boundary seeds a scene (ROADMAP Queue 3 item 1). The
  port therefore runs on the JAX run's query indices, so that every head is
  compared on the same queries, and its own KPS is held separately: it keeps
  JAX's seeds except seeds within 0.06 of the boundary logit.
* ``weights.to_flax`` carries the butd model's state back into the JAX tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    assert_grounder_outputs_match,
    assert_kps_matches_up_to_boundary_ties,
    assert_same_arrays,
    grounder_forwards,
    jax_tpu_serving_path,
    one_torch_thread,
)

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.models.layers import MultiHeadAttention
from eda_tpu_torch.weights import from_flax, to_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), butd=True)
JAX_CFG = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), butd=True)
SCENES = dict(num_points=1024, num_objects=4, text_len=16)


def butd_inputs() -> dict:
    """Three synthetic butd scenes: all boxes valid, none valid, 3 of 132 valid."""
    inputs = SyntheticScenes(SyntheticConfig(**SCENES), vocab_size=512).batch(range(3), butd=True)
    inputs["det_mask"][1] = False
    rng = np.random.default_rng(3)
    inputs["det_mask"][2] = False
    inputs["det_mask"][2, [0, 2, 3]] = True
    inputs["det_boxes"][2, :3] = rng.uniform(-2, 2, (3, 6)).astype(np.float32) ** 2
    inputs["det_class_ids"][2, :3] = [7, 484, 100]
    return inputs


@pytest.mark.parametrize("max_objects", [16, 132])
def test_synthetic_butd_batches_are_jax_s(max_objects):
    cfg = dict(SCENES, max_objects=max_objects)
    got = SyntheticScenes(SyntheticConfig(**cfg), vocab_size=512)
    want = JaxSyntheticScenes(JaxSyntheticConfig(**cfg), vocab_size=512)
    for idx in (0, 5):
        g, w = got.example(idx, butd=True), want.example(idx, butd=True)
        assert g["utterance"] == w["utterance"]
        for group in ("inputs", "targets"):
            assert_same_arrays(g[group], w[group], f"example {idx} {group}")
        assert g["inputs"]["det_boxes"].shape == (132, 6)
        assert g["inputs"]["det_mask"].sum() == SCENES["num_objects"]
    w = want.batch([1, 4], butd=True)
    g = got.train_batch([1, 4], butd=True)
    for group in ("inputs", "targets"):
        assert_same_arrays(g[group], w[group], f"train_batch {group}")
    assert_same_arrays(got.batch([1, 4], butd=True), w["inputs"], "batch")
    assert "det_boxes" not in got.batch([1], butd=False)


def test_butd_grounder_matches_jax_serving_path(jax_tpu_serving_path):  # noqa: F811
    inputs = butd_inputs()
    got, want = grounder_forwards(JAX_CFG, CFG, inputs, jax_kps=True)
    assert_grounder_outputs_match(got, want, CFG)
    excused = assert_kps_matches_up_to_boundary_ties(got, want, CFG.num_queries)
    print(f"butd forward: boundary seeds excused per scene {excused}")
    assert np.isfinite(got["last_center"]).all()
    assert got["last_center"].shape == (3, CFG.num_queries, 3)


def test_cross_d_over_no_valid_box_is_uniform():
    """All keys invalid: every query averages the 132 values (uniform weights), as
    flax's ``finfo.min`` logits give, in bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        attn = MultiHeadAttention(32, 4, dtype)
        for p in attn.parameters():
            torch.nn.init.normal_(p, std=0.3, generator=torch.Generator().manual_seed(0))
        q = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(1))
        kv = torch.randn(2, 132, 32, generator=torch.Generator().manual_seed(2))
        got = attn(q, kv, kv, torch.zeros(2, 132, dtype=torch.bool))
        values = attn.value(kv).float().mean(1, keepdim=True).to(dtype)
        want = attn.out(values.expand(-1, 5, -1))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), atol=0.03, rtol=0)


def test_butd_state_carries_back_to_flax():
    model = JaxGrounder(JAX_CFG)
    inputs = {k: jnp.asarray(v) for k, v in butd_inputs().items()}
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False), inputs)
    port = EDAGrounder(CFG)
    port.init_weights(4)
    state = port.state_dict()
    back = from_flax(to_flax(state, shapes))
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k].float()) for k in state)
    new = [k for k in state if k.startswith(("box_embeddings.", "butd_class_embeddings.",
                                              "class_embeddings."))]
    assert sorted(new) == sorted([
        "box_embeddings.dense.0.weight", "box_embeddings.dense.0.bias",
        "box_embeddings.dense.1.weight", "box_embeddings.dense.1.bias",
        "box_embeddings.bn.0.weight", "box_embeddings.bn.0.bias",
        "box_embeddings.bn.0.running_mean", "box_embeddings.bn.0.running_var",
        "butd_class_embeddings.weight", "class_embeddings.weight", "class_embeddings.bias"])
    assert state["butd_class_embeddings.weight"].shape == (485, 768)
    assert not port.butd_class_embeddings.weight.requires_grad
    n_cross_d = CFG.num_encoder_layers + CFG.num_decoder_layers
    assert len({k.rsplit(".attn", 1)[0] for k in state if ".cross_d.attn" in k}) == n_cross_d
