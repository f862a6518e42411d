"""The port's converters (``train/convert.py``, ``train/checkpoint.py``, the
class-table tool) against the JAX package's, on constructed state dicts.

A reference-layout BeaUTyDETR state dict of the tiny fused butd config
(``torch_parity.fabricate_eda_state_dict``, built as
``tests/test_convert_eda.py`` builds it: random torch modules with the
reference's names):

* ``convert_eda_checkpoint`` gives the JAX converter's (params, batch_stats)
  trees leaf for leaf, bit for bit (the fused SA takes only the conv kernels,
  as ``w{i}``); merged into the two models' init, the port's state is the JAX
  tree's under ``weights.from_flax``, every leaf but the fused SA's biases and
  LayerNorms replaced, and the two forwards agree within
  ``tests/test_torch_grounder.py``'s tolerances (KPS as in
  ``test_torch_butd_model.py``);
* ``load_eda_pth`` on a ``.pth`` with an epoch, the run's flags and DDP
  prefixes gives JAX's start epoch and state; ``merge_into`` raises as JAX's
  on an unknown leaf (``KeyError``) and a wrong shape (``ValueError``) and
  then writes nothing;
* ``warm_start``'s ``pp_checkpoint`` (a GroupFree-style ``backbone_net.``
  checkpoint) and ``class_embeddings3d.npy`` branches give JAX's trees and log
  lines; a table of the wrong shape is skipped with its log line;
* ``torch_state(read_torch_checkpoint(path))`` returns the numpy state dict of
  JAX's ``load_torch_checkpoint``;
* ``tools.gen_class_embeddings.generate`` gives JAX's ``generate`` table
  within 1e-4 (f32, as ``test_torch_warm_start.py`` holds the text encoder)
  with the same encoder weights (an HF-named file, through each package's
  converter) and the fabricated byte-level BPE.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    assert_grounder_outputs_match,
    assert_kps_matches_up_to_boundary_ties,
    fabricate_eda_state_dict,
    grounder_forwards,
    jax_tpu_serving_path,
    one_torch_thread,
    to_numpy,
)

import real_data_fixtures
from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu.train import checkpoint as jax_checkpoint
from eda_tpu.train import convert as jax_convert
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train import checkpoint, convert
from eda_tpu_torch.weights import from_flax, load_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), butd=True)
JAX_CFG = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), butd=True)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_same_tree(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape and np.array_equal(got[key], want[key]), key


@pytest.fixture(scope="module")
def sd():
    return fabricate_eda_state_dict(JAX_CFG)


@pytest.fixture(scope="module")
def inputs():
    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                             vocab_size=JAX_CFG.text_vocab_size)
    return gen.batch(range(2), butd=True)["inputs"]


@pytest.fixture(scope="module")
def init(inputs):
    """The tiny fused butd JAX grounder's init variables, as numpy."""
    model = JaxGrounder(JAX_CFG)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    return to_numpy(jax.jit(lambda x: model.init(jax.random.key(0), x, train=False))(jin))


def port_model(variables):
    model = EDAGrounder(CFG)
    load_flax(model, variables)
    return model


def test_convert_eda_checkpoint_equals_jax(sd):
    got = convert.convert_eda_checkpoint(sd, CFG)
    want = jax_convert.convert_eda_checkpoint(sd, JAX_CFG)
    for g, w in zip(got, want):
        assert_same_tree(g, w)
    assert set(got[0]["backbone_net"]["sa1"]) == {"w0", "w1", "w2"}
    assert "cross_d" in got[0]["cross_encoder_0"] and "cross_d" in got[0]["decoder_1"]
    assert got[0]["butd_class_embeddings"]["embedding"].shape == (485, 768)


def test_converted_models_agree(sd, init, inputs, jax_tpu_serving_path):  # noqa: F811
    params, stats = jax_convert.convert_eda_checkpoint(sd, JAX_CFG)
    merged_p, n_p = jax_convert.merge_into(init["params"], params)
    merged_s, n_s = jax_convert.merge_into(init["batch_stats"], stats)
    merged = {"params": merged_p, "batch_stats": merged_s}
    model = port_model(init)
    n = convert.merge_into(model, {"params": convert.convert_eda_checkpoint(sd, CFG)[0]})
    n += convert.merge_into(model, {"batch_stats": convert.convert_eda_checkpoint(sd, CFG)[1]})
    assert n == n_p + n_s
    state, want = model.state_dict(), from_flax(merged)
    assert state.keys() == want.keys() and all(torch.equal(state[k], want[k]) for k in want)
    # every leaf comes from the checkpoint but the fused SA's biases and LayerNorms
    kept = {k for k in want if k.startswith("backbone_net.sa") and ".kernels." not in k}
    assert len(want) - n == len(kept)

    got, ref = grounder_forwards(JAX_CFG, CFG, inputs, jax_kps=True, variables=merged)
    assert_grounder_outputs_match(got, ref, CFG)
    assert_kps_matches_up_to_boundary_ties(got, ref, CFG.num_queries)


@pytest.mark.parametrize("payload", ["released", "bare"])
def test_load_eda_pth_equals_jax(sd, init, tmp_path, payload):
    tensors = {"module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if payload == "released":
        tensors = {"model": tensors, "epoch": 7, "config": argparse.Namespace(lr=2e-4),
                   "optimizer": {"state": {}, "param_groups": [{"lr": 2e-4}]}}
    path = tmp_path / "eda.pth"
    torch.save(tensors, path)
    logs, jax_logs = [], []
    params, stats, want_epoch = jax_convert.load_eda_pth(
        str(path), init["params"], init["batch_stats"], JAX_CFG, log=jax_logs.append)
    model = port_model(init)
    epoch = convert.load_eda_pth(str(path), model, CFG, log=logs.append)
    assert epoch == want_epoch == (8 if payload == "released" else 0)
    want = from_flax({"params": params, "batch_stats": stats})
    state = model.state_dict()
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert logs == jax_logs


def test_merge_into_refuses_as_jax(init):
    model = port_model(init)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    good = np.ones((485, 768), np.float32)
    unknown = {"params": {"class_embeddings": {"kernel": np.ones((768, 64), np.float32)},
                          "stray": {"kernel": np.ones((2, 2), np.float32)}}}
    wrong = {"params": {"butd_class_embeddings": {"embedding": good},
                        "pos_embed": {"Dense_0": {"kernel": np.ones((3, 7), np.float32)}}}}
    for variables, error in ((unknown, KeyError), (wrong, ValueError)):
        with pytest.raises(error):
            jax_convert.merge_into(init["params"], variables["params"])
        with pytest.raises(error):
            convert.merge_into(model, variables)
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("table_rows", [485, 484])
def test_warm_start_pp_checkpoint_and_class_table_equal_jax(sd, init, tmp_path, table_rows):
    backbone = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()
                if k.startswith("backbone_net.")}
    torch.save({"model": backbone, "epoch": 3}, tmp_path / "gf_detector.pth")
    table = np.random.default_rng(1).normal(size=(table_rows, 768)).astype(np.float32)
    np.save(tmp_path / "class_embeddings3d.npy", table)
    logs, jax_logs = [], []
    params, stats = jax_convert.warm_start(
        init["params"], init["batch_stats"], JAX_CFG, data_root=str(tmp_path),
        pp_checkpoint=str(tmp_path / "gf_detector.pth"), log=jax_logs.append)
    model = port_model(init)
    convert.warm_start(model, CFG, data_root=str(tmp_path),
                       pp_checkpoint=str(tmp_path / "gf_detector.pth"), log=logs.append)
    want = from_flax({"params": params, "batch_stats": stats})
    state = model.state_dict()
    assert all(torch.equal(state[k], want[k]) for k in want)
    # JAX logs nothing for an absent roberta-base; the port says it skips
    assert logs == [jax_logs[0], f"text_encoder: no RoBERTa weights under "
                    f"{tmp_path / 'roberta-base'}, skipping", jax_logs[1]]
    assert "warm-started 32 backbone leaves" in logs[0]  # 12 SA kernels, 20 FP leaves
    loaded = torch.equal(state["butd_class_embeddings.weight"], torch.from_numpy(table))
    assert loaded == (table_rows == 485)
    assert ("skipping" in logs[2]) == (table_rows != 485)


def test_load_torch_checkpoint_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    state = {"module.a.weight": torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32)),
             "b.running_mean": torch.zeros(4), "b.num_batches_tracked": torch.tensor(5)}
    for payload in ({"model": state, "epoch": 2}, state):
        torch.save(payload, tmp_path / "x.pth")
        got = checkpoint.torch_state(checkpoint.read_torch_checkpoint(str(tmp_path / "x.pth")))
        want = jax_checkpoint.load_torch_checkpoint(str(tmp_path / "x.pth"))
        assert got.keys() == want.keys() == {"a.weight", "b.running_mean",
                                             "b.num_batches_tracked"}
        assert all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype
                   for k in want)


def test_gen_class_embeddings_equals_jax_generate(tmp_path, monkeypatch):
    from eda_tpu.models import roberta as jax_roberta
    from eda_tpu.models import tokenizer as jax_tokenizer
    from eda_tpu.tools.gen_class_embeddings import generate as jax_generate
    from eda_tpu_torch.data.class_config import class485_names
    from eda_tpu_torch.tools import gen_class_embeddings

    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), text_vocab_size=4096)
    rb = tmp_path / "roberta-base"
    real_data_fixtures.write_bpe_vocab(rb, real_data_fixtures.fixture_corpus()
                                       + class485_names()[:40])
    encoder = real_data_fixtures.seeded_roberta(cfg, seed=5)
    hf = real_data_fixtures.hf_roberta_state(encoder)
    torch.save(hf, rb / "pytorch_model.bin")
    names = class485_names()[:40]
    got = gen_class_embeddings.generate(str(rb / "pytorch_model.bin"), names, str(rb), cfg,
                                        device="cpu")

    # JAX's tool on the same BPE and the same weights, at the tiny geometry
    jax_make = jax_tokenizer.make_tokenizer
    monkeypatch.setattr(jax_tokenizer, "make_tokenizer", lambda *a, **k: jax_make(str(rb)))
    monkeypatch.setattr(jax_roberta, "RobertaEncoder", functools.partial(
        jax_roberta.RobertaEncoder, vocab_size=cfg.text_vocab_size, num_layers=cfg.text_layers,
        heads=cfg.text_heads, intermediate=cfg.text_intermediate))
    state = {k[len("roberta."):]: v.numpy() for k, v in hf.items()}
    params = jax_roberta.convert_hf_state_dict(state, cfg.text_layers, cfg.text_heads)
    want = jax_generate(params, names, hidden=cfg.text_hidden)
    assert got.shape == want.shape == (40, cfg.text_hidden) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(want).max() > 100 * 1e-4  # the tolerance is 1% of the table's scale
