"""The port's RoBERTa warm start (``train/convert.py``) against the JAX package's.

* A random HF-named ``roberta-base`` state dict at the tiny geometry (with
  ``roberta.`` and DDP ``module.`` prefixes, a token-type row, a pooler and
  ``position_ids``) gives the port exactly the tensors that JAX's
  ``warm_start`` (``convert_hf_state_dict``) followed by ``weights.load_flax``
  gives, every other tensor untouched;
* the warm-started text encoder's output matches ``eda_tpu``'s within 1e-4
  (f32, as ``tests/test_torch_grounder.py`` holds it);
* a missing file leaves the weights unchanged and logs; ``model.pt`` is read
  too; ``pp_checkpoint`` is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_data_fixtures
from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu.models.roberta import RobertaEncoder as JaxRoberta
from eda_tpu.train.convert import warm_start as jax_warm_start
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train.convert import warm_start
from eda_tpu_torch.weights import load_flax
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG, JAX_CFG = ModelConfig(use_bf16=True).tiny(), JaxConfig(use_bf16=True).tiny()


@pytest.fixture(scope="module")
def variables():
    """The tiny JAX grounder's variables, random, as numpy."""
    model = JaxGrounder(JAX_CFG)
    inputs = {
        "point_clouds": jax.ShapeDtypeStruct((1, JAX_CFG.num_points, 6), jnp.float32),
        "text_ids": jax.ShapeDtypeStruct((1, 16), jnp.int32),
        "text_mask": jax.ShapeDtypeStruct((1, 16), jnp.bool_),
    }
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False), inputs)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def write_hf(root, prefix: str, name: str = "pytorch_model.bin", seed: int = 4):
    encoder = real_data_fixtures.seeded_roberta(CFG, seed)
    token_type = torch.randn(1, CFG.text_hidden, generator=torch.Generator().manual_seed(9))
    state = real_data_fixtures.hf_roberta_state(encoder, token_type=token_type)
    state = {prefix + k[len("roberta."):]: v for k, v in state.items()}
    (root / "roberta-base").mkdir(exist_ok=True)
    torch.save(state, root / "roberta-base" / name)
    return encoder, token_type


def port_model(variables):
    model = EDAGrounder(dataclasses.replace(CFG, input_feature_dim=3))
    load_flax(model, variables)
    return model


@pytest.mark.parametrize("prefix", ["roberta.", "", "module.roberta."])
def test_warm_start_equals_jax_convert_then_load_flax(tmp_path, variables, prefix):
    encoder, token_type = write_hf(tmp_path, prefix)
    logs = []
    params, stats = jax_warm_start(variables["params"], variables["batch_stats"], JAX_CFG,
                                   data_root=str(tmp_path), log=logs.append)
    want = port_model({"params": params, "batch_stats": stats}).state_dict()
    model = port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got_logs = []
    warm_start(model, CFG, data_root=str(tmp_path), log=got_logs.append)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key in got:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(got[key], before[key]) != key.startswith("text_encoder."), key
    n_text = len(model.text_encoder.state_dict())
    assert got_logs == [f"text_encoder: loaded {n_text} RoBERTa leaves from "
                        f"{tmp_path / 'roberta-base' / 'pytorch_model.bin'}"]
    assert any(f"loaded {n_text} RoBERTa leaves" in line for line in logs)
    # the position table carries token-type row 0; everything else is the encoder's
    text = model.text_encoder.state_dict()
    for key, value in encoder.state_dict().items():
        if key == "embeddings.position_embeddings.weight":
            value = value + token_type[0]
        assert torch.equal(text[key], value), key


def test_text_encoder_output_matches_jax(tmp_path, variables):
    write_hf(tmp_path, "roberta.")
    params, _ = jax_warm_start(variables["params"], variables["batch_stats"], JAX_CFG,
                               data_root=str(tmp_path), log=lambda _: None)
    model = port_model(variables)
    warm_start(model, CFG, data_root=str(tmp_path), log=lambda _: None)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, CFG.text_vocab_size, (3, 40)).astype(np.int32)
    valid = np.arange(40)[None] < np.array([[40], [17], [5]])
    jax_encoder = JaxRoberta(JAX_CFG.text_vocab_size, JAX_CFG.text_hidden, JAX_CFG.text_layers,
                             JAX_CFG.text_heads, JAX_CFG.text_intermediate)
    want = np.asarray(jax_encoder.apply({"params": params["text_encoder"]}, jnp.asarray(ids),
                                        jnp.asarray(valid), train=False))
    with torch.inference_mode():
        got = model.text_encoder(torch.from_numpy(ids), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_missing_file_leaves_the_weights(tmp_path, variables):
    model = port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logs = []
    warm_start(model, CFG, data_root=str(tmp_path), log=logs.append)
    warm_start(model, CFG, data_root=None, log=logs.append)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert logs == [f"text_encoder: no RoBERTa weights under {tmp_path / 'roberta-base'}, "
                    "skipping"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        warm_start(model, CFG, data_root=str(tmp_path), pp_checkpoint="gf.pth")


def test_model_pt_and_geometry_checks(tmp_path, variables):
    encoder, _ = write_hf(tmp_path, "roberta.", name="model.pt")
    model = port_model(variables)
    warm_start(model, CFG, data_root=str(tmp_path), log=lambda _: None)
    assert torch.equal(model.text_encoder.layer[1].output.weight,
                       encoder.layer[1].output.weight)
    narrow = dataclasses.replace(CFG, text_hidden=32, text_heads=2, input_feature_dim=3)
    with pytest.raises(ValueError, match="shape"):
        warm_start(EDAGrounder(narrow), narrow, data_root=str(tmp_path))
