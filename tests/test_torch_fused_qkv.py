"""The fused q/k/v projection (``ModelConfig.fused_qkv``), port vs port and port vs ``eda_tpu``.

``eda_tpu/models/layers.py:_FusedMHACore`` projects in one wide product
wherever q, k and v are the same array, with the parameter tree of the unfused
flax attention. The port's ``MultiHeadAttention(fuse=True)`` does the same by
tensor identity: ``q is k is v`` (language self-attention, RoBERTa), ``q is
k`` (vision and query self-attention, q = k = x + pos), ``k is v`` (every
cross-attention).

Held, with the tolerances of ``tests/test_fused_attention.py`` (1e-5 abs in
f32, 3e-2 in bf16; the full model 2e-4 abs + 1e-4 relative; train-mode
gradients with dropout off 1e-4 abs):
* the port fused against the port unfused on one set of weights: the encoder
  layer (f32, bf16), the decoder layer, the RoBERTa layer, the tiny model, and
  the encoder layer's train-mode gradients;
* the port fused against JAX fused (its weights carried over with
  ``weights.from_flax``): the encoder layer (f32, bf16), the decoder layer,
  the RoBERTa layer and the encoder layer's gradients; the tiny bf16 grounder
  on its TPU serving path (``torch_parity.assert_grounder_outputs_match``);
* the parameters: a fused model's state dict is the unfused one's, JAX fused
  variables load strictly, and a reference ``.pth`` converts into both alike;
* each of the three cases runs one wide product.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    assert_grounder_outputs_match,
    fabricate_eda_state_dict,
    grounder_forwards,
    jax_tpu_serving_path,
    one_torch_thread,
    to_numpy,
)

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.models import layers as jax_layers
from eda_tpu.models.roberta import RobertaLayer as JaxRobertaLayer
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models import layers
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.models.roberta import RobertaLayer
from eda_tpu_torch.train import convert
from eda_tpu_torch.weights import from_flax, load_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_ATOL, BF16_ATOL, GRAD_ATOL = 1e-5, 3e-2, 1e-4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    vis = rng.normal(size=(2, 16, 32)).astype(np.float32)
    pos = rng.normal(size=(2, 16, 32)).astype(np.float32)
    txt = rng.normal(size=(2, 9, 32)).astype(np.float32)
    tvalid = np.array([[1] * 6 + [0] * 3, [1] * 9], bool)
    q = rng.normal(size=(2, 8, 32)).astype(np.float32)
    loc = rng.normal(size=(2, 8, 6)).astype(np.float32)
    det = rng.normal(size=(2, 5, 32)).astype(np.float32)
    dvalid = np.array([[1, 1, 1, 0, 0], [1] * 5], bool)
    h = rng.normal(size=(2, 12, 48)).astype(np.float32)
    hvalid = np.array([[1] * 8 + [0] * 4, [1] * 12], bool)
    return dict(vis=vis, pos=pos, txt=txt, tvalid=tvalid, q=q, loc=loc, det=det, dvalid=dvalid,
                h=h, hvalid=hvalid)


def _t(x):
    return torch.from_numpy(x)


# (JAX module, its call arguments, port module factory, port call) per layer
def _encoder(x, dtype=jnp.float32, fused=True):
    kw = dict(d_model=32, n_heads=4, dim_feedforward=24, dropout=0.0)
    jax_mod = jax_layers.BiEncoderLayer(**kw, dtype=dtype, fused_qkv=fused)
    args = (x["vis"], x["pos"], None, x["txt"], x["tvalid"])
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32

    def port(fu):
        return layers.BiEncoderLayer(32, 4, 24, True, tdtype, 0.0, fused_qkv=fu)

    def call(m, vis=None):
        return m(_t(x["vis"]) if vis is None else vis, _t(x["pos"]), None, _t(x["txt"]),
                 _t(x["tvalid"]))
    return jax_mod, args, port, call


def _decoder(x, fused=True):
    kw = dict(d_model=32, n_heads=4, dim_feedforward=24, dropout=0.0, butd=True)
    jax_mod = jax_layers.BiDecoderLayer(**kw, fused_qkv=fused)
    args = (x["q"], x["vis"], x["txt"], x["loc"], None, x["det"], x["dvalid"])

    def port(fu):
        return layers.BiDecoderLayer(32, 4, 24, "loc_learned", torch.float32, 0.0, butd=True,
                                     fused_qkv=fu)

    def call(m):
        return m(_t(x["q"]), _t(x["vis"]), _t(x["txt"]), _t(x["loc"]), None, _t(x["det"]),
                 _t(x["dvalid"]))
    return jax_mod, args, port, call


def _roberta(x, fused=True):
    jax_mod = JaxRobertaLayer(48, 4, 96, fused_qkv=fused)
    args = (x["h"], x["hvalid"])

    def call(m):
        return m(_t(x["h"]), _t(x["hvalid"]))
    return jax_mod, args, lambda fu: RobertaLayer(48, 4, 96, fused_qkv=fu), call


CASES = {
    "encoder-f32": (lambda x: _encoder(x), F32_ATOL),
    "encoder-bf16": (lambda x: _encoder(x, jnp.bfloat16), BF16_ATOL),
    "decoder": (_decoder, F32_ATOL),
    "roberta": (_roberta, F32_ATOL),
}


def _jax_variables(jax_mod, args, seed=0):
    return to_numpy(jax.jit(lambda *a: jax_mod.init(jax.random.key(seed), *a, train=False))(
        *args))


def _ported(port, fused, variables):
    m = port(fused).eval()
    load_flax(m, variables)
    return m


def _outputs(out):
    return [o.float().detach() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("case", list(CASES))
def test_port_fused_matches_port_unfused_and_jax_fused(case):
    make, atol = CASES[case]
    x = _inputs()
    jax_mod, args, port, call = make(x)
    variables = _jax_variables(jax_mod, args)
    want = jax.jit(lambda v, *a: jax_mod.apply(v, *a, train=False))(variables, *args)
    want = [np.asarray(w, np.float32) for w in (want if isinstance(want, tuple) else (want,))]
    with torch.no_grad():
        fused = _outputs(call(_ported(port, True, variables)))
        unfused = _outputs(call(_ported(port, False, variables)))
    for f, u, w in zip(fused, unfused, want):
        np.testing.assert_allclose(f.numpy(), u.numpy(), atol=atol, rtol=0)
        np.testing.assert_allclose(f.numpy(), w, atol=atol, rtol=0)


def test_train_mode_gradients_match(monkeypatch):
    """Dropout off, train mode: the fused encoder layer's parameter gradients
    equal the unfused port's and JAX fused's (loss: the sum of squares of
    both outputs, as ``tests/test_fused_attention.py``)."""
    x = _inputs(1)
    jax_mod, args, port, call = _encoder(x)
    variables = _jax_variables(jax_mod, args)

    def loss(params):
        out = jax_mod.apply({"params": params}, *args, train=True)
        return jnp.sum(out[0] ** 2) + jnp.sum(out[1] ** 2)

    want = from_flax({"params": to_numpy(jax.jit(jax.grad(loss))(variables["params"]))})
    grads = {}
    for fused in (True, False):
        m = _ported(port, fused, variables).train()
        out = call(m)
        (out[0].pow(2).sum() + out[1].pow(2).sum()).backward()
        grads[fused] = {n: p.grad for n, p in m.named_parameters()}
    assert grads[True].keys() == want.keys()
    for name, g in grads[True].items():
        np.testing.assert_allclose(g.numpy(), grads[False][name].numpy(), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case,want", [
    ("encoder-f32", [2, 2, 2, 3]),  # vision q|k, cross k|v twice, language q|k|v
    ("decoder", [2, 2, 2, 2]),      # query q|k, cross k|v to text, boxes and vision
    ("roberta", [3]),               # q|k|v
])
def test_each_case_runs_one_wide_product(case, want, monkeypatch):
    """The number of projections each wide product of a call holds."""
    make, _ = CASES[case]
    x = _inputs()
    jax_mod, args, port, call = make(x)
    m = _ported(port, True, _jax_variables(jax_mod, args))
    seen = []
    orig = layers.MultiHeadAttention._project

    def counted(self, inp, *dense):
        seen.append(len(dense))
        return orig(self, inp, *dense)

    monkeypatch.setattr(layers.MultiHeadAttention, "_project", counted)
    with torch.no_grad():
        call(m)
    assert sorted(seen) == want


def test_fused_tiny_model_matches_unfused_and_keeps_its_parameters():
    cfg = ModelConfig().tiny()
    plain, fused = EDAGrounder(cfg), EDAGrounder(dataclasses.replace(cfg, fused_qkv=True))
    plain.init_weights(0)
    assert {k: v.shape for k, v in plain.state_dict().items()} == {
        k: v.shape for k, v in fused.state_dict().items()}
    fused.load_state_dict(plain.state_dict())
    inputs = SyntheticScenes(SyntheticConfig(num_points=cfg.num_points, num_objects=4,
                                             text_len=16), vocab_size=cfg.text_vocab_size)
    inputs = {k: torch.from_numpy(v) for k, v in inputs.batch(range(2)).items()}
    with torch.inference_mode():
        a, b = plain.eval()(inputs), fused.eval()(inputs)
    for key in ("last_center", "last_pred_size", "last_sem_cls_scores"):
        np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), atol=2e-4, rtol=1e-4)

    # a reference .pth (of the two-stage model, as the released ones) converts
    # into both alike
    butd = dataclasses.replace(cfg, butd=True)
    params, stats = convert.convert_eda_checkpoint(fabricate_eda_state_dict(butd), butd)
    models = [EDAGrounder(dataclasses.replace(butd, fused_qkv=f)) for f in (False, True)]
    for model in models:
        model.load_state_dict(models[0].state_dict())
        assert convert.merge_into(model, {"params": params, "batch_stats": stats}) > 100
    s1, s2 = (m.state_dict() for m in models)
    assert s1.keys() == s2.keys() and all(torch.equal(s1[k], s2[k]) for k in s1)


def test_fused_tiny_grounder_matches_jax_fused(jax_tpu_serving_path):  # noqa: F811
    """The tiny bf16 grounder with ``fused_qkv`` on both sides; JAX's fused
    variables load strictly into the fused port."""
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), fused_qkv=True)
    jcfg = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), fused_qkv=True)
    inputs = SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                             vocab_size=512).batch(range(2))
    got, want = grounder_forwards(jcfg, cfg, inputs)
    assert_grounder_outputs_match(got, want, cfg)
