"""The whole slice: one tiny-config training step of the port vs the JAX package's.

The JAX side runs ``make_train_step`` on its TPU training path with every
Pallas kernel interpreted (``tpu_path(training=True)``: the fused SA takes
``impl="pallas_train"``, the pair pool exports winners and its backward runs
the compact kernel at SA1 and the windowed one at SA2-4) and dropout off
(``cfg.dropout = 0``, ``flax.linen.Dropout`` patched to the identity). It is
computed once per file. The port runs ``make_train_step`` on the CPU with the
same weights (``weights.load_flax``, BatchNorm statistics included), the same
batch, dropout off (``p = 0`` on every ``Dropout``) and the kernels' plain
versions.

Two discrete choices of the step hang on near-ties that the two frameworks'
bf16 rounding can break either way: which seeds KPS keeps (the train-mode
objectness logits differ by up to ~0.05, BatchNorm normalising with batch
statistics over only 2 x 128 seeds) and which query the Hungarian auction
gives each target (random weights predict near-identical boxes). Left alone,
the seed set differs in most weight draws and a flipped match moves a box
loss by 10-30%. So the test hands the port the JAX run's choices: the JAX
step's loss function is wrapped (test-only) to also return its KPS indices
and its matches, and the port's ``top_k_indices`` and ``hungarian_match`` are
replaced by lookups of them. Everything continuous is then compared. The
port's own KPS and auction are held to the JAX ones on identical inputs in
``test_torch_grounder.py`` and ``test_torch_losses.py``.

Compared, with the tolerances and why. At random tiny weights the train-mode
forward is badly conditioned: the deeper decoder layers see near-identical
queries, so their BatchNorms divide by batch standard deviations of ~0.1-0.2
and magnify one-ulp bf16 differences ~10x. The port against itself, with the
input coordinates moved by 1e-6, gives gradients of global cosine 0.73 and a
``grad_norm`` 9% away; the port against JAX does better (measured values in
brackets, this file's inputs):
* the loss within 1% (0.17%); every other metric within 5% (2.8%, the
  largest being ``grad_norm``);
* gradients, read as AdamW's first moments after the step (0.1 x the clipped
  gradient): global cosine >= 0.85 (0.917); per leaf cosine >= 0.4 (0.57)
  and norm ratio within 2x (0.64-1.37); the leaves whose gradient is zero in
  exact arithmetic (attention key biases, Dense biases before a train-mode
  BatchNorm) below 2e-3 of the largest leaf norm on both sides (5.6e-4);
* new parameters within 2 lr of the JAX value (Adam's first step moves each
  by ~lr * sign(g), so a small gradient of the other sign moves it by 2 lr),
  and at least 80% of them within 0.1 lr (88.5%);
* BatchNorm running statistics within 1% of the leaf's largest value (0.18%);
* the frozen text encoder unchanged.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import NO_EXCESS_PRECISION, perturb, to_numpy, tpu_path

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.config import TrainConfig as JaxTrainConfig
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu.losses.criterion import SetCriterionConfig as JaxCriterionConfig
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu.train.optim import make_optimizer
from eda_tpu.losses import criterion as jax_criterion
from eda_tpu.losses.matcher import hungarian_match as jax_hungarian_match
from eda_tpu.models.grounder import decoder_prefixes
from eda_tpu.ops.boxes import box_cxcyczwhd_to_xyzxyz
from eda_tpu.train import step as jax_step_module
from eda_tpu.train.step import TrainState as JaxTrainState
from eda_tpu.train.step import make_train_step as jax_make_train_step
from eda_tpu_torch.config import ModelConfig, TrainConfig
from eda_tpu_torch.losses import criterion as port_criterion
from eda_tpu_torch.losses.criterion import SetCriterionConfig
from eda_tpu_torch.losses.matcher import MatchResult
from eda_tpu_torch.models import grounder as port_grounder
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.models.layers import Dropout
from eda_tpu_torch.train.optim import AdamW, group_of
from eda_tpu_torch.train.step import TrainState, make_train_step
from eda_tpu_torch.weights import from_flax, load_flax

STEPS_PER_EPOCH = 10
LOSS_REL = 0.01
METRIC_REL = 0.05
GLOBAL_COS = 0.85
LEAF_COS = 0.4
NORM_RATIO = 2.0
ZERO_NORM = 2e-3
PARAM_CLOSE = 0.8
BN_REL = 0.01
# parameters whose gradient is zero in exact arithmetic: attention key biases
# (softmax ignores a shift of all logits) and Dense biases that a train-mode
# BatchNorm follows (the batch mean removes them)
ZERO_GRAD = re.compile(r"attn\.key\.bias$|points_obj_cls\.dense\.[01]\.bias$"
                       r"|pos_embed\.dense\.0\.bias$|self_posembed\.dense\.0\.bias$")


def _strip_masked(tree):
    """An optax group state's tree without the MaskedNode leaves of other groups."""
    if isinstance(tree, dict):
        out = {k: _strip_masked(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None}
    return None if isinstance(tree, optax.MaskedNode) else np.asarray(tree, np.float32)


def _first_moments(opt_state) -> dict:
    """Port-named AdamW first moments of every trained JAX parameter."""
    moments = {}
    for state in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(state, optax.ScaleByAdamState):
            moments.update(from_flax({"params": _strip_masked(state.mu)}))
    return moments


DECISIONS = ("__query_inds", "__match_q", "__query_matched", "__query_target")


def _loss_with_decisions(cfg, end_points, targets):
    """The JAX loss, plus its KPS indices and the matches of every prefix
    (the same matcher on the same inputs as inside the loss)."""
    loss, metrics = jax_criterion.compute_hungarian_loss(cfg, end_points, targets)
    gt = jnp.concatenate([targets["center_label"], targets["size_gts"]], -1)
    matches = []
    for p in decoder_prefixes(cfg.num_decoder_layers):
        boxes = jnp.concatenate([end_points[f"{p}center"], end_points[f"{p}pred_size"]], -1)
        logits = end_points[f"{p}sem_cls_scores"]
        matches.append(jax_hungarian_match(
            logits, box_cxcyczwhd_to_xyzxyz(boxes), boxes, gt, box_cxcyczwhd_to_xyzxyz(gt),
            targets["positive_map"][..., :logits.shape[-1]], targets["box_label_mask"] > 0,
            cost_class=cfg.cost_class, cost_bbox=cfg.cost_bbox, cost_giou=cfg.cost_giou))
    metrics["__query_inds"] = end_points["query_points_sample_inds"]
    for name in ("match_q", "query_matched", "query_target"):
        metrics["__" + name] = jnp.concatenate([getattr(m, name) for m in matches])
    return loss, metrics


@pytest.fixture(scope="module")
def jax_step():
    with pytest.MonkeyPatch.context() as mp:
        tpu_path(mp, training=True)
        mp.setattr(jax_step_module, "compute_hungarian_loss", _loss_with_decisions)
        jcfg = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), dropout=0.0)
        gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4,
                                                    text_len=16), vocab_size=512)
        batch = gen.batch(range(2))
        batch_j = jax.tree_util.tree_map(jnp.asarray, batch)
        model = JaxGrounder(jcfg)
        variables = jax.jit(lambda x: model.init(jax.random.key(0), x, train=False))(
            batch_j["inputs"])
        variables = perturb(to_numpy(variables), seed=2)
        tx = make_optimizer(JaxTrainConfig(), variables["params"], STEPS_PER_EPOCH)
        state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
        step = jax_make_train_step(
            model, JaxCriterionConfig(num_decoder_layers=jcfg.num_decoder_layers), donate=False)
        rng = jax.random.key(0)
        compiled = step.lower(state, batch_j, rng).compile(compiler_options=NO_EXCESS_PRECISION)
        new_state, metrics = compiled(state, batch_j, rng)
        return dict(
            batch=batch, variables=variables,
            decisions={k: torch.from_numpy(np.array(metrics[k])) for k in DECISIONS},
            metrics={k: float(v) for k, v in metrics.items() if k not in DECISIONS},
            params=from_flax({"params": to_numpy(new_state.params),
                              "batch_stats": to_numpy(new_state.batch_stats)}),
            moments=_first_moments(new_state.opt_state),
        )


@pytest.fixture(scope="module")
def port_step(jax_step):
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), dropout=0.0)
    model = EDAGrounder(cfg)
    load_flax(model, jax_step["variables"])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    state = TrainState(model, AdamW(model, TrainConfig(), STEPS_PER_EPOCH))
    batch = {group: {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
             for group, arrays in jax_step["batch"].items()}
    dec = jax_step["decisions"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_grounder, "top_k_indices", lambda logits, k: dec["__query_inds"].long())
        mp.setattr(port_criterion, "hungarian_match", lambda *a, **k: MatchResult(
            dec["__match_q"], a[6], dec["__query_matched"], dec["__query_target"],
            torch.zeros(len(a[6]), dtype=torch.int32)))
        metrics = make_train_step(
            SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers))(state, batch)
    return dict(state=state, metrics={k: float(v) for k, v in metrics.items()})


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-300))


def test_metrics_and_grad_norm_match(jax_step, port_step):
    want, got = jax_step["metrics"], port_step["metrics"]
    assert set(got) == set(want)
    assert np.isfinite(list(got.values())).all()
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    for key, w in want.items():
        assert abs(got[key] - w) <= METRIC_REL * abs(w) + 1e-6, (key, got[key], w)
    assert want["grad_norm"] > TrainConfig().clip_norm  # the clip acts


def test_gradients_match_as_first_moments(jax_step, port_step):
    opt = port_step["state"].optimizer
    names = {p: n for n, p in port_step["state"].model.named_parameters()}
    got = {names[p]: mu for p, (mu, _) in opt.moments.items()}
    want = jax_step["moments"]
    assert set(got) == set(want)
    assert not any(group_of(n) == "text" for n in got)
    keys = sorted(want)
    glob = _cos(torch.cat([got[k].flatten() for k in keys]),
                torch.cat([want[k].flatten() for k in keys]))
    assert glob >= GLOBAL_COS, glob
    largest = max(float(w.norm()) for w in want.values())
    for name in keys:
        g, w = got[name], want[name]
        if ZERO_GRAD.search(name):  # zero in exact arithmetic: both must be tiny
            assert max(float(g.norm()), float(w.norm())) < ZERO_NORM * largest, name
            continue
        ratio = float(g.norm() / w.norm())
        assert _cos(g, w) >= LEAF_COS and 1 / NORM_RATIO <= ratio <= NORM_RATIO, (
            name, _cos(g, w), ratio)


def test_new_parameters_and_batch_stats_match(jax_step, port_step):
    model = port_step["state"].model
    cfg = TrainConfig()
    lrs = {"main": cfg.lr, "backbone": cfg.lr_backbone, "text": 0.0}
    state = model.state_dict()
    close = total = 0
    for name, want in jax_step["params"].items():
        got, want = state[name].float(), want.float()
        if name.endswith(("running_mean", "running_var")):
            assert (got - want).abs().max() <= BN_REL * want.abs().max(), name
            continue
        lr = lrs[group_of(name)]
        if lr == 0.0:  # frozen text encoder
            assert torch.equal(got, want), name
            continue
        diff = (got - want).abs()
        assert diff.max() <= 2 * lr * (1 + 1e-3) + 1e-6 * want.abs().max(), name
        close += int((diff <= 0.1 * lr).sum())
        total += diff.numel()
    assert close >= PARAM_CLOSE * total, close / total
