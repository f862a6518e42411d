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

A second step runs at the converged tiny checkpoint (``torch_tiny_overfit.npz``)
with the port's own KPS and auction: its matches must be JAX's, its loss and
metrics within the tolerances above (``test_converged_step_with_the_ports_own_decisions``).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    LOSS_REL,
    METRIC_REL,
    assert_first_moments_match,
    assert_new_parameters_match,
    assert_step_metrics_match,
    jax_train_step,
    port_train_step,
)

from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu_torch.config import TrainConfig
from eda_tpu_torch.weights import to_flax


@pytest.fixture(scope="module")
def jax_step():
    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                             vocab_size=512)
    return jax_train_step(gen.batch(range(2)))


@pytest.fixture(scope="module")
def port_step(jax_step):
    return port_train_step(jax_step)


def test_metrics_and_grad_norm_match(jax_step, port_step):
    assert_step_metrics_match(jax_step["metrics"], port_step["metrics"])
    assert jax_step["metrics"]["grad_norm"] > TrainConfig().clip_norm  # the clip acts


def test_gradients_match_as_first_moments(jax_step, port_step):
    assert_first_moments_match(jax_step, port_step)


def test_new_parameters_and_batch_stats_match(jax_step, port_step):
    assert_new_parameters_match(jax_step, port_step)


def test_converged_step_with_the_ports_own_decisions():
    """At the converged tiny checkpoint (``tests/torch_tiny_overfit.npz``, two
    of its training scenes) the port runs its own KPS and auction. The
    matches must be JAX's and the loss and metrics within the tolerances
    above. The KPS seed set is not held: the train-mode objectness logits'
    gap at the KPS boundary (0.029-0.062, adjacent gaps among the top 33 down
    to 0.004) lies under the packages' ~0.05 train-mode difference, and one
    seed of each scene differs (ROADMAP Queue 3); the gradient and parameter
    gates above are not held here either: at convergence some leaves' gradients
    are ~1e-7 and their cosine is noise."""
    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4, text_len=32,
                                                max_objects=16), vocab_size=512)
    with np.load(Path(__file__).with_name("torch_tiny_overfit.npz")) as f:
        state = {k: torch.from_numpy(f[k]) for k in f.files}

    def converged(model, batch_j):
        shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False),
                                batch_j["inputs"])
        return to_flax(state, shapes)

    want = jax_train_step(gen.batch(range(2)), converged)
    got = port_train_step(want, own_decisions=True)
    match, dec = got["decisions"]["match"], want["decisions"]
    valid, matched = match.target_valid, match.query_matched
    assert valid.sum() > 0
    assert torch.equal(match.match_q[valid], dec["__match_q"].long()[valid])
    assert torch.equal(matched, dec["__query_matched"].bool())
    assert torch.equal(match.query_target[matched], dec["__query_target"].long()[matched])
    kps = got["decisions"]["kps"]
    differ = [len(set(k.tolist()) - set(w.tolist()))
              for k, w in zip(kps, dec["__query_inds"].long())]
    print(f"converged step: matches equal JAX's; KPS seeds differing per scene {differ}")
    w, g = want["metrics"], got["metrics"]
    assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"])
    for key in w:
        assert abs(g[key] - w[key]) <= METRIC_REL * abs(w[key]) + 1e-6, (key, g[key], w[key])
