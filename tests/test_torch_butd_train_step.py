"""One tiny two-stage (butd) training step of the port against the JAX package's.

``ModelConfig(use_bf16=True).tiny()`` with ``butd``, two synthetic butd scenes
(4 detected boxes each in 132 slots), the JAX side on its TPU training path
with every Pallas kernel interpreted and dropout off, the port on the CPU with
the same weights (``weights.load_flax``, BatchNorm statistics included), the
same batch, dropout off and the JAX run's KPS indices and Hungarian matches,
as ``tests/test_torch_train_step.py`` does and for the reasons its docstring
gives. The gates are that file's (``torch_parity``): the loss within 1%, every
other metric within 5%, except ``grad_norm``, within 20% (``GRAD_NORM_REL``):
at these random weights the butd step's global gradient norm moves by 15% in
either package when the input points move by 1e-6 (measured: JAX 218.98 and
232.85-251.33 over four such moves, the port 231.58-252.07; the port against
JAX on the unmoved input 252.07 / 218.98), the deeper BatchNorms magnifying
bf16 noise as the docstring of ``tests/test_torch_train_step.py`` says,
while the clipped gradients agree leaf by leaf (below); the gradients, read
as AdamW's first moments, at global cosine >= 0.85, per leaf cosine >= 0.4
and norm ratio within 2x. The last decoder layer's ``cross_v`` projections
and ``prediction_head.1``'s center head fail those per-leaf gates against
the port itself when the input points move by 1e-6 (cosine 0.34-0.79, norm
ratio up to 3.1), so the test measures the port's own noise: three more port
steps on inputs moved by 1e-6, and a leaf that fails any of them is held by
the global cosine only (``prediction_head.1.center_head.bn.0.weight`` sits at
cosine 0.38-0.39 against both JAX and the third moved step, at the 0.4 gate); every other leaf must pass against JAX, and at
most ``MAX_NOISY`` leaves may be excused. The leaves whose gradient is zero in exact
arithmetic below 2e-3 of the largest leaf norm, except ``box_embeddings``'
first Dense bias (a train-mode BatchNorm follows it): below 1e-2, since it
sums 2 x 132 bf16 rows, 2 x 128 of them identical padding (JAX's measures
3.3e-3, the port's 1.4e-4); new parameters
within 2 lr, 80% within 0.1 lr; BatchNorm statistics within 1% of the leaf's
largest value, ``box_embeddings``' among them (its batch statistics run over
all 2 x 132 slots, the zero padding included, as flax's do).

The frozen class table (``butd_class_embeddings``) takes no gradient in
either package (its first moment is exactly zero), yet sits in AdamW's main
group, so the step decays it: ``p <- p - lr * wd * p``. The port's new table
must equal ``p * (1 - lr * wd)`` within one f32 ulp and be JAX's new table bit
for bit.
"""

import copy

import numpy as np
import pytest
import torch
from torch_parity import (
    assert_first_moments_match,
    assert_new_parameters_match,
    assert_step_metrics_match,
    jax_train_step,
    leaf_gate_failures,
    one_torch_thread,  # noqa: F401
    port_moments,
    port_train_step,
)

from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu_torch.config import TrainConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TABLE = "butd_class_embeddings.weight"
GRAD_NORM_REL = 0.2
MAX_NOISY = 10  # of the tiny butd model's 336 trained leaves
NOISE_DRAWS = 3


@pytest.fixture(scope="module")
def jax_step():
    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                             vocab_size=512)
    batch = gen.batch(range(2), butd=True)
    batch["inputs"]["det_mask"][1, 2:] = False  # scene 1: 2 of its 4 boxes detected
    return jax_train_step(batch, butd=True)


@pytest.fixture(scope="module")
def port_step(jax_step):
    return port_train_step(jax_step, butd=True)


@pytest.fixture(scope="module")
def noisy_leaves(jax_step, port_step):
    """Leaves whose moments fail the per-leaf gates between the port's step and
    the port's step on input points moved by up to 1e-6 (``NOISE_DRAWS`` draws)."""
    base = port_moments(port_step)
    noisy = set()
    for seed in range(NOISE_DRAWS):
        moved = copy.deepcopy(jax_step["batch"])
        xyz = moved["inputs"]["point_clouds"][..., :3]
        xyz += np.random.default_rng(seed).uniform(-1e-6, 1e-6, xyz.shape).astype(np.float32)
        noisy |= leaf_gate_failures(port_moments(port_train_step({**jax_step, "batch": moved},
                                                                 butd=True)), base)
    return noisy


def test_butd_metrics_and_grad_norm_match(jax_step, port_step):
    assert_step_metrics_match(jax_step["metrics"], port_step["metrics"], GRAD_NORM_REL)
    assert jax_step["metrics"]["grad_norm"] > TrainConfig().clip_norm


def test_butd_gradients_match_as_first_moments(jax_step, port_step, noisy_leaves):
    assert TABLE in jax_step["moments"]  # in the optimizer, with a zero moment
    print(f"butd step: {len(noisy_leaves)} leaves noisy against the port itself: "
          f"{sorted(noisy_leaves)}")
    assert len(noisy_leaves) <= MAX_NOISY
    assert_first_moments_match(jax_step, port_step, excused=noisy_leaves)


def test_butd_new_parameters_and_batch_stats_match(jax_step, port_step):
    assert_new_parameters_match(jax_step, port_step)
    state = port_step["state"].model.state_dict()
    before = {k: torch.from_numpy(np.asarray(v)) for k, v in
              jax_step["variables"]["batch_stats"]["box_embeddings"]["BatchNorm_0"].items()}
    # the box embedding's running statistics moved (train-mode BatchNorm over 2 x 132 rows)
    assert not torch.equal(state["box_embeddings.bn.0.running_mean"], before["mean"])
    assert not torch.equal(state["box_embeddings.bn.0.running_var"], before["var"])


def test_frozen_table_is_only_decayed(jax_step, port_step):
    cfg = TrainConfig()
    p0 = torch.from_numpy(np.array(
        jax_step["variables"]["params"]["butd_class_embeddings"]["embedding"], np.float32))
    got = port_step["state"].model.state_dict()[TABLE]
    want = p0 * (1 - cfg.lr * cfg.weight_decay)
    ulp = torch.abs(torch.nextafter(want, torch.full_like(want, np.inf)) - want)
    assert not torch.equal(got, p0)
    assert ((got - want).abs() <= ulp).all()
    assert torch.equal(got, jax_step["params"][TABLE])
    assert port_step["state"].model.butd_class_embeddings.weight.grad is None
