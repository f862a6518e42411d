"""Checkpoints of the port (``train/checkpoint.py``) and the (seed, step) dropout stream.

* the twins of ``tests/test_checkpoint.py:33-60``: a round trip, the
  ``save_freq`` cadence, ``restore_optimizer=False``; and ``max_to_keep``;
* n steps, save, restore into a model built from another seed, one more
  step: bit-identical (parameters, BatchNorm statistics, AdamW moments,
  metrics) to the run that never stopped, with dropout on;
* the dropout masks of a step depend on (seed, step) only, are drawn from
  the step's generator, and train mode without one raises.
"""

import dataclasses

import pytest
import torch

from eda_tpu_torch.config import ModelConfig, TrainConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.losses.criterion import SetCriterionConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.models.layers import Dropout
from eda_tpu_torch.train.checkpoint import CheckpointManager
from eda_tpu_torch.train.optim import AdamW
from eda_tpu_torch.train.step import (TrainState, dropout_generator, make_train_step,
                                      step_generator)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), num_decoder_layers=1,
                          num_encoder_layers=1)
SEED = 3


def _batch(indices=range(2)):
    gen = SyntheticScenes(SyntheticConfig(num_points=CFG.num_points, num_objects=3,
                                          text_len=16, max_objects=8),
                          vocab_size=CFG.text_vocab_size)
    return {group: {k: torch.from_numpy(v) for k, v in arrays.items()}
            for group, arrays in gen.train_batch(indices).items()}


def small_state(weights_seed=0):
    model = EDAGrounder(CFG)
    model.init_weights(weights_seed)
    return TrainState(model, AdamW(model, TrainConfig(), steps_per_epoch=10))


def _step():
    return make_train_step(SetCriterionConfig(num_decoder_layers=CFG.num_decoder_layers),
                           seed=SEED)


def _equal_states(a: TrainState, b: TrainState) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (a.step == b.step and sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and oa["count"] == ob["count"]
            and all(torch.equal(x, y) for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"])))


def test_checkpoint_roundtrip(tmp_path):
    state = small_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_freq=1)
    assert mgr.latest_epoch() is None
    assert mgr.restore(state) == (state, 0)
    _step()(state, _batch())
    state.step = 42
    assert mgr.save(epoch=0, state=state)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["epoch_0.pt"]

    fresh = small_state(weights_seed=1)
    restored, start_epoch = mgr.restore(fresh)
    assert start_epoch == 1 and restored.step == 42
    assert _equal_states(restored, state)


def test_checkpoint_save_freq(tmp_path):
    state = small_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_freq=5)
    assert not mgr.save(epoch=0, state=state)  # (0 + 1) % 5 != 0
    assert mgr.latest_epoch() is None
    assert mgr.save(epoch=4, state=state)
    assert mgr.latest_epoch() == 4
    assert mgr.save(epoch=7, state=state, force=True)
    assert mgr.latest_epoch() == 7 and mgr.epochs() == [4, 7]


def test_checkpoint_skip_optimizer(tmp_path):
    state = small_state()
    _step()(state, _batch())
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_freq=1)
    mgr.save(epoch=0, state=state)
    fresh = small_state(weights_seed=1)
    before = [mu.clone() for mu in fresh.optimizer.state_dict()["mu"]]
    restored, _ = mgr.restore(fresh, restore_optimizer=False)
    # the optimizer untouched (the reference's --eval / --reduce_lr path);
    # parameters, statistics and step restored
    assert restored.optimizer.count == 0
    assert all(torch.equal(a, b) for a, b in zip(before, restored.optimizer.state_dict()["mu"]))
    assert restored.step == 1
    sa, sb = state.model.state_dict(), restored.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_checkpoint_keeps_the_newest(tmp_path):
    state = small_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_freq=1, max_to_keep=2)
    for epoch in range(5):
        state.step = epoch
        assert mgr.save(epoch, state)
    assert mgr.epochs() == [3, 4]
    assert not any(p.name.endswith(".tmp") for p in (tmp_path / "ckpt").iterdir())
    restored, start = mgr.restore(small_state(), epoch=3)
    assert start == 4 and restored.step == 3


def test_restored_run_continues_bit_for_bit(tmp_path):
    """Dropout on (p = 0.1): 2 steps, save, restore into a model of other
    weights, 1 step; against 3 uninterrupted steps."""
    batches = [_batch(range(2)), _batch(range(2, 4)), _batch(range(4, 6))]
    step = _step()
    whole = small_state()
    assert any(m.p > 0 for m in whole.model.modules() if isinstance(m, Dropout))
    for b in batches:
        want = step(whole, b)

    first = small_state()
    for b in batches[:2]:
        step(first, b)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_freq=1)
    mgr.save(0, first)
    resumed, _ = mgr.restore(small_state(weights_seed=7))
    torch.manual_seed(12345)  # the global generator plays no part
    got = step(resumed, batches[2])
    assert resumed.step == whole.step == 3
    assert _equal_states(resumed, whole)
    assert all(torch.equal(got[k], want[k]) for k in want)


def _train_forward(model, generator):
    with dropout_generator(model, generator):
        return model(_batch()["inputs"])["last_center"]


def test_dropout_masks_depend_on_seed_and_step_only():
    model = EDAGrounder(CFG)
    model.init_weights(0)
    model.train()
    with pytest.raises(RuntimeError, match="generator"):
        model(_batch()["inputs"])
    a = _train_forward(model, step_generator(SEED, 5, "cpu"))
    torch.manual_seed(999)
    torch.rand(100)
    b = _train_forward(model, step_generator(SEED, 5, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, _train_forward(model, step_generator(SEED, 6, "cpu")))
    assert not torch.equal(a, _train_forward(model, step_generator(SEED + 1, 5, "cpu")))
    model.eval()  # eval mode: no mask, no generator needed
    with torch.no_grad():
        model(_batch()["inputs"])
    assert all(m.generator is None for m in model.modules() if isinstance(m, Dropout))
