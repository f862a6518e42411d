"""Checkpoints across meshes: saved data-parallel, restored tensor-parallel, bit for bit.

The counterpart of ``tests/test_checkpoint.py:99`` (save under data = 8,
restore under data = 4 x model = 2). Two gloo ranks (data = 2) take one step
of the tiny f32 model and save; rank 0 writes full tensors. Four ranks
(data = 2 x model = 2) of a model with other weights restore it: each keeps
its part of every split tensor, and the gathered parameters, BatchNorm
statistics, AdamW moments, update count and step equal the saved ones bit
for bit; then a step runs and gives the same finite loss on every rank. The
saved file restores into a one-process model of the port too.

Every rank restores rank 0's entry: a rank whose directory lacks it, or
holds another file under its name (a host that does not share rank 0's
disk), makes the restore raise on every rank.
"""

import math

import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    one_torch_thread,
    parallel_checkpoint_rank,
    parallel_restore_rank,
)

from eda_tpu_torch.config import ModelConfig, TrainConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.parallel.launch import spawn
from eda_tpu_torch.train.checkpoint import CheckpointManager
from eda_tpu_torch.train.optim import AdamW
from eda_tpu_torch.train.step import TrainState


def test_dp_save_tp_restore_bit_equal(tmp_path, one_torch_thread):  # noqa: F811
    gen = SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                          vocab_size=512)
    batch = gen.train_batch(range(4))
    saved = spawn(parallel_checkpoint_rank, 2,
                  dict(seed=0, batch=batch, directory=str(tmp_path), save=True), timeout=120)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["epoch_0.pt"]
    want = saved[0]
    restored = spawn(parallel_checkpoint_rank, 4,
                     dict(seed=5, batch=batch, directory=str(tmp_path), save=False,
                          step_after=True), model=2, timeout=120)
    for got in restored:
        assert (got["count"], got["step"]) == (want["count"], want["step"]) == (1, 1)
        for key in want["state"]:
            assert np.array_equal(got["state"][key], want["state"][key]), key
        for key in want["moments"]:
            for a, b in zip(got["moments"][key], want["moments"][key]):
                assert np.array_equal(a, b), key
        assert got["shapes"]["decoder.0.ffn.dense.0.weight"] == (32, 96)
        assert math.isfinite(got["loss"]) and got["loss"] == restored[0]["loss"]

    model = EDAGrounder(ModelConfig().tiny())
    state = TrainState(model, AdamW(model, TrainConfig(), 10))
    CheckpointManager(str(tmp_path)).restore(state)
    for key, value in model.state_dict().items():
        assert torch.equal(value, torch.from_numpy(want["state"][key])), key


@pytest.mark.parametrize("other", ["absent", "stale"])
def test_restore_refuses_a_rank_without_rank0s_entry(tmp_path, other,
                                                     one_torch_thread):  # noqa: F811
    shared, own = tmp_path / "rank0", tmp_path / "rank1"
    model = EDAGrounder(ModelConfig().tiny())
    model.init_weights(0)
    state = TrainState(model, AdamW(model, TrainConfig(), 10))
    state.step = 3
    CheckpointManager(str(shared)).save(0, state, force=True)
    own.mkdir()
    if other == "stale":  # an older run's entry under the same name
        state.step = 2
        CheckpointManager(str(own)).save(0, state, force=True)
    with pytest.raises(RuntimeError, match="do not read one checkpoint"):
        spawn(parallel_restore_rank, 2, [str(shared), str(own)], timeout=120)
