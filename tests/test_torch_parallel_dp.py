"""A 2-rank data-parallel step of the port against its one-process step on the global batch.

Two spawned gloo processes each hold half of a 4-scene batch of the tiny f32
model, with dropout on: every rank draws the global batch's masks and keeps
its rows, so the two ranks drop what one process drops; BatchNorm takes the
global statistics; each rank's loss is its share and the gradients are
summed. Held to ``torch_parity.assert_parallel_step_matches`` (the same
arithmetic up to the order of the sums), with every rank holding the same
state, metrics and moments, and two steps from one state (the state and a
deep copy) bit for bit on each rank. A 1-rank mesh (one gloo process) must give the one-process step
bit for bit.
"""

import numpy as np
from torch_parity import (
    assert_parallel_step_matches,
    one_torch_thread,  # noqa: F401
    parallel_rank_step,
)

from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.parallel.launch import spawn


def spec(**extra):
    gen = SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                          vocab_size=512)
    return dict(overrides=dict(use_bf16=False), batch=gen.train_batch(range(4)),
                crit=dict(num_replicas=2), **extra)


def test_dp_step_matches_one_process_with_dropout(one_torch_thread):  # noqa: F811
    one = parallel_rank_step(None, spec())
    ranks = spawn(parallel_rank_step, 2, spec(repeat=True), timeout=120)
    assert all(r["repeats_agree"] for r in ranks)
    assert_parallel_step_matches(one, ranks)


def test_one_rank_mesh_is_the_one_process_step(one_torch_thread):  # noqa: F811
    one = parallel_rank_step(None, spec(steps=2))
    (mesh_run,) = spawn(parallel_rank_step, 1, spec(steps=2), timeout=120)
    assert mesh_run["metrics"] == one["metrics"]
    for key in one["state"]:
        assert np.array_equal(mesh_run["state"][key], one["state"][key]), key
    for key in one["moments"]:
        assert np.array_equal(mesh_run["moments"][key], one["moments"][key]), key
