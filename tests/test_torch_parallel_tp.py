"""Tensor-parallel steps of the port against its one-process step on the global batch.

Spawned gloo processes on a data x model mesh (data = 2 x model = 2 from four
processes, data = 1 x model = 2 from two): every attention layer, FFN and
RoBERTa layer holds its share of the heads and hidden units
(``parallel.shard_params``), enters a split block through ``copy_to_model``
and leaves it through ``reduce_from_model``; AdamW clips by the norm of the
whole gradient. The tiny f32 model with dropout on (the FFN's hidden masks
drawn whole and split), against the one-process step under
``torch_parity.assert_parallel_step_matches``; every rank holds the same
global state, metrics and moments (the replicated leaves, LayerNorms and
biases included, got the same gradient on every model rank); the split
leaves are still parts after the step; two steps from one state agree bit
for bit on every rank.
"""

import pytest
from torch_parity import (
    assert_parallel_step_matches,
    one_torch_thread,  # noqa: F401
    parallel_rank_step,
)

from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.parallel.launch import spawn
from eda_tpu_torch.parallel.mesh import tp_param_spec


@pytest.fixture(scope="module")
def one_process(one_torch_thread):  # noqa: F811
    gen = SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                          vocab_size=512)
    spec = dict(overrides=dict(use_bf16=False), batch=gen.train_batch(range(4)))
    return spec, parallel_rank_step(None, spec)


@pytest.mark.parametrize("world", [4, 2])
def test_tp_step_matches_one_process(world, one_process):
    spec, one = one_process
    ranks = spawn(parallel_rank_step, world, dict(spec, repeat=True), model=2, timeout=120)
    assert all(r["repeats_agree"] for r in ranks)
    split = 0
    for name, shape in ranks[0]["shapes"].items():
        full = one["state"][name].shape
        dim = tp_param_spec(name)
        want = full if dim is None else full[:dim] + (full[dim] // 2,) + full[dim + 1:]
        assert shape == want, name
        split += dim is not None
    assert split > 20
    assert_parallel_step_matches(one, ranks)
