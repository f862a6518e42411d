"""One tiny f32 training step with ``points_presorted=False``, port vs ``eda_tpu``, on the port's own decisions.

As ``tests/test_torch_f32_train_step.py`` (the same gates: the port's own KPS
seed set and matches must be JAX's, the loss within 1%, metrics within 5%, a
global gradient cosine of at least 0.98, the per-leaf and parameter gates),
with every fused SA layer sorting on the device, on clouds permuted per scene
(``test_torch_device_sort_model.permuted``: SA1's sort is then no identity).
"""

import pytest
from test_torch_device_sort_model import UNSORTED, permuted, tiny_batch
from test_torch_f32_train_step import assert_f32_step_matches
from torch_parity import jax_train_step, one_torch_thread, port_train_step  # noqa: F401


@pytest.mark.usefixtures("one_torch_thread")
def test_unsorted_f32_step_matches_jax_on_its_own_decisions():
    jax_run = jax_train_step(permuted(tiny_batch(), seed=1),
                             overrides=dict(UNSORTED, use_bf16=False))
    port_run = port_train_step(jax_run, own_decisions=True)
    cfg = port_run["state"].model.cfg
    assert not cfg.points_presorted and not cfg.use_bf16
    assert_f32_step_matches(jax_run, port_run)
