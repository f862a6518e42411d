"""One tiny bf16 training step with ``points_presorted=False``, port vs ``eda_tpu``.

JAX's step on its TPU training path (``jax_train_step(...,
overrides={"points_presorted": False})``, every Pallas kernel interpreted,
dropout off) on clouds permuted per scene
(``test_torch_device_sort_model.permuted``: SA1's sort is then no identity),
the port on the JAX run's KPS and matches, under the gates of
``tests/test_torch_train_step.py`` (its docstring says why each is what it is).
"""

import pytest
from test_torch_device_sort_model import UNSORTED, permuted, tiny_batch
from torch_parity import (  # noqa: F401
    assert_first_moments_match,
    assert_new_parameters_match,
    assert_step_metrics_match,
    jax_train_step,
    one_torch_thread,
    port_train_step,
)


@pytest.mark.usefixtures("one_torch_thread")
def test_unsorted_training_step_matches_jax():
    jax_run = jax_train_step(permuted(tiny_batch()), overrides=UNSORTED)
    port_run = port_train_step(jax_run)
    assert not port_run["state"].model.cfg.points_presorted
    assert_step_metrics_match(jax_run["metrics"], port_run["metrics"])
    assert_first_moments_match(jax_run, port_run)
    assert_new_parameters_match(jax_run, port_run)
