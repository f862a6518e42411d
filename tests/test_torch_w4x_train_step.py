"""One tiny f32 training step of the width-4 backbone ("W4X"), port vs JAX, on the port's own decisions.

``chip_smoke.w4x_configs(ModelConfig())[1]``: the tiny f32 config with
Group-Free-3D's ``width=4`` SA widths (SA1 (256, 256, 512), SA2-4 (512, 512,
1024), the widths whose training kernels are ``csrc/sa_pair_pool_512.cu``'s
winners variant, ``csrc/sa_pair_pool_bwd_512.cu`` and ``csrc/sa_prep_bwd_512.cu``
on the card) and FP2 out the tiny d_model. The widths are not cut.

The JAX side runs ``make_train_step`` on its TPU training path with every
Pallas kernel interpreted (``torch_parity.jax_train_step``), dropout off; the
port runs the same step on the CPU (every kernel wrapper on its plain
version) with the JAX run's weights, loaded by ``weights.load_flax``, and
batch, and its own KPS and matches. The gates are the f32 step's
(``tests/test_torch_f32_train_step.py``, ``torch_parity.assert_f32_step_matches``):
the loss within 1%, every other metric within 5%, the gradients' global
cosine >= 0.98 and every leaf under the per-leaf gates (none excused), new
parameters and BatchNorm statistics.
"""

import numpy as np
import pytest
from torch_parity import assert_f32_step_matches, f32_own_step, one_torch_thread  # noqa: F401

import chip_smoke
from eda_tpu_torch.config import ModelConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_w4x_f32_step_matches_jax_on_its_own_decisions():
    _, tiny = chip_smoke.w4x_configs(ModelConfig())
    assert not tiny.use_bf16 and tiny.sa_mlps == chip_smoke.W4X_SA_MLPS
    jax_run, port_run = f32_own_step(dict(use_bf16=False, sa_mlps=tiny.sa_mlps,
                                          fp_mlps=tiny.fp_mlps))
    cfg = port_run["state"].model.cfg
    assert not cfg.use_bf16 and cfg.sa_mlps == tiny.sa_mlps and cfg.fp_mlps == tiny.fp_mlps
    assert np.isfinite(list(port_run["metrics"].values())).all()
    assert_f32_step_matches(jax_run, port_run)
