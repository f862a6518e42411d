"""One tiny training step of the f32 gather model (``sa_impl="gather"``), port vs JAX, on the port's own decisions.

The reference-exact PointNet++ (the ball query in ``nearest`` mode, shared
MLPs with train-mode BatchNorm, max over the neighbours) in f32, the twin of
``ACCURACY.md`` §3's gather trainings. The JAX side runs on its TPU training
path (``torch_parity.jax_train_step``; the gather SA calls no Pallas kernel,
the rest of the step is as in the fused model), dropout off; the port runs
its own KPS and auction. Gates and why: ``test_torch_f32_train_step.py``
(measured here: loss 4e-6, ``grad_norm`` 8e-4 relative, global cosine 0.99998).
"""

from test_torch_f32_train_step import OVERRIDES, assert_f32_step_matches, own_step


def test_gather_step_matches_jax_on_its_own_decisions():
    jax_run, port_run = own_step(OVERRIDES["gather"])
    assert port_run["state"].model.cfg.sa_impl == "gather"
    assert_f32_step_matches(jax_run, port_run)
