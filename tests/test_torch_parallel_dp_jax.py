"""A 2-rank data-parallel step of the port against JAX's ``data=2`` mesh step.

JAX runs ``train.py``'s step: one global-view jit over a mesh of two CPU
devices, the batch sharded over ``data``, ``num_replicas=2``
(``torch_parity.jax_train_step(..., data=2)``; the f32 gather tiny model,
whose only Pallas kernel, FPS, runs interpreted). The port runs two spawned
gloo processes, each with its half of the batch, global BatchNorm
statistics, its share of the loss, and the gradients summed over the group
(``torch_parity.parallel_rank_step``). Dropout is off on both sides; the
port takes its own KPS and matches, as ``test_torch_f32_train_step.py``
does, and is held to that file's f32 gates: the loss within 1%, every other
metric (``grad_norm`` included) within 5%, the gradients as AdamW's first
moments (global cosine >= 0.98 and the per-leaf gates), the new parameters
and BatchNorm statistics (measured: loss 1e-5, ``grad_norm`` 9e-4 relative).
"""

import numpy as np
import torch
from test_torch_f32_train_step import F32_GLOBAL_COS, OVERRIDES
from torch_parity import (
    LOSS_REL,
    METRIC_REL,
    assert_first_moments_match,
    assert_new_parameters_match,
    assert_step_metrics_match,
    cos,
    jax_train_step,
    one_torch_thread,  # noqa: F401
    parallel_rank_step,
    port_moments,
    port_run_of,
)

from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu_torch.parallel.launch import spawn


def test_dp_step_matches_jax_mesh_step(one_torch_thread):  # noqa: F811
    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                             vocab_size=512)
    overrides = OVERRIDES["gather"]
    jax_run = jax_train_step(gen.batch(range(4)), overrides=overrides, data=2)
    spec = dict(overrides=overrides, variables=jax_run["variables"], batch=jax_run["batch"],
                crit=dict(num_replicas=2), dropout=False)
    ranks = spawn(parallel_rank_step, 2, spec, timeout=120)
    for key in ranks[0]["state"]:  # one global step: every rank holds the same state
        assert np.array_equal(ranks[0]["state"][key], ranks[1]["state"][key]), key
    assert ranks[0]["metrics"] == ranks[1]["metrics"]

    port_run = port_run_of(ranks[0], overrides)
    assert_step_metrics_match(jax_run["metrics"], port_run["metrics"])
    got, want = port_moments(port_run), jax_run["moments"]
    keys = sorted(want)
    glob = cos(torch.cat([got[k].flatten() for k in keys]),
               torch.cat([want[k].flatten() for k in keys]))
    assert glob >= F32_GLOBAL_COS, glob
    assert_first_moments_match(jax_run, port_run)
    assert_new_parameters_match(jax_run, port_run)
    w, g = jax_run["metrics"], port_run["metrics"]
    print(f"loss rel {abs(g['loss'] - w['loss']) / abs(w['loss']):.2e}, grad_norm "
          f"{g['grad_norm']:.4f} vs {w['grad_norm']:.4f}, global cos {glob:.5f}")
    assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"])
    assert all(abs(g[k] - w[k]) <= METRIC_REL * abs(w[k]) + 1e-6 for k in w)
