"""Port schedules and the three-group AdamW with its clip vs the JAX package's optax chain.

Schedules: the per-iteration multistep and cosine schedules, with the raw
``warmup_epoch = -1`` offset and with a real warmup, rtol 1e-6. AdamW: three
steps over a small parameter tree with ``backbone_net``, ``text_encoder`` and
main parameters, random gradients whose global norm is above the clip in some
steps and below it in others; parameters after every step and the returned
gradient norm within rtol 1e-5 (f32 arithmetic in the same order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from eda_tpu.config import TrainConfig as JaxTrainConfig
from eda_tpu.train import optim as jax_optim
from eda_tpu_torch.config import TrainConfig
from eda_tpu_torch.train import optim as port_optim

SPE = 7


@pytest.mark.parametrize("kw", [
    dict(),
    dict(lr_scheduler="cosine", max_epoch=3),
    dict(warmup_epoch=2, lr_decay_epochs=(3, 5)),
    dict(lr_scheduler="cosine", warmup_epoch=1, max_epoch=4),
], ids=["multistep", "cosine", "multistep-warmup", "cosine-warmup"])
def test_schedules_match_jax(kw):
    want = jax_optim.make_lr_schedules(JaxTrainConfig(**kw), SPE)
    got = port_optim.make_lr_schedules(TrainConfig(**kw), SPE)
    for group in ("main", "backbone", "text"):
        for t in [0, 1, 5, 6, 7, 8, 13, 14, 20, 21, 34, 35, 50, 70, 400, 700, 1000]:
            w = float(want[group](jnp.int32(t)))
            assert got[group](t) == pytest.approx(w, rel=1e-6, abs=1e-12), (group, t)


class _Tree(nn.Module):
    def __init__(self, shapes):
        super().__init__()
        for top, leaves in shapes.items():
            setattr(self, top, nn.ParameterDict(
                {k: nn.Parameter(torch.zeros(s)) for k, s in leaves.items()}))


def test_adamw_three_groups_and_clip_match_optax():
    rng = np.random.default_rng(0)
    shapes = {"backbone_net": {"w": (4, 3), "b": (3,)}, "text_encoder": {"w": (5,)},
              "head": {"w": (3, 2), "b": (2,)}}
    params = {top: {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
              for top, leaves in shapes.items()}
    cfg = dict(lr=1e-2, lr_backbone=3e-2, lr_decay_epochs=(0.3,), clip_norm=1.0)
    tx = jax_optim.make_optimizer(JaxTrainConfig(**cfg), params, steps_per_epoch=SPE)
    jparams = {top: {k: jnp.asarray(v) for k, v in leaves.items()}
               for top, leaves in params.items()}
    opt_state = tx.init(jparams)

    model = _Tree(shapes)
    with torch.no_grad():
        for top, leaves in params.items():
            for k, v in leaves.items():
                getattr(model, top)[k].copy_(torch.from_numpy(v))
    port = port_optim.AdamW(model, TrainConfig(**cfg), steps_per_epoch=SPE)
    assert {g: len(ps) for g, ps in port.groups.items()} == {"main": 2, "backbone": 2, "text": 1}

    for scale in (3.0, 0.05, 2.0):  # clipped, not clipped, clipped
        grads = {top: {k: (scale * rng.normal(size=s)).astype(np.float32)
                       for k, s in leaves.items()} for top, leaves in shapes.items()}
        jgrads = {top: {k: jnp.asarray(v) for k, v in leaves.items()}
                  for top, leaves in grads.items()}
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_norm = float(optax.global_norm(jgrads))
        for top, leaves in grads.items():
            for k, v in leaves.items():
                getattr(model, top)[k].grad = torch.from_numpy(v)
        norm = port.step()
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        for top, leaves in jparams.items():
            for k, v in leaves.items():
                np.testing.assert_allclose(getattr(model, top)[k].detach().numpy(),
                                           np.asarray(v), rtol=1e-5, atol=1e-7,
                                           err_msg=f"{top}.{k}")
    # the frozen text encoder kept its values
    np.testing.assert_array_equal(model.text_encoder["w"].detach().numpy(),
                                  params["text_encoder"]["w"])
