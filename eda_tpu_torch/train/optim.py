"""AdamW over three parameter groups, per-iteration schedules, global-norm clip.

Counterpart of ``eda_tpu/train/optim.py``: the main parameters at ``lr``,
``backbone_net`` at ``lr_backbone``, the text encoder frozen; weight decay on
every parameter of a trained group (``optax.adamw``); the gradients of all
parameters clipped to global norm ``clip_norm`` before the update
(``optax.chain(clip_by_global_norm, ...)``). The update repeats optax's
arithmetic in f32, as a few multi-tensor (``torch._foreach_*``) calls per
group::

    mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   t = t + 1
    u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
    p  = p + (-lr(t - 1)) u

Schedules match the reference's torch schedulers: milestones and the cosine
horizon are offset by the RAW ``warmup_epoch``, its disabled -1 included
(``eda_tpu/train/optim.py:50-100``).

``AdamW.constant`` is the accuracy probe's optimizer
(``eda_tpu/tools/window_sweep.py``, ``--schedule constant``):
``optax.chain(clip_by_global_norm(1.0), adamw(lr))``, one group of every
parameter, the text encoder included (its gradient is zero, so only the
weight decay of 1e-4 moves it), at a constant rate, with the same arithmetic.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from eda_tpu_torch.config import TrainConfig

COSINE_ETA_MIN = 1e-6


def group_of(name: str) -> str:
    """Optimizer group of a parameter by its top-level module."""
    top = name.split(".", 1)[0]
    return {"backbone_net": "backbone", "text_encoder": "text"}.get(top, "main")


def make_lr_schedules(cfg: TrainConfig, steps_per_epoch: int) -> Dict[str, Callable[[int], float]]:
    """Per-group ``count -> lr``; ``count`` is the number of updates made so far."""
    we = cfg.warmup_epoch

    def schedule(base_lr: float) -> Callable[[int], float]:
        if cfg.lr_scheduler == "cosine":
            horizon = max(1, (cfg.max_epoch - we) * steps_per_epoch)

            def main(t):
                cosf = 0.5 * (1.0 + math.cos(math.pi * min(t, horizon) / horizon))
                return COSINE_ETA_MIN + (base_lr - COSINE_ETA_MIN) * cosf
        else:
            milestones = [(m - we) * steps_per_epoch for m in cfg.lr_decay_epochs]

            def main(t):
                return base_lr * cfg.lr_decay_rate ** sum(t >= m for m in milestones)

        if we <= 0:
            return main
        warm_steps = we * steps_per_epoch
        mult = cfg.warmup_multiplier

        def sched(t):
            if t > warm_steps:
                return main(t - warm_steps)
            return base_lr / mult * ((mult - 1.0) * min(t, warm_steps) / warm_steps + 1.0)

        return sched

    return {"main": schedule(cfg.lr), "backbone": schedule(cfg.lr_backbone),
            "text": schedule(cfg.text_lr)}


class AdamW:
    """Clip -> AdamW per group over a model's parameters (text encoder frozen).

    With ``one_group`` every parameter, the text encoder included, is in one
    group at the constant rate ``cfg.lr`` (``AdamW.constant``).
    """

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, one_group: bool = False):
        self.cfg = cfg
        self.b1, self.b2, self.eps = b1, b2, eps
        if one_group:
            self.schedules = {"all": lambda t: cfg.lr}
        else:
            self.schedules = make_lr_schedules(cfg, steps_per_epoch)
        self.groups: Dict[str, List[torch.nn.Parameter]] = {name: [] for name in self.schedules}
        for name, p in model.named_parameters():
            self.groups["all" if one_group else group_of(name)].append(p)
        self.params = [p for ps in self.groups.values() for p in ps]
        self.trained = [g for g in self.groups if g != "text"]
        self.moments = {p: (torch.zeros_like(p), torch.zeros_like(p))
                        for g in self.trained for p in self.groups[g]}
        self.count = 0

    @classmethod
    def constant(cls, model: torch.nn.Module, lr: float, clip_norm: float = 1.0,
                 weight_decay: float = 1e-4) -> "AdamW":
        """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr, weight_decay=...))``
        over every parameter of ``model`` as one group at the constant rate ``lr``."""
        cfg = TrainConfig(lr=lr, weight_decay=weight_decay, clip_norm=clip_norm)
        return cls(model, cfg, 1, one_group=True)

    def state_dict(self) -> dict:
        """The update count and both moments of every trained parameter, in order."""
        trained = [p for g in self.trained for p in self.groups[g]]
        return {"count": self.count, "mu": [self.moments[p][0] for p in trained],
                "nu": [self.moments[p][1] for p in trained]}

    def load_state_dict(self, state: dict) -> None:
        trained = [p for g in self.trained for p in self.groups[g]]
        if len(state["mu"]) != len(trained) or len(state["nu"]) != len(trained):
            raise ValueError(f"optimizer state holds {len(state['mu'])} moments, "
                             f"this optimizer trains {len(trained)} parameters")
        with torch.no_grad():
            for p, mu, nu in zip(trained, state["mu"], state["nu"]):
                self.moments[p][0].copy_(mu)
                self.moments[p][1].copy_(nu)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (None counts as zero).

        Returns the global gradient norm before clipping, as a 0-d tensor on
        the parameters' device (no host sync).
        """
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = (norm < self.cfg.clip_norm).float()
        divisor = torch.where(keep > 0, torch.ones_like(norm), norm)  # finite when not clipping
        t = self.count + 1
        # optax's f32 bias corrections: 1 - decay ** t in f32
        bc1 = float(1 - torch.tensor(self.b1) ** t)
        bc2 = float(1 - torch.tensor(self.b2) ** t)
        for group in self.trained:
            params = self.groups[group]
            if not params:
                continue
            g = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            # where(keep, g, g / norm * clip), exactly, as a sum of masked terms
            clipped = torch._foreach_div(g, divisor)
            torch._foreach_mul_(clipped, self.cfg.clip_norm)
            torch._foreach_mul_(clipped, 1 - keep)
            torch._foreach_add_(clipped, torch._foreach_mul(g, keep))
            g = clipped
            mu = [self.moments[p][0] for p in params]
            nu = [self.moments[p][1] for p in params]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1 - self.b2)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, g2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            torch._foreach_add_(u, torch._foreach_mul(params, self.cfg.weight_decay))
            torch._foreach_mul_(u, -self.schedules[group](self.count))
            torch._foreach_add_(params, u)
        self.count = t
        return norm
