"""One training step of the grounding model (counterpart of ``eda_tpu/train/step.py``).

A step is the reference's whole inner loop: forward in train mode (dropout,
BatchNorm batch statistics and running-statistic update), the loss with every
Hungarian match, the backward, the global-norm clip and the AdamW update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from eda_tpu_torch.losses.criterion import SetCriterionConfig, compute_hungarian_loss
from eda_tpu_torch.train.optim import AdamW


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and the step count."""

    model: torch.nn.Module
    optimizer: AdamW
    step: int = 0


def make_train_step(criterion_cfg: SetCriterionConfig) -> Callable:
    """``step(state, batch) -> metrics`` with ``batch = {"inputs": ..., "targets": ...}``.

    The metrics are those of ``compute_hungarian_loss`` plus ``grad_norm``, the
    global gradient norm before clipping, all 0-d tensors on the model's device.
    """

    def step(state: TrainState, batch: Dict[str, dict]) -> Dict[str, torch.Tensor]:
        state.model.train()
        end_points = state.model(batch["inputs"])
        loss, metrics = compute_hungarian_loss(criterion_cfg, end_points, batch["targets"])
        state.optimizer.zero_grad()
        loss.backward()
        metrics["grad_norm"] = state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
