"""Training and evaluation steps of the grounding model (counterpart of ``eda_tpu/train/step.py``).

A training step is the reference's whole inner loop: forward in train mode
(dropout, BatchNorm batch statistics and running-statistic update), the loss
with every Hungarian match, the backward, the global-norm clip and the AdamW
update. Its dropout masks come from one generator on the model's device keyed
by (seed, step), the counterpart of ``fold_in(key(seed), state.step)``: a run
restored at step n draws the masks of the uninterrupted run. Every sum of
the backward has a fixed order (the kernels' records, ``pointops.gather_shared``
where gathered rows repeat), so two steps from one state agree bit for bit on
the card, as the reference's step does. The evaluation
steps run the forward in eval mode under ``torch.inference_mode()`` (the
serving kernels, no autograd) and restore the model's mode afterwards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from eda_tpu_torch.eval.grounding import score_and_iou_multi
from eda_tpu_torch.losses.criterion import SetCriterionConfig, compute_hungarian_loss
from eda_tpu_torch.models.layers import Dropout
from eda_tpu_torch.train.optim import AdamW


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and the step count."""

    model: torch.nn.Module
    optimizer: AdamW
    step: int = 0


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of a run seeded ``seed``, on ``device``."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(words[0]) << 32 | int(words[1]))


@contextlib.contextmanager
def dropout_generator(model: torch.nn.Module, generator: torch.Generator) -> Iterator[None]:
    """Every ``Dropout`` of ``model`` draws from ``generator`` inside the block."""
    layers = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in layers:
        m.generator = generator
    try:
        yield
    finally:
        for m in layers:
            m.generator = None


def make_train_step(criterion_cfg: SetCriterionConfig, seed: int = 0) -> Callable:
    """``step(state, batch) -> metrics`` with ``batch = {"inputs": ..., "targets": ...}``.

    The metrics are those of ``compute_hungarian_loss`` plus ``grad_norm``, the
    global gradient norm before clipping, all 0-d tensors on the model's device.
    Dropout draws from ``step_generator(seed, state.step)``.
    """

    def step(state: TrainState, batch: Dict[str, dict]) -> Dict[str, torch.Tensor]:
        state.model.train()
        device = batch["inputs"]["point_clouds"].device
        with dropout_generator(state.model, step_generator(seed, state.step, device)):
            end_points = state.model(batch["inputs"])
        loss, metrics = compute_hungarian_loss(criterion_cfg, end_points, batch["targets"])
        state.optimizer.zero_grad()
        loss.backward()
        metrics["grad_norm"] = state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _in_eval_mode(model: torch.nn.Module, fn):
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            return fn()
    finally:
        model.train(was_training)


def make_eval_step(model: torch.nn.Module,
                   criterion_cfg: Optional[SetCriterionConfig] = None) -> Callable:
    """``eval_fn(batch) -> (end_points, metrics)``: the eval forward and, given
    ``criterion_cfg`` and ``batch["targets"]``, the loss metrics."""

    def eval_fn(batch: Dict[str, dict]):
        def run():
            end_points = model(batch["inputs"])
            metrics = {}
            if criterion_cfg is not None and "targets" in batch:
                _, metrics = compute_hungarian_loss(criterion_cfg, end_points, batch["targets"])
            return end_points, metrics

        return _in_eval_mode(model, run)

    return eval_fn


def make_eval_score_step(model: torch.nn.Module, prefixes: Sequence[str] = ("last_", "proposal_"),
                         modes: Sequence[str] = ("bbs", "bbf"),
                         filter_non_gt_boxes: bool = False) -> Callable:
    """``score_fn(batch) -> ious``: the eval forward and the grounding scoring.

    Returns the (P, M, B, topk) IoU stack of ``score_and_iou_multi`` on the
    model's device, the only thing ``GroundingEvaluator`` needs.
    """
    prefixes, modes = tuple(prefixes), tuple(modes)

    def score_fn(batch: Dict[str, dict]) -> torch.Tensor:
        def run():
            end_points = model(batch["inputs"])
            targets = batch["targets"]
            if filter_non_gt_boxes and "det_boxes" in batch["inputs"]:
                targets = {**targets, "__det_boxes": batch["inputs"]["det_boxes"],
                           "__det_mask": batch["inputs"]["det_mask"]}
            return score_and_iou_multi(end_points, targets, prefixes=prefixes, modes=modes)

        return _in_eval_mode(model, run)

    return score_fn
