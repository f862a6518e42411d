"""Entry points of the port: the flagship grounding forward, its training step and its evaluation.

``entry`` is the twin of ``__graft_entry__.entry``: ``ModelConfig(use_bf16=True)``,
a batch of 50 000-point synthetic scenes and a randomly initialised
``EDAGrounder`` on the chosen device, returning ``last_center``.

The serving inputs are ``point_clouds`` (B, N, 3 + C) f32, ``text_ids`` (B, L)
int32 and ``text_mask`` (B, L) bool; a ``butd`` config (the two-stage
grounder) also takes the detected boxes ``det_boxes`` (B, 132, 6) cxcyczwhd
f32, their 485-way classes ``det_class_ids`` (B, 132) int32 and ``det_mask``
(B, 132) bool, which the synthetic batches fill with the scene's boxes.
``build_trainer`` gives the same model with its optimizer, the training step
and a synthetic training batch; ``build_evaluator`` the model in eval mode,
the fused forward + scoring step, a grounding evaluator and a batch with
targets. The device is CUDA unless the caller passes ``device="cpu"``; without
CUDA and without an explicit device they raise, they never move to the CPU by
themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from eda_tpu_torch.config import ModelConfig, TrainConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.eval.grounding import GroundingEvaluator
from eda_tpu_torch.losses.criterion import SetCriterionConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train.optim import AdamW
from eda_tpu_torch.train.step import TrainState, make_eval_score_step, make_train_step

# schedule length of the synthetic training run: longer than any smoke or test
# runs, so the learning rates stay at their base values
STEPS_PER_EPOCH = 1000


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        # full-f32 matmuls (the |a|^2 + |b|^2 - 2ab distances need them) and
        # bf16 products summed in f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def _scenes(cfg: ModelConfig, text_len: int, num_objects: int) -> SyntheticScenes:
    return SyntheticScenes(
        SyntheticConfig(num_points=cfg.num_points, num_objects=num_objects, text_len=text_len),
        vocab_size=cfg.text_vocab_size,
    )


def make_batch(cfg: ModelConfig, indices, device, text_len: int = 64, num_objects: int = 8):
    """Synthetic serving inputs of the scenes ``indices`` as tensors on ``device``."""
    batch = _scenes(cfg, text_len, num_objects).batch(indices, butd=cfg.butd)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def to_device(batch: dict, device) -> dict:
    """A numpy ``{"inputs": {...}, "targets": {...}}`` batch as tensors on ``device``."""
    return {group: {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
            for group, arrays in batch.items()}


def make_train_batch(cfg: ModelConfig, indices, device, text_len: int = 64,
                     num_objects: int = 8):
    """Synthetic ``{"inputs": ..., "targets": ...}`` of the scenes ``indices`` on ``device``."""
    return to_device(_scenes(cfg, text_len, num_objects).train_batch(indices, butd=cfg.butd),
                     device)


def build(cfg: Optional[ModelConfig] = None, *, batch_size: int = 2,
          device: Optional[str] = None, seed: int = 0) -> Tuple[EDAGrounder, dict]:
    """(model, inputs): the flagship grounder with random weights from ``seed``."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(use_bf16=True)
    model = EDAGrounder(cfg)
    model.init_weights(seed)
    model = model.to(dev).eval()
    return model, make_batch(cfg, range(batch_size), dev)


def build_trainer(cfg: Optional[ModelConfig] = None, *, batch_size: int = 2,
                  device: Optional[str] = None, seed: int = 0):
    """(state, step, batch): a ``TrainState`` (model with random weights from
    ``seed`` and its AdamW under the default ``TrainConfig``), the training
    step and a synthetic training batch.

    ``step(state, batch)`` runs one training step and returns its metrics.
    """
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(use_bf16=True)
    model = EDAGrounder(cfg)
    model.init_weights(seed)
    model = model.to(dev).train()
    train_cfg = TrainConfig()
    optimizer = AdamW(model, train_cfg, STEPS_PER_EPOCH)
    step = make_train_step(SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers),
                           seed=train_cfg.seed)
    return TrainState(model, optimizer), step, make_train_batch(cfg, range(batch_size), dev)


def build_evaluator(cfg: Optional[ModelConfig] = None, *, batch_size: int,
                    device: Optional[str] = None, seed: int = 0):
    """(model, score_step, evaluator, batch): the grounder with random weights
    from ``seed`` in eval mode, the forward + scoring step of ``train.py``'s
    evaluation (prefixes ``last_`` and ``proposal_``, modes ``bbs`` and
    ``bbf``), an empty ``GroundingEvaluator`` and a synthetic batch with targets.

    ``evaluator.evaluate(None, None, ious=score_step(batch))`` scores one batch.
    """
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(use_bf16=True)
    model = EDAGrounder(cfg)
    model.init_weights(seed)
    model = model.to(dev).eval()
    evaluator = GroundingEvaluator(prefixes=("last_", "proposal_"))
    score_step = make_eval_score_step(model, prefixes=evaluator.prefixes, modes=evaluator.modes)
    return model, score_step, evaluator, make_train_batch(cfg, range(batch_size), dev)


def entry(device: Optional[str] = None, **overrides) -> torch.Tensor:
    """``last_center`` (B, num_queries, 3) of the flagship forward on ``device``.

    ``overrides`` replace ``ModelConfig`` fields (e.g. a cut depth for tests).
    """
    cfg = dataclasses.replace(ModelConfig(use_bf16=True), **overrides)
    model, inputs = build(cfg, device=device)
    with torch.inference_mode():
        return model(inputs)["last_center"]
