"""Entry point: the flagship grounding forward of the port.

The twin of ``__graft_entry__.entry``: ``ModelConfig(use_bf16=True)``, a batch
of 50 000-point synthetic scenes and a randomly initialised ``EDAGrounder``
on the chosen device, returning ``last_center``. The device is CUDA unless the
caller passes ``device="cpu"``; without CUDA and without an explicit device it
raises, it never moves to the CPU by itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.grounder import EDAGrounder


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


def make_batch(cfg: ModelConfig, indices, device, text_len: int = 64, num_objects: int = 8):
    """Synthetic serving inputs of the scenes ``indices`` as tensors on ``device``."""
    gen = SyntheticScenes(
        SyntheticConfig(num_points=cfg.num_points, num_objects=num_objects, text_len=text_len),
        vocab_size=cfg.text_vocab_size,
    )
    return {k: torch.from_numpy(v).to(device) for k, v in gen.batch(indices).items()}


def build(cfg: Optional[ModelConfig] = None, *, batch_size: int = 2,
          device: Optional[str] = None, seed: int = 0) -> Tuple[EDAGrounder, dict]:
    """(model, inputs): the flagship grounder with random weights from ``seed``."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig(use_bf16=True)
    model = EDAGrounder(cfg)
    model.init_weights(seed)
    model = model.to(dev).eval()
    return model, make_batch(cfg, range(batch_size), dev)


def entry(device: Optional[str] = None, **overrides) -> torch.Tensor:
    """``last_center`` (B, num_queries, 3) of the flagship forward on ``device``.

    ``overrides`` replace ``ModelConfig`` fields (e.g. a cut depth for tests).
    """
    cfg = dataclasses.replace(ModelConfig(use_bf16=True), **overrides)
    model, inputs = build(cfg, device=device)
    return model(inputs)["last_center"]
