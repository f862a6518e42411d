"""Model configuration of the PyTorch port.

The port keeps its own copy of the JAX package's ``ModelConfig``: same
fields, same defaults, same ``tiny()`` miniature, so a configuration written
for one package describes the same network in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (reference ``models/bdetr.py:46-157``)."""

    num_class: int = 256          # soft-token positions (= max text tokens)
    num_obj_class: int = 485      # ScanNet object vocabulary
    input_feature_dim: int = 3    # per-point features besides xyz (RGB)
    num_queries: int = 256
    num_decoder_layers: int = 6
    num_encoder_layers: int = 3
    d_model: int = 288
    n_heads: int = 8
    dim_feedforward: int = 256
    dropout: float = 0.1
    self_position_embedding: str = "loc_learned"  # none | xyz_learned | loc_learned
    self_attend: bool = True
    contrastive_align: bool = True
    contrastive_dim: int = 64
    butd: bool = False            # detected-box stream (two-stage mode)
    butd_box_dim: int = 128
    butd_class_embed_dim: int = 768
    max_detected_boxes: int = 132
    # PointNet++ backbone
    sa_npoints: Sequence[int] = (2048, 1024, 512, 256)
    sa_radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2)
    sa_nsamples: Sequence[int] = (64, 32, 16, 16)
    sa_mlps: Sequence[Sequence[int]] = ((64, 64, 128), (128, 128, 256), (128, 128, 256), (128, 128, 256))
    fp_mlps: Sequence[Sequence[int]] = ((256, 256), (256, 288))
    sa_impl: str = "fused"
    sa_ball_mode: str = "nearest"
    sa_windows: Sequence[int] = (1024, 256, 256, 256)
    points_presorted: bool = True
    num_points: int = 50000
    # Text encoder (RoBERTa-base geometry by default)
    text_vocab_size: int = 50265
    text_hidden: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate: int = 3072
    text_max_len: int = 256
    # Precision: activations dtype for matmul-heavy paths.
    use_bf16: bool = False
    fused_qkv: bool = False

    def tiny(self) -> "ModelConfig":
        """A miniature config for tests: same topology, toy widths."""
        return dataclasses.replace(
            self,
            num_points=1024,
            sa_windows=(256, 128, 64, 64),
            sa_npoints=(256, 128, 64, 32),
            sa_mlps=((16, 16, 32), (32, 32, 64), (32, 32, 64), (32, 32, 64)),
            fp_mlps=((64, 64), (64, 96)),
            d_model=96,
            dim_feedforward=64,
            n_heads=4,
            num_queries=32,
            num_decoder_layers=2,
            num_encoder_layers=1,
            text_hidden=64,
            text_layers=2,
            text_heads=4,
            text_intermediate=128,
            text_vocab_size=512,
            contrastive_dim=16,
            butd_box_dim=32,
            max_detected_boxes=16,
        )
