"""Model, training and data configuration of the PyTorch port.

The port keeps its own copies of the JAX package's ``ModelConfig``,
``TrainConfig`` and ``DataConfig``: same fields, same defaults, same
``tiny()`` miniature, so a configuration written for one package describes
the same network and run in the other.
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule and run cadence: the JAX package's ``TrainConfig``
    (reference ``main_utils.py:276-330``), field for field."""

    batch_size: int = 12              # per device
    lr: float = 2e-4
    lr_backbone: float = 2e-3
    text_lr: float = 2e-5
    weight_decay: float = 5e-4
    max_epoch: int = 100
    warmup_epoch: int = -1
    warmup_multiplier: float = 100.0
    lr_decay_epochs: Sequence[int] = (50, 75)
    lr_decay_rate: float = 0.1
    clip_norm: float = 0.1
    lr_scheduler: str = "multistep"   # multistep | cosine
    save_freq: int = 5
    val_freq: int = 5
    seed: int = 0                     # weights and the dropout stream
    checkpoint_dir: str = "logs"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline (reference ``src/joint_det_dataset.py``): the JAX
    package's ``DataConfig``, field for field."""

    datasets: Sequence[str] = ("scanrefer",)
    test_dataset: str = "scanrefer"
    data_root: str = "data/"
    use_color: bool = True
    use_height: bool = False
    use_multiview: bool = False
    augment: bool = True
    augment_det: bool = False
    detect_intermediate: bool = True
    joint_det: bool = False
    butd: bool = False
    butd_gt: bool = False
    butd_cls: bool = False
    max_num_objects: int = 132        # MAX_NUM_OBJ, joint_det_dataset.py:45
    num_workers: int = 4
    debug: bool = False               # cap at 128 annos, overfit mode
