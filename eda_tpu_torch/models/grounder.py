"""EDAGrounder: the 3D visual-grounding model.

Counterpart of ``eda_tpu/models/grounder.py`` with ``butd=False``: PointNet++
backbone and RoBERTa text encoder feed the cross-modal encoder; the top
``num_queries`` seeds by objectness (KPS) become queries; a proposal head and
the decoder layers each predict center, size and soft-token scores. The
returned ``end_points`` keep the JAX package's keys and prefixes
(``proposal_``, ``{i}head_``, ``last_``).

``train()`` selects the training forward (dropout, BatchNorm batch statistics,
the fused SA's kernels with a backward); the frozen text encoder and the
decoder's box inputs carry no gradient, as the JAX model's ``stop_gradient``s.
Serving callers wrap the forward in ``torch.inference_mode()``.
"""

from __future__ import annotations

import torch
from torch import nn

from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.models.layers import (
    BiDecoderLayer,
    BiEncoderLayer,
    ClsAgnosticPredictHead,
    ContrastiveProjection,
    Dense,
    Dropout,
    PointsObjClsModule,
    PositionEmbeddingLearned,
    lecun_normal_,
)
from eda_tpu_torch.models.pointnet2 import FusedSetAbstraction, PointNetPPBackbone
from eda_tpu_torch.models.roberta import RobertaEncoder


class EDAGrounder(nn.Module):
    """Inputs: point_clouds (B, N, 3 + C) f32, text_ids (B, L) int, text_mask (B, L) bool."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.butd:
            raise NotImplementedError("the detected-box stream (butd) is not ported yet")
        if cfg.sa_impl != "fused" or not cfg.points_presorted:
            raise NotImplementedError("the port runs the fused SA over presorted clouds only")
        if not cfg.use_bf16:
            raise NotImplementedError("the port's fused SA kernels compute in bf16 only")
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.use_bf16 else torch.float32
        d = cfg.d_model
        self.backbone_net = PointNetPPBackbone(
            input_feature_dim=cfg.input_feature_dim,
            npoints=tuple(cfg.sa_npoints),
            radii=tuple(cfg.sa_radii),
            mlps=tuple(tuple(m) for m in cfg.sa_mlps),
            fp_mlps=tuple(tuple(m) for m in cfg.fp_mlps),
            sa_windows=tuple(cfg.sa_windows),
            dtype=dt,
        )
        self.text_encoder = RobertaEncoder(
            cfg.text_vocab_size, cfg.text_hidden, cfg.text_layers, cfg.text_heads,
            cfg.text_intermediate,
        )
        self.text_projector_dense = Dense(cfg.text_hidden, d)
        self.text_projector_norm = nn.LayerNorm(d, eps=1e-12)
        self.text_dropout = Dropout(cfg.dropout)
        self.pos_embed = PositionEmbeddingLearned(3, d, dt)
        self.cross_encoder = nn.ModuleList([
            BiEncoderLayer(d, cfg.n_heads, cfg.dim_feedforward, cfg.self_attend, dt,
                           cfg.dropout)
            for _ in range(cfg.num_encoder_layers)
        ])
        if cfg.contrastive_align:
            self.contrastive_proj_text = ContrastiveProjection(d, cfg.contrastive_dim, dt)
            self.contrastive_proj_image = ContrastiveProjection(d, cfg.contrastive_dim, dt)
        self.points_obj_cls = PointsObjClsModule(d, dt)
        self.decoder_query_proj = Dense(d, d)
        self.proposal_head = ClsAgnosticPredictHead(cfg.num_class, d, dt)
        self.decoder = nn.ModuleList([
            BiDecoderLayer(d, cfg.n_heads, cfg.dim_feedforward,
                           cfg.self_position_embedding, dt, cfg.dropout)
            for _ in range(cfg.num_decoder_layers)
        ])
        self.prediction_head = nn.ModuleList([
            ClsAgnosticPredictHead(cfg.num_class, d, dt)
            for _ in range(cfg.num_decoder_layers)
        ])

    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed`` with the JAX package's initializers:
        lecun-normal kernels, normal(1/sqrt(dim)) embeddings, zero biases,
        unit norm scales and identity BatchNorm statistics."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, Dense):
                    lecun_normal_(module.weight, module.weight.shape[1], g)
                elif isinstance(module, FusedSetAbstraction):
                    for k in module.kernels:
                        lecun_normal_(k, k.shape[0], g)
                elif isinstance(module, nn.Embedding):
                    module.weight.normal_(0.0, module.weight.shape[1] ** -0.5, generator=g)

    def forward(self, inputs: dict) -> dict:
        cfg = self.cfg
        end_points = self.backbone_net(inputs["point_clouds"])
        end_points["seed_inds"] = end_points["fp2_inds"]
        end_points["seed_xyz"] = end_points["fp2_xyz"]
        points_xyz = end_points["fp2_xyz"]
        points_features = end_points["fp2_features"]

        text_valid = inputs["text_mask"].bool()
        with torch.no_grad():  # the frozen text encoder: no dropout, no gradient
            encoded_text = self.text_encoder(inputs["text_ids"], text_valid)
        text_feats = self.text_projector_norm(self.text_projector_dense(encoded_text))
        text_feats = self.text_dropout(text_feats)
        end_points["text_feats_prepro"] = text_feats

        pos_feats = self.pos_embed(points_xyz)
        for layer in self.cross_encoder:
            points_features, text_feats = layer(
                points_features, pos_feats, None, text_feats, text_valid
            )
        end_points["text_memory"] = text_feats
        end_points["seed_features"] = points_features
        if cfg.contrastive_align:
            end_points["proj_tokens"] = self.contrastive_proj_text(text_feats)

        logits = self.points_obj_cls(points_features)
        end_points["seeds_obj_cls_logits"] = logits
        sample_inds = top_k_indices(logits, cfg.num_queries)
        idx = sample_inds[..., None]
        cluster_xyz = points_xyz.gather(1, idx.expand(-1, -1, 3))
        cluster_feature = points_features.gather(1, idx.expand(-1, -1, points_features.shape[-1]))
        end_points["query_points_xyz"] = cluster_xyz
        end_points["query_points_feature"] = cluster_feature
        end_points["query_points_sample_inds"] = sample_inds

        query = self.decoder_query_proj(cluster_feature)
        if cfg.contrastive_align:
            end_points["proposal_proj_queries"] = self.contrastive_proj_image(query)
        center, size, sem_cls = self.proposal_head(cluster_feature, cluster_xyz)
        end_points["proposal_base_xyz"] = cluster_xyz
        end_points["proposal_center"] = center
        end_points["proposal_pred_size"] = size
        end_points["proposal_sem_cls_scores"] = sem_cls
        base_xyz, base_size = center.detach(), size.detach()

        for i, (layer, head) in enumerate(zip(self.decoder, self.prediction_head)):
            prefix = "last_" if i == cfg.num_decoder_layers - 1 else f"{i}head_"
            if cfg.self_position_embedding == "loc_learned":
                query_loc = torch.cat([base_xyz, base_size], -1)
            else:
                query_loc = base_xyz
            query = layer(query, points_features, text_feats, query_loc, text_valid)
            if cfg.contrastive_align:
                end_points[f"{prefix}proj_queries"] = self.contrastive_proj_image(query)
            center, size, sem_cls = head(query, cluster_xyz)
            end_points[f"{prefix}base_xyz"] = cluster_xyz
            end_points[f"{prefix}center"] = center
            end_points[f"{prefix}pred_size"] = size
            end_points[f"{prefix}sem_cls_scores"] = sem_cls
            base_xyz, base_size = center.detach(), size.detach()
        return end_points


def top_k_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest values per row, descending, as ``lax.top_k``.

    ``lax.top_k`` orders floats totally (+0 above -0) and puts equal values
    lowest index first; ``torch.topk`` promises no order among ties. So the
    values sort by their total-order integer key, stably.
    """
    bits = logits.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # monotone in the float order
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


def decoder_prefixes(num_decoder_layers: int) -> list:
    """['proposal_', 'last_', '0head_', ...]."""
    return ["proposal_", "last_"] + [f"{i}head_" for i in range(num_decoder_layers - 1)]
