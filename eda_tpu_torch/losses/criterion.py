"""EDA's loss stack: KPS, position alignment, boxes, semantic alignment.

Counterpart of ``eda_tpu/losses/criterion.py``: padded, masked and batched.
Every loss consumes the dense ``MatchResult`` and the padded targets
(``center_label`` (B, G, 3), ``size_gts`` (B, G, 3), ``box_label_mask`` (B, G),
the five token maps (B, G, L), ``point_instance_label`` (B, N),
``text_lengths`` (B,)). The matches of all prediction prefixes run as one
batched auction; the metric names are the JAX package's.

Under data parallelism (a ``mesh`` of W data ranks, each holding B / W rows
of the global batch) each rank's loss is its share of the global loss, so
that the shares sum to the loss the JAX package computes over the global
batch: ``num_boxes`` is the group's count, the matched terms are the rank's
sums over it, and the batch means (KPS) divide by the global batch. The
gradients of the shares are then summed over the group, not averaged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from eda_tpu_torch.losses.matcher import MatchResult, hungarian_match
from eda_tpu_torch.models.grounder import decoder_prefixes
from eda_tpu_torch.ops.boxes import box_cxcyczwhd_to_xyzxyz, generalized_box_iou_3d


@dataclasses.dataclass(frozen=True)
class SetCriterionConfig:
    cost_class: float = 1.0
    cost_bbox: float = 0.0
    cost_giou: float = 2.0
    eos_coef: float = 0.1
    temperature: float = 0.07
    query_points_obj_topk: int = 4
    num_decoder_layers: int = 6
    dataset: str = "scanrefer"  # scanrefer | sr3d | nr3d | scannet
    use_contrastive_align: bool = True
    # the data-parallel width whose DDP gradient averaging the loss reproduces
    # (eda_tpu/losses/criterion.py:59-66): num_boxes is multiplied by it, so the
    # Hungarian terms carry the 1 / world_size that DDP's average gives them
    # and the per-replica KPS mean does not; 1 = the single-GPU recipe
    num_replicas: int = 1

    @property
    def pos_weights(self) -> Tuple[float, float, float, float]:
        """(main, attribute, pronoun, relation) mix."""
        if self.dataset == "sr3d":
            return (0.625, 0.125, 0.125, 0.125)
        return (0.6, 0.2, 0.2, 0.1)

    @property
    def loss_weight(self) -> float:
        """ce / sem-align down-weight, 0.5 for ScanRefer."""
        return 0.5 if self.dataset == "scanrefer" else 1.0


def sigmoid_focal_loss(logits, targets, weights, alpha: float = 0.25, gamma: float = 2.0):
    """Per-element focal BCE."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1 - p) + (1 - targets) * p
    bce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return alpha_w * (pt ** gamma) * bce * weights


def kps_loss(end_points: dict, targets: dict, topk: int, batch_total=None) -> torch.Tensor:
    """Seed objectness loss with hard top-k positives, summed over the rows and
    divided by ``batch_total`` (default: the rows given)."""
    seed_inds = end_points["seed_inds"].long()  # (B, K)
    seed_xyz = end_points["seed_xyz"]
    logits = end_points["seeds_obj_cls_logits"]
    gt_center, gt_size = targets["center_label"], targets["size_gts"]
    box_mask = targets["box_label_mask"].float()
    B, K = seed_inds.shape
    G = gt_center.shape[1]
    obj = targets["point_instance_label"].long().gather(1, seed_inds)  # (B, K)
    fg = obj >= 0
    obj = torch.where(fg, obj, G - 1)
    delta = (seed_xyz[:, :, None, :] - gt_center[:, None, :, :]) / (gt_size[:, None] + 1e-6)
    dist = torch.sqrt((delta ** 2).sum(-1) + 1e-6)  # (B, K, G)
    assigned = obj[:, :, None] == torch.arange(G, device=obj.device)
    dist = torch.where(assigned, dist, torch.full_like(dist, 100.0)).transpose(1, 2)
    # the topk closest seeds per GT, ties to the lowest index (lax.top_k)
    topk_inds = torch.sort(-dist, dim=-1, descending=True, stable=True).indices[..., :topk]
    scatter = torch.where(box_mask[:, :, None] > 0, topk_inds, K)  # K: dropped
    objectness = torch.zeros((B, K + 1), device=logits.device)
    objectness.scatter_(1, scatter.reshape(B, -1), 1.0)
    objectness = torch.where(fg, objectness[:, :K], torch.zeros_like(logits))
    weights = torch.full((B, K), 1.0 / max(K, 1), device=logits.device)
    return sigmoid_focal_loss(logits, objectness, weights).sum() / (batch_total or B)


def _gather_per_query(match: MatchResult, per_target: torch.Tensor) -> torch.Tensor:
    """(B, G, C) per-target rows onto their matched queries (B, Q, C); zeros elsewhere."""
    idx = match.query_target.long()[:, :, None].expand(-1, -1, per_target.shape[-1])
    gathered = per_target.gather(1, idx)
    return torch.where(match.query_matched[:, :, None], gathered, torch.zeros_like(gathered))


def pos_align_loss(cfg, pred_logits, match, targets, num_boxes):
    """Dense position-alignment CE over soft token maps."""
    logp = F.log_softmax(pred_logits, -1)
    C = pred_logits.shape[-1]
    wm, wa, wp, wr = cfg.pos_weights
    weighted = (targets["positive_map"][..., :C] * wm
                + targets["modify_positive_map"][..., :C] * wa
                + targets["pron_positive_map"][..., :C] * wp
                + targets["rel_positive_map"][..., :C] * wr)
    tgt = _gather_per_query(match, weighted)
    not_mentioned = F.one_hot(torch.tensor(C - 1), C).float().to(tgt.device)
    target_sim = torch.where(match.query_matched[:, :, None], tgt, not_mentioned)
    entropy = torch.log(target_sim + 1e-6) * target_sim
    loss_ce = (entropy - logp * target_sim).sum(-1)
    eos = torch.where(match.query_matched, 1.0, cfg.eos_coef)
    return (loss_ce * eos).sum() / num_boxes


def box_loss(pred_boxes, match, targets, num_boxes):
    """L1 (center + 0.2 * size) and GIoU on matched pairs."""
    gt_boxes = torch.cat([targets["center_label"], targets["size_gts"]], -1)
    src = pred_boxes.gather(1, match.match_q.long()[:, :, None].expand(-1, -1, 6))
    valid = match.target_valid
    l1 = (src[..., :3] - gt_boxes[..., :3]).abs() + 0.2 * (src[..., 3:] - gt_boxes[..., 3:]).abs()
    loss_bbox = torch.where(valid[..., None], l1, torch.zeros_like(l1)).sum() / num_boxes
    giou = generalized_box_iou_3d(box_cxcyczwhd_to_xyzxyz(src).reshape(-1, 1, 6),
                                  box_cxcyczwhd_to_xyzxyz(gt_boxes).reshape(-1, 1, 6))
    giou = giou.reshape(valid.shape)
    loss_giou = torch.where(valid, 1.0 - giou, torch.zeros_like(giou)).sum() / num_boxes
    return loss_bbox, loss_giou


def sem_align_loss(cfg, proj_queries, proj_tokens, match, targets, num_boxes):
    """Bidirectional InfoNCE over the decoupled spans."""
    logits = torch.einsum("bqd,bld->bql", proj_queries, proj_tokens) / cfg.temperature
    B, Q, L = logits.shape
    eos_ind = targets["text_lengths"].long() - 1
    nm = (F.one_hot(eos_ind, L) * 0.5 + F.one_hot(eos_ind - 1, L) * 0.5).float()[:, None, :]
    main_f = _gather_per_query(match, targets["positive_map"][..., :L])
    positive_map = torch.where(match.query_matched[:, :, None], main_f, nm) > 0
    modi_f = _gather_per_query(match, targets["modify_positive_map"][..., :L])
    pron_f = _gather_per_query(match, targets["pron_positive_map"][..., :L])
    rel_f = _gather_per_query(match, targets["rel_positive_map"][..., :L])
    modi_map, pron_map, rel_map = modi_f > 0, pron_f > 0, rel_f > 0
    other_map = _gather_per_query(match, targets["other_entity_map"][..., :L]) > 0
    mask = torch.where(match.query_matched, 1.0, cfg.eos_coef)
    zero = torch.zeros_like(logits)

    pos_logits = torch.where(positive_map, -logits, zero)
    modi_pos = torch.where(modi_map, -logits, zero)
    pron_pos = torch.where(pron_map, -logits, zero)
    rel_pos = torch.where(rel_map, -logits, zero)
    other_neg = torch.where(other_map, logits, zero)
    nb_pos = positive_map.sum(-1) + 1e-6
    nb_modi = modi_map.sum(-1) + 1e-6
    nb_pron = pron_map.sum(-1) + 1e-6
    nb_rel = rel_map.sum(-1) + 1e-6

    # object -> text
    neg_term = torch.logsumexp(logits + other_neg, -1)
    box_to_token = (pos_logits.sum(-1) / nb_pos + 0.2 * modi_pos.sum(-1) / nb_modi
                    + 0.2 * pron_pos.sum(-1) / nb_pron + 0.1 * rel_pos.sum(-1) / nb_rel
                    + neg_term)
    box_to_token = torch.where(positive_map.any(-1), box_to_token, torch.zeros_like(box_to_token))
    box_to_token_loss = (box_to_token * mask).sum()

    # text -> object; later assignments of tmask overwrite earlier ones
    tokens_with_pos = (positive_map | modi_map | pron_map | rel_map).any(1)
    eos_hot = F.one_hot(eos_ind, L).bool()
    before_eos = F.one_hot(eos_ind - 1, L).bool()
    tmask = torch.full((B, L), cfg.eos_coef, device=logits.device)
    tmask = torch.where(eos_hot, 1.0, tmask)
    tmask = torch.where(positive_map.any(1), 1.0, tmask)
    tmask = torch.where(modi_map.any(1), 0.2, tmask)
    tmask = torch.where(pron_map.any(1), 0.2, tmask)
    tmask = torch.where(rel_map.any(1), 0.1, tmask)
    tmask = torch.where(before_eos, 0.1, tmask)
    pos_term = pos_logits.sum(1) + modi_pos.sum(1) + pron_pos.sum(1) + rel_pos.sum(1)
    neg_term = torch.logsumexp(logits, 1)
    nb_obj = positive_map.sum(1) + modi_f.sum(1) + pron_f.sum(1) + rel_f.sum(1) + 1e-6
    entropy = -torch.log(nb_obj + 1e-6) / nb_obj
    token_to_box = entropy + pos_term / nb_obj + neg_term
    token_to_box = torch.where(tokens_with_pos, token_to_box, torch.zeros_like(token_to_box))
    token_to_box_loss = (token_to_box * tmask).sum()
    return (box_to_token_loss + token_to_box_loss) / 2.0 / num_boxes


def compute_hungarian_loss(cfg: SetCriterionConfig, end_points: dict, targets: dict,
                           mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(scalar loss, metrics) over all prediction prefixes; with a ``mesh`` of
    several data ranks, this rank's shares of them."""
    prefixes = decoder_prefixes(cfg.num_decoder_layers)
    P = len(prefixes)
    gt_boxes = torch.cat([targets["center_label"], targets["size_gts"]], -1)
    gt_xyzxyz = box_cxcyczwhd_to_xyzxyz(gt_boxes)
    target_valid = targets["box_label_mask"] > 0
    count = target_valid.float().sum()
    shares = mesh is not None and mesh.data > 1
    if shares:
        count = mesh.all_reduce_(count, "data")
    num_boxes = torch.clamp(count, min=1.0) * float(cfg.num_replicas)

    boxes = [torch.cat([end_points[f"{p}center"], end_points[f"{p}pred_size"]], -1)
             for p in prefixes]
    logits = [end_points[f"{p}sem_cls_scores"] for p in prefixes]
    pmap_c = targets["positive_map"][..., :logits[0].shape[-1]]
    # one auction for every prefix: the prefixes stack on the batch axis
    tile = lambda t: t.repeat((P,) + (1,) * (t.dim() - 1))  # noqa: E731
    pred_boxes = torch.cat(boxes)
    match = hungarian_match(torch.cat(logits), box_cxcyczwhd_to_xyzxyz(pred_boxes), pred_boxes,
                            tile(gt_boxes), tile(gt_xyzxyz), tile(pmap_c), tile(target_valid),
                            cost_class=cfg.cost_class, cost_bbox=cfg.cost_bbox,
                            cost_giou=cfg.cost_giou)
    B = gt_boxes.shape[0]
    metrics: Dict[str, torch.Tensor] = {}
    totals = {"ce": 0.0, "bbox": 0.0, "giou": 0.0, "sem": 0.0}
    for i, prefix in enumerate(prefixes):
        m = MatchResult(*(t[i * B:(i + 1) * B] for t in match))
        ce = pos_align_loss(cfg, logits[i], m, targets, num_boxes)
        bbox, giou = box_loss(boxes[i], m, targets, num_boxes)
        metrics[f"{prefix}loss_ce"] = ce
        metrics[f"{prefix}loss_bbox"] = bbox
        metrics[f"{prefix}loss_giou"] = giou
        sem = torch.zeros((), device=gt_boxes.device)
        if cfg.use_contrastive_align:
            sem = sem_align_loss(cfg, end_points[f"{prefix}proj_queries"],
                                 end_points["proj_tokens"], m, targets, num_boxes)
            metrics[f"{prefix}loss_sem_align"] = sem
        for key, value in (("ce", ce), ("bbox", bbox), ("giou", giou), ("sem", sem)):
            totals[key] = totals[key] + value
    kps = kps_loss(end_points, targets, cfg.query_points_obj_topk,
                   B * mesh.data if shares else None)
    w = cfg.loss_weight
    loss = 8.0 * kps + (1.0 / (cfg.num_decoder_layers + 1)) * (
        w * totals["ce"] + 5.0 * totals["bbox"] + totals["giou"] + w * totals["sem"])
    metrics.update(loss_ce=totals["ce"], loss_bbox=totals["bbox"], loss_giou=totals["giou"],
                   loss_sem_align=totals["sem"], query_points_generation_loss=kps, loss=loss)
    return loss, metrics
