"""Grounding evaluator: Acc@{0.25,0.5} x Top-{1,5,10} under two scoring modes.

Counterpart of ``eda_tpu/eval/grounding.py``:

* ``bbs`` — position alignment: soft-token class scores x decoupled positive
  maps;
* ``bbf`` — semantic alignment: query-token similarities at T = 0.07;

both combine component scores as ``main + modi + pron + rel - other``, take
the top-10 queries of the root annotated object, and threshold their 3D IoU
with its GT box. Hardness breakdowns (view-dep / hard / unique) accumulate on
the ``last_`` prefix at top-1.

Scoring runs on the end points' device; the evaluator pulls the
(P, M, B, 10) IoU stack to the host once per batch and only counts there, so
merging evaluators is a sum of counters.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from eda_tpu_torch.models.grounder import top_k_indices
from eda_tpu_torch.ops.boxes import box_cxcyczwhd_to_xyzxyz, pairwise_box_iou_3d

TEMPERATURE = 0.07


def grounding_scores(end_points: dict, targets: dict, *, prefix: str, mode: str):
    """(scores (B, Q), pred_bbox (B, Q, 6)): each query's grounding score for
    the root (first) annotated object, and its cxcyczwhd box.

    With ``targets["__det_boxes"]`` (and ``__det_mask``) a prediction that
    overlaps no valid detected box by IoU > 0.25 scores +0, the
    ``filter_non_gt_boxes`` protocol.
    """
    pred_bbox = torch.cat([end_points[f"{prefix}center"], end_points[f"{prefix}pred_size"]], -1)
    if mode == "bbs":
        sem = torch.softmax(end_points[f"{prefix}sem_cls_scores"], -1)  # (B, Q, C)
    else:  # bbf
        sim = torch.einsum("bqd,bld->bql", end_points[f"{prefix}proj_queries"],
                           end_points["proj_tokens"])
        sem = torch.softmax(sim / TEMPERATURE, -1)  # (B, Q, L)
    C = sem.shape[-1]

    def comp(key, binarize=False):
        m = targets[key][:, 0, :C]  # root object row, (B, C)
        if binarize:
            m = (m > 0).to(sem.dtype)
        return torch.einsum("bqc,bc->bq", sem, m)

    scores = (comp("positive_map", binarize=True) + comp("modify_positive_map")
              + comp("pron_positive_map") + comp("rel_positive_map")
              - comp("other_entity_map"))  # (B, Q)

    if "__det_boxes" in targets:
        iou_dp, _ = pairwise_box_iou_3d(box_cxcyczwhd_to_xyzxyz(targets["__det_boxes"]),
                                        box_cxcyczwhd_to_xyzxyz(pred_bbox))  # (B, D, Q)
        iou_dp = torch.where(targets["__det_mask"].bool()[:, :, None], iou_dp, 0.0)
        # +0 for a filtered prediction whatever its score's sign: the jitted
        # reference's ``scores * is_correct`` compiles to a select
        scores = torch.where(iou_dp.amax(1) > 0.25, scores, 0.0)
    return scores, pred_bbox


def score_and_iou(end_points: dict, targets: dict, *, prefix: str, mode: str,
                  topk: int = 10) -> torch.Tensor:
    """(B, topk) IoU of each sample's top-k predicted boxes with its root GT box.

    The root (first) annotated object only, as the reference's
    ``only_root=True`` grounding configuration; scores as ``grounding_scores``.
    Ranks follow ``lax.top_k``: descending, +0 above -0, lowest query first
    among ties.
    """
    scores, pred_bbox = grounding_scores(end_points, targets, prefix=prefix, mode=mode)
    k = min(topk, scores.shape[-1])
    top = top_k_indices(scores, k)  # (B, k)
    boxes = pred_bbox.gather(1, top[..., None].expand(-1, -1, 6))
    gt_root = torch.cat([targets["center_label"][:, :1], targets["size_gts"][:, :1]], -1)
    ious, _ = pairwise_box_iou_3d(box_cxcyczwhd_to_xyzxyz(gt_root),
                                  box_cxcyczwhd_to_xyzxyz(boxes))  # (B, 1, k)
    ious = ious[:, 0]
    if k < topk:  # fewer queries than ranks: pad as misses
        ious = torch.nn.functional.pad(ious, (0, topk - k))
    return ious


def score_and_iou_multi(end_points: dict, targets: dict, *, prefixes: Sequence[str],
                        modes: Sequence[str], topk: int = 10) -> torch.Tensor:
    """All (prefix, mode) IoU matrices stacked as one (P, M, B, topk) tensor."""
    return torch.stack([
        torch.stack([score_and_iou(end_points, targets, prefix=p, mode=m, topk=topk)
                     for m in modes])
        for p in prefixes
    ])


class GroundingEvaluator:
    """Accumulates Acc@threshold x top-k counters across batches (host integers)."""

    def __init__(
        self,
        prefixes: Sequence[str] = ("last_", "proposal_"),
        thresholds: Sequence[float] = (0.25, 0.5),
        topks: Sequence[int] = (1, 5, 10),
        modes: Sequence[str] = ("bbs", "bbf"),
        filter_non_gt_boxes: bool = False,
    ):
        self.prefixes = tuple(prefixes)
        self.thresholds = tuple(thresholds)
        self.topks = tuple(topks)
        self.modes = tuple(modes)
        # butd_cls protocol: drop predictions with no detected-box overlap
        self.filter_non_gt_boxes = filter_non_gt_boxes
        self.dets: Dict = {}
        self.gts: Dict = {}
        self.reset()

    def reset(self):
        for prefix in self.prefixes:
            for t in self.thresholds:
                for k in self.topks:
                    for mode in self.modes:
                        self.dets[(prefix, t, k, mode)] = 0
                        self.gts[(prefix, t, k, mode)] = 0
        for key in ("vd", "vid", "hard", "easy", "unique", "multi",
                    "vd50", "vid50", "hard50", "easy50", "unique50", "multi50"):
            self.dets[key] = 0
            self.gts[key] = 0

    def evaluate(self, end_points: Optional[dict], targets: Optional[dict],
                 hardness: Optional[dict] = None, valid: Optional[np.ndarray] = None,
                 inputs: Optional[dict] = None, ious=None):
        """Accumulate one batch.

        ``hardness``: optional bool arrays (B,) keyed is_view_dep / is_hard /
        is_unique. ``valid``: optional bool (B,) marking real samples (a padded
        tail batch counts only its real rows). ``inputs``: the model inputs,
        needed (det_boxes / det_mask) when ``filter_non_gt_boxes`` is set.
        ``ious``: optionally the precomputed (P, M, B, topk) stack of
        ``score_and_iou_multi`` (ordered as self.prefixes x self.modes, e.g.
        from ``train.step.make_eval_score_step``), a tensor on any device or
        an array; ``end_points``, ``targets`` and ``inputs`` may then be None.
        """
        if ious is None:
            if self.filter_non_gt_boxes and inputs is not None and "det_boxes" in inputs:
                targets = {**targets, "__det_boxes": inputs["det_boxes"],
                           "__det_mask": inputs["det_mask"]}
            with torch.inference_mode():
                ious = score_and_iou_multi(end_points, targets, prefixes=self.prefixes,
                                           modes=self.modes)
        if isinstance(ious, torch.Tensor):
            ious = ious.cpu().numpy()
        ious = np.asarray(ious)
        for pi, prefix in enumerate(self.prefixes):
            for mi, mode in enumerate(self.modes):
                iou_pm = ious[pi, mi]  # (B, 10)
                B = iou_pm.shape[0]
                vmask = np.ones(B, bool) if valid is None else np.asarray(valid, bool)
                for t in self.thresholds:
                    hit = iou_pm > t
                    for k in self.topks:
                        found = hit[:, :k].any(1) & vmask
                        self.dets[(prefix, t, k, mode)] += int(found.sum())
                        self.gts[(prefix, t, k, mode)] += int(vmask.sum())
                        if (mode == "bbf" and prefix == "last_" and k == 1
                                and hardness is not None):
                            suffix = "" if t == self.thresholds[0] else "50"
                            if t in (self.thresholds[0], self.thresholds[1]):
                                self._breakdown(found, hardness, suffix, vmask)

    def _breakdown(self, found: np.ndarray, hardness: dict, suffix: str, vmask: np.ndarray):
        for flag, yes, no in (("is_view_dep", "vd", "vid"), ("is_hard", "hard", "easy"),
                              ("is_unique", "unique", "multi")):
            mask = np.asarray(hardness[flag]).astype(bool) & vmask
            inv = ~np.asarray(hardness[flag]).astype(bool) & vmask
            self.dets[yes + suffix] += int(found[mask].sum())
            self.gts[yes + suffix] += int(mask.sum())
            self.dets[no + suffix] += int(found[inv].sum())
            self.gts[no + suffix] += int(inv.sum())

    def merge(self, other: "GroundingEvaluator"):
        """Reduction across evaluators: plain counter sum."""
        for key in self.dets:
            self.dets[key] += other.dets[key]
            self.gts[key] += other.gts[key]

    def accuracy(self, prefix="last_", threshold=0.25, topk=1, mode="bbf") -> float:
        key = (prefix, threshold, topk, mode)
        return self.dets[key] / max(self.gts[key], 1)

    def print_stats(self) -> str:
        """Reference-style accuracy table."""
        mode_str = {"bbs": "Box given span (soft-token)", "bbf": "Box given span (contrastive)"}
        lines = []
        for prefix in self.prefixes:
            for mode in self.modes:
                line = f"{prefix} {mode_str[mode]} "
                for t in self.thresholds:
                    for k in self.topks:
                        acc = self.accuracy(prefix, t, k, mode)
                        line += f"Acc{t}Top{k}: {acc:.4f} "
                lines.append(line)
        for key in ("vd", "vid", "hard", "easy", "unique", "multi"):
            if self.gts[key]:
                lines.append(f"{key}: {self.dets[key] / max(self.gts[key], 1):.4f} "
                             f"({self.dets[key]}/{self.gts[key]})")
        return "\n".join(lines)
