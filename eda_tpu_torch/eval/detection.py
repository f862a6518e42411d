"""Detection AP: prediction parsing, greedy matching, VOC AP.

The port's copy of ``eda_tpu/eval/detection.py`` (host-side numpy, the same
sorts and tie order, so that AP equals the JAX package's to the last digit),
itself a port of the reference's detection-evaluation branch:

* ``parse_predictions`` (``models/ap_helper.py:71-236``): axis-aligned boxes
  (heading is always 0 in this pipeline), objectness from
  ``1 - P(not-mentioned)`` over the soft-token scores (``:142-150``),
  class-aware 3D NMS (``:192-213``), per-class proposals (``:216-234``);
* ``parse_groundtruths`` (``ap_helper.py:239-296``);
* ``APCalculator`` + ``eval_det`` (``utils/eval_det.py:30-252``): greedy
  TP/FP matching per class at an IoU threshold, 11-point-free VOC AP.

All boxes here are corner-format xyzxyz in the depth frame; the reference's
camera-frame flip (``flip_axis_to_camera``) is an internal representation
detail it undoes at IoU time, so it is dropped.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from eda_tpu_torch.eval.nms import nms_3d


def _center_size_to_corners(boxes: np.ndarray) -> np.ndarray:
    """(..., 6) cxcyczwhd -> (..., 6) xyzxyz."""
    return np.concatenate(
        [boxes[..., :3] - boxes[..., 3:] / 2, boxes[..., :3] + boxes[..., 3:] / 2],
        -1,
    )


def parse_predictions(
    pred_center: np.ndarray,
    pred_size: np.ndarray,
    sem_cls_scores: np.ndarray,
    *,
    nms_iou: float = 0.25,
    conf_thresh: float = 0.0,
    per_class_proposal: bool = True,
    num_classes: int | None = None,
) -> List[List[Tuple[int, np.ndarray, float]]]:
    """Per-sample list of (class_id, box_corners(6,), score) detections.

    sem_cls_scores: (B, Q, C+1) soft-token logits whose LAST column is the
    'not mentioned' slot; objectness = 1 - P(last), class probs renormalized
    (ap_helper.py:146-150).
    """
    B, Q, _ = sem_cls_scores.shape
    probs = np.exp(sem_cls_scores - sem_cls_scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    obj_prob = 1.0 - probs[..., -1]  # (B, Q)
    cls_probs = probs[..., :-1] / np.maximum(obj_prob[..., None], 1e-9)
    if num_classes is not None:
        cls_probs = cls_probs[..., :num_classes]
    pred_cls = cls_probs.argmax(-1)  # (B, Q)
    corners = _center_size_to_corners(
        np.concatenate([pred_center, np.abs(pred_size)], -1)
    )  # (B, Q, 6)

    results: List[List[Tuple[int, np.ndarray, float]]] = []
    for b in range(B):
        keep = nms_3d(corners[b], obj_prob[b], nms_iou, classes=pred_cls[b])
        dets: List[Tuple[int, np.ndarray, float]] = []
        # Reference filters on OBJECTNESS, not the per-class score
        # (ap_helper.py:222-228: `obj_prob[i, j] > conf_thresh`).
        if per_class_proposal:
            for c in range(cls_probs.shape[-1]):
                for j in keep:
                    if obj_prob[b, j] > conf_thresh:
                        score = cls_probs[b, j, c] * obj_prob[b, j]
                        dets.append((c, corners[b, j], float(score)))
        else:
            for j in keep:
                if obj_prob[b, j] > conf_thresh:
                    dets.append(
                        (int(pred_cls[b, j]), corners[b, j], float(obj_prob[b, j]))
                    )
        results.append(dets)
    return results


def parse_predictions_from_probs(
    pred_center: np.ndarray,
    pred_size: np.ndarray,
    cls_probs: np.ndarray,
    obj_prob: np.ndarray,
    *,
    nms_iou: float = 0.25,
    conf_thresh: float = 0.0,
    per_class_proposal: bool = True,
) -> List[List[Tuple[int, np.ndarray, float]]]:
    """Like ``parse_predictions`` but with precomputed class/objectness probs.

    Used by the scannet detection-eval branch, where the soft-token scores
    are first projected onto class-name token spans
    (``train_dist_mod.py:248-279``).
    """
    B, Q, _ = cls_probs.shape
    pred_cls = cls_probs.argmax(-1)
    corners = _center_size_to_corners(
        np.concatenate([pred_center, np.abs(pred_size)], -1)
    )
    results: List[List[Tuple[int, np.ndarray, float]]] = []
    for b in range(B):
        keep = nms_3d(corners[b], obj_prob[b], nms_iou, classes=pred_cls[b])
        dets: List[Tuple[int, np.ndarray, float]] = []
        if per_class_proposal:
            for c in range(cls_probs.shape[-1]):
                for j in keep:
                    if obj_prob[b, j] > conf_thresh:
                        score = cls_probs[b, j, c] * obj_prob[b, j]
                        dets.append((c, corners[b, j], float(score)))
        else:
            for j in keep:
                if obj_prob[b, j] > conf_thresh:
                    dets.append(
                        (int(pred_cls[b, j]), corners[b, j], float(obj_prob[b, j]))
                    )
        results.append(dets)
    return results


def parse_groundtruths(
    gt_boxes: np.ndarray, gt_classes: np.ndarray, gt_mask: np.ndarray
) -> List[List[Tuple[int, np.ndarray]]]:
    """Per-sample list of (class_id, box_corners(6,)). Boxes are cxcyczwhd."""
    corners = _center_size_to_corners(gt_boxes)
    out = []
    for b in range(gt_boxes.shape[0]):
        out.append(
            [
                (int(gt_classes[b, g]), corners[b, g])
                for g in range(gt_boxes.shape[1])
                if gt_mask[b, g]
            ]
        )
    return out


def _iou_corner(a: np.ndarray, b: np.ndarray) -> float:
    lo = np.maximum(a[:3], b[:3])
    hi = np.minimum(a[3:], b[3:])
    whd = np.clip(hi - lo, 0, None)
    inter = whd.prod()
    va = np.prod(a[3:] - a[:3])
    vb = np.prod(b[3:] - b[:3])
    return float(inter / max(va + vb - inter, 1e-9))


def generalized_box_iou_corners(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise GIoU for corner-format (N, 6)/(M, 6) xyzxyz boxes -> (N, M).

    Numpy port of the reference's ``utils/eval_det.py:87-131``
    ``generalized_box_iou3d`` (the copy its ``eval_grounding`` uses): plain
    GIoU = IoU - (hull - union) / hull, no epsilon guards — callers must
    pass non-degenerate boxes (the reference asserts the same).
    """
    assert (a[:, 3:] >= a[:, :3]).all() and (b[:, 3:] >= b[:, :3]).all()
    lo = np.maximum(a[:, None, :3], b[None, :, :3])
    hi = np.minimum(a[:, None, 3:], b[None, :, 3:])
    inter = np.clip(hi - lo, 0, None).prod(-1)
    va = np.prod(a[:, 3:] - a[:, :3], -1)
    vb = np.prod(b[:, 3:] - b[:, :3], -1)
    union = va[:, None] + vb[None, :] - inter
    iou = inter / union
    hull_lo = np.minimum(a[:, None, :3], b[None, :, :3])
    hull_hi = np.maximum(a[:, None, 3:], b[None, :, 3:])
    hull = np.clip(hull_hi - hull_lo, 0, None).prod(-1)
    return iou - (hull - union) / hull


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated VOC AP (utils/eval_det.py:30-66, use_07=False)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class APCalculator:
    """Accumulates detections/GT and computes per-class AP + recall.

    Mirrors ``models/ap_helper.py:299-362`` + ``utils/eval_det.py:160-252``
    (single-process; the reference's Pool(10) parallel matching is
    unnecessary at these scales).
    """

    def __init__(self, iou_thresh: float = 0.25):
        self.iou_thresh = iou_thresh
        self.reset()

    def reset(self):
        self._pred: Dict[int, List] = {}
        self._gt: Dict[int, List] = {}
        self._scan = 0

    def step(self, batch_pred, batch_gt):
        """batch_pred: from parse_predictions; batch_gt: from parse_groundtruths."""
        for preds, gts in zip(batch_pred, batch_gt):
            sid = self._scan
            self._scan += 1
            self._pred[sid] = preds
            self._gt[sid] = gts

    def compute_metrics(self) -> Dict[str, float]:
        # The class universe is GT classes UNION predicted classes: the
        # reference's eval_det seeds `gt[classname]` while walking the
        # predictions too (utils/eval_det.py:277-286), so with per-class
        # proposals every class scores (pred-only classes at AP 0) and the
        # mAP mean runs over all of them (ap_helper.py:341).
        classes = sorted(
            {c for gts in self._gt.values() for c, _ in gts}
            | {c for preds in self._pred.values() for c, _, _ in preds}
        )
        out: Dict[str, float] = {}
        aps, recs = [], []
        for c in classes:
            ap, rec = self._eval_class(c)
            out[f"ap_{c}"] = ap
            out[f"recall_{c}"] = rec
            aps.append(ap)
            recs.append(rec)
        out["mAP"] = float(np.mean(aps)) if aps else 0.0
        out["AR"] = float(np.mean(recs)) if recs else 0.0
        return out

    def compute_accuracy(
        self, ovthresh: float | None = None
    ) -> Dict[int, float]:
        """GIoU-based grounding accuracy at top-{1,5,10}.

        Port of ``APCalculator.compute_accuracy`` -> ``eval_grounding``
        (``models/ap_helper.py:355-358``, ``utils/eval_det.py:364-413``):
        per scan, predictions sorted by score (stable descending, matching
        Python ``sorted``), GIoU of the top-k boxes against the FIRST GT box
        (``target[:1]``), a hit when any exceeds the threshold. Class labels
        are ignored — only geometry scores. Dead code in the reference
        (nothing calls ``compute_accuracy``); kept for surface parity.
        A scan with no predictions counts as a miss (the reference would
        raise on the empty unpack — deviation pinned in the parity test
        docstring).
        """
        if ovthresh is None:
            ovthresh = self.iou_thresh
        ks = (1, 5, 10)
        score = {k: 0.0 for k in ks}
        count = 0.0
        for sid, gts in self._gt.items():
            if not gts:
                continue
            count += 1.0
            preds = self._pred.get(sid, [])
            if not preds:
                continue
            order = sorted(range(len(preds)), key=lambda i: -preds[i][2])
            boxes = np.stack([preds[i][1] for i in order])  # (N, 6)
            target = gts[0][1][None, :]  # (1, 6) — target[:1]
            giou = generalized_box_iou_corners(boxes, target)[:, 0]
            for k in ks:
                if giou[:k].max() >= ovthresh:
                    score[k] += 1.0
        for k in ks:
            if count:
                score[k] /= count
        return score

    def _eval_class(self, cls: int) -> Tuple[float, float]:
        # gather gt per scan
        gt_boxes = {
            sid: [box for c, box in gts if c == cls] for sid, gts in self._gt.items()
        }
        npos = sum(len(v) for v in gt_boxes.values())
        dets = []  # (score, sid, box)
        for sid, preds in self._pred.items():
            for c, box, score in preds:
                if c == cls:
                    dets.append((score, sid, box))
        if not dets or npos == 0:
            return 0.0, 0.0
        dets.sort(key=lambda d: -d[0])
        used = {sid: np.zeros(len(b), bool) for sid, b in gt_boxes.items()}
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (_, sid, box) in enumerate(dets):
            candidates = gt_boxes.get(sid, [])
            best_iou, best_j = 0.0, -1
            for j, gt in enumerate(candidates):
                iou = _iou_corner(box, gt)
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou > self.iou_thresh and not used[sid][best_j]:
                tp[i] = 1
                used[sid][best_j] = True
            else:
                fp[i] = 1
        cum_tp = np.cumsum(tp)
        cum_fp = np.cumsum(fp)
        # reference denominators verbatim (utils/eval_det.py:240-249)
        recall = cum_tp / float(npos + 1e-8)
        precision = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float64).eps)
        return voc_ap(recall, precision), float(recall[-1])
