"""GroundingDataset: real-data examples in the model's fixed-shape format.

The port's own copy of ``eda_tpu/data/dataset.py``. It joins a packed scan
store with annotation records, augments, builds the decoupled positive maps,
and emits ``{"inputs", "targets", "hardness"}`` of numpy arrays:

inputs:   point_clouds (N, 3+C), text_ids (L,), text_mask (L,),
          [det_boxes (D, 6), det_class_ids (D,), det_mask (D,), det_logits (D, 485)]
targets:  center_label / size_gts (G, 3), box_label_mask (G,),
          {positive, modify_positive, pron_positive, other_entity, rel_positive}
          _map (G, 256), point_instance_label (N,), text_lengths ()
hardness: is_view_dep / is_hard / is_unique flags
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from eda_tpu_torch.data import annotations as anno_lib
from eda_tpu_torch.data.augment import (
    MEAN_RGB,
    augment_scene,
    is_view_dependent,
    rotate_natural,
    rotate_sr3d,
)
from eda_tpu_torch.data.class_config import (
    dc485,
    instance_label_in_class485,
    instance_label_to_class485,
    instance_label_to_scanrefer18,
    raw_to_tsv_id,
)
from eda_tpu_torch.data.positive_maps import MAX_TOKENS, build_positive_maps, not_mentioned_suffix
from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.data.scannet import Scan, load_packed_scans, object_box_from_points
from eda_tpu_torch.data.tokenizer import SimpleTokenizer, make_tokenizer

MAX_NUM_OBJ = 132
LOG = logging.getLogger("eda_tpu_torch")


def require_h5py() -> None:
    """Multiview features need ``h5py``: raise where it is missing, so that no
    run trains without the channel it asked for."""
    if importlib.util.find_spec("h5py") is None:
        raise RuntimeError("--use_multiview reads its features with the h5py package, "
                           "which is not installed")


def load_detected(detected_dir, split: str, scan_id: str):
    """A scan's detections, ``group_free_pred_bboxes_{split}/{scan_id}.npy``
    (a dict of 'box' xyzxyz, 'class' raw labels, 'logits'): (cxcyczwhd boxes,
    485-way class ranks, logits or None), or None where absent."""
    path = osp.join(detected_dir or "", f"group_free_pred_bboxes_{split}", f"{scan_id}.npy")
    if not detected_dir or not osp.exists(path):
        return None
    d = np.load(path, allow_pickle=True).item()
    corners = np.asarray(d["box"], np.float32)
    boxes = np.concatenate(
        [(corners[:, :3] + corners[:, 3:]) / 2, corners[:, 3:] - corners[:, :3]], 1)
    classes = np.array([instance_label_to_class485(str(c)) for c in d["class"]], np.int32)
    logits = np.asarray(d["logits"], np.float32) if "logits" in d else None
    return boxes, classes, logits


def load_cls_results(detected_dir) -> dict:
    """Per-scan predicted object classes for ``--butd_cls``
    (``cls_results.json`` beside the detections); {} where absent."""
    path = osp.join(detected_dir or "", "..", "cls_results.json")
    if detected_dir and osp.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _corrupt_detections(rng, boxes: np.ndarray, classes: np.ndarray):
    """``--augment_det``: with probability 0.3 a detected box becomes a random
    box within the scene's extent with a random 485-way class."""
    if not len(boxes):
        return boxes, classes
    lo, hi = boxes.min(0), boxes.max(0)
    rand_box = (hi - lo)[None] * rng.random(boxes.shape) + lo
    corrupt = rng.random(len(boxes)) > 0.7
    out_boxes = np.where(corrupt[:, None], rand_box, boxes)
    out_classes = np.where(corrupt, rng.integers(0, 485, len(classes)), classes).astype(
        classes.dtype)
    return out_boxes, out_classes


def stack_examples(examples: List[dict]) -> dict:
    """Examples -> one batch: every array of every group stacked."""
    return {group: {k: np.stack([np.asarray(e[group][k]) for e in examples])
                    for k in examples[0][group]}
            for group in ("inputs", "targets", "hardness")}


def detected_arrays(dataset, scan_id: str, aug, rng, oracle):
    """The detected-box stream of one example, as ``MAX_NUM_OBJ`` rows.

    The scan's detections, moved by the example's augmentation ``aug`` (and
    corrupted under ``--augment_det``); or, with ``--butd_gt`` / ``--butd_cls``
    or without detections on disk, the oracle: ``oracle()`` gives the kept
    scene objects' (boxes, 485-way classes), and ``--butd_cls`` swaps in the
    predicted classes of ``cls_results.json``. The logits stay zero under the
    oracle.
    """
    det_boxes = np.zeros((MAX_NUM_OBJ, 6), np.float32)
    det_mask = np.zeros((MAX_NUM_OBJ,), bool)
    det_cls = np.zeros((MAX_NUM_OBJ,), np.int32)
    det_logits = np.zeros((MAX_NUM_OBJ, 485), np.float32)
    detected = None
    if not (dataset.butd_gt or dataset.butd_cls):
        detected = load_detected(dataset.detected_dir, dataset.split, scan_id)
    if detected is not None:
        boxes, classes, logits = detected
        if aug is not None:
            boxes = aug.apply_boxes(boxes)
        if dataset.augment_det and dataset.augment:
            boxes, classes = _corrupt_detections(rng, boxes, classes)
        n = min(len(boxes), MAX_NUM_OBJ)
        det_boxes[:n] = boxes[:n]
        det_mask[:n] = True
        det_cls[:n] = classes[:n]
        if logits is not None:
            k = min(n, len(logits))
            c = min(logits.shape[1], det_logits.shape[1])
            det_logits[:k, :c] = logits[:k, :c]
    else:
        boxes, classes = oracle()
        n = len(boxes)
        det_boxes[:n] = boxes
        det_mask[:n] = True
        det_cls[:n] = classes
        if dataset.butd_cls:
            results = dataset._cls_results()
            if results:
                cls = np.asarray(results[scan_id], np.int32)
                cls = cls[cls > -1]
                if len(cls) != n:
                    raise ValueError(f"cls_results.json has {len(cls)} classes for {scan_id} "
                                     f"but the scan keeps {n} objects")
                det_cls[:n] = cls
            elif not getattr(dataset, "_warned_cls_fallback", False):
                # only a missing file falls back to the ground-truth classes
                dataset._warned_cls_fallback = True
                LOG.warning("--butd_cls without cls_results.json: falling back to GT classes "
                            "(NOT the reference protocol's predicted classes)")
    return {"det_boxes": det_boxes, "det_class_ids": det_cls, "det_mask": det_mask,
            "det_logits": det_logits}


class GroundingDataset:
    """Scan + annotation dataset producing fixed-shape training examples."""

    def __init__(
        self,
        scans: Dict[str, Scan],
        annos: List[dict],
        *,
        split: str = "train",
        use_color: bool = True,
        augment: bool = True,
        detect_intermediate: bool = True,
        butd: bool = False,
        butd_gt: bool = False,
        butd_cls: bool = False,
        text_len: int = MAX_TOKENS,
        tokenizer=None,
        vocab_size: int = 50265,
        seed: int = 0,
        augment_det: bool = False,
        detected_dir: str = None,
        use_height: bool = False,
        multiview_path: str = None,
    ):
        if multiview_path:
            require_h5py()
        self.scans = scans
        self.annos = [a for a in annos if a["scan_id"] in scans]
        self.split = split
        self.use_color = use_color
        self.augment = augment and split == "train"
        self.detect_intermediate = detect_intermediate
        self.butd = butd or butd_gt or butd_cls
        self.butd_gt = butd_gt
        self.butd_cls = butd_cls
        self.augment_det = augment_det
        self.detected_dir = detected_dir
        self.use_height = use_height
        self.multiview_path = multiview_path
        self.text_len = text_len
        self.tokenizer = tokenizer or make_tokenizer(vocab_size=vocab_size)
        self.seed = seed
        # distractors and uniqueness key on the nyu40class NAME, not the id
        anno_lib.compute_scanrefer_flags(self.annos, self.scans, instance_label_to_scanrefer18)

    @classmethod
    def from_args(cls, args, split: str) -> "GroundingDataset":
        """From the training CLI's flags: ``{data_root}/{split}_v3scans.pkl``, the
        annotations of every dataset in ``--dataset``, and the byte-level BPE of
        ``{data_root}/roberta-base``."""
        if getattr(args, "use_multiview", False):
            require_h5py()
        scans = load_packed_scans(osp.join(args.data_root, f"{split}_v3scans.pkl"))
        annos: List[dict] = []
        for name in args.dataset:
            if name == "synthetic":
                continue
            annos.extend(anno_lib.load_annotations(
                name, args.data_root, split, debug=args.debug,
                wo_obj_name=getattr(args, "wo_obj_name", None)))
        tok_path = osp.join(args.data_root, "roberta-base")
        tokenizer = make_tokenizer(tok_path if osp.isdir(tok_path) else None)
        if isinstance(tokenizer, SimpleTokenizer):
            # hash ids alias words and split at words, not BPE pieces: the
            # positive maps would not be RoBERTa's
            msg = (
                "real dataset %s resolved to the hash-id SimpleTokenizer "
                "(no usable %s); token ids and subword boundaries will NOT "
                "match the reference's RoBERTa vocabulary. Provide "
                "vocab.json+merges.txt under that path (read by "
                "eda_tpu_torch.data.bpe, no transformers needed), or set "
                "EDA_TPU_ALLOW_HASH_TOKENIZER=1 to proceed anyway."
                % (args.dataset, tok_path)
            )
            if not os.environ.get("EDA_TPU_ALLOW_HASH_TOKENIZER"):
                raise RuntimeError(msg)
            LOG.warning(msg)
        return cls(
            scans,
            annos,
            split=split,
            use_color=args.use_color,
            augment=getattr(args, "augment", True),
            detect_intermediate=args.detect_intermediate,
            butd=args.butd,
            butd_gt=args.butd_gt,
            butd_cls=args.butd_cls,
            tokenizer=tokenizer,
            augment_det=getattr(args, "augment_det", False),
            detected_dir=osp.join(args.data_root, "group_free_pred_bboxes"),
            use_height=getattr(args, "use_height", False),
            multiview_path=(
                osp.join(args.data_root, "scanrefer_2d_feats", "enet_feats_maxpool.hdf5")
                if getattr(args, "use_multiview", False) else None),
        )

    def __len__(self) -> int:
        return len(self.annos)

    def _cls_results(self) -> dict:
        if not hasattr(self, "_cls_results_cache"):
            self._cls_results_cache = load_cls_results(self.detected_dir)
        return self._cls_results_cache

    def _load_multiview(self, scan_id: str) -> np.ndarray:
        """The scan's 128-d multiview features per point (``enet_feats_maxpool.hdf5``)."""
        import h5py

        if not hasattr(self, "_multiview_file"):
            self._multiview_file = h5py.File(self.multiview_path, "r")
        feats = np.asarray(self._multiview_file[scan_id], np.float32)
        n = len(self.scans[scan_id].pc)
        if len(feats) != n:
            # rows pair 1:1 with the packed points: any other count misaligns them
            raise ValueError(f"multiview store for {scan_id} has {len(feats)} rows but "
                             f"the packed scan keeps {n} points")
        return feats

    def example(self, idx: int, butd: Optional[bool] = None) -> dict:
        butd = self.butd if butd is None else butd
        anno = self.annos[idx]
        scan = self.scans[anno["scan_id"]]
        rng = np.random.default_rng((self.seed * 1_000_003 + idx) % (2**31))

        xyz = scan.pc.copy()
        color = scan.color - MEAN_RGB if self.use_color else None

        # the target, and the first anchor under --detect_intermediate
        tids = [anno["target_id"]]
        if (self.detect_intermediate and anno.get("anchor_ids")
                and anno.get("decoupled", {}).get("auxi")):
            tids.append(anno["anchor_ids"][0])
        obj_idxs = [scan.object_by_id(t) for t in tids]
        obj_idxs = [o for o in obj_idxs if o is not None]

        point_instance = -np.ones(len(xyz), np.int32)
        for slot, o in enumerate(obj_idxs):
            point_instance[scan.three_d_objects[o]["points"]] = slot

        # height is measured on the cloud before augmentation
        height = None
        if self.use_height:
            floor = np.percentile(xyz[:, 2], 0.99)
            height = (xyz[:, 2] - floor)[:, None].astype(np.float32)

        aug = None
        if self.augment:
            # sr3d gates on the relation, nr3d / scanrefer on the view words
            dset = anno.get("dataset", "scanrefer")
            if dset.startswith("sr3d"):
                rotate = rotate_sr3d(anno["utterance"])
            else:
                rotate = dset == "scannet" or rotate_natural(anno["utterance"])
            xyz, color, _, aug = augment_scene(rng, xyz, color, np.zeros((0, 6), np.float32),
                                               rotate)

        # every box is recomputed from the augmented points
        def obj_box(o: int) -> np.ndarray:
            return object_box_from_points(xyz, scan.three_d_objects[o]["points"])

        # scene objects: those of the 485-class vocabulary among the first 132
        scene_objs = [
            o for o in range(min(len(scan.three_d_objects), MAX_NUM_OBJ))
            if instance_label_in_class485(scan.three_d_objects[o]["instance_label"])
        ]
        scene_boxes = (np.stack([obj_box(o) for o in scene_objs]).astype(np.float32)
                       if scene_objs else np.zeros((0, 6), np.float32))
        scene_classes = np.array(
            [instance_label_to_class485(scan.three_d_objects[o]["instance_label"])
             for o in scene_objs], np.int32)

        gt_boxes = np.stack([obj_box(o) for o in obj_idxs])
        if self.augment:
            # box jitter, of the targets and of the scene boxes
            gt_boxes = gt_boxes * (0.95 + 0.1 * rng.random(gt_boxes.shape))
            scene_boxes = scene_boxes * (0.95 + 0.1 * rng.random(scene_boxes.shape)).astype(
                np.float32)

        caption = not_mentioned_suffix(anno["utterance"])
        tok = self.tokenizer.encode_batch([caption], max_len=self.text_len)
        maps = build_positive_maps(tok, 0, anno["decoupled"])

        G = MAX_NUM_OBJ
        center_label = np.zeros((G, 3), np.float32)
        size_gts = np.zeros((G, 3), np.float32)
        box_label_mask = np.zeros((G,), np.float32)
        n_t = len(obj_idxs)
        center_label[:n_t] = gt_boxes[:, :3]
        center_label[n_t:] = 1000.0
        size_gts[:n_t] = gt_boxes[:, 3:]
        box_label_mask[:n_t] = 1.0

        def tile(key, row=0):
            out = np.zeros((G, MAX_TOKENS), np.float32)
            out[row] = maps[key]
            return out

        # the auxiliary entity's box: the nearest scene box of its class within
        # 10 m of the target; row 1 of the target map takes the auxi map only
        # where it resolves and the dataset is sr3d (not sr3d+)
        auxi_box = None
        lemma = anno.get("decoupled", {}).get("auxi_lemma", "")
        if lemma and anno.get("dataset") != "scannet":
            cls_id = dc485().nyu40id2class.get(raw_to_tsv_id().get(lemma))
            if cls_id is not None and len(gt_boxes):
                best_d = 100.0
                for j, o in enumerate(scene_objs):
                    if o == (obj_idxs[0] if obj_idxs else -1):
                        continue
                    if scene_classes[j] == cls_id:
                        d = float(((gt_boxes[0, :3] - scene_boxes[j, :3]) ** 2).sum())
                        if d < best_d:
                            best_d = d
                            auxi_box = scene_boxes[j]

        positive_map = tile("main")
        if n_t > 1 and auxi_box is not None and anno.get("dataset") == "sr3d":
            positive_map[1] = maps["auxi"]

        extras = []
        if height is not None:
            extras.append(height)
        if self.multiview_path:
            extras.append(self._load_multiview(anno["scan_id"]))

        # Morton order after augmentation: the fused SA reads sorted clouds
        arrays = [a for a in (color, point_instance, *extras) if a is not None]
        sorted_all = morton_sort(xyz, *arrays)
        xyz = sorted_all[0]
        rest = list(sorted_all[1:])
        if color is not None:
            color = rest.pop(0)
        point_instance = rest.pop(0)
        extras = rest

        pc = xyz.astype(np.float32)
        if color is not None:
            pc = np.concatenate([pc, color.astype(np.float32)], -1)
        for extra in extras:
            pc = np.concatenate([pc, extra.astype(np.float32)], -1)

        inputs = {
            "point_clouds": pc,
            "text_ids": tok.input_ids[0],
            "text_mask": tok.attention_mask[0],
        }
        if butd:
            inputs.update(detected_arrays(self, anno["scan_id"], aug, rng,
                                          lambda: (scene_boxes, scene_classes)))

        targets = {
            "center_label": center_label,
            "size_gts": size_gts,
            "box_label_mask": box_label_mask,
            "positive_map": positive_map,
            "modify_positive_map": tile("modifiers"),
            "pron_positive_map": tile("pronouns"),
            "other_entity_map": tile("others"),
            "rel_positive_map": tile("relations"),
            "point_instance_label": point_instance,
            "text_lengths": np.int32(tok.lengths[0]),
        }
        hardness = {
            "is_view_dep": is_view_dependent(anno["utterance"]),
            "is_hard": len(anno.get("distractor_ids", [])) > 1,
            "is_unique": len(anno.get("distractor_ids", [])) == 0,
        }
        return {"inputs": inputs, "targets": targets, "hardness": hardness}

    def batch(self, indices, butd: Optional[bool] = None) -> dict:
        return stack_examples([self.example(int(i), butd) for i in indices])
