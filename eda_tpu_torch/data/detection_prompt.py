"""ScanNet detection prompts (the ``--joint_det`` auxiliary task) and dataset mixing.

The port's own copy of ``eda_tpu/data/detection_prompt.py``. Each scene
becomes a detection example whose utterance is a ``' . '``-joined list of
class names: the fixed 18-class prompt at evaluation, or at training, half of
the time, up to 10 present class names mixed with 10 absent ones. Its targets
are the scene's objects of the prompted classes; each target's positive map
marks its class name's span, and the other maps stay empty.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from eda_tpu_torch.data.augment import MEAN_RGB, augment_scene
from eda_tpu_torch.data.class_config import (
    NYU40_IDS_18,
    dc485,
    instance_label_in_class485,
    instance_label_to_class18,
    instance_label_to_class485,
    raw_to_nyu40,
)
from eda_tpu_torch.data.dataset import (
    MAX_NUM_OBJ,
    detected_arrays,
    load_cls_results,
    require_h5py,
    stack_examples,
)
from eda_tpu_torch.data.positive_maps import MAX_TOKENS, spans_to_map
from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.data.scannet import object_box_from_points
from eda_tpu_torch.data.tokenizer import make_tokenizer
from eda_tpu_torch.data.vocab import LABELS_TSV

_NYU18_SET = frozenset(NYU40_IDS_18)

# the names the prompts use (display names: 'couch', 'shower curtain', ...)
PROMPT_NAMES = [
    "cabinet", "bed", "chair", "couch", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "shower curtain", "toilet", "sink", "bathtub", "other furniture",
]


def _split_file_order(split: str):
    """Scan ids in ``meta/scannetv2_{split}.txt`` order; None where the file is absent."""
    path = osp.join(osp.dirname(LABELS_TSV),
                    f"scannetv2_{'train' if split == 'train' else 'val'}.txt")
    if not osp.exists(path):
        return None
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class DetectionPromptDataset:
    """Scenes -> detection-prompt examples with the ``GroundingDataset`` interface."""

    def __init__(
        self,
        scans: Dict,
        *,
        split: str = "train",
        use_color: bool = True,
        augment: bool = True,
        text_len: int = 256,
        tokenizer=None,
        vocab_size: int = 50265,
        seed: int = 0,
        use_height: bool = False,
        multiview_path: str = None,
        detected_dir: str = None,
        augment_det: bool = False,
        butd_gt: bool = False,
        butd_cls: bool = False,
    ):
        if multiview_path:
            require_h5py()
        # scans with at least one object of the 485-class vocabulary
        self.scan_ids = [
            sid for sid, scan in scans.items()
            if any(instance_label_in_class485(o["instance_label"]) for o in scan.three_d_objects)
        ]
        split_order = _split_file_order(split)
        in_order = ([s for s in split_order if s in set(self.scan_ids)]
                    if split_order is not None else [])
        if in_order:
            # the split file's scans in its order, and train drops the scans at
            # positions 965 and 977 of that order; scans outside the file (test
            # fixtures) keep their order and skip the drop
            self.scan_ids = in_order
            if split == "train":
                self.scan_ids = [s for i, s in enumerate(self.scan_ids) if i not in (965, 977)]
        self.scans = scans
        self.split = split
        self.use_color = use_color
        self.use_height = use_height
        self.multiview_path = multiview_path
        self.augment = augment and split == "train"
        self.text_len = text_len
        self.tokenizer = tokenizer or make_tokenizer(vocab_size=vocab_size)
        self.seed = seed
        self.detected_dir = detected_dir
        self.augment_det = augment_det
        self.butd_gt = butd_gt
        self.butd_cls = butd_cls

    def __len__(self) -> int:
        return len(self.scan_ids)

    def _cls_results(self) -> dict:
        if not hasattr(self, "_cls_results_cache"):
            self._cls_results_cache = load_cls_results(self.detected_dir)
        return self._cls_results_cache

    def example(self, idx: int, butd: bool = False) -> dict:
        rng = np.random.default_rng((self.seed * 7_777_777 + idx) % (2**31))
        scan_id = self.scan_ids[idx % len(self.scan_ids)]
        scan = self.scans[scan_id]

        labels = [o["instance_label"] for o in scan.three_d_objects]
        random_utt = self.split == "train" and rng.random() > 0.5
        if random_utt:
            # up to 10 present 485-class names and 10 distinct absent ones,
            # sorted, then shuffled
            cfg = dc485()
            present = sorted({instance_label_to_class485(lbl) for lbl in labels
                              if instance_label_in_class485(lbl)})
            if len(present) > 10:
                present = sorted(rng.choice(present, 10, replace=False))
            sampled_names = [cfg.class2type[c] for c in present]
            rng.shuffle(sampled_names)
            neg_names: List[str] = []
            while len(neg_names) < 10:
                name = cfg.class2type[int(rng.integers(0, cfg.num_class))]
                if name not in neg_names and name not in sampled_names:
                    neg_names.append(name)
            names = sorted(set(sampled_names + neg_names))
            rng.shuffle(names)
            # targets: objects of a sampled class among the first 132
            target_objs = [
                i for i in range(min(len(labels), MAX_NUM_OBJ))
                if instance_label_in_class485(labels[i])
                and cfg.class2type[instance_label_to_class485(labels[i])] in sampled_names
            ]
            obj_names = {i: cfg.class2type[instance_label_to_class485(labels[i])]
                         for i in target_objs}
        else:
            # the fixed 18-class prompt; targets are objects whose NYU40 id is
            # one of the 18 (no 'other' class)
            names = list(PROMPT_NAMES)
            target_objs = [i for i in range(min(len(labels), MAX_NUM_OBJ))
                           if raw_to_nyu40().get(labels[i]) in _NYU18_SET]
            obj_names = {i: PROMPT_NAMES[instance_label_to_class18(labels[i])]
                         for i in target_objs}
        utterance = " . ".join(names)

        xyz = scan.pc.copy()
        color = scan.color - MEAN_RGB if self.use_color else None
        # height is measured on the cloud before augmentation
        height = None
        if self.use_height:
            floor = np.percentile(xyz[:, 2], 0.99)
            height = (xyz[:, 2] - floor)[:, None].astype(np.float32)
        multiview = None
        if self.multiview_path:
            import h5py

            if not hasattr(self, "_multiview_file"):
                self._multiview_file = h5py.File(self.multiview_path, "r")
            multiview = np.asarray(self._multiview_file[scan_id], np.float32)
            if len(multiview) != len(xyz):
                raise ValueError(f"multiview store has {len(multiview)} rows but the scan "
                                 f"keeps {len(xyz)} points")
        point_instance = -np.ones(len(xyz), np.int32)
        for slot, o in enumerate(target_objs):
            point_instance[scan.three_d_objects[o]["points"]] = slot

        aug = None
        if self.augment:
            # scannet prompts always rotate
            xyz, color, _, aug = augment_scene(rng, xyz, color, np.zeros((0, 6), np.float32),
                                               True)

        def obj_box(o: int) -> np.ndarray:
            return object_box_from_points(xyz, scan.three_d_objects[o]["points"])

        gt_boxes = (np.stack([obj_box(o) for o in target_objs]).astype(np.float32)
                    if target_objs else np.zeros((0, 6), np.float32))
        if self.augment and len(gt_boxes):
            gt_boxes = gt_boxes * (0.95 + 0.1 * rng.random(gt_boxes.shape)).astype(np.float32)

        caption = utterance + " . not mentioned"
        tok = self.tokenizer.encode_batch([caption], max_len=self.text_len)

        G = MAX_NUM_OBJ
        center_label = np.zeros((G, 3), np.float32)
        center_label[:] = 1000.0
        size_gts = np.zeros((G, 3), np.float32)
        box_label_mask = np.zeros((G,), np.float32)
        n_t = len(target_objs)
        if n_t:
            center_label[:n_t] = gt_boxes[:, :3]
            size_gts[:n_t] = gt_boxes[:, 3:]
            box_label_mask[:n_t] = 1.0

        # each target's positive map: its class name's span in the prompt
        positive_map = np.zeros((G, MAX_TOKENS), np.float32)
        padded = " " + caption + " "
        for slot, o in enumerate(target_objs):
            name = obj_names[o]
            start = padded.find(" " + name + " ")
            if start < 0:
                continue
            positive_map[slot] = spans_to_map(tok, 0, [(start, start + len(name))])

        arrays = [a for a in (color, height, multiview, point_instance) if a is not None]
        sorted_all = morton_sort(xyz, *arrays)
        xyz, rest = sorted_all[0], list(sorted_all[1:])
        pc = xyz.astype(np.float32)
        if color is not None:
            pc = np.concatenate([pc, rest.pop(0).astype(np.float32)], -1)
        if height is not None:
            pc = np.concatenate([pc, rest.pop(0).astype(np.float32)], -1)
        if multiview is not None:
            pc = np.concatenate([pc, rest.pop(0).astype(np.float32)], -1)
        point_instance = rest.pop(0)

        zeros = np.zeros((G, MAX_TOKENS), np.float32)
        inputs = {
            "point_clouds": pc,
            "text_ids": tok.input_ids[0],
            "text_mask": tok.attention_mask[0],
        }
        if butd:
            # prompts ride the grounding examples' detected-box stream; the
            # oracle is the kept scene objects' unjittered boxes
            def oracle():
                kept = [i for i in range(min(len(labels), MAX_NUM_OBJ))
                        if instance_label_in_class485(labels[i])]
                boxes = (np.stack([obj_box(i) for i in kept]) if kept
                         else np.zeros((0, 6), np.float32))
                return boxes, np.array([instance_label_to_class485(labels[i]) for i in kept],
                                       np.int32)

            inputs.update(detected_arrays(self, scan_id, aug, rng, oracle))
        targets = {
            "center_label": center_label,
            "size_gts": size_gts,
            "box_label_mask": box_label_mask,
            "positive_map": positive_map,
            "modify_positive_map": zeros,
            "pron_positive_map": zeros.copy(),
            "other_entity_map": zeros.copy(),
            "rel_positive_map": zeros.copy(),
            "point_instance_label": point_instance,
            "text_lengths": np.int32(tok.lengths[0]),
        }
        # prompts carry no distractors; only the grounding evaluator reads these
        hardness = {"is_view_dep": False, "is_hard": False, "is_unique": True}
        return {"inputs": inputs, "targets": targets, "hardness": hardness}

    def batch(self, indices, butd: bool = False) -> dict:
        return stack_examples([self.example(int(i), butd) for i in indices])


class MixedDataset:
    """Datasets mixed by multiplier (``--joint_det`` repeats the prompts 10 times)."""

    def __init__(self, parts: List, multipliers: Optional[List[int]] = None):
        self.parts = parts
        multipliers = multipliers or [1] * len(parts)
        self._index: List = []
        for part_idx, (part, mult) in enumerate(zip(parts, multipliers)):
            self._index += [(part_idx, i) for i in range(len(part))] * mult

    def __len__(self) -> int:
        return len(self._index)

    def example(self, idx: int, butd: bool = False) -> dict:
        part_idx, inner = self._index[idx % len(self._index)]
        return self.parts[part_idx].example(inner, butd)

    def batch(self, indices, butd: bool = False) -> dict:
        return stack_examples([self.example(int(i), butd) for i in indices])
