"""Synthetic grounding scenes without ScanNet.

Rooms of boxy objects with template utterances ("the red chair next to the
table ."). ``batch`` gives what the model consumes when it serves
(``point_clouds``, ``text_ids``, ``text_mask``); ``example`` and
``train_batch`` add the criterion's targets, built by the text decoupler and
the positive maps (``butd=False``). The arrays are byte-for-byte those of the
JAX package's synthetic generator for the same config and index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from eda_tpu_torch.data.decouple import decoupled_spans
from eda_tpu_torch.data.positive_maps import MAX_TOKENS, build_positive_maps, not_mentioned_suffix
from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.data.tokenizer import SimpleTokenizer

_CLASSES = [
    "chair", "table", "desk", "sofa", "bed", "cabinet", "shelf", "lamp",
    "door", "window", "sink", "toilet", "refrigerator", "microwave",
]
_COLORS = ["red", "blue", "green", "brown", "black", "white", "grey", "yellow"]
_SIZES = ["small", "large", "tall", "short", "wide", "narrow"]
_RELATIONS = ["next to", "behind", "in front of", "to the left of",
              "to the right of", "above", "near"]


@dataclasses.dataclass
class SyntheticConfig:
    num_points: int = 50000
    max_objects: int = 132
    num_objects: int = 8
    text_len: int = 64
    room_extent: float = 5.0
    seed: int = 0


class SyntheticScenes:
    """Deterministic synthetic scene generator."""

    def __init__(self, cfg: SyntheticConfig, vocab_size: int = 50265):
        self.cfg = cfg
        self.tokenizer = SimpleTokenizer(vocab_size)

    def scene(self, idx: int) -> Dict[str, np.ndarray]:
        """One Morton-sorted scene: cloud, instance ids, boxes, classes, utterance, target."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 100003 + idx)
        n_obj = cfg.num_objects
        classes = rng.integers(0, len(_CLASSES), size=n_obj)
        colors = rng.integers(0, len(_COLORS), size=n_obj)
        centers = rng.uniform(-cfg.room_extent / 2, cfg.room_extent / 2, (n_obj, 3))
        centers[:, 2] = rng.uniform(0.2, 1.2, n_obj)
        sizes = rng.uniform(0.3, 1.2, (n_obj, 3))

        # points: uniform inside each box + floor clutter
        pts_per_obj = (cfg.num_points * 3 // 4) // n_obj
        pts, inst = [], []
        for i in range(n_obj):
            pts.append(centers[i] + (rng.uniform(-0.5, 0.5, (pts_per_obj, 3)) * sizes[i]))
            inst.append(np.full(pts_per_obj, i, np.int64))
        n_floor = cfg.num_points - pts_per_obj * n_obj
        floor = np.stack(
            [
                rng.uniform(-cfg.room_extent / 2, cfg.room_extent / 2, n_floor),
                rng.uniform(-cfg.room_extent / 2, cfg.room_extent / 2, n_floor),
                rng.uniform(0.0, 0.05, n_floor),
            ],
            -1,
        )
        pts.append(floor)
        inst.append(np.full(n_floor, -1, np.int64))
        xyz = np.concatenate(pts).astype(np.float32)
        instance = np.concatenate(inst)
        perm = rng.permutation(cfg.num_points)
        xyz, instance = morton_sort(xyz[perm], instance[perm])

        # colours as per-point features, coded by object colour id
        rgb = np.zeros((cfg.num_points, 3), np.float32)
        fg = instance >= 0
        rgb[fg] = (colors[instance[fg]][:, None] + 1) / len(_COLORS) - 0.5

        # utterance: main object + relation to a (distinct-class) anchor
        target = int(rng.integers(0, n_obj))
        anchors = [i for i in range(n_obj) if classes[i] != classes[target]]
        anchor = int(rng.choice(anchors)) if anchors else (target + 1) % n_obj
        rel = _RELATIONS[rng.integers(0, len(_RELATIONS))]
        size_word = _SIZES[rng.integers(0, len(_SIZES))]
        utterance = (
            f"the {size_word} {_COLORS[colors[target]]} {_CLASSES[classes[target]]} "
            f"{rel} the {_CLASSES[classes[anchor]]} ."
        )
        return {
            "point_clouds": np.concatenate([xyz, rgb], -1),
            "instance": instance,
            "boxes": np.concatenate([centers, sizes], -1).astype(np.float32),
            "classes": classes,
            "target": target,
            "anchor": anchor,
            "utterance": utterance,
        }

    def example(self, idx: int) -> Dict[str, dict]:
        """One training example: model inputs, criterion targets and the caption."""
        scene = self.scene(idx)
        caption = not_mentioned_suffix(scene["utterance"])
        tokens = self.tokenizer.encode_batch([caption], max_len=self.cfg.text_len)
        maps = build_positive_maps(tokens, 0, decoupled_spans(caption))
        G = self.cfg.max_objects
        target = scene["target"]
        center_label = np.zeros((G, 3), np.float32)
        size_gts = np.zeros((G, 3), np.float32)
        box_label_mask = np.zeros((G,), np.float32)
        center_label[0] = scene["boxes"][target, :3]
        size_gts[0] = scene["boxes"][target, 3:]
        box_label_mask[0] = 1.0

        def tile(m):
            out = np.zeros((G, MAX_TOKENS), np.float32)
            out[0] = m
            return out

        inputs = {
            "point_clouds": scene["point_clouds"],
            "text_ids": tokens.input_ids[0],
            "text_mask": tokens.attention_mask[0],
        }
        targets = {
            "center_label": center_label,
            "size_gts": size_gts,
            "box_label_mask": box_label_mask,
            "positive_map": tile(maps["main"]),
            "modify_positive_map": tile(maps["modifiers"]),
            "pron_positive_map": tile(maps["pronouns"]),
            "other_entity_map": tile(maps["others"]),
            "rel_positive_map": tile(maps["relations"]),
            # the target object's points -> GT slot 0, every other point -1
            "point_instance_label": np.where(scene["instance"] == target, 0, -1).astype(np.int32),
            "text_lengths": np.int32(tokens.lengths[0]),
        }
        return {"inputs": inputs, "targets": targets, "utterance": caption}

    def batch(self, indices) -> Dict[str, np.ndarray]:
        """Stacked model inputs of the scenes ``indices``."""
        return self.train_batch(indices)["inputs"]

    def train_batch(self, indices) -> Dict[str, Dict[str, np.ndarray]]:
        """Stacked ``{"inputs": ..., "targets": ...}`` of the scenes ``indices``."""
        examples = [self.example(int(i)) for i in indices]
        return {key: {k: np.stack([e[key][k] for e in examples]) for k in examples[0][key]}
                for key in ("inputs", "targets")}
