"""Synthetic grounding scenes: the serving inputs without ScanNet.

Rooms of boxy objects with template utterances ("the red chair next to the
table ."). The port needs only what the model consumes when it serves:
``point_clouds``, ``text_ids`` and ``text_mask``. The arrays are byte-for-byte
those of the JAX package's synthetic generator for the same config and index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.data.tokenizer import SimpleTokenizer, not_mentioned_suffix

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
        """One Morton-sorted scene: (N, 6) xyz+rgb cloud and its utterance."""
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
        return {"point_clouds": np.concatenate([xyz, rgb], -1), "utterance": utterance}

    def inputs(self, idx: int) -> Dict[str, np.ndarray]:
        """Model inputs of one scene."""
        scene = self.scene(idx)
        ids, mask = self.tokenizer.encode_batch(
            [not_mentioned_suffix(scene["utterance"])], max_len=self.cfg.text_len
        )
        return {
            "point_clouds": scene["point_clouds"],
            "text_ids": ids[0],
            "text_mask": mask[0],
        }

    def batch(self, indices) -> Dict[str, np.ndarray]:
        """Stacked model inputs of the scenes ``indices``."""
        examples = [self.inputs(int(i)) for i in indices]
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
