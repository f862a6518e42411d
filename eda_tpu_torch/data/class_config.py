"""ScanNet class vocabularies: the 18-class detection set and the 485-class object set.

The port's own copy of ``eda_tpu/data/class_config.py``. The 18 classes are
the VoteNet / ScanNet detection benchmark's, with their NYU40 ids. The
485-class vocabulary (the detected-box and class-embedding space) is a curated
subset of the label TSV's categories, recorded as data in
``meta/class485_vocab.tsv`` (rank, TSV id, display name).
"""

from __future__ import annotations

import csv
import functools
from typing import Dict, List

from eda_tpu_torch.data.scannet import read_label_mapping
from eda_tpu_torch.data.vocab import LABELS_TSV

CLASSES_18: List[str] = [
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "showercurtrain", "toilet", "sink", "bathtub", "garbagebin",
]
NYU40_IDS_18 = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]


class DatasetConfig18:
    """18-way detection vocabulary with NYU40 bridging."""

    num_class = 18

    def __init__(self):
        self.type2class: Dict[str, int] = {c: i for i, c in enumerate(CLASSES_18)}
        self.class2type = {i: c for c, i in self.type2class.items()}
        self.nyu40ids = list(NYU40_IDS_18)
        self.nyu40id2class = {nid: i for i, nid in enumerate(self.nyu40ids)}


@functools.lru_cache(maxsize=1)
def dc18() -> DatasetConfig18:
    return DatasetConfig18()


@functools.lru_cache(maxsize=1)
def raw_to_nyu40() -> Dict[str, int]:
    """Raw instance label -> NYU40 id."""
    return read_label_mapping(LABELS_TSV, "raw_category", "nyu40id")


@functools.lru_cache(maxsize=1)
def raw_to_nyu40class() -> Dict[str, str]:
    return read_label_mapping(LABELS_TSV, "raw_category", "nyu40class")


@functools.lru_cache(maxsize=1)
def raw_to_tsv_id() -> Dict[str, int]:
    """Raw instance label -> the TSV's ``id`` column."""
    return {k: int(v) for k, v in read_label_mapping(LABELS_TSV, "raw_category", "id").items()}


CLASS485_TSV = LABELS_TSV.replace("scannetv2-labels.combined.tsv", "class485_vocab.tsv")


class DatasetConfig485:
    """485-way object vocabulary with TSV-id bridging."""

    num_class = 485

    def __init__(self):
        ranks, names = [], []
        with open(CLASS485_TSV, newline="") as f:
            for row in csv.DictReader(f, delimiter="\t"):
                ranks.append(int(row["tsv_id"]))
                names.append(row["name"])
        self.type2class: Dict[str, int] = {n: i for i, n in enumerate(names)}
        self.class2type = {i: n for i, n in enumerate(names)}
        self.nyu40ids = ranks  # TSV ids, under the reference's field name
        self.nyu40id2class = {tid: i for i, tid in enumerate(ranks)}


@functools.lru_cache(maxsize=1)
def dc485() -> DatasetConfig485:
    return DatasetConfig485()


@functools.lru_cache(maxsize=1)
def class485_names() -> List[str]:
    """The 485 display names in class-rank order (embedding-table rows)."""
    cfg = dc485()
    return [cfg.class2type[i] for i in range(cfg.num_class)]


def instance_label_in_class485(label: str) -> bool:
    """Whether a scene object of this raw label is kept (its TSV id is in the vocabulary)."""
    return raw_to_tsv_id().get(label) in dc485().nyu40id2class


def instance_label_to_class485(label: str, default: int = 0) -> int:
    """Raw instance label -> 485-way class rank, ``default`` outside the vocabulary."""
    return dc485().nyu40id2class.get(raw_to_tsv_id().get(label), default)


def instance_label_to_class18(label: str) -> int:
    """Raw instance label -> 18-way class id by NYU40 id (17 = other)."""
    nyu = raw_to_nyu40().get(label)
    return dc18().nyu40id2class.get(nyu, 17)


# The 18 classes' display names, which differ from the TSV's nyu40class
# strings ('couch' vs 'sofa', 'refrigerator' vs 'refridgerator', ...).
TYPE2CLASS_18_NAMES: List[str] = [
    "cabinet", "bed", "chair", "couch", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "shower curtain", "toilet", "sink", "bathtub", "other furniture",
]


@functools.lru_cache(maxsize=1)
def _type2class18_by_name() -> Dict[str, int]:
    return {n: i for i, n in enumerate(TYPE2CLASS_18_NAMES)}


def instance_label_to_scanrefer18(label: str) -> int:
    """The ScanRefer distractor and uniqueness class: the display names keyed
    by the TSV's nyu40class name, so 'sofa', 'refridgerator' and
    'otherfurniture' objects land on class 17, unlike
    ``instance_label_to_class18``."""
    name = raw_to_nyu40class().get(label)
    return _type2class18_by_name().get(name, 17)
