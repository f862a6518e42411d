"""Annotation loaders: ScanRefer, SR3D, SR3D+ and NR3D.

The port's own copy of ``eda_tpu/data/annotations.py``. Each record is

    {scan_id, target_id, distractor_ids, utterance, target, anchors,
     anchor_ids, dataset, decoupled[, unique]}

Every loader normalizes the utterance (the literal typo tables below: the
ScanRefer fixes for every dataset, the punctuation and contraction fixes for
NR3D only) and runs the text decoupler once per record, keeping its span
groups under ``decoupled``. Wrong character offsets here would corrupt the
positive maps, so the tables are kept verbatim.
"""

from __future__ import annotations

import ast
import csv
import json
import os.path as osp
from collections import defaultdict
from typing import Dict, List

from eda_tpu_torch.data.decouple import decoupled_spans
from eda_tpu_torch.data.vocab import LABELS_TSV

MAX_DISTRACTORS = 32

SCANREFER_FIXES = (
    ("'m", "am"), ("'s", "is"), ("2-tiered", "2 - tiered"),
    ("4-drawers", "4 - drawers"), ("5-drawer", "5 - drawer"),
    ("8-hole", "8 - hole"), ("7-shaped", "7 - shaped"),
    ("2-door", "2 - door"), ("3-compartment", "3 - compartment"),
    ("computer/", "computer /"), ("3-tier", "3 - tier"),
    ("3-seater", "3 - seater"), ("4-seat", "4 - seat"),
    ("theses", "these"),
)

# NR3D only; order matters, each entry re-splits on whitespace.
NR3D_FIXES = (
    (".", " ."), (";", " ; "), ("-", " "), ('"', " "), ("?", " "),
    ("*", " "), (":", " "), ("$", " "), ("#", " "), ("/", " / "),
    ("you're", "you are"), ("isn't", "is not"), ("thats", "that is"),
    ("doesn't", "does not"), ("doesnt", "does not"), ("itis", "it is"),
    ("left-hand", "left - hand"), ("[", " [ "), ("]", " ] "),
    ("(", " ( "), (")", " ) "), ("wheel-chair", "wheel - chair"),
    (";s", "is"), ("tha=e", "the"), ("it’s", "it is"),
    ("’s", " is"), ("isnt", "is not"), ("Don't", "Do not"),
    ("arent", "are not"), ("cant", "can not"), ("you’re", "you are"),
    ("!", " !"), ("id the", " , the"), ("youre", "you are"), ("'", " "),
)


def normalize_utterance(utterance: str, dataset: str = "scanrefer") -> str:
    """Whitespace and comma normalization, then the typo tables."""
    caption = " ".join(utterance.replace(",", " , ").split())
    for old, new in SCANREFER_FIXES:
        caption = " ".join(caption.replace(old, new).split())
    if dataset == "nr3d":
        for old, new in NR3D_FIXES:
            caption = " ".join(caption.replace(old, new).split())
        caption = caption.strip("'") or caption
    return caption


def _decouple(annos: List[dict]) -> List[dict]:
    for anno in annos:
        utterance = normalize_utterance(anno["utterance"], anno.get("dataset", "scanrefer"))
        spans = decoupled_spans(utterance)
        if not spans["main"]:
            # no main object found: retry behind a generic prefix
            prefixed = "This is an object . " + utterance
            spans = decoupled_spans(prefixed)
            utterance = prefixed
        anno["utterance"] = utterance
        anno["decoupled"] = spans
    return annos


def load_scanrefer(data_path: str, split: str, wo_obj_name: str = None) -> List[dict]:
    """ScanRefer's JSON annotations of ``split`` (val for val and test).

    ``wo_obj_name``: the path of an annotation JSON without object names,
    which replaces the utterance source (an evaluation variant).
    """
    if split in ("val", "test"):
        split = "val"
    base = osp.join(data_path, "ScanRefer", f"ScanRefer_filtered_{split}")
    with open(base + ".txt") as f:
        scan_ids = {line.strip() for line in f}
    with open(base + ".json") as f:
        reader = json.load(f)
    if wo_obj_name:
        with open(wo_obj_name) as f:
            reader = json.load(f)
    annos = [
        {
            "scan_id": anno["scene_id"],
            "target_id": int(anno["object_id"]),
            "distractor_ids": [],
            "utterance": " ".join(anno["token"]),
            "target": " ".join(str(anno["object_name"]).split("_")),
            "anchors": [],
            "anchor_ids": [],
            "dataset": "scanrefer",
        }
        for anno in reader
        if anno["scene_id"] in scan_ids
    ]
    return _decouple(annos)


def _meta_scan_set(name: str, split: str):
    """The ReferIt3D split's scan ids (a Python list literal in
    ``meta/{name}_{split}_scans.txt``), or None where the file is absent."""
    path = osp.join(osp.dirname(LABELS_TSV), f"{name}_{split}_scans.txt")
    if not osp.exists(path):
        return None
    with open(path) as f:
        return set(ast.literal_eval(f.read()))


def _referit_rows(data_path: str, split: str, csv_name: str, list_name: str):
    """CSV rows of a split: one ``ReferIt3D/{csv}.csv`` for all splits,
    filtered by the meta scan list (val reads the test list), or else a
    pre-split ``refer_it_3d/{csv}_{split}.csv``."""
    ref_csv = osp.join(data_path, "ReferIt3D", f"{csv_name}.csv")
    if osp.exists(ref_csv):
        scans = _meta_scan_set(list_name, "test" if split in ("val", "test") else "train")
        with open(ref_csv, newline="") as f:
            for row in csv.DictReader(f):
                if scans is None or row["scan_id"] in scans:
                    yield row
        return
    with open(osp.join(data_path, "refer_it_3d", f"{csv_name}_{split}.csv"), newline="") as f:
        yield from csv.DictReader(f)


def load_sr3d(data_path: str, split: str, plus: bool = False) -> List[dict]:
    """SR3D (or SR3D+) CSV annotations of rows that mention the target class."""
    name = "sr3d+" if plus else "sr3d"
    annos = []
    for row in _referit_rows(data_path, split, name, "sr3d"):
        # the CSV holds True / False literals in assorted casings
        if str(row.get("mentions_target_class", "True")).lower() != "true":
            continue
        annos.append({
            "scan_id": row["scan_id"],
            "target_id": int(row["target_id"]),
            "distractor_ids": ast.literal_eval(row["distractor_ids"]),
            "utterance": row["utterance"],
            "target": row["instance_type"],
            "anchors": ast.literal_eval(row["anchors_types"]),
            "anchor_ids": ast.literal_eval(row["anchor_ids"]),
            "dataset": name,
        })
    return _decouple(annos)


def load_nr3d(data_path: str, split: str) -> List[dict]:
    """NR3D CSV annotations: val and test keep only ``correct_guess`` rows,
    train keeps every row. Distractors come later from the scans
    (``compute_scanrefer_flags``)."""
    annos = []
    for row in _referit_rows(data_path, split, "nr3d", "nr3d"):
        correct = str(row.get("correct_guess", "True")).lower() == "true"
        if split in ("val", "test") and not correct:
            continue
        annos.append({
            "scan_id": row["scan_id"],
            "target_id": int(row["target_id"]),
            "distractor_ids": [],
            "utterance": row["utterance"],
            "target": row["instance_type"],
            "anchors": [],
            "anchor_ids": [],
            "dataset": "nr3d",
        })
    return _decouple(annos)


def compute_scanrefer_flags(annos: List[dict], scans: Dict, label_to_class18) -> None:
    """Each dataset's distractors, and ScanRefer's unique flag, in place.

    * scanrefer: objects of the target's 18-way class (``label_to_class18``),
      at most 32, and ``unique`` where no other annotated target of the scene
      shares that class;
    * nr3d: objects whose raw instance label equals the record's target type;
    * sr3d / sr3d+: the CSV's distractors, left as they are.
    """
    scene2obj = defaultdict(list)
    used = defaultdict(set)
    for anno in annos:
        scan = scans.get(anno["scan_id"])
        if scan is None:
            continue
        tgt_idx = scan.object_by_id(anno["target_id"])
        if tgt_idx is None:
            continue
        dataset = anno.get("dataset", "scanrefer")
        if dataset == "nr3d":
            anno["distractor_ids"] = [
                i for i, o in enumerate(scan.three_d_objects)
                if o["instance_label"] == anno["target"] and i != tgt_idx
            ]
            continue
        if dataset != "scanrefer":
            continue
        labels = [label_to_class18(o["instance_label"]) for o in scan.three_d_objects]
        anno["distractor_ids"] = [
            i for i in range(len(labels)) if labels[i] == labels[tgt_idx] and i != tgt_idx
        ][:MAX_DISTRACTORS]
        if anno["target_id"] not in used[anno["scan_id"]]:
            used[anno["scan_id"]].add(anno["target_id"])
            scene2obj[anno["scan_id"]].append(labels[tgt_idx])
    for anno in annos:
        if anno.get("dataset", "scanrefer") != "scanrefer":
            continue
        scan = scans.get(anno["scan_id"])
        if scan is None:
            continue
        labels = [label_to_class18(o["instance_label"]) for o in scan.three_d_objects]
        tgt_idx = scan.object_by_id(anno["target_id"])
        if tgt_idx is None:
            continue
        anno["unique"] = sum(c == labels[tgt_idx] for c in scene2obj[anno["scan_id"]]) == 1


def load_annotations(
    dataset: str, data_path: str, split: str, debug: bool = False, wo_obj_name: str = None,
) -> List[dict]:
    """The records of ``dataset``; ``debug`` keeps the first 128."""
    if dataset == "scanrefer":
        annos = load_scanrefer(data_path, split, wo_obj_name=wo_obj_name)
    elif dataset == "sr3d":
        annos = load_sr3d(data_path, split)
    elif dataset == "sr3d+":
        annos = load_sr3d(data_path, split, plus=True)
    elif dataset == "nr3d":
        annos = load_nr3d(data_path, split)
    else:
        raise ValueError(f"unknown dataset {dataset}")
    if debug:
        annos = annos[:128]
    return annos
