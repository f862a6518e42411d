"""The port's annotation loaders against the JAX package's.

The typo tables and ``normalize_utterance``; the ScanRefer, SR3D, SR3D+ and
NR3D loaders on fabricated JSON and CSV files, in the pre-split
``refer_it_3d/`` layout and in the ``ReferIt3D/`` layout filtered by the meta
scan lists (NR3D's val keeps only ``correct_guess`` rows, SR3D drops rows that
do not mention their target's class); and the distractor and uniqueness
flags: every record equal to JAX's.
"""

import csv

import numpy as np
import pytest

from eda_tpu.data import annotations as jax_annotations
from eda_tpu.data.class_config import instance_label_to_scanrefer18 as jax_label18
from eda_tpu.data.scannet import load_packed_scans as jax_load
from eda_tpu_torch.data import annotations
from eda_tpu_torch.data.class_config import instance_label_to_scanrefer18
from eda_tpu_torch.data.scannet import load_packed_scans
from torch_parity import real_data_tree

UTTERANCES = [
    "the 2-tiered shelf", "it's a 3-seater couch", "theses chairs", "a computer/monitor",
    "a chair, a desk", "the pillow; it's red", "thats the one", "you're facing it",
    "the left-hand side", "isnt it? yes!", "a (big) box", "'quoted'", "Don't go; it’s there",
    "you’re right", "the wheel-chair", "tha=e door", "id the lamp", "#1 $5 * a: b [c] \"d\"",
    "   spaced    out  ", "",
]


@pytest.mark.parametrize("dataset", ["scanrefer", "sr3d", "nr3d"])
def test_normalize_utterance_equals_jax(dataset):
    assert annotations.SCANREFER_FIXES == jax_annotations.SCANREFER_FIXES
    assert annotations.NR3D_FIXES == jax_annotations.NR3D_FIXES
    for text in UTTERANCES:
        assert (annotations.normalize_utterance(text, dataset)
                == jax_annotations.normalize_utterance(text, dataset)), text


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return real_data_tree(tmp_path_factory.mktemp("annos"))


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("dataset", ["scanrefer", "sr3d", "sr3d+", "nr3d"])
def test_loaders_equal_jax(tree, dataset, split):
    root = str(tree[0])
    for debug in (False, True):
        got = annotations.load_annotations(dataset, root, split if split != "test" else "val",
                                           debug=debug)
        want = jax_annotations.load_annotations(dataset, root,
                                                split if split != "test" else "val", debug=debug)
        assert got == want and len(got) > 0
    if dataset == "nr3d" and split == "val":
        # the fixture's one correct_guess False row is dropped from val only
        train_rows = jax_annotations.load_annotations(dataset, root, "train")
        assert len(got) == len(train_rows) * 2 // 3 - 1
    if dataset.startswith("sr3d") and split == "train":
        assert len(got) == 3 * len(tree[2]["train"]) - 1  # one row mentions no target class


def test_referit_layout_filtered_by_meta_lists(tmp_path):
    """One ``ReferIt3D/{name}.csv`` for all splits, each split filtered by the
    meta scan lists (val reads the test list); the loaders read it as JAX's do."""
    import ast

    meta = annotations.osp.dirname(annotations.LABELS_TSV)
    train_ids = sorted(ast.literal_eval(open(f"{meta}/sr3d_train_scans.txt").read()))[:2]
    test_ids = sorted(ast.literal_eval(open(f"{meta}/sr3d_test_scans.txt").read()))[:2]
    nr_train = sorted(ast.literal_eval(open(f"{meta}/nr3d_train_scans.txt").read()))[:2]
    nr_test = sorted(ast.literal_eval(open(f"{meta}/nr3d_test_scans.txt").read()))[:2]
    (tmp_path / "ReferIt3D").mkdir()
    sr_rows = [{"scan_id": s, "target_id": i, "distractor_ids": "[3, 4]",
                "utterance": "the chair that is farthest from the door", "instance_type": "chair",
                "anchors_types": "['door']", "anchor_ids": "[2]",
                "mentions_target_class": ("TRUE", "false", "True", "True")[i]}
               for i, s in enumerate(train_ids + test_ids + ["scene9999_00"])
               if i < 4]
    nr_rows = [{"scan_id": s, "target_id": i, "utterance": "Facing the bed, pick the left lamp.",
                "instance_type": "lamp", "correct_guess": ("True", "False")[i % 2]}
               for i, s in enumerate(nr_train + nr_test)]
    for name, rows in (("sr3d", sr_rows), ("sr3d+", sr_rows), ("nr3d", nr_rows)):
        with open(tmp_path / "ReferIt3D" / f"{name}.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    for dataset in ("sr3d", "sr3d+", "nr3d"):
        for split in ("train", "val"):
            got = annotations.load_annotations(dataset, str(tmp_path), split)
            want = jax_annotations.load_annotations(dataset, str(tmp_path), split)
            assert got == want, (dataset, split)
    assert [a["scan_id"] for a in annotations.load_sr3d(str(tmp_path), "train")] == [train_ids[0]]
    assert len(annotations.load_nr3d(str(tmp_path), "val")) == 1
    assert len(annotations.load_nr3d(str(tmp_path), "train")) == 2


def test_wo_obj_name_replaces_the_source(tree, tmp_path):
    import json

    path = tmp_path / "wo.json"
    records = json.loads((tree[0] / "ScanRefer" / "ScanRefer_filtered_val.json").read_text())
    for r in records:
        r["token"] = ["it", "is", "over", "there"]
    path.write_text(json.dumps(records))
    got = annotations.load_scanrefer(str(tree[0]), "val", wo_obj_name=str(path))
    assert got == jax_annotations.load_scanrefer(str(tree[0]), "val", wo_obj_name=str(path))
    assert got[0]["utterance"].startswith("This is an object . ")  # no main object: prefixed


@pytest.mark.parametrize("dataset", ["scanrefer", "sr3d", "nr3d"])
def test_distractor_and_unique_flags_equal_jax(tree, dataset):
    root = tree[0]
    got = annotations.load_annotations(dataset, str(root), "train")
    want = jax_annotations.load_annotations(dataset, str(root), "train")
    annotations.compute_scanrefer_flags(got, load_packed_scans(str(root / "train_v3scans.pkl")),
                                        instance_label_to_scanrefer18)
    jax_annotations.compute_scanrefer_flags(want, jax_load(str(root / "train_v3scans.pkl")),
                                            jax_label18)
    assert got == want
    if dataset == "scanrefer":
        assert {a["unique"] for a in got} == {True, False}
        assert any(a["distractor_ids"] for a in got)
    assert np.mean([len(a["distractor_ids"]) for a in got]) <= annotations.MAX_DISTRACTORS
