"""Shared helpers of the ``test_torch_*`` parity tests (JAX reference vs PyTorch port).

The JAX side is compiled with ``xla_allow_excess_precision`` off: by default
XLA on the CPU keeps bf16 intermediates in f32 where a convert back to f32
follows (e.g. ``prod + bias`` in the prep kernel), so it skips roundings the
program asks for and that the port performs. With the option off, the JAX
reference rounds where its source says it does.
"""

from __future__ import annotations

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def compiled(fn, *args, **static):
    """Run ``fn(*args, **static)`` as one XLA program without excess precision."""
    jitted = jax.jit(lambda *a: fn(*a, **static))
    return jitted.lower(*args).compile(compiler_options=NO_EXCESS_PRECISION)(*args)


def bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 values to bf16 (nearest even) and back, in numpy."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def perturb(variables, seed: int = 0):
    """Random LayerNorm/BatchNorm parameters and statistics and random biases,
    so that no parameter sits at its identity init."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "scale" or re.fullmatch(r"ln_scale\d+", name):
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean") or re.fullmatch(r"b\d+|ln_bias\d+", name):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def tpu_path(monkeypatch, training: bool = False):
    """Put the JAX model on its TPU path, every Pallas kernel interpreted on the CPU.

    ``jax.default_backend`` reads "tpu" (so FusedSetAbstraction picks the
    Pallas pair kernel, ``impl="pallas_train"`` when it trains, and pointops
    the Pallas FPS). With ``training`` the pair pool's backward kernel is
    interpreted too and dropout is the identity (``flax.linen.Dropout``
    returns its input). Nothing in ``eda_tpu`` is edited.
    """
    from flax import linen as nn

    from eda_tpu.ops.pallas import fps as pallas_fps
    from eda_tpu.ops.pallas import sa_kernel, sa_prep

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(sa_prep, "_INTERPRET", True)
    names = [(sa_kernel, "sa_pair_pool_pallas"), (pallas_fps, "furthest_point_sample_pallas")]
    if training:
        names.append((sa_kernel, "sa_pair_pool_bwd_pallas"))
        monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    for module, name in names:
        orig = getattr(module, name)

        def patched(*a, _orig=orig, **k):
            k["interpret"] = True
            return getattr(_orig, "__wrapped__", _orig)(*a, **k)

        monkeypatch.setattr(module, name, patched)


@pytest.fixture
def jax_tpu_serving_path(monkeypatch):
    """The JAX model on its TPU serving path, interpreted on the CPU."""
    tpu_path(monkeypatch)


@pytest.fixture
def jax_tpu_training_path(monkeypatch):
    """The JAX model on its TPU training path (``impl="pallas_train"``),
    interpreted on the CPU, with dropout off."""
    tpu_path(monkeypatch, training=True)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's PyTorch work: the suite runs several
    workers on one machine, and tiny models gain nothing from more threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def real_data_tree(tmp, n_vertices: int = 3000, scenes=(("train", 3), ("val", 2)),
                   text_vocab_size: int = 4096, multiview: bool = False):
    """A real-format data root under ``tmp``, packed by the JAX package.

    ``real_data_fixtures.fabricate_real_data`` (ScanNet scenes, ScanRefer annotations,
    a byte-level BPE vocabulary and the tiny text encoder's HF weights at
    ``text_vocab_size`` tokens), then, from the scenes' labels: SR3D, SR3D+
    and NR3D CSVs in the pre-split ``refer_it_3d/`` layout (an NR3D val row
    with ``correct_guess`` False, an SR3D row that does not mention its
    target's class), GroupFree detections for the train split, and with
    ``multiview`` a 128-d feature store for every scene. Returns (data root,
    scan dir, ids by split, the seeded encoder).
    """
    import csv
    from pathlib import Path

    import real_data_fixtures
    from eda_tpu.data.scannet import pack_scans
    from eda_tpu_torch.config import ModelConfig

    tmp = Path(tmp)
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), text_vocab_size=text_vocab_size)
    root, scan_dir, ids, encoder, labels = real_data_fixtures.fabricate_real_data(
        tmp, cfg, n_vertices=n_vertices, scenes=dict(scenes))
    rng = np.random.default_rng(1)
    (root / "refer_it_3d").mkdir()
    for split, split_ids in ids.items():
        sr3d, nr3d = [], []
        for k, scan_id in enumerate(split_ids):
            names = labels[scan_id]
            for t in range(3):
                anchor = (t + 1) % len(names)
                rel = ("closest to", "on the left of", "above")[(k + t) % 3]
                sr3d.append({
                    "scan_id": scan_id, "target_id": t,
                    "distractor_ids": str([i for i in range(len(names))
                                           if names[i] == names[t] and i != t]),
                    "utterance": f"the {names[t]} that is {rel} the {names[anchor]}",
                    "instance_type": names[t], "anchors_types": str([names[anchor]]),
                    "anchor_ids": str([anchor]),
                    "mentions_target_class": "False" if (k, t) == (0, 2) else "True"})
                nr3d.append({
                    "scan_id": scan_id, "target_id": t,
                    "utterance": f"Facing the {names[anchor]}, it's the {names[t]} on the right.",
                    "instance_type": names[t],
                    "correct_guess": "False" if (k, t) == (0, 1) else "True"})
        for name, rows in (("sr3d", sr3d), ("sr3d+", sr3d), ("nr3d", nr3d)):
            with open(root / "refer_it_3d" / f"{name}_{split}.csv", "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(rows[0]))
                writer.writeheader()
                writer.writerows(rows)
    det_dir = root / "group_free_pred_bboxes" / "group_free_pred_bboxes_train"
    det_dir.mkdir(parents=True)
    for scan_id in ids["train"]:
        lo = rng.uniform(-2, 1, (5, 3))
        corners = np.concatenate([lo, lo + rng.uniform(0.2, 1.0, (5, 3))], 1)
        np.save(det_dir / f"{scan_id}.npy", {
            "box": corners.astype(np.float32),
            "class": [labels[scan_id][i % len(labels[scan_id])] for i in range(5)],
            "logits": rng.normal(size=(5, 19)).astype(np.float32)})
    if multiview:
        import h5py

        (root / "scanrefer_2d_feats").mkdir()
        with h5py.File(root / "scanrefer_2d_feats" / "enet_feats_maxpool.hdf5", "w") as f:
            for split_ids in ids.values():
                for scan_id in split_ids:
                    f[scan_id] = rng.normal(size=(50000, 128)).astype(np.float32)
    alignments = json.loads((root / "meta_data" / "scans_axis_alignment_matrices.json")
                            .read_text())
    for split, split_ids in ids.items():
        pack_scans(split_ids, str(scan_dir), str(root / f"{split}_v3scans.pkl"), alignments,
                   processes=1)
    return root, scan_dir, ids, encoder


def assert_same_arrays(got: dict, want: dict, where: str):
    assert list(got) == list(want), where
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where} {key}"
        assert g.tobytes() == w.tobytes(), f"{where} {key}"


def assert_same_example(got: dict, want: dict, where: str):
    assert list(got) == list(want)
    for group in want:
        if group == "hardness" and not np.ndim(want[group]["is_hard"]):
            assert got[group] == want[group] and all(
                type(got[group][k]) is type(want[group][k]) for k in want[group]), where
        else:
            assert_same_arrays(got[group], want[group], f"{where} {group}")
