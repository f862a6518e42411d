"""Real-format data fabricated from a seed, for the port's tests and ``chip_smoke.py``.

A ScanNet-layout scan tree (mesh vertices, segments, aggregation with a
duplicate object), ScanRefer annotations, axis alignments, a byte-level BPE
vocabulary in ``roberta-base``'s format and HF-named ``roberta-base`` weights
drawn from a seeded ``RobertaEncoder`` (under the HF names that
``eda_tpu_torch/train/convert.py`` reads), GroupFree-format detections; and
``CheckedSteps``, which wraps the CLI's training step to check
every real-data batch and count each step's kernel launches.

Imports torch, numpy and ``eda_tpu_torch`` only: ``chip_smoke.py`` imports it
on the card, where JAX is absent.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import torch

FIXTURE_OBJECTS = ("chair", "table", "desk", "bed", "sofa", "cabinet", "door", "window",
                   "lamp", "trash can", "office chair", "bookshelf")
FIXTURE_COLORS = ("brown", "black", "white", "red", "wooden", "small")
FIXTURE_RELATIONS = ("next to", "on the left of", "near", "behind", "in front of", "under")
ANNOS_PER_SCENE = 3
# the RobertaEncoder's names -> HF roberta-base's (the names that
# eda_tpu_torch/train/convert.py:convert_hf_roberta reads)
PORT_TO_HF = {
    "embeddings.word_embeddings.weight": "embeddings.word_embeddings.weight",
    "embeddings.position_embeddings.weight": "embeddings.position_embeddings.weight",
    "embeddings.layer_norm.weight": "embeddings.LayerNorm.weight",
    "embeddings.layer_norm.bias": "embeddings.LayerNorm.bias",
}
PORT_TO_HF_LAYER = {
    "attention.query": "attention.self.query", "attention.key": "attention.self.key",
    "attention.value": "attention.self.value", "attention.out": "attention.output.dense",
    "attention_norm": "attention.output.LayerNorm", "intermediate": "intermediate.dense",
    "output": "output.dense", "output_norm": "output.LayerNorm",
}


def fabricate_scannet(scan_dir: Path, data_root: Path, scan_ids: dict, n_vertices: int,
                      seed: int = 0, annos_per_scene: int = ANNOS_PER_SCENE) -> dict:
    """ScanNet-layout scenes under ``scan_dir`` (mesh vertices, segments,
    aggregation with one duplicate object), their axis alignments and
    ScanRefer annotations under ``data_root``. ``scan_ids``: split -> ids;
    each scene holds 4-7 objects, blobs of vertices in a 6 x 6 x 2.5 m room,
    and ``annos_per_scene`` utterances name its objects in turn. Returns
    each scene's object labels, in object-id order."""
    import numpy as np

    from eda_tpu_torch.data.ply import write_ply_vertices

    rng = np.random.default_rng(seed)
    alignments, scene_labels = {}, {}
    (data_root / "ScanRefer").mkdir(parents=True, exist_ok=True)
    k = 0
    for split, ids in scan_ids.items():
        records = []
        for scan_id in ids:
            d = scan_dir / scan_id
            d.mkdir(parents=True)
            n_obj = 4 + k % 4
            labels = [FIXTURE_OBJECTS[(k + 5 * j) % len(FIXTURE_OBJECTS)] for j in range(n_obj)]
            scene_labels[scan_id] = labels
            xyz = rng.uniform([-3, -3, 0], [3, 3, 2.5], (n_vertices, 3))
            seg = np.zeros(n_vertices, np.int64)
            per = n_vertices // (2 * n_obj + 2)
            for j in range(n_obj):
                rows = slice((j + 1) * per, (j + 2) * per)
                center = rng.uniform([-2.4, -2.4, 0.3], [2.4, 2.4, 1.5])
                size = rng.uniform(0.3, 1.2, 3)
                xyz[rows] = center + rng.uniform(-0.5, 0.5, (per, 3)) * size
                seg[rows] = np.where(np.arange(per) < per // 2, 2 * j + 1, 2 * j + 2)
            rgb = rng.integers(0, 256, (n_vertices, 3)).astype(np.uint8)
            write_ply_vertices(str(d / f"{scan_id}_vh_clean_2.ply"), {
                "x": xyz[:, 0].astype(np.float32), "y": xyz[:, 1].astype(np.float32),
                "z": xyz[:, 2].astype(np.float32),
                "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
            (d / f"{scan_id}_vh_clean_2.0.010000.segs.json").write_text(
                json.dumps({"segIndices": seg.tolist()}))
            groups = [{"objectId": j, "label": labels[j], "segments": [2 * j + 1, 2 * j + 2]}
                      for j in range(n_obj)]
            groups.append({**groups[0], "objectId": n_obj})  # a duplicate, dropped on load
            (d / f"{scan_id}.aggregation.json").write_text(json.dumps({"segGroups": groups}))
            theta = rng.uniform(-0.3, 0.3)
            align = np.eye(4)
            align[:2, :2] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
            align[:3, 3] = rng.uniform(-1, 1, 3)
            alignments[scan_id] = align.ravel().tolist()
            for a in range(annos_per_scene):
                target, anchor = labels[a % n_obj], labels[(a + 1) % n_obj]
                text = (f"the {FIXTURE_COLORS[(k + a) % len(FIXTURE_COLORS)]} {target} is "
                        f"{FIXTURE_RELATIONS[(k + 2 * a) % len(FIXTURE_RELATIONS)]} the "
                        f"{anchor} . it's the one by the wall")
                records.append({"scene_id": scan_id, "object_id": str(a % n_obj),
                                "object_name": target.replace(" ", "_"), "ann_id": str(a),
                                "description": text, "token": text.split()})
            k += 1
        base = data_root / "ScanRefer" / f"ScanRefer_filtered_{split}"
        base.with_suffix(".txt").write_text("".join(f"{s}\n" for s in ids))
        base.with_suffix(".json").write_text(json.dumps(records))
    (data_root / "meta_data").mkdir(exist_ok=True)
    (data_root / "meta_data" / "scans_axis_alignment_matrices.json").write_text(
        json.dumps(alignments))
    return scene_labels


def fixture_corpus() -> list:
    """Texts whose words the fabricated BPE vocabulary merges into tokens: the
    fixture's utterances and every class name a detection prompt may hold."""
    from eda_tpu_torch.data.class_config import class485_names
    from eda_tpu_torch.data.detection_prompt import PROMPT_NAMES

    words = (FIXTURE_OBJECTS + FIXTURE_COLORS + FIXTURE_RELATIONS + tuple(PROMPT_NAMES)
             + tuple(class485_names()))
    return [" ".join(words) + " the is it's itis one by wall this an object . not mentioned"]


def write_bpe_vocab(out_dir: Path, corpus) -> None:
    """A byte-level ``vocab.json`` + ``merges.txt`` in roberta-base's format:
    the specials, the 256 byte characters, and left-to-right merges that build
    every pre-tokenized piece of ``corpus``."""
    from eda_tpu_torch.data.bpe import _bytes_to_unicode, pre_tokenizer

    byte_chars = _bytes_to_unicode()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in sorted(byte_chars.values()):
        vocab[ch] = len(vocab)
    merges = []
    for text in corpus:
        for piece in pre_tokenizer().findall(text):
            parts = [byte_chars[b] for b in piece.encode("utf-8")]
            while len(parts) > 1:
                merged = parts[0] + parts[1]
                if merged not in vocab:
                    merges.append(f"{parts[0]} {parts[1]}")
                    vocab[merged] = len(vocab)
                parts = [merged] + parts[2:]
    vocab["<mask>"] = len(vocab)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "vocab.json").write_text(json.dumps(vocab))
    (out_dir / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{m}\n" for m in merges))


def hf_roberta_state(encoder, token_type=None) -> dict:
    """A port ``RobertaEncoder``'s tensors under HF ``roberta-base`` names
    (``roberta.`` prefixes, ``position_ids``, a pooler). ``token_type``: the
    (1, hidden) token-type table, zeros by default; the warm start folds it
    into the position table, so with zeros that table loads bit for bit."""
    out = {}
    for name, value in encoder.state_dict().items():
        m = re.match(r"^layer\.(\d+)\.(.+)\.(weight|bias)$", name)
        hf = (f"encoder.layer.{m.group(1)}.{PORT_TO_HF_LAYER[m.group(2)]}.{m.group(3)}"
              if m else PORT_TO_HF[name])
        out["roberta." + hf] = value.detach().clone()
    hidden = out["roberta.embeddings.word_embeddings.weight"].shape[1]
    positions = out["roberta.embeddings.position_embeddings.weight"].shape[0]
    out["roberta.embeddings.token_type_embeddings.weight"] = (
        torch.zeros(1, hidden) if token_type is None else token_type)
    out["roberta.embeddings.position_ids"] = torch.arange(positions)[None]
    out["roberta.pooler.dense.weight"] = torch.zeros(hidden, hidden)
    out["roberta.pooler.dense.bias"] = torch.zeros(hidden)
    return out


def seeded_roberta(cfg, seed: int = 0):
    """The text encoder of ``cfg`` with every tensor drawn from normal(0, 0.02), from ``seed``."""
    from eda_tpu_torch.models.roberta import RobertaEncoder

    encoder = RobertaEncoder(cfg.text_vocab_size, cfg.text_hidden, cfg.text_layers,
                             cfg.text_heads, cfg.text_intermediate)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in encoder.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return encoder


def fabricate_real_data(tmp: Path, cfg, n_vertices: int, scenes: dict, seed: int = 0,
                        annos_per_scene: int = ANNOS_PER_SCENE):
    """The whole real-format tree under ``tmp``: ``scans/``, and ``data/``
    with annotations, axis alignments and ``roberta-base/`` (vocabulary and
    the seeded text encoder's weights). Returns (data root, scan dir, ids by
    split, the seeded encoder, each scene's object labels)."""
    from eda_tpu_torch.tools.pack_scans import split_scan_ids

    ids = {split: split_scan_ids(split)[:n] for split, n in scenes.items()}
    root, scan_dir = tmp / "data", tmp / "scans"
    labels = fabricate_scannet(scan_dir, root, ids, n_vertices, seed, annos_per_scene)
    write_bpe_vocab(root / "roberta-base", fixture_corpus())
    encoder = seeded_roberta(cfg, seed)
    torch.save(hf_roberta_state(encoder), root / "roberta-base" / "pytorch_model.bin")
    return root, scan_dir, ids, encoder, labels


def fabricate_detections(root: Path, ids: dict, labels: dict, rng) -> None:
    """GroupFree-format detections (``group_free_pred_bboxes_{split}/{scan}.npy``:
    5 corner boxes, raw class names from the scene's labels, 19 logits) for
    every scene of ``ids`` (split -> scan ids), drawn from ``rng``."""
    import numpy as np

    for split, split_ids in ids.items():
        det_dir = root / "group_free_pred_bboxes" / f"group_free_pred_bboxes_{split}"
        det_dir.mkdir(parents=True, exist_ok=True)
        for scan_id in split_ids:
            lo = rng.uniform(-2, 1, (5, 3))
            corners = np.concatenate([lo, lo + rng.uniform(0.2, 1.0, (5, 3))], 1)
            np.save(det_dir / f"{scan_id}.npy", {
                "box": corners.astype(np.float32),
                "class": [labels[scan_id][i % len(labels[scan_id])] for i in range(5)],
                "logits": rng.normal(size=(5, 19)).astype(np.float32)})


def launch_counts() -> dict:
    from eda_tpu_torch.ops.cuda import build

    return {s: k.launches for s, k in build.KERNELS.items()}


def check_real_batch(batch, text_len: int = 256):
    """A real-data training batch: ``text_len``-token texts (checked now), and
    a positive map with mass in every target row (returned as a 0-d bool
    tensor on the batch's device, so that checking it waits for nothing)."""
    ids, maps = batch["inputs"]["text_ids"], batch["targets"]["positive_map"]
    if ids.shape[1] != text_len:
        raise AssertionError(f"real data: texts of {ids.shape[1]} tokens, not {text_len}")
    targets = batch["targets"]["box_label_mask"] > 0
    return targets.any() & ((maps.sum(-1) > 0) | ~targets).all()


class CheckedSteps:
    """Wraps ``cli.make_train_step``: records each step's kernel launches, its
    loss and ``grad_norm`` and its batch's checks (``check_real_batch``,
    ``text_len`` tokens); ``before_first(state)`` runs before the first step.
    It adds no wait for the card of its own, so the run keeps the CLI's
    timing; ``finish()`` then checks what was recorded and returns the
    (loss, grad_norm) of each step."""

    def __init__(self, make_train_step, before_first=None, text_len: int = 256):
        self.make_train_step = make_train_step
        self.before_first = before_first
        self.text_len = text_len
        self.launches, self._recorded = [], []

    def __call__(self, crit, seed=0):
        step = self.make_train_step(crit, seed=seed)

        def checked(state, batch):
            maps_ok = check_real_batch(batch, self.text_len)
            if not self.launches and self.before_first is not None:
                self.before_first(state)
            before = launch_counts()
            metrics = step(state, batch)
            after = launch_counts()
            self.launches.append({s: after[s] - before[s] for s in after})
            self._recorded.append((metrics["loss"], metrics["grad_norm"], maps_ok))
            return metrics

        return checked

    def finish(self) -> list:
        out = []
        for i, (loss, norm, maps_ok) in enumerate(self._recorded):
            if not bool(maps_ok):
                raise AssertionError(f"real data: step {i}: a target row has an empty "
                                     f"positive map")
            loss, norm = float(loss), float(norm)
            if not (math.isfinite(loss) and math.isfinite(norm)):
                raise AssertionError(f"real data: step {i}: loss {loss}, grad_norm {norm}")
            out.append((loss, norm))
        return out
