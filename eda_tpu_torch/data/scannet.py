"""ScanNet scene store: scans, labels, packing.

The port's own copy of ``eda_tpu/data/scannet.py``:

* a ``Scan`` reads the ``*_vh_clean_2.ply`` mesh vertices, aligns them with
  the scan's axis-alignment matrix, downsamples to 50 000 points with the fixed
  seed 1184, and builds each object's point indices from the segments and
  aggregation JSONs, dropping duplicate objects;
* ``pack_scans`` pickles a split into ``{split}_v3scans.pkl`` with a process
  pool, and ``load_packed_scans`` reads it back.

A store packed by the JAX package pickles ``eda_tpu.data.scannet.Scan``
objects. ``load_packed_scans`` maps exactly that class to this module's
``Scan`` (the two carry the same attributes) and refuses every other global
outside its allow list, so loading a store imports nothing of ``eda_tpu`` and
runs no code a pickle names.
"""

from __future__ import annotations

import csv
import json
import multiprocessing as mp
import os
import os.path as osp
import pickle
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from eda_tpu_torch.data.ply import read_ply_vertices

DOWNSAMPLE_SEED = 1184
KEEP_POINTS = 50000


def object_box_from_points(xyz: np.ndarray, point_idx) -> np.ndarray:
    """Tight axis-aligned cxcyczwhd box over an object's points (also of an
    augmented cloud: boxes are always recomputed from the points)."""
    pts = xyz[point_idx]
    mx, mn = pts.max(0), pts.min(0)
    return np.concatenate([(mx + mn) / 2.0, mx - mn]).astype(np.float32)


def read_label_mapping(
    tsv_path: str, label_from: str = "raw_category", label_to: str = "id"
) -> Dict[str, int]:
    """``label_from`` -> ``label_to`` column of the ScanNet label TSV (ints where numeric)."""
    mapping: Dict[str, int] = {}
    with open(tsv_path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            value = row[label_to]
            mapping[row[label_from]] = int(value) if value.isdigit() else value
    return mapping


class Scan:
    """One ScanNet scene: 50 000 downsampled points and its object instances.

    Attributes:
        pc: (50000, 3) axis-aligned float32 coordinates.
        color: (50000, 3) float32 in [0, 1).
        three_d_objects: list of {object_id, points (indices into pc),
            instance_label}.
    """

    def __init__(
        self,
        scan_id: str,
        top_scan_dir: str,
        load_objects: bool = True,
        axis_alignment: Optional[np.ndarray] = None,
    ):
        self.scan_id = scan_id
        self.top_scan_dir = top_scan_dir
        self.axis_alignment = axis_alignment
        self.choices: Optional[np.ndarray] = None
        self.pc, self.color = self._load_point_cloud()
        self.three_d_objects: List[dict] = []
        if load_objects:
            self._load_objects()

    def _path(self, suffix: str) -> str:
        return osp.join(self.top_scan_dir, self.scan_id, self.scan_id + suffix)

    def _load_point_cloud(self, keep_points: int = KEEP_POINTS):
        data = read_ply_vertices(self._path("_vh_clean_2.ply"))
        pc = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float64)
        pc = self.align_to_axes(pc)
        color = (np.stack([data["red"], data["green"], data["blue"]], 1) / 256.0).astype(np.float32)

        # a fixed-seed downsample, so that packing is reproducible
        rs = np.random.RandomState(DOWNSAMPLE_SEED)
        choices = rs.choice(pc.shape[0], keep_points, replace=len(pc) < keep_points)
        self.choices = choices
        self._new_pts = np.zeros(len(pc), int)
        self._new_pts[choices] = np.arange(len(choices))
        return pc[choices].astype(np.float32), color[choices]

    def align_to_axes(self, pc: np.ndarray) -> np.ndarray:
        """Apply the scan's 4x4 axis-alignment matrix (row-major, 16 floats)."""
        if self.axis_alignment is None:
            return pc
        mat = np.asarray(self.axis_alignment, np.float64).reshape(4, 4)
        homo = np.concatenate([pc, np.ones((len(pc), 1))], 1)
        return (homo @ mat.T)[:, :3]

    def _load_objects(self):
        with open(self._path("_vh_clean_2.0.010000.segs.json")) as f:
            segment_indices = json.load(f)["segIndices"]
        segments: Dict[int, List[int]] = {}
        for i, s in enumerate(segment_indices):
            segments.setdefault(s, []).append(i)

        with open(self._path(".aggregation.json")) as f:
            aggregation = json.load(f)

        objects = []
        for info in aggregation["segGroups"]:
            points: List[int] = []
            for s in info["segments"]:
                points.extend(segments.get(s, []))
            points = np.array(sorted(set(points)))
            if self.choices is not None and len(points):
                points = self._new_pts[points[np.isin(points, self.choices)]]
            objects.append({
                "object_id": int(info["objectId"]),
                "points": np.asarray(points),
                "instance_label": str(info["label"]),
            })
        # an object with exactly the points of an earlier one is a duplicate
        kept: List[dict] = []
        for o in objects:
            dup = any(
                len(k["points"]) == len(o["points"]) and (k["points"] == o["points"]).all()
                for k in kept
            )
            if not dup:
                kept.append(o)
        self.three_d_objects = kept

    def get_object_bbox(self, obj_idx: int) -> np.ndarray:
        """Axis-aligned cxcyczwhd box of an object's points."""
        return object_box_from_points(self.pc, self.three_d_objects[obj_idx]["points"])

    def object_by_id(self, object_id: int) -> Optional[int]:
        for i, o in enumerate(self.three_d_objects):
            if o["object_id"] == object_id:
                return i
        return None


def load_axis_alignments(path: str) -> Dict[str, list]:
    """``scans_axis_alignment_matrices.json``: scan_id -> 16 floats."""
    with open(path) as f:
        return json.load(f)


def _load_one(args):
    scan_id, scan_dir, alignments = args
    return scan_id, Scan(scan_id, scan_dir, axis_alignment=alignments.get(scan_id))


def pack_scans(
    scan_ids: List[str],
    scan_dir: str,
    out_path: str,
    alignments: Optional[Dict[str, list]] = None,
    processes: int = 4,
):
    """Read ``scan_ids`` under ``scan_dir`` (``processes`` spawned workers) and
    pickle them, keyed by scan id, to ``out_path``; returns the dict."""
    alignments = alignments or {}
    args = [(sid, scan_dir, alignments) for sid in scan_ids]
    scans: Dict[str, Scan] = {}
    if processes > 1:
        # spawned workers; a worker that dies raises BrokenProcessPool
        with ProcessPoolExecutor(processes, mp_context=mp.get_context("spawn")) as pool:
            for sid, scan in pool.map(_load_one, args):
                scans[sid] = scan
    else:
        for a in args:
            sid, scan = _load_one(a)
            scans[sid] = scan
    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(scans, f, protocol=pickle.HIGHEST_PROTOCOL)
    return scans


# Globals a packed store may name: the scan class (the JAX package's name maps
# to this module's), and what numpy 1.x and 2.x pickle arrays with.
_SCAN_CLASSES = {("eda_tpu.data.scannet", "Scan"), (__name__, "Scan")}
_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (f"numpy.{core}.{module}", name)
    for core in ("core", "_core")
    for module, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                         ("numeric", "_frombuffer"))
}
_BUILTINS = {("builtins", "set"), ("builtins", "frozenset")}


class _StoreUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _SCAN_CLASSES:
            return Scan
        if (module, name) in _NUMPY_GLOBALS | _BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a scan store may not name {module}.{name}")


def load_packed_scans(path: str) -> Dict[str, Scan]:
    """A store written by ``pack_scans`` of either package: scan_id -> ``Scan``."""
    with open(path, "rb") as f:
        return _StoreUnpickler(f).load()
