"""ctypes bindings of the host pipeline's native core (``_native/loader.cpp``).

The port's own copy of ``eda_tpu/data/native.py``. The library is built with
``g++`` on first use into ``build/native/`` at the repository root (listed in
``.gitignore``); its file name carries a hash of the source and the flags. A
failed build raises with the compiler's output: nothing falls back quietly.
The numpy functions beside the bindings are their plain versions. Nothing on
the data path calls the library: the dataset sorts with numpy
(``data/presort.py``), as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from eda_tpu_torch.data.presort import morton_keys_np

SOURCE = Path(__file__).resolve().parent / "_native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# eda_tpu's Makefile: the same code from the same flags rounds the same
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
ORIGIN = -50.0  # the Morton grid's corner, as ``morton_keys_np``

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libeda_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it exists; raises with g++'s output on failure."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([os.environ.get("CXX", "g++"), *FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{out.stdout}{out.stderr}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, f32, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_int32
            ptr = ctypes.POINTER
            signatures = {
                "morton_keys": [ptr(f32), i64, f32, f32, ptr(i32)],
                "radix_argsort_u32": [ptr(ctypes.c_uint32), i64, ptr(i32)],
                "ply_decode_vertices": [ptr(ctypes.c_uint8), i64, i64, ptr(i64), ptr(i64),
                                        ptr(i32), i64, ptr(f32)],
                "prepare_scene": [ptr(f32), i64, ptr(ctypes.c_double), i64, ctypes.c_uint64,
                                  f32, f32, ptr(f32), ptr(i32)],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _points(xyz: np.ndarray) -> np.ndarray:
    xyz = np.ascontiguousarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), not {xyz.shape}")
    return xyz


def morton_argsort_np(xyz: np.ndarray, cell_size: float = 0.2) -> np.ndarray:
    """Plain version of ``morton_argsort``: a stable numpy argsort of the keys."""
    return np.argsort(morton_keys_np(xyz, cell_size), kind="stable").astype(np.int32)


def morton_argsort(xyz: np.ndarray, cell_size: float = 0.2) -> np.ndarray:
    """Stable argsort of the Morton keys of (N, 3) points, by the library's radix sort."""
    lib = _load()
    xyz = _points(xyz)
    n = len(xyz)
    keys = np.empty(n, np.int32)
    lib.morton_keys(_ptr(xyz, ctypes.c_float), n, cell_size, ORIGIN, _ptr(keys, ctypes.c_int32))
    order = np.empty(n, np.int32)
    lib.radix_argsort_u32(_ptr(keys.view(np.uint32), ctypes.c_uint32), n,
                          _ptr(order, ctypes.c_int32))
    return order


_KIND = {"u": 0, "i": 1, "f": 2}


def ply_decode(raw: bytes, count: int, stride: int, layout: list) -> np.ndarray:
    """A binary PLY vertex block as (count, properties) float32.

    layout: (byte offset, byte size, numpy dtype kind 'u' / 'i' / 'f') of each
    property within a ``stride``-byte vertex record.
    """
    for offset, size, kind in layout:
        if kind not in _KIND or size not in ((4, 8) if kind == "f" else (1, 2, 4)):
            raise ValueError(f"unsupported PLY property {size} bytes of kind {kind!r}")
        if offset < 0 or offset + size > stride:
            raise ValueError(f"property at byte {offset} outside a {stride}-byte record")
    if len(raw) < count * stride:
        raise ValueError(f"{len(raw)} bytes hold fewer than {count} records of {stride}")
    lib = _load()
    buf = np.frombuffer(raw, np.uint8, count=count * stride)
    offs = np.array([entry[0] for entry in layout], np.int64)
    sizes = np.array([entry[1] for entry in layout], np.int64)
    kinds = np.array([_KIND[entry[2]] for entry in layout], np.int32)
    out = np.empty((count, len(layout)), np.float32)
    lib.ply_decode_vertices(_ptr(buf, ctypes.c_uint8), count, stride,
                            _ptr(offs, ctypes.c_int64), _ptr(sizes, ctypes.c_int64),
                            _ptr(kinds, ctypes.c_int32), len(layout), _ptr(out, ctypes.c_float))
    return out


def prepare_scene_np(xyz: np.ndarray, keep_n: int, seed: int, align: Optional[np.ndarray] = None,
                     cell_size: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """Plain version of ``prepare_scene``."""
    xyz = _points(xyz)
    rs = np.random.RandomState(seed % (2**31))
    rows = rs.choice(len(xyz), keep_n, replace=len(xyz) < keep_n)
    pts = xyz[rows]
    if align is not None:
        mat = np.asarray(align, np.float64).reshape(4, 4)
        pts = (np.c_[pts, np.ones(len(pts))] @ mat.T)[:, :3].astype(np.float32)
    order = morton_argsort_np(pts, cell_size)
    return pts[order], rows[order].astype(np.int32)


def prepare_scene(xyz: np.ndarray, keep_n: int, seed: int, align: Optional[np.ndarray] = None,
                  cell_size: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """Downsample, axis-align and Morton-sort a cloud in one pass.

    Returns (sorted xyz (keep_n, 3), source rows (keep_n,)): each output slot's
    source vertex, for gathering colours and labels. The downsample is
    ``np.random.RandomState(seed).choice(n, keep_n, replace=n < keep_n)`` bit
    for bit.
    """
    lib = _load()
    xyz = _points(xyz)
    mat = None
    if align is not None:
        mat = np.ascontiguousarray(align, np.float64).reshape(-1)
        if mat.size != 16:
            raise ValueError(f"the alignment must hold 16 values, not {mat.size}")
    out_xyz = np.empty((keep_n, 3), np.float32)
    src = np.empty(keep_n, np.int32)
    lib.prepare_scene(_ptr(xyz, ctypes.c_float), len(xyz),
                      _ptr(mat, ctypes.c_double) if mat is not None else None,
                      keep_n, seed, cell_size, ORIGIN,
                      _ptr(out_xyz, ctypes.c_float), _ptr(src, ctypes.c_int32))
    return out_xyz, src
