"""Vertex element of a PLY file, binary little-endian or ASCII.

The port's own copy of ``eda_tpu/data/ply.py``: ScanNet ships its meshes in
these two formats; faces are skipped, and list properties on vertices are
refused.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> Dict[str, np.ndarray]:
    """Per-vertex property arrays keyed by property name (x, y, z, red, ...)."""
    with open(path, "rb") as f:
        header_lines: List[bytes] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            header_lines.append(line.strip())
            if line.strip() == b"end_header":
                break

        fmt = None
        elements: List[Tuple[str, int]] = []
        props: Dict[str, List[Tuple[str, str]]] = {}
        current = None
        for line in header_lines:
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                current = parts[1]
                elements.append((current, int(parts[2])))
                props[current] = []
            elif parts[0] == "property" and current is not None:
                if parts[1] == "list":
                    props[current].append(("list", " ".join(parts[2:])))
                else:
                    props[current].append((parts[2], parts[1]))

        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        if not elements or elements[0][0] != "vertex":
            raise ValueError(f"{path}: expected vertex as first element")

        name, count = elements[0]
        vertex_props = props[name]
        if any(p[0] == "list" for p in vertex_props):
            raise ValueError(f"{path}: list properties on vertices unsupported")

        if fmt == "binary_little_endian":
            dtype = np.dtype([(pname, "<" + _PLY_DTYPES[ptype]) for pname, ptype in vertex_props])
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
        else:
            rows = [f.readline().split() for _ in range(count)]
            arr = np.asarray(rows, dtype=np.float64)
            dtype = np.dtype([(pname, _PLY_DTYPES[ptype]) for pname, ptype in vertex_props])
            data = np.zeros(count, dtype=dtype)
            for i, (pname, _) in enumerate(vertex_props):
                data[pname] = arr[:, i]

        return {pname: np.ascontiguousarray(data[pname]) for pname, _ in vertex_props}


def write_ply_vertices(path: str, arrays: Dict[str, np.ndarray], ascii_fmt: bool = False):
    """Write a vertex-only PLY from per-property arrays (fixtures and tools)."""
    names = list(arrays)
    count = len(arrays[names[0]])
    inv = {v: k for k, v in _PLY_DTYPES.items()}
    with open(path, "wb") as f:
        f.write(b"ply\n")
        fmt = "ascii" if ascii_fmt else "binary_little_endian"
        f.write(f"format {fmt} 1.0\n".encode())
        f.write(f"element vertex {count}\n".encode())
        for n in names:
            tname = inv[arrays[n].dtype.str.lstrip("<>|=")]
            f.write(f"property {tname} {n}\n".encode())
        f.write(b"end_header\n")
        if ascii_fmt:
            cols = np.stack([arrays[n].astype(np.float64) for n in names], 1)
            for row in cols:
                f.write((" ".join(str(v) for v in row) + "\n").encode())
        else:
            rec = np.zeros(
                count,
                dtype=np.dtype([(n, "<" + arrays[n].dtype.str.lstrip("<>|=")) for n in names]),
            )
            for n in names:
                rec[n] = arrays[n]
            f.write(rec.tobytes())
