"""The port's native host core (``data/native.py``, its own ``loader.cpp``).

Built with ``g++`` into ``build/native/`` and held against its numpy
versions and, bit for bit, against ``eda_tpu.data.native``'s library:
``morton_argsort``, ``ply_decode`` and ``prepare_scene``. A failed build
raises with the compiler's output.
"""

import numpy as np
import pytest

from eda_tpu.data import native as jax_native
from eda_tpu_torch.data import native
from eda_tpu_torch.data.ply import read_ply_vertices, write_ply_vertices
from eda_tpu_torch.data.presort import morton_keys_np


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.build().exists()
    assert jax_native.build()


@pytest.mark.parametrize("n,cell", [(5000, 0.2), (50000, 0.2), (1, 0.5), (3000, 0.05)])
def test_morton_argsort(rng, n, cell):
    xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    xyz[: n // 10] = xyz[0]  # ties: a stable sort keeps their order
    got = native.morton_argsort(xyz, cell)
    np.testing.assert_array_equal(got, native.morton_argsort_np(xyz, cell))
    np.testing.assert_array_equal(got, jax_native.morton_argsort(xyz, cell))
    keys = morton_keys_np(xyz, cell).view(np.uint32)
    assert (np.diff(keys[got].astype(np.int64)) >= 0).all()


def test_ply_decode(tmp_path, rng):
    path = str(tmp_path / "v.ply")
    data = {"x": rng.normal(size=100).astype(np.float32),
            "y": rng.normal(size=100).astype(np.float64),
            "z": rng.normal(size=100).astype(np.float32),
            "red": rng.integers(0, 255, 100).astype(np.uint8),
            "label": rng.integers(-300, 300, 100).astype(np.int16),
            "id": rng.integers(0, 70000, 100).astype(np.uint32)}
    write_ply_vertices(path, data)
    raw = open(path, "rb").read()
    body = raw[raw.index(b"end_header\n") + len(b"end_header\n"):]
    layout = [(0, 4, "f"), (4, 8, "f"), (12, 4, "f"), (16, 1, "u"), (17, 2, "i"), (19, 4, "u")]
    got = native.ply_decode(body, 100, 23, layout)
    assert got.tobytes() == jax_native.ply_decode(body, 100, 23, layout).tobytes()
    want = read_ply_vertices(path)
    for col, key in enumerate(data):
        np.testing.assert_array_equal(got[:, col], want[key].astype(np.float32))
    with pytest.raises(ValueError, match="unsupported"):
        native.ply_decode(body, 100, 23, [(0, 3, "f")])
    with pytest.raises(ValueError, match="outside"):
        native.ply_decode(body, 100, 23, [(21, 4, "u")])


@pytest.mark.parametrize("n,keep,aligned", [(60000, 50000, True), (10000, 4096, False),
                                            (800, 1000, True), (3000, 500, False)])
def test_prepare_scene(rng, n, keep, aligned):
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    align = None
    if aligned:
        align = np.eye(4)
        align[:2, :2] = [[0.8, -0.6], [0.6, 0.8]]
        align[:3, 3] = [0.5, -1.25, 2.0]
    got = native.prepare_scene(xyz, keep, seed=1184, align=align)
    want = jax_native.prepare_scene(xyz, keep, seed=1184, align=align)
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    out_xyz, src = got
    # the downsample is numpy's RandomState draw, the output Morton-sorted
    draw = np.random.RandomState(1184).choice(n, keep, replace=n < keep)
    np.testing.assert_array_equal(np.sort(src), np.sort(draw))
    plain_xyz, plain_src = native.prepare_scene_np(xyz, keep, seed=1184, align=align)
    np.testing.assert_array_equal(np.sort(plain_src), np.sort(src))
    moved = xyz[src] if align is None else xyz[src] @ align[:3, :3].T.astype(np.float32) + \
        align[:3, 3].astype(np.float32)
    np.testing.assert_allclose(out_xyz, moved, atol=1e-5)
    keys = morton_keys_np(out_xyz, 0.2).view(np.uint32).astype(np.int64)
    assert (np.diff(keys) >= 0).all()
    if align is None:  # no rounding differs: the plain version is bit-identical
        assert plain_xyz.tobytes() == out_xyz.tobytes() and plain_src.tobytes() == src.tobytes()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "loader.cpp"
    bad.write_text("extern \"C\" void f() { undeclared_name(); }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not (tmp_path / "build" / native.library_path().name).exists()
