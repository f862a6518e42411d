"""The port's ScanNet store and real-data examples against the JAX package's.

* PLY files written by either package read the same in the other;
* ``Scan`` (points, colours, every object's points) equals ``eda_tpu``'s;
* a store packed by ``eda_tpu.data.scannet.pack_scans`` loads in the port in
  a process where importing ``eda_tpu`` or ``jax`` raises;
* ``GroundingDataset.from_args`` gives, over a grid of options (augmentation,
  colour, height, ``detect_intermediate``, the detected-box stream with and
  without a detection directory, multiview features, the ScanRefer, SR3D,
  SR3D+ and NR3D annotations), examples and batches bit-identical to JAX's.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import train as jax_train
from eda_tpu.data.dataset import GroundingDataset as JaxDataset
from eda_tpu.data.ply import read_ply_vertices as jax_read, write_ply_vertices as jax_write
from eda_tpu.data.scannet import Scan as JaxScan
from eda_tpu_torch.data.dataset import GroundingDataset
from eda_tpu_torch.data.ply import read_ply_vertices, write_ply_vertices
from eda_tpu_torch.data.scannet import Scan, load_packed_scans, pack_scans
from torch_parity import assert_same_arrays, assert_same_example, real_data_tree

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return real_data_tree(tmp_path_factory.mktemp("real"), multiview=True)


@pytest.mark.parametrize("ascii_fmt", [False, True])
def test_ply_files_cross_read(tmp_path, rng, ascii_fmt):
    data = {"x": rng.normal(size=64).astype(np.float32),
            "y": rng.normal(size=64).astype(np.float32),
            "z": rng.normal(size=64).astype(np.float64),
            "red": rng.integers(0, 255, 64).astype(np.uint8),
            "label": rng.integers(-5, 40, 64).astype(np.int32)}
    for write, read, name in ((write_ply_vertices, jax_read, "port"),
                              (jax_write, read_ply_vertices, "jax")):
        path = tmp_path / f"{name}.ply"
        write(str(path), data, ascii_fmt=ascii_fmt)
        assert path.read_bytes() == (tmp_path / "port.ply").read_bytes()
        got, want = read(str(path)), jax_read(str(path))
        assert_same_arrays(got, want, name)
        for key in data:
            np.testing.assert_allclose(got[key], data[key], rtol=1e-6 if ascii_fmt else 0)


def test_scan_equals_jax(tree):
    root, scan_dir, ids, _ = tree
    import json

    align = json.loads((root / "meta_data" / "scans_axis_alignment_matrices.json").read_text())
    for scan_id in ids["train"][:2]:
        for alignment in (None, align[scan_id]):
            got = Scan(scan_id, str(scan_dir), axis_alignment=alignment)
            want = JaxScan(scan_id, str(scan_dir), axis_alignment=alignment)
            assert got.pc.tobytes() == want.pc.tobytes()
            assert got.color.tobytes() == want.color.tobytes()
            assert got.pc.shape == (50000, 3)
            assert len(got.three_d_objects) == len(want.three_d_objects) >= 4
            for g, w in zip(got.three_d_objects, want.three_d_objects):
                assert (g["object_id"], g["instance_label"]) == (w["object_id"],
                                                                 w["instance_label"])
                assert g["points"].tobytes() == w["points"].tobytes()
            for i in range(len(got.three_d_objects)):
                assert got.get_object_bbox(i).tobytes() == want.get_object_bbox(i).tobytes()


def test_jax_store_loads_without_eda_tpu(tree, tmp_path):
    """The store ``real_data_tree`` packed with ``eda_tpu`` loads in the port with
    ``eda_tpu`` and ``jax`` unimportable, into the port's ``Scan``, equal to a
    store the port packs itself."""
    root, scan_dir, ids, _ = tree
    port_store = tmp_path / "port.pkl"
    import json

    align = json.loads((root / "meta_data" / "scans_axis_alignment_matrices.json").read_text())
    pack_scans(ids["val"], str(scan_dir), str(port_store), align, processes=1)
    code = (
        "import sys\n"
        "for name in ('eda_tpu', 'jax', 'flax'):\n"
        "    sys.modules[name] = None\n"
        "from eda_tpu_torch.data.scannet import Scan, load_packed_scans\n"
        f"jax_store = load_packed_scans({str(root / 'val_v3scans.pkl')!r})\n"
        f"port_store = load_packed_scans({str(port_store)!r})\n"
        "assert list(jax_store) == list(port_store)\n"
        "for sid, scan in jax_store.items():\n"
        "    other = port_store[sid]\n"
        "    assert type(scan) is Scan and type(other) is Scan\n"
        "    assert scan.pc.tobytes() == other.pc.tobytes()\n"
        "    assert scan.color.tobytes() == other.color.tobytes()\n"
        "    assert [o['points'].tobytes() for o in scan.three_d_objects] == "
        "[o['points'].tobytes() for o in other.three_d_objects]\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('eda_tpu', 'jax') "
        "and sys.modules[m] is not None]\n"
        "print(len(jax_store))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == len(ids["val"])


def test_pack_with_spawned_workers_equals_one_process(tree, tmp_path):
    root, scan_dir, ids, _ = tree
    one = pack_scans(ids["val"], str(scan_dir), str(tmp_path / "a.pkl"), processes=1)
    two = pack_scans(ids["val"], str(scan_dir), str(tmp_path / "b.pkl"), processes=2)
    assert list(one) == list(two) == ids["val"]
    for sid in one:
        assert one[sid].pc.tobytes() == two[sid].pc.tobytes()
    assert load_packed_scans(str(tmp_path / "b.pkl"))[ids["val"][0]].pc.tobytes() == \
        one[ids["val"][0]].pc.tobytes()


GRID = {
    "scanrefer-train": ["--dataset", "scanrefer", "--use_color"],
    "scanrefer-val": ["--dataset", "scanrefer", "--use_color", "--eval"],
    "scanrefer-no-augment": ["--dataset", "scanrefer", "--no_augment"],
    "scanrefer-height": ["--dataset", "scanrefer", "--use_color", "--use_height"],
    "sr3d-intermediate": ["--dataset", "sr3d", "--use_color", "--detect_intermediate"],
    "sr3d+-intermediate": ["--dataset", "sr3d+", "--detect_intermediate"],
    "nr3d": ["--dataset", "nr3d", "--use_color"],
    "butd-detections": ["--dataset", "scanrefer", "--use_color", "--butd", "--augment_det"],
    "butd-gt": ["--dataset", "sr3d", "--butd_gt"],
    "butd-cls": ["--dataset", "nr3d", "--butd_cls"],
    "multiview": ["--dataset", "scanrefer", "--use_color", "--use_height", "--use_multiview"],
}


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("case", sorted(GRID))
def test_grounding_dataset_bit_identical(tree, case, split, monkeypatch):
    """Every example of the split and a batch of three, array for array and
    flag for flag; on ``val`` no detection directory exists (the scene-box
    fallback), on ``train`` the GroupFree detections are read."""
    root = tree[0]
    args = jax_train.parse_args(GRID[case] + ["--data_root", str(root)])
    got_ds = GroundingDataset.from_args(args, split)
    want_ds = JaxDataset.from_args(args, split)
    assert len(got_ds) == len(want_ds) > 0
    assert got_ds.annos == want_ds.annos
    butd = got_ds.butd
    for i in range(len(want_ds)):
        assert_same_example(got_ds.example(i), want_ds.example(i), f"{case} {split} {i}")
    idx = [len(want_ds) - 1, 0, 1]
    assert_same_example(got_ds.batch(idx, butd=butd), want_ds.batch(idx, butd=butd),
                        f"{case} {split} batch")
