"""Pack a ScanNet split into the scan store the training CLI reads.

The port's twin of ``eda_tpu/tools/pack_scans.py``: reads every scan of
``meta/scannetv2_{split}.txt`` under ``--scan_dir`` (with the axis alignments
of ``{data_root}/meta_data/scans_axis_alignment_matrices.json`` where that
file exists) and writes ``{data_root}/{split}_v3scans.pkl``.

Usage:
    python -m eda_tpu_torch.tools.pack_scans --scan_dir /path/to/scans \\
        --split train --data_root data/
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import List

from eda_tpu_torch.data.scannet import load_axis_alignments, pack_scans
from eda_tpu_torch.data.vocab import LABELS_TSV


def split_scan_ids(split: str) -> List[str]:
    """The scan ids of ``meta/scannetv2_{split}.txt``."""
    with open(osp.join(osp.dirname(LABELS_TSV), f"scannetv2_{split}.txt")) as f:
        return [line.strip() for line in f if line.strip()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("pack ScanNet scans (PyTorch port)")
    parser.add_argument("--scan_dir", required=True)
    parser.add_argument("--data_root", default="data/")
    parser.add_argument("--split", default="train", choices=["train", "val", "test"])
    parser.add_argument("--processes", type=int, default=4)
    args = parser.parse_args(argv)

    align_path = osp.join(args.data_root, "meta_data", "scans_axis_alignment_matrices.json")
    alignments = load_axis_alignments(align_path) if osp.exists(align_path) else {}
    out = osp.join(args.data_root, f"{args.split}_v3scans.pkl")
    scans = pack_scans(split_scan_ids(args.split), args.scan_dir, out, alignments,
                       processes=args.processes)
    print(f"packed {len(scans)} scans -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
