"""Neighbourhood coverage of the fused SA's windows, measured on the host.

The port's own copy of ``eda_tpu/tools/coverage_probe.py`` (numpy, on the
CPU): what fraction of each center's true in-radius ball the SA1 window
sees, under window-start policies, curve orderings and window sizes, against
the reference's own neighbourhood completeness (its ball query keeps the
first <= nsample in-radius points in index order, so it is itself a subset
sampler at SA1's scale).

Modes (synthetic scenes; FPS by the port's plain version on the CPU):
  --policies   window-start policies at fixed W: block midpoint (the
               kernels'), block-range center, dual half-windows, per-center
               ideal; each under Morton and Hilbert ordering.
  --sweep      coverage against the window W and the centers per block pb.
  --reference  the reference ball query's own coverage at nsample = 64.
  --segments   eight cell-targeted segments a center instead of one window
               (a ball of radius r spans at most 8 cells of size 2r, each one
               rank range in Morton order).

Usage:
    python -m eda_tpu_torch.tools.coverage_probe --policies --reference --scenes 2
"""

import argparse

import numpy as np
import torch

from eda_tpu_torch.data.presort import morton_keys_np
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.ops.pointops import furthest_point_sample


def hilbert_keys_np(xyz, cell_size, origin=-50.0, bits=10):
    """Skilling's AxesToTranspose, vectorized; 3 x bits -> int64 key."""
    X = np.clip(
        np.floor((xyz - origin) / cell_size), 0, (1 << bits) - 1
    ).astype(np.uint32)
    x = [X[:, 0].copy(), X[:, 1].copy(), X[:, 2].copy()]
    n = 3
    M = np.uint32(1 << (bits - 1))
    Q = M
    while Q > 1:
        P = np.uint32(Q - 1)
        for i in range(n):
            mask = (x[i] & Q) != 0
            x[0] = np.where(mask, x[0] ^ P, x[0])
            t = np.where(mask, 0, (x[0] ^ x[i]) & P).astype(np.uint32)
            x[0] ^= t
            x[i] ^= t
        Q >>= 1
    for i in range(1, n):
        x[i] ^= x[i - 1]
    t = np.zeros(len(X), np.uint32)
    Q = M
    while Q > 1:
        t = np.where((x[n - 1] & Q) != 0, t ^ np.uint32(Q - 1), t)
        Q >>= 1
    for i in range(n):
        x[i] ^= t
    key = np.zeros(len(X), np.int64)
    for j in range(bits - 1, -1, -1):
        for i in range(n):
            key = (key << 1) | ((x[i] >> j) & 1).astype(np.int64)
    return key


def _spread3(v):
    v = (v | (v << 16)) & np.uint32(0x030000FF)
    v = (v | (v << 8)) & np.uint32(0x0300F00F)
    v = (v | (v << 4)) & np.uint32(0x030C30C3)
    v = (v | (v << 2)) & np.uint32(0x09249249)
    return v


def window_coverage(order_keys, xyz, centers_idx, r, W, pb, policy):
    """Mean in-radius coverage for a contiguous-window start policy."""
    N = len(xyz)
    order = np.argsort(order_keys, kind="stable")
    rank_of = np.empty(N, np.int64)
    rank_of[order] = np.arange(N)
    sx = xyz[order]
    ranks = np.sort(rank_of[centers_idx])
    M = len(ranks)
    covs = []
    for b0 in range(0, M, pb):
        grp = ranks[b0 : b0 + pb]
        if policy == "mid":  # the production kernel: block-midpoint start
            s = np.clip(grp[len(grp) // 2] - W // 2, 0, N - W)
            wins = [(s, s + W)] * len(grp)
        elif policy == "range":
            mid = (grp[0] + grp[-1]) // 2
            s = np.clip(mid - W // 2, 0, N - W)
            wins = [(s, s + W)] * len(grp)
        elif policy == "dual":
            h = max(len(grp) // 2, 1)
            wins = []
            for sub in (grp[:h], grp[h:]):
                if len(sub) == 0:
                    continue
                mid = (sub[0] + sub[-1]) // 2
                s = np.clip(mid - W // 4, 0, N - W // 2)
                wins.extend([(s, s + W // 2)] * len(sub))
        elif policy == "ideal":  # per-center window: upper bound
            wins = [
                (np.clip(g - W // 2, 0, N - W), np.clip(g - W // 2, 0, N - W) + W)
                for g in grp
            ]
        else:
            raise ValueError(policy)
        for g, (s, e) in zip(grp, wins):
            s = (s // 16) * 16  # kernel start quantization (sublane tile)
            c = sx[g]
            d2 = np.sum((sx - c) ** 2, axis=1)
            inr = d2 <= r * r
            covs.append(inr[s:e].sum() / max(inr.sum(), 1))
    return float(np.mean(covs))


def segment_coverage(keys, xyz, centers_idx, r, seg_len, pb, shared):
    """8-segment cell-targeted windows: each center reads the rank ranges
    of the <=8 cells (size 2r) its ball can touch, seg_len rows each."""
    N = len(xyz)
    order = np.argsort(keys, kind="stable")
    ks = keys[order].astype(np.int64)
    rank_of = np.empty(N, np.int64)
    rank_of[order] = np.arange(N)
    sx = xyz[order]
    ranks = np.sort(rank_of[centers_idx])
    s2 = 2 * r
    covs, rows = [], []
    for b0 in range(0, len(ranks), pb):
        grp = ranks[b0 : b0 + pb]
        if shared:
            anchor = sx[grp].mean(axis=0)
            anchors = [anchor] * len(grp)
        else:
            anchors = [sx[g] for g in grp]
        for g, a in zip(grp, anchors):
            base = np.floor((a - (-50.0)) / s2 - 0.5).astype(np.int64)
            cells = base[None, :] + np.stack(
                np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), -1
            ).reshape(8, 3)
            c = np.clip(cells, 0, 511).astype(np.uint32)
            pref = (
                _spread3(c[:, 0]) | (_spread3(c[:, 1]) << 1) | (_spread3(c[:, 2]) << 2)
            ).astype(np.int64)
            lo = np.searchsorted(ks, pref << 3)
            hi = np.minimum(np.searchsorted(ks, (pref + 1) << 3), lo + seg_len)
            seen = np.zeros(N, bool)
            tot_rows = 0
            for s, e in zip(lo, hi):
                seen[s:e] = True
                tot_rows += e - s
            d2 = np.sum((sx - sx[g]) ** 2, axis=1)
            inr = d2 <= r * r
            covs.append((inr & seen).sum() / max(inr.sum(), 1))
            rows.append(tot_rows)
    return float(np.mean(covs)), float(np.mean(rows))


def reference_coverage(xyz, centers_idx, r, nsample):
    """The reference ball_query keeps the first <=nsample in-radius points
    in INDEX order (ball_query_gpu.cu scans j=0..n-1, stops at nsample)."""
    covs, sizes = [], []
    for g in centers_idx:
        d2 = np.sum((xyz - xyz[g]) ** 2, axis=1)
        total = int((d2 <= r * r).sum())
        covs.append(min(total, nsample) / max(total, 1))
        sizes.append(total)
    return float(np.mean(covs)), float(np.mean(sizes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("eda_tpu_torch.tools.coverage_probe")
    ap.add_argument("--policies", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--segments", action="store_true")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--num_points", type=int, default=50000)
    ap.add_argument("--centers", type=int, default=2048)
    ap.add_argument("--radius", type=float, default=0.2)
    args = ap.parse_args(argv)
    if not any((args.policies, args.sweep, args.reference, args.segments)):
        args.policies = args.reference = True

    cfg = SyntheticConfig(num_points=args.num_points, num_objects=8, text_len=64)
    gen = SyntheticScenes(cfg, vocab_size=512)
    r = args.radius
    for i in range(args.scenes):
        ex = gen.example(i)
        xyz = np.asarray(ex["inputs"]["point_clouds"][:, :3], np.float64)
        cidx = furthest_point_sample(torch.from_numpy(xyz[None].astype(np.float32)),
                                     args.centers)[0].numpy()
        mk = morton_keys_np(xyz.astype(np.float32), r)
        print(f"scene {i}:")
        if args.policies:
            hk = hilbert_keys_np(xyz, r)
            for name, keys in (("morton", mk), ("hilbert", hk)):
                for policy in ("mid", "range", "dual", "ideal"):
                    c = window_coverage(keys, xyz, cidx, r, 1024, 16, policy)
                    print(f"  {name:7s} {policy:6s} W=1024 pb=16  cov={c:.3f}")
        if args.sweep:
            for pb in (4, 8, 16):
                for W in (256, 512, 768, 1024):
                    c = window_coverage(mk, xyz, cidx, r, W, pb, "mid")
                    print(f"  sweep pb={pb:2d} W={W:4d}  cov={c:.3f}")
        if args.segments:
            for seg in (128, 192):
                for shared in (False, True):
                    c, rows = segment_coverage(mk, xyz, cidx, r, seg, 16, shared)
                    kind = "block-shared" if shared else "per-center"
                    print(f"  8seg x{seg} {kind:12s} cov={c:.3f} rows~{rows:.0f}")
        if args.reference:
            c, size = reference_coverage(xyz, cidx, r, 64)
            print(f"  reference ball_query nsample=64  cov={c:.3f} (mean ball {size:.0f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
