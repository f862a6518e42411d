"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root (needs one CUDA card).

1. Prints the card's name and power limit and the torch / CUDA versions.
2. Builds every CUDA kernel from ``eda_tpu_torch/csrc`` (one nvcc per source,
   all started at once) and prints the build time.
3. Checks a small grounder (``ModelConfig(use_bf16=True).tiny()``) on the card
   against the same weights and inputs on the CPU, where every kernel wrapper
   runs its plain PyTorch version.
4. Records the kernels' inputs in one full-width forward
   (``ModelConfig(use_bf16=True)``, batch 8, 50 000-point scenes, random
   weights from a seed) and holds each kernel call against its plain version
   on those inputs: FPS bit-exact, the bf16 prep within 0.02 (plus one bf16
   step of the value), the pair pool within 0.03 with identical -1e9 rows.
   Times both with CUDA events, per SA layer.
5. Serves five batches of 8 scenes through the full-width forward with every
   launch counter set to 0 first; each batch must advance every counter by 4
   (one launch per SA layer) and give a finite (8, 256, 3) ``last_center``.
   Prints ms per batch and scenes/s, then the stage times and the busiest
   device operations of one more batch under ``torch.profiler``.
6. Prints the per-kernel JSON line, the card line, and as its last line
   ``{"ok": true, "device": {...}}``.

Per kernel, the JSON line's ``ms``, ``plain_ms`` and ``bound_ms`` are sums over
the four SA layers of one batch-8 forward, and ``launches`` is the count of the
serving phase. Any failed check raises, and the script exits non-zero. Without
CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_F32 = 67e12      # f32 outside the tensor cores, flop/s
PEAK_BF16 = 989e12    # bf16 tensor cores, dense, flop/s
BATCH = 8
REQUESTS = 5
HEAD_ATOL = 0.06      # card (cuBLAS bf16) vs CPU heads, as tests/test_torch_grounder.py


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Recorder:
    """Records the arguments of the kernel wrappers the model calls."""

    def __init__(self):
        from eda_tpu_torch.ops import fused_sa, pointops

        self.targets = [(pointops, "furthest_point_sample", "fps_launch"),
                        (fused_sa, "sa_prep", "sa_prep_launch"),
                        (fused_sa, "sa_pair_pool", "sa_pair_pool_launch")]
        self.calls = {symbol: [] for _, _, symbol in self.targets}

    def __enter__(self):
        self.saved = []
        for module, name, symbol in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def wrapped(*args, _fn=fn, _symbol=symbol, **kwargs):
                self.calls[_symbol].append((args, kwargs))
                return _fn(*args, **kwargs)

            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def bound(ops: float, peak: float, nbytes: float):
    """(least ms, what sets it) for ``ops`` at ``peak`` and ``nbytes`` at HBM rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fps_bound(args, kw):
    xyz, npoint = args
    B, N, _ = xyz.shape
    ops = B * (npoint - 1) * N * 9  # 3 sub, 3 mul, 2 add, 1 min per point and step
    return bound(ops, PEAK_F32, xyz.numel() * 4 + B * npoint * 4)


def prep_bound(args, kw):
    pts, w1 = args[0], args[1]
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    nbytes = pts.numel() * 4 + B * N * c1 * 2 + (in_dim + 3) * c1 * 4
    return bound(2 * B * N * in_dim * c1, PEAK_BF16, nbytes)


def in_radius_pairs(xyz, cen, starts, radius, window) -> int:
    """Pairs of this run's windows that lie within the radius (the work the pool needs)."""
    from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, window_starts

    starts = window_starts(starts.long(), xyz.shape[1], window)
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    offs = torch.arange(window, device=xyz.device)
    total = 0
    for j in range(starts.shape[1]):
        pts = xyz.gather(1, (starts[:, j, None] + offs)[..., None].expand(-1, -1, 3))
        c = cen[:, j * BLOCK:(j + 1) * BLOCK]
        d2 = ((pts[:, None] - c[:, :, None]) ** 2).sum(-1)
        total += int((d2 <= r2).sum())
    return total


def pool_bound(args, kw):
    A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3 = args
    c1, c2, c3 = A.shape[-1], w2.shape[1], w3.shape[1]
    pairs = in_radius_pairs(xyz, cen, starts, kw["radius"], kw["window"])
    nbytes = (A.numel() * 2 + xyz.numel() * 4 + b_c.numel() * 2 + cen.numel() * 4
              + starts.numel() * 4 + (w2.numel() + w3.numel()) * 2
              + (3 * c2 + c3) * 4 + b_c.shape[0] * b_c.shape[1] * c3 * 4)
    return bound(pairs * 2 * (c1 * c2 + c2 * c3), PEAK_BF16, nbytes)


def check_kernel(symbol: str, got, want, layer: int) -> float:
    """Max abs error of a kernel result against its plain version; raises past tolerance."""
    if symbol == "fps_launch":
        if not torch.equal(got, want):
            raise AssertionError(f"FPS kernel differs from its plain version at SA{layer}")
        return 0.0
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    if symbol == "sa_prep_launch":
        # 0.02, plus one bf16 step (2^-7 relative) where the LN output is large
        if not ((g - w).abs() <= 0.02 + w.abs() * 2.0 ** -7).all():
            raise AssertionError(f"prep kernel off its plain version at SA{layer}: {err}")
    else:
        if not torch.equal(got < -1e8, want < -1e8):
            raise AssertionError(f"pool kernel -1e9 rows differ at SA{layer}")
        if err > 0.03:
            raise AssertionError(f"pool kernel off its plain version at SA{layer}: {err}")
    return err


@torch.no_grad()
def check_kernels(calls) -> list:
    """Hold every recorded kernel call against its plain version; time both."""
    from eda_tpu_torch.ops.cuda import build, fps, sa_kernel, sa_prep

    specs = {
        "fps_launch": ("fps", fps.fps, fps.fps_plain, fps_bound),
        "sa_prep_launch": ("sa_prep", sa_prep.sa_prep, sa_prep.sa_prep_plain, prep_bound),
        "sa_pair_pool_launch": ("sa_pair_pool", sa_kernel.sa_pair_pool,
                                sa_kernel.sa_pair_pool_plain, pool_bound),
    }
    rows = []
    for symbol, (name, kernel_fn, plain_fn, bound_fn) in specs.items():
        kernel = build.KERNELS[symbol]
        if len(calls[symbol]) != 4:
            raise AssertionError(f"{name}: the forward made {len(calls[symbol])} calls, not 4")
        total = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        bound_ops = bound_bytes = 0.0
        for layer, (args, kw) in enumerate(calls[symbol], start=1):
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            torch.cuda.synchronize()
            err = check_kernel(symbol, got, want, layer)
            ms = cuda_ms(lambda: kernel_fn(*args, **kw), 20 if name != "sa_pair_pool" else 5)
            plain_ms = cuda_ms(lambda: plain_fn(*args, **kw), 1)
            bound_ms, by = bound_fn(args, kw)
            bound_ops += bound_ms if by == "operations" else 0.0
            bound_bytes += bound_ms if by == "bytes" else 0.0
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)][:2]
            print(f"kernel {name} SA{layer} {shapes}: max_abs_err {err} ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({by})")
            for key, value in (("err", err), ("ms", ms), ("plain_ms", plain_ms),
                               ("bound_ms", bound_ms)):
                total[key] = max(total[key], value) if key == "err" else total[key] + value
        rows.append({
            "name": name, "route": "cuda",
            "source": f"eda_tpu_torch/csrc/{kernel.source}.cu",
            "replaces": kernel.replaces, "launches": 0, "max_abs_err": total["err"],
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": None,
        })
    return rows


def small_model_check(root_cfg) -> None:
    """A tiny grounder on the card (kernels) against the CPU (plain versions).

    Every seed becomes a query (``num_queries`` = seed count), so the check
    does not hang on the order of near-tied objectness logits: the queries are
    aligned by seed index before the heads are compared.
    """
    import dataclasses

    from eda_tpu_torch.entry import build as build_model

    cfg = root_cfg.tiny()
    cfg = dataclasses.replace(cfg, num_queries=cfg.sa_npoints[1])
    gpu_model, gpu_in = build_model(cfg, batch_size=2, device="cuda", seed=1)
    cpu_model, cpu_in = build_model(cfg, batch_size=2, device="cpu", seed=1)
    got = {k: v.cpu() for k, v in gpu_model(gpu_in).items()}
    want = cpu_model(cpu_in)
    for i in range(1, 5):
        if not torch.equal(got[f"sa{i}_inds"], want[f"sa{i}_inds"]):
            raise AssertionError(f"tiny model: sa{i}_inds differ between card and CPU")
    feat_err = (got["fp2_features"].float() - want["fp2_features"].float()).abs().max().item()
    g_inds, w_inds = got["query_points_sample_inds"], want["query_points_sample_inds"]
    if not torch.equal(g_inds.sort(1).values, w_inds.sort(1).values):
        raise AssertionError("tiny model: the queries' seeds differ between card and CPU")
    perm = torch.stack([g.argsort()[w.argsort().argsort()] for g, w in zip(g_inds, w_inds)])
    errs = {}
    for key in ("proposal_center", "last_center", "last_pred_size", "last_sem_cls_scores"):
        g = got[key].gather(1, perm[..., None].expand(-1, -1, got[key].shape[-1]))
        errs[key] = (g.float() - want[key].float()).abs().max().item()
    print(f"tiny model card vs CPU: sa inds equal, fp2_features max err {feat_err}, "
          f"query-aligned max errs {errs}")
    if feat_err > 0.05 or max(errs.values()) > HEAD_ATOL:
        raise AssertionError("tiny model on the card is off its CPU twin")
    if not torch.isfinite(got["last_center"]).all():
        raise AssertionError("tiny model: non-finite last_center on the card")


def stage_times(model, batch) -> dict:
    """Host-clock ms of the forward's stages, each ended by a synchronize."""
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    with torch.no_grad():
        _, backbone = timed(lambda: model.backbone_net(batch["point_clouds"]))
        _, text = timed(lambda: model.text_encoder(batch["text_ids"],
                                                   batch["text_mask"].bool()))
        _, whole = timed(lambda: model(batch))
    return {"backbone": backbone, "text_encoder": text, "whole": whole,
            "rest": whole - backbone - text}


def profile_forward(model, batch) -> None:
    """Device time by operation and the device's busy share over one forward."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    # device-side events only (kernels, copies): a host op's device time
    # repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled forward: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; profiler on)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms  calls {e.count:5d}  "
              f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from eda_tpu_torch.config import ModelConfig
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import make_batch
    from eda_tpu_torch.ops.cuda import build

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "warning" in line or "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    cfg = ModelConfig(use_bf16=True)
    small_model_check(cfg)

    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder() as rec:
        model(inputs)
    torch.cuda.synchronize()
    rows = check_kernels(rec.calls)
    del rec

    batches = [inputs] + [make_batch(cfg, range(BATCH * i, BATCH * (i + 1)), "cuda")
                          for i in range(1, REQUESTS)]
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    for i, batch in enumerate(batches):
        before = {s: k.launches for s, k in build.KERNELS.items()}
        t = time.perf_counter()
        center = model(batch)["last_center"]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if center.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(center).all():
            raise AssertionError(f"request {i}: bad last_center {tuple(center.shape)}")
        for symbol, kernel in build.KERNELS.items():
            if kernel.launches - before[symbol] != 4:
                raise AssertionError(f"request {i}: {symbol} launched "
                                     f"{kernel.launches - before[symbol]} times, not 4")
        print(f"request {i}: {BATCH} scenes in {times[-1] * 1e3:.2f} ms, last_center finite")
    launches = {s: k.launches for s, k in build.KERNELS.items()}
    for row, symbol in zip(rows, ("fps_launch", "sa_prep_launch", "sa_pair_pool_launch")):
        row["launches"] = launches[symbol]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was not launched on the main path")
    steady = statistics.median(times[1:])
    print(f"serving forward, batch {BATCH}: {steady * 1e3:.2f} ms per batch, "
          f"{BATCH / steady:.2f} scenes/s (median of requests 1-{REQUESTS - 1}; "
          f"request 0 {times[0] * 1e3:.2f} ms)")
    print(f"stage ms of one batch: {stage_times(model, batches[-1])}")
    profile_forward(model, batches[-1])

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
