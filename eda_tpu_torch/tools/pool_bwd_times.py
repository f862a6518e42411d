"""Device time of the SA kernels of one training step at the flagship's shapes, layer by layer.

Records the kernel calls of one training step (and, for the pools, of one
serving forward) at batch 8 on 50 000-point synthetic scenes (random weights,
seed 0), then times each call with CUDA events: ``--reps`` launches queued
behind a device sleep, after one warm-up. ``--kernels`` picks what is
recorded:

* ``pool`` (default): the pool forward of a serving forward (K3,
  ``ops.fused_sa.sa_pair_pool``) and of a training step (K4, with winners,
  ``sa_pair_pool_winners``) and the pool backward (K5 compact at SA1, K6
  windowed at SA2-4, ``sa_pool_bwd``) of ``ModelConfig(use_bf16=True)``;
* ``pool_w2x``: the same kernels of the width-2 backbone (``W2X_SA_MLPS``,
  ``W2X_FP_MLPS``: SA2-4 on the wide (256, 256, 512) kernels);
* ``prep_f32``: the f32 prep forward and backward (K2f, K7f,
  ``ops.fused_sa.sa_prep`` / ``sa_prep_bwd``) of ``ModelConfig()``;
* ``prep_bf16``: the bf16 prep forward and backward (K2, K7) of
  ``ModelConfig(use_bf16=True)``;
* ``prep_w2x``: the same kernels of the width-2 backbone (SA1 at c1 128,
  SA2-4 at c1 256, in_dim 259 / 515 / 515);
* ``prep_f32_w2x``: the f32 prep forward and backward (K2f, K7f) of the
  width-2 backbone in ``ModelConfig()`` (SA2-4 at c1 256);
* ``serve_w4x``: the prep and the pool of a serving forward (K2, K3) of the
  width-4 backbone (``W4X_SA_MLPS``, ``W4X_FP_MLPS``: SA1 at (256, 256, 512)
  and c1 256, SA2-4 on the (512, 512, 1024) pool and the c1-512 prep, labelled
  "K3 XL" and "K2 XL");
* ``serve_f32_w4x``: the same of the f32 width-4 backbone (K2f, "K2f XL");
* ``pool_w4x``: the pools of a serving forward and of a training step and
  the pool and prep backward (K3, K4, K5 at SA1, K6, K7) of the width-4
  backbone, SA2-4 labelled " XL" (the winners pool and the backward at (512,
  512, 1024), K7 at c1 512);
* ``step_f32_w4x``: the training step's kernels (K4, K5, K6, K7f) of the f32
  width-4 backbone (its pools are the bf16 ones).

Prints one JSON line: the card's name and power limit, ms and the peak device
memory of one call (above what was allocated before it) per layer, the sums
per kernel, and whether a second launch gave every output bit for bit. With
``--busy`` it also profiles one forward and one training step of the same
model and gives the device's busy ms in each (``torch.profiler``). With
``--split`` it profiles one call per layer and gives the device ms of each of
its launches by name (the kernel, its scratch memsets, the fixed-order
reductions of its records); where the f32 forward keeps W1's split across
calls (its cluster route, c1 above 128), ``w1_split_ms`` is the device ms of
splitting that layer's W1 once (``split_w1``), which a call makes only after
W1 changed. Each K2f layer names its route (``sa_prep.f32_forward_route``).

It uses only the port's public entry points (``entry.build_trainer``,
``entry.build``, ``ops.fused_sa``), so the same file times another checkout
of the port when run from that checkout's root:

    python -m eda_tpu_torch.tools.pool_bwd_times --kernels prep_f32 --label change
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

SLEEP_CYCLES = 50_000_000  # ~25 ms of device sleep ahead of the timed launches
# The width-2 and width-4 backbones ("W2X", "W4X"): Group-Free-3D's
# Pointnet2Backbone(width=2 / 4) (models/backbone_module.py) multiplies every
# SA and FP width of the flagship by 2 / 4
W2X_SA_MLPS = ((128, 128, 256), (256, 256, 512), (256, 256, 512), (256, 256, 512))
W2X_FP_MLPS = ((512, 512), (512, 288))
W4X_SA_MLPS = ((256, 256, 512), (512, 512, 1024), (512, 512, 1024), (512, 512, 1024))
W4X_FP_MLPS = ((1024, 1024), (1024, 288))
WIDTHS = {"flagship": None, "w2x": (W2X_SA_MLPS, W2X_FP_MLPS), "w4x": (W4X_SA_MLPS, W4X_FP_MLPS)}
_POOL_STEP = {"sa_pair_pool_winners": "K4", "sa_pool_bwd": None}
_POOL_SERVE = {"sa_pair_pool": "K3"}
# --kernels -> (use_bf16, the widths (``WIDTHS``), the recorded fused_sa
# functions of a training step and of a serving forward, each with the kernel
# it runs; None: K5 or K6 by the call's variant)
KERNELS = {
    "pool": (True, "flagship", _POOL_STEP, _POOL_SERVE),
    "pool_w2x": (True, "w2x", _POOL_STEP, _POOL_SERVE),
    "prep_f32": (False, "flagship", {"sa_prep": "K2f", "sa_prep_bwd": "K7f"}, {}),
    "prep_bf16": (True, "flagship", {"sa_prep": "K2", "sa_prep_bwd": "K7"}, {}),
    "prep_w2x": (True, "w2x", {"sa_prep": "K2", "sa_prep_bwd": "K7"}, {}),
    "prep_f32_w2x": (False, "w2x", {"sa_prep": "K2f", "sa_prep_bwd": "K7f"}, {}),
    "serve_w4x": (True, "w4x", {}, {"sa_prep": "K2", "sa_pair_pool": "K3"}),
    "serve_f32_w4x": (False, "w4x", {}, {"sa_prep": "K2f"}),
    "pool_w4x": (True, "w4x", {**_POOL_STEP, "sa_prep_bwd": "K7"}, _POOL_SERVE),
    "step_f32_w4x": (False, "w4x", {**_POOL_STEP, "sa_prep_bwd": "K7f"}, {}),
}
# the functions called SA1 -> SA4; the others (backward) SA4 -> SA1
FORWARD = ("sa_prep", "sa_pair_pool", "sa_pair_pool_winners")


def model_config(kernels: str):
    """The model whose kernels ``--kernels`` times."""
    import dataclasses

    from eda_tpu_torch.config import ModelConfig

    use_bf16, widths = KERNELS[kernels][:2]
    cfg = ModelConfig(use_bf16=use_bf16)
    if WIDTHS[widths] is None:
        return cfg
    sa_mlps, fp_mlps = WIDTHS[widths]
    return dataclasses.replace(cfg, sa_mlps=sa_mlps, fp_mlps=fp_mlps)


def xl(name: str, a) -> bool:
    """Whether a recorded prep or pool call runs above (256, 256, 512) / c1 256."""
    if name in ("sa_prep", "sa_prep_bwd"):
        return a[1 if name == "sa_prep" else 2].shape[1] > 256
    return name in ("sa_pair_pool", "sa_pair_pool_winners", "sa_pool_bwd") and a[0].shape[-1] > 256


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def peak_mib(fn) -> float:
    """Device memory one call of ``fn`` takes at its peak, above what was allocated."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def busy_ms(fn) -> float:
    """The device's busy ms over one call of ``fn``: its kernels' and copies' own time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def split_ms(fn) -> dict:
    """Device ms of one call of ``fn`` by launch: kernels by their function's
    name, memsets and copies as the profiler names them."""
    import re

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.self_device_time_total:
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
        name = re.split(r"[<(]", name)[0] if not name.startswith("Mem") else name
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out


def w1_split_ms(a, kw):
    """Device ms of splitting a K2f call's W1 once, where the f32 forward keeps
    the split across calls (``sa_prep.f32_w1_split``); else None."""
    from eda_tpu_torch.ops.cuda import sa_prep

    if kw.get("compute_dtype") != torch.float32 or not hasattr(sa_prep, "f32_w1_split"):
        return None  # (an older checkout splits W1 at every call)
    rows = a[0].shape[0] * a[0].shape[1]
    fresh = a[1].detach().clone()  # a W1 not yet split
    ms = split_ms(lambda: sa_prep.f32_w1_split(rows, fresh))
    return sum(ms.values()) if ms else None


def f32_route(a, kw):
    """A K2f call's route (``sa_prep.f32_forward_route_cuda``); else None."""
    from eda_tpu_torch.ops.cuda import sa_prep

    if kw.get("compute_dtype") != torch.float32 or not hasattr(sa_prep, "f32_forward_route_cuda"):
        return None  # (an older checkout names no route)
    pts, w1 = a[0], a[1]
    return sa_prep.f32_forward_route_cuda(pts.shape[0] * pts.shape[1], pts.shape[2], w1.shape[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kernels", choices=sorted(KERNELS), default="pool")
    ap.add_argument("--busy", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    from eda_tpu_torch.bench import card_line
    from eda_tpu_torch.entry import build, build_trainer
    from eda_tpu_torch.ops import fused_sa

    _, _, step_recorded, serve_recorded = KERNELS[args.kernels]
    cfg = model_config(args.kernels)
    recorded = {**step_recorded, **serve_recorded}
    kernels = {name: getattr(fused_sa, name) for name in recorded}
    calls = []

    def run_recorded(names, fn):
        def recorder(name):
            def record(*a, **kw):
                calls.append((name, a, kw))
                return kernels[name](*a, **kw)
            return record

        for name in names:
            setattr(fused_sa, name, recorder(name))
        try:
            fn()
        finally:
            for name in names:
                setattr(fused_sa, name, kernels[name])

    busy = {}
    if step_recorded:  # (the serve_* sets time a forward only)
        state, step, batch = build_trainer(cfg, batch_size=args.batch, device="cuda", seed=0)
        run_recorded(step_recorded, lambda: step(state, batch))
        if args.busy:
            busy["step"] = busy_ms(lambda: step(state, batch))
        del state, step, batch
        torch.cuda.empty_cache()
    model, inputs = build(cfg, batch_size=args.batch, device="cuda", seed=0)
    with torch.inference_mode():
        run_recorded(serve_recorded, lambda: model(inputs))
        if args.busy:
            model(inputs)
            busy["forward"] = busy_ms(lambda: model(inputs))
    del model, inputs
    torch.cuda.synchronize()
    layers, sums, repeat, seen = [], {}, True, {}
    for name, a, kw in calls:
        fn = kernels[name]
        first, again = fn(*a, **kw), fn(*a, **kw)
        outs = zip(first, again) if isinstance(first, tuple) else [(first, again)]
        repeat &= all(torch.equal(x, y) for x, y in outs)
        del first, again
        kernel = recorded[name] or ("K5" if kw["compact"] else "K6")
        kernel += " XL" if xl(name, a) else ""
        i = seen[name] = seen.get(name, -1) + 1
        layer = f"SA{i + 1}" if name in FORWARD else f"SA{4 - i}"
        ms = cuda_ms(lambda: fn(*a, **kw), args.reps)
        sums[kernel] = sums.get(kernel, 0.0) + ms
        layers.append({"layer": layer, "kernel": kernel, "ms": ms,
                       "peak_mib": peak_mib(lambda: fn(*a, **kw))})
        if args.split:
            layers[-1]["split_ms"] = split_ms(lambda: fn(*a, **kw))
            once = w1_split_ms(a, kw) if name == "sa_prep" else None
            if once is not None:
                layers[-1]["w1_split_ms"] = once
        route = f32_route(a, kw) if name == "sa_prep" else None
        if route is not None:
            layers[-1]["route"] = route
    out = {"label": args.label, "card": card_line(), "batch": args.batch,
           "kernels": args.kernels, "layers": layers,
           **{f"{k}_ms": v for k, v in sums.items()}, "bit_identical_repeat": repeat}
    if busy:
        out["busy_ms"] = busy
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
