"""Device time of the SA kernels of one training step at the flagship's shapes, layer by layer.

Records the kernel calls of one training step at batch 8 on 50 000-point
synthetic scenes (random weights, seed 0), then times each call with CUDA
events: ``--reps`` launches queued behind a device sleep, after one warm-up.
``--kernels`` picks what is recorded:

* ``pool`` (default): the pool backward (K5 compact at SA1, K6 windowed at
  SA2-4, ``ops.fused_sa.sa_pool_bwd``) of ``ModelConfig(use_bf16=True)``;
* ``prep_f32``: the f32 prep forward and backward (K2f, K7f,
  ``ops.fused_sa.sa_prep`` / ``sa_prep_bwd``) of ``ModelConfig()``;
* ``prep_bf16``: the bf16 prep forward and backward (K2, K7) of
  ``ModelConfig(use_bf16=True)``.

Prints one JSON line: the card's name and power limit, ms and the peak device
memory of one call (above what was allocated before it) per layer, the sums
per kernel, and whether a second launch gave every output bit for bit. With
``--busy`` it also profiles one forward and one training step of the same
model and gives the device's busy ms in each (``torch.profiler``).

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
# --kernels -> (use_bf16, recorded fused_sa functions and the kernel each runs)
KERNELS = {
    "pool": (True, {"sa_pool_bwd": None}),
    "prep_f32": (False, {"sa_prep": "K2f", "sa_prep_bwd": "K7f"}),
    "prep_bf16": (True, {"sa_prep": "K2", "sa_prep_bwd": "K7"}),
}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kernels", choices=sorted(KERNELS), default="pool")
    ap.add_argument("--busy", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    from eda_tpu_torch.bench import card_line
    from eda_tpu_torch.config import ModelConfig
    from eda_tpu_torch.entry import build, build_trainer
    from eda_tpu_torch.ops import fused_sa

    use_bf16, recorded = KERNELS[args.kernels]
    cfg = ModelConfig(use_bf16=use_bf16)
    state, step, batch = build_trainer(cfg, batch_size=args.batch, device="cuda", seed=0)
    calls = []
    kernels = {name: getattr(fused_sa, name) for name in recorded}

    def recorder(name):
        def record(*a, **kw):
            calls.append((name, a, kw))
            return kernels[name](*a, **kw)
        return record

    for name in recorded:
        setattr(fused_sa, name, recorder(name))
    try:
        step(state, batch)
    finally:
        for name, fn in kernels.items():
            setattr(fused_sa, name, fn)
    torch.cuda.synchronize()
    layers, sums, repeat, seen = [], {}, True, {}
    for name, a, kw in calls:
        fn = kernels[name]
        first, again = fn(*a, **kw), fn(*a, **kw)
        outs = zip(first, again) if isinstance(first, tuple) else [(first, again)]
        repeat &= all(torch.equal(x, y) for x, y in outs)
        del first, again
        kernel = recorded[name] or ("K5" if kw["compact"] else "K6")
        # forward calls run SA1 -> SA4, backward calls SA4 -> SA1
        i = seen[name] = seen.get(name, -1) + 1
        layer = f"SA{i + 1}" if name == "sa_prep" else f"SA{4 - i}"
        ms = cuda_ms(lambda: fn(*a, **kw), args.reps)
        sums[kernel] = sums.get(kernel, 0.0) + ms
        layers.append({"layer": layer, "kernel": kernel, "ms": ms,
                       "peak_mib": peak_mib(lambda: fn(*a, **kw))})
    out = {"label": args.label, "card": card_line(), "batch": args.batch,
           "kernels": args.kernels, "layers": layers,
           **{f"{k}_ms": v for k, v in sums.items()}, "bit_identical_repeat": repeat}
    if args.busy:
        out["busy_ms"] = {"step": busy_ms(lambda: step(state, batch))}
        del calls, state, step, batch
        torch.cuda.empty_cache()
        model, inputs = build(cfg, batch_size=args.batch, device="cuda", seed=0)
        with torch.inference_mode():
            model(inputs)
            out["busy_ms"]["forward"] = busy_ms(lambda: model(inputs))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
