"""Device time of the pool backward kernels (K5 compact, K6 windowed) at the flagship's shapes.

Records the ``sa_pool_bwd`` calls of one training step of
``ModelConfig(use_bf16=True)`` at batch 8 on 50 000-point synthetic scenes
(random weights, seed 0), then times each call with CUDA events: ``--reps``
launches queued behind a device sleep, after one warm-up. Prints one JSON line:
the card's name and power limit, ms per layer and the sums per kernel (K5 at
SA1, K6 at SA2-4), and whether a second launch gave every output bit for bit.

It uses only the port's public entry points (``entry.build_trainer``,
``ops.fused_sa.sa_pool_bwd``), so the same file times another checkout of
the port when run from that checkout's root:

    python -m eda_tpu_torch.tools.pool_bwd_times --label change
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

SLEEP_CYCLES = 50_000_000  # ~25 ms of device sleep ahead of the timed launches


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    from eda_tpu_torch.bench import card_line
    from eda_tpu_torch.config import ModelConfig
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.ops import fused_sa

    state, step, batch = build_trainer(ModelConfig(use_bf16=True), batch_size=args.batch,
                                       device="cuda", seed=0)
    calls, kernel = [], fused_sa.sa_pool_bwd

    def record(*a, **kw):
        calls.append((a, kw))
        return kernel(*a, **kw)

    fused_sa.sa_pool_bwd = record
    try:
        step(state, batch)
    finally:
        fused_sa.sa_pool_bwd = kernel
    torch.cuda.synchronize()
    layers, sums, repeat = [], {"K5": 0.0, "K6": 0.0}, True
    for i, (a, kw) in enumerate(calls):
        first, again = kernel(*a, **kw), kernel(*a, **kw)
        repeat &= all(torch.equal(x, y) for x, y in zip(first, again))
        del first, again
        ms = cuda_ms(lambda: kernel(*a, **kw), args.reps)
        name = "K5" if kw["compact"] else "K6"
        sums[name] += ms
        layers.append({"layer": f"SA{4 - i}", "kernel": name, "ms": ms})
    print(json.dumps({"label": args.label, "card": card_line(), "batch": args.batch,
                      "layers": layers, "K5_ms": sums["K5"], "K6_ms": sums["K6"],
                      "bit_identical_repeat": repeat}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
