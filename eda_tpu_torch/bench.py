"""End-to-end grounding throughput of the port (counterpart of the root ``bench.py``).

Measures scenes per second of the flagship ``EDAGrounder`` (50 000-point
synthetic scenes, RoBERTa-base geometry, 3 encoder and 6 decoder layers, 256
queries, random weights from seed 0) on one device, the way ``bench.py:93-222``
times the JAX package:

* forward: ``inner`` chained eval forwards, each input moved by a value that
  depends on the previous output (``pc + s * 1e-20``), closed by a scalar
  read and ``torch.cuda.synchronize()``;
* train: ``inner`` full training steps (forward, loss with every match,
  backward, clip, AdamW, BatchNorm update);
* eval (``--eval``): the forward + scoring step and
  ``GroundingEvaluator.evaluate(ious=...)``, serially and pipelined one deep
  (batch i + 1 is scored before batch i's IoU stack is pulled to the host).

Each timer prints its spread (median, min and max scenes/s over the
repetitions) to stderr. Standard output gets one JSON line per metric with the
JAX bench's names, ``mfu_accounting`` first and ``grounding_forward_throughput``
last, unit "scenes/sec/chip"; each line names the device and, on CUDA, the
card's name and power limit (``nvidia-smi``). ``mfu`` divides the dense-window
FLOPs (``utils/flops.py``) by the time and the H100 bf16 peak, ``useful_mfu``
the in-radius FLOPs; both only on CUDA. As in the JAX bench, ``--dry`` and
``--impl gather`` print no ``mfu_accounting`` line.

Runs on CUDA unless ``--cpu`` is given; ``--dry`` selects the JAX bench's tiny
config, ``ModelConfig().tiny()`` (f32; on either device), batch 2 and 32-token
texts; ``--impl gather`` the gather SA.

Usage:
    python -m eda_tpu_torch.bench --eval              # flagship, batch 32, on the card
    python -m eda_tpu_torch.bench --eval --batch 8
    python -m eda_tpu_torch.bench --dry --cpu --eval  # CPU smoke
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from eda_tpu_torch.config import ModelConfig, TrainConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.entry import STEPS_PER_EPOCH, resolve_device, to_device
from eda_tpu_torch.eval.grounding import GroundingEvaluator
from eda_tpu_torch.losses.criterion import SetCriterionConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train.optim import AdamW
from eda_tpu_torch.train.step import TrainState, make_eval_score_step, make_train_step


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None without one."""
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def build(cfg: ModelConfig, batch_size: int, text_len: int, device):
    """(model, batch): the grounder with random weights from seed 0 in eval
    mode, and ``{"inputs", "targets"}`` of scenes 0..batch_size-1 on ``device``."""
    gen = SyntheticScenes(
        SyntheticConfig(num_points=cfg.num_points, num_objects=8, text_len=text_len,
                        max_objects=cfg.max_detected_boxes),
        vocab_size=cfg.text_vocab_size,
    )
    batch = to_device(gen.train_batch(range(batch_size)), device)
    model = EDAGrounder(cfg)
    model.init_weights(0)
    return model.to(device).eval(), batch


def _force(x: torch.Tensor) -> float:
    """A scalar read of a dependent value, then a synchronize: the work is done."""
    value = float(x.reshape(-1)[0])
    if x.is_cuda:
        torch.cuda.synchronize()
    return value


def _report_spread(name: str, times, inner: int, batch: int) -> dict:
    """Median, min and max scenes/s over the repetitions, to stderr; returned too."""
    sps = sorted(batch * inner / t for t in times)
    spread = {"reps": len(sps), "median": float(np.median(sps)), "min": sps[0], "max": sps[-1]}
    print(f"{name} reps={len(sps)}: median {spread['median']:.2f} scenes/sec "
          f"(min {sps[0]:.2f}, max {sps[-1]:.2f})", file=sys.stderr)
    return spread


def bench_forward(model, batch, iters: int = 20, inner: int = 4):
    """(scenes/s, spread) of ``inner`` chained eval forwards per repetition."""
    inputs = batch["inputs"]

    def fwd_n():
        acc, pc = 0.0, inputs["point_clouds"]
        for _ in range(inner):
            s = model({**inputs, "point_clouds": pc})["last_center"].sum()
            acc, pc = acc + s, pc + (s * 1e-20).to(pc.dtype)
        return acc

    with torch.inference_mode():
        _force(fwd_n())
        times = []
        for _ in range(max(iters // inner, 5)):
            t0 = time.perf_counter()
            _force(fwd_n())
            times.append(time.perf_counter() - t0)
    bs = inputs["point_clouds"].shape[0]
    spread = _report_spread("forward", times, inner, bs)
    return bs / (float(np.median(times)) / inner), spread


def bench_train(model, batch, cfg: ModelConfig, iters: int = 10, inner: int = 4):
    """(scenes/s, spread) of ``inner`` training steps per repetition, under the
    default ``TrainConfig``, on a copy of ``model``."""
    model = copy.deepcopy(model)
    train_cfg = TrainConfig()
    state = TrainState(model, AdamW(model, train_cfg, STEPS_PER_EPOCH))
    step = make_train_step(SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers),
                           seed=train_cfg.seed)

    def step_n():
        for _ in range(inner):
            loss = step(state, batch)["loss"]
        return loss

    _force(step_n())
    times = []
    for _ in range(max(iters // inner, 4)):
        t0 = time.perf_counter()
        _force(step_n())
        times.append(time.perf_counter() - t0)
    bs = batch["inputs"]["point_clouds"].shape[0]
    spread = _report_spread("train", times, inner, bs)
    return bs / (float(np.median(times)) / inner), spread


def bench_eval(model, batch, iters: int = 8):
    """(scenes/s, spread) of the pipelined evaluation loop; the serial loop's
    spread goes to stderr as well."""
    ev = GroundingEvaluator(prefixes=("last_",))
    score_fn = make_eval_score_step(model, prefixes=ev.prefixes, modes=ev.modes)
    ev.evaluate(None, None, ious=score_fn(batch))  # warm-up
    times = []
    for _ in range(max(iters, 5)):
        ev = GroundingEvaluator(prefixes=("last_",))
        t0 = time.perf_counter()
        ev.evaluate(None, None, ious=score_fn(batch))
        times.append(time.perf_counter() - t0)
    bs = batch["inputs"]["point_clouds"].shape[0]
    _report_spread("eval[serial]", times, 1, bs)

    reps = []
    n = max(iters, 5)
    for _ in range(3):
        ev = GroundingEvaluator(prefixes=("last_",))
        pending = None
        t0 = time.perf_counter()
        for _ in range(n):
            ious = score_fn(batch)
            if pending is not None:
                ev.evaluate(None, None, ious=pending)
            pending = ious
        ev.evaluate(None, None, ious=pending)
        reps.append((time.perf_counter() - t0) / n)
    spread = _report_spread("eval[pipelined]", reps, 1, bs)
    return bs / float(np.median(reps)), spread


def parse_args(argv=None):
    p = argparse.ArgumentParser("eda_tpu_torch.bench")
    p.add_argument("--dry", action="store_true", help="tiny config, batch 2")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    p.add_argument("--no-train", action="store_true", help="skip the train-step bench")
    p.add_argument("--eval", action="store_true",
                   help="also measure the evaluation loop (forward + scoring + counters)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--impl", default="fused", choices=["fused", "gather"],
                   help="SA implementation")
    p.add_argument("--no-mfu", action="store_true", help="skip the FLOP accounting")
    p.add_argument("--fused_qkv", type=int, default=None,
                   help="override ModelConfig.fused_qkv (0/1) for A/B runs")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    card = card_line() if device.type == "cuda" else None
    where = {"device": device.type, "card": card}
    cfg = ModelConfig().tiny() if args.dry else ModelConfig(use_bf16=True)
    if args.fused_qkv is not None:
        cfg = dataclasses.replace(cfg, fused_qkv=bool(args.fused_qkv))
    if args.impl != "fused":
        cfg = dataclasses.replace(cfg, sa_impl=args.impl)
    batch_size = 2 if args.dry else args.batch
    text_len = 32 if args.dry else 64

    print(f"device: {device}" + (f", card: {card}" if card else ""), file=sys.stderr)
    model, batch = build(cfg, batch_size, text_len, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.1f}M", file=sys.stderr)

    fwd, fwd_spread = bench_forward(model, batch, iters=args.iters)
    print(f"forward: {fwd:.2f} scenes/sec", file=sys.stderr)
    tps = train_spread = None
    if not args.no_train:
        tps, train_spread = bench_train(model, batch, cfg, iters=max(2, args.iters // 2))
        print(f"train: {tps:.2f} scenes/sec", file=sys.stderr)

    mfu = {}
    # as the JAX bench: the fused path at full width only
    if not args.no_mfu and args.impl == "fused" and not args.dry:
        from eda_tpu_torch.utils.flops import PEAK_NAME, measure_sa_occupancy, mfu_summary

        pcs = batch["inputs"]["point_clouds"][:4].cpu().numpy()
        occ = measure_sa_occupancy(pcs, cfg, device=device)
        on_card = device.type == "cuda"  # a CPU time is no share of the card's peak
        mfu = mfu_summary(cfg, batch_size, text_len,
                          fwd_time_s=batch_size / fwd if on_card else None,
                          train_time_s=batch_size / tps if on_card and tps else None,
                          occupancy=occ)
        print(f"mfu: {({k: v for k, v in mfu.items() if k.endswith('mfu')})} against "
              f"{mfu['peak_flops']:.4g} FLOP/s ({PEAK_NAME}); occupancy "
              f"{[round(o, 3) for o in occ]}", file=sys.stderr)
        print(json.dumps({"metric": "mfu_accounting", **mfu, "peak": PEAK_NAME, **where}))

    def line(metric, value, spread, prefix=None):
        out = {"metric": metric, "value": value, "unit": "scenes/sec/chip", "batch": batch_size,
               "spread": spread, **where}
        if prefix and f"{prefix}_mfu" in mfu:
            out["mfu"], out["useful_mfu"] = mfu[f"{prefix}_mfu"], mfu[f"{prefix}_useful_mfu"]
        return json.dumps(out)

    if tps is not None:
        print(line("grounding_train_throughput", tps, train_spread, "train"))
    if args.eval:
        eps, eval_spread = bench_eval(model, batch)
        print(f"eval: {eps:.2f} scenes/sec", file=sys.stderr)
        print(line("grounding_eval_throughput", eps, eval_spread))
    # the headline (forward) line prints last, as in the JAX bench
    print(line("grounding_forward_throughput", fwd, fwd_spread, "fwd"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
