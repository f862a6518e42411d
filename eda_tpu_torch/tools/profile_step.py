"""Trace training steps or forwards with ``torch.profiler`` and print the device time by op and by bucket.

Counterpart of ``eda_tpu/tools/profile_step.py``: it traces ``--steps`` real
training steps (or serving forwards with ``--eval``) of the flagship
``ModelConfig(use_bf16=True)`` (``--dry``: ``ModelConfig().tiny()``) at
``--batch`` synthetic scenes, after one warm-up call, and prints the total
device time a step, the ``--top`` busiest device operations and the time in
the JAX tool's coarse buckets (``eda_tpu/tools/profile_step.py:69-86``): SA
fwd kernel, SA bwd kernel, FPS kernel, backbone fwd, backbone bwd, text fwd,
model bwd, loss, other.

The buckets come from the CUDA kernels' symbols (the SA kernels of
``csrc/``: pair pool, prep, mask, their backward and FPS) and from ranges the
tool opens around the backbone's and the text encoder's forward (module
hooks) and around the loss; the model code is not changed. A kernel launched
from a backward op belongs to the backbone's backward when the forward op
that recorded it (the profiler's sequence number) ran inside the backbone's
range. The trace is saved as ``trace.json`` (Chrome format) in ``--out`` (a
temporary directory by default); ``--parse DIR`` re-reads a saved trace. On
the CPU (``--device cpu``) there are no device events, and the CPU ops' self
times take their place.

Usage:
    python -m eda_tpu_torch.tools.profile_step                 # training step, batch 32
    python -m eda_tpu_torch.tools.profile_step --eval --batch 8
    python -m eda_tpu_torch.tools.profile_step --parse DIR --steps 3
    python -m eda_tpu_torch.tools.profile_step --dry --device cpu --steps 1
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import torch

SCOPES = ("backbone_net", "text_encoder")  # modules whose forward gets a range
LOSS = "loss"
# kernel symbols of csrc/ (a symbol in a backward op's context is the backward's)
SA_KERNELS = ("sa_pair_pool_kernel", "pool_bwd_tiles", "reduce_dA", "sa_prep_kernel",
              "prep_bwd_tiles", "prep_tc", "prep_fma", "split_w1", "sa_mask_kernel")
FPS_KERNELS = ("fps_regs", "fps_scratch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function"


@contextlib.contextmanager
def ranges(model):
    """Profiler ranges around the forward of ``SCOPES`` and around the loss."""
    from eda_tpu_torch.train import step as step_module

    handles, open_ranges = [], {}
    for name in SCOPES:
        def pre(module, args, _name=name):
            open_ranges[_name] = torch.profiler.record_function(_name).__enter__()

        def post(module, args, out, _name=name):
            open_ranges.pop(_name).__exit__(None, None, None)

        module = getattr(model, name)
        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    loss_fn = step_module.compute_hungarian_loss

    def loss(*args, **kwargs):
        with torch.profiler.record_function(LOSS):
            return loss_fn(*args, **kwargs)

    step_module.compute_hungarian_loss = loss
    try:
        yield
    finally:
        step_module.compute_hungarian_loss = loss_fn
        for h in handles:
            h.remove()


def capture(args) -> str:
    """Trace ``args.steps`` calls into ``args.out`` (or a new directory); returns it."""
    from torch.profiler import ProfilerActivity, profile

    from eda_tpu_torch.bench import build
    from eda_tpu_torch.config import ModelConfig, TrainConfig
    from eda_tpu_torch.entry import STEPS_PER_EPOCH, resolve_device
    from eda_tpu_torch.losses.criterion import SetCriterionConfig
    from eda_tpu_torch.train.optim import AdamW
    from eda_tpu_torch.train.step import TrainState, make_train_step

    device = resolve_device(args.device)
    cfg = ModelConfig().tiny() if args.dry else ModelConfig(use_bf16=True)
    model, batch = build(cfg, args.batch, 32 if args.dry else 64, device)
    if args.eval:
        def call():
            with torch.inference_mode():
                return model(batch["inputs"])["last_center"].sum()
    else:
        state = TrainState(model.train(), AdamW(model, TrainConfig(), STEPS_PER_EPOCH))
        step = make_train_step(SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers))

        def call():
            return step(state, batch)["loss"]
    print(f"warm-up: {float(call()):.4f}", file=sys.stderr)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    tracedir = Path(args.out or tempfile.mkdtemp(prefix="eda_trace_"))
    tracedir.mkdir(parents=True, exist_ok=True)
    with ranges(model), profile(activities=activities) as prof:
        for _ in range(args.steps):
            float(call())
    prof.export_chrome_trace(str(tracedir / "trace.json"))
    return str(tracedir)


def _contexts(events, points):
    """For each query point (tid, ts), the complete events on that thread
    whose span holds it, outermost first (an event's own start point holds
    the event); and each event's self time.

    ``events`` are the trace's complete CPU events, which nest per thread."""
    by_tid = collections.defaultdict(list)
    for i, e in enumerate(events):
        by_tid[e["tid"]].append((e["ts"], 0, -e["dur"], i))
    for j, (tid, ts) in enumerate(points):
        by_tid[tid].append((ts, 1, 0.0, j))
    self_time = [e["dur"] for e in events]
    found = [()] * len(points)
    for items in by_tid.values():
        items.sort()
        stack = []
        for ts, is_point, _, k in items:
            while stack and events[stack[-1]]["ts"] + events[stack[-1]]["dur"] <= ts:
                stack.pop()
            if is_point:
                found[k] = tuple(stack)
            else:
                if stack:
                    self_time[stack[-1]] -= events[k]["dur"]
                stack.append(k)
    return found, self_time


def bucket(name: str, context) -> str:
    """The coarse bucket of a device operation ``name`` launched in ``context``
    (the CPU events around its launch, outermost first, as dicts)."""
    names = [c["name"] for c in context]
    backward = [c for c in context if c["name"].startswith(BACKWARD)]
    if any(k in name for k in FPS_KERNELS):
        return "FPS kernel"
    if any(k in name for k in SA_KERNELS):
        return "SA bwd kernel" if backward else "SA fwd kernel"
    if backward:
        return "backbone bwd" if backward[-1].get("backbone") else "model bwd"
    if "backbone_net" in names:
        return "backbone fwd"
    if "text_encoder" in names:
        return "text fwd"
    if LOSS in names:
        return "loss"
    return "other"


def report(tracedir: str, steps: int, top: int = 20) -> dict:
    """Print the per-op table and the buckets of the trace in ``tracedir``;
    returns {bucket: ms per step}."""
    trace = json.loads((Path(tracedir) / "trace.json").read_text())["traceEvents"]
    cpu = [e for e in trace if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")]
    device = [e for e in trace if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    by_ext = {e["args"]["External id"]: e for e in cpu if "External id" in e.get("args", {})}
    # the sequence numbers of the forward ops inside the backbone's range mark
    # the backward ops of the backbone
    found, self_time = _contexts(cpu, [(e["tid"], e["ts"]) for e in cpu])
    seqs = {e["args"]["Sequence number"] for e, ctx in zip(cpu, found)
            if "Sequence number" in e.get("args", {}) and not e["name"].startswith(BACKWARD)
            and any(cpu[k]["name"] == "backbone_net" for k in ctx)}
    for e in cpu:
        if e["name"].startswith(BACKWARD) and e.get("args", {}).get("Sequence number") in seqs:
            e["backbone"] = True
    if device:
        launches = [by_ext.get(e.get("args", {}).get("External id")) for e in device]
        points = [(a["tid"], a["ts"]) if a else (None, 0.0) for a in launches]
        ctx, _ = _contexts(cpu, points)
        work = [(e["name"], e["dur"], [cpu[k] for k in c]) for e, c in zip(device, ctx)]
        where = "device"
    else:  # the CPU: every op's self time
        work = [(e["name"], t, [cpu[k] for k in c])
                for e, t, c in zip(cpu, self_time, found) if e["cat"] == "cpu_op"]
        where = "CPU self"
    total = sum(w[1] for w in work) / steps / 1e3
    print(f"total {where} time: {total:.3f} ms/step")
    per_op = collections.Counter()
    calls = collections.Counter()
    for name, dur, _ in work:
        per_op[name] += dur
        calls[name] += 1
    print(f"--- top {top} ops ---")
    for name, dur in per_op.most_common(top):
        print(f"{dur / steps / 1e3:9.3f} ms {100 * dur / max(total * steps * 1e3, 1e-9):5.1f}% "
              f"calls {calls[name] // steps:5d}  {name[:90]}")
    agg = collections.Counter()
    for name, dur, context in work:
        agg[bucket(name, context)] += dur
    print("--- buckets ---")
    for k, v in agg.most_common():
        print(f"{v / steps / 1e3:9.3f} ms  {k}")
    return {k: v / steps / 1e3 for k, v in agg.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("eda_tpu_torch.tools.profile_step")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval", action="store_true", help="profile the serving forward")
    ap.add_argument("--dry", action="store_true", help="tiny config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", help="trace output directory")
    ap.add_argument("--parse", help="skip the capture; read the trace in this directory")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    tracedir = args.parse or capture(args)
    print(f"trace: {tracedir}", file=sys.stderr)
    report(tracedir, args.steps, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
