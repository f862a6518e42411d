"""Accuracy-vs-window sweep and overfit probe (counterpart of ``eda_tpu/tools/window_sweep.py``).

1. Train a grounder on synthetic scenes (``--eval-on-train`` is the
   reference's ``--debug`` overfit mode: dropout off, accuracy on the
   training scenes; ``--train-windows dense`` trains with exact windows).
2. Freeze the parameters and evaluate under each ``sa_windows`` setting of
   ``--sweep`` (windows are a runtime knob, not a parameter shape).
3. Print Acc@0.25 / Acc@0.5 (top-1, ``bbs`` scoring, ``last_`` prefix) and the
   forward throughput per setting as JSON lines; with ``--eval-every N`` also
   a trace line every N steps.

The flags, their defaults and the JSON keys are the JAX tool's. Differences:
the run is on CUDA unless ``--cpu`` is given (``--dry`` selects the tiny
config only, on either device); ``--save-params`` / ``--init-params`` write
and read the port's checkpoint format (``train.checkpoint.save_state``) with
the saving run's flags, and a resumed run must repeat them. The restored step
continues the batch rotation and the (seed, step) dropout stream, so a staged
run is one long run. ``--dry`` builds ``ModelConfig().tiny()`` (f32), as the
JAX tool does; ``--impl gather`` trains and evaluates the gather SA, whose
windows do not exist: its sweep is ``default`` alone.

Usage:
    python -m eda_tpu_torch.tools.window_sweep --dry --eval-on-train \\
        --steps 4000 --eval-every 250 --schedule constant --lr 1e-3 --sweep default
    python -m eda_tpu_torch.tools.window_sweep --dry --cpu --steps 2   # CPU smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


from eda_tpu_torch.config import ModelConfig, TrainConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.entry import resolve_device, to_device
from eda_tpu_torch.eval.grounding import GroundingEvaluator
from eda_tpu_torch.losses.criterion import SetCriterionConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train.checkpoint import load_state, save_state
from eda_tpu_torch.train.optim import AdamW
from eda_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

# the flags a staged run must repeat: they fix the model, the data, the batch
# rotation, the dropout stream and the optimizer
RESUME_FLAGS = ("dry", "batch", "train_batches", "train_windows", "impl", "eval_on_train",
                "seed", "schedule", "lr")
DEFAULT_SWEEP = ["dense", "2048,512,512,512", "1024,256,256,256", "512,128,128,128"]
DRY_SWEEP = ["dense", "256,128,64,64", "128,64,64,64", "64,64,64,64"]


def parse_windows(spec: str, cfg: ModelConfig):
    if spec == "default":
        return tuple(cfg.sa_windows)
    if spec == "dense":
        return tuple(max(cfg.num_points, 4 * n) for n in cfg.sa_npoints)
    return tuple(int(x) for x in spec.split(","))


def parse_args(argv=None):
    ap = argparse.ArgumentParser("window_sweep")
    ap.add_argument("--dry", action="store_true", help="tiny config")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--eval-on-train", action="store_true",
                    help="evaluate the TRAINING scenes, dropout off (overfit probe)")
    ap.add_argument("--train-windows", default="default",
                    help="'default', 'dense', or comma list, e.g. 1024,256,256,256")
    ap.add_argument("--sweep", nargs="*", default=DEFAULT_SWEEP,
                    help="window settings to evaluate")
    ap.add_argument("--impl", default="fused", choices=["fused", "gather"],
                    help="SA implementation; only 'fused' is ported")
    ap.add_argument("--train-batches", type=int, default=4,
                    help="number of training batches (train scenes = batch * this)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "constant"],
                    help="'cosine' decays to zero over --steps; 'constant' holds --lr")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="if >0, evaluate the training scenes every N steps and print a "
                         "JSON trace line")
    ap.add_argument("--save-params", default="",
                    help="save the final training state (and these flags) to this path")
    ap.add_argument("--init-params", default="",
                    help="continue from a --save-params file: same flags, --schedule "
                         "constant; --steps counts ADDITIONAL steps")
    args = ap.parse_args(argv)
    if args.init_params and args.schedule != "constant":
        ap.error("--init-params needs --schedule constant: cosine's period is sized to "
                 "--steps, which differs between stages")
    if args.dry and args.sweep == DEFAULT_SWEEP:
        args.sweep = list(DRY_SWEEP)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    base = ModelConfig().tiny() if args.dry else ModelConfig(use_bf16=True)
    gen = SyntheticScenes(
        SyntheticConfig(num_points=base.num_points, num_objects=4 if args.dry else 8,
                        text_len=32 if args.dry else 64,
                        max_objects=16 if args.dry else base.max_detected_boxes),
        vocab_size=base.text_vocab_size,
    )

    def make_batch(lo, hi):
        return to_device(gen.train_batch(range(lo, hi)), device)

    train_cfg = dataclasses.replace(base, sa_impl=args.impl)
    if args.impl == "gather":
        args.sweep = ["default"]  # windows are a fused-path knob
    if args.train_windows != "default":
        train_cfg = dataclasses.replace(train_cfg,
                                        sa_windows=parse_windows(args.train_windows, base))
    if args.eval_on_train:
        train_cfg = dataclasses.replace(train_cfg, dropout=0.0)
    model = EDAGrounder(train_cfg)
    model.init_weights(args.seed)
    model = model.to(device)

    crit = SetCriterionConfig(num_decoder_layers=train_cfg.num_decoder_layers,
                              dataset="scanrefer")
    if args.schedule == "cosine":
        optimizer = AdamW(model, TrainConfig(lr=args.lr, lr_backbone=args.lr, clip_norm=1.0,
                                             lr_scheduler="cosine", max_epoch=1),
                          steps_per_epoch=max(args.steps, 1))
    else:
        optimizer = AdamW.constant(model, args.lr)
    state = TrainState(model, optimizer)
    flags = {k: getattr(args, k) for k in RESUME_FLAGS}
    if args.init_params:
        saved = load_state(args.init_params, state)["flags"]
        if saved != flags:
            diff = {k: (saved.get(k), flags[k]) for k in flags if saved.get(k) != flags[k]}
            raise SystemExit(f"--init-params {args.init_params} was saved with other flags "
                             f"(saved, given): {diff}")
        print(f"warm-start from {args.init_params} at step {state.step}", file=sys.stderr)
    step = make_train_step(crit, seed=args.seed)
    batches = [make_batch(i * args.batch, (i + 1) * args.batch)
               for i in range(args.train_batches)]
    forward = make_eval_step(model)

    def trace_accuracy():
        ev = GroundingEvaluator(prefixes=("last_",), modes=("bbs",))
        for b in batches[: args.eval_batches]:
            ev.evaluate(forward(b)[0], b["targets"])
        return ev.accuracy("last_", 0.25, 1, "bbs"), ev.accuracy("last_", 0.5, 1, "bbs")

    start = state.step
    for i in range(start, start + args.steps):
        metrics = step(state, batches[i % args.train_batches])
        if i % 25 == 0 or i == start + args.steps - 1:
            print(f"step {i}: loss {float(metrics['loss']):.3f}", file=sys.stderr)
        if args.eval_every and (i + 1) % args.eval_every == 0:
            a25, a50 = trace_accuracy()
            print(json.dumps({
                "trace": True, "impl": args.impl, "seed": args.seed, "step": i + 1,
                "acc_025_top1": round(a25, 4), "acc_05_top1": round(a50, 4),
                "loss": round(float(metrics["loss"]), 4),
            }), flush=True)

    if args.save_params:
        save_state(args.save_params, state, flags=flags)
        print(f"saved the training state to {args.save_params}", file=sys.stderr)

    if args.eval_on_train:
        eval_batches = batches[: args.eval_batches]
    else:
        eval_batches = [make_batch(1000 + i * args.batch, 1000 + (i + 1) * args.batch)
                        for i in range(args.eval_batches)]
    frozen = model.state_dict()
    for spec in args.sweep:
        windows = parse_windows(spec, base)
        eval_model = EDAGrounder(dataclasses.replace(base, sa_windows=windows,
                                                     sa_impl=args.impl)).to(device)
        eval_model.load_state_dict(frozen)
        fwd = make_eval_step(eval_model)
        ev = GroundingEvaluator(prefixes=("last_",), modes=("bbs",))
        t_fwd = None
        for i, b in enumerate(eval_batches):
            t0 = time.perf_counter()
            out, _ = fwd(b)
            float(out["last_center"][0, 0, 0])  # waits for the forward
            dt = time.perf_counter() - t0
            if i > 0:  # the first call builds and warms up
                t_fwd = dt if t_fwd is None else min(t_fwd, dt)
            ev.evaluate(out, b["targets"])
        rec = {
            "impl": args.impl,
            "sa_windows": list(windows),
            "acc_025_top1": round(ev.accuracy("last_", 0.25, 1, "bbs"), 4),
            "acc_05_top1": round(ev.accuracy("last_", 0.5, 1, "bbs"), 4),
            "train_windows": list(train_cfg.sa_windows),
            "steps": args.steps,
            "seed": args.seed,
            "schedule": args.schedule,
            "lr": args.lr,
        }
        if t_fwd:
            rec["fwd_scenes_per_sec"] = round(args.batch / t_fwd, 2)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
