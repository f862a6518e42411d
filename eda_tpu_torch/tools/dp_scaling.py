"""Data parallelism on the cards of one host against one card, through the training CLI.

After building the kernels and running ``entry.dryrun_multichip(N)`` (NCCL
ranks, rank r on card r), it runs, with the same flags:

* ``torchrun --standalone --nproc_per_node N -m eda_tpu_torch.train`` at
  ``N * BATCH`` scenes a step (``BATCH`` = 8 a card) and ``python -m
  eda_tpu_torch.train`` at ``BATCH`` on one card, ``STEPS`` = 24 synthetic
  steps each of the flagship bf16 model, and reads steps/s and scenes/s from
  each run's ``metrics.jsonl`` from step ``WARMUP`` = 8 on (wall time, the
  input pipeline's waits included) and, beside it, from the first step;
* the evaluation of the converged tiny weights (``tests/torch_tiny_overfit.npz``,
  the overfit contract's state) by the N ranks at ``EVAL_BATCH`` = 8 scenes
  a batch and by one card at ``EVAL_BATCH / N``, the rows one rank scores:
  the two records must be equal. One card at ``EVAL_BATCH`` is run too and
  whether it equals is printed (on the card a row's result may depend on the
  batch's shape).

Prints the card's name and power limit first and one JSON line of the
results last; exits 1 when a check fails. It needs N cards:

    python -m eda_tpu_torch.tools.dp_scaling --ranks 4 --out logs/dp_scaling
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
THREADS = "4"  # OMP_NUM_THREADS of every run
BATCH, STEPS, WARMUP, EVAL_BATCH = 8, 24, 8, 8
WEIGHTS = ROOT / "tests" / "torch_tiny_overfit.npz"


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def run(name: str, cmd: list, out: Path) -> float:
    """Run ``cmd`` with its output in ``out/name.out``; its wall seconds."""
    t = time.perf_counter()
    with open(out / f"{name}.out", "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                            env={**os.environ, "OMP_NUM_THREADS": THREADS}).returncode
    seconds = time.perf_counter() - t
    if rc:
        sys.stdout.write((out / f"{name}.out").read_text()[-4000:])
        raise SystemExit(f"{name} exited {rc}")
    print(f"{name}: {seconds:.1f} s", flush=True)
    return seconds


def train_cmd(ranks: int, batch: int, steps: int, log_dir: Path) -> list:
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", str(ranks), "-m"] if ranks > 1 else [sys.executable, "-m"])
    return launcher + ["eda_tpu_torch.train", "--dataset", "synthetic", "--use_color",
                       "--batch_size", str(batch), "--max_steps", str(steps), "--print_freq",
                       "1", "--log_dir", str(log_dir)]


def eval_cmd(ranks: int, batch: int, ckpt: Path, log_dir: Path) -> list:
    cmd = train_cmd(ranks, batch, 0, log_dir)
    return cmd[:cmd.index("--max_steps")] + ["--debug", "--eval", "--checkpoint_path",
                                             str(ckpt), "--log_dir", str(log_dir)]


def rows_of(log_dir: Path, group: str) -> list:
    rows = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if r["group"] == group]


def rate(rows: list, first_step: int) -> dict:
    """Steps/s between the row of ``first_step`` and the last row."""
    first = next(r for r in rows if r["step"] >= first_step)
    last = rows[-1]
    return dict(steps=[first["step"], last["step"]],
                steps_per_s=(last["step"] - first["step"]) / (last["time"] - first["time"]))


def write_converged(weights: Path, directory: Path) -> None:
    """``directory/epoch_0.pt``: the tiny model with ``weights``, fresh moments."""
    from eda_tpu_torch.config import ModelConfig, TrainConfig
    from eda_tpu_torch.models.grounder import EDAGrounder
    from eda_tpu_torch.train.checkpoint import save_state
    from eda_tpu_torch.train.optim import AdamW
    from eda_tpu_torch.train.step import TrainState

    directory.mkdir(parents=True, exist_ok=True)
    model = EDAGrounder(ModelConfig(use_bf16=True).tiny())
    with np.load(weights) as f:
        model.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files})
    save_state(str(directory / "epoch_0.pt"), TrainState(model, AdamW(model, TrainConfig(), 3)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--out", default="logs/dp_scaling")
    args = p.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        print(f"dp_scaling takes {args.ranks} CUDA cards", file=sys.stderr)
        return 1
    if EVAL_BATCH % args.ranks:
        raise SystemExit(f"{EVAL_BATCH} eval scenes a batch do not split over {args.ranks}")
    out = (ROOT / args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    print(card_line(), flush=True)

    from eda_tpu_torch import entry
    from eda_tpu_torch.ops.cuda import build

    t = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    entry.dryrun_multichip(args.ranks)
    print(f"dryrun_multichip: {time.perf_counter() - t:.1f} s", flush=True)

    n = args.ranks
    result = {"card": card_line(), "ranks": n, "batch_a_card": BATCH}
    for name, ranks in ((f"train{n}", n), ("train1", 1)):
        run(name, train_cmd(ranks, BATCH * ranks, STEPS, out / name), out)
        rows = rows_of(out / name, "train")
        result[name] = dict(after_warmup=rate(rows, WARMUP), from_first=rate(rows, 1),
                            losses=[r["loss"] for r in rows])
        for window in ("after_warmup", "from_first"):
            r = result[name][window]
            r["scenes_per_s"] = r["steps_per_s"] * BATCH * ranks
    one, many = result["train1"]["after_warmup"], result[f"train{n}"]["after_warmup"]
    result["speedup"] = many["scenes_per_s"] / one["scenes_per_s"]
    result["per_card"] = result["speedup"] / n

    write_converged(WEIGHTS, out / "converged")
    records = {}
    for name, ranks, batch in ((f"eval{n}", n, EVAL_BATCH),
                               ("eval1_rank_rows", 1, EVAL_BATCH // n),
                               ("eval1", 1, EVAL_BATCH)):
        run(name, eval_cmd(ranks, batch, out / "converged", out / name), out)
        (rec,) = rows_of(out / name, "val")
        records[name] = {k: v for k, v in rec.items() if k not in ("step", "time")}
    result["eval"] = records[f"eval{n}"]
    result["eval_equals_one_card_at_rank_rows"] = records[f"eval{n}"] == records["eval1_rank_rows"]
    result["eval_equals_one_card_at_eval_batch"] = records[f"eval{n}"] == records["eval1"]
    result["eval1_differs_in"] = sorted(k for k in records["eval1"]
                                        if records["eval1"][k] != records[f"eval{n}"][k])
    print(json.dumps(result))
    if not result["eval_equals_one_card_at_rank_rows"]:
        print(f"{n} ranks do not count what one card counts on a rank's rows", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
