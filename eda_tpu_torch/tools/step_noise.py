"""How far the tiny training step on the card lies from its CPU twin, and what moves it.

One tiny training step (``ModelConfig.tiny()`` at the widths ``--widths``
names, dropout off, batch 2, seed 1, as ``chip_smoke.small_train_check``
runs it) on the CPU, where every kernel wrapper runs its plain version, and on
the card on the CPU run's KPS indices and matches, once with the kernels and
once with each group of wrappers swapped for its plain version on the card
(the pools, the pool backward, the prep backward, all of them). Each line
gives the gradient's global cosine against the CPU step (AdamW's first
moments, as the smoke compares them) and ``grad_norm``. Then the CPU step
against itself with every pooled value moved by up to ``--noise`` of itself
(the pool kernels round h1 to bf16 after sums in another order: one bf16
step, 2^-8, moves a pooled value by as much), ``--draws`` times: the model's
own sensitivity, against which the card's distance is read.

Prints one JSON line a run, with the card's name and power limit; without
CUDA it exits non-zero, printing nothing:

    python -m eda_tpu_torch.tools.step_noise --widths w4x --f32
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

# the wrapper groups swapped for their plain versions on the card, by fused_sa name
PLAIN = {"kernels": (), "plain pools": ("sa_pair_pool_winners",),
         "plain pool backward": ("sa_pool_bwd",), "plain prep backward": ("sa_prep_bwd",),
         "all plain": ("sa_pair_pool_winners", "sa_pool_bwd", "sa_prep", "sa_prep_bwd")}


def tiny_config(widths: str, f32: bool):
    """The tiny config, dropout off, at the SA and FP widths of ``widths``
    (``tools/pool_bwd_times.WIDTHS``), FP2 out the tiny d_model."""
    from eda_tpu_torch.config import ModelConfig
    from eda_tpu_torch.tools.pool_bwd_times import WIDTHS

    cfg = dataclasses.replace(ModelConfig(use_bf16=not f32).tiny(), dropout=0.0)
    if WIDTHS[widths] is None:
        return cfg
    sa_mlps, fp_mlps = WIDTHS[widths]
    return dataclasses.replace(cfg, sa_mlps=sa_mlps,
                               fp_mlps=(fp_mlps[0], (fp_mlps[1][0], cfg.d_model)))


def first_moments(state) -> dict:
    names = {p: n for n, p in state.model.named_parameters()}
    return {names[p]: mu.cpu() for p, (mu, _) in state.optimizer.moments.items()}


def global_cos(got: dict, want: dict) -> float:
    keys = sorted(want)
    a = torch.cat([got[k].flatten() for k in keys]).double()
    b = torch.cat([want[k].flatten() for k in keys]).double()
    return float(a @ b / (a.norm() * b.norm() + 1e-300))


def step_moments(cfg, device: str, swaps: dict, chosen: dict):
    """One tiny step of ``cfg`` on ``device`` with ``fused_sa``'s functions
    ``swaps`` (name -> replacement) in place; it records its KPS indices and
    matches into an empty ``chosen`` and replays those of a full one. Returns
    (AdamW's first moments by parameter name, the step's metrics)."""
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.losses import criterion
    from eda_tpu_torch.models import grounder
    from eda_tpu_torch.models.layers import Dropout
    from eda_tpu_torch.ops import fused_sa

    state, step, batch = build_trainer(cfg, batch_size=2, device=device, seed=1)
    for m in state.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0

    def record(fn, key):
        def wrapped(*a, **k):
            chosen[key] = fn(*a, **k)
            return chosen[key]
        return wrapped

    if chosen:
        kps, match = chosen["kps"], chosen["match"]
        decisions = {
            (grounder, "top_k_indices"): lambda logits, k: kps.to(device),
            (criterion, "hungarian_match"): lambda *a, **k: type(match)(
                *(t.to(device) for t in match))}
    else:
        decisions = {(grounder, "top_k_indices"): record(grounder.top_k_indices, "kps"),
                     (criterion, "hungarian_match"): record(criterion.hungarian_match, "match")}
    patches = {**{(fused_sa, n): fn for n, fn in swaps.items()}, **decisions}
    saved = {key: getattr(*key) for key in patches}
    for (mod, name), fn in patches.items():
        setattr(mod, name, fn)
    try:
        metrics = {k: float(v) for k, v in step(state, batch).items()}
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return first_moments(state), metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", choices=("flagship", "w2x", "w4x"), default="w4x")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--noise", type=float, default=2.0 ** -8)
    ap.add_argument("--draws", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_noise: no CUDA device", file=sys.stderr)
        return 1
    from eda_tpu_torch.bench import card_line
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import sa_kernel, sa_pool_bwd, sa_prep

    plain = {"sa_pair_pool_winners": sa_kernel.sa_pair_pool_winners_plain,
             "sa_pool_bwd": sa_pool_bwd.sa_pool_bwd_plain, "sa_prep": sa_prep.sa_prep_plain,
             "sa_prep_bwd": sa_prep.sa_prep_bwd_plain}
    cfg = tiny_config(args.widths, args.f32)
    chosen: dict = {}
    want, want_m = step_moments(cfg, "cpu", {}, chosen)
    base = {"card": card_line(), "widths": args.widths, "f32": args.f32,
            "cpu_grad_norm": want_m["grad_norm"]}
    for variant, names in PLAIN.items():
        got, got_m = step_moments(cfg, "cuda", {n: plain[n] for n in names}, chosen)
        print(json.dumps({**base, "run": variant, "global_cos": global_cos(got, want),
                          "grad_norm": got_m["grad_norm"]}), flush=True)
        torch.cuda.empty_cache()
    for draw in range(args.draws):
        gen = torch.Generator().manual_seed(100 + draw)

        def moved_pool(*a, _pool=fused_sa.sa_pair_pool_winners, **k):
            values, winners = _pool(*a, **k)
            shift = (torch.rand(values.shape, generator=gen) * 2 - 1) * args.noise
            return values * (1 + shift), winners

        got, got_m = step_moments(cfg, "cpu", {"sa_pair_pool_winners": moved_pool}, chosen)
        print(json.dumps({**base, "run": f"cpu, pooled values moved by {args.noise:.3g}",
                          "draw": draw, "global_cos": global_cos(got, want),
                          "grad_norm": got_m["grad_norm"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
