"""Smoke run of the PyTorch port on one NVIDIA GPU: serving forward and training step.

Usage: ``python3 chip_smoke.py`` from the repository root (needs one CUDA card).

1. Prints the card's name and power limit and the torch / CUDA versions.
2. Builds every CUDA kernel from ``eda_tpu_torch/csrc`` (one nvcc per source,
   all started at once) and prints the build time.
3. Checks a small grounder (``ModelConfig(use_bf16=True).tiny()``) on the card
   against the same weights and inputs on the CPU, where every kernel wrapper
   runs its plain PyTorch version: the serving forward, then one training step
   with dropout off (loss, metrics, gradients, new parameters).
4. Serving. Records the serving kernels' inputs (K1 FPS, K2 prep, K3 pair
   pool) in one full-width forward (``ModelConfig(use_bf16=True)``, batch 8,
   50 000-point scenes, random weights from a seed) and holds each kernel call
   against its plain version on those inputs: FPS bit-exact, the bf16 prep
   within 0.02 (plus one bf16 step of the value), the pair pool within 0.03
   with identical -1e9 rows; times both with CUDA events, per SA layer. Then
   serves five batches of 8 scenes with every launch counter set to 0 first:
   each batch must advance K1, K2 and K3 by 4 (one launch per SA layer) and
   no training kernel, and give a finite (8, 256, 3) ``last_center``. Prints ms
   per batch and scenes/s, the forward's cost with the attention the port had
   before (``scaled_dot_product_attention``) against the one that rounds where
   flax rounds, the stage times and the busiest device operations.
5. Training. Records the training kernels' inputs (K4 pair pool with winners,
   K5 compact and K6 windowed pair-pool backward, K7 prep backward) in one
   full-width training step at batch 8 and holds each against its plain
   version; times both per SA layer. Then runs five training steps from fresh
   counters: each must give a finite loss and ``grad_norm``, change the
   parameters, and advance K1, K2, K4 and K7 by 4, K5 by 1, K6 by 3 and K3 by
   0. Prints ms per step and scenes/s, the stage times of one step (forward,
   loss, backward, optimizer), the matcher's host syncs and the busiest device
   operations of one step.
6. Prints the per-kernel JSON line, the card line, and as its last line
   ``{"ok": true, "device": {...}}``.

Per kernel, the JSON line's ``ms``, ``plain_ms`` and ``bound_ms`` are sums over
the four SA layers of one batch-8 forward (K1-K3) or training step (K4-K7), and
``launches`` is the count of the serving run (K1-K3) or the training run
(K4-K7). Any failed check raises, and the script exits non-zero. Without CUDA
it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
STEPS = 5
HEAD_ATOL = 0.06      # card (cuBLAS bf16) vs CPU heads, as tests/test_torch_grounder.py

SERVING = ("fps_launch", "sa_prep_launch", "sa_pair_pool_launch")
TRAINING = ("sa_pair_pool_winners_launch", "sa_pool_bwd_compact_launch",
            "sa_pool_bwd_window_launch", "sa_prep_bwd_launch")
# launches per training step of the flagship: compact backward at SA1 only
STEP_LAUNCHES = {"fps_launch": 4, "sa_prep_launch": 4, "sa_pair_pool_launch": 0,
                 "sa_pair_pool_winners_launch": 4, "sa_pool_bwd_compact_launch": 1,
                 "sa_pool_bwd_window_launch": 3, "sa_prep_bwd_launch": 4}
# card vs CPU training step, as tests/test_torch_train_step.py holds the port to
# JAX, but 10% for a single metric: the tiny train-mode step magnifies bf16
# noise (the port against itself, the input moved by 1e-6, moves grad_norm 9%)
LOSS_REL, METRIC_REL = 0.01, 0.10
GLOBAL_COS, LEAF_COS, NORM_RATIO, ZERO_NORM = 0.85, 0.4, 2.0, 2e-3
PARAM_CLOSE, BN_REL = 0.8, 0.01
ZERO_GRAD = ("attn.key.bias", "points_obj_cls.dense.0.bias", "points_obj_cls.dense.1.bias",
             "pos_embed.dense.0.bias", "self_posembed.dense.0.bias")
# kernel vs plain on a real training step, relative to each leaf's largest value:
# the prep backward as tests/test_sa_prep.py (0.02), the pool backward's weight
# gradients as tests/test_sa_kernel_interpret.py (1%); dA and db_c 0.5% (a bf16
# rounding of dx that lands on the other side of a boundary moves an element
# by ~5e-4 of the leaf's largest value)
PREP_BWD_REL, POOL_BWD_W_REL, POOL_BWD_A_REL = 0.02, 0.01, 0.005


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


def timed(fn):
    """(result, host-clock ms) of ``fn()`` between two synchronizes."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


class Recorder:
    """Records the arguments of kernel wrappers the model calls.

    ``targets`` are (module, attribute, symbol) triples; a symbol may be a
    function of the call's keyword arguments (the pool backward's variant).
    """

    def __init__(self, targets):
        self.targets = targets
        self.calls = {}

    def __enter__(self):
        self.saved = []
        for module, name, symbol in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def wrapped(*args, _fn=fn, _symbol=symbol, **kwargs):
                key = _symbol(kwargs) if callable(_symbol) else _symbol
                self.calls.setdefault(key, []).append((args, kwargs))
                return _fn(*args, **kwargs)

            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def bound(ops: float, peak: float, nbytes: float):
    """(least ms, what sets it) for ``ops`` at ``peak`` and ``nbytes`` at HBM rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def fps_bound(args, kw):
    xyz, npoint = args
    B, N, _ = xyz.shape
    ops = B * (npoint - 1) * N * 9  # 3 sub, 3 mul, 2 add, 1 min per point and step
    return bound(ops, PEAK_F32, xyz.numel() * 4 + B * npoint * 4)


def prep_bound(args, kw):
    pts, w1 = args[0], args[1]
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    nb = pts.numel() * 4 + B * N * c1 * 2 + (in_dim + 3) * c1 * 4
    return bound(2 * B * N * in_dim * c1, PEAK_BF16, nb)


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


def pool_bound(args, kw, winners: bool = False):
    A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3 = args
    c1, c2, c3 = A.shape[-1], w2.shape[1], w3.shape[1]
    pairs = in_radius_pairs(xyz, cen, starts, kw["radius"], kw["window"])
    out = b_c.shape[0] * b_c.shape[1] * c3 * (8 if winners else 4)
    nb = nbytes(A, xyz, b_c, cen, starts, b2, s2, lb2, b3) + (w2.numel() + w3.numel()) * 2 + out
    return bound(pairs * 2 * (c1 * c2 + c2 * c3), PEAK_BF16, nb)


def live_rows(args, kw) -> tuple:
    """(pair rows, won channels) the pool backward needs for this run's data."""
    A, b_c, g, winners, starts = args[:5]
    from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, window_starts

    B, N, _ = A.shape
    M = b_c.shape[1]
    live = g != 0
    channels = int(live.sum())
    if kw["compact"]:
        return channels, channels
    start = window_starts(starts.long(), N, kw["window"]).repeat_interleave(BLOCK, dim=1)
    rel = winners.long() - start[..., None]
    live &= (rel >= 0) & (rel < kw["window"])
    center = torch.arange(B * M, device=A.device).view(B, M, 1).expand_as(rel)
    rows = int(torch.unique((center * N + rel)[live]).numel())
    return rows, int(live.sum())


def pool_bwd_bound(args, kw):
    A, b_c, g, winners, starts, w2, b2, s2, lb2, w3 = args
    c1, c2 = w2.shape
    rows, channels = live_rows(args, kw)
    # per row: h0 @ W2, dh0 = dx @ W2^T, dW2 = h0^T dx; per won channel: W3^T and dW3
    ops = rows * 6 * c1 * c2 + channels * 4 * c2
    nb = (nbytes(A, b_c, g, winners, starts, b2, s2, lb2) + (w2.numel() + w3.numel()) * 2
          + A.numel() * 4 + b_c.numel() * 4 + (w2.numel() + w3.numel() + 3 * c2 + w3.shape[1]) * 4)
    return bound(ops, PEAK_BF16, nb)


def prep_bwd_bound(args, kw):
    pts, dA, w1 = args[0], args[1], args[2]
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    # recompute x, dpts = dx @ W1^T, dW1 = pts^T dx: three (B*N, in_dim, c1) products
    nb = pts.numel() * 4 + dA.numel() * 2 + pts.numel() * 4 + (3 * in_dim + 5) * c1 * 4
    return bound(6 * B * N * in_dim * c1, PEAK_BF16, nb)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-30))


def abs_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_kernel(symbol: str, got, want, layer: int) -> float:
    """Max abs error of a kernel result against its plain version; raises past
    tolerance: absolute for K1-K4 (as their CPU tests), relative to each
    leaf's largest value for the backward kernels."""
    if symbol == "fps_launch":
        if not torch.equal(got, want):
            raise AssertionError(f"FPS kernel differs from its plain version at SA{layer}")
        return 0.0
    if symbol == "sa_prep_launch":
        g, w = got.float(), want.float()
        err = (g - w).abs().max().item()
        # 0.02, plus one bf16 step (2^-7 relative) where the LN output is large
        if not ((g - w).abs() <= 0.02 + w.abs() * 2.0 ** -7).all():
            raise AssertionError(f"prep kernel off its plain version at SA{layer}: {err}")
        return err
    if symbol in ("sa_pair_pool_launch", "sa_pair_pool_winners_launch"):
        if symbol == "sa_pair_pool_winners_launch":
            (got, got_win), (want, want_win, second) = got, want
            # the two sides round h1 to bf16 after f32 sums in other orders, so a
            # pooled value moves by up to the largest value error: a winner is
            # decided where the best two values are further apart than twice that
            separated = (want - second) > 2 * abs_err(got, want) + 1e-6
            if not torch.equal(got_win[separated], want_win[separated]):
                raise AssertionError(f"pool winners differ from the plain version at SA{layer}")
            print(f"  SA{layer} winners equal on {int(separated.sum())} of {separated.numel()} "
                  f"(center, channel) pairs whose best two values differ; "
                  f"{int((got_win == want_win).sum())} equal in all")
        if not torch.equal(got < -1e8, want < -1e8):
            raise AssertionError(f"pool kernel -1e9 rows differ at SA{layer}")
        err = abs_err(got, want)
        if err > 0.03:
            raise AssertionError(f"pool kernel off its plain version at SA{layer}: {err}")
        return err
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    print(f"  SA{layer} errors relative to each output's largest value: "
          f"{[f'{e:.2e}' for e in errs]}")
    if symbol == "sa_prep_bwd_launch":  # dpts, dW1, db1, dscale, dlnb
        if max(errs) > PREP_BWD_REL:
            raise AssertionError(f"prep backward off its plain version at SA{layer}: {errs}")
    elif max(errs[:2]) > POOL_BWD_A_REL or max(errs[2:]) > POOL_BWD_W_REL:
        # dA, db_c | dW2, db2, ds2, dlb2, dW3, db3
        raise AssertionError(f"pool backward off its plain version at SA{layer}: {errs}")
    return max(abs_err(g, w) for g, w in zip(got, want))


def kernel_specs():
    from eda_tpu_torch.ops.cuda import fps, sa_kernel, sa_pool_bwd, sa_prep

    bwd = (sa_pool_bwd.sa_pool_bwd, sa_pool_bwd.sa_pool_bwd_plain)
    return {
        "fps_launch": ("fps", fps.fps, fps.fps_plain, fps_bound, 20),
        "sa_prep_launch": ("sa_prep", sa_prep.sa_prep, sa_prep.sa_prep_plain, prep_bound, 20),
        "sa_pair_pool_launch": ("sa_pair_pool", sa_kernel.sa_pair_pool,
                                sa_kernel.sa_pair_pool_plain, pool_bound, 5),
        "sa_pair_pool_winners_launch": (
            "sa_pair_pool_winners", sa_kernel.sa_pair_pool_winners,
            lambda *a, **k: sa_kernel.sa_pair_pool_winners_plain(*a, runner_up=True, **k),
            lambda a, k: pool_bound(a, k, winners=True), 5),
        "sa_pool_bwd_compact_launch": ("sa_pool_bwd_compact", *bwd, pool_bwd_bound, 5),
        "sa_pool_bwd_window_launch": ("sa_pool_bwd_window", *bwd, pool_bwd_bound, 5),
        "sa_prep_bwd_launch": ("sa_prep_bwd", sa_prep.sa_prep_bwd, sa_prep.sa_prep_bwd_plain,
                               prep_bwd_bound, 10),
    }


@torch.no_grad()
def check_kernels(calls, symbols, layers: dict) -> list:
    """Hold every recorded kernel call against its plain version; time both."""
    from eda_tpu_torch.ops.cuda import build

    specs = kernel_specs()
    rows = []
    for symbol in symbols:
        name, kernel_fn, plain_fn, bound_fn, reps = specs[symbol]
        kernel = build.KERNELS[symbol]
        if len(calls.get(symbol, [])) != layers[symbol]:
            raise AssertionError(f"{name}: the run made {len(calls.get(symbol, []))} calls, "
                                 f"not {layers[symbol]}")
        total = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        bound_ops = bound_bytes = 0.0
        for i, (args, kw) in enumerate(calls[symbol]):
            # the backward runs the layers last to first
            backward = symbol in ("sa_pool_bwd_window_launch", "sa_prep_bwd_launch")
            layer = 4 - i if backward else i + 1
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            torch.cuda.synchronize()
            err = check_kernel(symbol, got, want, layer)
            del got, want
            ms = cuda_ms(lambda: kernel_fn(*args, **kw), reps)
            plain_ms = cuda_ms(lambda: plain_fn(*args, **kw), 1)
            bound_ms, by = bound_fn(args, kw)
            bound_ops += bound_ms if by == "operations" else 0.0
            bound_bytes += bound_ms if by == "bytes" else 0.0
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)][:2]
            print(f"kernel {name} SA{layer} {shapes}: max_err {err} ms {ms:.4f} "
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
    from eda_tpu_torch.entry import build as build_model

    cfg = root_cfg.tiny()
    cfg = dataclasses.replace(cfg, num_queries=cfg.sa_npoints[1])
    gpu_model, gpu_in = build_model(cfg, batch_size=2, device="cuda", seed=1)
    cpu_model, cpu_in = build_model(cfg, batch_size=2, device="cpu", seed=1)
    with torch.inference_mode():
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


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-300))


def small_train_check(root_cfg) -> None:
    """One tiny training step on the card against its CPU twin, dropout off.

    The CPU run's KPS indices and matches are handed to the card run (the
    discrete choices that near-ties make noise-sensitive), and the tolerances
    are those ``tests/test_torch_train_step.py`` holds the port to JAX with.
    """
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.losses import criterion
    from eda_tpu_torch.models import grounder
    from eda_tpu_torch.models.layers import Dropout
    from eda_tpu_torch.train.optim import group_of

    cfg = dataclasses.replace(root_cfg.tiny(), dropout=0.0)
    cpu, step, cpu_batch = build_trainer(cfg, batch_size=2, device="cpu", seed=1)
    gpu, _, gpu_batch = build_trainer(cfg, batch_size=2, device="cuda", seed=1)
    for state in (cpu, gpu):
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    chosen = {}

    def record(fn, key):
        def wrapped(*a, **k):
            chosen[key] = fn(*a, **k)
            return chosen[key]
        return wrapped

    def replay(key):
        def lookup(*a, **k):
            v = chosen[key]
            return v.cuda() if key == "kps" else type(v)(*(t.cuda() for t in v))
        return lookup

    with patched(grounder, "top_k_indices", record(grounder.top_k_indices, "kps")), \
            patched(criterion, "hungarian_match", record(criterion.hungarian_match, "match")):
        want = {k: float(v) for k, v in step(cpu, cpu_batch).items()}
    with patched(grounder, "top_k_indices", replay("kps")), \
            patched(criterion, "hungarian_match", replay("match")):
        got = {k: float(v) for k, v in step(gpu, gpu_batch).items()}
    if not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"tiny train step on the card: non-finite metrics {got}")
    worst, worst_key = max((abs(got[k] - w) / (abs(w) + 1e-6), k) for k, w in want.items())
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    names = {p: n for n, p in cpu.model.named_parameters()}
    gnames = {p: n for n, p in gpu.model.named_parameters()}
    mu_cpu = {names[p]: mu for p, (mu, _) in cpu.optimizer.moments.items()}
    mu_gpu = {gnames[p]: mu.cpu() for p, (mu, _) in gpu.optimizer.moments.items()}
    keys = sorted(mu_cpu)
    glob = _cos(torch.cat([mu_gpu[k].flatten() for k in keys]),
                torch.cat([mu_cpu[k].flatten() for k in keys]))
    largest = max(float(v.norm()) for v in mu_cpu.values())
    bad = []
    for k in keys:
        g, w = mu_gpu[k], mu_cpu[k]
        if k.endswith(ZERO_GRAD):
            if max(float(g.norm()), float(w.norm())) >= ZERO_NORM * largest:
                bad.append(k)
        elif (_cos(g, w) < LEAF_COS
              or not 1 / NORM_RATIO <= float(g.norm() / w.norm()) <= NORM_RATIO):
            bad.append(k)
    lrs = {"main": cpu.optimizer.cfg.lr, "backbone": cpu.optimizer.cfg.lr_backbone, "text": 0.0}
    cstate, gstate = cpu.model.state_dict(), gpu.model.state_dict()
    close = total = 0
    bn_err = 0.0
    for k, w in cstate.items():
        g = gstate[k].cpu().float()
        if k.endswith(("running_mean", "running_var")):
            bn_err = max(bn_err, rel_err(g, w))
            continue
        lr = lrs[group_of(k)]
        diff = (g - w.float()).abs()
        if lr == 0.0:
            if not torch.equal(g, w.float()):
                bad.append(k)
            continue
        if diff.max() > 2 * lr * (1 + 1e-3) + 1e-6 * w.abs().max():
            bad.append(k)
        close += int((diff <= 0.1 * lr).sum())
        total += diff.numel()
    print(f"tiny train step card vs CPU: loss {got['loss']:.5f} vs {want['loss']:.5f}, "
          f"grad_norm {got['grad_norm']:.4f} vs {want['grad_norm']:.4f}, worst metric rel "
          f"{worst:.4f} ({worst_key}), gradient global cos {glob:.4f}, params within 0.1 lr "
          f"{close / total:.4f}, BN stats rel {bn_err:.5f}")
    if (loss_err > LOSS_REL or worst > METRIC_REL or glob < GLOBAL_COS or bad
            or close < PARAM_CLOSE * total or bn_err > BN_REL):
        raise AssertionError(f"tiny train step on the card is off its CPU twin; leaves {bad}")


def stage_times(model, batch) -> dict:
    """Host-clock ms of the forward's stages, each ended by a synchronize."""
    with torch.inference_mode():
        _, backbone = timed(lambda: model.backbone_net(batch["point_clouds"]))
        _, text = timed(lambda: model.text_encoder(batch["text_ids"], batch["text_mask"].bool()))
        _, whole = timed(lambda: model(batch))
    return {"backbone": backbone, "text_encoder": text, "whole": whole,
            "rest": whole - backbone - text}


def profile(fn, label: str) -> None:
    """Device time by operation and the device's busy share over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    # device-side events only (kernels, copies): a host op's device time
    # repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; profiler on)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms  calls {e.count:5d}  "
              f"{e.key[:90]}")


def sdpa_attention(self, q, k, v, key_valid=None):
    """The port's attention before it rounded where flax rounds: one
    ``scaled_dot_product_attention`` call (the yardstick of its cost)."""
    import torch.nn.functional as F

    B, Lq, d = q.shape
    h = self.n_heads
    dh = d // h
    qh = self.query(q).view(B, Lq, h, dh).transpose(1, 2)
    kh = self.key(k).view(B, k.shape[1], h, dh).transpose(1, 2)
    vh = self.value(v).view(B, v.shape[1], h, dh).transpose(1, 2)
    qh = qh / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(self.dtype)
    mask = None if key_valid is None else key_valid[:, None, None, :].bool()
    x = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)
    return self.out(x.transpose(1, 2).reshape(B, Lq, d))


def attention_cost(model, batch) -> None:
    """Serving forward with the rounding attention and with SDPA, in turns A B B A."""
    from eda_tpu_torch.models import layers

    times = {"rounded": [], "sdpa": []}
    with torch.inference_mode():
        for which in ("rounded", "sdpa", "sdpa", "rounded"):
            fwd = sdpa_attention if which == "sdpa" else layers.MultiHeadAttention.forward
            with patched(layers.MultiHeadAttention, "forward", fwd):
                for _ in range(2):
                    times[which].append(timed(lambda: model(batch))[1])
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"serving forward by attention (ms per batch, median of 4, turns A B B A): "
          f"rounded as flax {med['rounded']:.2f}, scaled_dot_product_attention "
          f"{med['sdpa']:.2f}, cost {med['rounded'] - med['sdpa']:+.2f} ms")


def serving_phase(cfg):
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import make_batch
    from eda_tpu_torch.ops import fused_sa, pointops
    from eda_tpu_torch.ops.cuda import build

    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder([(pointops, "furthest_point_sample", "fps_launch"),
                   (fused_sa, "sa_prep", "sa_prep_launch"),
                   (fused_sa, "sa_pair_pool", "sa_pair_pool_launch")]) as rec:
        with torch.inference_mode():
            model(inputs)
    torch.cuda.synchronize()
    rows = check_kernels(rec.calls, SERVING, {s: 4 for s in SERVING})
    del rec

    batches = [inputs] + [make_batch(cfg, range(BATCH * i, BATCH * (i + 1)), "cuda")
                          for i in range(1, REQUESTS)]
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    with torch.inference_mode():
        for i, batch in enumerate(batches):
            before = {s: k.launches for s, k in build.KERNELS.items()}
            out, ms = timed(lambda: model(batch)["last_center"])
            times.append(ms)
            if out.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"request {i}: bad last_center {tuple(out.shape)}")
            for symbol, kernel in build.KERNELS.items():
                want = 4 if symbol in SERVING else 0
                if kernel.launches - before[symbol] != want:
                    raise AssertionError(f"request {i}: {symbol} launched "
                                         f"{kernel.launches - before[symbol]} times, not {want}")
            print(f"request {i}: {BATCH} scenes in {ms:.2f} ms, last_center finite")
    launches = {s: k.launches for s, k in build.KERNELS.items()}
    steady = statistics.median(times[1:])
    print(f"serving forward, batch {BATCH}: {steady:.2f} ms per batch, "
          f"{1e3 * BATCH / steady:.2f} scenes/s (median of requests 1-{REQUESTS - 1}; "
          f"request 0 {times[0]:.2f} ms)")
    attention_cost(model, batches[-1])
    print(f"stage ms of one batch: {stage_times(model, batches[-1])}")
    with torch.inference_mode():
        profile(lambda: model(batches[-1]), "serving forward")
    return rows, launches


def train_phase(cfg):
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.losses import criterion, matcher
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build

    state, step, batch = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    bwd = lambda kw: ("sa_pool_bwd_compact_launch" if kw["compact"]  # noqa: E731
                      else "sa_pool_bwd_window_launch")
    with Recorder([(fused_sa, "sa_pair_pool_winners", "sa_pair_pool_winners_launch"),
                   (fused_sa, "sa_pool_bwd", bwd),
                   (fused_sa, "sa_prep_bwd", "sa_prep_bwd_launch")]) as rec:
        step(state, batch)
    torch.cuda.synchronize()
    layers = {"sa_pair_pool_winners_launch": 4, "sa_pool_bwd_compact_launch": 1,
              "sa_pool_bwd_window_launch": 3, "sa_prep_bwd_launch": 4}
    rows = check_kernels(rec.calls, TRAINING, layers)
    del rec

    trained = [p for n, p in state.model.named_parameters() if not n.startswith("text_encoder")]
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    matcher.HOST_SYNCS = 0
    times = []
    for i in range(STEPS):
        before = {s: k.launches for s, k in build.KERNELS.items()}
        old = [p.detach().clone() for p in trained]
        metrics, ms = timed(lambda: step(state, batch))
        times.append(ms)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"step {i}: loss {loss}, grad_norm {norm}")
        changed = sum(not torch.equal(o, p) for o, p in zip(old, trained))
        if changed < 0.9 * len(trained):
            raise AssertionError(f"step {i}: only {changed} of {len(trained)} parameters changed")
        for symbol, kernel in build.KERNELS.items():
            if kernel.launches - before[symbol] != STEP_LAUNCHES[symbol]:
                raise AssertionError(f"step {i}: {symbol} launched "
                                     f"{kernel.launches - before[symbol]} times, "
                                     f"not {STEP_LAUNCHES[symbol]}")
        print(f"step {i}: {BATCH} scenes in {ms:.2f} ms, loss {loss:.4f}, grad_norm {norm:.4f}, "
              f"{changed} of {len(trained)} parameters changed")
    launches = {s: k.launches for s, k in build.KERNELS.items()}
    steady = statistics.median(times[1:])
    print(f"training step, batch {BATCH}: {steady:.2f} ms per step, "
          f"{1e3 * BATCH / steady:.2f} scenes/s (median of steps 1-{STEPS - 1}; "
          f"step 0 {times[0]:.2f} ms); matcher host syncs {matcher.HOST_SYNCS} in {STEPS} steps")

    # stage times of one step, each stage ended by a synchronize
    model, opt = state.model, state.optimizer
    model.train()
    ends, t_fwd = timed(lambda: model(batch["inputs"]))
    (loss, _), t_loss = timed(lambda: criterion.compute_hungarian_loss(
        criterion.SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers), ends,
        batch["targets"]))
    opt.zero_grad()
    _, t_bwd = timed(loss.backward)
    _, t_opt = timed(opt.step)
    print(f"stage ms of one training step: forward {t_fwd:.2f}, loss (matching included) "
          f"{t_loss:.2f}, backward {t_bwd:.2f}, optimizer {t_opt:.2f}")
    del ends, loss
    profile(lambda: step(state, batch), "training step")
    return rows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from eda_tpu_torch.config import ModelConfig
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
    small_train_check(cfg)
    serve_rows, serve_launches = serving_phase(cfg)
    torch.cuda.empty_cache()
    train_rows, train_launches = train_phase(cfg)

    rows = serve_rows + train_rows
    for row, symbol in zip(rows, SERVING + TRAINING):
        row["launches"] = (serve_launches if symbol in SERVING else train_launches)[symbol]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was not launched on the main path")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
