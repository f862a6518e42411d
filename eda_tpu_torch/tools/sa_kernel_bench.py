"""Latency of the fused SA pair kernels at production shapes, layer by layer.

Counterpart of ``eda_tpu/tools/sa_kernel_bench.py``: ``--inner`` chained
calls of one kernel, each call's input moved by a value of the last call's
output, timed together with CUDA events after one warm-up; the median over
``max(iters // inner, 3)`` repetitions, divided by ``inner``. The calls queue
up behind a device sleep, so that the card runs them back to back and the
host's time per call (the wrappers' Python) does not pass for device time,
as the JAX tool's calls inside one ``jit`` do not. It times the
pair pool with winner export (K4, the training forward; ``--no-winners``
the serving pool K3) or, with ``--bwd``, the pool backward (K5 where the
model picks the compact variant, SA1, else K6), under the radius test
``EDA_SA_D2`` selects (``pair`` by default).

Inputs (``make_inputs``): by default a uniform cloud Morton-sorted at 1.5 r
with evenly spaced center ranks; with ``--scenes`` the bench's synthetic
scenes and the backbone's own FPS chain down to the layer
(``utils/flops.sa_chain``). Random A, b_c and weights from ``seed``.

Runs on CUDA unless ``--device cpu`` is given (the kernels' plain versions,
timed on the host clock).

Usage:
    python -m eda_tpu_torch.tools.sa_kernel_bench --layer sa1 --batch 32
    python -m eda_tpu_torch.tools.sa_kernel_bench --layer sa1 --batch 32 --bwd
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, sa_pair_pool, sa_pair_pool_winners
from eda_tpu_torch.ops.cuda.sa_pool_bwd import compact_backward, sa_pool_bwd
from eda_tpu_torch.ops.fused_sa import morton_keys

SLEEP_CYCLES = 50_000_000  # ~25 ms of device sleep ahead of each timed repetition

# production SA layer shapes (ModelConfig defaults: N=50000, npoints / radii /
# mlps of the backbone, sa_windows=(1024, 256, 256, 256))
LAYERS = {
    # name: (N, M, radius, window, c_in (A's c1), widths)
    "sa1": (50000, 2048, 0.2, 1024, 64, (64, 64, 128)),
    "sa2": (2048, 1024, 0.4, 256, 128, (128, 128, 256)),
    "sa3": (1024, 512, 0.8, 256, 128, (128, 128, 256)),
    "sa4": (512, 256, 1.2, 256, 128, (128, 128, 256)),
}


def make_inputs(layer: str, B: int, seed: int = 0, scenes: bool = False, device="cpu"):
    """(A, xyz, b_c, cen, starts, (w2, b2, s2, lb2, w3, b3), kwargs) of one
    ``layer`` call at batch ``B`` on ``device``: A and b_c in bf16, the
    centers in rank order, the windows' starts from 16-center blocks."""
    N, M, radius, W, c1, widths = LAYERS[layer]
    rng = np.random.default_rng(seed)
    if scenes:
        from eda_tpu_torch.config import ModelConfig
        from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
        from eda_tpu_torch.utils.flops import sa_chain

        cfg = ModelConfig()
        gen = SyntheticScenes(
            SyntheticConfig(num_points=cfg.num_points, num_objects=8, text_len=64,
                            max_objects=cfg.max_detected_boxes),
            vocab_size=cfg.text_vocab_size,
        )
        pcs = np.stack([gen.scene(i)["point_clouds"][:, :3] for i in range(B)])
        want = int(layer[-1]) - 1
        for li, (g, layer_xyz, layer_ranks) in enumerate(
                sa_chain(pcs, cfg, max_scenes=B, device=device)):
            if li == want:
                if (g.n, g.m, g.w) != (N, M, W):
                    raise ValueError(f"{layer}: the backbone's geometry {g} is not {LAYERS[layer]}")
                xyz, ranks = layer_xyz, layer_ranks.astype(np.int64)
                break
    else:
        xyz = rng.uniform(0, 5.0, (B, N, 3)).astype(np.float32)
        keys = morton_keys(torch.from_numpy(xyz), radius * 1.5).numpy()
        xyz = np.take_along_axis(xyz, np.argsort(keys, axis=1, kind="stable")[..., None], 1)
        # evenly spaced ranks approximate FPS coverage of the sorted cloud
        ranks = np.round(np.linspace(0, N - 1, M)).astype(np.int64)[None].repeat(B, 0)
    A = rng.normal(size=(B, N, c1)).astype(np.float32)
    cen = np.take_along_axis(xyz, ranks[..., None], 1)
    b_c = rng.normal(size=(B, M, c1)).astype(np.float32)
    mids = ranks.reshape(B, M // BLOCK, BLOCK)[:, :, BLOCK // 2]
    starts = np.clip(mids - W // 2, 0, N - W).astype(np.int32)
    weights = []
    for ci, co in zip(widths[:-1], widths[1:]):
        k = rng.normal(size=(ci, co)).astype(np.float32) / np.sqrt(ci)
        weights += [k, rng.normal(size=co).astype(np.float32)]
        if len(weights) == 2:  # the interior layer's LayerNorm
            weights += [np.ones(co, np.float32), np.zeros(co, np.float32)]

    def t(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)

    return (t(A, torch.bfloat16), t(xyz), t(b_c, torch.bfloat16), t(cen), t(starts),
            tuple(t(w) for w in weights), dict(radius=radius, window=W))


def _median_ms(fn, iters: int, inner: int, device) -> float:
    """Median ms of one of ``inner`` chained calls of ``fn(i)`` over the repetitions."""
    cuda = device.type == "cuda"
    fn(0)
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(max(iters // inner, 3)):
        if cuda:
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
        t0 = time.perf_counter()
        for i in range(inner):
            fn(i)
        if cuda:
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times) / inner


def bench_fwd(layer: str, B: int, iters: int, inner: int, with_winners: bool = True,
              scenes: bool = False, device="cpu") -> float:
    """ms per call of the pair pool (K4, or K3 without winners)."""
    device = torch.device(device)
    A, xyz, b_c, cen, starts, params, kw = make_inputs(layer, B, scenes=scenes, device=device)
    pool = sa_pair_pool_winners if with_winners else sa_pair_pool
    state = {"a": A}

    def call(_):
        out = pool(state["a"], xyz, b_c, cen, starts, *params, **kw)
        out = out[0] if with_winners else out
        state["a"] = state["a"] + (out[0, 0].sum() * 1e-24).to(A.dtype)

    return _median_ms(call, iters, inner, device)


def bench_bwd(layer: str, B: int, iters: int, inner: int, compact: bool | None = None,
              scenes: bool = False, device="cpu") -> float:
    """ms per call of the pool backward (compact where the model picks it)."""
    device = torch.device(device)
    A, xyz, b_c, cen, starts, params, kw = make_inputs(layer, B, scenes=scenes, device=device)
    out, winners = sa_pair_pool_winners(A, xyz, b_c, cen, starts, *params, **kw)
    w2, b2, s2, lb2, w3, _ = params
    if compact is None:
        compact = compact_backward(kw["window"], w3.shape[1])
    state = {"g": torch.where(out > -1e8, 1.0, 0.0)}

    def call(_):
        dA, dbc, *_ = sa_pool_bwd(A, b_c, state["g"], winners, starts, w2, b2, s2, lb2, w3,
                                  window=kw["window"], compact=compact)
        state["g"] = state["g"] + dbc[0, 0].sum() * 1e-24

    return _median_ms(call, iters, inner, device)


def main(argv=None) -> int:
    from eda_tpu_torch.bench import card_line
    from eda_tpu_torch.entry import resolve_device

    p = argparse.ArgumentParser("eda_tpu_torch.tools.sa_kernel_bench")
    p.add_argument("--layer", default="sa1", choices=sorted(LAYERS))
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--inner", type=int, default=4)
    p.add_argument("--bwd", action="store_true")
    p.add_argument("--no-winners", action="store_true")
    p.add_argument("--scenes", action="store_true",
                   help="the bench's synthetic scenes and the backbone's FPS chain instead of "
                        "a uniform cloud and evenly spaced ranks")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line())
    if args.bwd:
        dt = bench_bwd(args.layer, args.batch, args.iters, args.inner, scenes=args.scenes,
                       device=device)
        kind = "bwd"
    else:
        dt = bench_fwd(args.layer, args.batch, args.iters, args.inner,
                       with_winners=not args.no_winners, scenes=args.scenes, device=device)
        kind = "fwd" + ("" if not args.no_winners else "_nowin")
    print(f"{args.layer} {kind} B={args.batch}: {dt:.4f} ms/call ({device.type})")
    if not args.scenes:
        print("note: a uniform cloud and evenly spaced center ranks only approximate the "
              "in-radius density of FPS over scenes (pass --scenes for the bench's scene "
              "geometry)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
