"""Device time of the f32 prep forward (K2f) at the width-2 backbone's SA2-4 widths.

Seeded random inputs at batch 8's rows of ``ModelConfig()`` with the width-2
SA widths (SA2 16 384 x 259, SA3 8 192 x 515, SA4 4 096 x 515, c1 256), each
call timed with CUDA events (``--reps`` launches queued behind a device sleep,
after one warm-up) and profiled once for its launches by name; each reports its
route (``sa_prep.f32_forward_route``), its largest error against the plain
version and whether a second launch gave A bit for bit; ``--in_dim`` puts every
layer at another in_dim (the time against the K steps, 32 in_dim a step). It
builds only the f32
prep's library, not the model (``tools/pool_bwd_times.py --kernels
prep_f32_w2x`` times the model's own calls). Prints one JSON line with the
card's name and power limit; without CUDA it exits non-zero:

    python -m eda_tpu_torch.tools.prep_f32_times
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

# (layer, rows at batch 8, in_dim): the width-2 backbone's SA2-4 at c1 256
W2X_F32_FORWARDS = (("SA2", 8 * 2048, 259), ("SA3", 8 * 1024, 515), ("SA4", 8 * 512, 515))
C1 = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--in_dim", type=int, default=0, help="every layer's in_dim (0: the model's)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prep_f32_times: no CUDA device", file=sys.stderr)
        return 1
    from eda_tpu_torch.bench import card_line
    from eda_tpu_torch.ops.cuda import sa_prep
    from eda_tpu_torch.tools.pool_bwd_times import cuda_ms, split_ms

    g = torch.Generator().manual_seed(args.seed)
    f32 = dict(compute_dtype=torch.float32, radius=0.8)
    layers = []
    for layer, rows, in_dim in W2X_F32_FORWARDS:
        in_dim = args.in_dim or in_dim
        pts = torch.randn(8, rows // 8, in_dim, generator=g).cuda()
        w1 = (torch.randn(in_dim, C1, generator=g) * in_dim ** -0.5).cuda()
        b1, lnb = (0.1 * torch.randn(2, C1, generator=g)).cuda()
        scale = (1 + 0.1 * torch.randn(C1, generator=g)).cuda()
        call = (pts, w1, b1, scale, lnb)
        got, again = sa_prep.sa_prep(*call, **f32), sa_prep.sa_prep(*call, **f32)
        want = sa_prep.sa_prep_plain(*call, **f32)
        layers.append({
            "layer": layer, "rows": rows, "in_dim": in_dim,
            "route": sa_prep.f32_forward_route(rows, in_dim, C1),
            "ms": cuda_ms(lambda: sa_prep.sa_prep(*call, **f32), args.reps),
            "split_ms": split_ms(lambda: sa_prep.sa_prep(*call, **f32)),
            "max_abs_err": (got - want).abs().max().item(),
            "bit_identical_repeat": torch.equal(got, again),
        })
    print(json.dumps({"label": args.label, "card": card_line(), "layers": layers,
                      "ms": sum(x["ms"] for x in layers)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
