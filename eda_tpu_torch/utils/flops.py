"""Analytic FLOP counts and MFU of the grounder (counterpart of ``eda_tpu/utils/flops.py``).

Counts matmul FLOPs (2*m*n*k) of one scene's forward from ``ModelConfig``
alone, component by component, with the JAX package's formulas, so both
packages give the same counts for the same config. Two totals:

* **dense-window FLOPs**: every SA pair stage counted over the whole
  (center x window) grid. On the TPU this is what the kernels execute. The
  port's pair pools skip the (center, 64-point) tiles that hold no pair in
  radius (``csrc/sa_pair_pool.cu``; ``chip_smoke.py`` prints the share
  skipped), so on the card this is NOT the work executed: it is a fixed
  yardstick of the model's size at a given window.
* **in-radius FLOPs**: the same sum with each SA pair stage scaled by the
  layer's measured window occupancy (the share of window slots in radius,
  ``measure_sa_occupancy``): the work a perfectly sparse kernel needs.

``mfu_summary`` divides each by the time and by ``H100_PEAK_BF16_FLOPS``:
``mfu`` over the dense-window count, ``useful_mfu`` over the in-radius count.
Elementwise work (LayerNorm, ReLU, the radius test, the max-pool, FPS,
softmaxes) is not counted, nor the small matmuls the JAX module omits (KPS
objectness over the seeds, learned position embeddings, the box stream, the
loss and the matcher).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

# NVIDIA H100 SXM5 ("NVIDIA H100 80GB HBM3"), dense BF16 tensor-core peak,
# 989.4 TFLOP/s at the 700 W limit: NVIDIA's H100 data sheet (SXM column,
# without sparsity)
H100_PEAK_BF16_FLOPS = 989.4e12
PEAK_NAME = "NVIDIA H100 SXM5 dense bf16 tensor-core peak (NVIDIA H100 data sheet)"


@dataclasses.dataclass
class SALayerGeom:
    n: int        # input points
    m: int        # centers
    w: int        # window actually used (min(window, n); dense => n)
    c_in: int     # feature channels in (excl. xyz)
    mlp: Sequence[int]
    radius: float
    dense: bool


def sa_geometry(cfg) -> List[SALayerGeom]:
    """Per-SA-layer sizes as the fused backbone runs them (each layer's
    centers are the next layer's input cloud)."""
    out = []
    n = cfg.num_points
    c = cfg.input_feature_dim
    for i in range(4):
        w = min(cfg.sa_windows[i], n)
        out.append(SALayerGeom(n=n, m=cfg.sa_npoints[i], w=w, c_in=c,
                               mlp=tuple(cfg.sa_mlps[i]), radius=cfg.sa_radii[i], dense=w >= n))
        n = cfg.sa_npoints[i]
        c = cfg.sa_mlps[i][-1]
    return out


def _mm(m, n, k):
    return 2.0 * m * n * k


def forward_flops(cfg, text_len: int = 64) -> dict:
    """Matmul FLOPs of ONE scene's forward, by component.

    Keys: sa_point (layer-0 per-point projections), sa_pair (the interior
    stages over the dense center x window grid), sa_pair_layers (per layer,
    for occupancy scaling), fp, text, text_proj, encoder, decoder, heads,
    contrastive.
    """
    D, F, V = cfg.d_model, cfg.dim_feedforward, cfg.sa_npoints[1]
    Q, L = cfg.num_queries, text_len
    comp = {}

    sa_point = 0.0
    sa_pair_layers = []
    for g in sa_geometry(cfg):
        c1 = g.mlp[0]
        sa_point += _mm(g.n, c1, 3 + g.c_in) + _mm(g.m, c1, 3)
        pair = 0.0
        prev = c1
        for ch in g.mlp[1:]:
            pair += _mm(g.m * g.w, ch, prev)
            prev = ch
        sa_pair_layers.append(pair)
    comp["sa_point"] = sa_point
    comp["sa_pair"] = float(sum(sa_pair_layers))
    comp["sa_pair_layers"] = [float(x) for x in sa_pair_layers]

    sa_out = [m[-1] for m in cfg.sa_mlps]
    fp = 0.0
    fp_in = sa_out[2] + sa_out[3]
    n_fp1 = cfg.sa_npoints[2]
    for ch in cfg.fp_mlps[0]:
        fp += _mm(n_fp1, ch, fp_in)
        fp_in = ch
    fp_in = sa_out[1] + cfg.fp_mlps[0][-1]
    n_fp2 = cfg.sa_npoints[1]
    for ch in cfg.fp_mlps[1]:
        fp += _mm(n_fp2, ch, fp_in)
        fp_in = ch
    fp += _mm(n_fp1, sa_out[3], 3) + _mm(n_fp2, cfg.fp_mlps[0][-1], 3)
    comp["fp"] = fp

    H, I = cfg.text_hidden, cfg.text_intermediate
    per_layer = _mm(L, H, H) * 4 + _mm(L, L, H) * 2 + _mm(L, I, H) + _mm(L, H, I)
    comp["text"] = per_layer * cfg.text_layers
    comp["text_proj"] = _mm(L, D, H)

    enc = (
        _mm(V, D, D) * 4 + _mm(V, V, D) * 2      # vision self-attn
        + _mm(L, D, D) * 4 + _mm(L, L, D) * 2    # language self-attn
        + _mm(L, D, D) * 2 + _mm(V, D, D) * 2    # lang->vis cross (q,o / k,v)
        + _mm(L, V, D) * 2                       # cross scores + apply
        + _mm(V, D, D) * 2 + _mm(L, D, D) * 2    # vis->lang cross
        + _mm(V, L, D) * 2
        + _mm(V, F, D) + _mm(V, D, F)            # vision FFN
        + _mm(L, F, D) + _mm(L, D, F)            # language FFN
    )
    comp["encoder"] = enc * cfg.num_encoder_layers

    dec = (
        _mm(Q, D, D) * 4 + _mm(Q, Q, D) * 2      # query self-attn
        + _mm(Q, D, D) * 2 + _mm(L, D, D) * 2    # cross to text
        + _mm(Q, L, D) * 2
        + _mm(Q, D, D) * 2 + _mm(V, D, D) * 2    # cross to vision seeds
        + _mm(Q, V, D) * 2
        + _mm(Q, F, D) + _mm(Q, D, F)            # FFN
        + _mm(Q, D, 6) + _mm(Q, D, D)            # learned query pos-embed
    )
    comp["decoder"] = dec * cfg.num_decoder_layers

    n_heads = cfg.num_decoder_layers + 1
    head = (
        _mm(Q, D, D) * 2 + _mm(Q, 3, D)          # center MLP
        + _mm(Q, D, D) * 2 + _mm(Q, 3, D)        # size MLP
        + _mm(Q, D, D) * 2 + _mm(Q, cfg.num_class, D)  # sem-cls MLP
    )
    comp["heads"] = head * n_heads

    if cfg.contrastive_align:
        K = cfg.contrastive_dim
        proj = _mm(Q, D, D) * 2 + _mm(Q, K, D) + _mm(L, D, D) * 2 + _mm(L, K, D)
        comp["contrastive"] = (proj + _mm(Q, L, K)) * n_heads
    return comp


def total_flops(comp: dict, occupancy: Optional[Sequence[float]] = None):
    """(dense-window, in-radius) totals of a per-scene component dict; without
    ``occupancy`` both are the dense-window total."""
    dense = sum(v for k, v in comp.items() if k != "sa_pair_layers")
    if occupancy is None:
        return dense, dense
    in_radius = dense - comp["sa_pair"] + sum(
        o * f for o, f in zip(occupancy, comp["sa_pair_layers"]))
    return dense, in_radius


# a trained matmul costs 3x its forward (forward, dW, dx), the pair grid's
# backward included; the frozen text encoder 1x (no gradient reaches it)
TRAIN_MULTIPLIER = 3.0
FROZEN_COMPONENTS = ("text",)


def train_flops(comp: dict, occupancy: Optional[Sequence[float]] = None):
    """(dense-window, in-radius) FLOPs of one scene's training step."""
    dense_f, in_radius_f = total_flops(comp, occupancy)
    frozen = sum(comp.get(k, 0.0) for k in FROZEN_COMPONENTS)
    dense = frozen + TRAIN_MULTIPLIER * (dense_f - frozen)
    in_radius = frozen + TRAIN_MULTIPLIER * (in_radius_f - frozen)
    return dense, in_radius


def measure_sa_occupancy(point_clouds: np.ndarray, cfg, max_scenes: int = 4, device="cpu"):
    """Measured share of window slots in radius, per SA layer.

    Replays the fused backbone's geometry on the host (``sa_chain``) and the
    kernels' block-midpoint window starts (16-center blocks when M % 16 == 0,
    else 8; start = clip(mid_rank - W/2, 0, N - W), floored to 16).
    """
    occs = []
    for g, xyz_all, ranks in sa_chain(point_clouds, cfg, max_scenes, device):
        B, N = xyz_all.shape[:2]
        pb = 16 if g.m % 16 == 0 else 8
        frac = []
        for b in range(B):
            mids = ranks[b].reshape(-1, pb)[:, pb // 2]
            starts = np.clip(mids - g.w // 2, 0, N - g.w)
            starts = (starts // 16) * 16
            for blk, s in enumerate(starts):
                grp = ranks[b, blk * pb:(blk + 1) * pb]
                cen = xyz_all[b, grp]
                win = xyz_all[b, s:s + g.w]
                d2 = ((cen[:, None, :] - win[None]) ** 2).sum(-1)
                frac.append((d2 <= g.radius ** 2).mean())
        occs.append(float(np.mean(frac)))
    return occs


def sa_chain(point_clouds: np.ndarray, cfg, max_scenes: int = 4, device="cpu"):
    """Yield (geom, layer_xyz, center_ranks) per SA layer, replaying the fused
    backbone's chain on the host: Morton-presorted input, the port's FPS (on
    ``device``: the kernel on CUDA, its bit-exact plain version on the CPU)
    with the two-stage presample at SA1 as ``FusedSetAbstraction.sample``,
    rank-ordered center chaining."""
    from eda_tpu_torch.ops import pointops

    def fps(xyz, m):
        return pointops.furthest_point_sample(torch.from_numpy(xyz).to(device), m).cpu().numpy()

    xyz_all = np.asarray(point_clouds[:max_scenes, :, :3], np.float32)
    for g in sa_geometry(cfg):
        B, N = xyz_all.shape[:2]
        if N >= 4 * 8192 >= 4 * g.m:
            sub = (np.arange(8192) * N) // 8192
            inds = sub[fps(np.ascontiguousarray(xyz_all[:, sub]), g.m)]
        else:
            inds = fps(xyz_all, g.m)
        ranks = np.sort(inds, axis=1)
        yield g, xyz_all, ranks
        xyz_all = np.take_along_axis(xyz_all, ranks[..., None].astype(np.int64), axis=1)


def mfu_summary(cfg, batch_size: int, text_len: int, fwd_time_s: Optional[float] = None,
                train_time_s: Optional[float] = None,
                occupancy: Optional[Sequence[float]] = None,
                peak: float = H100_PEAK_BF16_FLOPS) -> dict:
    """FLOP counts and MFU shares for the bench. Times are per-BATCH seconds.

    ``*_dense_window_flops_per_scene`` and ``*_in_radius_flops_per_scene`` are
    the two counts; ``*_mfu`` divides the dense-window count by time and
    ``peak``, ``*_useful_mfu`` the in-radius count.
    """
    comp = forward_flops(cfg, text_len)
    out = {"occupancy": list(occupancy) if occupancy else None, "peak_flops": peak}
    dense, in_radius = total_flops(comp, occupancy)
    out["fwd_dense_window_flops_per_scene"] = dense
    out["fwd_in_radius_flops_per_scene"] = in_radius
    if fwd_time_s:
        out["fwd_mfu"] = batch_size * dense / fwd_time_s / peak
        out["fwd_useful_mfu"] = batch_size * in_radius / fwd_time_s / peak
    t_dense, t_in_radius = train_flops(comp, occupancy)
    out["train_dense_window_flops_per_scene"] = t_dense
    out["train_in_radius_flops_per_scene"] = t_in_radius
    if train_time_s:
        out["train_mfu"] = batch_size * t_dense / train_time_s / peak
        out["train_useful_mfu"] = batch_size * t_in_radius / train_time_s / peak
    return out
