"""SA pair-MLP max-pool forward: the CUDA kernel ``csrc/sa_pair_pool.cu`` and its plain version.

Counterpart of ``eda_tpu/ops/pallas/sa_kernel.py:sa_pair_pool_pallas``:
``sa_pair_pool`` (serving, no winner export) and ``sa_pair_pool_winners``
(training: also the winning point of each pooled value, for the backward in
``sa_pool_bwd.py``). Centers come in blocks of 16 (rank order); each block
pairs with the ``window`` points that start at its window start floored to a
multiple of 16. Per pair (center c, point p)::

    h0 = bf16(relu(f32(A_p) + f32(bc_c)))
    h1 = bf16(relu(LN(h0 @ W2 + b2)))      # f32 sums of bf16 products
    z  = h1 @ W3 + b3                      # f32 pre-activation

and the output is the max of z over the in-radius pairs, -1e9 for a center
with no point of its window in range. The pair MLP has one interior layer, as
every configuration of the model does.

The radius test is the TPU kernel's ``d2_mode`` (``resolve_d2_mode``), all in
f32:

* ``pair``: ``|p - c|^2 <= r^2``, the sum taken x, y, z;
* ``mxu``: the expansion about the block's first center ``o``
  (``sa_kernel.py:251-255, 279-289``): with ``p' = p - o``, ``c' = c - o``,
  ``psq = |p'|^2`` and ``csq = |c'|^2`` (sums x, y, z),
  ``pc = (-2p'x)c'x + (-2p'y)c'y + (-2p'z)c'z + csq`` and the pair is in
  radius iff ``pc <= r^2 - psq``;
* ``pre``: the mask of ``sa_mask.sa_radius_mask``, (B, M // 16, W, 16), row
  ``w`` the window's point ``w``; the pool reads no coordinates.

``mxu`` and ``pre`` may decide a pair within ~1e-5 of the radius otherwise
than ``pair`` (``sa_kernel.py:75-80``).

Winners follow the TPU kernel's tie rule (``sa_kernel.py:357-382``): the
window is cut in tiles of ``wc = min(128, W)`` points; within a tile the last
of equal maxima wins, across tiles the first tile keeps a tie. A center with
no in-radius point exports global rank 0.
"""

from __future__ import annotations

import ctypes
import os

import torch

from eda_tpu_torch.ops.cuda.build import Kernel, ptr, register, require_cuda
from eda_tpu_torch.ops.cuda.sa_prep import bf16_round, ln_one_pass

BLOCK = 16  # centers per window block
NEG = -1e9
PLAIN_MAX_PAIRS = 1 << 22  # pairs the plain version holds at once (SA1's grid is ~1 GB a scene)
# (c1, c2, c3) widths the kernels are instantiated for (csrc/sa_pair_pool.cu,
# csrc/sa_pair_pool_bwd.cu): the model's layer widths, full and tiny, in
# ascending order. Other widths up to (128, 128, 256) run zero-padded on the
# smallest triple that covers them (``kernel_widths``, ``pad_widths``).
WIDTHS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128, 256))

D2_MODES = ("pair", "mxu", "pre")

_GEOMETRY_ARGS = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 8 + (ctypes.c_float, ctypes.c_void_p)
_MASK_ARGS = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
# (d2_mode, winners) -> the launch function of csrc/sa_pair_pool.cu
KERNELS = {
    ("pair", False): register(Kernel(
        "sa_pair_pool", "sa_pair_pool_launch", _GEOMETRY_ARGS,
        replaces="eda_tpu/ops/pallas/sa_kernel.py:1271")),
    ("pair", True): register(Kernel(
        "sa_pair_pool", "sa_pair_pool_winners_launch", _GEOMETRY_ARGS + (ctypes.c_void_p,),
        replaces="eda_tpu/ops/pallas/sa_kernel.py:1195")),
    ("mxu", False): register(Kernel(
        "sa_pair_pool", "sa_pair_pool_mxu_launch", _GEOMETRY_ARGS,
        replaces="eda_tpu/ops/pallas/sa_kernel.py:1271")),
    ("mxu", True): register(Kernel(
        "sa_pair_pool", "sa_pair_pool_mxu_winners_launch", _GEOMETRY_ARGS + (ctypes.c_void_p,),
        replaces="eda_tpu/ops/pallas/sa_kernel.py:1195")),
    ("pre", False): register(Kernel(
        "sa_pair_pool", "sa_pair_pool_pre_launch", _MASK_ARGS,
        replaces="eda_tpu/ops/pallas/sa_kernel.py:1235")),
    ("pre", True): register(Kernel(
        "sa_pair_pool", "sa_pair_pool_pre_winners_launch", _MASK_ARGS + (ctypes.c_void_p,),
        replaces="eda_tpu/ops/pallas/sa_kernel.py:1235")),
}


def resolve_d2_mode(d2_mode: str | None = None) -> str:
    """The radius-test mode: ``d2_mode``, else ``EDA_SA_D2``, else ``"pair"``.

    Read anew on every call, as ``eda_tpu/ops/pallas/sa_kernel.py:84-90``.
    """
    mode = d2_mode or os.environ.get("EDA_SA_D2", "pair")
    if mode not in D2_MODES:
        raise ValueError(f"EDA_SA_D2/d2_mode must be 'pair', 'mxu' or 'pre', got {mode!r}")
    return mode


def _check_mask(mask, B: int, n_blocks: int, window: int) -> None:
    if mask is None or mask.shape != (B, n_blocks, window, BLOCK) or mask.dtype != torch.uint8:
        raise ValueError(f"d2_mode='pre' takes a ({B}, {n_blocks}, {window}, {BLOCK}) uint8 mask")


def window_starts(starts: torch.Tensor, n_points: int, window: int) -> torch.Tensor:
    """Window starts as the kernel uses them: floored to 16, inside [0, N - W]."""
    return torch.clamp((starts // 16) * 16, 0, n_points - window)


def kernel_widths(c1: int, c2: int, c3: int) -> tuple:
    """The instantiated triple a layer of widths (c1, c2, c3) runs on: the
    smallest of ``WIDTHS`` that covers each width. Wider layers raise."""
    for widths in WIDTHS:
        if c1 <= widths[0] and c2 <= widths[1] and c3 <= widths[2]:
            return widths
    raise ValueError(f"the pair-pool kernels take widths up to {WIDTHS[-1]}, "
                     f"got c1={c1}, c2={c2}, c3={c3}")


def pad_widths(widths, A, b_c, w2, b2, s2, lb2, w3, b3=None, g=None, winners=None):
    """The pool's operands zero-padded to ``widths`` = (C1, C2, C3), as the
    TPU kernel pads its lanes (``eda_tpu/ops/fused_sa.py:590-604``).

    A and b_c on their channel axis; W2's and W3's rows and columns; b2, s2,
    lb2 to C2; b3, and the backward's g and winners, to C3. With zero
    weights, biases and LayerNorm parameters a padded channel adds nothing to
    any sum and no kept output depends on it: h0 and z are 0 there, h1 is
    relu(xhat * 0 + 0) = 0, and a zero cotangent makes no pair row. Only the
    interior LayerNorm's divisor must stay the real c2. Returns the padded
    operands in the order given (None stays None).
    """
    pad = torch.nn.functional.pad
    C1, C2, C3 = widths
    (c1, c2), c3 = w2.shape, w3.shape[1]
    out = [pad(A, (0, C1 - c1)), pad(b_c, (0, C1 - c1)), pad(w2, (0, C2 - c2, 0, C1 - c1))]
    out += [pad(v, (0, C2 - c2)) for v in (b2, s2, lb2)]
    out.append(pad(w3, (0, C3 - c3, 0, C2 - c2)))
    out += [None if t is None else pad(t, (0, C3 - c3)) for t in (b3, g, winners)]
    return tuple(out)


def sa_pair_pool_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                       *, radius: float, window: int, d2_mode: str | None = None,
                       mask=None, c2_real: int | None = None) -> torch.Tensor:
    """Plain PyTorch pair pool, in chunks of center blocks.

    The matmuls run in f32 on bf16-rounded operands: the products are exact,
    so each sum is an f32 sum of bf16 products as in the kernel. ``c2_real``
    is the real interior width of operands that ``pad_widths`` padded.
    """
    return _pool_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                       radius=radius, window=window, d2_mode=resolve_d2_mode(d2_mode),
                       mask=mask, with_winners=False, c2_real=c2_real)


def sa_pair_pool_winners_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                               *, radius: float, window: int, d2_mode: str | None = None,
                               mask=None, runner_up: bool = False, c2_real: int | None = None):
    """Plain PyTorch pair pool with winner export: ((B, M, c3) f32, (B, M, c3) int32).

    With ``runner_up`` it also returns the best value of the other pairs, so a
    caller can tell a winner from a near-tie.
    """
    return _pool_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                       radius=radius, window=window, d2_mode=resolve_d2_mode(d2_mode),
                       mask=mask, with_winners=True, runner_up=runner_up, c2_real=c2_real)


def _in_radius(x_w, cen, r2: float, d2_mode: str) -> torch.Tensor:
    """(B, nb, 16, W) radius test of window points x_w (B, nb, 1, W, 3) against
    centers cen (B, nb, 16, 1, 3), f32, term by term as the kernel."""
    if d2_mode == "pair":
        d = x_w - cen
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2] <= r2
    origin = cen[:, :, :1]  # the block's first center
    c, p = cen - origin, x_w - origin
    csq = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1] + c[..., 2] * c[..., 2]
    psq = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]
    pc = ((-2 * p[..., 0]) * c[..., 0] + (-2 * p[..., 1]) * c[..., 1]
          + (-2 * p[..., 2]) * c[..., 2] + csq)
    return pc <= r2 - psq


def _pool_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3, *, radius: float,
                window: int, d2_mode: str, mask, with_winners: bool, runner_up: bool = False,
                c2_real: int | None = None):
    B, N, c1 = A.shape
    M = b_c.shape[1]
    n_blocks = M // BLOCK
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    if d2_mode == "pre":
        _check_mask(mask, B, n_blocks, window)
    starts = window_starts(starts.long(), N, window)
    w2f, w3f = bf16_round(w2.float()), bf16_round(w3.float())
    b2, s2, lb2, b3 = (v.float() for v in (b2, s2, lb2, b3))
    offs = torch.arange(window, device=A.device)
    chunk = max(1, PLAIN_MAX_PAIRS // (B * BLOCK * window))
    out = torch.empty((B, M, w3.shape[1]), dtype=torch.float32, device=A.device)
    winners = torch.empty((B, M, w3.shape[1]), dtype=torch.int32, device=A.device)
    second = torch.empty_like(out)
    tile = (offs // min(128, window))[:, None]  # (W, 1) tile of each window point
    for j0 in range(0, n_blocks, chunk):
        j1 = min(n_blocks, j0 + chunk)
        nb = j1 - j0
        pos = (starts[:, j0:j1, None] + offs).reshape(B, nb * window, 1)
        a_w = A.float().gather(1, pos.expand(-1, -1, c1)).view(B, nb, 1, window, c1)
        bc = b_c[:, j0 * BLOCK:j1 * BLOCK].float().view(B, nb, BLOCK, 1, c1)
        h = bf16_round(torch.relu(a_w + bc))  # (B, nb, 16, W, c1)
        h = bf16_round(torch.relu(ln_one_pass(h @ w2f + b2, s2, lb2, c=c2_real)))
        z = h @ w3f + b3
        if d2_mode == "pre":
            keep = mask[:, j0:j1].transpose(2, 3).bool()  # (B, nb, 16, W)
        else:
            x_w = xyz.float().gather(1, pos.expand(-1, -1, 3)).view(B, nb, 1, window, 3)
            cen = cen_xyz[:, j0 * BLOCK:j1 * BLOCK].float().view(B, nb, BLOCK, 1, 3)
            keep = _in_radius(x_w, cen, r2, d2_mode)
        z = torch.where(keep[..., None], z, torch.full_like(z, NEG))
        best = z.amax(dim=3)  # (B, nb, 16, c3)
        out[:, j0 * BLOCK:j1 * BLOCK] = best.reshape(B, nb * BLOCK, -1)
        if with_winners:
            eq = z == best[:, :, :, None]
            first = torch.where(eq, tile, window).amin(dim=3, keepdim=True)
            pos = torch.where(eq & (tile == first), offs[:, None], -1).amax(dim=3)
            win = torch.where(best > NEG, starts[:, j0:j1, None, None] + pos, 0)
            winners[:, j0 * BLOCK:j1 * BLOCK] = win.reshape(B, nb * BLOCK, -1).int()
            if runner_up:
                others = torch.where(offs[:, None] == pos[:, :, :, None], NEG, z)
                second[:, j0 * BLOCK:j1 * BLOCK] = others.amax(dim=3).reshape(B, nb * BLOCK, -1)
    if runner_up:
        return out, winners, second
    return (out, winners) if with_winners else out


def sa_pair_pool(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                 *, radius: float, window: int, d2_mode: str | None = None,
                 mask=None) -> torch.Tensor:
    """Windowed masked-max pair MLP: the kernel on CUDA, the plain version on the CPU.

    Args:
        A: (B, N, c1) bf16 pre-normalized per-point projections.
        xyz: (B, N, 3) f32 sorted coordinates.
        b_c: (B, M, c1) bf16 per-center offsets, centers in rank order.
        cen_xyz: (B, M, 3) f32 center coordinates (rank order).
        starts: (B, M // 16) int window starts, floored to 16 here.
        w2, b2, s2, lb2: interior layer (c1, c2) kernel, bias, LN scale and bias.
        w3, b3: last layer (c2, c3) kernel and bias.
        d2_mode: the radius test, resolved by ``resolve_d2_mode``.
        mask: with ``d2_mode="pre"``, the (B, M // 16, window, 16) in-radius
            mask of ``sa_mask.sa_radius_mask``; xyz and cen_xyz are then unused.

    Returns:
        (B, M, c3) f32 pooled last-layer pre-activations; -1e9 rows for centers
        with no in-radius point in their window.
    """
    mode = resolve_d2_mode(d2_mode)
    if A.device.type == "cpu":
        return sa_pair_pool_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2,
                                  w3, b3, radius=radius, window=window, d2_mode=mode, mask=mask)
    return _launch(mode, False, A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                   radius=radius, window=window, mask=mask)


def sa_pair_pool_winners(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                         *, radius: float, window: int, d2_mode: str | None = None, mask=None):
    """``sa_pair_pool`` that also returns the (B, M, c3) int32 global rank of
    each pooled value's point: the kernel on CUDA, the plain version on the CPU."""
    mode = resolve_d2_mode(d2_mode)
    if A.device.type == "cpu":
        return sa_pair_pool_winners_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2,
                                          w3, b3, radius=radius, window=window, d2_mode=mode,
                                          mask=mask)
    return _launch(mode, True, A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                   radius=radius, window=window, mask=mask)


def _launch(mode: str, with_winners: bool, A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3,
            b3, *, radius: float, window: int, mask):
    B, N, c1 = A.shape
    M = b_c.shape[1]
    c2, c3 = w3.shape
    pre = mode == "pre"
    if A.dtype != torch.bfloat16 or b_c.dtype != torch.bfloat16:
        raise ValueError("sa_pair_pool takes bf16 A and b_c")
    if w2.shape != (c1, c2) or b_c.shape[-1] != c1:
        raise ValueError("sa_pair_pool widths do not agree")
    widths = kernel_widths(c1, c2, c3)
    if widths != (c1, c2, c3):
        A, b_c, w2, b2, s2, lb2, w3, b3, _, _ = pad_widths(widths, A, b_c, w2, b2, s2, lb2,
                                                           w3, b3)
    C1, C2, C3 = widths
    A, b_c = A.contiguous(), b_c.contiguous()
    w2, w3 = (w.to(torch.bfloat16).contiguous() for w in (w2, w3))
    b2, s2, lb2, b3 = (v.float().contiguous() for v in (b2, s2, lb2, b3))
    starts = window_starts(starts.to(torch.int32), N, window).to(torch.int32).contiguous()
    require_cuda(A, b_c, starts, w2, b2, s2, lb2, w3, b3)
    if (M % BLOCK or b_c.shape != (B, M, C1) or starts.shape != (B, M // BLOCK)
            or not 0 < window <= N):
        raise ValueError("sa_pair_pool input shapes do not agree")
    if pre:
        _check_mask(mask, B, M // BLOCK, window)
        require_cuda(mask)
        geometry = [ptr(A), ptr(b_c), ptr(mask), ptr(starts)]
    else:
        require_cuda(xyz, cen_xyz)
        if xyz.dtype != torch.float32 or cen_xyz.dtype != torch.float32:
            raise ValueError("sa_pair_pool takes float32 coordinates")
        if xyz.shape != (B, N, 3) or cen_xyz.shape != (B, M, 3):
            raise ValueError("sa_pair_pool input shapes do not agree")
        geometry = [ptr(A), ptr(xyz), ptr(b_c), ptr(cen_xyz), ptr(starts)]
    out = torch.empty((B, M, C3), dtype=torch.float32, device=A.device)
    args = geometry + [ptr(w2), ptr(b2), ptr(s2), ptr(lb2), ptr(w3), ptr(b3),
                       B, N, M, C1, C2, C3, c2, window]
    if not pre:
        args.append(torch.tensor(radius * radius, dtype=torch.float32).item())
    args.append(ptr(out))
    kernel = KERNELS[mode, with_winners]
    if with_winners:
        winners = torch.empty((B, M, C3), dtype=torch.int32, device=A.device)
        kernel(*args, ptr(winners))
        return out[..., :c3], winners[..., :c3]
    kernel(*args)
    return out[..., :c3]
