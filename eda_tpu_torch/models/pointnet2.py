"""PointNet++ backbone, channels-last.

Counterpart of ``eda_tpu/models/pointnet2.py``: four SA layers, then two FP
layers. The SA layers are fused (``sa_impl="fused"``: chained in rank order
over a Morton-presorted cloud, or with ``points_presorted=False`` each
layer sorting its input on the device) or gather layers (``"gather"``: FPS over the
whole cloud, a ball query, the grouped neighbourhoods through a shared MLP
with BatchNorm, max-pooled; the reference's PointNet++). ``end_points``
keeps the JAX package's keys: ``sa{i}_xyz``, ``sa{i}_features``,
``sa{i}_inds`` (indices into the input cloud), ``fp2_features``,
``fp2_xyz`` and ``fp2_inds``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from eda_tpu_torch.models.layers import BatchNorm, Dense
from eda_tpu_torch.ops import pointops
from eda_tpu_torch.ops.fused_sa import SAParams, check_trainable, fused_set_abstraction


class SharedMLP(nn.Module):
    """(Dense without bias + BatchNorm + ReLU) per channel width, over the last axis."""

    def __init__(self, in_features: int, channels: Sequence[int], dtype: torch.dtype):
        super().__init__()
        widths = [in_features, *channels]
        self.dense = nn.ModuleList(
            [Dense(a, b, bias=False, dtype=dtype) for a, b in zip(widths, widths[1:])]
        )
        self.bn = nn.ModuleList([BatchNorm(c) for c in channels])

    def forward(self, x):
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x)))
        return x


class SetAbstraction(nn.Module):
    """Single-scale grouping SA layer (the reference's ``PointnetSAModuleVotes``).

    FPS over the whole cloud, a ball query (``ball_mode``: ``nearest`` or
    ``first``), the neighbours' xyz relative to the center divided by the
    radius beside their features, a shared MLP and a max over the neighbours.
    """

    def __init__(self, npoint: int, radius: float, nsample: int, in_features: int,
                 mlp_channels: Sequence[int], ball_mode: str = "nearest",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if ball_mode not in ("nearest", "first"):
            raise ValueError(f"unknown ball_mode {ball_mode!r}")
        self.npoint, self.radius, self.nsample, self.ball_mode = npoint, radius, nsample, ball_mode
        self.mlp = SharedMLP(3 + in_features, mlp_channels, dtype)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor):
        inds = pointops.furthest_point_sample(xyz.contiguous(), self.npoint).long()
        new_xyz = pointops.gather_points(xyz, inds)
        query = pointops.ball_query if self.ball_mode == "first" else pointops.ball_query_nearest
        nbr = query(xyz, new_xyz, self.radius, self.nsample)
        grouped_xyz = (pointops.group_points(xyz, nbr) - new_xyz[:, :, None]) \
            / xyz.new_tensor(self.radius)
        grouped = torch.cat([grouped_xyz, pointops.group_points(features, nbr)], -1)
        return new_xyz, self.mlp(grouped).amax(2), inds


class FusedSetAbstraction(nn.Module):
    """Index-free SA layer: FPS + fused windowed neighbourhood MLP + max pool.

    With ``presorted`` (a Morton-sorted input) it returns centers, features
    and center indices in ascending index order, which is Morton order again:
    the next layer is presorted too. Otherwise the fused SA sorts the points
    on the device and everything comes back in FPS order.
    """

    def __init__(self, npoint: int, radius: float, window: int, in_features: int,
                 mlp_channels: Sequence[int], block: int = 64, fps_presample: int = 8192,
                 dtype: torch.dtype = torch.bfloat16, presorted: bool = True):
        super().__init__()
        self.npoint, self.radius, self.window = npoint, radius, window
        self.block, self.fps_presample, self.dtype = block, fps_presample, dtype
        self.presorted = presorted
        widths = [3 + in_features, *mlp_channels]
        self.kernels = nn.ParameterList(
            [nn.Parameter(torch.empty(a, b)) for a, b in zip(widths, widths[1:])]
        )
        self.biases = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c in mlp_channels])
        self.ln_scales = nn.ParameterList([nn.Parameter(torch.ones(c)) for c in mlp_channels])
        self.ln_biases = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c in mlp_channels])

    def sample(self, xyz: torch.Tensor) -> torch.Tensor:
        """(B, npoint) FPS indices; two-stage over a Morton-stride presample of
        large presorted clouds (an unsorted cloud's stride sample is no stratum)."""
        B, N, _ = xyz.shape
        P = self.fps_presample
        if self.presorted and N >= 4 * P >= 4 * self.npoint:
            # a Morton-stride subsample is already spatially stratified, so FPS
            # over it keeps full-FPS coverage at a fraction of the serial cost
            sub = torch.arange(P, device=xyz.device) * N // P
            local = pointops.furthest_point_sample(xyz[:, sub].contiguous(), self.npoint)
            return sub[local.long()]
        return pointops.furthest_point_sample(xyz.contiguous(), self.npoint).long()

    def params(self) -> SAParams:
        return SAParams(tuple(self.kernels), tuple(self.biases),
                        tuple(self.ln_scales), tuple(self.ln_biases))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor):
        inds = self.sample(xyz)
        params = self.params()
        out = fused_set_abstraction(
            xyz, features, inds, params, radius=self.radius, window=self.window,
            block=self.block, compute_dtype=self.dtype, presorted=self.presorted,
            return_rank_order=self.presorted,
        )
        if self.presorted:
            new_features, inds = out
        else:
            new_features = out
        return pointops.gather_points(xyz, inds), new_features, inds


class FeaturePropagation(nn.Module):
    """FP layer: 3-NN inverse-distance interpolation + shared MLP."""

    def __init__(self, in_features: int, mlp_channels: Sequence[int], dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.mlp = SharedMLP(in_features, mlp_channels, dtype)

    def forward(self, unknown_xyz, known_xyz, unknown_feats: Optional[torch.Tensor], known_feats):
        dist2, idx = pointops.three_nn(unknown_xyz, known_xyz)
        weight = pointops.interpolation_weights(dist2)
        interp = pointops.three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], -1)
        return self.mlp(interp.to(self.dtype))


class PointNetPPBackbone(nn.Module):
    """4 SA + 2 FP layers over a (B, N, 3 + C) cloud. The fused SA
    (``sa_impl``) chains its layers in rank order over a Morton-presorted
    cloud (``points_presorted``), else each layer sorts on the device."""

    def __init__(self, input_feature_dim: int = 3,
                 npoints: Sequence[int] = (2048, 1024, 512, 256),
                 radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
                 mlps: Sequence[Sequence[int]] = ((64, 64, 128), (128, 128, 256),
                                                  (128, 128, 256), (128, 128, 256)),
                 fp_mlps: Sequence[Sequence[int]] = ((256, 256), (256, 288)),
                 sa_windows: Sequence[int] = (1024, 256, 256, 256),
                 dtype: torch.dtype = torch.float32, sa_impl: str = "fused",
                 nsamples: Sequence[int] = (64, 32, 16, 16), sa_ball_mode: str = "nearest",
                 points_presorted: bool = True):
        super().__init__()
        if sa_impl not in ("fused", "gather"):
            raise ValueError(f"unknown sa_impl {sa_impl!r}")
        self.sa_impl = sa_impl
        # rank-order chaining: a rank-ordered subset of a Morton-sorted cloud is
        # Morton-sorted at every coarser cell, so later layers need no sort
        self.chain = sa_impl == "fused" and points_presorted
        in_feats = [input_feature_dim] + [m[-1] for m in mlps[:3]]
        for i in range(4):
            if sa_impl == "fused":
                sa = FusedSetAbstraction(npoints[i], radii[i], sa_windows[i], in_feats[i],
                                         mlps[i], dtype=dtype, presorted=self.chain)
            else:
                sa = SetAbstraction(npoints[i], radii[i], nsamples[i], in_feats[i], mlps[i],
                                    sa_ball_mode, dtype)
            setattr(self, f"sa{i + 1}", sa)
        self.fp1 = FeaturePropagation(mlps[3][-1] + mlps[2][-1], fp_mlps[0], dtype)
        self.fp2 = FeaturePropagation(fp_mlps[0][-1] + mlps[1][-1], fp_mlps[1], dtype)

    def forward(self, point_cloud: torch.Tensor) -> dict:
        xyz = point_cloud[..., 0:3].float().contiguous()
        features = point_cloud[..., 3:].float()
        B, N = xyz.shape[:2]
        if self.sa_impl == "fused" and xyz.device.type == "cuda" and torch.is_grad_enabled():
            # a training step at widths without training kernels raises before any launch
            n = N
            for i in range(4):
                sa = getattr(self, f"sa{i + 1}")
                if any(p.requires_grad for p in sa.parameters()):
                    check_trainable(sa.params(), window=sa.window, n_points=n)
                n = sa.npoint
        end_points = {}
        # each current point's index into the input cloud
        domain_orig = torch.arange(N, device=xyz.device).expand(B, N)
        for i in range(4):
            xyz, features, inds = getattr(self, f"sa{i + 1}")(xyz, features)
            domain_orig = domain_orig.gather(1, inds)
            end_points[f"sa{i + 1}_xyz"] = xyz
            end_points[f"sa{i + 1}_features"] = features
            end_points[f"sa{i + 1}_inds"] = domain_orig
        f1 = self.fp1(end_points["sa3_xyz"], end_points["sa4_xyz"],
                      end_points["sa3_features"], end_points["sa4_features"])
        f2 = self.fp2(end_points["sa2_xyz"], end_points["sa3_xyz"],
                      end_points["sa2_features"], f1)
        end_points["fp2_features"] = f2
        end_points["fp2_xyz"] = end_points["sa2_xyz"]
        if self.chain:
            # the seeds are sa2's points, whose input-cloud indices are tracked exactly
            end_points["fp2_inds"] = end_points["sa2_inds"]
        else:  # the reference's approximation (backbone_module.py:142)
            end_points["fp2_inds"] = end_points["sa1_inds"][:, :f2.shape[1]]
        return end_points
