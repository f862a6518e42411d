"""PointNet++ backbone with fused set abstraction, channels-last.

Counterpart of ``eda_tpu/models/pointnet2.py`` on its serving path: four fused
SA layers chained in rank order over a Morton-presorted cloud, then two FP
layers. ``end_points`` keeps the JAX package's keys: ``sa{i}_xyz``,
``sa{i}_features``, ``sa{i}_inds`` (indices into the input cloud),
``fp2_features``, ``fp2_xyz`` and ``fp2_inds``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from eda_tpu_torch.models.layers import BatchNorm, Dense
from eda_tpu_torch.ops import pointops
from eda_tpu_torch.ops.fused_sa import SAParams, fused_set_abstraction


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


class FusedSetAbstraction(nn.Module):
    """Index-free SA layer: FPS + fused windowed neighbourhood MLP + max pool.

    Returns centers, features and center indices in ascending index order,
    which over a Morton-sorted cloud is Morton order again: the next layer is
    presorted too.
    """

    def __init__(self, npoint: int, radius: float, window: int, in_features: int,
                 mlp_channels: Sequence[int], block: int = 64, fps_presample: int = 8192):
        super().__init__()
        self.npoint, self.radius, self.window = npoint, radius, window
        self.block, self.fps_presample = block, fps_presample
        widths = [3 + in_features, *mlp_channels]
        self.kernels = nn.ParameterList(
            [nn.Parameter(torch.empty(a, b)) for a, b in zip(widths, widths[1:])]
        )
        self.biases = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c in mlp_channels])
        self.ln_scales = nn.ParameterList([nn.Parameter(torch.ones(c)) for c in mlp_channels])
        self.ln_biases = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c in mlp_channels])

    def sample(self, xyz: torch.Tensor) -> torch.Tensor:
        """(B, npoint) FPS indices; two-stage over a Morton-stride presample of large clouds."""
        B, N, _ = xyz.shape
        P = self.fps_presample
        if N >= 4 * P >= 4 * self.npoint:
            # a Morton-stride subsample is already spatially stratified, so FPS
            # over it keeps full-FPS coverage at a fraction of the serial cost
            sub = torch.arange(P, device=xyz.device) * N // P
            local = pointops.furthest_point_sample(xyz[:, sub].contiguous(), self.npoint)
            return sub[local.long()]
        return pointops.furthest_point_sample(xyz.contiguous(), self.npoint).long()

    def forward(self, xyz: torch.Tensor, features: torch.Tensor):
        inds = self.sample(xyz)
        params = SAParams(tuple(self.kernels), tuple(self.biases),
                          tuple(self.ln_scales), tuple(self.ln_biases))
        new_features, inds = fused_set_abstraction(
            xyz, features, inds, params, radius=self.radius, window=self.window,
            block=self.block,
        )
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
    """4 fused SA + 2 FP layers over a Morton-presorted (B, N, 3 + C) cloud."""

    def __init__(self, input_feature_dim: int = 3,
                 npoints: Sequence[int] = (2048, 1024, 512, 256),
                 radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
                 mlps: Sequence[Sequence[int]] = ((64, 64, 128), (128, 128, 256),
                                                  (128, 128, 256), (128, 128, 256)),
                 fp_mlps: Sequence[Sequence[int]] = ((256, 256), (256, 288)),
                 sa_windows: Sequence[int] = (1024, 256, 256, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        in_feats = [input_feature_dim] + [m[-1] for m in mlps[:3]]
        for i in range(4):
            setattr(self, f"sa{i + 1}", FusedSetAbstraction(
                npoints[i], radii[i], sa_windows[i], in_feats[i], mlps[i]))
        self.fp1 = FeaturePropagation(mlps[3][-1] + mlps[2][-1], fp_mlps[0], dtype)
        self.fp2 = FeaturePropagation(fp_mlps[0][-1] + mlps[1][-1], fp_mlps[1], dtype)

    def forward(self, point_cloud: torch.Tensor) -> dict:
        xyz = point_cloud[..., 0:3].float().contiguous()
        features = point_cloud[..., 3:].float()
        B, N = xyz.shape[:2]
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
        # the seeds are sa2's points, whose input-cloud indices are tracked exactly
        end_points["fp2_inds"] = end_points["sa2_inds"]
        return end_points
