"""PointNet++ with multi-scale grouping, the NHR baseline's point encoder.

JAX counterpart: animatable_nerf_tpu/baselines/pointnet2_msg.py
(`_PointMLP` :32, `SetAbstractionMSG` :50, `FeaturePropagation` :92,
`PointNet2MSG` :112; reference lib/networks/pointnet2/pointnet2_msg.py),
on the point ops of ops/pointnet2.py. Channels-last (B, N, C). The
parameters carry the reference's names, the ones JAX's
compat/torch_import.py `convert_pointnet2` reads:
`SA_modules.{k}.mlps.{s}.layer{i}.conv.weight` (out, in, 1, 1) and
`....layer{i}.bn.bn.{weight,bias,running_mean,running_var}`, the same
under `FP_modules.{k}.mlp.`. A 1x1 convolution without bias is a matmul
over the channel axis; the batch norm is the UNet's `TorchBatchNorm`
over every axis but the last.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import pointnet2 as pn2
from .unet import TorchBatchNorm

DEFAULT_NPOINTS = (4096, 1024, 256, 64)
DEFAULT_RADII = ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
DEFAULT_NSAMPLES = ((16, 32),) * 4
DEFAULT_MLPS = (((16, 16), (32, 32)), ((32, 32), (32, 32)),
                ((64, 64), (64, 64)), ((64, 64), (64, 64)))
# fp0's widths are (out_dim, out_dim)
DEFAULT_FP_WIDTHS = (None, (256, 256), (512, 512), (512, 512))


class _BN(nn.Module):
    """The reference's BatchNorm wrapper (`bn.bn`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = TorchBatchNorm(channels, channel_dim=-1)

    def forward(self, x):
        return self.bn(x)


class _ConvBN(nn.Module):
    """1x1 convolution without bias, batch norm, relu."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = _BN(cout)

    def forward(self, x):
        w = self.conv.weight
        return F.relu(self.bn(F.linear(x, w.reshape(w.shape[0], w.shape[1]))))


class SharedMLP(nn.Module):
    def __init__(self, cin: int, widths):
        super().__init__()
        for i, w in enumerate(widths):
            self.add_module(f"layer{i}", _ConvBN(cin, w))
            cin = w

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class SetAbstractionMSG(nn.Module):
    """FPS centres, then per radius scale: ball query, the neighbours'
    offsets (and features) through the scale's MLP, max over the group;
    the scales concatenated."""

    def __init__(self, npoint: int, radii, nsamples, mlps, cin: int):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = nn.ModuleList(SharedMLP(cin + 3, widths) for widths in mlps)
        self.out_channels = sum(widths[-1] for widths in mlps)

    def forward(self, xyz, features):
        new_xyz = pn2.gather_points(xyz, pn2.furthest_point_sample(xyz, self.npoint))
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            idx = pn2.ball_query(radius, nsample, xyz, new_xyz)
            grouped = pn2.group_points(xyz, idx) - new_xyz[:, :, None]
            if features is not None:
                grouped = torch.cat([grouped, pn2.group_points(features, idx)], -1)
            outs.append(torch.amax(mlp(grouped), dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance upsampling of the known points' features,
    the unknown points' own features appended, then the MLP."""

    def __init__(self, cin: int, widths):
        super().__init__()
        self.mlp = SharedMLP(cin, widths)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        with torch.no_grad():
            dist, idx = pn2.three_nn(unknown_xyz, known_xyz)
            w = pn2.interpolation_weights(dist)
        interp = pn2.three_interpolate(known_feats, idx, w)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class PointNet2MSG(nn.Module):
    """4-level MSG encoder-decoder: xyz (B, N, 3) -> (B, N, out_dim)."""

    def __init__(self, out_dim: int = 18, npoints=DEFAULT_NPOINTS,
                 radii=DEFAULT_RADII, nsamples=DEFAULT_NSAMPLES,
                 mlps=DEFAULT_MLPS, fp_widths=DEFAULT_FP_WIDTHS):
        super().__init__()
        fp = [(out_dim, out_dim) if w is None else tuple(w) for w in fp_widths]
        self.SA_modules = nn.ModuleList()
        channels = [0]
        for k in range(len(npoints)):
            sa = SetAbstractionMSG(npoints[k], radii[k], nsamples[k], mlps[k],
                                   channels[-1])
            self.SA_modules.append(sa)
            channels.append(sa.out_channels)
        self.FP_modules = nn.ModuleList()
        for k in range(len(fp)):
            known = fp[k + 1][-1] if k + 1 < len(fp) else channels[k + 1]
            self.FP_modules.append(FeaturePropagation(known + channels[k], fp[k]))

    def forward(self, xyz, features=None):
        l_xyz, l_feat = [xyz], [features]
        for sa in self.SA_modules:
            nx, nf = sa(l_xyz[-1], l_feat[-1])
            l_xyz.append(nx)
            l_feat.append(nf)
        for k in range(len(self.FP_modules) - 1, -1, -1):
            l_feat[k] = self.FP_modules[k](l_xyz[k], l_xyz[k + 1], l_feat[k],
                                           l_feat[k + 1])
        return l_feat[0]
