"""NHR: neural rendering of the posed SMPL vertex cloud.

JAX counterpart: animatable_nerf_tpu/baselines/nhr.py (`pixel_dirs_world`
:34, `NHR` :46; reference lib/networks/nhr/nhr.py, pcprender.py). Per
view: the canonical vertices' blend weights from the `tbw` volume, the
warp big pose -> T-pose -> posed -> world, PointNet++ MSG on the posed
cloud, the splat of its features (ops/rasterize.py) with the learned
`default_features` on the pixels no point reaches, the world view
directions of the covered pixels, and the gated UNet into rgb and a
mask. The parameters carry the reference's names, the ones JAX's
compat/torch_import.py `convert_nhr` reads: `pointnet.*`,
`render.unet.*` and `pcpr_parameters.default_features` (fdim, 1).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.grid import pts_sample_blend_weights
from ..core.lbs import (
    pose_points_to_tpose_points,
    pose_points_to_world_points,
    tpose_points_to_pose_points,
)
from ..ops.rasterize import rasterize_points
from .pointnet2_msg import PointNet2MSG
from .unet import UNet

# the reference NHR refiner's widths (pcprender.py:42-47)
NHR_UNET_WIDTHS = (32, 64, 180, 450, 450, 180, 64, 32, 26)
# each point's footprint, (2r+1)^2 pixels (JAX NHR.splat_radius)
SPLAT_RADIUS = 2


def pixel_dirs_world(H: int, W: int, K, R):
    """(H, W, 3) unit world directions of the pixels' rays: K^-1 [u, v, 1]
    rotated camera -> world (JAX :34)."""
    v, u = torch.meshgrid(torch.arange(H, dtype=K.dtype, device=K.device),
                          torch.arange(W, dtype=K.dtype, device=K.device),
                          indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    world = (pix @ torch.linalg.inv(K).T) @ R
    return world / (torch.linalg.norm(world, dim=-1, keepdim=True) + 1e-8)


class _Render(nn.Module):
    def __init__(self, in_channels: int, widths):
        super().__init__()
        self.unet = UNet(in_channels, 3, widths)


class _PCPRParameters(nn.Module):
    def __init__(self, feature_dim: int):
        super().__init__()
        self.default_features = nn.Parameter(
            torch.randn(feature_dim, 1) * 0.02)


class NHR(nn.Module):
    """NHR at image size H x W. `pointnet_kwargs` and `unet_widths`
    shrink the submodules (tests)."""

    frame_keys = ("tpose", "tbw", "tbounds", "big_A", "A", "R", "Th", "K",
                  "RT")

    def __init__(self, H: int, W: int, feature_dim: int = 18,
                 pointnet_kwargs=None, unet_widths=NHR_UNET_WIDTHS):
        super().__init__()
        self.H, self.W = H, W
        self.pointnet = PointNet2MSG(out_dim=feature_dim,
                                     **(pointnet_kwargs or {}))
        self.pcpr_parameters = _PCPRParameters(feature_dim)
        self.render = _Render(feature_dim + 3, unet_widths)

    def posed_vertices(self, frame):
        """(posed SMPL vertices, world vertices) of the frame's canonical
        (big-pose) vertices (JAX :69-80)."""
        tverts = frame["tpose"]
        bw = pts_sample_blend_weights(tverts, frame["tbw"],
                                      frame["tbounds"])[..., :24]
        bw = bw / torch.clamp(bw.sum(-1, keepdim=True), min=1e-8)
        ppose = pose_points_to_tpose_points(tverts, bw, frame["big_A"])
        pverts = tpose_points_to_pose_points(ppose, bw, frame["A"])
        return pverts, pose_points_to_world_points(pverts, frame["R"],
                                                   frame["Th"])

    def forward(self, frame) -> dict:
        pverts, wverts = self.posed_vertices(frame)
        feats = self.pointnet(pverts[None])[0]
        K, RT = frame["K"], frame["RT"]
        ras = rasterize_points(wverts, feats, K, RT[:3, :3], RT[:3, 3:],
                               self.H, self.W, splat_radius=SPLAT_RADIUS)
        hit = ras["mask"][..., None]
        feat_map = torch.where(hit, ras["feature_map"],
                               self.pcpr_parameters.default_features[:, 0])
        dirs = torch.where(hit, pixel_dirs_world(self.H, self.W, K, RT[:3, :3]),
                           0.0)
        fused = torch.cat([feat_map, dirs], dim=-1)
        out = self.render.unet(fused.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
        return {"rgb_map": out[..., :3], "mask": out[..., 3],
                "depth": ras["depth"], "point_mask": ras["mask"]}
