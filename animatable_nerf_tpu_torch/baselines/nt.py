"""NT: the neural texture baseline.

JAX counterpart: animatable_nerf_tpu/baselines/nt.py (`NeuralTexture`
:22, `NT` :44; reference lib/networks/nt/nt.py, texture.py). Four
texture levels (size, size/2, size/4, size/8 texels, `feature_dim`
channels) are sampled at the same uv (`core/grid.py` `grid_bilerp`),
summed, multiplied by `uv_msk`, and refined by the gated UNet into rgb
and a mask. The levels carry the reference's names and layout,
`texture.layer{i}` of shape (1, C, A, B), whose last axis the uv's u
coordinate indexes; the UNet is `unet.*`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.grid import grid_bilerp
from .unet import UNet

NT_UNET_WIDTHS = (64, 128, 256, 512, 512, 256, 128, 64, 32)


class NeuralTexture(nn.Module):
    def __init__(self, size: int = 1024, feature_dim: int = 16):
        super().__init__()
        for lvl in range(4):
            s = size // (2 ** lvl)
            self.register_parameter(
                f"layer{lvl + 1}",
                nn.Parameter(torch.randn(1, feature_dim, s, s)))

    def forward(self, uv, uv_mask):
        """uv (H, W, 2) in [0, 1], uv_mask (H, W) -> (H, W, C)."""
        y = 0.0
        for lvl in range(4):
            tex = getattr(self, f"layer{lvl + 1}")[0].permute(1, 2, 0)
            y = y + grid_bilerp(tex, uv)
        return y * uv_mask[..., None]


class NT(nn.Module):
    frame_keys = ("uv", "uv_msk")

    def __init__(self, size: int = 1024, feature_dim: int = 16,
                 unet_widths=NT_UNET_WIDTHS):
        super().__init__()
        self.texture = NeuralTexture(size, feature_dim)
        self.unet = UNet(feature_dim, 3, unet_widths)

    def forward(self, frame) -> dict:
        x = self.texture(frame["uv"], frame["uv_msk"])
        out = self.unet(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
        return {"rgb_map": out[..., :3], "mask": out[..., 3]}
