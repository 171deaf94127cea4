"""The gated-convolution UNet refiner of the NHR and NT baselines.

JAX counterpart: animatable_nerf_tpu/baselines/unet.py (`TorchBatchNorm`
:27, `GatedConv` :77, `DoubleConv` :91, `blur_pool` :109, `_max_pool`
:133, `upsample2x_align_corners` :153, `Down` :175, `Up` :193, `UNet`
:223; reference lib/networks/nhr/unet_model.py, unet_parts.py). The
modules and their parameters carry the reference's PyTorch names
(`inc.conv.conv.0.conv2.weight`, `down1.mpconv.2.conv.conv.1.running_mean`,
`outc.conv2.bias`, ...), the ones JAX's compat/torch_import.py
`convert_nhr_unet` reads. Activations are channels-first (N, C, H, W),
as PyTorch convolves.

`TorchBatchNorm` is JAX's with `frozen=False`, the only form
`make_model` builds: it normalises by the current batch's biased
statistics in evaluation as in training, and never updates its stored
`running_mean` / `running_var`. Those stay parameters without a
gradient, so checkpoints carry them as JAX's do (with Adam moments that
stay 0). nn.BatchNorm2d computes something else in `eval()` and updates
its running statistics in `train()`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class TorchBatchNorm(nn.Module):
    """(x - mean) * rsqrt(var + eps) * weight + bias over every axis but
    the channel (axis 1), with the batch's own biased statistics."""

    def __init__(self, channels: int, eps: float = 1e-5, channel_dim: int = 1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels),
                                         requires_grad=False)
        self.running_var = nn.Parameter(torch.ones(channels),
                                        requires_grad=False)

    def forward(self, x):
        cd = self.channel_dim % x.ndim
        axes = tuple(a for a in range(x.ndim) if a != cd)
        shape = [1] * x.ndim
        shape[cd] = -1
        m = torch.mean(x, dim=axes, keepdim=True)
        v = torch.mean(torch.square(x - m), dim=axes, keepdim=True)
        return ((x - m) * torch.rsqrt(v + self.eps) * self.weight.view(shape)
                + self.bias.view(shape))


class GatedConv(nn.Module):
    """sigmoid(conv2_gate(x)) * conv2(x), 3x3 convolutions with padding 1
    (flax's SAME)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv2 = nn.Conv2d(cin, cout, 3, padding=1)
        self.conv2_gate = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return torch.sigmoid(self.conv2_gate(x)) * self.conv2(x)


class DoubleConv(nn.Module):
    """(gated conv -> batch norm -> relu) x 2, as the reference's
    Sequential `conv` (slots 0, 1, 3, 4 hold parameters)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            GatedConv(cin, cout), TorchBatchNorm(cout), nn.ReLU(),
            GatedConv(cout, cout), TorchBatchNorm(cout), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class BlurPool(nn.Module):
    """Anti-aliased downsampling: reflect padding by 1, then the fixed
    binomial [1, 2, 1] x [1, 2, 1] / 16 filter per channel with stride 2
    (JAX `blur_pool` at its default size; reference
    models_lpf.Downsample). No parameters."""

    def __init__(self):
        super().__init__()
        f1 = np.asarray([1.0, 2.0, 1.0], np.float32)
        f2 = np.outer(f1, f1)
        self.register_buffer("filt", torch.from_numpy(f2 / f2.sum()),
                             persistent=False)

    def forward(self, x):
        C = x.shape[1]
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")
        kern = self.filt.to(x.dtype)[None, None].expand(C, 1, 3, 3)
        return F.conv2d(x, kern, stride=2, groups=C)


class MaxPool(nn.Module):
    """2x2 max pool with stride 1 and no padding, (H, W) -> (H-1, W-1),
    as JAX's chain of elementwise maxima of the four shifted windows, so
    a tie splits the gradient as jnp.maximum's does (torch.maximum splits
    it the same way). No parameters."""

    def forward(self, x):
        Ho, Wo = x.shape[2] - 1, x.shape[3] - 1
        out = None
        for di in range(2):
            for dj in range(2):
                sl = x[:, :, di:di + Ho, dj:dj + Wo]
                out = sl if out is None else torch.maximum(out, sl)
        return out


def _linspace(n: int, device) -> torch.Tensor:
    """jnp.linspace(0, n - 1, 2n) in float32: 0 * (1 - s) + (n - 1) * s
    with s = iota / (2n - 1), the endpoint exact (within one float32
    rounding of XLA's)."""
    step = (np.arange(2 * n, dtype=np.float32) / np.float32(2 * n - 1)
            ).astype(np.float32)
    pos = (np.float32(0.0) * (np.float32(1.0) - step)
           + np.float32(n - 1) * step).astype(np.float32)
    pos[-1] = n - 1
    return torch.from_numpy(pos).to(device)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)
    as JAX computes it: per axis, output node i samples input coordinate
    i * (n - 1) / (2n - 1), a gather and a lerp (JAX :153)."""

    def axis_up(x, axis):
        n = x.shape[axis]
        if n == 1:
            return torch.repeat_interleave(x, 2, dim=axis)
        pos = _linspace(n, x.device)
        lo = torch.clamp(torch.floor(pos).long(), 0, n - 2)
        frac = (pos - lo.to(pos.dtype)).to(x.dtype)
        a = torch.index_select(x, axis, lo)
        b = torch.index_select(x, axis, lo + 1)
        shape = [1] * x.ndim
        shape[axis] = 2 * n
        frac = frac.reshape(shape)
        return a * (1.0 - frac) + b * frac

    return axis_up(axis_up(x, 2), 3)


class InConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x):
        return self.conv(x)


class Down(nn.Module):
    """Max pool (stride 1) -> blur pool (stride 2) -> double conv, the
    reference's `mpconv` Sequential."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mpconv = nn.Sequential(MaxPool(), BlurPool(), DoubleConv(cin, cout))

    def forward(self, x):
        return self.mpconv(x)


class Up(nn.Module):
    """Bilinear 2x upsampling, zero padding (the low side gets diff // 2)
    or cropping onto the skip's size, the skip first in the concatenation,
    then a double conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x, skip):
        x = upsample2x_align_corners(x)
        sh, sw = skip.shape[2], skip.shape[3]
        dy, dx = sh - x.shape[2], sw - x.shape[3]
        if dy > 0 or dx > 0:
            x = F.pad(x, (max(dx // 2, 0), max(dx - dx // 2, 0),
                          max(dy // 2, 0), max(dy - dy // 2, 0)))
        if dy < 0 or dx < 0:
            x = x[:, :, :sh, :sw]
        return self.conv(torch.cat([skip, x], dim=1))


class OutConv(nn.Module):
    """A 1x1 and a 3x3 convolution, summed."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)
        self.conv2 = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return self.conv(x) + self.conv2(x)


class UNet(nn.Module):
    """4-down / 4-up gated UNet over (N, in_channels, H, W). `widths` is
    the reference's 9-entry spec [inc, d1, d2, d3, d4, u1, u2, u3, u4];
    the output has n_classes channels plus a sigmoid mask channel."""

    def __init__(self, in_channels: int, n_classes: int = 3,
                 widths=(64, 128, 256, 512, 512, 256, 128, 64, 32)):
        super().__init__()
        w = tuple(widths)
        self.n_classes = n_classes
        self.inc = InConv(in_channels, w[0])
        self.down1 = Down(w[0], w[1])
        self.down2 = Down(w[1], w[2])
        self.down3 = Down(w[2], w[3])
        self.down4 = Down(w[3], w[4])
        self.up1 = Up(w[4] + w[3], w[5])
        self.up2 = Up(w[5] + w[2], w[6])
        self.up3 = Up(w[6] + w[1], w[7])
        self.up4 = Up(w[7] + w[0], w[8])
        self.outc = OutConv(w[8], n_classes + 1)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        h = self.up1(x5, x4)
        h = self.up2(h, x3)
        h = self.up3(h, x2)
        h = self.up4(h, x1)
        out = self.outc(h)
        n = self.n_classes
        return torch.cat([out[:, :n], torch.sigmoid(out[:, n:])], dim=1)
