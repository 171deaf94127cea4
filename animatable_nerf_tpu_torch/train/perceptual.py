"""The reference's loss package (lib/losses) in plain PyTorch.

JAX counterpart: animatable_nerf_tpu/train/perceptual.py:1-356. Four
loss components of the reference:

  * `perceptual_loss` (JAX :85; lib/losses/nhr_perceptual_loss.py:58-90),
    the objective of the NHR and NT trainers under `train.vgg_weights`:
    the L1 between the relu1_2 / relu2_2 activations of the first four
    convolutions of torchvision's VGG19 on prediction and target (and
    the same on a fourth, mask channel repeated to three), plus the
    image L1;
  * `vgg_perceptual_loss` (JAX :176; lib/losses/perceptual_loss.py):
    a 1-channel VGG16 on grayscale-normalized images, per-tap MSE,
    optionally mask-weighted or on Gram matrices;
  * `ssim_loss` (JAX :268; lib/losses/ssim.py): 11x11 Gaussian-window
    SSIM;
  * `gan_loss` and `NLayerDiscriminator` (JAX :279, :303;
    lib/losses/discriminator.py): the LSGAN / BCE objective and the
    pix2pixHD PatchGAN.

JAX leaves these convolutions to XLA, outside any Pallas kernel, so here
they are `torch.nn.functional.conv2d` and `max_pool2d` in FP32 (the
entry points turn TF32 off for cuDNN, device.py), as the UNets run.
Images are NCHW and kernels OIHW. The weight file is the .npz that
JAX's converter and `tools/convert_vgg_weights.py` here write: HWIO
kernels `conv{i}_w`, biases `conv{i}_b` and `arch`; `load_vgg_npz`
turns HWIO into OIHW once.
"""

from __future__ import annotations

from math import exp

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..compat.jax_params import vgg_state_dict

# (in, out) of the four convolutions of torchvision vgg19.features[0..8]
VGG19_HEAD_CONVS = ((3, 64), (64, 64), (64, 128), (128, 128))

# the reference's 1-channel VGG16 (cfg 'D', vgg.py:70-99): convolutions
# a block, a tap after each block's second ReLU
VGG16_GRAY_BLOCKS = ((64, 64), (128, 128), (256, 256, 256),
                     (512, 512, 512), (512, 512, 512))


def _conv(x, params, i, pad=1):
    return F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"], padding=pad)


def vgg19_head_taps(params, x):
    """The relu1_2 and relu2_2 activations of the VGG19 head on raw x
    (N, 3, H, W) (JAX :69; nhr_perceptual_loss.py:26-55)."""
    x = F.relu(_conv(x, params, 0))
    x = F.relu(_conv(x, params, 1))
    relu1 = x
    x = F.max_pool2d(x, 2)
    x = F.relu(_conv(x, params, 2))
    x = F.relu(_conv(x, params, 3))
    return relu1, x


def _tap_l1(params, x, target):
    xf = vgg19_head_taps(params, x)
    tf = vgg19_head_taps(params, target)
    return (torch.mean(torch.abs(xf[0] - tf[0]))
            + torch.mean(torch.abs(xf[1] - tf[1]))) / 2.0


def perceptual_loss(params, x, target):
    """(feature_loss, l1_loss) of x against target, (N, C, H, W) with C
    3 (rgb) or 4 (rgb and a mask channel, the trainers' stacking); the
    trainers sum the two (JAX :85)."""
    feature_loss = _tap_l1(params, x[:, 0:3], target[:, 0:3])
    if x.shape[1] > 3:
        feature_loss = feature_loss + _tap_l1(
            params, x[:, 3:4].repeat(1, 3, 1, 1),
            target[:, 3:4].repeat(1, 3, 1, 1))
    return feature_loss, torch.mean(torch.abs(x - target))


def _random_convs(seed, plan):
    """JAX's draw (`random_vgg19_head` :110, `random_vgg16_gray` :209):
    float32 HWIO numpy arrays for each (in, out) of `plan`, in order
    (numpy computes the scaling in float64, which jnp.asarray rounds)."""
    r = np.random.RandomState(seed)
    params = {}
    for i, (cin, cout) in enumerate(plan):
        w = r.randn(3, 3, cin, cout).astype(np.float32) * np.sqrt(2.0 / (9 * cin))
        params[f"conv{i}_w"] = w.astype(np.float32)
        params[f"conv{i}_b"] = (r.randn(cout).astype(np.float32) * 0.01).astype(
            np.float32)
    return params


def random_vgg19_head_arrays(seed: int = 0) -> dict:
    """JAX's `random_vgg19_head(seed)` as HWIO numpy arrays."""
    return _random_convs(seed, VGG19_HEAD_CONVS)


def random_vgg19_head(seed: int = 0, device=None) -> dict:
    """JAX's `random_vgg19_head(seed)` (the same numpy draw), OIHW."""
    return vgg_state_dict(random_vgg19_head_arrays(seed), device)


def _gray_plan():
    plan, cin = [], 1
    for widths in VGG16_GRAY_BLOCKS:
        for cout in widths:
            plan.append((cin, cout))
            cin = cout
    return plan


def random_vgg16_gray_arrays(seed: int = 0) -> dict:
    """JAX's `random_vgg16_gray(seed)` as HWIO numpy arrays."""
    return _random_convs(seed, _gray_plan())


def random_vgg16_gray(seed: int = 0, device=None) -> dict:
    """JAX's `random_vgg16_gray(seed)` (the same numpy draw), OIHW."""
    return vgg_state_dict(random_vgg16_gray_arrays(seed), device)


def load_vgg_npz(path: str, device=None) -> dict:
    """A converted .npz (HWIO, either package's converter) -> OIHW
    tensors on `device` (JAX :125)."""
    z = np.load(path)
    return vgg_state_dict({k: z[k] for k in z.files if k != "arch"}, device)


def vgg16_gray_taps(params, img):
    """The five taps conv{1..5}_2_relu of the 1-channel VGG16 on
    ((mean over channels of img) - 114.451) / 255, img (N, C, H, W) in
    [0, 255] (JAX :141; perceptual_loss.py:57-81). The layers after the
    last tap feed no tap and are skipped."""
    x = (torch.mean(img, dim=1, keepdim=True) - 114.451) / 255.0
    taps, ci = [], 0
    for bi, widths in enumerate(VGG16_GRAY_BLOCKS):
        for wi in range(len(widths)):
            x = F.relu(_conv(x, params, ci))
            ci += 1
            if wi == 1:
                taps.append(x)
                if bi == len(VGG16_GRAY_BLOCKS) - 1:
                    return taps
        x = F.max_pool2d(x, 2)
    return taps


def _gram(f):
    """(N, C, H, W) -> (N, C, C) / (C H W) (JAX :168)."""
    n, c, h, w = f.shape
    m = f.reshape(n, c, h * w)
    return torch.bmm(m, m.transpose(1, 2)) / (c * h * w)


def vgg_perceptual_loss(params, pred, gt, mask=None, layer_weights=None,
                        is_gram: bool = False):
    """The list of the five per-tap losses (JAX :176;
    perceptual_loss.py:83-106): the MSE of each tap, or of its Gram
    matrix with `is_gram` (which, as the reference, ignores the mask),
    weighted by the mask (N, 1, H, W) resized bilinearly to the tap
    with antialiasing, as jax.image.resize does, times the layer's
    weight. pred, gt (N, C, H, W) in [0, 255]."""
    if layer_weights is None:
        layer_weights = (1.0,) * 5
    if is_gram:
        mask = None
    pf = vgg16_gray_taps(params, pred)
    gf = vgg16_gray_taps(params, gt)
    losses = []
    for w, p, g in zip(layer_weights, pf, gf):
        if is_gram:
            p, g = _gram(p), _gram(g)
        d = (p - g) ** 2
        if mask is not None:
            m = mask
            if tuple(m.shape[-2:]) != tuple(p.shape[-2:]):
                m = F.interpolate(m, size=p.shape[-2:], mode="bilinear",
                                  align_corners=False, antialias=True)
            d = d * m
        losses.append(torch.mean(d) * w)
    return losses


def gaussian_window(window_size: int = 11, sigma: float = 1.5):
    """The normalized 1D Gaussian, float32 numpy (JAX :231)."""
    g = np.array([exp(-((i - window_size // 2) ** 2) / (2.0 * sigma ** 2))
                  for i in range(window_size)], np.float32)
    return g / g.sum()


def ssim_map(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """The SSIM map of (N, C, H, W) images: each channel filtered by the
    Gaussian window with zero padding of window_size // 2 (JAX :241;
    ssim.py:15-35)."""
    c = img1.shape[1]
    g1 = gaussian_window(window_size, sigma)
    w2d = np.outer(g1, g1).astype(np.float32)
    w = torch.as_tensor(np.tile(w2d[None, None], (c, 1, 1, 1)),
                        device=img1.device)
    pad = window_size // 2

    def f(x):
        return F.conv2d(x, w, padding=pad, groups=c)

    mu1, mu2 = f(img1), f(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = f(img1 * img1) - mu1_sq
    sigma2_sq = f(img2 * img2) - mu2_sq
    sigma12 = f(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim_loss(img1, img2, window_size: int = 11, loss_weight: float = 1.0):
    """weight * clamp(1 - mean(ssim_map), 0, 1) (JAX :268)."""
    v = torch.mean(ssim_map(img1, img2, window_size))
    return loss_weight * torch.clamp(1.0 - v, 0.0, 1.0)


def gan_loss(pred, target_is_real: bool, use_lsgan: bool = True,
             real_label: float = 1.0, fake_label: float = 0.0):
    """The MSE (LSGAN) or BCE of a prediction against a constant label
    (JAX :279): a tensor, a list of a discriminator's outputs (the last
    scored), or a list of such lists (summed)."""
    if isinstance(pred, (list, tuple)) and isinstance(pred[0], (list, tuple)):
        return sum(gan_loss(p, target_is_real, use_lsgan, real_label,
                            fake_label) for p in pred)
    if isinstance(pred, (list, tuple)):
        pred = pred[-1]
    t = real_label if target_is_real else fake_label
    if use_lsgan:
        return torch.mean((pred - t) ** 2)
    eps = 1e-12
    return -torch.mean(t * torch.log(pred + eps)
                       + (1.0 - t) * torch.log(1.0 - pred + eps))


class NLayerDiscriminator(nn.Module):
    """The pix2pixHD PatchGAN (JAX :303; discriminator.py:52-101): 4x4
    convolutions with padding 2, `n_layers` stride-2 stages doubling the
    width (at most 512), instance norm (no affine) and LeakyReLU(0.2),
    a stride-1 stage and a 1-channel head, `conv{i}` as the flax names.
    NCHW. `get_interm_feat` returns every stage's activation (and, as
    the reference's path, skips the sigmoid)."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, get_interm_feat: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.use_sigmoid = use_sigmoid
        self.get_interm_feat = get_interm_feat
        widths, strides = [ndf], [2]
        nf = ndf
        for _ in range(1, n_layers):
            nf = min(nf * 2, 512)
            widths.append(nf)
            strides.append(2)
        widths.append(min(nf * 2, 512))
        strides.append(1)
        cin = input_nc
        for i, (nf, s) in enumerate(zip(widths, strides)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, nf, 4, s, 2))
            cin = nf
        setattr(self, f"conv{n_layers + 1}", nn.Conv2d(cin, 1, 4, 1, 2))

    def forward(self, x):
        feats = []
        for i in range(self.n_layers + 1):
            x = getattr(self, f"conv{i}")(x)
            if i > 0:
                x = F.group_norm(x, x.shape[1], eps=1e-5)
            x = F.leaky_relu(x, 0.2)
            feats.append(x)
        x = getattr(self, f"conv{self.n_layers + 1}")(x)
        if self.use_sigmoid and not self.get_interm_feat:
            x = torch.sigmoid(x)
        feats.append(x)
        return feats if self.get_interm_feat else x
