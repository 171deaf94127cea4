"""The field modules of the AniNeRF, displacement-field (PDF) and
aligned families.

JAX counterpart: animatable_nerf_tpu/fields/fields.py. Parameter names
follow the reference's PyTorch modules (tpose_nerf_network.py,
anisdf_pdf_network.py, aligned_aninerf_pbw_network.py), as
animatable_nerf_tpu/compat/torch_export.py writes them, so
compat/jax_params.py state dicts and reference checkpoints strict-load.
The 8x256 trunks (the blend-weight fields, NeRF trunk, displacement
field) run through kernel K1 (ops/skip_mlp.py); the heads, the
weight-normalized SDF/NeRF/color networks and the opacity scalars are
plain PyTorch, as the JAX package leaves them to XLA.

Every field computes in its `dtype`, the config's `compute_dtype`
(float32, or bfloat16: JAX fields/fields.py:20-252 with `dtype`), set
on a whole model by `set_compute_dtype`. It is compute-only: the
parameters stay float32. In bf16 the positional encodings are formed in
float32 and cast, the weight norms are formed in float32 before the
cast, the trunks take K1's bf16 form, the heads multiply in bf16 and
the outputs are cast back to float32 where JAX casts them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.encoding import encoding_dim, positional_encoding
from ..core.numerics import clip
from .mlp import (
    WNLinear,
    dense_init_,
    geometric_init_,
    linear,
    run_skip_mlp,
    skip_linears,
)

_SKIPS = (4,)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype):
    """Set the compute dtype (float32 or bfloat16) of every field in
    `model`: each module that has a class attribute `dtype`."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"no {dtype} compute")
    for m in model.modules():
        if hasattr(type(m), "dtype"):
            m.dtype = dtype


def _prior_softmax(owner, linears, pts, smpl_bw, cond, xyz_res: int):
    """The blend-weight fields' common form: [PE(xyz), cond] through the
    skip-4 stack `linears` (K1, its packed weights kept on `owner`) ->
    24 logits, added to log(smpl_bw + 1e-9) and softmaxed. pts (N, 3),
    smpl_bw (N, 24), cond (C,) -> (N, 24)."""
    pe = positional_encoding(pts, xyz_res)
    feat = torch.cat([pe, cond.expand(pe.shape[0], cond.shape[-1])], dim=-1)
    logits = run_skip_mlp(owner, feat, linears, _SKIPS, dtype=owner.dtype)
    return torch.softmax(torch.log(smpl_bw + 1e-9) + logits, dim=-1)


class BlendWeightField(nn.Module):
    """Neural blend-weight field (JAX fields.py:20-50; reference
    tpose_nerf_network.py:25-29, 55-77).

    [PE(xyz) (63), latent (128)] = 191 -> 8x256 skip-4 MLP -> 24 logits,
    added to log(smpl_bw + 1e-9) and softmaxed. The parameters carry
    the reference's names: `bw_latent`, `bw_linears.{i}`, `bw_fc`.
    """

    dtype = torch.float32

    def __init__(self, num_latents: int, xyz_res: int = 10,
                 latent_dim: int = 128):
        super().__init__()
        self.xyz_res = xyz_res
        din = encoding_dim(xyz_res, 3) + latent_dim
        self.bw_latent = nn.Embedding(num_latents, latent_dim)
        self.bw_linears = skip_linears(din, 256, 8, _SKIPS)
        self.bw_fc = nn.Linear(256, 24)

    def blend_weights(self, pts, smpl_bw, latent_index: int):
        """pts (N, 3); smpl_bw (N, 24); latent_index int -> (N, 24)."""
        return _prior_softmax(self, [*self.bw_linears, self.bw_fc], pts,
                              smpl_bw, self.bw_latent.weight[int(latent_index)],
                              self.xyz_res)

    def forward(self, pts, smpl_bw, latent_index: int):
        return self.blend_weights(pts, smpl_bw, latent_index)


class _Unread(nn.Module):
    """A table the reference declares and its forward never reads, kept
    as a buffer `weight` of zeros: reference state dicts strict-load,
    and no optimizer sees it."""

    def __init__(self, rows: int, dim: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(rows, dim))


class PoseCondBWField(nn.Module):
    """Blend-weight field conditioned on the 72-d pose vector in place of
    a frame latent (JAX models/aligned.py:53-68; reference
    aligned_aninerf_pbw_network.py:45-60): [PE(xyz) (63), pose (72)] =
    135 -> 8x256 skip-4 MLP -> 24 logits, added to log(smpl_bw + 1e-9)
    and softmaxed. The parameters carry the reference's names
    `bw_linears.{i}`, `bw_fc`. The reference also declares a frame-latent
    table `bw_latent`, (num_train_frame + 1, 128), that its forward
    never reads; it is kept as zeros (`_Unread`), as the JAX exporter
    synthesizes it (compat/torch_export.py:250-262)."""

    dtype = torch.float32

    def __init__(self, num_latents: int, xyz_res: int = 10,
                 pose_dim: int = 72, latent_dim: int = 128):
        super().__init__()
        self.xyz_res = xyz_res
        self.bw_latent = _Unread(num_latents, latent_dim)
        self.bw_linears = skip_linears(encoding_dim(xyz_res, 3) + pose_dim,
                                       256, 8, _SKIPS)
        self.bw_fc = nn.Linear(256, 24)

    def blend_weights(self, pts, smpl_bw, pose_vec):
        """pts (N, 3); smpl_bw (N, 24); pose_vec (72,) -> (N, 24)."""
        return _prior_softmax(self, [*self.bw_linears, self.bw_fc], pts,
                              smpl_bw, pose_vec, self.xyz_res)

    def forward(self, pts, smpl_bw, pose_vec):
        return self.blend_weights(pts, smpl_bw, pose_vec)


class TPoseNeRF(nn.Module):
    """Canonical-space NeRF (JAX fields.py:78-151; reference
    tpose_nerf_network.py:218-275).

    PE(xyz) -> 8x256 skip-4 trunk, all 8 layers activated -> alpha_fc;
    feature_fc(trunk) concat the 128-d frame latent -> latent_fc (no
    activation); concat PE(viewdir) -> view_fc -> relu -> rgb_fc.
    In bf16 the trunk's output and every head stay bf16 up to sigma and
    the rgb logits, cast to float32 (JAX fields.py:104-151).
    """

    dtype = torch.float32

    def __init__(self, num_latents: int, xyz_res: int = 10,
                 view_res: int = 4):
        super().__init__()
        self.xyz_res = xyz_res
        self.view_res = view_res
        pe_dim = encoding_dim(xyz_res, 3)
        self.pts_linears = skip_linears(pe_dim, 256, 8, _SKIPS)
        self.alpha_fc = nn.Linear(256, 1)
        self.feature_fc = nn.Linear(256, 256)
        self.nf_latent = nn.Embedding(num_latents, 128)
        self.latent_fc = nn.Linear(256 + 128, 256)
        self.view_fc = nn.Linear(256 + encoding_dim(view_res, 3), 128)
        self.rgb_fc = nn.Linear(128, 3)

    def trunk(self, pts):
        """(N, 3) -> (N, 256) in the compute dtype (K1's bf16 form
        rounds the activated last layer to bf16, so the cast is exact)."""
        pe = positional_encoding(pts, self.xyz_res)
        h = run_skip_mlp(self, pe, self.pts_linears, _SKIPS, act_last=True,
                         dtype=self.dtype)
        return h.to(self.dtype)

    def density(self, pts):
        """The density alone, trunk plus `alpha_fc` (JAX fields.py:131-134;
        reference tpose_nerf_network.py:241-250 `calculate_alpha`): pts
        (N, 3) -> sigma (N,)."""
        return linear(self.alpha_fc, self.trunk(pts), self.dtype)[..., 0].float()

    def forward(self, pts, viewdir, latent_index: int):
        """pts (N, 3), viewdir (N, 3) -> (sigma (N,), rgb_logits (N, 3))."""
        dt = self.dtype
        h = self.trunk(pts)
        sigma = linear(self.alpha_fc, h, dt)[..., 0].float()
        feat = linear(self.feature_fc, h, dt)
        latent = self.nf_latent.weight[int(latent_index)].to(dt)
        feat = linear(self.latent_fc, torch.cat(
            [feat, latent.expand(feat.shape[0], 128)], dim=-1), dt)
        vdir = positional_encoding(viewdir, self.view_res).to(dt)
        h2 = torch.relu(linear(self.view_fc, torch.cat([feat, vdir], dim=-1),
                               dt))
        return sigma, linear(self.rgb_fc, h2, dt).float()


def displacement_layers(xyz_res: int = 10, pose_dim: int = 72):
    """The displacement field's layers (`resd_linears`, `resd_fc`):
    [PE(xyz) (63), pose (72)] = 135 -> 8x256 skip-4 MLP -> 3, with JAX's
    SkipMLP init, lecun_normal kernels and zero biases, so the initial
    displacement is near 0."""
    linears = skip_linears(encoding_dim(xyz_res, 3) + pose_dim, 256, 8,
                           _SKIPS)
    fc = nn.Linear(256, 3)
    dense_init_([*linears, fc])
    return linears, fc


def displacement(owner, linears, pts, pose_vec, xyz_res: int,
                 dtype: torch.dtype = torch.float32):
    """The displacement 0.05 * tanh(MLP([PE(pts), pose])) of the layers
    `linears` (K1 in `dtype`, its packed weights kept on `owner`; the
    tanh in float32): pts (N, 3), pose_vec (72,) -> (N, 3)."""
    pe = positional_encoding(pts, xyz_res)
    feat = torch.cat(
        [pe, pose_vec.expand(pe.shape[0], pose_vec.shape[-1])], dim=-1
    )
    return 0.05 * torch.tanh(run_skip_mlp(owner, feat, linears, _SKIPS,
                                          dtype=dtype))


class ResidualField(nn.Module):
    """Pose-dependent displacement field (JAX fields.py:53; reference
    anisdf_pdf_network.py:23-32, 49-73): [PE(xyz) (63), pose (72)] = 135
    -> 8x256 skip-4 MLP -> 3, scaled by 0.05 * tanh. The parameters
    carry the reference's names `resd_linears.{i}`, `resd_fc`. Initial
    weights as JAX's SkipMLP (`displacement_layers`)."""

    dtype = torch.float32

    def __init__(self, xyz_res: int = 10, pose_dim: int = 72):
        super().__init__()
        self.xyz_res = xyz_res
        self.resd_linears, self.resd_fc = displacement_layers(xyz_res,
                                                              pose_dim)

    def residual(self, pts, pose_vec):
        """pts (N, 3); pose_vec (72,) -> resd (N, 3)."""
        return displacement(self, [*self.resd_linears, self.resd_fc], pts,
                            pose_vec, self.xyz_res, self.dtype)


class _Softplus(torch.autograd.Function):
    """jax.nn.softplus, logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with JAX's derivative (lax logaddexp's jvp): g * exp(x - out), in
    x's dtype. Autograd through the forward's ops would round other
    intermediates in bf16: the bf16 SDF normals then differ from JAX's
    by 2% of their largest entry, by 0.4% with this form. The backward
    is differentiable again (a gradient of the normals), through `out`
    back into this function, as JAX differentiates its jvp."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad * torch.exp(x - out)


_softplus = _Softplus.apply


class GeometricFieldNetwork(nn.Module):
    """Weight-normalized 9-layer SDF network, also NeRF-PDF's softplus
    NeRF (JAX fields.py:154; reference anisdf_pdf_network.py:348-453,
    aligned_aninerf_pdf_network.py:204-292): PE(xyz) with multires 6
    (39 channels) -> lin0..lin8, softplus(100 x)/100 after all but the
    last; before lin4 x = [x, inputs] / sqrt(2), so lin3 outputs
    256 - 39 = 217. Output (N, 257): channel 0 the sdf (or the
    pre-activation density), 1: the feature.
    Initial weights: the IDR geometric init (`geometric_init_`), an sdf
    near |x| - 0.5. In bf16 (JAX fields.py:189-207) the encoding is cast
    to bf16, the skip divides by sqrt(2) rounded to bf16, every layer
    and softplus computes in bf16, and the output is cast to float32.
    """

    dtype = torch.float32

    def __init__(self, multires: int = 6, d_hidden: int = 256,
                 n_layers: int = 8, d_out: int = 257, skip_in=(4,)):
        super().__init__()
        self.multires = multires
        self.skip_in = tuple(skip_in)
        d_pe = encoding_dim(multires, 3)
        dims = [d_pe] + [d_hidden] * n_layers + [d_out]
        for l in range(len(dims) - 1):
            out_dim = dims[l + 1] - d_pe if (l + 1) in self.skip_in else dims[l + 1]
            setattr(self, f"lin{l}", WNLinear(dims[l], out_dim))
        self.n_linear = len(dims) - 1
        geometric_init_([getattr(self, f"lin{l}") for l in range(self.n_linear)],
                        d_pe, self.skip_in)

    def forward(self, pts):
        dt = self.dtype
        inputs = positional_encoding(pts, self.multires).to(dt)
        # np.sqrt(2).astype(dtype), as JAX divides
        sqrt2 = torch.tensor(math.sqrt(2), dtype=dt).item()
        x = inputs
        for l in range(self.n_linear):
            if l in self.skip_in:
                x = torch.cat([x, inputs], dim=-1) / sqrt2
            x = getattr(self, f"lin{l}")(x, dt)
            if l < self.n_linear - 1:
                x = _softplus(100.0 * x) / 100.0
        return x.float()


class ColorNetwork(nn.Module):
    """IDR-style rendering network (JAX fields.py:210; reference
    anisdf_pdf_network.py:468-549 with normals,
    aligned_aninerf_pdf_network.py:296-379 without): [points (3),
    PE(viewdir) (27), normals (3) with `use_normals`, feature (256)] ->
    lin0..lin2 (256, relu) -> concat the 128-d frame latent -> lin3
    (relu) -> lin4 -> sigmoid. All layers weight-normalized. In bf16 the
    inputs are cast to bf16, the layers compute in bf16 and lin4's
    output is cast to float32 before the sigmoid (JAX fields.py:232-252).
    """

    dtype = torch.float32

    def __init__(self, num_latents: int, view_res: int = 4,
                 d_feature: int = 256, use_normals: bool = True):
        super().__init__()
        self.view_res = view_res
        self.use_normals = bool(use_normals)
        din = (3 + encoding_dim(view_res, 3) + (3 if use_normals else 0)
               + d_feature)
        self.color_latent = nn.Embedding(num_latents, 128)
        self.lin0 = WNLinear(din, 256)
        self.lin1 = WNLinear(256, 256)
        self.lin2 = WNLinear(256, 256)
        self.lin3 = WNLinear(256 + 128, 256)
        self.lin4 = WNLinear(256, 3)

    def forward(self, points, normals, viewdirs, features, latent_index: int):
        """normals is read only with `use_normals` (None otherwise)."""
        dt = self.dtype
        parts = [points, positional_encoding(viewdirs, self.view_res)]
        if self.use_normals:
            parts.append(normals)
        x = torch.cat([p.to(dt) for p in (*parts, features)], dim=-1)
        h = torch.relu(self.lin0(x, dt))
        h = torch.relu(self.lin1(h, dt))
        h = torch.relu(self.lin2(h, dt))
        latent = self.color_latent.weight[int(latent_index)].to(dt)
        h = torch.relu(self.lin3(
            torch.cat([h, latent.expand(h.shape[0], 128)], dim=-1), dt))
        return torch.sigmoid(self.lin4(h, dt).float())


class BetaNetwork(nn.Module):
    """The learnable VolSDF beta, clipped to [1e-9, 1e6] (JAX
    fields.py:255; reference anisdf_pdf_network.py:456-465)."""

    def __init__(self, init_val: float = 0.1):
        super().__init__()
        self.beta = nn.Parameter(torch.tensor(init_val))

    def forward(self):
        return torch.clamp(self.beta, 1e-9, 1e6)


class SingleVarianceNetwork(nn.Module):
    """NeuS's learnable inverse variance, exp(10 s) clipped to [1e-6,
    1e6] (JAX fields.py:266; reference anisdf_neus_pdf_network.py:
    373-383), with s the parameter `variance`; the clip has JAX's
    gradient at its bounds (`numerics.clip`)."""

    def __init__(self):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(0.2))

    def forward(self):
        return clip(torch.exp(10.0 * self.variance), 1e-6, 1e6)
