"""The field modules of the AniNeRF family.

JAX counterpart: animatable_nerf_tpu/fields/fields.py. Parameter names
follow the reference's PyTorch modules (tpose_nerf_network.py), as
animatable_nerf_tpu/compat/torch_export.py:90-109 writes them, so
compat/jax_params.py state dicts and reference checkpoints strict-load.
Both 8x256 trunks run through kernel K1 (ops/skip_mlp.py); the heads
are plain nn.Linear, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.encoding import encoding_dim, positional_encoding
from .mlp import run_skip_mlp, skip_linears

_SKIPS = (4,)


class BlendWeightField(nn.Module):
    """Neural blend-weight field (JAX fields.py:20-50; reference
    tpose_nerf_network.py:25-29, 55-77).

    [PE(xyz) (63), latent (128)] = 191 -> 8x256 skip-4 MLP -> 24 logits,
    added to log(smpl_bw + 1e-9) and softmaxed. The parameters carry
    the reference's names: `bw_latent`, `bw_linears.{i}`, `bw_fc`.
    """

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
        pe = positional_encoding(pts, self.xyz_res)
        latent = self.bw_latent.weight[int(latent_index)]
        feat = torch.cat(
            [pe, latent.expand(pe.shape[0], latent.shape[0])], dim=-1
        )
        logits = run_skip_mlp(feat, [*self.bw_linears, self.bw_fc], _SKIPS)
        return torch.softmax(torch.log(smpl_bw + 1e-9) + logits, dim=-1)

    def forward(self, pts, smpl_bw, latent_index: int):
        return self.blend_weights(pts, smpl_bw, latent_index)


class TPoseNeRF(nn.Module):
    """Canonical-space NeRF (JAX fields.py:78-151; reference
    tpose_nerf_network.py:218-275).

    PE(xyz) -> 8x256 skip-4 trunk, all 8 layers activated -> alpha_fc;
    feature_fc(trunk) concat the 128-d frame latent -> latent_fc (no
    activation); concat PE(viewdir) -> view_fc -> relu -> rgb_fc.
    """

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
        pe = positional_encoding(pts, self.xyz_res)
        return run_skip_mlp(pe, self.pts_linears, _SKIPS, act_last=True)

    def forward(self, pts, viewdir, latent_index: int):
        """pts (N, 3), viewdir (N, 3) -> (sigma (N,), rgb_logits (N, 3))."""
        h = self.trunk(pts)
        sigma = self.alpha_fc(h)[..., 0]
        feat = self.feature_fc(h)
        latent = self.nf_latent.weight[int(latent_index)]
        feat = self.latent_fc(
            torch.cat([feat, latent.expand(feat.shape[0], 128)], dim=-1)
        )
        vdir = positional_encoding(viewdir, self.view_res)
        h2 = torch.relu(self.view_fc(torch.cat([feat, vdir], dim=-1)))
        return sigma, self.rgb_fc(h2)
