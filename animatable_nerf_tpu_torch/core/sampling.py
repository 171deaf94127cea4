"""Stratified sampling of z-values along rays.

JAX counterpart: animatable_nerf_tpu/core/sampling.py (reference
lib/networks/renderer/tpose_renderer.py:14-39, :63-66). Training's
jitter draws from an explicit torch.Generator where JAX splits a PRNG
key, so the two packages jitter alike in distribution, not in value;
with `perturb` off both sample the same grid.
"""

from __future__ import annotations

import torch


def stratified_z_vals(near, far, n_samples: int, perturb: bool = False,
                      generator: torch.Generator | None = None):
    """(R,) near/far -> (R, S) evenly spaced z values; with `perturb`
    (training), each jittered uniformly within its interval between
    the midpoints (JAX sampling.py:13-35)."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                       device=near.device)
    z = near[..., None] * (1.0 - t) + far[..., None] * t
    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        u = torch.rand(z.shape, generator=generator, dtype=z.dtype,
                       device=z.device)
        z = lower + (upper - lower) * u
    return z


def z_vals_to_pts(ray_o, ray_d, z_vals):
    """(..., 3), (..., 3), (..., S) -> (..., S, 3) world points."""
    return ray_o[..., None, :] + ray_d[..., None, :] * z_vals[..., None]


def z_vals_to_dists(z_vals):
    """Per-sample step sizes; the last interval is repeated."""
    d = z_vals[..., 1:] - z_vals[..., :-1]
    return torch.cat([d, d[..., -1:]], dim=-1)
