"""Stratified sampling of z-values along rays.

JAX counterpart: animatable_nerf_tpu/core/sampling.py (reference
lib/networks/renderer/tpose_renderer.py:14-39, :63-66). The eval path
samples without perturbation; training's jitter comes with the
training slice.
"""

from __future__ import annotations

import torch


def stratified_z_vals(near, far, n_samples: int):
    """(R,) near/far -> (R, S) evenly spaced z values (eval: no jitter)."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                       device=near.device)
    return near[..., None] * (1.0 - t) + far[..., None] * t


def z_vals_to_pts(ray_o, ray_d, z_vals):
    """(..., 3), (..., 3), (..., S) -> (..., S, 3) world points."""
    return ray_o[..., None, :] + ray_d[..., None, :] * z_vals[..., None]


def z_vals_to_dists(z_vals):
    """Per-sample step sizes; the last interval is repeated."""
    d = z_vals[..., 1:] - z_vals[..., :-1]
    return torch.cat([d, d[..., -1:]], dim=-1)
