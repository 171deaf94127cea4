"""Shared helpers of the model layer.

JAX counterpart: animatable_nerf_tpu/models/common.py (the subset the
AniNeRF eval path uses).
"""

from __future__ import annotations

import torch


def keep_mask_with_argmin(norm_vals, threshold):
    """mask = norm_vals < threshold, with the argmin point forced on
    (the reference's keep-at-least-one, tpose_nerf_network.py:153-154).
    Non-finite values become +inf first, so they never win the argmin;
    ties go to the first index, as in jnp.argmin."""
    norm_vals = torch.where(
        torch.isfinite(norm_vals), norm_vals,
        torch.full_like(norm_vals, float("inf")),
    )
    mask = norm_vals < threshold
    if mask.numel():
        mask[torch.argmin(norm_vals)] = True
    return mask


def inside_bounds(pts, bounds):
    """Strict all-axes AABB membership: (N, 3), (2, 3) -> (N,) bool
    (reference tpose_nerf_network.py:186-188)."""
    return torch.all((pts > bounds[0]) & (pts < bounds[1]), dim=-1)


def raw_alpha_from_sigma(sigma, dists):
    """alpha = 1 - exp(-relu(sigma) * dists) (tpose_nerf_network.py:201)."""
    return 1.0 - torch.exp(-torch.relu(sigma) * dists)


def volume_lipschitz_bound(vol, bounds):
    """Certified Lipschitz bound of a trilinearly interpolated volume
    vol (D, H, W) over bounds (2, 3): per-axis max adjacent-sample
    difference over the cell size, combined in the 2-norm."""
    sizes = torch.tensor(vol.shape, dtype=vol.dtype, device=vol.device)
    cell = (bounds[1] - bounds[0]) / torch.clamp(sizes - 1.0, min=1.0)
    lx = torch.max(torch.abs(torch.diff(vol, dim=0))) / cell[0]
    ly = torch.max(torch.abs(torch.diff(vol, dim=1))) / cell[1]
    lz = torch.max(torch.abs(torch.diff(vol, dim=2))) / cell[2]
    return torch.sqrt(lx * lx + ly * ly + lz * lz)
