"""Volume-rendering compositing.

JAX counterpart: animatable_nerf_tpu/core/composite.py (reference
lib/networks/renderer/nerf_net_utils.py:6-36, :78-88 for
`get_intersection_mask`). `composite_compacted`
computes what the JAX function of that name computes (composite.py:
71-131) from a survivor-compacted sample stream. The JAX code runs a
segmented Hillis-Steele scan because TPU scatters serialize; here the
survivors scatter back into the dense (R, S) layout and `raw2outputs`
composites it. The two differ by the (1 + 1e-10) transmittance factors
of skipped samples, which the JAX docstring bounds at ~6e-9 for S=64.
"""

from __future__ import annotations

import torch


def raw2outputs(raw, z_vals, white_bkgd: bool = False):
    """Classic NeRF alpha compositing.

    raw (..., S, 4): activated rgb + alpha; z_vals (..., S).
    Returns rgb_map (..., 3), disp_map, acc_map, weights (..., S),
    depth_map.
    """
    rgb = raw[..., :-1]
    weights = alpha_weights(raw[..., -1])
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map


def alpha_weights(alpha):
    """The compositing weights of alpha (..., S): alpha times the
    transmittance, the cumulative product of 1 - alpha + 1e-10 before
    each sample (`raw2outputs`'s)."""
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(
        torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1
    )[..., :-1]
    return alpha * trans


def sample_pdf(bins, weights, n_samples: int):
    """Inverse-CDF hierarchical sampling, its deterministic form (JAX
    composite.py:134-166 with det; reference nerf_net_utils.py:40-75):
    bins (R, B), weights (R, B - 1) -> samples (R, n_samples). The
    weights get a 1e-5 floor, so a ray of all-zero weights samples its
    bins evenly; u is an even grid on [0, 1] (JAX's jnp.linspace, as
    core/sampling.py forms it); each u falls in the CDF bin
    searchsorted(..., right=True) finds, and a bin of CDF width under
    1e-5 takes width 1. The inverse CDF is discontinuous at such a bin
    (a zero weight beside larger ones), so where the CDF's last entry
    rounds to the other side of 1 than JAX's sums make it, the last
    sample (u = 1) lands at the start of the last such bin instead of
    its end."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.expand(*cdf.shape[:-1], n_samples).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_g0 = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_g1 = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def scatter_raw(sidx, rgb, alpha, n_rays: int, n_samples: int):
    """Survivor rows (sidx ascending flat sample indices) -> dense
    (R, S, 4) raw with zeros elsewhere."""
    raw = torch.zeros(n_rays * n_samples, 4, dtype=rgb.dtype,
                      device=rgb.device)
    raw[sidx] = torch.cat([rgb, alpha[:, None]], dim=-1)
    return raw.reshape(n_rays, n_samples, 4)


def composite_compacted(sidx, rgb, alpha, z_vals, n_rays: int,
                        n_samples: int):
    """Maps of a compacted sample stream: sidx (K,) flat sample indices,
    rgb (K, 3), alpha (K,), z_vals (R, S) -> (rgb_map, acc_map,
    depth_map)."""
    raw = scatter_raw(sidx, rgb, alpha, n_rays, n_samples)
    rgb_map, _, acc_map, _, depth_map = raw2outputs(raw, z_vals)
    return rgb_map, acc_map, depth_map


def get_intersection_mask(sdf):
    """Per-ray surface crossing (JAX composite.py:165-177): sdf (..., S)
    -> mask (...,) bool, true where some pair of neighbouring samples
    changes sign. JAX's index of the crossing is not ported: no path
    of the port reads it."""
    sign = torch.sign(sdf[..., :-1] * sdf[..., 1:])
    return sign.min(dim=-1).values == -1
