"""SDF -> opacity (VolSDF Laplace CDF, NeuS sigmoid-CDF residuals).

JAX counterpart: animatable_nerf_tpu/core/sdf.py:22 `volsdf_sigma`, :35
`sigma_to_alpha` (reference anisdf_pdf_network.py:271-286, 330-331) and
:42 `neus_alpha` (reference sdf_utils.py:40-61).
"""

from __future__ import annotations

import torch

from .numerics import clip


def volsdf_sigma(sdf, beta):
    """Laplace-CDF density with scale beta; with x = -sdf:
    x <= 0: 0.5/beta * exp(x/beta), x > 0: 1/beta * (1 - 0.5 exp(-x/beta))."""
    x = -sdf
    val0 = 0.5 / beta * torch.exp(torch.clamp(x, max=0.0) / beta)
    val1 = 1.0 / beta * (1.0 - 0.5 * torch.exp(-torch.clamp(x, min=0.0) / beta))
    return torch.where(x <= 0, val0, val1)


def sigma_to_alpha(sigma, step: float = 0.005):
    """alpha = 1 - exp(-relu(sigma) * step); the reference hard-codes the
    0.005 step whatever the sample spacing."""
    return 1.0 - torch.exp(-torch.clamp(sigma, min=0.0) * step)


def neus_alpha(sdf, inv_variance):
    """NeuS opacity of ray-ordered samples: sdf (R, S), masked samples
    holding a large positive value (+10, whose cdf ~= 1 is the
    reference's `full_cdf = 1` fill) -> alpha (R, S).
    cdf = sigmoid(sdf * inv_variance), p_i = cdf_i - cdf_{i+1} with the
    last residual repeated, alpha = clip((p + 1e-5) / (cdf + 1e-5), 0, 1),
    the clip differentiated as JAX's (`numerics.clip`)."""
    cdf = 1.0 / (1.0 + torch.exp(-sdf * inv_variance))
    residual = cdf[..., :-1] - cdf[..., 1:]
    p = torch.cat([residual, residual[..., -1:]], dim=-1)
    return clip((p + 1e-5) / (cdf + 1e-5), 0.0, 1.0)
