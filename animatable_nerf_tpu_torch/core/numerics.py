"""Backward-safe elementary functions.

JAX counterpart: animatable_nerf_tpu/core/numerics.py:25-42. `sqrt`
and `linalg.norm` have an infinite (torch: NaN) derivative at exactly 0.
The dense train path evaluates every point and masks afterwards, so an
exact zero occurs: a zero-initialised displacement field has
||resd|| = 0 at every point. These helpers are exact in value and carry
a zero gradient at 0 instead. `clip` is `jnp.clip` with JAX's gradient
at the bounds.
"""

from __future__ import annotations

import torch


def safe_sqrt(x):
    """sqrt with a zero subgradient at x <= 0 (value: sqrt of the
    clamped input). NaN stays NaN (x * 0), so a garbage distance still
    fails a filter downstream."""
    positive = x > 0
    root = torch.sqrt(torch.where(positive, x, torch.ones_like(x)))
    return torch.where(positive, root, x * 0.0)


def safe_norm(x, dim: int = -1, keepdim: bool = False):
    """L2 norm with a zero subgradient at ||x|| = 0 (value identical)."""
    return safe_sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi) as JAX differentiates it, minimum(maximum(x,
    lo), hi): at x exactly on a bound the gradient is 0.5 (torch.clamp
    gives 1). Training meets such ties: NeuS's alpha is exactly 1 where
    the next sample's cdf lies below the rounding of this one's."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))
