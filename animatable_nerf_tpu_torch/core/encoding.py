"""NeRF positional encoding.

JAX counterpart: animatable_nerf_tpu/core/encoding.py (reference
lib/networks/embedder.py:5-54). Output is the raw input followed by,
for each of `multires` log-spaced frequencies 2^0 .. 2^(multires-1),
sin(x*f) then cos(x*f) over all input dims.
"""

from __future__ import annotations

import torch


def encoding_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """(..., d) -> (..., d * (1 + 2 * multires)), band order
    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]."""
    if multires == 0:
        return x
    freqs = 2.0 ** torch.linspace(
        0.0, multires - 1, multires, dtype=x.dtype, device=x.device
    )
    xb = x[..., None, :] * freqs[:, None]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = sc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, enc], dim=-1)
