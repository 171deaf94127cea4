"""The NHR baseline's point splatter in plain PyTorch.

JAX counterpart: animatable_nerf_tpu/ops/rasterize.py:34
`rasterize_points` (XLA, not Pallas; it replaces the reference's PCPR
CUDA rasterizer). Each point is projected through K, R, T, its pixel
rounded half to even (torch.round, as jnp.round), and written over a
(2r+1)^2 footprint. Pass one keeps each pixel's least depth (a
scatter-min); pass two keeps the lowest point index among the points
within Z_EPS of it. Off-screen points and points behind the camera go
to a sentinel pixel past the image, which is dropped. The features are
gathered by the winning index (index_select, whose backward is a
scatter-add), so their gradient reaches the winners and only them. The
footprint's offsets are scattered in one call per pass: a minimum does
not depend on the order.
"""

from __future__ import annotations

import torch

_INF = 1.0e38
# a point within this depth of a pixel's nearest is a candidate winner
Z_EPS = 1e-4


def rasterize_points(pts, features, K, R, T, H: int, W: int,
                     splat_radius: int = 1) -> dict:
    """Splat (P, 3) world points with (P, C) features through K (3, 3),
    R (3, 3) and T (3, 1), world to camera. Returns feature_map (H, W,
    C), depth (H, W) (0 where empty), index (H, W) int64 (-1 where
    empty) and mask (H, W) bool."""
    P = pts.shape[0]
    cam = pts @ R.T + T.reshape(1, 3)
    uvw = cam @ K.T
    depth = uvw[:, 2]
    u = uvw[:, 0] / torch.clamp(depth, min=1e-8)
    v = uvw[:, 1] / torch.clamp(depth, min=1e-8)
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    npix = H * W
    r = splat_radius
    offsets = torch.tensor([(dy, dx) for dy in range(-r, r + 1)
                            for dx in range(-r, r + 1)], device=pts.device)
    uu = ui[None] + offsets[:, 1:2]
    vv = vi[None] + offsets[:, 0:1]
    valid = (depth > 1e-8)[None] & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
    flat = torch.where(valid, vv * W + uu, npix).reshape(-1)
    n = len(offsets)

    with torch.no_grad():
        d = depth.detach()
        zbuf = torch.full((npix + 1,), _INF, dtype=d.dtype, device=d.device)
        zbuf.scatter_reduce_(0, flat, d.repeat(n), "amin")
        pid = torch.arange(P, device=d.device).repeat(n)
        front = d.repeat(n) <= zbuf[flat] + Z_EPS
        winner = torch.full((npix + 1,), P, dtype=torch.int64, device=d.device)
        winner.scatter_reduce_(0, torch.where(front, flat, npix), pid, "amin")
    winner, zbuf = winner[:npix], zbuf[:npix]
    mask = winner < P
    safe = torch.where(mask, winner, 0)
    fmap = torch.where(mask[:, None], torch.index_select(features, 0, safe), 0.0)
    return {
        "feature_map": fmap.reshape(H, W, -1),
        "depth": torch.where(mask, zbuf, 0.0).reshape(H, W),
        "index": torch.where(mask, winner, -1).reshape(H, W),
        "mask": mask.reshape(H, W),
    }
