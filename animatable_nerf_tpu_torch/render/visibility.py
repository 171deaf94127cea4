"""Multi-view visibility carving of the mesh sweep.

JAX counterpart: animatable_nerf_tpu/render/visibility.py
(`prepare_inside_mask` :15-36; reference
lib/networks/renderer/tpose_renderer_mmsk.py:14-57 `prepare_inside_pts`).
"""

from __future__ import annotations

import torch


def prepare_inside_mask(pts, Ks, RTs, masks):
    """pts (N, 3), Ks (V, 3, 3), RTs (V, 3, 4), masks (V, H, W) ->
    (N,) bool: whether each point projects into the foreground of every
    view. The pixel is the projection rounded half to even and clamped
    into the image, so a point projecting outside reads the border
    pixel (tpose_renderer_mmsk.py:41-47)."""
    V, H, W = masks.shape
    cam = torch.einsum("vij,nj->vni", RTs[:, :, :3], pts) + RTs[:, None, :, 3]
    pix = torch.einsum("vij,vnj->vni", Ks, cam)
    uv = pix[..., :2] / pix[..., 2:]
    u = torch.clamp(torch.round(uv[..., 0]).long(), 0, W - 1)
    v = torch.clamp(torch.round(uv[..., 1]).long(), 0, H - 1)
    vals = torch.gather(masks.reshape(V, -1), 1, v * W + u) > 0
    return torch.all(vals, dim=0)
