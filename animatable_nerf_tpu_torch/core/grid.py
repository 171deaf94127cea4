"""Trilinear lookup in a channels-last voxel volume with PyTorch
`grid_sample` semantics (align_corners=True, padding_mode='border').

JAX counterpart: animatable_nerf_tpu/core/grid.py:218-270
(`pts_sample_blend_weights_packed`, `pts_sample_blend_weights`;
reference lib/utils/blend_utils.py:119-149). Volume axis 0 (D) is
indexed by x, axis 1 (H) by y and axis 2 (W) by z — the reference's
xyz->zyx flip before grid_sample. The JAX package gathers from a
corner-packed copy of the volume because TPU gathers cost per row;
here the 8 corners are gathered directly from the (D, H, W, C) volume,
with the same cell choice, corner weights and summation order as the
packed formula, so the values agree. `grid_bilerp` is the 2-D lookup
of the NT baseline's texture pyramid.
"""

from __future__ import annotations

import torch

from .numerics import clip

# corner order of the JAX packed layout: dx-major, then dy, dz
_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def grid_trilerp(vol: torch.Tensor, pts01: torch.Tensor) -> torch.Tensor:
    """Sample `vol` (D, H, W, C) at normalized points (..., 3) in [0, 1]
    (border-clamped outside). Returns (..., C) in vol's float type
    promoted with pts01's."""
    D, H, W, C = vol.shape
    batch_shape = pts01.shape[:-1]
    p = pts01.reshape(-1, 3)
    sizes = torch.tensor([D, H, W], dtype=p.dtype, device=p.device)
    idx = torch.minimum(torch.clamp(p * (sizes - 1.0), min=0.0), sizes - 1.0)
    last_cell = torch.tensor([D - 2, H - 2, W - 2], device=p.device)
    i0 = torch.minimum(torch.floor(idx).long(), last_cell)
    frac = idx - i0.to(idx.dtype)
    lin = (i0[:, 0] * H + i0[:, 1]) * W + i0[:, 2]
    flat = vol.reshape(-1, C)

    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    gx, gy, gz = 1 - fx, 1 - fy, 1 - fz
    weights = (
        gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
        fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz,
    )
    out = None
    for w, (dx, dy, dz) in zip(weights, _CORNERS):
        g = flat[lin + ((dx * H + dy) * W + dz)].to(p.dtype)
        out = w * g if out is None else out + w * g
    return out.reshape(*batch_shape, C)


def pts_sample_blend_weights(pts, vol, bounds):
    """Interpolate per-point channels from a voxel volume.

    pts (..., 3) SMPL coordinates; vol (D, H, W, C) (24 blend weights +
    1 distance channel in `lbs/bweights/<i>.npy`); bounds (2, 3).
    """
    mn, mx = bounds[0], bounds[1]
    return grid_trilerp(vol, (pts - mn) / (mx - mn))


def pack_corner_volume(vol: torch.Tensor) -> torch.Tensor:
    """(D, H, W, C) -> (D-1, H-1, W-1, 8*C): each cell holds the channels
    of its 8 corners, in the order (0,0,0),(0,0,1),(0,1,0),(0,1,1),
    (1,0,0),(1,0,1),(1,1,0),(1,1,1) (JAX core/grid.py:65). The port keeps
    the layout for the per-frame distance grid, whose reader
    (`grid_corner_distance_bound`) wants all 8 corners of a cell."""
    D, H, W, _ = vol.shape
    return torch.cat(
        [vol[dx:D - 1 + dx, dy:H - 1 + dy, dz:W - 1 + dz]
         for dx, dy, dz in _CORNERS],
        dim=-1,
    )


def _corner_distances(packed, pts01, cell):
    """The cell's 8 corner values (n, 8) f32 and the distances |x - c_i|
    (8 tensors (n,)) in pack_corner_volume's corner order, for points
    pts01 (..., 3) normalized to the res^3 grid (border-clamped)."""
    Dm, Hm, Wm, _ = packed.shape
    p = pts01.reshape(-1, 3)
    sizes = torch.tensor([Dm + 1, Hm + 1, Wm + 1], dtype=p.dtype,
                         device=p.device)
    idx = torch.minimum(torch.clamp(p * (sizes - 1.0), min=0.0), sizes - 1.0)
    last_cell = torch.tensor([Dm - 1, Hm - 1, Wm - 1], device=p.device)
    i0 = torch.minimum(torch.floor(idx).long(), last_cell)
    frac = idx - i0.to(idx.dtype)
    lin = (i0[:, 0] * Hm + i0[:, 1]) * Wm + i0[:, 2]
    g = packed.reshape(-1, 8)[lin].to(torch.float32)

    fx, fy, fz = frac[:, 0] * cell[0], frac[:, 1] * cell[1], frac[:, 2] * cell[2]
    gx, gy, gz = cell[0] - fx, cell[1] - fy, cell[2] - fz
    x2, y2, z2 = fx * fx, fy * fy, fz * fz
    X2, Y2, Z2 = gx * gx, gy * gy, gz * gz
    # corner order of pack_corner_volume: dx-major, then dy, dz
    return g, [torch.sqrt(ax + ay + az) for ax, ay, az in
               [(x2, y2, z2), (x2, y2, Z2), (x2, Y2, z2), (x2, Y2, Z2),
                (X2, y2, z2), (X2, y2, Z2), (X2, Y2, z2), (X2, Y2, Z2)]]


def grid_corner_distance_bound(packed, pts01, cell):
    """Certified lower bound of a 1-Lipschitz distance field from its
    corner-packed grid (JAX core/grid.py:126): the max over the cell's 8
    corners of d(corner) * (1 - 2^-7) - |x - corner|. The factor absorbs
    the bf16 rounding of the corners. Points whose pts01 clamps into the
    grid need the caller to subtract the clamp excess.

    packed (res-1,)^3 x 8; pts01 (..., 3) normalized to the res^3 grid;
    cell (3,) cell edge lengths -> (...,) f32."""
    g, r = _corner_distances(packed, pts01, cell)
    scale = 1.0 - 2.0 ** -7
    lb = g[:, 0] * scale - r[0]
    for k in range(1, 8):
        lb = torch.maximum(lb, g[:, k] * scale - r[k])
    return lb.reshape(pts01.shape[:-1])


def grid_corner_distance_upper(packed, pts01, cell):
    """Certified upper bound of a 1-Lipschitz field from its corner-packed
    grid (JAX core/grid.py:178), the dual of `grid_corner_distance_bound`:
    the min over the cell's 8 corners of d(corner) * (1 + 2^-7) +
    |x - corner|. Points whose pts01 clamps into the grid need the caller
    to add the clamp excess."""
    g, r = _corner_distances(packed, pts01, cell)
    scale = 1.0 + 2.0 ** -7
    ub = g[:, 0] * scale + r[0]
    for k in range(1, 8):
        ub = torch.minimum(ub, g[:, k] * scale + r[k])
    return ub.reshape(pts01.shape[:-1])


def grid_bilerp(img: torch.Tensor, uv01: torch.Tensor) -> torch.Tensor:
    """Sample `img` (H, W, C) at normalized points (..., 2) in [0, 1]
    (JAX core/grid.py:226; the NT texture pyramid, which the reference
    samples with F.grid_sample, align_corners=True, border). uv01[..., 0]
    indexes the W axis, [..., 1] the H axis. The clamp is jnp.clip's,
    with its gradient of 0.5 on a bound (`numerics.clip`); the four
    corners are gathered and blended in JAX's order."""
    H, W, C = img.shape
    u = clip(uv01[..., 0], 0.0, 1.0) * (W - 1)
    v = clip(uv01[..., 1], 0.0, 1.0) * (H - 1)
    u0f, v0f = torch.floor(u), torch.floor(v)
    fu = (u - u0f)[..., None]
    fv = (v - v0f)[..., None]
    u0, v0 = u0f.long(), v0f.long()
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    flat = img.reshape(-1, C)

    def take(vi, ui):
        # index_select: its backward is a scatter-add (index_add_), where
        # advanced indexing's sorts the indices first, 300x slower on the
        # card at a 1024x1024 image
        return torch.index_select(flat, 0, (vi * W + ui).reshape(-1)).reshape(
            *vi.shape, C)

    c0 = take(v0, u0) * (1 - fu) + take(v0, u1) * fu
    c1 = take(v1, u0) * (1 - fu) + take(v1, u1) * fu
    return c0 * (1 - fv) + c1 * fv
