"""Ray generation, ray/AABB intersection and the projected-box mask.

JAX counterpart: animatable_nerf_tpu/core/rays.py (reference
lib/utils/if_nerf/if_nerf_data_utils.py:64-135, :156-196). These are
host-side numpy functions of the data pipeline. `get_bound_2d_mask`
rasterizes the box faces with `fill_poly`, a numpy polygon fill that
follows cv2.fillPoly's rule (integer vertices, 8-connected outline
included, even-odd scanline interior in 16.16 fixed point), so the
port needs no OpenCV.
"""

from __future__ import annotations

import numpy as np


def get_rays_np(H: int, W: int, K: np.ndarray, R: np.ndarray, T: np.ndarray):
    """Per-pixel world-space rays for a pinhole camera (w2c extrinsics).
    Returns (rays_o, rays_d), both (H, W, 3); directions are normalized."""
    rays_o = -np.dot(R.T, T).ravel()
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = np.dot(xy1, np.linalg.inv(K).T)
    pixel_world = np.dot(pixel_camera - T.ravel(), R)
    rays_d = pixel_world - rays_o[None, None]
    rays_d = rays_d / np.linalg.norm(rays_d, axis=2, keepdims=True)
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_near_far_np(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """Returns (near (n',), far (n',), mask (n,)): a ray is kept iff
    exactly 2 of its 6 slab-plane intersections lie on the box inflated
    by 0.01 (reference if_nerf_data_utils.py:156-196). Distances are
    |t|, so boxes behind the camera keep positive near/far (reference
    quirk)."""
    bounds = bounds.astype(np.float64)
    ray_o = ray_o.astype(np.float64)
    ray_d = ray_d.astype(np.float64)
    bounds = bounds + np.asarray([-0.01, 0.01])[:, None]
    nom = bounds[None] - ray_o[:, None]
    # axis-parallel rays divide by zero; their inf/nan plane hits fail
    # the box-membership test below, exactly as in the reference
    with np.errstate(divide="ignore", invalid="ignore"):
        d_int = (nom / ray_d[:, None]).reshape(-1, 6)
        p_int = d_int[..., None] * ray_d[:, None] + ray_o[:, None]
    eps = 1e-6
    valid = np.all((p_int >= bounds[0] - eps) & (p_int <= bounds[1] + eps), axis=-1)
    d_abs = np.abs(d_int)
    mask_at_box = valid.sum(-1) == 2
    sel = d_abs[mask_at_box]
    vsel = valid[mask_at_box]
    near = np.where(vsel, sel, np.inf).min(-1)
    far = np.where(vsel, sel, -np.inf).max(-1)
    return near.astype(np.float32), far.astype(np.float32), mask_at_box


_BOX_FACES = [
    [0, 1, 3, 2, 0],
    [4, 5, 7, 6, 5],
    [0, 1, 5, 4, 0],
    [2, 3, 7, 6, 2],
    [0, 2, 6, 4, 0],
    [1, 3, 7, 5, 1],
]


def get_bound_corners(bounds: np.ndarray) -> np.ndarray:
    """8 corners of an AABB in the reference's order."""
    mn, mx = bounds[0], bounds[1]
    return np.array(
        [
            [mn[0], mn[1], mn[2]],
            [mn[0], mn[1], mx[2]],
            [mn[0], mx[1], mn[2]],
            [mn[0], mx[1], mx[2]],
            [mx[0], mn[1], mn[2]],
            [mx[0], mn[1], mx[2]],
            [mx[0], mx[1], mn[2]],
            [mx[0], mx[1], mx[2]],
        ]
    )


# ------------------------------------------------------------ polygon fill
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(W: int, H: int, p1, p2):
    """cv2.clipLine onto [0, W-1] x [0, H-1]; None when nothing is left."""
    right, bottom = W - 1, H - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _draw_line(mask, p1, p2, value):
    """cv2.line with 8-connectivity: Bresenham from the left end
    (cv2 LineIterator, leftToRight), after clipping to the image."""
    H, W = mask.shape
    if not (0 <= p1[0] < W and 0 <= p2[0] < W and 0 <= p1[1] < H
            and 0 <= p2[1] < H):
        clipped = _clip_line(W, H, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = value
        minor = err < 0
        err += -(dy + dy) + ((dx + dx) if minor else 0)
        if vert:
            y += step_y
            x += 1 if minor else 0
        else:
            x += 1
            y += step_y if minor else 0


def fill_poly(mask: np.ndarray, pts, value=1):
    """cv2.fillPoly(mask, [pts], value) for one polygon of integer (x, y)
    vertices: the outline is drawn 8-connected and the interior filled
    by the even-odd rule over 16.16 fixed-point edges (cv2 drawing.cpp
    CollectPolyEdges + FillEdgeCollection). Writes `mask` in place."""
    H, W = mask.shape
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []  # (y0, y1, x0 fixed-point, dx fixed-point per row)
    p0 = pts[-1]
    for p1 in pts:
        _draw_line(mask, p0, p1, value)
        if p0[1] != p1[1]:
            lo, hi = (p0, p1) if p0[1] < p1[1] else (p1, p0)
            dx = _tdiv((p1[0] - p0[0]) << _XY_SHIFT, p1[1] - p0[1])
            edges.append((lo[1], hi[1], lo[0] << _XY_SHIFT, dx))
        p0 = p1
    if len(edges) < 2:
        return mask
    y_min = min(e[0] for e in edges)
    y_max = min(max(e[1] for e in edges), H)
    for y in range(max(y_min, 0), y_max):
        xs = sorted(
            x0 + (y - y0) * dx for y0, y1, x0, dx in edges if y0 <= y < y1
        )
        for a, b in zip(xs[0::2], xs[1::2]):
            x1 = (a + _XY_ONE - 1) >> _XY_SHIFT
            x2 = b >> _XY_SHIFT
            if x1 < W and x2 >= 0:
                mask[y, max(x1, 0):min(x2, W - 1) + 1] = value
    return mask


def get_bound_2d_mask(bounds, K, pose, H, W) -> np.ndarray:
    """Rasterize the projected 3D bbox into a binary (H, W) uint8 mask
    (reference if_nerf_data_utils.py:114-135: fillPoly over the six box
    faces, vertices rounded to integers)."""
    corners_3d = get_bound_corners(bounds)
    xyz = np.dot(corners_3d, pose[:, :3].T) + pose[:, 3:].T
    xy = np.dot(xyz, K.T)
    corners_2d = np.round(xy[:, :2] / xy[:, 2:]).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    for face in _BOX_FACES:
        fill_poly(mask, corners_2d[face], 1)
    return mask
