"""Linear blend skinning warps between world / posed-SMPL / canonical
spaces.

JAX counterpart: animatable_nerf_tpu/core/lbs.py (reference
lib/utils/blend_utils.py:6-105). The blended 3x3 rotation block is
inverted in closed form (adjugate over a determinant clamped away from
zero, lbs.py:52), not with torch.linalg.inv: the blend of bone
rotations can drift close to singular, and the clamp is part of the
contract.
"""

from __future__ import annotations

import torch


def world_points_to_pose_points(wpts, Rh, Th):
    """(wpts - Th) @ Rh — world to SMPL coordinates."""
    return (wpts - Th) @ Rh


def pose_points_to_world_points(ppts, Rh, Th):
    """ppts @ Rh^T + Th — SMPL to world coordinates (JAX lbs.py:36)."""
    return ppts @ Rh.transpose(-1, -2) + Th


def world_dirs_to_pose_dirs(wdirs, Rh):
    """wdirs @ Rh (JAX lbs.py:31)."""
    return wdirs @ Rh


def _blend_transforms(bw, A):
    """sum_k bw[..., k] * A[k]: (N, 24) x (24, 4, 4) -> (N, 4, 4)."""
    M = bw @ A.reshape(*A.shape[:-3], A.shape[-3], 16)
    return M.reshape(*M.shape[:-1], 4, 4)


def inverse_3x3(m, det_eps: float = 0.0):
    """Analytic 3x3 inverse via the adjugate. m: (..., 3, 3).

    `det_eps` > 0 clamps |det| away from zero, keeping its sign
    (sign(0) -> +1); exact for every healthy blend (|det| ~ 1)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    if det_eps:
        sign = torch.where(det >= 0, 1.0, -1.0)
        det = sign * torch.clamp(torch.abs(det), min=det_eps)
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        dim=-1,
    ).reshape(*m.shape[:-2], 3, 3)
    return adj * inv_det[..., None, None]


def _matvec3(R, v):
    """Per-point 3x3 matrix-vector product as a broadcast multiply-sum."""
    return torch.sum(R * v[..., None, :], dim=-1)


def pose_points_to_tpose_points(ppts, bw, A):
    """Backward LBS warp, posed SMPL space -> canonical space
    (reference blend_utils.py:41-59; bw is (..., N, 24) here)."""
    M = _blend_transforms(bw, A)
    pts = ppts - M[..., :3, 3]
    R_inv = inverse_3x3(M[..., :3, :3], det_eps=1e-6)
    return _matvec3(R_inv, pts)


def pose_dirs_to_tpose_dirs(ddirs, bw, A):
    """Backward LBS warp of directions (JAX lbs.py:108)."""
    M = _blend_transforms(bw, A)
    return _matvec3(inverse_3x3(M[..., :3, :3], det_eps=1e-6), ddirs)


def tpose_points_to_pose_points(pts, bw, A):
    """Forward LBS warp, canonical -> posed (JAX lbs.py:115)."""
    M = _blend_transforms(bw, A)
    return _matvec3(M[..., :3, :3], pts) + M[..., :3, 3]


def tpose_dirs_to_pose_dirs(ddirs, bw, A):
    """Forward LBS warp of directions (JAX lbs.py:121)."""
    M = _blend_transforms(bw, A)
    return _matvec3(M[..., :3, :3], ddirs)


def backward_warp_points_dirs(ppts, pdirs, bw, A, big_A):
    """Posed -> T-pose -> big-pose warp of points and (optional) dirs
    with the blended transforms and the 3x3 inverse formed once (JAX
    lbs.py:127; the same operations as pose_points_to_tpose_points then
    tpose_points_to_pose_points with big_A). Returns (init_bigpose,
    bigpose_dirs or None)."""
    M1 = _blend_transforms(bw, A)
    R1_inv = inverse_3x3(M1[..., :3, :3], det_eps=1e-6)
    M2 = _blend_transforms(bw, big_A)
    R2 = M2[..., :3, :3]
    tpose = _matvec3(R1_inv, ppts - M1[..., :3, 3])
    init_bigpose = _matvec3(R2, tpose) + M2[..., :3, 3]
    dirs = None
    if pdirs is not None:
        dirs = _matvec3(R2, _matvec3(R1_inv, pdirs))
    return init_bigpose, dirs
