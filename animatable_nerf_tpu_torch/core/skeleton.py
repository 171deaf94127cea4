"""SMPL skeleton math: Rodrigues rotations and kinematic-chain rigid
transforms.

JAX counterpart: animatable_nerf_tpu/core/skeleton.py (reference
lib/utils/if_nerf/if_nerf_data_utils.py:392-458). These run on the host
data path, on CPU tensors in float32 like the JAX host program.
`rodrigues_np` replaces `cv2.Rodrigues` (JAX data/dataset.py:232).
"""

from __future__ import annotations

import numpy as np
import torch

N_JOINTS = 24


def batch_rodrigues(poses: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3), with the
    reference's `poses + 1e-8` inside the norm."""
    angle = torch.linalg.norm(poses + 1e-8, dim=-1, keepdim=True)
    rot_dir = poses / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(*poses.shape[:-1], 3, 3)
    ident = torch.eye(3, dtype=poses.dtype, device=poses.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def rigid_transforms(poses, joints, parents, return_joints: bool = False):
    """Per-bone transforms G = A(pose, J_rel) @ A(rest, J)^{-1}.

    poses (24, 3) axis-angle, joints (24, 3) rest-pose joints, parents
    (24,) kinematic tree. Returns (24, 4, 4) canonical -> posed SMPL
    transforms (and the posed joints (24, 3) with `return_joints`).
    """
    poses = torch.as_tensor(np.asarray(poses, np.float32))
    joints = torch.as_tensor(np.asarray(joints, np.float32))
    parents = np.asarray(parents)
    n_joints = parents.shape[0]

    rot_mats = batch_rodrigues(poses)
    rel_joints = joints.clone()
    rel_joints[1:] = joints[1:] - joints[parents[1:]]
    tm = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(n_joints, 1, 4)
    tm = torch.cat([tm, bottom], dim=-2)

    chain = [tm[0]]
    for i in range(1, n_joints):
        chain.append(chain[parents[i]] @ tm[i])
    transforms = torch.stack(chain, dim=0)
    posed_joints = transforms[:, :3, 3].clone()

    joints_h = torch.cat([joints, torch.zeros_like(joints[:, :1])], dim=-1)
    rest = (transforms @ joints_h[..., None])[..., 0]
    transforms[..., 3] = transforms[..., 3] - rest
    if return_joints:
        return transforms, posed_joints
    return transforms


def rigid_transforms_host(poses, joints, parents, return_joints=False):
    """numpy in, numpy out (the data pipeline's form)."""
    out = rigid_transforms(poses, joints, parents, return_joints)
    if return_joints:
        return out[0].numpy(), out[1].numpy()
    return out.numpy()


def big_pose_A(joints, parents, angle_deg: float = 30.0) -> np.ndarray:
    """Rigid transforms of the canonical "big pose" (legs spread):
    axis-angle components 5 and 8 set to +/- 30 degrees
    (reference tpose_dataset.py:80-90)."""
    big = np.zeros([N_JOINTS * 3], dtype=np.float32)
    big[5] = np.deg2rad(angle_deg)
    big[8] = np.deg2rad(-angle_deg)
    return rigid_transforms_host(big.reshape(-1, 3), joints, parents)


def rodrigues_np(rvec) -> np.ndarray:
    """Axis-angle (3,) -> (3, 3) rotation, computed as cv2.Rodrigues does
    (float64 internally, returned in the input's float type)."""
    rvec = np.asarray(rvec)
    r = rvec.astype(np.float64).reshape(3)
    theta = float(np.sqrt(r @ r))
    if theta < np.finfo(np.float64).eps:
        R = np.eye(3)
    else:
        c, s = np.cos(theta), np.sin(theta)
        c1 = 1.0 - c
        r = r * (1.0 / theta)
        rrt = np.outer(r, r)
        r_x = np.array(
            [[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]]
        )
        R = c * np.eye(3) + c1 * rrt + s * r_x
    out_type = rvec.dtype if rvec.dtype in (np.float32, np.float64) else np.float64
    return R.astype(out_type)
