"""Host-side data utilities: mask processing, eval ray sampling, volume
padding.

JAX counterpart: animatable_nerf_tpu/data/utils.py:23-160 (reference
if_nerf_data_utils.py:199-307, :566-605). The mask erosion/dilation
uses scipy.ndimage in place of cv2.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ..core.rays import get_rays_np, get_near_far_np, get_bound_2d_mask


def erode_mask_edge(msk: np.ndarray, border: int = 5) -> np.ndarray:
    """Mark the mask boundary band with 100 (reference
    tpose_dataset.py:116-121). Flat `border`x`border` min/max filters
    with cv2.erode/cv2.dilate's rules: the window of pixel i spans
    i - border//2 .. i + border - border//2 - 1, and the image edge
    neither erodes nor dilates (constant border at the extreme value)."""
    msk = msk.copy()
    er = ndimage.minimum_filter(msk, size=border, mode="constant",
                                cval=np.iinfo(msk.dtype).max)
    di = ndimage.maximum_filter(msk, size=border, mode="constant", cval=0)
    msk[(di - er) == 1] = 100
    return msk


def crop_mask_edge(msk: np.ndarray, border: int = 10) -> np.ndarray:
    """Reference if_nerf_data_utils.py:598-605."""
    return erode_mask_edge(msk, border)


def get_bounds(xyz: np.ndarray, box_padding: float = 0.05) -> np.ndarray:
    """AABB of a vertex set, padded (if_nerf_data_utils.py:566-579)."""
    mn = xyz.min(0) - box_padding
    mx = xyz.max(0) + box_padding
    return np.stack([mn, mx]).astype(np.float32)


def sample_rays_image(img, msk, K, R, T, bounds, split: str,
                      mask_bkgd: bool = True):
    """Eval rays of one image: every pixel in the projected box whose
    ray hits the 3-D bounds. Returns (rgb, ray_o, ray_d, near, far,
    coord, mask_at_box). Training's random ray draw comes with the
    training slice."""
    if split == "train":
        raise NotImplementedError(
            "training ray sampling is not ported yet (eval split only)"
        )
    H, W = img.shape[:2]
    ray_o, ray_d = get_rays_np(H, W, K, R, T)
    pose = np.concatenate([R, T.reshape(3, 1)], axis=1)
    bound_mask = get_bound_2d_mask(bounds, K, pose, H, W)
    if mask_bkgd:
        img[bound_mask != 1] = 0
    msk = msk * bound_mask
    bound_mask[msk == 100] = 0

    rgb = img.reshape(-1, 3).astype(np.float32)
    ro = ray_o.reshape(-1, 3)
    rd = ray_d.reshape(-1, 3)
    near, far, mab = get_near_far_np(bounds, ro, rd)
    coord = np.argwhere(mab.reshape(H, W))
    return (
        rgb[mab],
        ro[mab].astype(np.float32),
        rd[mab].astype(np.float32),
        near.astype(np.float32),
        far.astype(np.float32),
        coord,
        mab,
    )


def pad_volume_to(vol: np.ndarray, bounds: np.ndarray, target_shape):
    """Edge-pad a (D, H, W, C) volume to `target_shape` and extend
    `bounds` by whole voxels so trilinear sampling is unchanged: every
    original grid point keeps its position and border-clamped samples
    read the replicated edge."""
    D, H, W, C = vol.shape
    tD, tH, tW = target_shape
    if tD < D or tH < H or tW < W:
        raise ValueError(f"cannot pad {vol.shape[:3]} down to {target_shape}")
    mn, mx = bounds[0].copy(), bounds[1].copy()
    voxel = (mx - mn) / (np.array([D, H, W]) - 1.0)
    pads = (tD - D, tH - H, tW - W)
    if any(pads):
        out = np.empty((tD, tH, tW, C), dtype=vol.dtype)
        out[:D, :H, :W] = vol
        if tW > W:
            out[:D, :H, W:] = out[:D, :H, W - 1 : W]
        if tH > H:
            out[:D, H:, :] = out[:D, H - 1 : H, :]
        if tD > D:
            out[D:] = out[D - 1 : D]
        vol = out
    mx = mx + voxel * np.array(pads)
    return vol, np.stack([mn, mx]).astype(np.float32)
