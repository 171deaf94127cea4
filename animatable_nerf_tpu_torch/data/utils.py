"""Host-side data utilities: mask processing, ray sampling, volume
padding.

JAX counterpart: animatable_nerf_tpu/data/utils.py:23-160 (reference
if_nerf_data_utils.py:199-307, :566-605). The mask erosion/dilation
uses scipy.ndimage in place of cv2. The training draw takes the same
numbers from the same np.random.RandomState in the same order as JAX's,
so one seed gives bit-equal rays in both packages.
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


def prepare_rays_image(img, msk, K, R, T, bounds, split: str,
                       mask_bkgd: bool = True) -> dict:
    """The rays of one image without the train split's random draw (JAX
    utils.py:46-118 up to its draw loop; the loader runs this on its
    worker threads): the image's rays and projected box, the background
    masked (`img` is changed in place, as in JAX). On the test split the
    finished rays, `rays`: (rgb, ray_o, ray_d, near, far, coord,
    mask_at_box) of every pixel in the projected box whose ray hits the
    3-D bounds; on the train split the pixels `draw_rays_image` picks
    from."""
    H, W = img.shape[:2]
    ray_o, ray_d = get_rays_np(H, W, K, R, T)
    pose = np.concatenate([R, T.reshape(3, 1)], axis=1)
    bound_mask = get_bound_2d_mask(bounds, K, pose, H, W)
    if mask_bkgd:
        img[bound_mask != 1] = 0
    msk = msk * bound_mask
    bound_mask[msk == 100] = 0

    if split == "train":
        return {"img": img, "ray_o": ray_o, "ray_d": ray_d,
                "bounds": bounds, "body": np.argwhere(msk == 1),
                "bound": np.argwhere(bound_mask == 1),
                "face": np.argwhere(msk == 13)}

    rgb = img.reshape(-1, 3).astype(np.float32)
    ro = ray_o.reshape(-1, 3)
    rd = ray_d.reshape(-1, 3)
    near, far, mab = get_near_far_np(bounds, ro, rd)
    coord = np.argwhere(mab.reshape(H, W))
    return {"rays": (
        rgb[mab],
        ro[mab].astype(np.float32),
        rd[mab].astype(np.float32),
        near.astype(np.float32),
        far.astype(np.float32),
        coord,
        mab,
    )}


def draw_rays_image(prepared: dict, nrays: int = 0,
                    body_sample_ratio: float = 0.5,
                    face_sample_ratio: float = 0.0,
                    rng: np.random.RandomState | None = None):
    """The rays of `prepare_rays_image`'s image, (rgb, ray_o, ray_d,
    near, far, coord, mask_at_box): the test split's as they are; on the
    train split `nrays` drawn from `rng` by the body/bbox loop (JAX
    utils.py:71-105): each round draws body_sample_ratio of the rays
    still wanted from the body mask, face_sample_ratio from the face
    label (13), the rest from the projected box, and keeps those that
    hit the bounds, until `nrays` are kept. The last round can overshoot;
    as in JAX and the reference, nothing is trimmed. The loader calls
    this in item order."""
    if "rays" in prepared:
        return prepared["rays"]
    p = prepared
    return _sample_train_rays(p["img"], p["body"], p["bound"], p["face"],
                              p["ray_o"], p["ray_d"], p["bounds"], nrays,
                              body_sample_ratio, face_sample_ratio,
                              rng or np.random)


def _sample_train_rays(img, coord_body_all, coord_bound_all, coord_face_all,
                       ray_o, ray_d, bounds, nrays, body_sample_ratio,
                       face_sample_ratio, rng):
    """The training draw of `draw_rays_image` (the same draws from `rng`,
    in the same order, as JAX utils.py:71-105) over the pixels of the
    body, of the projected box and of the face label."""
    n_sampled = 0
    outs = ([], [], [], [], [], [], [])
    while n_sampled < nrays:
        n_body = int((nrays - n_sampled) * body_sample_ratio)
        n_face = int((nrays - n_sampled) * face_sample_ratio)
        n_rand = (nrays - n_sampled) - n_body - n_face
        coords = [coord_body_all[rng.randint(0, len(coord_body_all), n_body)]]
        if len(coord_face_all) > 0 and n_face > 0:
            coords.append(
                coord_face_all[rng.randint(0, len(coord_face_all), n_face)])
        coords.append(
            coord_bound_all[rng.randint(0, len(coord_bound_all), n_rand)])
        coord = np.concatenate(coords, axis=0)
        ro = ray_o[coord[:, 0], coord[:, 1]]
        rd = ray_d[coord[:, 0], coord[:, 1]]
        rgb = img[coord[:, 0], coord[:, 1]]
        near, far, mab = get_near_far_np(bounds, ro, rd)
        for out, v in zip(outs, (rgb[mab], ro[mab], rd[mab], near, far,
                                 coord[mab], mab[mab])):
            out.append(v)
        n_sampled += len(near)
    rgb, ro, rd, near, far, coord, mab = [np.concatenate(o) for o in outs]
    return (rgb.astype(np.float32), ro.astype(np.float32),
            rd.astype(np.float32), near.astype(np.float32),
            far.astype(np.float32), coord, mab)


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
