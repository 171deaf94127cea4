"""A copy of a synthetic dataset root as a real camera rig would leave
it: lens distortion on every camera and masks of another size than
their images. It exercises the steps of `_BaseDataset.load_image` that
the synthetic roots skip (data/camera.py's undistort and resizes).

`write_distorted_copy(src, dst)` writes, under `dst`:
  * `annots.npy` with D = DISTORTION for every camera (K[:2] times
    `upsample`);
  * `decoded.npz` with the images as they are (or upsampled) and the
    `mask_cihp` masks at half their size, by `resize_nearest`;
  * at `upsample` 1, the image files copied as they are and, given a
    `png_writer` (cv2.imwrite where OpenCV is installed), the half-size
    masks as PNG files, so that the JAX package reads the same arrays
    through cv2.imread;
  * symbolic links to everything else of the root.

With `upsample` k the images and masks are first repeated k times along
both axes (nearest neighbour), so a 128x128 root becomes a frame of the
real datasets' size; only the port reads that copy. `config_opts(dst)`
gives the config opts that read a copy at ratio 0.5.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from .camera import resize_nearest
from .decode_cache import ARCHIVE, DecodedImages

# k1 k2 p1 p2 k3, of the size of a real camera's
DISTORTION = np.array([-0.08, 0.03, 5e-4, -4e-4, 0.01]).reshape(5, 1)
MASK_DIR = "mask_cihp"


def write_distorted_copy(src: str, dst: str, upsample: int = 1,
                         png_writer=None) -> str:
    """Write the distorted copy of the root `src` into `dst`; returns
    `dst` as an absolute path."""
    src, dst = os.path.abspath(src), os.path.abspath(dst)
    os.makedirs(dst, exist_ok=True)
    annots = np.load(os.path.join(src, "annots.npy"), allow_pickle=True).item()
    cams = annots["cams"]
    K = np.array(cams["K"], np.float64)
    K[:, :2] *= upsample
    cams["K"] = K
    cams["D"] = np.repeat(DISTORTION[None], len(K), axis=0)
    np.save(os.path.join(dst, "annots.npy"), annots)

    images = DecodedImages(src)
    arrays = {}
    for key, img in images.items():
        if upsample != 1:
            img = img.repeat(upsample, axis=0).repeat(upsample, axis=1)
        if key.startswith(MASK_DIR + "/"):
            img = resize_nearest(img, img.shape[0] // 2, img.shape[1] // 2)
            if png_writer is not None and upsample == 1:
                path = os.path.join(dst, key)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                if not png_writer(path, img):
                    raise OSError(f"could not write {path}")
        elif upsample == 1:
            path = os.path.join(dst, key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            shutil.copyfile(os.path.join(src, key), path)
        arrays[key] = img
    np.savez(os.path.join(dst, ARCHIVE), **arrays)

    written = {"annots.npy", ARCHIVE, MASK_DIR} | {
        key.split("/")[0] for key in arrays}
    for name in sorted(os.listdir(src)):
        if name not in written:
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    return dst


def config_opts(root: str, ratio: float = 0.5) -> list:
    """Config opts that point both splits at the copy `root`, read at
    `ratio` (0.5, the shipped real-subject configs' ratio, by default)."""
    opts = ["ratio", str(ratio)]
    for split in ("train", "test"):
        opts += [f"{split}_dataset.data_root", root,
                 f"{split}_dataset.ann_file", os.path.join(root, "annots.npy")]
    return opts
