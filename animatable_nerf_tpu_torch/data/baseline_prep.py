"""The two files the baselines read that a dataset root may lack, and a
copy of a root that has them.

JAX counterpart: the baseline files `generate_synthetic_dataset` writes
(animatable_nerf_tpu/data/synthetic.py): `_bw_volume` :380-397 for
`lbs/bigpose_bw.npy`, which NHRDataset reads, and the uv splat :543-571
for `uv/<frame>_<view>.npy`, which NTDataset reads. The tracked roots
were written without them, so

    python -m animatable_nerf_tpu_torch.data.baseline_prep \\
        data/synthetic/capsule data/synthetic/capsule_baseline [upsample]

writes a copy (`write_baseline_copy`) that both packages read:
  * `lbs/` with links to the root's files and `bigpose_bw.npy`: the
    nearest big-pose vertex's 24 blend weights and its distance on a
    grid of 0.025 over the vertices' bounds padded by 0.05;
  * `uv/`: per frame and view, each vertex's canonical (x, y) scaled to
    [0, 1] over the T-pose vertices, splatted from the frame's world
    vertices through the view's camera (T / 1000) at splat radius 3 by
    ops/rasterize.py, at the root's image size;
  * relative links to everything else.
With `upsample` k the copy's images and masks are repeated k times
along both axes into its `decoded.npz` and K[:2] is scaled by k, as
data/distorted_copy.py does without the distortion; the uv maps stay
at the root's size, so the NT dataset resizes them (INTER_LINEAR). Only
the port reads that copy. `config_opts` gives the opts that read a copy.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops.rasterize import rasterize_points
from .decode_cache import ARCHIVE, DecodedImages
from .utils import get_bounds

UV_SPLAT_RADIUS = 3


def _link(target: str, link: str):
    """A symbolic link at `link` to `target`, relative to the link's
    directory."""
    os.symlink(os.path.relpath(target, os.path.dirname(link)), link)


def bw_volume(verts, weights, box_padding: float = 0.05, voxel: float = 0.025):
    """(D, H, W, 25) float32 volume over `verts`' bounds padded by
    `box_padding`: at each node the nearest vertex's weights and the
    distance to it (scipy's cKDTree); and its bounds (2, 3)."""
    from scipy.spatial import cKDTree

    bounds = get_bounds(verts, box_padding)
    shape = np.maximum(
        np.ceil((bounds[1] - bounds[0]) / voxel).astype(int) + 1, 2)
    axes = [np.linspace(bounds[0][i], bounds[1][i], shape[i]) for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    dist, idx = cKDTree(verts).query(grid)
    vol = np.concatenate([weights[idx], dist[:, None]], axis=-1)
    return vol.reshape(*shape, 25).astype(np.float32), bounds


def _frames(annots):
    """(row, frame file index, image paths) of each frame of `annots`."""
    for row, entry in enumerate(annots["ims"]):
        ims = list(entry["ims"])
        yield row, int(os.path.basename(ims[0])[:-4]), ims


def write_uv_maps(root: str, dst: str):
    """uv/<frame>_<view>.npy under `dst` for every frame and view of the
    root `root`: the canonical uv of each vertex splatted by
    `rasterize_points` (on the CPU) at the view's image size."""
    annots = np.load(os.path.join(root, "annots.npy"), allow_pickle=True).item()
    cams = annots["cams"]
    images = DecodedImages(root)
    tverts = np.load(os.path.join(root, "lbs", "tvertices.npy"))
    mn, mx = tverts.min(0), tverts.max(0)
    vert_uv = torch.as_tensor(((tverts[:, :2] - mn[:2]) / (mx[:2] - mn[:2] + 1e-8)
                               ).astype(np.float32))
    os.makedirs(os.path.join(dst, "uv"), exist_ok=True)

    def f32(a):
        return torch.as_tensor(np.asarray(a).astype(np.float32))

    for _, fi, ims in _frames(annots):
        wverts = torch.as_tensor(np.load(
            os.path.join(root, "vertices", f"{fi}.npy")).astype(np.float32))
        for v, im in enumerate(ims):
            H, W = images.imread(os.path.join(root, im)).shape[:2]
            ras = rasterize_points(
                wverts, vert_uv, f32(cams["K"][v]), f32(cams["R"][v]),
                f32(np.asarray(cams["T"][v]) / 1000.0), H, W,
                splat_radius=UV_SPLAT_RADIUS)
            np.save(os.path.join(dst, "uv", f"{fi}_{v}.npy"),
                    ras["feature_map"].numpy().astype(np.float32))


def write_baseline_copy(src: str, dst: str, upsample: int = 1) -> str:
    """Write the baseline copy of the root `src` into `dst` (see the
    module's docstring); returns `dst` as an absolute path. `dst` must
    be new or empty: a file written over an earlier copy's link would
    land in the root."""
    src, dst = os.path.abspath(src), os.path.abspath(dst)
    if os.path.isdir(dst) and os.listdir(dst):
        raise FileExistsError(f"{dst} is not empty: remove it to write the "
                              "baseline copy again")
    os.makedirs(os.path.join(dst, "lbs"), exist_ok=True)
    for name in os.listdir(os.path.join(src, "lbs")):
        _link(os.path.join(src, "lbs", name), os.path.join(dst, "lbs", name))
    lbs = os.path.join(src, "lbs")
    vol, _ = bw_volume(np.load(os.path.join(lbs, "bigpose_vertices.npy")),
                       np.load(os.path.join(lbs, "weights.npy")))
    np.save(os.path.join(dst, "lbs", "bigpose_bw.npy"), vol)
    write_uv_maps(src, dst)

    written = {"lbs", "uv"}
    if upsample != 1:
        annots = np.load(os.path.join(src, "annots.npy"), allow_pickle=True).item()
        K = np.array(annots["cams"]["K"], np.float64)
        K[:, :2] *= upsample
        annots["cams"]["K"] = K
        np.save(os.path.join(dst, "annots.npy"), annots)
        arrays = {key: img.repeat(upsample, axis=0).repeat(upsample, axis=1)
                  for key, img in DecodedImages(src).items()}
        np.savez(os.path.join(dst, ARCHIVE), **arrays)
        written |= {"annots.npy", ARCHIVE} | {k.split("/")[0] for k in arrays}
    for name in sorted(os.listdir(src)):
        if name not in written:
            _link(os.path.join(src, name), os.path.join(dst, name))
    return dst


def config_opts(root: str, image_size: int | None = None) -> list:
    """Config opts that point both splits at the copy `root` and, given
    `image_size`, set H and W (the NHR splat's size) to it."""
    opts = []
    if image_size is not None:
        opts += ["H", str(image_size), "W", str(image_size)]
    for split in ("train", "test"):
        opts += [f"{split}_dataset.data_root", root,
                 f"{split}_dataset.ann_file", os.path.join(root, "annots.npy")]
    return opts


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        raise SystemExit("usage: python -m animatable_nerf_tpu_torch.data."
                         "baseline_prep <src root> <dst> [upsample]")
    print(write_baseline_copy(argv[0], argv[1],
                              int(argv[2]) if len(argv) == 3 else 1))


if __name__ == "__main__":
    main()
