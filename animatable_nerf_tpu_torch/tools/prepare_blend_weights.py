"""Build the blend-weight voxel grids the grid-based (aninerf) datasets
require.

JAX counterpart: tools/prepare_blend_weights.py (`grid_points` :46,
`grid_blend_weights` :57, `prepare_human` :73), whose files this writes.
Mirrors tools/custom_dataset/prepare_blend_weights.py of the reference:
for each frame, construct a voxel grid over the posed SMPL vertices
(voxel 0.025, bounds padded ±0.05 — :156-169), assign each grid point
the skinning weights of its closest point on the SMPL surface
(barycentric over the closest face — :268-274) plus the distance to the
surface as channel 25, and write:

  lbs/bweights/<i>.npy   — (D, H, W, 25) posed-space grids per frame
  lbs/tbw.npy            — T-pose grid
  lbs/bigpose_bw.npy     — big-pose grid

The closest-point query (smpl/point_mesh.py, plain PyTorch) runs on the
card unless `--device cpu` is given, and raises without one.

Usage:
  python -m animatable_nerf_tpu_torch.tools.prepare_blend_weights \
      --data_dir data/zju_mocap --humans CoreView_313 \
      --smpl_path data/smplx/smpl/SMPL_NEUTRAL.pkl [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.skeleton import rigid_transforms_host as rigid_transforms
from ..smpl import (
    SMPLModel,
    barycentric_interpolation,
    big_pose_vector,
    closest_point_on_mesh,
    load_smpl,
)

VOXEL = 0.025
PAD = 0.05


def grid_points(xyz):
    """Voxel-grid points over padded bounds
    (prepare_blend_weights.py:156-169)."""
    mn = xyz.min(0) - PAD
    mx = xyz.max(0) + PAD
    x = np.arange(mn[0], mx[0] + VOXEL, VOXEL)
    y = np.arange(mn[1], mx[1] + VOXEL, VOXEL)
    z = np.arange(mn[2], mx[2] + VOXEL, VOXEL)
    return np.stack(np.meshgrid(x, y, z, indexing="ij"), axis=-1)


def grid_blend_weights(verts, faces, weights, device=None):
    """(D, H, W, 25) grid: barycentric skinning weights + distance
    channel, sampled at the grid points over `verts`; the closest-point
    query on `device` (the card by default)."""
    pts = grid_points(verts)
    sh = pts.shape
    flat = pts.reshape(-1, 3).astype(np.float32)
    res = closest_point_on_mesh(flat, verts, faces, device=device)
    fidx = np.asarray(res["face"])
    bary = np.asarray(res["bary"])
    dist = np.asarray(res["dist"])
    corner_w = weights[faces[fidx]]  # (N, 3, 24)
    bw = barycentric_interpolation(corner_w, bary)
    out = np.concatenate([bw, dist[:, None]], axis=1)
    return out.reshape(*sh[:3], 25).astype(np.float32)


def prepare_human(data_dir, human, smpl_path, begin_frame=0,
                  frame_interval=1, end_frame=-1,
                  params_dir="params", vertices_dir="vertices",
                  lbs_dir="lbs", device=None):
    root = os.path.join(data_dir, human)
    lbs_root = os.path.join(root, lbs_dir)
    bweight_dir = os.path.join(lbs_root, "bweights")
    os.makedirs(bweight_dir, exist_ok=True)
    model = SMPLModel(load_smpl(smpl_path))
    faces = model.faces.astype(np.int64)
    weights = model.weights.astype(np.float32)

    pdir = os.path.join(root, params_dir)
    vdir = os.path.join(root, vertices_dir)
    ids = sorted(
        int(os.path.splitext(n)[0])
        for n in os.listdir(pdir)
        if os.path.splitext(n)[0].isdigit()
    )
    if end_frame > 0:
        ids = [i for i in ids if i < end_frame]
    ids = [i for i in ids if i >= begin_frame][::frame_interval]

    # per-frame posed grids
    for i in ids:
        params = np.load(
            os.path.join(pdir, f"{i}.npy"), allow_pickle=True
        ).item()
        vertices = np.load(os.path.join(vdir, f"{i}.npy"))
        _, R, Th, _, _, _ = model.transform_params(params)
        pxyz = np.dot(vertices - Th, R).astype(np.float32)
        bw = grid_blend_weights(pxyz, faces, weights, device)
        np.save(os.path.join(bweight_dir, f"{i}.npy"), bw)

    # T-pose grid (prepare_blend_weights.py:229-283)
    first = ids[0]
    params = np.load(
        os.path.join(pdir, f"{first}.npy"), allow_pickle=True
    ).item()
    vertices = np.load(os.path.join(vdir, f"{first}.npy"))
    A, R, Th, joints, parents, _ = model.transform_params(params)
    pxyz = np.dot(vertices - Th, R)
    tverts = model.inverse_lbs(pxyz, A)
    np.save(
        os.path.join(lbs_root, "tbw.npy"),
        grid_blend_weights(tverts, faces, weights, device),
    )

    # big-pose grid (prepare_blend_weights.py:296+)
    big_A = np.asarray(
        rigid_transforms(
            big_pose_vector().astype(np.float32),
            joints.astype(np.float32), parents,
        )
    )
    blended = np.einsum("vb,bij->vij", model.weights, big_A)
    bigpose = (
        np.einsum("vij,vj->vi", blended[:, :3, :3], tverts)
        + blended[:, :3, 3]
    ).astype(np.float32)
    np.save(
        os.path.join(lbs_root, "bigpose_bw.npy"),
        grid_blend_weights(bigpose, faces, weights, device),
    )
    return lbs_root


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--humans", nargs="+", required=True)
    ap.add_argument("--smpl_path", required=True)
    ap.add_argument("--begin_frame", type=int, default=0)
    ap.add_argument("--end_frame", type=int, default=-1)
    ap.add_argument("--frame_interval", type=int, default=1)
    ap.add_argument("--params", default="params")
    ap.add_argument("--vertices", default="vertices")
    ap.add_argument("--lbs", default="lbs")
    ap.add_argument("--device", default=None,
                    help="cpu to run the closest-point query on the CPU")
    args = ap.parse_args(argv)
    for human in args.humans:
        out = prepare_human(
            args.data_dir, human, args.smpl_path, args.begin_frame,
            args.frame_interval, args.end_frame,
            args.params, args.vertices, args.lbs, args.device,
        )
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
