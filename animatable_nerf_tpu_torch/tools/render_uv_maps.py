"""Pre-render per-view SMPL UV maps for the Neural Texture baseline.

JAX counterpart: tools/render_uv_maps.py (`load_obj_uv` :31, `planar_uv`
:64, `render_human` :72), on the port's host rasterizer (native.py
`rasterize_mesh`, the same csrc/mesh_native.cpp). This is a mesh
rasterization; data/baseline_prep.py `write_uv_maps` reproduces the
synthetic generator's point splat instead. Mirrors tools/render_h36m_uvmaps_pytorch3d.py: for every (frame, camera)
pair, rasterize the posed SMPL mesh and write the per-pixel UV
coordinates to `uv/<frame>_<cam>.npy` (H, W, 2), which the NT dataset
consumes (lib/datasets/h36m/nt.py; data/baselines.py NTDataset).

The rasterizer is the in-tree native z-buffer (csrc/mesh_native.cpp
`rasterize_mesh`, built with g++ at first use), no pytorch3d. Per-vertex UVs come from an OBJ with
vt entries (--uv_obj, e.g. the SMPL smpl_uv.obj) or, fallback, a planar
unwrap of the canonical vertices.

Usage:
  python -m animatable_nerf_tpu_torch.tools.render_uv_maps --data_dir data/h36m --humans S9 \
      [--uv_obj data/smpl_uv.obj]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..native import rasterize_mesh


def load_obj_uv(path: str):
    """Parse vt coords + per-face vt indices from an OBJ; returns
    per-vertex uv by averaging the vts assigned to each vertex."""
    vts = []
    v_uv_sum = {}
    v_uv_cnt = {}
    faces = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "vt":
                vts.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "f":
                tri_v, tri_vt = [], []
                for token in parts[1:4]:
                    comp = token.split("/")
                    tri_v.append(int(comp[0]) - 1)
                    if len(comp) > 1 and comp[1]:
                        tri_vt.append(int(comp[1]) - 1)
                faces.append(tri_v)
                for vi, ti in zip(tri_v, tri_vt):
                    v_uv_sum.setdefault(vi, np.zeros(2))
                    v_uv_sum[vi] += np.asarray(vts[ti])
                    v_uv_cnt[vi] = v_uv_cnt.get(vi, 0) + 1
    n = max(v_uv_sum) + 1 if v_uv_sum else 0
    uv = np.zeros((n, 2), np.float32)
    for vi, s in v_uv_sum.items():
        uv[vi] = s / v_uv_cnt[vi]
    return uv, np.asarray(faces, np.int64)


def planar_uv(tverts: np.ndarray) -> np.ndarray:
    """Fallback unwrap: normalized canonical (x, y)."""
    mn, mx = tverts.min(0), tverts.max(0)
    return ((tverts[:, :2] - mn[:2]) / (mx[:2] - mn[:2] + 1e-8)).astype(
        np.float32
    )


def render_human(data_dir, human, uv_obj=None, ratio: float = 1.0,
                 vertices_dir="vertices"):
    root = os.path.join(data_dir, human)
    annots = np.load(
        os.path.join(root, "annots.npy"), allow_pickle=True
    ).item()
    cams = annots["cams"]
    faces = np.load(os.path.join(root, "lbs", "faces.npy")).astype(np.int64)
    tverts = np.load(os.path.join(root, "lbs", "tvertices.npy"))
    if uv_obj:
        vert_uv, obj_faces = load_obj_uv(uv_obj)
        if len(obj_faces):
            faces = obj_faces
    else:
        vert_uv = planar_uv(tverts)

    out_dir = os.path.join(root, "uv")
    os.makedirs(out_dir, exist_ok=True)
    vdir = os.path.join(root, vertices_dir)
    frame_ids = sorted(
        int(os.path.splitext(nm)[0])
        for nm in os.listdir(vdir)
        if os.path.splitext(nm)[0].isdigit()
    )
    n_cams = len(cams["K"])
    for i in frame_ids:
        wverts = np.load(os.path.join(vdir, f"{i}.npy")).astype(np.float32)
        for c in range(n_cams):
            K = np.asarray(cams["K"][c], np.float32).copy()
            K[:2] *= ratio
            R = np.asarray(cams["R"][c], np.float32)
            T = np.asarray(cams["T"][c], np.float32).reshape(3) / 1000.0
            # target size from intrinsics (principal point at center)
            H = int(round(K[1, 2] * 2))
            W = int(round(K[0, 2] * 2))
            out = rasterize_mesh(wverts, faces, vert_uv, K, R, T, H, W)
            np.save(os.path.join(out_dir, f"{i}_{c}.npy"), out["attr"])
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--humans", nargs="+", required=True)
    ap.add_argument("--uv_obj", default=None)
    ap.add_argument("--ratio", type=float, default=1.0)
    ap.add_argument("--vertices", default="vertices")
    args = ap.parse_args(argv)
    for human in args.humans:
        out = render_human(
            args.data_dir, human, args.uv_obj, args.ratio, args.vertices
        )
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
