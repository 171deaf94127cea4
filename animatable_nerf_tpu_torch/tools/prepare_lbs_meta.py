"""Build the lbs/ metadata directory the KNN-based (pdf/sdf) datasets
require.

JAX counterpart: tools/prepare_lbs_meta.py (`prepare_human` :46), whose
files this writes with the same names, dtypes and values; host numpy on
the port's smpl/ package. Mirrors
tools/custom_dataset/prepare_lbs_meta.py of the reference:
reads per-frame EasyMocap params (`params/<i>.npy` dicts with poses/
shapes/Rh/Th) and posed vertices (`vertices/<i>.npy`), plus a raw SMPL
pickle, and writes into `<human>/lbs/`:

  parents.npy, joints.npy       — kinematic tree + rest joints
  weights.npy                   — (6890, 24) normalized skinning weights
  tvertices.npy                 — canonical (T-pose) vertices
  bigpose_vertices.npy, faces.npy — big-pose template + SMPL faces
  smpl_params.npy               — all frames' params concatenated
  training_joints.npy           — per-frame posed world joints (24, 3)
                                  for nearest-training-pose lookup
                                  (tpose_pdf_dataset.py:176-184)

Usage:
  python -m animatable_nerf_tpu_torch.tools.prepare_lbs_meta --data_dir data/zju_mocap \
      --humans CoreView_313 --smpl_path data/smplx/smpl/SMPL_NEUTRAL.pkl
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.skeleton import rigid_transforms_host as rigid_transforms
from ..smpl import SMPLModel, big_pose_vector, load_smpl


def _frame_ids(param_dir, begin):
    ids = []
    for name in os.listdir(param_dir):
        stem = os.path.splitext(name)[0]
        if stem.isdigit():
            ids.append(int(stem))
    return sorted(i for i in ids if i >= begin)


def prepare_human(data_dir, human, smpl_path, begin_frame=0,
                  params_dir="params", vertices_dir="vertices",
                  lbs_dir="lbs"):
    root = os.path.join(data_dir, human)
    lbs_root = os.path.join(root, lbs_dir)
    os.makedirs(lbs_root, exist_ok=True)
    model = SMPLModel(load_smpl(smpl_path))

    pdir = os.path.join(root, params_dir)
    vdir = os.path.join(root, vertices_dir)
    ids = _frame_ids(pdir, begin_frame)
    if not ids:
        raise FileNotFoundError(f"no frame params under {pdir}")

    first = ids[0]
    params = np.load(
        os.path.join(pdir, f"{first}.npy"), allow_pickle=True
    ).item()
    vertices = np.load(os.path.join(vdir, f"{first}.npy"))

    A, R, Th, joints, parents, _ = model.transform_params(params)

    np.save(os.path.join(lbs_root, "parents.npy"), parents)
    np.save(os.path.join(lbs_root, "joints.npy"), joints.astype(np.float32))
    np.save(
        os.path.join(lbs_root, "weights.npy"),
        model.weights.astype(np.float32),
    )
    if model.faces is not None:
        np.save(os.path.join(lbs_root, "faces.npy"), model.faces)

    # world -> SMPL coords, then inverse LBS to T-pose
    # (prepare_lbs_meta.py:155-172)
    pxyz = np.dot(vertices - Th, R)
    tverts = model.inverse_lbs(pxyz, A)
    np.save(os.path.join(lbs_root, "tvertices.npy"), tverts)

    # big-pose template (prepare_lbs_meta.py:209-229)
    big_A = np.asarray(
        rigid_transforms(
            big_pose_vector().astype(np.float32),
            joints.astype(np.float32),
            parents,
        )
    )
    blended = np.einsum("vb,bij->vij", model.weights, big_A)
    bigpose = (
        np.einsum("vij,vj->vi", blended[:, :3, :3], tverts)
        + blended[:, :3, 3]
    )
    np.save(
        os.path.join(lbs_root, "bigpose_vertices.npy"),
        bigpose.astype(np.float32),
    )

    # all-frame params + posed world joints (training_joints)
    all_params: dict = {}
    training_joints = []
    for i in ids:
        p = np.load(os.path.join(pdir, f"{i}.npy"), allow_pickle=True).item()
        for k, val in p.items():
            all_params.setdefault(k, []).append(np.asarray(val))
        poses_i = np.asarray(p["poses"], np.float64).reshape(-1, 3)[:24]
        _, cj = rigid_transforms(
            poses_i.astype(np.float32), joints.astype(np.float32), parents,
            return_joints=True,
        )
        A_i, R_i, Th_i, _, _, _ = model.transform_params(p)
        posed = np.asarray(cj) @ R_i.T + Th_i
        training_joints.append(posed.astype(np.float32))
    np.save(
        os.path.join(lbs_root, "smpl_params.npy"),
        {k: np.concatenate(v, axis=0) for k, v in all_params.items()},
    )
    np.save(
        os.path.join(lbs_root, "training_joints.npy"),
        np.stack(training_joints),
    )
    return lbs_root


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--humans", nargs="+", required=True)
    ap.add_argument("--smpl_path", required=True)
    ap.add_argument("--begin_frame", type=int, default=0)
    ap.add_argument("--params", default="params")
    ap.add_argument("--vertices", default="vertices")
    ap.add_argument("--lbs", default="lbs")
    args = ap.parse_args(argv)
    for human in args.humans:
        out = prepare_human(
            args.data_dir, human, args.smpl_path, args.begin_frame,
            args.params, args.vertices, args.lbs,
        )
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
