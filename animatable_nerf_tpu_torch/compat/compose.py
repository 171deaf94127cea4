"""Weights of the four aligned families composed from the tracked
checkpoints, for the tests and the card.

The aligned families (JAX animatable_nerf_tpu/models/aligned.py) share
NeRF-PDF's canonical head (`nerf_network` and `color_network` without
normals, :96-101) and, on the capsule configs (num_train_frame 4), the
shapes of AniNeRF's blend-weight field (latent (5, 128), mlp lin0 (191,
256), out (256, 24)). So each family's flax param tree is built, array
for array, from two tracked files (read with compat/flax_msgpack.py):

  * LBW: AniNeRF's `bw_field`, NeRF-PDF's `nerf_network` and
    `color_network`;
  * PBW: `bw_field/mlp` from NeRF-PDF's displacement trunk
    (`resd_field/mlp` lin0-lin7, [PE(xyz), pose] = 135 inputs, as
    PoseCondBWField takes) with AniNeRF's `bw_field/mlp/out` (256, 24),
    and NeRF-PDF's head;
  * SMPL: NeRF-PDF's head alone;
  * LBWPDF: LBW's tree plus NeRF-PDF's `resd_field`.

`write_aligned(family)` writes the tree as a fresh start
(train/checkpoints.py `write_start`) into
data/trained_model/deform/synthetic_aligned_<family>/latest.flax, where
configs/synthetic_aligned_<family>.yaml reads it; both packages load
that file.

The novel-pose trees (`compose_novel_pose`) are those of
configs/synthetic_aligned_<family>_novel_pose.yaml: two training frames
(num_train_frame 2) and the novel-pose window on frames 2-3
(num_eval_frame 2), the counts at which the tracked AniNeRF stage-2
file was trained. Each family takes its tree above with the color
latent table cut to its first two rows; LBW and LBWPDF take that file's
`bw_field` (latent (3, 128)) and `novel_pose_bw` (latent (2, 128)).
`write_novel_pose(family)` writes the tree with `novel_pose_bw` to
data/trained_model/deform/synthetic_aligned_<family>_novel_pose/ (the
config's exp_name, which `test_novel_pose` evaluates) and, for LBW and
LBWPDF, the stage-1 tree without it to
data/trained_model/deform/synthetic_aligned_<family>_2f/ (the config's
`init_aninerf`, from which stage 2 starts with `novel_pose_bw` at its
seeded init). From the repository root:

    python -m animatable_nerf_tpu_torch.compat.compose [lbw pbw smpl lbw_pdf]
    python -m animatable_nerf_tpu_torch.compat.compose lbw_novel_pose [...]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .flax_msgpack import read_checkpoint

ANINERF_CKPT = "data/trained_model/deform/synthetic/latest.flax"
NERF_PDF_CKPT = "data/trained_model/deform/synthetic_nerf_pdf/latest.flax"
NOVEL_POSE_CKPT = "data/trained_model/deform/synthetic_2f_anim/latest.flax"
FAMILIES = ("lbw", "pbw", "smpl", "lbw_pdf")
# the families with a novel-pose field (the others render novel poses
# through their stage-1 deform and have no stage 2)
NOVEL_POSE_FIELD = ("lbw", "lbw_pdf")
NOVEL_POSE_TRAIN_FRAMES = 2


def compose_aligned(family: str) -> dict:
    """The flax param tree {"params": {...}} of the aligned `family`
    (one of FAMILIES), composed from the tracked AniNeRF and NeRF-PDF
    checkpoints."""
    if family not in FAMILIES:
        raise ValueError(f"unknown aligned family {family!r}; one of {FAMILIES}")
    nerf_pdf = read_checkpoint(NERF_PDF_CKPT)["params"]
    nerf_pdf = nerf_pdf.get("params", nerf_pdf)
    tree = {"nerf_network": nerf_pdf["nerf_network"],
            "color_network": nerf_pdf["color_network"]}
    if family != "smpl":
        aninerf = read_checkpoint(ANINERF_CKPT)["params"]
        bw_field = aninerf.get("params", aninerf)["bw_field"]
        if family == "pbw":
            resd = nerf_pdf["resd_field"]["mlp"]
            mlp = {f"lin{i}": resd[f"lin{i}"] for i in range(8)}
            mlp["out"] = bw_field["mlp"]["out"]
            bw_field = {"mlp": mlp}
        tree["bw_field"] = bw_field
    if family == "lbw_pdf":
        tree["resd_field"] = nerf_pdf["resd_field"]
    return {"params": tree}


def compose_novel_pose(family: str, novel_pose_bw: bool = True) -> dict:
    """The flax param tree of the aligned `family` at num_train_frame 2
    (configs/synthetic_aligned_<family>_novel_pose.yaml), with the tracked
    AniNeRF stage-2 file's `novel_pose_bw` for LBW and LBWPDF unless
    `novel_pose_bw` is False (the stage-1 tree)."""
    tree = dict(compose_aligned(family)["params"])
    color = dict(tree["color_network"])
    color["color_latent"] = {"embedding": np.asarray(
        color["color_latent"]["embedding"])[:NOVEL_POSE_TRAIN_FRAMES]}
    tree["color_network"] = color
    if family in NOVEL_POSE_FIELD:
        anim = read_checkpoint(NOVEL_POSE_CKPT)["params"]
        anim = anim.get("params", anim)
        tree["bw_field"] = anim["bw_field"]
        if novel_pose_bw:
            tree["novel_pose_bw"] = anim["novel_pose_bw"]
    return {"params": tree}


def write_novel_pose(family: str) -> str:
    """`compose_novel_pose(family)` written as a fresh start into
    data/trained_model/deform/synthetic_aligned_<family>_novel_pose/ and,
    for LBW and LBWPDF, the stage-1 tree into
    data/trained_model/deform/synthetic_aligned_<family>_2f/; returns the
    first file's path."""
    from ..train.checkpoints import write_start

    base = f"data/trained_model/deform/synthetic_aligned_{family}"
    if family in NOVEL_POSE_FIELD:
        write_start(f"{base}_2f", compose_novel_pose(family, False))
    write_start(f"{base}_novel_pose", compose_novel_pose(family))
    return os.path.join(f"{base}_novel_pose", "latest.flax")


def write_aligned(family: str) -> str:
    """`compose_aligned(family)` written as a fresh start (zero Adam
    moments, step 0) into data/trained_model/deform/
    synthetic_aligned_<family>/; returns the file's path."""
    from ..train.checkpoints import write_start

    model_dir = f"data/trained_model/deform/synthetic_aligned_{family}"
    write_start(model_dir, compose_aligned(family))
    return os.path.join(model_dir, "latest.flax")


def main(argv=None):
    for name in (argv if argv else FAMILIES):
        if name.endswith("_novel_pose"):
            print(write_novel_pose(name[:-len("_novel_pose")]))
        else:
            print(write_aligned(name))


if __name__ == "__main__":
    main(sys.argv[1:])
