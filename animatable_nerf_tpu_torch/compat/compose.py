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
that file. From the repository root:

    python -m animatable_nerf_tpu_torch.compat.compose [lbw pbw smpl lbw_pdf]
"""

from __future__ import annotations

import os
import sys

from .flax_msgpack import read_checkpoint

ANINERF_CKPT = "data/trained_model/deform/synthetic/latest.flax"
NERF_PDF_CKPT = "data/trained_model/deform/synthetic_nerf_pdf/latest.flax"
FAMILIES = ("lbw", "pbw", "smpl", "lbw_pdf")


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


def write_aligned(family: str) -> str:
    """`compose_aligned(family)` written as a fresh start (zero Adam
    moments, step 0) into data/trained_model/deform/
    synthetic_aligned_<family>/; returns the file's path."""
    from ..train.checkpoints import write_start

    model_dir = f"data/trained_model/deform/synthetic_aligned_{family}"
    write_start(model_dir, compose_aligned(family))
    return os.path.join(model_dir, "latest.flax")


def main(argv=None):
    for family in (argv if argv else FAMILIES):
        print(write_aligned(family))


if __name__ == "__main__":
    main(sys.argv[1:])
