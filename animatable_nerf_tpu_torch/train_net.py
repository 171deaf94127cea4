"""The port's training CLI (counterpart of the repo's train_net.py):

    python -m animatable_nerf_tpu_torch.train_net \\
        --cfg_file configs/synthetic.yaml [--device cpu] [key value ...]
    python -m animatable_nerf_tpu_torch.train_net \\
        --cfg_file configs/synthetic_sdf_pdf.yaml [--device cpu] [key value ...]

and the same with configs/synthetic_nerf_pdf.yaml (NeRF-PDF) or
configs/synthetic_neus_pdf.yaml (NeuS-PDF). Trains AniNeRF or a
displacement-field family, stage 1 (engine.py `run_train`), on `cuda`
unless `--device cpu` is given; without a GPU and without
`--device cpu` it raises. For SDF-PDF and NeuS-PDF, `init_sdf <exp>`
starts a fresh run from the SDF network of
data/trained_model/<task>/<exp>. AniNeRF's stage 2, the novel-pose
blend-weight field on the frames after the training ones, from the
stage-1 run `init_aninerf` names:

    python -m animatable_nerf_tpu_torch.train_net \
        --cfg_file configs/synthetic_novel_pose.yaml aninerf_animation True \
        exp_name synthetic_2f_anim [--device cpu]
The image-space baselines NHR and NT train one whole image a step
from a seeded start (configs/synthetic_nhr.yaml and synthetic_nt.yaml
read the capsule's baseline copy, data/baseline_prep.py):

    python -m animatable_nerf_tpu_torch.train_net \
        --cfg_file configs/synthetic_nhr.yaml [--device cpu]

Checkpoints go to data/trained_model/<task>/<exp_name>/ in the JAX
package's flax format, so `python run.py --type evaluate` (JAX) and
`python -m animatable_nerf_tpu_torch.run --type evaluate` (the port)
both read them. `resume False` starts afresh; `fix_random True` seeds
the ray draw.
"""

from __future__ import annotations

import numpy as np

from . import engine
from .config import parse_cli


def main(argv=None):
    args, cfg = parse_cli(argv)
    if cfg.fix_random:
        np.random.seed(0)
    engine.run_train(cfg, args.device)


if __name__ == "__main__":
    main()
