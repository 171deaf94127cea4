"""The port's CLI (counterpart of the repo's run.py, run types of
reference run.py):

    python -m animatable_nerf_tpu_torch.run --type evaluate \\
        --cfg_file configs/synthetic.yaml [--device cpu] [key value ...]

(or configs/synthetic_nerf_pdf.yaml, configs/synthetic_sdf_pdf.yaml,
configs/synthetic_neus_pdf.yaml for the displacement-field families).
AniNeRF's novel poses, from a stage-2 checkpoint:

    python -m animatable_nerf_tpu_torch.run --type evaluate \
        --cfg_file configs/synthetic_novel_pose.yaml test_novel_pose True \
        exp_name synthetic_2f_anim [--device cpu]

Runs on `cuda` unless `--device cpu` is given; without a GPU and
without `--device cpu` it raises.
"""

from __future__ import annotations

from . import engine
from .config import parse_cli


def main(argv=None):
    args, cfg = parse_cli(argv)
    if args.type != "evaluate":
        raise SystemExit(f"unknown --type {args.type!r}; ported: evaluate")
    engine.run_evaluate(cfg, args.device)


if __name__ == "__main__":
    main()
