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

Meshes (the mesh overlay; the KNN families name their mesh dataset,
lib.datasets.anisdf_mesh_dataset for SDF-PDF and NeuS-PDF,
lib.datasets.aninerf_pdf_mesh_dataset for NeRF-PDF and the aligned
families):

    python -m animatable_nerf_tpu_torch.run --type visualize \
        --cfg_file configs/synthetic.yaml vis_posed_mesh True [--device cpu]
    python -m animatable_nerf_tpu_torch.run --type visualize \
        --cfg_file configs/synthetic_sdf_pdf.yaml vis_tpose_mesh True \
        test_dataset_module lib.datasets.anisdf_mesh_dataset
    python -m animatable_nerf_tpu_torch.run --type animation \
        --cfg_file configs/synthetic_sdf_pdf.yaml vis_posed_mesh True \
        test_dataset_module lib.datasets.anisdf_mesh_dataset

write data/animation/<exp_name>/{posed_mesh,tpose_mesh}/<frame>.{ply,npy}.

Rendered visualizations, carved by the training views' masks (the KNN
families name the pdf datasets, test_dataset_module
lib.datasets.tpose_pdf_novel_view_dataset or
lib.datasets.tpose_pdf_pose_sequence_dataset):

    python -m animatable_nerf_tpu_torch.run --type visualize \
        --cfg_file configs/synthetic.yaml vis_novel_view True [vis_depth True]
    python -m animatable_nerf_tpu_torch.run --type visualize \
        --cfg_file configs/synthetic.yaml vis_pose_sequence True \
        [test_novel_pose True]
    python -m animatable_nerf_tpu_torch.run --type raster \
        --cfg_file configs/synthetic.yaml vis_posed_mesh True [raster_view 0]

write data/novel_view/<exp_name>/frame_<f>/<v>.png (with vis_depth also
<v>_depth.npy and <v>_acc.npy), data/perform/<exp_name>/frame<f>_view<v>.png
and data/raster/<exp_name>/frame<f>_view<v>.png with _depth.npy.

The image-space baselines NHR and NT (configs/baselines/, and on the
capsule's baseline copy, written by `python -m
animatable_nerf_tpu_torch.data.baseline_prep data/synthetic/capsule
data/synthetic/capsule_baseline`) take `--type evaluate` only:

    python -m animatable_nerf_tpu_torch.run --type evaluate \
        --cfg_file configs/synthetic_nhr.yaml [--device cpu]

Runs on `cuda` unless `--device cpu` is given; without a GPU and
without `--device cpu` it raises.
"""

from __future__ import annotations

from . import engine
from .config import parse_cli


# the run types, each engine.run_<type>
RUN_TYPES = ("evaluate", "visualize", "animation", "raster")
# the JAX CLI's other run types (run.py), not ported
UNPORTED_TYPES = ("dataset", "network", "light_stage", "evaluate_nv", "lpips")


def main(argv=None):
    args, cfg = parse_cli(argv)
    if args.type in UNPORTED_TYPES:
        raise NotImplementedError(
            f"--type {args.type} is not ported; ported: " + ", ".join(RUN_TYPES))
    if args.type not in RUN_TYPES:
        raise SystemExit(f"unknown --type {args.type!r}; ported: "
                         + ", ".join(RUN_TYPES))
    return getattr(engine, f"run_{args.type}")(cfg, args.device)


if __name__ == "__main__":
    main()
