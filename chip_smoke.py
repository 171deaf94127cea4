#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (animatable_nerf_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:
  1. the card (nvidia-smi) and the build of every kernel from csrc/
     (one nvcc per source, all at once);
  2. kernel K1 (ops/skip_mlp.py, csrc/skip_mlp.cu) against its plain
     PyTorch version on the card, at the three production wirings and
     the row count of one eval tile's survivors, with times and bounds
     (and the tensor-core instructions of its SASS);
  3. kernels K2-K6 (ops/knn.py, csrc/knn.cu) against their plain
     versions: K2 at 131,072 queries over 6890 vertices with duplicate
     vertices (also timed at a full frame's 77,505 queries a launch and
     with one channel, and its walk's pairs counted by its counting
     build); K3 and K4 at the 96^3 grid builds of one capsule frame,
     timed alone, as calls, and as calls on a fresh vertex tensor (their
     layout built in the call), with their walks counted by their
     counting builds; K5 and K6 at 131,072 queries around that frame's
     vertices, with the frame's d5 grid (K5, its kept blocks per tile
     and its rejects counted) and cell lists (K6, and the whole
     `build_cell_knn` call that holds one K3 and one K4), both also held
     against K2. K2's and K5's bounds count the pairs the data needs
     (band_pairs), K3's and K4's the vertices of the runs they must
     sweep (run_pairs);
  4. the port's `run_evaluate` on configs/synthetic.yaml (AniNeRF) with
     the tracked checkpoint (4 views), each view held to the JAX
     package's PSNR within PSNR_TOL_DB, with K1's launches counted;
  5. a torch.profiler breakdown of one 128x128 AniNeRF eval frame, then
     one full-size 1000x1002 frame of the same subject, timed and
     profiled;
  6. the same for SDF-PDF (configs/synthetic_sdf_pdf.yaml, the capsule
     subject): `run_evaluate` held to the JAX PSNR with K1, K2 and K3
     each launched, then one 1000x1002 frame timed and profiled;
  7. the same with `knn_blocked True` (the d5 grid by K4, pass 2 by K5):
     `run_evaluate` held to the same JAX PSNR with K2 launched 0 times,
     and one 1000x1002 frame held to phase 6's frame: K5 against K2 on
     the frame's pass-2 points differs only on rows with an exact
     distance tie, and the maps within 1e-6 on every other ray; K2 and
     K5 timed on those points, per tile launch and per 131,072;
  7b. the same as phase 6 for NeRF-PDF and NeuS-PDF
     (configs/synthetic_nerf_pdf.yaml, configs/synthetic_neus_pdf.yaml,
     the capsule subject): `run_evaluate` held to each family's JAX
     PSNR, then one 1000x1002 frame timed and profiled. Their point
     filter reads only the posed vertices, so each path must launch K1,
     K2 and K3 as often as phase 6's and report its candidate and
     survivor counts, view by view and on the full frame;
  8. training (configs/synthetic.yaml, AniNeRF): K1's gradient
     (ops/skip_mlp.py `SkipMLPFunction`: the kernel forward, the vjp of
     the plain version) against autograd through the plain version at
     one step's 32,768 rows; one train step on the card against the
     same step on this machine's CPU; `run_train` for one epoch of 50
     steps (perturb 0, the ray draw seeded, from the tracked weights
     with a fresh Adam at step 0) with K1's launches counted; the
     port's evaluate of the checkpoint it wrote, each view held to the
     JAX package's PSNR for the same run on the CPU; and a profile of
     train steps (device ms by kernel, K1's share, the backward's time,
     the per-step repack of K1's weights);
  9. training of SDF-PDF (configs/synthetic_sdf_pdf.yaml): K1's gradient
     of a gradient (the observed-space eikonal term's path) against
     autograd-of-autograd through the plain version at 32,768 rows of
     the displacement field's wiring; one train step on the card against
     the CPU (K1 twice and K2 once on the card); `run_train` for one
     epoch of 50 steps as in phase 8, with every kernel's launches
     counted (K1 2 and K2 1 a step, K3-K6 none); the evaluate of its
     checkpoint held to the JAX package's PSNR for the same run on the
     CPU; a profile of 5 steps (K1's and K2's shares, the backward with
     its double backward by events); and K2 on one step's dense points
     (timed, its bound, the cdist chain);
 10. training of NeRF-PDF and NeuS-PDF (configs/synthetic_nerf_pdf.yaml,
     configs/synthetic_neus_pdf.yaml) on SDF-PDF's dense train path: for
     each, one train step on the card against the CPU (NeRF-PDF K1 once
     and K2 once, NeuS-PDF K1 twice and K2 once on the card), then
     `run_train` for one epoch of 50 steps as in phase 8 with every
     kernel's launches counted, the evaluate of its checkpoint held to
     the JAX package's PSNR for the same run on the CPU, and a profile
     of 5 steps (K1's and K2's shares, forward and backward by events);
 11. AniNeRF stage 2 (configs/synthetic_novel_pose.yaml): the
     `test_novel_pose` evaluate of the tracked stage-2 checkpoint
     (frames 2-3, view 3) held to the JAX package's PSNR, with K1's
     launches and the candidate and survivor counts; frame 2 at
     1000x1002 timed and profiled (K1 twice a tile); K1 against its
     plain version at a stage-2 step's 65,536 rows of the blend-weight
     and density-trunk wirings; one stage-2 step on the card against
     the CPU on the same points (K1 six times, a gradient for
     `novel_pose_bw` alone); `run_train` for one epoch of 50 stage-2
     steps from the common start (`write_initial_start`), every frozen
     leaf bit-identical to the start after it and the novel-pose
     evaluate of its checkpoint held to the JAX CPU run of the same 50
     steps; and a profile of 5 steps;
 12. real cameras: distorted copies of the synthetic roots
     (data/distorted_copy.py: lens distortion on every camera, masks at
     half size) in a temporary directory, read at ratio 0.5 through
     data/camera.py's undistort and resizes: the evaluates of AniNeRF
     (configs/synthetic_novel_pose.yaml, the synthetic_2f weights),
     SDF-PDF and NeRF-PDF held to the JAX package's PSNR on the same
     copies (K1, and K1-K3 for the PDF families, launched); one AniNeRF
     train step on the card against the CPU, then 20 steps of
     `run_train` (s/step, data s/step, device ms and idle share); one
     512x512 AniNeRF frame of the copy at 1024x1024 (device ms, K1
     launches); and the host time of `load_image` at 1024x1024, cold
     (the undistort maps built) and warm, for an eval and a train item;
 13. the aligned families (configs/synthetic_aligned_{lbw,pbw,smpl,
     lbw_pdf}.yaml) on weights composed from the tracked AniNeRF and
     NeRF-PDF checkpoints (compat/compose.py, written first): for each,
     the evaluate held to the JAX package's PSNR on the composed file,
     with K1 1 / 1 / 0 / 2 times a tile, K2 once a tile and K3 once a
     frame; item 0 on the card against the port's CPU render; one train
     step (256 rays) on the card against the CPU, held by the whole
     gradient (LBWPDF's loss to ALIGNED_LOSS_RTOL), and the same step
     with K1's plain version on the card held to the CPU's (every stat
     within TRAIN_LOSS_RTOL); one epoch of 50 steps from the composed start (K1 2 / 2 /
     0 / 3 and K2 2 / 2 / 1 / 2 a step) and the evaluate of its
     checkpoint held to the JAX CPU run of the same steps; a profile of
     5 steps; on LBW's step, K2's differentiable form on the canonical
     points (the launch with and without its index output against the
     plain version, the backward against the CPU's, their times and the
     cdist chain's); and one 1000x1002 frame of LBW and of LBWPDF;
 14. the aligned families' novel poses and pass 1 without the distance
     grid: the four `test_novel_pose` evaluates
     (configs/synthetic_aligned_<f>_novel_pose.yaml, frames 2-3, view 3,
     on weights composed by compose.py `write_novel_pose`) held to the
     JAX package's PSNR, with K1 1 / 1 / 0 / 2 times a tile, K2 once a
     tile and K3 once a frame; for LBW and LBWPDF one stage-2 step on
     the card against the CPU on the same points (16,384 a branch; K1
     and K2 four times each), and with K1's plain version on the card,
     then one epoch of 50 stage-2 steps from the common start
     (`write_initial_start`), every frozen leaf unchanged, and the
     novel-pose evaluate of its checkpoint held to the JAX CPU run of
     the same steps, a profile of 5 steps, and on LBW K2's
     differentiable form and its backward at the step's 65,536
     canonical points; the evaluates of SDF-PDF, NeRF-PDF, NeuS-PDF and
     AlignedLBW with `knn_grid_res 0` held to the JAX no-grid PSNR and
     to the grid evaluates of the same call (the same survivors), K3
     once a tile; one 1000x1002 SDF-PDF frame without the grid (K3 once
     a tile, its layout built once, the grid frame's survivors and
     maps, device time against the grid frame), and K3 on 4 of its
     tiles against its plain version, with its time per tile launch,
     the bound of the pairs the data needs (`run_pairs`) and the cdist
     chain's time;
 15. meshes (`--type visualize` with vis_posed_mesh, `--type animation`):
     for each of the eight families, `run_visualize` of frame 0 at
     voxel 0.02 (configs/synthetic.yaml's; the mesh datasets of
     MESH_FAMILIES), its posed mesh held to the JAX package's
     (JAX_MESH: counts, centroid, bounding box, area), K1 and K2 counted
     a sweep tile; `run_animation` of SDF-PDF over the four test frames
     with one vertex count; then full size, voxel 0.005, AniNeRF (the
     human subject) and SDF-PDF (the capsule): one `extract_mesh` of
     frame 0 profiled (its grid points and tiles, K1's and K2's
     launches by the wrappers and by the profiler, the sweep's device
     and wall time, the host's marching cubes and largest component,
     the SDF re-pose), and the sweep held to the same sweep with K1's and
     K2's plain versions on the card (MESH_FIELD_REL_TOL, the filter's
     flips counted);
 16. rendered visualizations (`--type visualize` with vis_novel_view or
     vis_pose_sequence, `--type raster`): `run_visualize` of one view or
     frame, carved by the training views' masks, for the novel views of
     AniNeRF, SDF-PDF, NeuS-PDF and AlignedLBW and the pose sequences of
     AniNeRF's novel poses and NeRF-PDF (VIS_CASES, ratio 0.5, the
     distance grid at 24^3), each held to the JAX package's summary of
     the same render (JAX_VIS) and to the port's CPU render of the item,
     with K1, K2 and K3 counted a tile; `run_raster` of AniNeRF's and
     SDF-PDF's frame 0 held to JAX's covered pixels and depth
     (JAX_RASTER); then one 1000x1002 novel view of AniNeRF and of
     SDF-PDF carved by the masks at that size: its time, the carve's
     device time, its survivors with and without the carve, and the
     uncarved render of the same rays within VIS_FRAME_TOL on the rays
     the carve removed nothing from;
 17. the image-space baselines NHR and NT (plain PyTorch, no kernel of
     K1-K6, every count held at 0) on the capsule's baseline copy
     written into a temporary directory (`write_baseline_copy`), from
     the port's seeded start: `run --type evaluate` held to the JAX
     package's PSNR (JAX_PSNR_BASELINE); an item and a train step on the
     card against the CPU (NHR's bounds at least twice what one ulp of
     its vertices moves the CPU's own result, under fixed ceilings); 20
     steps of `run_train` on the card, held at matched weights at the
     steps BASELINE_MATCHED_STEPS (the CPU from the card's weights and
     Adam state: the loss, the gradient, and Adam's update from the
     card's gradient), then its evaluate printed beside the JAX CPU run
     of 50 steps; then the copy at 1024x1024: one frame and 5
     steps at full width (s per frame and step, device ms, idle share,
     peak memory, top device ops, NHR's furthest-point sampling), NT's
     frame held to the CPU's, NHR's checked finite and in range;
 18. train-time survivor compaction (`train_keep_frac` 0.9): for each of
     the eight families at its synthetic config (512 rays x 64 samples,
     tracked or composed weights), the dense step and the compacted step
     on the card from the same weights, the loss and stats within
     TRAIN_LOSS_RTOL (LBWPDF: ALIGNED_LOSS_RTOL) and each gradient leaf
     within TRAIN_GRAD_REL of each other; the compacted step's launches
     (K3 once on the frame's first step, for its 64^3 distance grid, and
     0 on the second; K1 and K2 as often as the dense step's), pass 1's
     candidates and the exact survivors, K2's rows (the candidates) and
     K1's (the survivors); the compacted step on the card against the
     CPU's (64 rays, a 16^3 grid); both steps timed (the median wall of
     10 steps each, in turns; device ms, idle share, K1, K2, K3 ms) and
     the 64^3 grid built on 10 fresh vertex copies; then
     50 compacted steps of SDF-PDF and of AniNeRF, K3 once a frame, each
     evaluate held to the JAX CPU run of the same steps
     (JAX_PSNR_TRAIN_COMPACT); the 64^3 grid's build also gives K3's
     bound there (`run_pairs`, as phase 3's at 96^3);
 19. the host pipeline and the rest of the CLI: `run_train` of phase
     12's real-camera copy at 1024x1024 for 20 steps at one and at four
     reader threads (`train.num_workers` 2 and 8), from one start: s/step,
     data s/step, the device's idle share, every batch's digest and every
     loss equal between the two; phase 4's evaluate through the
     pipelined evaluate with `eval_timing True` (its
     `eval_timing_per_frame` line, held to the JAX PSNR); `--type
     dataset` (items a second); `--type network` with `profile_dir` (the
     trace written, K1's launches those of `render_item` on the same
     frames); `--type evaluate_nv` on the evaluate's comparison PNGs
     (each view within the PSNR bound of 8-bit truncation); `--type
     lpips` on those pairs with seeded alex weights (the card's scores
     within 1e-5 of the CPU's; one 1000x1002 pair timed); `--type
     light_stage` on a seeded binary PLY of 100,000 points (the
     occupancy equal to a numpy floor reference);
 20. the evaluation options: K1's bf16 form (compute_dtype bfloat16)
     against its plain bf16 version at the three wirings and K1_ROWS
     rows, timed against its bf16 bound, the bf16 addmm chain and the
     float32 form, with the bytes its weight stream reads from L2 a
     call, the rate that implies and the rate of the stream alone, and
     its ptxas spills (none allowed, nor serialized wgmmas) and SASS
     HGMMA count; the bf16 evaluates of
     AniNeRF and SDF-PDF held to the JAX bf16 PSNR, each view within
     JAX's max rgb delta of 0.02 of the port's float32 view, and one
     1000x1002 AniNeRF frame in bf16 beside float32 (wall, device ms,
     K1's share); the `use_importance` evaluates of AniNeRF, SDF-PDF and
     NeuS-PDF held to the JAX PSNR, K1 and K2 launched a tile on both
     passes; AniNeRF's `slab_filter 8` evaluate held to the JAX PSNR
     and, view by view, to the flat render, and its 1000x1002 frame
     beside the flat one (wall, device ms, candidates); `seg_filter 4`
     on SDF-PDF, which renders as without it;
 21. the training options: K1's bf16 form against its plain version at a
     train step's rows (32,768 dense, 24,323 and 16,673 compacted,
     65,536 of stage 2) beside its bound, the bf16 chain, the float32
     form and its backward, and the bf16 repack a step; a bf16 step of
     each of the eight families, of AniNeRF's compacted step and of its
     stage 2 on the card against the CPU, K1's bf16 form launched as
     often as the float32 step launches the float32 form and that form
     never; 50 bf16 steps of AniNeRF and SDF-PDF held to the JAX
     package's bf16 runs, and bf16 steps beside float32 ones in turns;
     five AniNeRF steps under Adam, RAdam, SGD and AdamW held at matched
     weights, each update timed (torch.optim.Adam's beside Adam's), their
     checkpoints read back; SDF-PDF with `eval_ep 1`
     (two "val" lines, `best.flax`, the evaluations' K1 and K3); a
     NeRF-PDF step in four chunks (its trainer's `dense_chunk_rows` at
     8192) against the CPU and a 4096-ray step in two chunks at the
     default bound, timed;
 22. the host tools and the baselines' VGG19 objective (none of K1-K6
     but on the imported evaluates): JAX's seeded VGG19 head written as
     a torchvision .pth and converted by tools/convert_vgg_weights.py;
     one `train.vgg_weights` step of NHR and NT on phase 17's copy on
     the card against the CPU at matched weights, NT's vgg_loss and
     l1_loss held to the JAX package's (JAX_VGG_NT), then 5 steps of
     each at 1024x1024 beside the stand-in objective's, and the VGG
     head's forward and backward alone; the tracked AniNeRF and SDF-PDF
     checkpoints exported to reference .pth files
     (compat/torch_export.py), imported by `python -m
     animatable_nerf_tpu_torch.tools.import_torch_checkpoint` and
     evaluated: each view equal to phases 4 and 6 to 1e-6 dB, K1-K3
     launched as there; `prepare_lbs_meta` and `prepare_blend_weights`
     on the capsule's 4 frames with an SMPL-sized body (13,776 faces):
     six closest-point grids on the card, timed, 4096 points of one
     held to the CPU (the face but at ties, dist, bary); and the
     skeleton render of one frame and camera, its drawn pixels equal to
     JAX's cv2 drawing's;
then the kernel table line, the script's seconds, the card line and
{"ok": true, ...} last. Each phase's line carries its wall `seconds`.
Kernel launch counts are set to 0 just before each path and read just
after it. Any failed phase raises and exits non-zero. Imports nothing of
JAX.
"""

import atexit
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Per-view PSNR (frames 0-3, view 3) of the JAX package on
# configs/synthetic.yaml with data/trained_model/deform/synthetic/latest.flax,
# computed on the CPU with:
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic.yaml
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR = [7.655750694805134, 7.5696494082365495, 8.05470772363299,
            9.417616795213712]
# The same for SDF-PDF on configs/synthetic_sdf_pdf.yaml with
# data/trained_model/deform/synthetic_sdf_pdf/latest.flax (frames 0-3,
# view 3), computed on the CPU with:
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_sdf_pdf.yaml
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_sdf_pdf/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_SDF = [19.918607338172638, 22.15452214101879, 23.829273881602546,
                25.011918868247466]
# Per-view PSNR (frames 0-3, view 3) of the JAX package after one epoch
# of 50 steps of configs/synthetic.yaml from the tracked weights with a
# fresh Adam at step 0, perturb 0 and the ray draw seeded, computed on
# the CPU with (the starting checkpoint written by the port, which JAX
# resumes from; `train.num_workers 2` gives JAX's loader one thread,
# so the seeded draws come in item order):
#   python -c "from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start as w; w('data/trained_model/deform/synthetic/latest.flax', 'data/trained_model/deform/train50_jax')"
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file configs/synthetic.yaml exp_name train50_jax train.epoch 1 perturb 0 fix_random True train.num_workers 2 resume True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic.yaml exp_name train50_jax
#   python -c "import numpy as np; print(np.load('data/result/deform/train50_jax/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_TRAIN = [12.357885896866387, 13.075392752633316, 13.178003074358783,
                  14.846938962667753]
# The same for SDF-PDF: one epoch of 50 steps of
# configs/synthetic_sdf_pdf.yaml from the tracked weights, fresh Adam,
# perturb 0 and the ray draw seeded, computed on the CPU with:
#   python -c "from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start as w; w('data/trained_model/deform/synthetic_sdf_pdf/latest.flax', 'data/trained_model/deform/train50_sdf_jax')"
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file configs/synthetic_sdf_pdf.yaml exp_name train50_sdf_jax train.epoch 1 perturb 0 fix_random True train.num_workers 2 resume True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_sdf_pdf.yaml exp_name train50_sdf_jax
#   python -c "import numpy as np; print(np.load('data/result/deform/train50_sdf_jax/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_TRAIN_SDF = [21.096650006737693, 22.82760370503967, 24.089425792358725,
                      24.915604842368836]
# The same for NeRF-PDF and NeuS-PDF on configs/synthetic_nerf_pdf.yaml
# and configs/synthetic_neus_pdf.yaml with their tracked checkpoints
# (600 and 400 JAX CPU steps, the commands in each config's header; the
# draw was not seeded, so the constants belong to the tracked files, and
# a rebuilt file needs them computed again), computed on the CPU with:
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_nerf_pdf.yaml
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_nerf_pdf/metrics.npy', allow_pickle=True).item()['psnr'])"
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_neus_pdf.yaml
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_neus_pdf/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_NERF_PDF = [19.595280411095594, 22.00581491525693, 22.569217838586276,
                     23.556801078276198]
JAX_PSNR_NEUS_PDF = [21.087645831516657, 23.324572879268064, 24.59723973769971,
                     25.410040919281137]
# The same for NeRF-PDF and NeuS-PDF: one epoch of 50 steps of
# configs/synthetic_nerf_pdf.yaml and configs/synthetic_neus_pdf.yaml
# from their tracked weights, fresh Adam, perturb 0 and the ray draw
# seeded, computed on the CPU with (<f> is nerf, then neus):
#   python -c "from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start as w; w('data/trained_model/deform/synthetic_<f>_pdf/latest.flax', 'data/trained_model/deform/train50_<f>_jax')"
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file configs/synthetic_<f>_pdf.yaml exp_name train50_<f>_jax train.epoch 1 perturb 0 fix_random True train.num_workers 2 resume True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_<f>_pdf.yaml exp_name train50_<f>_jax
#   python -c "import numpy as np; print(np.load('data/result/deform/train50_<f>_jax/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_TRAIN_NERF_PDF = [16.894390662515747, 20.012868710307224,
                           20.305442278667034, 22.350231658445075]
JAX_PSNR_TRAIN_NEUS_PDF = [19.528702528923024, 22.199117244717034,
                           23.002480195160604, 24.149925234993855]
# AniNeRF stage 2 (configs/synthetic_novel_pose.yaml: stage 1 on frames
# 0-1, the novel-pose window on frames 2-3; the configs' header gives the
# commands that made its two tracked checkpoints). Per-view PSNR (frames
# 2-3, view 3) of the JAX package's novel-pose evaluate of the tracked
# stage-2 checkpoint, computed on the CPU with:
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_novel_pose.yaml test_novel_pose True exp_name synthetic_2f_anim
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_2f_anim/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_NOVEL_POSE = [19.44497446793018, 20.48112558264862]
# The same after one epoch of 50 stage-2 steps (65,536 points a branch)
# from the common start the port writes (the stage-1 weights and the
# port's seeded init of novel_pose_bw, a fresh Adam), computed on the CPU
# with:
#   python -c "from animatable_nerf_tpu_torch.config import load_config as c; from animatable_nerf_tpu_torch.engine import write_initial_start as w; w(c('configs/synthetic_novel_pose.yaml', ['aninerf_animation', 'True', 'exp_name', 'anim50_jax']))"
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file configs/synthetic_novel_pose.yaml aninerf_animation True exp_name anim50_jax train.epoch 1 fix_random True train.num_workers 2 resume True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_novel_pose.yaml test_novel_pose True exp_name anim50_jax
#   python -c "import numpy as np; print(np.load('data/result/deform/anim50_jax/metrics.npy', allow_pickle=True).item()['psnr'])"
# The two packages draw their points from their own generators, so the
# runs agree in distribution, not point for point.
JAX_PSNR_TRAIN_ANIMATION = [19.41772006377906, 20.455082227639465]
PSNR_TOL_DB = 0.1
NOVEL_POSE_CFG = "configs/synthetic_novel_pose.yaml"
ANIM_EXP = "chip_smoke_train_anim"
ANIM_OPTS = ["aninerf_animation", "True", "exp_name", ANIM_EXP, "train.epoch",
             "1", "fix_random", "True", "resume", "True", "log_interval", "10"]
ANIM_ROWS = 65536  # n_anim_samples: each branch's points a stage-2 step
TRAIN_EXP = "chip_smoke_train"  # exp_name of the train phase's run
TRAIN_OPTS = ["exp_name", TRAIN_EXP, "train.epoch", "1", "perturb", "0",
              "fix_random", "True", "resume", "True", "log_interval", "10"]
TRAIN_SDF_CFG = "configs/synthetic_sdf_pdf.yaml"
TRAIN_SDF_EXP = "chip_smoke_train_sdf"
TRAIN_SDF_OPTS = ["exp_name", TRAIN_SDF_EXP] + TRAIN_OPTS[2:]
TRAIN_ROWS = 32768  # one step's dense points: N_rand 512 x N_samples 64
# the card's train step against the CPU's: loss rtol, and each gradient
# leaf within TRAIN_GRAD_REL of its largest entry (rounding in the
# canonical points is multiplied by the positional encoding; the JAX
# and port CPU steps differ by up to 2.3e-3, tests/test_torch_train.py)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-2
# K1's gradient against autograd through the plain version: the
# backward is the plain version's own vjp, so only the forward's 3xTF32
# rounding enters (K1_REL_TOL of the scale of each tensor)
# K1 against its plain version: 3xTF32 on the tensor cores against FP32
# (TF32 off), summed in another order over up to 447 terms per layer and
# 9 chained layers; the split keeps float32 accuracy (its CPU emulation in
# tests/test_torch_mlp.py is within 6e-7 of FP32 at these widths), so
# 1e-4 of the output scale leaves room.
K1_REL_TOL = 1e-4
K1_ROWS = 131072  # survivors of one 8192-ray tile at a 25% keep
# K2-K6 round every operation as their plain versions do (no FMA, the
# same order), so they agree to the bit
KNN_TOL = 0.0
K2_ROWS = 131072  # queries, as many as K1_ROWS
# K2's queries per launch on a full SDF-PDF frame: 4,960,334 pass-1
# candidates over 64 tiles
K2_FRAME_ROWS = 77505
K2_DUPS = 64  # vertices that are exact copies of others
GRID_RES = 96  # the engine's knn_grid_res
CELL_RES = (12, 12, 12)  # K6's cell grid
CELL_CAPS = (2048, 2304, 3072, 4096)  # K6 takes the least without overflow
# slots for the cells that can hold a point within 0.1 of a vertex: the
# flat capsule has 841 such cells at 12^3, more than the default 512
CELL_SLOTS = 1024
NORM_TH = 0.1  # the SDF-PDF filter on K2's weighted distance
# the blocked full frame against the flat one: K5 picks K2's neighbours,
# but breaks exact distance ties in Morton order, not by vertex index
FRAME_TOL = 1e-6
# operations per (query, vertex) pair: 3 subtractions, 3 multiplications,
# 2 additions and a compare or min
OPS_PER_PAIR = 9
# published H100 SXM peaks (at the 700 W limit): FP32 outside the tensor
# cores, TF32 on them (dense), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# K1 forms each float32 product from three TF32 ones (3xTF32)
K1_TF32_PASSES = 3
PEAK_BYTES_PER_S = 3.35e12
FULL_H, FULL_W = 1002, 1000  # H36M S9's frame (configs/aninerf_s9p.yaml)


# when the last line was printed (main sets it when the script starts)
_LAST_LINE = [time.time()]


def emit(obj):
    """Print obj as one JSON line. A phase's line gains `seconds`, the
    wall time since the line before it: the phase's own time (a phase
    of several lines: each part's)."""
    now = time.time()
    if "phase" in obj:
        obj = {**obj, "seconds": now - _LAST_LINE[0]}
    _LAST_LINE[0] = now
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=2, iters=10):
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the port's own kernels, by the names the profiler gives them
OWN_KERNELS = ("skip_mlp_kernel", "skip_mlp_bf16_kernel", "knn_blend_kernel",
               "min_dist_kernel", "kth_dist_kernel", "knn_blocked_kernel",
               "knn_celled_kernel")


def device_breakdown(fn, top=8, host=True):
    """Device time of one fn() run by kernel, from torch.profiler: the
    wall time, the summed kernel time (one stream, so kernels do not
    overlap), the idle share, the `top` kernels by time and the time and
    launches of each of the port's own kernels. Times in ms; the kernel
    numbers are None where the profiler recorded no device time. Without
    `host` the profiler records the device alone (a long run's host
    events take it many seconds to aggregate)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_kernel, launches = {}, {}
    for e in prof.key_averages():
        # device-side events only: an operator's own entry repeats the
        # time of the kernels it launched, and so does a range recorded
        # on the device's timeline (torch.optim's "Optimizer.step#...")
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
            launches[e.key] = launches.get(e.key, 0) + e.count
    busy_ms = sum(by_kernel.values())
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "kernels": None}
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    own = {name: sum(v for k, v in by_kernel.items() if name in k)
           for name in OWN_KERNELS}
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels": [{"name": k[:80], "ms": v, "share": v / busy_ms}
                        for k, v in ranked],
            "own_kernels_ms": own,
            "own_kernels_launches": {name: sum(
                n for k, n in launches.items() if name in k)
                for name in OWN_KERNELS}}


def wrapper_split(fn, kernel, iters=10):
    """`iters` calls of a wrapper under the profiler, per call: its device
    time, the part in `kernel`, and its largest kernels (the sorts and
    gathers around the kernel)."""
    fn()
    prof = device_breakdown(lambda: [fn() for _ in range(iters)], top=4)
    if prof["kernels"] is None:
        return prof
    return {"calls": iters, "device_ms": prof["device_ms"] / iters,
            "kernel_ms": prof["own_kernels_ms"][kernel] / iters,
            "top": [dict(k, ms=k["ms"] / iters) for k in prof["kernels"]]}


def kernel_alone(times, split):
    """The times of a wrapper that sorts, tiles and gathers around its
    kernel (K5, K6): the kernel's own device time from the profiler as
    kernel_ms, and the whole call's event time as call_ms. Where the
    profiler saw no device time, kernel_ms is the whole call's, and
    kernel_ms_from says so."""
    own = split.get("kernel_ms")
    rest = {k: v for k, v in times.items() if not k.startswith("kernel_ms")}
    return {**rest, "kernel_ms": times["kernel_ms"] if own is None else own,
            "kernel_ms_from": "events of the whole call" if own is None
            else "profiler", "call_ms": times["kernel_ms"],
            "call_ms_runs": times["kernel_ms_runs"], "profile": split}


def bound(ops, nbytes, peak=PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations over `peak`
    (the FP32 one unless given) and the bytes over the HBM rate."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def timed_pair(kernel, plain, library, plain_iters=3):
    """Times in ms on one card and call: plain, kernel, kernel, plain,
    then the library chain."""
    plain_a = cuda_ms(plain, warmup=1, iters=plain_iters)
    kern_a = cuda_ms(kernel)
    kern_b = cuda_ms(kernel)
    plain_b = cuda_ms(plain, warmup=1, iters=plain_iters)
    return {"kernel_ms": (kern_a + kern_b) / 2, "kernel_ms_runs": [kern_a, kern_b],
            "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
            "library_ms": cuda_ms(library, warmup=1, iters=plain_iters)}


def k1_wirings():
    """(name, din, layer shapes, skips, act_last) of the three trunks."""
    def shapes(din, n_hidden, dout_last):
        dims = []
        d_in = din
        for i in range(n_hidden):
            dims.append((d_in, 256))
            d_in = 256 + (din if i == 4 else 0)
        if dout_last:
            dims.append((d_in, dout_last))
        return dims

    return [
        ("bw_field", 191, shapes(191, 8, 24), (4,), False),
        ("tpose_trunk", 63, shapes(63, 8, 0), (4,), True),
        ("resd_field", 135, shapes(135, 8, 3), (4,), False),
    ]


def sass_counts(lib_path):
    """Tensor-core instructions of each kernel in a built library's SASS
    (cuobjdump next to nvcc): HGMMA for wgmma, HMMA for mma.sync; None
    without cuobjdump."""
    from animatable_nerf_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        head = part.split("\n")[0]
        name = next((k for k in OWN_KERNELS if k + "E" in head), head)
        out[name] = {op: len(re.findall(rf"\b{op}\.", part))
                     for op in ("HGMMA", "HMMA")}
    return out


def phase_k1(skip_mlp, skip_mlp_plain, pack_layers, n_rows=K1_ROWS,
             wirings=None, phase="k1_vs_plain"):
    """K1 against its plain version at `n_rows` rows of each wiring (all
    three, or those named in `wirings`), timed with its bound; returns
    one row per wiring."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, din, dims, skips, act_last in k1_wirings():
        if wirings is not None and name not in wirings:
            continue
        x = torch.rand(n_rows, din, device="cuda", generator=gen) * 2 - 1
        layers = [
            (torch.randn(i, o, device="cuda", generator=gen) / math.sqrt(i),
             torch.randn(o, device="cuda", generator=gen) * 0.1)
            for i, o in dims
        ]
        kwargs = dict(skips=skips, act="relu", act_last=act_last)

        def library():
            h = x
            for j, (w, b) in enumerate(layers):
                h = torch.addmm(b, h, w)
                if j < len(layers) - 1 or act_last:
                    h = torch.relu_(h)
                    if j in skips and j < len(layers) - 1:
                        h = torch.cat([x, h], dim=-1)
            return h

        got = skip_mlp(x, layers, **kwargs)  # packs the weights itself
        torch.cuda.synchronize()
        ref = skip_mlp_plain(x, layers, **kwargs)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(math.isfinite(err) and err <= K1_REL_TOL * max(scale, 1.0),
              f"K1 {name}: max abs err {err} vs output scale {scale}")
        # timed as the fields call it: the weights packed once beforehand
        packed = pack_layers(layers, skips)
        times = timed_pair(lambda: skip_mlp(x, layers, packed=packed, **kwargs),
                           lambda: skip_mlp_plain(x, layers, **kwargs),
                           library, plain_iters=10)
        flops = 2 * n_rows * sum(i * o for i, o in dims)
        nbytes = 4 * (n_rows * (din + dims[-1][1])
                      + sum(i * o + o for i, o in dims))
        bound_ms, bound_by = bound(K1_TF32_PASSES * flops, nbytes,
                                   PEAK_TF32_FLOPS)
        rows.append({
            "wiring": name, "rows": n_rows, "din": din,
            "dout": dims[-1][1], "layers": len(dims),
            "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
            "tol_abs": K1_REL_TOL * max(scale, 1.0), **times,
            "flops": flops, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_fp32_ms": bound(flops, nbytes)[0],
            "share_of_bound": bound_ms / times["kernel_ms"],
            # the float32 work counted once, not the three TF32 passes
            "kernel_tflops": flops / (times["kernel_ms"] * 1e-3) / 1e12,
        })
    emit({"phase": phase, "tolerance": (
        f"max abs err <= {K1_REL_TOL} x max(1, max |plain|): 3xTF32 tensor "
        "cores vs FP32 (TF32 off), different summation order"),
          "bound": "max(3 x FLOP / 495 TFLOP/s (TF32), bytes / 3.35 TB/s); "
          "bound_fp32_ms: FLOP / 67 TFLOP/s (FP32 CUDA cores)",
          "wirings": rows})
    return rows


def cdist_knn(src, ref, values, k=5, eps=1e-8, chunk=16384):
    """The library chain K2 is timed against: torch.cdist, torch.topk
    and a gather, chunked over the queries."""
    import torch

    vals, wds = [], []
    for s in range(0, src.shape[0], chunk):
        d, idx = torch.topk(torch.cdist(src[s:s + chunk], ref), k, dim=1,
                            largest=False)
        w = 1.0 / (d + eps)
        vals.append((values[idx] * w[..., None]).sum(1) / w.sum(1, keepdim=True))
        wds.append((d * w).sum(1, keepdim=True) / w.sum(1, keepdim=True))
    return torch.cat(vals), torch.cat(wds)


def cdist_min(src, ref, chunk=16384):
    """The library chain K3 is timed against: torch.cdist(...).amin(1),
    chunked over the queries."""
    import torch

    return torch.cat([torch.cdist(src[s:s + chunk], ref).amin(1)
                      for s in range(0, src.shape[0], chunk)])


def cdist_kth(src, ref, k=5, chunk=16384):
    """The library chain K4 is timed against: torch.cdist and the k-th
    value of torch.topk, chunked over the queries."""
    import torch

    return torch.cat([torch.topk(torch.cdist(src[s:s + chunk], ref), k, dim=1,
                                 largest=False).values[:, k - 1]
                      for s in range(0, src.shape[0], chunk)])


def differing_rows(a_vals, a_wd, b_vals, b_wd):
    """Rows that differ in any bit (a row with other neighbours has
    another blend)."""
    return ((a_vals != b_vals).any(1) | (a_wd != b_wd).any(1))


def max_err(a_vals, a_wd, b_vals, b_wd):
    return max((a_vals - b_vals).abs().max().item(),
               (a_wd - b_wd).abs().max().item())


def kth_sq_dist(src, verts, k=5, chunk=16384):
    """(N,) each query's k-th smallest squared distance, (dx*dx + dy*dy)
    + dz*dz as the kernels form it (torch.topk: for the bounds only)."""
    import torch

    out = []
    for s in range(0, src.shape[0], chunk):
        q = src[s:s + chunk]
        d = [q[:, a:a + 1] - verts[None, :, a] for a in range(3)]
        out.append(torch.topk(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], k,
                              dim=1, largest=False).values[:, k - 1])
    return torch.cat(out)


def fresh_ms(fn, verts, warmup=2, iters=10):
    """Mean device time of fn(v) by CUDA events, each call on its own copy
    v of the vertex tensor verts, as each frame brings new vertices: the
    layout a wrapper builds once per vertex tensor version is built in
    every call."""
    copies = iter([verts.clone() for _ in range(warmup + iters)])
    return cuda_ms(lambda: fn(next(copies)), warmup, iters)


def run_pairs(src, runs, m, kth2, run=32, chunk=16384):
    """(N,) per query, the vertices that K3's and K4's walk has to reach
    over `grid_layout`'s runs of `run` rows with boxes `runs` (R, 8): the
    real rows (m in all) of the runs whose box gap to the query, squared
    and summed as the kernels sum them, is at most the query's k-th
    smallest squared distance kth2. The gap bounds d2 to every vertex of
    the run, so an exact walk can skip every other run."""
    import torch

    real = torch.full((runs.shape[0],), run, device=src.device)
    real[-1] = m - run * (runs.shape[0] - 1)
    lo, hi = runs[None, :, 0:3], runs[None, :, 3:6]
    out = []
    for s in range(0, src.shape[0], chunk):
        q = src[s:s + chunk, None]
        g = torch.where(q < lo, q - lo, torch.where(q > hi, q - hi, 0.0))
        g2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
        out.append(((g2 <= kth2[s:s + chunk, None]) * real).sum(1))
    return torch.cat(out)


def band_pairs(src, verts, axis, kth2, kept=None, chunk=16384):
    """(N,) per query, the vertices an exact walk along `axis` has to
    reach: those whose square on that axis, formed as the kernels form
    it, is at most the query's k-th smallest squared distance kth2. Every
    other vertex lies farther than the k-th on that axis alone, so an
    exact reject leaves it untouched. kept(s, e), where given, is the
    (e - s, M) bool mask of the pairs a cull leaves; only those count."""
    import torch

    out = []
    for s in range(0, src.shape[0], chunk):
        e = min(s + chunk, src.shape[0])
        da = src[s:e, axis:axis + 1] - verts[None, :, axis]
        near = da * da <= kth2[s:e, None]
        if kept is not None:
            near &= kept(s, e)
        out.append(near.sum(1))
    return torch.cat(out)


def k5_band_pairs(knn, src, d5ub, blocks, axis, kth2):
    """band_pairs' total for one K5 call: the queries tiled as the call
    tiles them, each against the vertices of its tile's kept blocks."""
    order, src_p, meta, bb = knn.blocked_tiles(src, d5ub, blocks[2])
    keep = knn.blocked_cull(meta, bb)
    tile, block = knn.BLOCKED_TILE, blocks[0].shape[0] // blocks[2].shape[0]

    def kept(s, e):
        rows = keep[s // tile:-(-e // tile)].repeat_interleave(tile, dim=0)
        return rows[:e - s].repeat_interleave(block, dim=1)

    n = src.shape[0]
    return int(band_pairs(src_p[:n], blocks[0], axis, kth2[order], kept,
                          chunk=64 * tile).sum())


def knn_io_bytes(n, m, c, d5ub=False):
    """Bytes a K2 (or, with d5ub, K5) call must move: the queries (and
    their radii) and the outputs once, the vertices and their values
    once."""
    return 4 * (n * (3 + int(d5ub) + c + 1) + m * (3 + c))


def blend_ops(n, c, k=5):
    """The blend's operations: per neighbour a square root, an add and a
    divide for its weight, an add and a multiply for the weighted
    distance and per channel a multiply and an add."""
    return n * k * (2 * c + 4)


def phase_knn(knn, common, pvertices, weights):
    """K2-K6 against their plain versions on the card, with times,
    bounds and the library chains' times."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    m, c = pvertices.shape[0], weights.shape[1]
    # K2: a seeded cloud of SMPL's size with K2_DUPS exact duplicates,
    # queries around its vertices, the first ones exactly on duplicated
    # vertices, so the lowest-index tie-break decides them
    ref = torch.rand(m, 3, device="cuda", generator=gen) * torch.tensor(
        [0.8, 1.8, 0.5], device="cuda") - torch.tensor([0.4, 1.0, 0.25], device="cuda")
    ref[-K2_DUPS:] = ref[:K2_DUPS]
    pick = torch.randint(0, m, (K2_ROWS,), device="cuda", generator=gen)
    src = ref[pick] + 0.03 * torch.randn(K2_ROWS, 3, device="cuda", generator=gen)
    src[:K2_DUPS] = ref[:K2_DUPS]
    logits = torch.randn(m, c, device="cuda", generator=gen)
    values = torch.softmax(logits, dim=-1)
    got_v, got_d = knn.knn_blend(src, ref, values)
    torch.cuda.synchronize()
    ref_v, ref_d = knn.knn_blend_plain(src, ref, values)
    err2 = max_err(got_v, got_d, ref_v, ref_d)
    rows_differ = int(differing_rows(got_v, got_d, ref_v, ref_d).sum())
    times2 = timed_pair(lambda: knn.knn_blend(src, ref, values),
                        lambda: knn.knn_blend_plain(src, ref, values),
                        lambda: cdist_knn(src, ref, values))
    # the bound of the work this run's data needs: the pairs of the band
    # on the walk's axis, the blend and the bytes; PR 2's all-pairs bound
    # beside it
    pairs2 = K2_ROWS * m
    band2 = int(band_pairs(src, ref, int(knn.sweep_layout(ref)[1]),
                           kth_sq_dist(src, ref)).sum())
    b2, by2 = bound(OPS_PER_PAIR * band2 + blend_ops(K2_ROWS, c),
                    knn_io_bytes(K2_ROWS, m, c))
    b2_all, _ = bound(OPS_PER_PAIR * pairs2 + blend_ops(K2_ROWS, c),
                      knn_io_bytes(K2_ROWS, m, c))
    # the walk's work, counted by the kernel's counting build: the pairs
    # it reached (each took the one-axis test) and those that went on to
    # the full distance
    tested2, full2 = knn.knn_blend_counts(src, ref, values).tolist()
    # the same draw at a full frame's queries per launch, and the blend's
    # share: the same queries with one channel instead of C
    src_frame = src[:K2_FRAME_ROWS].contiguous()
    one_channel = values[:, :1].contiguous()
    k2 = {"name": "knn_blend", "queries": K2_ROWS, "vertices": m, "channels": c,
          "duplicate_vertices": K2_DUPS, "max_abs_err": err2,
          "rows_differing": rows_differ, **times2,
          "kernel_ms_frame_launch": cuda_ms(
              lambda: knn.knn_blend(src_frame, ref, values)),
          "frame_launch_queries": K2_FRAME_ROWS,
          "kernel_ms_one_channel": cuda_ms(
              lambda: knn.knn_blend(src, ref, one_channel)),
          "pairs": pairs2, "pairs_tested": tested2, "pairs_full": full2,
          "tested_share": tested2 / pairs2, "full_share": full2 / pairs2,
          "reject_pass_share": full2 / max(tested2, 1),
          "pairs_band": band2, "band_share": band2 / pairs2,
          "bound_ms": b2, "bound_by": by2, "bound_allpairs_ms": b2_all,
          "share_of_bound": b2 / times2["kernel_ms"],
          "library": "torch.cdist + torch.topk + gather, "
          "chunks of 16384 queries"}
    check(err2 <= KNN_TOL and rows_differ == 0,
          f"K2 differs from its plain version: {err2}, {rows_differ} rows")

    # K3 and K4 (k = 5): the 96^3 distance-grid and d5-grid builds of one
    # capsule frame
    nodes, _, _ = knn.pdist_grid_nodes(pvertices, GRID_RES)
    n3 = nodes.shape[0]
    _, runs = knn.grid_layout(pvertices)
    walk_axis = int(knn.sweep_layout(pvertices)[1])
    io3 = 4 * (n3 * 3 + m * 3 + n3)
    grid_rows = []
    for name, k, kernel, plain, library in (
            ("min_dist", 1, "min_dist_kernel", knn.min_dist_plain, cdist_min),
            ("kth_distance", 5, "kth_dist_kernel", knn.kth_distance_plain,
             cdist_kth)):
        call = getattr(knn, name)
        got = call(nodes, pvertices)
        torch.cuda.synchronize()
        want = plain(nodes, pvertices)
        err = (got - want).abs().max().item()
        differ = int((got != want).sum())
        times = timed_pair(lambda: call(nodes, pvertices),
                           lambda: plain(nodes, pvertices),
                           lambda: library(nodes, pvertices))
        # the walk's work, by the kernel's counting build
        ranked, swept, tested, full = knn.grid_dist_counts(
            nodes, pvertices, k).tolist()
        # the bound of the work these inputs need: the vertices of the runs
        # whose box lies within each query's k-th distance; beside it the
        # band of K2's walk axis within it, and all pairs (the earlier bound)
        kth2 = kth_sq_dist(nodes, pvertices, k)
        needed = int(run_pairs(nodes, runs, m, kth2).sum())
        band = int(band_pairs(nodes, pvertices, walk_axis, kth2).sum())
        b, by = bound(OPS_PER_PAIR * needed, io3)
        warps = -(-n3 // 32)
        row = {"name": name, "queries": n3, "vertices": m, "k": k,
               "max_abs_err": err, "values_differing": differ,
               **kernel_alone(times, wrapper_split(
                   lambda: call(nodes, pvertices), kernel)),
               # the whole call on a new vertex tensor: its layout is built
               # in the call, as once per frame in the engine
               "call_fresh_ms": fresh_ms(lambda v: call(nodes, v), pvertices),
               "runs": runs.shape[0], "warps": warps,
               "runs_ranked": ranked, "runs_swept": swept,
               "runs_ranked_per_warp": ranked / warps,
               "runs_swept_per_warp": swept / warps,
               "pairs_tested": tested, "pairs_full": full,
               "pairs_tested_per_query": tested / n3,
               "pairs_full_per_query": full / n3,
               "pairs_needed": needed, "pairs_needed_per_query": needed / n3,
               "pairs_band": band, "pairs": n3 * m,
               "bound_ms": b, "bound_by": by,
               "bound_band_ms": bound(OPS_PER_PAIR * band, io3)[0],
               "bound_allpairs_ms": bound(OPS_PER_PAIR * n3 * m, io3)[0],
               "library": {"min_dist": "torch.cdist(...).amin(1)",
                           "kth_distance": "torch.cdist + torch.topk (k-th "
                           "value)"}[name] + ", chunks of 16384 queries"}
        row["share_of_bound"] = b / row["kernel_ms"]
        check(err <= KNN_TOL and differ == 0,
              f"{name} differs from its plain version: {err}, {differ} values")
        grid_rows.append(row)
    k3, k4 = grid_rows

    # K5 and K6 on queries around the frame's posed vertices, against
    # their plain versions and against K2 on the same queries
    pick = torch.randint(0, m, (K2_ROWS,), device="cuda", generator=gen)
    src = pvertices[pick] + 0.03 * torch.randn(K2_ROWS, 3, device="cuda",
                                               generator=gen)
    flat_v, flat_d = knn.knn_blend(src, pvertices, weights)
    d5_packed, bounds = knn.build_d5_payload(pvertices, res=GRID_RES)
    d5ub = common.grid_d5_upper(src, {"d5_packed": d5_packed,
                                      "pdist_bounds": bounds})
    blocks = knn.build_knn_blocks(pvertices, weights)
    _, _, meta, bb = knn.blocked_tiles(src, d5ub, blocks[2])
    keep = knn.blocked_cull(meta, bb)
    tile, block = knn.BLOCKED_TILE, blocks[0].shape[0] // blocks[2].shape[0]
    kept = int(keep.sum())
    got_v, got_d = knn.knn_blend_blocked(src, d5ub, *blocks)
    torch.cuda.synchronize()
    ref_v, ref_d = knn.knn_blend_blocked_plain(src, d5ub, *blocks)
    err5 = max_err(got_v, got_d, ref_v, ref_d)
    differ5 = int(differing_rows(got_v, got_d, ref_v, ref_d).sum())
    differ5_k2 = int(differing_rows(got_v, got_d, flat_v, flat_d).sum())
    times5 = timed_pair(lambda: knn.knn_blend_blocked(src, d5ub, *blocks),
                        lambda: knn.knn_blend_blocked_plain(src, d5ub, *blocks),
                        lambda: cdist_knn(src, pvertices, weights))
    blend5, io_bytes = blend_ops(K2_ROWS, c), knn_io_bytes(K2_ROWS, m, c, True)
    # the band's pairs (on K2's walk axis) within the tiles' kept blocks;
    # the bounds of all pairs of the kept blocks (PR 3's) and of all pairs
    # beside it
    band5 = k5_band_pairs(knn, src, d5ub, blocks,
                          int(knn.sweep_layout(pvertices)[1]),
                          kth_sq_dist(src, pvertices))
    b5, by5 = bound(OPS_PER_PAIR * band5 + blend5, io_bytes)
    b5_kept, _ = bound(OPS_PER_PAIR * kept * tile * block + blend5, io_bytes)
    b_flat, _ = bound(OPS_PER_PAIR * K2_ROWS * m + blend5, io_bytes)
    # the kernel's counting build: of the kept (tile, block) pairs' query
    # pairs, those whose one-axis test ran (the rest a warp skipped by its
    # box test) and those that went on to the full distance
    tested5, full5 = knn.knn_blend_blocked_counts(src, d5ub, *blocks).tolist()
    per_tile = keep.sum(1).float()
    k5 = {"name": "knn_blend_blocked", "queries": K2_ROWS, "vertices": m,
          "channels": c, "tiles": keep.shape[0], "blocks": keep.shape[1],
          "pairs_kept": kept, "cull_keep_share": kept / keep.numel(),
          "kept_blocks_per_tile": {"mean": per_tile.mean().item(),
                                   "min": per_tile.min().item(),
                                   "max": per_tile.max().item()},
          "pairs_swept": kept * tile * block, "pairs_tested": tested5,
          "pairs_full": full5,
          "tested_share_of_swept": tested5 / (kept * tile * block),
          "full_share_of_swept": full5 / (kept * tile * block),
          "reject_pass_share": full5 / max(tested5, 1),
          "max_abs_err": err5, "rows_differing": differ5,
          "rows_differing_from_k2": differ5_k2,
          **kernel_alone(times5, wrapper_split(
              lambda: knn.knn_blend_blocked(src, d5ub, *blocks),
              "knn_blocked_kernel")),
          "pairs_band": band5, "bound_ms": b5, "bound_by": by5,
          "bound_kept_blocks_ms": b5_kept, "bound_ms_flat": b_flat,
          "library": "torch.cdist + torch.topk + gather, chunks of 16384 "
          "queries"}
    k5["share_of_bound"] = b5 / k5["kernel_ms"]
    check(err5 <= KNN_TOL and differ5 == 0,
          f"K5 differs from its plain version: {err5}, {differ5} rows")
    check(differ5_k2 == 0, f"K5 differs from K2 on {differ5_k2} rows")

    for cap in CELL_CAPS:
        payload, overflow = knn.build_cell_knn(pvertices, weights, res=CELL_RES,
                                               cap=cap, slot_cap=CELL_SLOTS)
        if not bool(overflow):
            break
    check(not bool(overflow), f"K6: the cell lists overflow every cap {CELL_CAPS}")
    # the whole build, one K3 and one K4 on the cell centres, on a new
    # vertex tensor each call, as once per frame
    cell_ms = fresh_ms(lambda v: knn.build_cell_knn(
        v, weights, res=CELL_RES, cap=cap, slot_cap=CELL_SLOTS), pvertices)
    k3["build_cell_knn_ms"] = k4["build_cell_knn_ms"] = cell_ms
    lists = [payload[key] for key in
             ("cknn_verts", "cknn_vals", "cknn_lut", "cknn_bounds")]
    got_v, got_d = knn.knn_blend_celled(src, *lists)
    torch.cuda.synchronize()
    ref_v, ref_d = knn.knn_blend_celled_plain(src, *lists)
    err6 = max_err(got_v, got_d, ref_v, ref_d)
    differ6 = int(differing_rows(got_v, got_d, ref_v, ref_d).sum())
    passing = flat_d[:, 0] < NORM_TH
    differ6_k2 = int((differing_rows(got_v, got_d, flat_v, flat_d) & passing).sum())
    below_k2 = int((got_d[~passing, 0] < flat_d[~passing, 0]).sum())
    times6 = timed_pair(lambda: knn.knn_blend_celled(src, *lists),
                        lambda: knn.knn_blend_celled_plain(src, *lists),
                        lambda: cdist_knn(src, pvertices, weights))
    # the work this run's data needs: each query against the real entries
    # of its own list (pads sit at 1e6), at least k of them; the bytes are
    # the queries, the outputs, the coordinates of the used slots' real
    # entries, and k value rows per query or the used slots' real value
    # rows, whichever is fewer
    slot = knn.cell_slots(src, lists[2], lists[3])
    list_len = (lists[0] != 1e6).any(1).sum(1)
    used = slot.unique()
    slots_used, entries_used = used.numel(), int(list_len[used].sum())
    pairs6 = int(torch.clamp(list_len[slot], min=5).sum())
    b6, by6 = bound(OPS_PER_PAIR * pairs6 + blend5,
                    4 * (K2_ROWS * (4 + c) + 3 * entries_used
                         + min(5 * K2_ROWS, entries_used) * c))
    k6 = {"name": "knn_blend_celled", "queries": K2_ROWS, "vertices": m,
          "cell_res": list(CELL_RES), "cap": cap,
          "slots": lists[0].shape[0] - 1, "slots_used": slots_used,
          "list_entries_used": entries_used, "pairs_needed": pairs6,
          "pairs_swept": K2_ROWS * cap,
          "rows_passing_filter": int(passing.sum()),
          "max_abs_err": err6, "rows_differing": differ6,
          "passing_rows_differing_from_k2": differ6_k2,
          "other_rows_wdist_below_k2": below_k2,
          **kernel_alone(times6, wrapper_split(
              lambda: knn.knn_blend_celled(src, *lists), "knn_celled_kernel")),
          "bound_ms": b6,
          "bound_by": by6, "bound_ms_flat": b_flat,
          "library": "torch.cdist + torch.topk + gather, chunks of 16384 "
          "queries"}
    check(err6 <= KNN_TOL and differ6 == 0,
          f"K6 differs from its plain version: {err6}, {differ6} rows")
    check(differ6_k2 == 0 and below_k2 == 0,
          f"K6 against K2: {differ6_k2} passing rows differ, {below_k2} other "
          "rows have a smaller wdist")
    emit({"phase": "knn_vs_plain", "tolerance": (
        "max abs err == 0 and no differing row: the kernels round every "
        "operation as the plain versions do; K5 equal to K2 on every row, "
        "K6 on every row with K2's wdist < 0.1 and no smaller wdist "
        "elsewhere"), "kernels": [k2, k3, k4, k5, k6]})
    return k2, k3, k4, k5, k6


KNN_WRAPPERS = ("knn_blend", "min_dist", "kth_distance", "knn_blend_blocked",
                "knn_blend_celled")


def launch_counts(k1, knn):
    return {"skip_mlp": k1.skip_mlp.launches,
            "skip_mlp_bf16": k1.skip_mlp.launches_bf16,
            **{name: getattr(knn, name).launches for name in KNN_WRAPPERS}}


def reset_counts(k1, knn):
    k1.skip_mlp.launches = 0
    k1.skip_mlp.launches_bf16 = 0
    for name in KNN_WRAPPERS:
        getattr(knn, name).launches = 0


# each evaluate's per-view records, by phase name (phase 14 holds its
# no-grid views to the grid views of the same call)
EVAL_ITEMS = {}


def phase_evaluate(name, cfg, jax_psnr, k1, knn):
    """run_evaluate of `cfg` on the card, each view held to the JAX
    package's PSNR; returns the kernels' launches in this run and each
    view's (candidates, survivors)."""
    from animatable_nerf_tpu_torch.engine import run_evaluate

    reset_counts(k1, knn)
    t0 = time.time()
    res = run_evaluate(cfg, "cuda")
    wall = time.time() - t0
    launches = launch_counts(k1, knn)
    items = res["items"]
    EVAL_ITEMS[name] = items
    check(len(items) == len(jax_psnr), f"{name}: expected {len(jax_psnr)} items")
    dpsnr = [it["psnr"] - ref for it, ref in zip(items, jax_psnr)]
    emit({"phase": name, "items": items, "psnr_mean": res["psnr"],
          "ssim_mean": res["ssim"], "jax_psnr": jax_psnr,
          "delta_psnr_db": dpsnr, "tol_db": PSNR_TOL_DB,
          "launches": launches, "wall_s": wall,
          "s_per_frame": [it["seconds"] for it in items]})
    check(all(abs(d) <= PSNR_TOL_DB for d in dpsnr),
          f"{name}: PSNR differs from JAX by {dpsnr} dB")
    return launches, [(it["n_candidates"], it["n_survivors"]) for it in items]


# each full frame's device profile, by phase name
FRAME_PROFILES = {}


def full_frame_item(ds, item):
    """The item's view at 1000x1002 (K scaled), with its rays and box
    near/far."""
    from animatable_nerf_tpu_torch.core.rays import get_near_far_np, get_rays_np

    item = dict(item)
    cam = int(item["cam_ind"])
    K = np.array(ds.cams["K"][cam], np.float64)
    K[:2] *= FULL_W / 128.0
    R = np.array(ds.cams["R"][cam])
    T = np.array(ds.cams["T"][cam]) / 1000.0
    ro, rd = get_rays_np(FULL_H, FULL_W, K, R, T)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    near, far, mab = get_near_far_np(item["wbounds"], ro, rd)
    item.update(ray_o=ro[mab], ray_d=rd[mab], near=near, far=far)
    return item


def phase_full_frame(name, eng, item, k1, knn, size=(FULL_H, FULL_W)):
    """One full-size frame, timed after a warm-up render, then profiled
    on the device alone (the host's events of 64 tiles took the profiler
    15-25 s a frame to aggregate); returns the kernels' launches in the
    timed render and its maps. Both the timed and the profiled render
    start without the frame's cached tensors, so they include the
    frame's upload and (SDF-PDF) its K3 grid."""
    import torch

    eng.render_item(item)  # first render: allocator warm-up
    torch.cuda.synchronize()
    eng.clear_frame_cache()
    reset_counts(k1, knn)
    t0 = time.time()
    out, n_rays = eng.render_item(item)
    frame_s = time.time() - t0
    launches = launch_counts(k1, knn)
    finite = all(bool(np.isfinite(v).all()) for v in out.values())
    acc_max = float(out["acc_map"].max())
    emit({"phase": name, "H": size[0], "W": size[1], "rays": n_rays,
          **eng.stats, "s_per_frame": frame_s,
          "rays_per_s": n_rays / frame_s, "launches": launches,
          "finite": finite, "acc_max": acc_max,
          "acc_mean": float(out["acc_map"].mean())})
    check(finite and acc_max > 0, f"{name}: frame is not finite or empty")
    eng.clear_frame_cache()
    FRAME_PROFILES[name] = device_breakdown(lambda: eng.render_item(item),
                                            host=False)
    emit({"phase": f"{name}_profile", **FRAME_PROFILES[name]})
    return launches, out


FILTER_KERNELS = ("skip_mlp", "knn_blend", "min_dist")


def phase_pdf_family(family, jax_psnr, full_item, sdf, k1, knn):
    """evaluate_<family> and full_frame_<family> (phase 7b): the same
    views and full frame as phase 6's SDF-PDF path `sdf` ({eval, eval
    counts, frame, frame stats}), held to the family's JAX PSNR, with K1,
    K2 and K3 launched as often as there and the same candidate and
    survivor counts. Returns (eval launches, full-frame launches)."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine

    cfg = load_config(f"configs/synthetic_{family}.yaml", [],
                      run_type="evaluate")
    check(cfg.network_module == family, f"{family}: config names "
          f"{cfg.network_module}")
    launches, counts = phase_evaluate(f"evaluate_{family}", cfg, jax_psnr,
                                      k1, knn)
    eng = Engine(cfg, "cuda")
    eng.load_params()
    frame_launches, _ = phase_full_frame(f"full_frame_{family}", eng,
                                         full_item, k1, knn)
    same = {"eval_launches": [launches[k] for k in FILTER_KERNELS]
            == [sdf["eval"][k] for k in FILTER_KERNELS],
            "eval_counts": counts == sdf["eval_counts"],
            "frame_launches": frame_launches == sdf["frame"],
            "frame_counts": eng.stats == sdf["frame_stats"]}
    emit({"phase": f"{family}_filter_as_sdf_pdf", **same,
          "eval_counts": counts, "frame_stats": eng.stats})
    check(all(same.values()) and launches["skip_mlp"] > 0,
          f"{family}: the point filter differs from SDF-PDF's: {same}")
    return launches, frame_launches


def kernels_on_points(knn, src, d5ub, parts, pverts, weights, blocks):
    """K2 and K5 on slices `parts` [(start, end)] of the points src (N,
    3) with their radii d5ub: each kernel's device time per launch
    (torch.profiler, mean over the parts) and the bound of the same work
    (band_pairs, the blend and the bytes), mean over the parts."""
    m, c = pverts.shape[0], weights.shape[1]
    axis = int(knn.sweep_layout(pverts)[1])
    kth2 = kth_sq_dist(src, pverts)
    band2 = band_pairs(src, pverts, axis, kth2)

    def k2():
        for s, e in parts:
            knn.knn_blend(src[s:e], pverts, weights)

    def k5():
        for s, e in parts:
            knn.knn_blend_blocked(src[s:e], d5ub[s:e], *blocks)

    out = {"launches": len(parts),
           "queries_mean": sum(e - s for s, e in parts) / len(parts)}
    for name, run, kernel in (("k2", k2, "knn_blend_kernel"),
                              ("k5", k5, "knn_blocked_kernel")):
        run()  # warm-up
        prof = device_breakdown(run)
        ms = (None if prof["kernels"] is None
              else prof["own_kernels_ms"][kernel] / len(parts))
        bounds = []
        for s, e in parts:
            n = e - s
            pairs = (int(band2[s:e].sum()) if name == "k2" else k5_band_pairs(
                knn, src[s:e], d5ub[s:e], blocks, axis, kth2[s:e]))
            bounds.append(bound(OPS_PER_PAIR * pairs + blend_ops(n, c),
                                knn_io_bytes(n, m, c, name == "k5"))[0])
        b = sum(bounds) / len(bounds)
        out[name] = {"kernel_ms": ms, "bound_ms": b,
                     "share_of_bound": None if ms is None else b / ms}
    return out


def phase_blocked_vs_flat(eng, item, flat, knn, common):
    """Render `item` once more with the blocked engine, recording pass
    2's points and radii, and hold it to the flat frame `flat`: K5 and
    K2 on those points may differ only on rows whose 6 nearest squared
    distances hold an exact tie (K5 breaks it in Morton order, K2 by
    vertex index), and the maps may differ by more than FRAME_TOL only
    on as many rays as there are such rows (one sample each)."""
    import torch

    real, recorded = common.knn_blend_blocked, []

    def recording(src, d5ub, *rest, **kwargs):
        recorded.append((src, d5ub))
        return real(src, d5ub, *rest, **kwargs)

    common.knn_blend_blocked = recording
    try:
        out, _ = eng.render_item(item)
    finally:
        common.knn_blend_blocked = real
    frame = eng._device_frame(item)
    src = torch.cat([p for p, _ in recorded])
    d5ub = torch.cat([r for _, r in recorded])
    pverts = frame["pvertices"]
    v5, w5 = knn.knn_blend_blocked(src, d5ub, frame["knn_verts"],
                                   frame["knn_values"], frame["knn_bboxes"])
    v2, w2 = knn.knn_blend(src, pverts, frame["weights"])
    # the pairs each kernel's rejects leave on the frame's own points
    n_pass2 = src.shape[0]
    tested2, full2 = knn.knn_blend_counts(src, pverts, frame["weights"]).tolist()
    tested5, full5 = knn.knn_blend_blocked_counts(
        src, d5ub, frame["knn_verts"], frame["knn_values"],
        frame["knn_bboxes"]).tolist()
    rows = differing_rows(v5, w5, v2, w2).nonzero().squeeze(1)
    # the kernels' squared distances, (dx*dx + dy*dy) + dz*dz
    q = src[rows]
    d = [q[:, a:a + 1] - pverts[None, :, a] for a in range(3)]
    top = torch.topk(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 6, dim=1,
                     largest=False).values
    tie_rows = int((top[:, 1:] == top[:, :-1]).any(1).sum())
    ray_diff = ((np.abs(out["rgb_map"] - flat["rgb_map"]).max(-1) > FRAME_TOL)
                | (np.abs(out["acc_map"] - flat["acc_map"]) > FRAME_TOL))
    result = {"phase": "full_frame_blocked_vs_flat", "pass2_rows": src.shape[0],
              "rows_differing_from_k2": rows.numel(), "tie_rows": tie_rows,
              "rays_over_tol": int(ray_diff.sum()),
              "max_abs_diff": {key: float(np.abs(out[key] - flat[key]).max())
                               for key in ("rgb_map", "acc_map")},
              "d5ub_below_exact": int((d5ub < knn.kth_distance(src, pverts)).sum()),
              "k2_pairs_per_point": {"tested": tested2 / n_pass2,
                                     "full": full2 / n_pass2},
              # K2 on these points as the engine calls it, one launch per
              # tile, and in one launch: the difference is the launches'
              # tails
              "k2_tile_launches_ms": cuda_ms(
                  lambda: [knn.knn_blend(p, pverts, frame["weights"])
                           for p, _ in recorded], iters=3),
              "k2_one_launch_ms": cuda_ms(
                  lambda: knn.knn_blend(src, pverts, frame["weights"]), iters=3),
              "k5_pairs_per_point": {"tested": tested5 / n_pass2,
                                     "full": full5 / n_pass2},
              "tol": FRAME_TOL, "tie_distances": top[:4].tolist()}
    # K2 and K5 on these points: per launch as the engine makes them, one
    # per tile, and at the kernel table's K2_ROWS queries a launch (the
    # whole slices of K2_ROWS consecutive points)
    ends = np.cumsum([p.shape[0] for p, _ in recorded]).tolist()
    blocks = (frame["knn_verts"], frame["knn_values"], frame["knn_bboxes"])
    result["frame_points"] = {
        "tile_launches": kernels_on_points(
            knn, src, d5ub, list(zip([0] + ends[:-1], ends)), pverts,
            frame["weights"], blocks),
        f"launches_of_{K2_ROWS}": kernels_on_points(
            knn, src, d5ub, [(s, s + K2_ROWS) for s in
                             range(0, n_pass2 - K2_ROWS + 1, K2_ROWS)],
            pverts, frame["weights"], blocks)}
    emit(result)
    check(tie_rows == rows.numel() and result["rays_over_tol"] <= rows.numel()
          and result["d5ub_below_exact"] == 0,
          f"the blocked full frame differs from the flat one: {result}")
    return result["frame_points"]


def phase_k1_grad(k1):
    """K1 with a gradient on the card, at one train step's rows and the
    three wirings: the output and the gradients of x, W and b against
    autograd through the plain version, and the times of the forward
    (the kernel), of the backward (the plain vjp) and of the plain
    forward and backward."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, din, dims, skips, act_last in k1_wirings():
        x = (torch.rand(TRAIN_ROWS, din, device="cuda", generator=gen) * 2
             - 1).requires_grad_()
        layers = [
            ((torch.randn(i, o, device="cuda", generator=gen)
              / math.sqrt(i)).requires_grad_(),
             (torch.randn(o, device="cuda", generator=gen) * 0.1).requires_grad_())
            for i, o in dims
        ]
        leaves = [x] + [t for wb in layers for t in wb]
        g = torch.randn(TRAIN_ROWS, dims[-1][1], device="cuda", generator=gen)
        kwargs = dict(skips=skips, act="relu", act_last=act_last)

        def grads(fn):
            out = fn(x, layers, **kwargs)
            return [out.detach()] + list(torch.autograd.grad(out, leaves, g))

        before = k1.skip_mlp.launches
        got = grads(k1.skip_mlp)
        torch.cuda.synchronize()
        check(k1.skip_mlp.launches == before + 1,
              f"K1 grad {name}: the forward did not launch the kernel")
        want = grads(k1.skip_mlp_plain)
        errs = []
        for a, b in zip(got, want):
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            errs.append(err / max(scale, 1e-30))
            check(math.isfinite(err) and err <= K1_REL_TOL * max(scale, 1e-30),
                  f"K1 grad {name}: max abs err {err} vs scale {scale}")
        packed = k1.pack_layers([(w.detach(), b.detach()) for w, b in layers],
                                skips)
        out = k1.skip_mlp(x, layers, packed=packed, **kwargs)
        rows.append({
            "wiring": name, "rows": TRAIN_ROWS,
            "max_rel_err": {"out": errs[0], "x": errs[1],
                            "weights": max(errs[2:])},
            "forward_ms": cuda_ms(lambda: k1.skip_mlp(
                x, layers, packed=packed, **kwargs)),
            "backward_ms": cuda_ms(lambda: torch.autograd.grad(
                out, leaves, g, retain_graph=True)),
            "plain_forward_backward_ms": cuda_ms(
                lambda: grads(k1.skip_mlp_plain), iters=5),
        })
    emit({"phase": "k1_grad_vs_plain", "tolerance": (
        f"max abs err <= {K1_REL_TOL} x max |plain| for the output and "
        "each gradient (x, every W and b)"), "wirings": rows})
    return rows


def train_step_grads(trainer, batch):
    """(loss, stats, {name: grad on the CPU}) of one train step's loss,
    for the parameters that received a gradient."""
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, stats, _ = trainer.loss({k: v[0] for k, v in batch.items()})
    loss.backward()
    return (float(loss.detach()), {k: float(v.detach()) for k, v in stats.items()},
            {n: p.grad.detach().cpu() for n, p in
             trainer.model.named_parameters() if p.grad is not None})


# the card's launches of each phase_train_step_vs_cpu step, by phase name
STEP_LAUNCHES = {}


def phase_train_step_vs_cpu(name, cfg, state_dict, batch, k1, knn, expect,
                            trainer_cls=None, whole_gradient=False,
                            loss_rtol=TRAIN_LOSS_RTOL, return_cpu=False,
                            grad_rel=TRAIN_GRAD_REL):
    """One train step's loss and gradients on the card against the same
    step with the port on this machine's CPU (the plain versions), from
    the same weights and batch, with each stat's difference reported;
    `expect` the kernels' launches on the card (none on the CPU).
    `trainer_cls` defaults to the stage-1 Trainer. The gradient is held
    leaf by leaf (each within `grad_rel` of its largest entry), or with
    `whole_gradient` as one vector (its relative L2 error within
    `grad_rel`; the leaf errors reported); the loss within `loss_rtol`.
    The card's launches go to STEP_LAUNCHES[name]. Returns the names of
    the parameters that received a gradient (the same on both), and with
    `return_cpu` also the CPU step's (loss, stats, gradients)."""
    from animatable_nerf_tpu_torch.engine import make_model
    from animatable_nerf_tpu_torch.train.trainer import Trainer

    results = {}
    for device in ("cpu", "cuda"):
        model = make_model(cfg)
        model.load_state_dict(state_dict)
        trainer = (trainer_cls or Trainer)(cfg, model.to(device), device)
        before = launch_counts(k1, knn)
        t0 = time.time()
        loss, stats, grads = train_step_grads(trainer, batch)
        after = launch_counts(k1, knn)
        results[device] = (loss, stats, grads,
                           {k: after[k] - before[k] for k in after},
                           time.time() - t0)
    (cpu_loss, cpu_s, cpu_g, cpu_n, cpu_t), (gpu_loss, gpu_s, gpu_g, gpu_n,
                                             gpu_t) = (results["cpu"],
                                                       results["cuda"])
    check(set(gpu_g) == set(cpu_g), f"{name}: gradients of {sorted(gpu_g)} "
          f"on the card, of {sorted(cpu_g)} on the CPU")
    rel = {n: (gpu_g[n] - g).abs().max().item()
           / max(g.abs().max().item(), 1e-30) for n, g in cpu_g.items()}
    worst = max(rel, key=rel.get)
    rel_l2 = math.sqrt(
        sum(float(((gpu_g[n] - g).double() ** 2).sum()) for n, g in cpu_g.items())
        / sum(float((g.double() ** 2).sum()) for g in cpu_g.values()))
    stats_rel = {k: abs(gpu_s[k] / v - 1) if v else abs(gpu_s[k])
                 for k, v in cpu_s.items()}
    emit({"phase": name, "rays": int(cfg.N_rand),
          "samples": int(cfg.N_samples), "loss_cuda": gpu_loss,
          "loss_cpu": cpu_loss, "loss_rel_err": abs(gpu_loss / cpu_loss - 1),
          "stats_cuda": gpu_s, "stats_rel_err": stats_rel,
          "grad_max_rel_err": rel[worst], "grad_worst_leaf": worst,
          "grad_rel_l2": rel_l2, "grad_leaves": len(cpu_g),
          "launches": {"cuda": gpu_n, "cpu": cpu_n},
          "first_step_s": {"cuda": gpu_t, "cpu": cpu_t},
          "tolerance": f"loss rtol {loss_rtol} (the stats reported); "
          + (f"the whole gradient's |d| <= {grad_rel} x |g| (L2, CPU)"
             if whole_gradient else
             f"each gradient leaf max |d| <= {grad_rel} x its max |g| "
             "(CPU)")})
    STEP_LAUNCHES[name] = gpu_n
    want = {k: expect.get(k, 0) for k in gpu_n}
    check(all(v == 0 for v in cpu_n.values()) and gpu_n == want,
          f"{name}: launches {cpu_n} on the CPU, {gpu_n} on the card "
          f"(expected {want})")
    check(stats_rel["loss"] <= loss_rtol,
          f"{name}: loss {gpu_loss} on the card vs {cpu_loss} on the CPU")
    check(all(bool(g.isfinite().all()) for g in gpu_g.values()),
          f"{name}: the gradient is not finite")
    if whole_gradient:
        check(rel_l2 <= grad_rel,
              f"{name}: the gradient differs by {rel_l2} of its L2 norm")
    else:
        check(rel[worst] <= grad_rel,
              f"{name}: gradient {worst}: {rel[worst]} of its scale")
    if return_cpu:
        return set(cpu_g), (cpu_loss, cpu_s, cpu_g)
    return set(cpu_g)


def repack_ms(model, dtype=None, iters=10):
    """K1's per-step weight repack of AniNeRF's two trunks in the form
    `dtype` (float32 by default, or bf16: the cast, the padding and the
    swizzle): after their parameters get a new version (an in-place add
    of 0, as an optimizer step makes one), the time of packing them anew
    (fields/mlp.py packed_layers), by CUDA events around the packing
    alone; mean ms per step."""
    import torch

    dtype = dtype or torch.float32
    from animatable_nerf_tpu_torch.fields.mlp import packed_layers

    trunks = [(model, [*model.bw_linears, model.bw_fc], 191),
              (model.tpose_human, model.tpose_human.pts_linears, 63)]
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        with torch.no_grad():
            for _, linears, _ in trunks:
                for lin in linears:
                    lin.weight.add_(0.0)
                    lin.bias.add_(0.0)
        start.record()
        for owner, linears, din in trunks:
            packed_layers(owner, linears, (4,), din, dtype)
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def step_parts_ms(trainer, batch, steps=5):
    """Mean device-clock ms per train step of its forward (render and
    loss), backward, and update, by CUDA events around each part."""
    import torch

    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(steps)]
    for e in ev:
        trainer.optimizer.zero_grad(set_to_none=True)
        e[0].record()
        loss, _, _ = trainer.loss({k: v[0] for k, v in batch.items()})
        e[1].record()
        loss.backward()
        e[2].record()
        trainer.apply_gradients()
        e[3].record()
    torch.cuda.synchronize()
    parts = [sum(e[i].elapsed_time(e[i + 1]) for e in ev) / steps
             for i in range(3)]
    return dict(zip(("forward_ms", "backward_ms", "update_ms"), parts))


def train_and_evaluate(cfg_file, opts, exp, jax_psnr, k1, knn):
    """`run_train` of `cfg_file` with `opts` on the card from a fresh
    start on the config's tracked weights (`write_fresh_start`), its
    kernels' launches counted from 0, then the port's evaluate of the
    checkpoint it wrote, each view against the JAX package's PSNR for
    the same run on the CPU. Returns (cfg, trainer, recorder, launches,
    wall s, evaluate items, dPSNR)."""
    import torch

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import run_evaluate, run_train
    from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start

    cfg = load_config(cfg_file, opts)
    src = os.path.join("data/trained_model", cfg.task,
                       load_config(cfg_file, []).exp_name, "latest.flax")
    write_fresh_start(src, cfg.trained_model_dir)
    reset_counts(k1, knn)
    t0 = time.time()
    trainer, recorder = run_train(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts(k1, knn)
    res = run_evaluate(load_config(cfg_file, ["exp_name", exp],
                                   run_type="evaluate"), "cuda")
    items = res["items"]
    dpsnr = [it["psnr"] - ref for it, ref in zip(items, jax_psnr)]
    return cfg, trainer, recorder, launches, wall, items, dpsnr


def train_summary(cfg, trainer, recorder, launches, wall, items, dpsnr,
                  jax_psnr):
    """The train phases' common record."""
    import torch

    return {"steps": trainer.step, "rays_per_step": int(cfg.N_rand),
            "samples_per_ray": int(cfg.N_samples), "wall_s": wall,
            "s_per_step_mean": recorder.batch_time.global_avg,
            "s_per_step_median_last20": recorder.batch_time.median,
            "rays_per_s": int(cfg.N_rand) / recorder.batch_time.median,
            "data_s_per_step_mean": recorder.data_time.global_avg,
            "loss_medians_last20": {k: v.median for k, v in
                                    recorder.scalars.items()
                                    if k.endswith("loss")},
            "params_finite": all(bool(torch.isfinite(p).all())
                                 for p in trainer.model.parameters()),
            "launches": launches, "eval_items": items, "jax_psnr": jax_psnr,
            "delta_psnr_db": dpsnr, "tol_db": PSNR_TOL_DB}


def check_train(name, summary, per_step):
    """A train phase's checks: 50 steps, each kernel launched `per_step`
    times a step (the others never), finite weights and losses, and each
    view within PSNR_TOL_DB of the JAX PSNR."""
    steps, launches = summary["steps"], summary["launches"]
    check(steps == 50 and launches == {
        k: per_step.get(k, 0) * steps for k in launches},
          f"{name}: {steps} steps launched {launches}")
    losses = summary["loss_medians_last20"]
    check(summary["params_finite"]
          and all(math.isfinite(v) for v in losses.values()),
          f"{name}: the loss or the weights are not finite ({losses})")
    dpsnr = summary["delta_psnr_db"]
    check(len(summary["eval_items"]) == len(summary["jax_psnr"])
          and all(abs(d) <= PSNR_TOL_DB for d in dpsnr),
          f"{name}: PSNR of the trained weights differs from JAX by {dpsnr} dB")


def steps_profile(trainer, batch, kernels, n=5):
    """A profile of `n` train steps on the trained model after one more
    step: per step the wall, device ms and idle share, each of
    `kernels` (the port's kernel names) ms and share, the top kernels."""
    def steps():
        for _ in range(n):
            trainer.train_step(batch)

    steps()
    prof = device_breakdown(steps, top=10)
    out = {"steps": n, "wall_ms": prof["wall_ms"] / n,
           "device_ms": None if prof["device_ms"] is None
           else prof["device_ms"] / n, "idle_share": prof["idle_share"]}
    for kernel in kernels:
        ms = (None if prof["kernels"] is None
              else prof["own_kernels_ms"][kernel] / n)
        out[f"{kernel}_ms"] = ms
        out[f"{kernel}_share"] = (None if ms is None
                                  else ms / out["device_ms"])
    out["kernels"] = None if prof["kernels"] is None else [
        dict(k, ms=k["ms"] / n) for k in prof["kernels"]]
    return out


def phase_train(k1, knn):
    """The training path of AniNeRF: one step on the card against the
    CPU, one epoch of run_train, the evaluate of its checkpoint against
    the JAX PSNR, and a profile of train steps. Returns the kernels'
    launches in the run."""
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.compat.jax_params import aninerf_state_dict
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_dataset
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    ckpt = "data/trained_model/deform/synthetic/latest.flax"
    cfg = load_config("configs/synthetic.yaml", TRAIN_OPTS)
    state_dict = aninerf_state_dict(read_checkpoint(ckpt)["params"])
    ds = make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = stack_batch([collate_rays(ds[0], int(cfg.N_rand))])
    phase_train_step_vs_cpu("train_step_vs_cpu", cfg, state_dict, batch, k1,
                            knn, {"skip_mlp": 3})

    run = train_and_evaluate("configs/synthetic.yaml", TRAIN_OPTS, TRAIN_EXP,
                             JAX_PSNR_TRAIN, k1, knn)
    cfg, trainer, _, launches, _, _, _ = run
    summary = train_summary(*run, JAX_PSNR_TRAIN)
    steps = trainer.step
    # the steady state, on the trained model: a profile of 5 steps, the
    # parts of a step by events, and the repack alone
    prof = steps_profile(trainer, batch, ["skip_mlp_kernel"])
    prof["k1_ms"], prof["k1_share"] = (prof.pop("skip_mlp_kernel_ms"),
                                       prof.pop("skip_mlp_kernel_share"))
    emit({"phase": "train", "config": "configs/synthetic.yaml",
          "opts": TRAIN_OPTS, **summary,
          "k1_launches_per_step": launches["skip_mlp"] / steps,
          "profile_per_step": prof,
          "events_per_step": step_parts_ms(trainer, batch),
          "repack_ms": repack_ms(trainer.model)})
    check_train("train", summary, {"skip_mlp": 3})
    return launches


def phase_k1_second_derivative(k1):
    """K1's gradient of a gradient on the card, at one train step's rows
    of the displacement field's wiring: a loss on d(u . y)/dx
    differentiated again with respect to x and every layer, against
    autograd-of-autograd through the plain version; with its times."""
    import torch

    _, din, dims, skips, _ = k1_wirings()[2]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.rand(TRAIN_ROWS, din, device="cuda", generator=gen) * 2
         - 1).requires_grad_()
    layers = [((torch.randn(i, o, device="cuda", generator=gen)
                / math.sqrt(i)).requires_grad_(),
               (torch.randn(o, device="cuda", generator=gen) * 0.1).requires_grad_())
              for i, o in dims]
    leaves = [x] + [t for wb in layers for t in wb]
    u = torch.randn(TRAIN_ROWS, dims[-1][1], device="cuda", generator=gen)

    def second(fn):
        y = fn(x, layers, skips=skips, act="relu")
        (g,) = torch.autograd.grad((y * u).sum(), x, create_graph=True)
        d2 = torch.autograd.grad((g * g).sum(), leaves, allow_unused=True)
        return [g.detach()] + [torch.zeros_like(t) if d is None else d
                               for d, t in zip(d2, leaves)]

    before = k1.skip_mlp.launches
    got = second(k1.skip_mlp)
    torch.cuda.synchronize()
    check(k1.skip_mlp.launches == before + 1,
          "K1 second derivative: the forward did not launch the kernel")
    want = second(k1.skip_mlp_plain)
    errs = []
    for a, b in zip(got, want):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        errs.append(err / max(scale, 1e-30))
        check(math.isfinite(err) and err <= K1_REL_TOL * max(scale, 1e-30),
              f"K1 second derivative: max abs err {err} vs scale {scale}")

    def forward():
        with torch.no_grad():
            k1.skip_mlp(x, layers, skips=skips, act="relu")

    def recompute_vjp(wanted):
        # what SkipMLPFunction.backward runs: the plain forward and its
        # vjp with a graph, here for x alone or for x and every layer
        y = k1.skip_mlp_plain(x, layers, skips=skips, act="relu")
        return torch.autograd.grad(y, wanted, u, create_graph=True)

    row = {"wiring": "resd_field", "rows": TRAIN_ROWS,
           "max_rel_err": {"dy_dx": errs[0], "x": errs[1],
                           "weights": max(errs[2:])},
           "ms": cuda_ms(lambda: second(k1.skip_mlp), iters=5),
           "plain_ms": cuda_ms(lambda: second(k1.skip_mlp_plain), iters=5),
           # the split of ms - plain_ms: the kernel's forward, and the
           # weight gradients the backward builds for every layer (the
           # difference of the two recompute_vjp times), which a
           # gradient with respect to x alone then discards
           "split_ms": {
               "kernel_forward": cuda_ms(forward, iters=5),
               "recompute_vjp_x": cuda_ms(lambda: recompute_vjp([x]), iters=5),
               "recompute_vjp_all": cuda_ms(lambda: recompute_vjp(leaves),
                                            iters=5)}}
    emit({"phase": "k1_second_derivative_vs_plain", "tolerance": (
        f"max abs err <= {K1_REL_TOL} x max |plain| for d(u.y)/dx and the "
        "gradient of |d(u.y)/dx|^2 with respect to x, every W and b"),
          **row})
    return row


def k2_on_train_points(knn, trainer, batch):
    """K2 on the points of one SDF-PDF train step (its one launch a step,
    recorded from the model's call): the kernel's time, its plain
    version's and the cdist chain's, the bound of the work this data
    needs (band_pairs, the blend, the bytes), and its walk's pairs
    counted by the counting build."""
    from animatable_nerf_tpu_torch.models import pdf

    real, recorded = pdf.sample_blend_closest_points, []

    def recording(src, ref, values, *args, **kwargs):
        recorded.append((src, ref, values))
        return real(src, ref, values, *args, **kwargs)

    pdf.sample_blend_closest_points = recording
    try:
        trainer.loss({k: v[0] for k, v in batch.items()})
    finally:
        pdf.sample_blend_closest_points = real
    check(len(recorded) == 1, f"an SDF-PDF step made {len(recorded)} KNN calls")
    src, ref, values = (t.contiguous() for t in recorded[0])
    n, m, c = src.shape[0], ref.shape[0], values.shape[1]
    times = timed_pair(lambda: knn.knn_blend(src, ref, values),
                       lambda: knn.knn_blend_plain(src, ref, values),
                       lambda: cdist_knn(src, ref, values))
    kth2 = kth_sq_dist(src, ref)
    band = int(band_pairs(src, ref, int(knn.sweep_layout(ref)[1]), kth2).sum())
    b, by = bound(OPS_PER_PAIR * band + blend_ops(n, c), knn_io_bytes(n, m, c))
    tested, full = knn.knn_blend_counts(src, ref, values).tolist()
    got_v, got_d = knn.knn_blend(src, ref, values)
    want_v, want_d = knn.knn_blend_plain(src, ref, values)
    err = max_err(got_v, got_d, want_v, want_d)
    check(err <= KNN_TOL, f"K2 on the train points differs from its plain "
          f"version by {err}")
    return {"queries": n, "max_abs_err": err, **times,
            "pairs": n * m, "pairs_band": band,
            "pairs_band_per_query": band / n, "pairs_tested": tested,
            "pairs_full": full, "pairs_tested_per_query": tested / n,
            "filter_pass_share": float((got_d[:-1, 0] < NORM_TH).float().mean()),
            "bound_ms": b, "bound_by": by,
            "share_of_bound": b / times["kernel_ms"],
            "library": "torch.cdist + torch.topk + gather, chunks of 16384 "
            "queries"}


def phase_train_sdf_pdf(k1, knn):
    """The training path of SDF-PDF: K1's gradient of a gradient, one
    step on the card against the CPU, one epoch of run_train (K1 twice
    and K2 once a step), the evaluate of its checkpoint against the JAX
    PSNR, a profile of train steps and K2 on one step's dense points.
    Returns (the kernels' launches in the run, K2's row on the points)."""
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.compat.jax_params import sdf_pdf_state_dict
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_dataset
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    second = phase_k1_second_derivative(k1)
    ckpt = "data/trained_model/deform/synthetic_sdf_pdf/latest.flax"
    cfg = load_config(TRAIN_SDF_CFG, TRAIN_SDF_OPTS)
    state_dict = sdf_pdf_state_dict(read_checkpoint(ckpt)["params"])
    ds = make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = stack_batch([collate_rays(ds[0], int(cfg.N_rand))])
    per_step = {"skip_mlp": 2, "knn_blend": 1}
    phase_train_step_vs_cpu("train_sdf_pdf_step_vs_cpu", cfg, state_dict,
                            batch, k1, knn, per_step)

    run = train_and_evaluate(TRAIN_SDF_CFG, TRAIN_SDF_OPTS, TRAIN_SDF_EXP,
                             JAX_PSNR_TRAIN_SDF, k1, knn)
    cfg, trainer, _, launches, _, _, _ = run
    summary = train_summary(*run, JAX_PSNR_TRAIN_SDF)
    steps = trainer.step
    prof = steps_profile(trainer, batch, ["skip_mlp_kernel",
                                          "knn_blend_kernel"])
    k2_points = k2_on_train_points(knn, trainer, batch)
    emit({"phase": "train_sdf_pdf", "config": TRAIN_SDF_CFG,
          "opts": TRAIN_SDF_OPTS, **summary,
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "profile_per_step": prof,
          "events_per_step": step_parts_ms(trainer, batch),
          "k2_train_points": k2_points,
          "k1_second_derivative_ms": second["ms"],
          "k1_second_derivative_split_ms": second["split_ms"]})
    check_train("train_sdf_pdf", summary, per_step)
    return launches, k2_points


def phase_train_pdf_family(family, jax_psnr, per_step, k1, knn):
    """The training path of NeRF-PDF or NeuS-PDF (SDF-PDF's dense path
    with the family's head): one step on the card against the CPU, one
    epoch of run_train with `per_step` launches a step, the evaluate of
    its checkpoint against the JAX PSNR, and a profile of train steps.
    Returns the kernels' launches in the run."""
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_dataset, make_model
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    cfg_file = f"configs/synthetic_{family}.yaml"
    exp = f"chip_smoke_train_{family}"
    opts = ["exp_name", exp] + TRAIN_OPTS[2:]
    cfg = load_config(cfg_file, opts)
    state_dict = param_codec(make_model(cfg))[0](read_checkpoint(
        f"data/trained_model/deform/synthetic_{family}/latest.flax")["params"])
    ds = make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = stack_batch([collate_rays(ds[0], int(cfg.N_rand))])
    phase_train_step_vs_cpu(f"train_{family}_step_vs_cpu", cfg, state_dict,
                            batch, k1, knn, per_step)

    run = train_and_evaluate(cfg_file, opts, exp, jax_psnr, k1, knn)
    cfg, trainer, _, launches, _, _, _ = run
    summary = train_summary(*run, jax_psnr)
    steps = trainer.step
    prof = steps_profile(trainer, batch, ["skip_mlp_kernel",
                                          "knn_blend_kernel"])
    emit({"phase": f"train_{family}", "config": cfg_file, "opts": opts,
          **summary,
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "profile_per_step": prof,
          "events_per_step": step_parts_ms(trainer, batch)})
    check_train(f"train_{family}", summary, per_step)
    return launches


class fixed_box_points:
    """Within the block, stage 2's `uniform_box_points` returns seeded
    points: the k-th call takes the (k mod 2)-th of two unit draws,
    scaled into its bounds on their device, so a step on the CPU and the
    same step on the card see the same points."""

    def __init__(self, n, seed=0):
        self.units = np.random.RandomState(seed).rand(2, n, 3).astype(
            np.float32)
        self.calls = 0

    def __call__(self, generator, bounds, n):
        import torch

        u = torch.as_tensor(self.units[self.calls % 2], device=bounds.device)
        self.calls += 1
        return bounds[0] + (bounds[1] - bounds[0]) * u

    def __enter__(self):
        from animatable_nerf_tpu_torch.train import animation

        self.real = animation.uniform_box_points
        animation.uniform_box_points = self
        return self

    def __exit__(self, *exc):
        from animatable_nerf_tpu_torch.train import animation

        animation.uniform_box_points = self.real


def flat_leaves(tree, prefix=""):
    """{path: array} of a nested dict of arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat_leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def phase_novel_pose(k1, knn):
    """Phase 11a: the novel-pose evaluate of the tracked stage-2
    checkpoint (frames 2-3, view 3) held to the JAX PSNR, then frame 2 at
    1000x1002 timed and profiled. Returns (eval launches, frame
    launches)."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset

    cfg = load_config(NOVEL_POSE_CFG, ["test_novel_pose", "True", "exp_name",
                                       "synthetic_2f_anim"],
                      run_type="evaluate")
    launches, _ = phase_evaluate("evaluate_novel_pose", cfg,
                                 JAX_PSNR_NOVEL_POSE, k1, knn)
    check(launches["skip_mlp"] > 0
          and all(launches[k] == 0 for k in KNN_WRAPPERS),
          f"evaluate_novel_pose launched {launches}")
    cfg.eval = True
    ds = make_dataset(cfg, "test")
    eng = Engine(cfg, "cuda")
    eng.load_params()
    item = ds[0]
    check(int(item["frame_index"]) == 2 and eng.novel_pose,
          "full_frame_novel_pose: not the novel-pose frame 2")
    frame_launches, _ = phase_full_frame("full_frame_novel_pose", eng,
                                         full_frame_item(ds, item), k1, knn)
    check(frame_launches["skip_mlp"] == 2 * eng.stats["tiles"],
          f"full_frame_novel_pose: K1 launched {frame_launches['skip_mlp']} "
          f"times over {eng.stats['tiles']} tiles")
    return launches, frame_launches


def phase_train_animation(k1, knn):
    """Phase 11b: AniNeRF stage 2. K1 against its plain version at a
    step's 65,536 rows of the two wirings stage 2 adds (the blend-weight
    fields, the density trunk); one stage-2 step on the card against the
    CPU on the same points (K1 six times on the card, a gradient for
    `novel_pose_bw` alone); `run_train` for 50 steps from the common
    start `write_initial_start` writes, every frozen leaf bit-identical
    to the start after them; the novel-pose evaluate of the checkpoint
    written, each view held to the JAX CPU run of the same 50 steps; and
    a profile of steps. Returns (the kernels' launches in the run, K1's
    rows at the step's shape)."""
    import torch

    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.compat.jax_params import aninerf_state_dict
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import (
        make_dataset, run_evaluate, run_train, write_initial_start)
    from animatable_nerf_tpu_torch.ops import skip_mlp as ops_k1
    from animatable_nerf_tpu_torch.train.animation import AnimationTrainer
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    k1_rows = phase_k1(ops_k1.skip_mlp, ops_k1.skip_mlp_plain,
                       ops_k1.pack_layers, n_rows=ANIM_ROWS,
                       wirings=("bw_field", "tpose_trunk"),
                       phase="k1_vs_plain_stage2")
    cfg = load_config(NOVEL_POSE_CFG, ANIM_OPTS)
    check(int(cfg.n_anim_samples) == ANIM_ROWS,
          f"n_anim_samples is {cfg.n_anim_samples}")
    per_step = {"skip_mlp": 6}
    start_dir = cfg.trained_model_dir
    write_initial_start(cfg)
    start = read_checkpoint(os.path.join(start_dir, "latest.flax"))["params"]
    ds = make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = stack_batch([collate_rays(ds[0], int(cfg.N_rand))])
    with fixed_box_points(ANIM_ROWS):
        trained = phase_train_step_vs_cpu(
            "train_animation_step_vs_cpu", cfg, aninerf_state_dict(start),
            batch, k1, knn, per_step, trainer_cls=AnimationTrainer)
    check(len(trained) == 19
          and all(n.startswith("novel_pose_bw.") for n in trained),
          f"train_animation_step_vs_cpu: gradients of {sorted(trained)}")

    reset_counts(k1, knn)
    t0 = time.time()
    trainer, recorder = run_train(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts(k1, knn)
    res = run_evaluate(load_config(NOVEL_POSE_CFG, [
        "test_novel_pose", "True", "exp_name", ANIM_EXP],
        run_type="evaluate"), "cuda")
    items = res["items"]
    dpsnr = [it["psnr"] - ref for it, ref in
             zip(items, JAX_PSNR_TRAIN_ANIMATION)]
    summary = train_summary(cfg, trainer, recorder, launches, wall, items,
                            dpsnr, JAX_PSNR_TRAIN_ANIMATION)
    after = flat_leaves(param_codec(trainer.model)[1](
        dict(trainer.model.named_parameters())))
    before = flat_leaves(start)
    frozen = [k for k in before if "/novel_pose_bw/" not in k]
    moved = [k for k in frozen if not np.array_equal(after[k], before[k])]
    trained_moved = sum(not np.array_equal(after[k], before[k])
                        for k in before if "/novel_pose_bw/" in k)
    samples = 2 * ANIM_ROWS
    steps = trainer.step
    prof = steps_profile(trainer, batch, ["skip_mlp_kernel"])
    prof["k1_ms"], prof["k1_share"] = (prof.pop("skip_mlp_kernel_ms"),
                                       prof.pop("skip_mlp_kernel_share"))
    emit({"phase": "train_animation", "config": NOVEL_POSE_CFG,
          "opts": ANIM_OPTS, **summary, "samples_per_step": samples,
          "samples_per_s": samples / recorder.batch_time.median,
          "frozen_leaves": len(frozen), "frozen_leaves_changed": moved,
          "trained_leaves_changed": trained_moved,
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "profile_per_step": prof,
          "events_per_step": step_parts_ms(trainer, batch)})
    check(not moved and len(frozen) == 46 and trained_moved == 19,
          f"train_animation: frozen leaves changed: {moved}; "
          f"{trained_moved} trained leaves moved")
    check_train("train_animation", summary, per_step)
    return launches, k1_rows


# Phase 12: real cameras. A distorted copy of each synthetic root
# (animatable_nerf_tpu_torch/data/distorted_copy.py: D on every camera,
# masks at half size) read at ratio 0.5. Per-view PSNR of the JAX package
# on those copies (AniNeRF: configs/synthetic_novel_pose.yaml, frames 0-1,
# view 3, the tracked synthetic_2f weights; SDF-PDF and NeRF-PDF: their
# capsule configs and tracked weights, frames 0-3, view 3), computed on
# the CPU with (<s> is human, then capsule):
#   python -c "import cv2; from animatable_nerf_tpu_torch.data.distorted_copy import write_distorted_copy as w; w('data/synthetic/<s>', '/tmp/camera_<s>', png_writer=cv2.imwrite)"
#   C="ratio 0.5 train_dataset.data_root /tmp/camera_<s> train_dataset.ann_file /tmp/camera_<s>/annots.npy test_dataset.data_root /tmp/camera_<s> test_dataset.ann_file /tmp/camera_<s>/annots.npy"
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_novel_pose.yaml $C   (<s> human)
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_2f/metrics.npy', allow_pickle=True).item()['psnr'])"
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_sdf_pdf.yaml $C   (<s> capsule)
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_sdf_pdf/metrics.npy', allow_pickle=True).item()['psnr'])"
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_nerf_pdf.yaml $C   (<s> capsule)
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_nerf_pdf/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_CAMERA = [18.65603642156197, 19.535369097660737]
JAX_PSNR_CAMERA_SDF = [19.942105998951888, 22.39381451723806,
                       24.105636621160542, 25.443771371443116]
JAX_PSNR_CAMERA_NERF_PDF = [19.498852072780856, 22.107296194588073,
                            22.606178859594813, 23.62379479264389]
CAMERA_TRAIN_EXP = "chip_smoke_train_camera"
CAMERA_TRAIN_STEPS = 20
CAMERA_UPSAMPLE = 8  # the 128x128 copy at 1024x1024, ZJU-MoCap's frame


def load_image_ms(ds, index):
    """Host ms of `ds.load_image(index)` and of the whole item, cold (the
    item's undistort map, which the image and both masks share, built in
    the call) and warm (the map cached); and each of its steps alone,
    warm unless named: reading the image and the masks, the masks'
    resize to the image, the map's build (cold), the undistort of the
    image and of one mask, and the resize by `ratio` of the image
    (INTER_AREA) and of one mask (INTER_NEAREST)."""
    from animatable_nerf_tpu_torch.data import camera

    def ms(f):
        t0 = time.perf_counter()
        out = f()
        return (time.perf_counter() - t0) * 1e3, out

    out = {}
    for state in ("cold", "warm"):
        if state == "cold":
            camera._cached_map.cache_clear()
        t, (img, *_) = ms(lambda: ds.load_image(index))
        if state == "cold":
            camera._cached_map.cache_clear()
        out[state] = {"load_image_ms": t, "item_ms": ms(lambda: ds[index])[0]}
    out["frame"] = list(img.shape)

    path = os.path.join(ds.data_root, ds.ims[index])
    steps = {}
    steps["read_image_ms"], raw = ms(
        lambda: ds._imread_rgb(path).astype(np.float32) / 255.0)
    steps["read_masks_ms"], (msk, _) = ms(lambda: ds.get_mask(index))
    H, W = raw.shape[:2]
    steps["mask_to_image_ms"], msk = ms(lambda: camera.resize_nearest(msk, H, W))
    K = np.array(ds.cams["K"][ds.cam_inds[index]])
    D = np.array(ds.cams["D"][ds.cam_inds[index]])
    camera._cached_map.cache_clear()
    steps["map_build_ms"], _ = ms(lambda: camera.undistort_map(K, D, H, W))
    steps["undistort_image_ms"], raw = ms(lambda: camera.undistort(raw, K, D))
    steps["undistort_mask_ms"], msk = ms(lambda: camera.undistort(msk, K, D))
    h, w = int(H * ds.cfg.ratio), int(W * ds.cfg.ratio)
    steps["resize_area_image_ms"], _ = ms(lambda: camera.resize_area(raw, h, w))
    steps["resize_nearest_mask_ms"], _ = ms(
        lambda: camera.resize_nearest(msk, h, w))
    out["steps"] = steps
    return out


def phase_camera(k1, knn):
    """Phase 12: real cameras. On distorted copies of the synthetic roots
    read at ratio 0.5: the AniNeRF, SDF-PDF and NeRF-PDF evaluates held to
    the JAX PSNR on the same copies (K1, and K2 and K3 for the PDF
    families, launched); one AniNeRF train step on the card against the
    CPU on the same batch (the eroded mask through the integer remap),
    then CAMERA_TRAIN_STEPS steps of `run_train` from the synthetic_2f
    weights on the copy at 1024x1024 (512x512 frames, as ZJU-MoCap's at
    ratio 0.5; s/step, data s/step) and a profile of steps (device ms,
    idle share); one 512x512 AniNeRF frame of that copy (device ms, K1
    launches); and the host time of `load_image` at 1024x1024, cold and
    warm and step by step, for an eval and a train item. Returns the
    launches of each path."""
    import shutil
    import tempfile

    import torch

    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.compat.jax_params import aninerf_state_dict
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.data.distorted_copy import (
        config_opts, write_distorted_copy)
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset, run_train
    from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    tmp = tempfile.mkdtemp(prefix="camera_copy_")
    try:
        t0 = time.time()
        human = write_distorted_copy("data/synthetic/human",
                                     os.path.join(tmp, "human"))
        capsule = write_distorted_copy("data/synthetic/capsule",
                                       os.path.join(tmp, "capsule"))
        big = write_distorted_copy("data/synthetic/human",
                                   os.path.join(tmp, "human_1024"),
                                   upsample=CAMERA_UPSAMPLE)
        copy_s = time.time() - t0
        paths = {}
        for name, cfg_file, root, jax_psnr, kernels in (
                ("evaluate_camera", NOVEL_POSE_CFG, human, JAX_PSNR_CAMERA,
                 ("skip_mlp",)),
                ("evaluate_camera_sdf_pdf", "configs/synthetic_sdf_pdf.yaml",
                 capsule, JAX_PSNR_CAMERA_SDF, FILTER_KERNELS),
                ("evaluate_camera_nerf_pdf", "configs/synthetic_nerf_pdf.yaml",
                 capsule, JAX_PSNR_CAMERA_NERF_PDF, FILTER_KERNELS)):
            cfg = load_config(cfg_file, config_opts(root), run_type="evaluate")
            launches, _ = phase_evaluate(name, cfg, jax_psnr, k1, knn)
            check(all(launches[k] > 0 for k in kernels)
                  and all(v == 0 for k, v in launches.items()
                          if k not in kernels),
                  f"{name} launched {launches}")
            paths[name] = launches

        # the train step on the card against the CPU at 64x64, then timed
        # steps at 512x512
        def train_cfg(root):
            return load_config(NOVEL_POSE_CFG, config_opts(root) + [
                "exp_name", CAMERA_TRAIN_EXP, "train.epoch", "1", "ep_iter",
                str(CAMERA_TRAIN_STEPS)] + TRAIN_OPTS[4:])

        def train_batch(cfg, size):
            ds = make_dataset(cfg, "train")
            ds._rng = np.random.RandomState(0)
            item = ds[4]
            check(int(item["H"]) == size
                  and len(np.unique(ds.load_image(4)[1])) > 3,
                  f"train_camera: the train item is not the undistorted "
                  f"{size}x{size} frame with its eroded band")
            return stack_batch([collate_rays(item, int(cfg.N_rand))])

        cfg = train_cfg(human)
        ckpt = "data/trained_model/deform/synthetic_2f/latest.flax"
        # the trained weights make this batch's gradient leaves sensitive to
        # float32 rounding (tests/test_torch_camera.py
        # ::test_train_step_gradient_conditioning: moving ray_d by one ulp
        # moves some leaves by more than 1% of their largest entry, the
        # whole gradient by under 1e-3 of its L2 norm), so the gradient is
        # held as one vector
        phase_train_step_vs_cpu(
            "train_camera_step_vs_cpu", cfg,
            aninerf_state_dict(read_checkpoint(ckpt)["params"]),
            train_batch(cfg, 64), k1, knn, {"skip_mlp": 3},
            whole_gradient=True)
        cfg = train_cfg(big)
        write_fresh_start(ckpt, cfg.trained_model_dir)
        reset_counts(k1, knn)
        t0 = time.time()
        trainer, recorder = run_train(cfg, "cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = launch_counts(k1, knn)
        paths["train_camera"] = launches
        steps = trainer.step
        prof = steps_profile(trainer, train_batch(cfg, 512), ["skip_mlp_kernel"])
        emit({"phase": "train_camera", "config": NOVEL_POSE_CFG,
              "opts": config_opts(big), "source_frame": [128 * CAMERA_UPSAMPLE] * 2,
              "steps": steps, "rays_per_step": int(cfg.N_rand), "wall_s": wall,
              "s_per_step_mean": recorder.batch_time.global_avg,
              "s_per_step_median": recorder.batch_time.median,
              "data_s_per_step_mean": recorder.data_time.global_avg,
              "data_s_per_step_median": recorder.data_time.median,
              "launches": launches,
              "loss_median": recorder.scalars["loss"].median,
              "profile_per_step": prof})
        check(steps == CAMERA_TRAIN_STEPS
              and launches == {k: (3 * steps if k == "skip_mlp" else 0)
                               for k in launches}
              and math.isfinite(recorder.scalars["loss"].median),
              f"train_camera: {steps} steps launched {launches}")

        # one 512x512 frame: the copy at 1024x1024 read at ratio 0.5
        cfg = load_config(NOVEL_POSE_CFG, config_opts(big), run_type="evaluate")
        cfg.eval = True
        ds = make_dataset(cfg, "test")
        host = {"eval_item": load_image_ms(ds, 0)}
        item = ds[0]
        size = (int(item["H"]), int(item["W"]))
        check(size == (512, 512), f"frame_camera_512: the frame is {size}")
        eng = Engine(cfg, "cuda")
        eng.load_params()
        frame_launches, _ = phase_full_frame("frame_camera_512", eng, item, k1,
                                             knn, size=size)
        check(frame_launches["skip_mlp"] == 2 * eng.stats["tiles"],
              f"frame_camera_512: K1 launched {frame_launches['skip_mlp']} "
              f"times over {eng.stats['tiles']} tiles")
        paths["frame_camera_512"] = frame_launches
        host["train_item"] = load_image_ms(make_dataset(train_cfg(big), "train"),
                                           4)
        emit({"phase": "camera_host", "copy_s": copy_s,
              "source_frame": [128 * CAMERA_UPSAMPLE] * 2,
              **host})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


# Phase 13: the aligned families (AlignedLBW, AlignedPBW, AlignedSMPL,
# AlignedLBWPDF) on weights composed from the tracked AniNeRF and
# NeRF-PDF checkpoints (animatable_nerf_tpu_torch/compat/compose.py). Per
# view PSNR (frames 0-3, view 3) of the JAX package's evaluate of each
# composed file, and of the checkpoint after one epoch of 50 steps from
# it (fresh Adam, perturb 0, the ray draw seeded), computed on the CPU
# with (<f> is lbw, pbw, smpl, then lbw_pdf):
#   python -m animatable_nerf_tpu_torch.compat.compose <f>
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_aligned_<f>.yaml
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_aligned_<f>/metrics.npy', allow_pickle=True).item()['psnr'])"
#   python -c "from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start as w; w('data/trained_model/deform/synthetic_aligned_<f>/latest.flax', 'data/trained_model/deform/train50_aligned_<f>_jax')"
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file configs/synthetic_aligned_<f>.yaml exp_name train50_aligned_<f>_jax train.epoch 1 perturb 0 fix_random True train.num_workers 2 resume True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_aligned_<f>.yaml exp_name train50_aligned_<f>_jax
#   python -c "import numpy as np; print(np.load('data/result/deform/train50_aligned_<f>_jax/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_ALIGNED_LBW = [18.825851687156632, 21.3224485453902,
                        22.174714024660748, 23.299455620661593]
JAX_PSNR_ALIGNED_PBW = [18.825783762375757, 21.325276535657412,
                        22.17066338833776, 23.29770448667656]
JAX_PSNR_ALIGNED_SMPL = [18.826476263800302, 21.322567827932225,
                         22.16903319359673, 23.297959618780343]
JAX_PSNR_ALIGNED_LBW_PDF = [19.59346466573363, 22.001358386950656,
                            22.57077348173854, 23.548182914614774]
JAX_PSNR_TRAIN_ALIGNED_LBW = [19.514879007663712, 22.95898182816822,
                              23.243578376529996, 25.204763947963137]
JAX_PSNR_TRAIN_ALIGNED_PBW = [19.630112570069347, 23.08282858412936,
                              23.377973353950637, 25.33081743095177]
JAX_PSNR_TRAIN_ALIGNED_SMPL = [19.60824410403113, 23.060482987923034,
                               23.348787235299476, 25.30308092652663]
JAX_PSNR_TRAIN_ALIGNED_LBW_PDF = [16.83894084749308, 19.93892016105859,
                                  20.243438550640793, 22.265262727674756]
ALIGNED = {  # family: (JAX evaluate PSNR, JAX PSNR after 50 steps)
    "lbw": (JAX_PSNR_ALIGNED_LBW, JAX_PSNR_TRAIN_ALIGNED_LBW),
    "pbw": (JAX_PSNR_ALIGNED_PBW, JAX_PSNR_TRAIN_ALIGNED_PBW),
    "smpl": (JAX_PSNR_ALIGNED_SMPL, JAX_PSNR_TRAIN_ALIGNED_SMPL),
    "lbw_pdf": (JAX_PSNR_ALIGNED_LBW_PDF, JAX_PSNR_TRAIN_ALIGNED_LBW_PDF),
}
# K1's launches per eval tile (the learned field; LBWPDF's displacement
# field too), and K1's and K2's per train step (the field at the posed
# and at the canonical points; K2 the filter and, with a learned field,
# the canonical prior with its gradient)
ALIGNED_K1_PER_TILE = {"lbw": 1, "pbw": 1, "smpl": 0, "lbw_pdf": 2}
ALIGNED_PER_STEP = {"lbw": {"skip_mlp": 2, "knn_blend": 2},
                    "pbw": {"skip_mlp": 2, "knn_blend": 2},
                    "smpl": {"knn_blend": 1},
                    "lbw_pdf": {"skip_mlp": 3, "knn_blend": 2}}
ALIGNED_FULL_FRAMES = ("lbw", "lbw_pdf")
# the card's eval item against the CPU's: the maps' largest difference
# (K1 in 3xTF32 against FP32, through the learned warp and the head)
ALIGNED_ITEM_TOL = 1e-3
# rays of the train step held against the CPU (the CPU's step at the
# config's 512 rays takes seconds a family)
ALIGNED_STEP_RAYS = 256
# the card's LBWPDF step against the CPU: the loss within 1e-3, not
# TRAIN_LOSS_RTOL. Its consistency term compares the blend-weight field
# at the posed points with the field at the canonical ones, which the
# displacement field moves: K1's 3xTF32 rounding of that field (within
# K1_REL_TOL of its scale), through the positional encoding, moves the
# term by some 5e-4 of itself. The step with K1's plain version on the
# card (`aligned_step_plain_k1`, held to TRAIN_LOSS_RTOL for every
# family) shows the rest of the card's step agrees with the CPU's.
ALIGNED_LOSS_RTOL = {"lbw_pdf": 1e-3}
# K2's backward on the card against the CPU: both are the same plain
# PyTorch vjp, in float32 summed in another order
K2_GRAD_REL = 1e-5


def cdist_knn_grad(src, ref, values, k=5, eps=1e-8):
    """The library chain K2's differentiable form is timed against:
    torch.cdist, torch.topk and a gather, differentiated by autograd
    (forward and backward, one call at the train step's size)."""
    import torch

    s = src.detach().requires_grad_(True)
    d, idx = torch.topk(torch.cdist(s, ref), k, dim=1, largest=False)
    w = 1.0 / (d + eps)
    vals = (values[idx] * w[..., None]).sum(1) / w.sum(1, keepdim=True)
    wd = (d * w).sum(1, keepdim=True) / w.sum(1, keepdim=True)
    return torch.autograd.grad((vals.sum() + wd.sum()), s)[0]


def k2_grad_on_tpose_points(knn, trainer, batch):
    """K2's differentiable form on one aligned train step's canonical
    points (the consistency target's prior, the step's one KNN call
    whose points carry a gradient, recorded from the model's call; a
    stage-2 step's is branch 0's, at n_anim_samples points): the launch with its selection against the plain version (bit
    for bit, the indices too) and the launch without it against its
    plain version (unchanged), the times of both launches, of the
    backward (the plain vjp over the k selected vertices), of the plain
    version's forward and of the cdist chain's forward and backward; the
    backward's gradient against the CPU's."""
    import torch

    from animatable_nerf_tpu_torch.models import aligned

    real, recorded = aligned.sample_blend_closest_points, []

    def recording(src, ref, values, *args, **kwargs):
        if src.requires_grad:
            recorded.append((src.detach(), ref, values))
        return real(src, ref, values, *args, **kwargs)

    aligned.sample_blend_closest_points = recording
    try:
        trainer.loss({k: v[0] for k, v in batch.items()})
    finally:
        aligned.sample_blend_closest_points = real
    check(len(recorded) == 1, f"an aligned step made {len(recorded)} "
          "differentiable KNN calls")
    src, ref, values = (t.contiguous() for t in recorded[0])
    n, m, c = src.shape[0], ref.shape[0], values.shape[1]
    got = knn.knn_blend(src, ref, values, indices=True)
    want = knn.knn_blend_plain(src, ref, values, indices=True)
    same_idx = torch.equal(got[2], want[2])
    err = max_err(got[0], got[1], want[0], want[1])
    err_off = max_err(*knn.knn_blend(src, ref, values),
                      *knn.knn_blend_plain(src, ref, values))
    check(same_idx and err <= KNN_TOL and err_off <= KNN_TOL,
          f"K2 on the canonical points: indices equal {same_idx}, "
          f"{err} with them and {err_off} without them against the plain "
          "version")

    rng = np.random.RandomState(3)
    g_vals = torch.tensor(rng.randn(n, c).astype(np.float32), device="cuda")
    g_wd = torch.tensor(rng.randn(n, 1).astype(np.float32), device="cuda")
    s = src.clone().requires_grad_(True)
    vals, wd = knn.knn_blend_differentiable(s, ref, values)

    def backward():
        return torch.autograd.grad((vals, wd), s, (g_vals, g_wd),
                                   retain_graph=True)[0]

    grad = backward()
    s_cpu = src.cpu().requires_grad_(True)
    v_cpu, d_cpu = knn.knn_blend_differentiable(s_cpu, ref.cpu(), values.cpu())
    (want_grad,) = torch.autograd.grad((v_cpu, d_cpu), s_cpu,
                                       (g_vals.cpu(), g_wd.cpu()))
    grad_err = ((grad.cpu() - want_grad).abs().max()
                / want_grad.abs().max()).item()
    check(grad_err <= K2_GRAD_REL and bool(grad.isfinite().all()),
          f"K2's backward on the card differs from the CPU's by {grad_err}")

    plain_a = cuda_ms(lambda: knn.knn_blend_plain(src, ref, values,
                                                  indices=True), 1, 3)
    idx_a = cuda_ms(lambda: knn.knn_blend(src, ref, values, indices=True))
    off_a = cuda_ms(lambda: knn.knn_blend(src, ref, values))
    off_b = cuda_ms(lambda: knn.knn_blend(src, ref, values))
    idx_b = cuda_ms(lambda: knn.knn_blend(src, ref, values, indices=True))
    plain_b = cuda_ms(lambda: knn.knn_blend_plain(src, ref, values,
                                                  indices=True), 1, 3)
    bwd = cuda_ms(backward)
    library = cuda_ms(lambda: cdist_knn_grad(src, ref, values), 1, 3)
    kth2 = kth_sq_dist(src, ref)
    band = int(band_pairs(src, ref, int(knn.sweep_layout(ref)[1]), kth2).sum())
    fwd_bound, fwd_by = bound(OPS_PER_PAIR * band + blend_ops(n, c),
                              knn_io_bytes(n, m, c) + 4 * n * 5)
    # the backward reads the queries, their 5 indices, the vertices, their
    # values and the two cotangents, and writes the queries' gradient; it
    # recomputes the blend and takes its vjp, about three times the
    # blend's operations
    bwd_bound, bwd_by = bound(3 * blend_ops(n, c),
                              4 * (n * (3 + 5 + c + 1 + 3) + m * (3 + c)))
    return {"queries": n, "max_abs_err": err, "max_abs_err_without": err_off,
            "indices_equal": same_idx, "grad_rel_err_vs_cpu": grad_err,
            "kernel_ms": (idx_a + idx_b) / 2, "kernel_ms_runs": [idx_a, idx_b],
            "kernel_without_indices_ms": (off_a + off_b) / 2,
            "plain_ms": (plain_a + plain_b) / 2,
            "backward_ms": bwd, "bound_ms": fwd_bound, "bound_by": fwd_by,
            "backward_bound_ms": bwd_bound, "backward_bound_by": bwd_by,
            "library_ms": library,
            "library": "torch.cdist + torch.topk + gather, forward and "
            "autograd backward", "pairs_band_per_query": band / n}


def aligned_step_plain_k1(name, cfg, state_dict, batch, k1, trainer_cls=None,
                          cpu=None):
    """The control of a train step on the card against the CPU: the same
    step on the card with K1's plain version in place of the kernel
    (every other kernel launched as on the main path), its loss and
    stats against the CPU's within TRAIN_LOSS_RTOL and its whole
    gradient within TRAIN_GRAD_REL of its L2 norm. These K1 calls are a
    comparison, not counted as launches. `trainer_cls` defaults to the
    stage-1 Trainer; `cpu`, where given, is the CPU step's (loss, stats,
    gradients) of the same step, which then is not run again."""
    from animatable_nerf_tpu_torch.engine import make_model
    from animatable_nerf_tpu_torch.train.trainer import Trainer

    def plain(x, layers, skips, act, act_last, packed=None):
        return k1.skip_mlp_plain(x, layers, skips, act, act_last)

    results = {} if cpu is None else {"cpu": cpu}
    for device in ("cpu", "cuda")[len(results):]:
        model = make_model(cfg)
        model.load_state_dict(state_dict)
        trainer = (trainer_cls or Trainer)(cfg, model.to(device), device)
        kernel, k1._forward = k1._forward, plain
        try:
            results[device] = train_step_grads(trainer, batch)
        finally:
            k1._forward = kernel
    (_, cpu_s, cpu_g), (_, gpu_s, gpu_g) = results["cpu"], results["cuda"]
    stats_rel = {k: abs(gpu_s[k] / v - 1) if v else abs(gpu_s[k])
                 for k, v in cpu_s.items()}
    rel_l2 = math.sqrt(
        sum(float(((gpu_g[n] - g).double() ** 2).sum()) for n, g in cpu_g.items())
        / sum(float((g.double() ** 2).sum()) for g in cpu_g.values()))
    emit({"phase": name, "stats_rel_err": stats_rel, "grad_rel_l2": rel_l2,
          "tolerance": f"each stat rtol {TRAIN_LOSS_RTOL}, the whole "
          f"gradient {TRAIN_GRAD_REL} of its L2 norm"})
    check(max(stats_rel.values()) <= TRAIN_LOSS_RTOL
          and rel_l2 <= TRAIN_GRAD_REL,
          f"{name}: the card's step with K1's plain version differs from "
          f"the CPU's: {stats_rel}, gradient {rel_l2}")


def aligned_item_vs_cpu(name, cfg_file, k1, knn):
    """One eval item (item 0) on the card against the port's CPU render
    of it, the distance grid at 24^3 on both (the main path's 96^3 grid
    takes tens of seconds on the CPU): the maps within ALIGNED_ITEM_TOL,
    and the same candidate and survivor counts."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset

    cfg = load_config(cfg_file, ["knn_grid_res", "24"], run_type="evaluate")
    cfg.eval = True
    item = make_dataset(cfg, "test")[0]
    outs, stats = {}, {}
    for device in ("cuda", "cpu"):
        eng = Engine(cfg, device)
        eng.load_params()
        t0 = time.time()
        outs[device], _ = eng.render_item(item)
        stats[device] = dict(eng.stats, seconds=time.time() - t0)
    err = {k: float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max())
           for k in outs["cpu"]}
    emit({"phase": name, "rays": len(item["ray_o"]), "max_abs_err": err,
          "tol": ALIGNED_ITEM_TOL, "stats": stats})
    same = all(stats["cuda"][k] == stats["cpu"][k]
               for k in ("n_candidates", "n_survivors"))
    check(same and max(err.values()) <= ALIGNED_ITEM_TOL,
          f"{name}: the card's item differs from the CPU's by {err} "
          f"(counts equal: {same})")


def phase_aligned(full_item, k1, knn):
    """Phase 13: for each aligned family, the composed weights written
    (compose.py `write_aligned`); the evaluate held to the JAX PSNR with
    K1, K2 and K3 launched as ALIGNED_K1_PER_TILE says; one item on the
    card against the CPU; one train step on the card against the CPU
    (the whole gradient), and the same step with K1's plain version on
    the card (`aligned_step_plain_k1`); one epoch of 50 steps from the composed start
    and the evaluate of its checkpoint held to the JAX CPU run of the
    same steps; a profile of train steps; K2's differentiable form on
    one step's canonical points; and for LBW and LBWPDF one 1000x1002
    frame. Returns the launches of each path and K2's row."""
    from animatable_nerf_tpu_torch.compat.compose import write_aligned
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset, make_model
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    paths, k2_grad = {}, None
    for family, (jax_psnr, jax_psnr_train) in ALIGNED.items():
        cfg_file = f"configs/synthetic_aligned_{family}.yaml"
        start = write_aligned(family)
        cfg = load_config(cfg_file, [], run_type="evaluate")
        name = f"evaluate_aligned_{family}"
        launches, _ = phase_evaluate(name, cfg, jax_psnr, k1, knn)
        # K2 once a tile, K1 as the family's field stacks a tile, K3 once
        # a frame (each view is another frame)
        tiles = launches["knn_blend"]
        want = {"skip_mlp": ALIGNED_K1_PER_TILE[family] * tiles,
                "knn_blend": tiles, "min_dist": len(jax_psnr)}
        check(tiles >= len(jax_psnr)
              and launches == {k: want.get(k, 0) for k in launches},
              f"{name} launched {launches}, expected {want}")
        paths[name] = launches
        aligned_item_vs_cpu(f"aligned_{family}_item_vs_cpu", cfg_file, k1, knn)

        exp = f"chip_smoke_train_aligned_{family}"
        opts = ["exp_name", exp] + TRAIN_OPTS[2:]
        step_cfg = load_config(cfg_file, opts + ["N_rand",
                                                 str(ALIGNED_STEP_RAYS)])
        state_dict = param_codec(make_model(step_cfg))[0](
            read_checkpoint(start)["params"])
        ds = make_dataset(step_cfg, "train")
        ds._rng = np.random.RandomState(0)
        batch = stack_batch([collate_rays(ds[0], ALIGNED_STEP_RAYS)])
        per_step = ALIGNED_PER_STEP[family]
        phase_train_step_vs_cpu(f"train_aligned_{family}_step_vs_cpu",
                                step_cfg, state_dict, batch, k1, knn,
                                per_step, whole_gradient=True,
                                loss_rtol=ALIGNED_LOSS_RTOL.get(
                                    family, TRAIN_LOSS_RTOL))
        aligned_step_plain_k1(f"train_aligned_{family}_step_plain_k1_vs_cpu",
                              step_cfg, state_dict, batch, k1)

        run = train_and_evaluate(cfg_file, opts, exp, jax_psnr_train, k1, knn)
        cfg, trainer, _, launches, _, _, _ = run
        summary = train_summary(*run, jax_psnr_train)
        steps = trainer.step
        ds = make_dataset(cfg, "train")
        ds._rng = np.random.RandomState(0)
        batch = stack_batch([collate_rays(ds[0], int(cfg.N_rand))])
        prof = steps_profile(trainer, batch, ["skip_mlp_kernel",
                                              "knn_blend_kernel"])
        record = {"phase": f"train_aligned_{family}", "config": cfg_file,
                  "opts": opts, **summary,
                  "launches_per_step": {k: v / steps
                                        for k, v in launches.items()},
                  "profile_per_step": prof,
                  "events_per_step": step_parts_ms(trainer, batch)}
        if family == "lbw":
            k2_grad = k2_grad_on_tpose_points(knn, trainer, batch)
            record["k2_differentiable_tpose_points"] = k2_grad
        emit(record)
        check_train(f"train_aligned_{family}", summary, per_step)
        paths[f"train_aligned_{family}"] = launches

        if family in ALIGNED_FULL_FRAMES:
            eng = Engine(load_config(cfg_file, [], run_type="evaluate"), "cuda")
            eng.load_params()
            frame_launches, _ = phase_full_frame(
                f"full_frame_aligned_{family}", eng, full_item, k1, knn)
            tiles = eng.stats["tiles"]
            want = {"skip_mlp": ALIGNED_K1_PER_TILE[family] * tiles,
                    "knn_blend": tiles, "min_dist": 1}
            check(frame_launches == {k: want.get(k, 0) for k in frame_launches},
                  f"full_frame_aligned_{family} launched {frame_launches}, "
                  f"expected {want}")
            paths[f"full_frame_aligned_{family}"] = frame_launches
            del eng
    return paths, k2_grad


# Phase 14: the aligned families' novel poses and pass 1 without the
# distance grid. Per-view PSNR (frames 2-3, view 3) of the JAX package's
# novel-pose evaluate of each family's composed novel-pose weights
# (compat/compose.py `compose_novel_pose`), computed on the CPU with
# (<f> is lbw, pbw, smpl, then lbw_pdf):
#   python -m animatable_nerf_tpu_torch.compat.compose <f>_novel_pose
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_aligned_<f>_novel_pose.yaml test_novel_pose True
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_aligned_<f>_novel_pose/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_NOVEL_POSE_ALIGNED = {
    "lbw": [22.786948238632256, 24.564297875676683],
    "pbw": [22.759171973359773, 24.564844587327638],
    "smpl": [22.757334690872167, 24.565164330808347],
    "lbw_pdf": [23.17494287050747, 24.80649776385785],
}
# The same after one epoch of 50 stage-2 steps (65,536 points a branch)
# of LBW and LBWPDF from the common start the port writes (the composed
# stage-1 weights of `init_aninerf` and the port's seeded init of
# novel_pose_bw, a fresh Adam), computed on the CPU with (<f> is lbw,
# then lbw_pdf; after the compose command above):
#   python -c "from animatable_nerf_tpu_torch.config import load_config as c; from animatable_nerf_tpu_torch.engine import write_initial_start as w; w(c('configs/synthetic_aligned_<f>_novel_pose.yaml', ['aninerf_animation', 'True', 'exp_name', 'anim50_aligned_<f>_jax']))"
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file configs/synthetic_aligned_<f>_novel_pose.yaml aninerf_animation True exp_name anim50_aligned_<f>_jax train.epoch 1 fix_random True train.num_workers 2 resume True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_aligned_<f>_novel_pose.yaml test_novel_pose True exp_name anim50_aligned_<f>_jax
#   python -c "import numpy as np; print(np.load('data/result/deform/anim50_aligned_<f>_jax/metrics.npy', allow_pickle=True).item()['psnr'])"
# The two packages draw their points from their own generators, so the
# runs agree in distribution, not point for point.
JAX_PSNR_TRAIN_ANIM_ALIGNED = {
    "lbw": [22.772742019217276, 24.56048911784169],
    "lbw_pdf": [23.162568963474175, 24.810800218880672],
}
# Per-view PSNR (frames 0-3, view 3) of the JAX package's evaluates
# without the distance grid (its pass 1 then takes every point's nearest
# distance, models/pdf.py:171-178, aligned.py:243-255) on the tracked or
# composed weights, computed on the CPU with (<c> is sdf_pdf, nerf_pdf,
# neus_pdf, then aligned_lbw):
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_<c>.yaml knn_grid_res 0
#   python -c "import numpy as np; print(np.load('data/result/deform/synthetic_<c>/metrics.npy', allow_pickle=True).item()['psnr'])"
# Each equals the grid evaluate's constant above to the last digit: pass
# 1 only narrows what pass 2 sees.
JAX_PSNR_NO_GRID = {
    "sdf_pdf": [19.918607338172638, 22.15452214101879, 23.829273881602546,
                25.011918868247466],
    "nerf_pdf": [19.595280411095594, 22.00581491525693, 22.569217838586276,
                 23.556801078276198],
    "neus_pdf": [21.087645831516657, 23.324572879268064, 24.59723973769971,
                 25.410040919281137],
    "aligned_lbw": [18.825851687156632, 21.3224485453902, 22.174714024660748,
                    23.299455620661593],
}
NOVEL_POSE_FAMILIES = ("lbw", "pbw", "smpl", "lbw_pdf")
STAGE2_FAMILIES = ("lbw", "lbw_pdf")
# K1 and K2 a stage-2 step of LBW and LBWPDF: in the pose branch the
# posed prior (K2), novel_pose_bw (K1), the canonical prior with its
# gradient (K2) and the frozen field (K1); in the canonical branch the
# same four the other way round
STAGE2_PER_STEP = {"skip_mlp": 4, "knn_blend": 4}
# points a branch of the stage-2 step held against the CPU: the CPU's
# step at the run's 65,536 takes about 27 s a family
STAGE2_STEP_ROWS = 16384
# the no-grid views against the grid views of the same call: the same
# survivors, so the same maps but for the order of the compositor's
# float additions
NO_GRID_VS_GRID_DB = 1e-3
NO_GRID_FRAME_TOL = 1e-5
# evenly spaced tiles of the no-grid full frame on which K3 is timed and
# bounded (each a whole tile's 524,288 ray-ordered points)
K3_TILE_SAMPLES = 2


class no_plain_knn:
    """Within the block a KNN plain version raises: on the card's main
    paths every KNN call must launch its kernel (the CPU steps held
    against the card run outside such blocks)."""

    NAMES = ("knn_blend_plain", "min_dist_plain", "kth_distance_plain",
             "knn_blend_blocked_plain", "knn_blend_celled_plain")

    def __init__(self, knn):
        self.knn = knn

    def __enter__(self):
        self.real = {n: getattr(self.knn, n) for n in self.NAMES}

        def refuse(*args, **kwargs):
            raise RuntimeError("a plain KNN version ran on the card's path")

        for n in self.NAMES:
            setattr(self.knn, n, refuse)
        return self

    def __exit__(self, *exc):
        for n, f in self.real.items():
            setattr(self.knn, n, f)


def novel_pose_cfg(family):
    return f"configs/synthetic_aligned_{family}_novel_pose.yaml"


def phase_novel_pose_aligned(k1, knn):
    """Phase 14a: for each aligned family the composed novel-pose weights
    written (compose.py `write_novel_pose`) and the `test_novel_pose`
    evaluate (frames 2-3, view 3) held to the JAX PSNR, K1 launched
    ALIGNED_K1_PER_TILE times a tile, K2 once a tile and K3 once a
    frame. Returns each path's launches."""
    from animatable_nerf_tpu_torch.compat.compose import write_novel_pose
    from animatable_nerf_tpu_torch.config import load_config

    paths = {}
    for family in NOVEL_POSE_FAMILIES:
        write_novel_pose(family)
        jax_psnr = JAX_PSNR_NOVEL_POSE_ALIGNED[family]
        cfg = load_config(novel_pose_cfg(family), ["test_novel_pose", "True"],
                          run_type="evaluate")
        name = f"evaluate_novel_pose_aligned_{family}"
        with no_plain_knn(knn):
            launches, _ = phase_evaluate(name, cfg, jax_psnr, k1, knn)
        tiles = launches["knn_blend"]
        want = {"skip_mlp": ALIGNED_K1_PER_TILE[family] * tiles,
                "knn_blend": tiles, "min_dist": len(jax_psnr)}
        check(tiles >= len(jax_psnr)
              and launches == {k: want.get(k, 0) for k in launches},
              f"{name} launched {launches}, expected {want}")
        paths[name] = launches
    return paths


def phase_train_animation_aligned(family, k1, knn):
    """Phase 14b: stage 2 of LBW or LBWPDF. One stage-2 step on the card
    against the CPU on the same points (STAGE2_STEP_ROWS a branch; K1
    and K2 four times each on the card; a gradient for `novel_pose_bw`
    alone, held as one vector), and the same step with K1's plain
    version on the card; `run_train` for one epoch of 50 steps from the common start
    `write_initial_start` writes, every frozen leaf bit-identical to the
    start after them; the novel-pose evaluate of its checkpoint held to
    the JAX CPU run of the same 50 steps; a profile of 5 steps; and on
    LBW K2's differentiable form at the step's canonical points (its
    backward at 65,536 points). Returns (the run's launches, K2's
    record or None)."""
    import torch

    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import (
        make_dataset, make_model, run_evaluate, run_train, write_initial_start)
    from animatable_nerf_tpu_torch.train.animation import AnimationTrainer
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    cfg_file = novel_pose_cfg(family)
    exp = f"chip_smoke_train_anim_aligned_{family}"
    opts = ["aninerf_animation", "True", "exp_name", exp] + ANIM_OPTS[4:]
    cfg = load_config(cfg_file, opts)
    check(int(cfg.n_anim_samples) == ANIM_ROWS,
          f"n_anim_samples is {cfg.n_anim_samples}")
    jax_psnr = JAX_PSNR_TRAIN_ANIM_ALIGNED[family]
    write_initial_start(cfg)
    start = read_checkpoint(os.path.join(cfg.trained_model_dir,
                                         "latest.flax"))["params"]
    state_dict = param_codec(make_model(cfg))[0](start)
    ds = make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    batch = stack_batch([collate_rays(ds[0], int(cfg.N_rand))])
    name = f"train_anim_aligned_{family}"
    step_cfg = load_config(cfg_file, opts + ["n_anim_samples",
                                             str(STAGE2_STEP_ROWS)])
    with fixed_box_points(STAGE2_STEP_ROWS):
        trained, cpu = phase_train_step_vs_cpu(
            f"{name}_step_vs_cpu", step_cfg, state_dict, batch, k1, knn,
            STAGE2_PER_STEP, trainer_cls=AnimationTrainer,
            whole_gradient=True, return_cpu=True)
        aligned_step_plain_k1(f"{name}_step_plain_k1_vs_cpu", step_cfg,
                              state_dict, batch, k1,
                              trainer_cls=AnimationTrainer, cpu=cpu)
    check(len(trained) == 19
          and all(n.startswith("novel_pose_bw.") for n in trained),
          f"{name}_step_vs_cpu: gradients of {sorted(trained)}")

    reset_counts(k1, knn)
    t0 = time.time()
    with no_plain_knn(knn):
        trainer, recorder = run_train(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts(k1, knn)
    res = run_evaluate(load_config(cfg_file, [
        "test_novel_pose", "True", "exp_name", exp], run_type="evaluate"),
        "cuda")
    items = res["items"]
    dpsnr = [it["psnr"] - ref for it, ref in zip(items, jax_psnr)]
    summary = train_summary(cfg, trainer, recorder, launches, wall, items,
                            dpsnr, jax_psnr)
    after = flat_leaves(param_codec(trainer.model)[1](
        dict(trainer.model.named_parameters())))
    before = flat_leaves(start)
    frozen = [k for k in before if "/novel_pose_bw/" not in k]
    moved = [k for k in frozen if not np.array_equal(after[k], before[k])]
    trained_moved = sum(not np.array_equal(after[k], before[k])
                        for k in before if "/novel_pose_bw/" in k)
    samples = 2 * ANIM_ROWS
    prof = steps_profile(trainer, batch, ["skip_mlp_kernel",
                                          "knn_blend_kernel"])
    record = {"phase": name, "config": cfg_file, "opts": opts, **summary,
              "samples_per_step": samples,
              "samples_per_s": samples / recorder.batch_time.median,
              "frozen_leaves": len(frozen), "frozen_leaves_changed": moved,
              "trained_leaves_changed": trained_moved,
              "launches_per_step": {k: v / summary["steps"]
                                    for k, v in launches.items()},
              "profile_per_step": prof,
              "events_per_step": step_parts_ms(trainer, batch)}
    k2_grad = None
    if family == "lbw":
        with fixed_box_points(ANIM_ROWS):
            k2_grad = k2_grad_on_tpose_points(knn, trainer, batch)
        record["k2_differentiable_stage2_points"] = k2_grad
    emit(record)
    check(not moved and trained_moved == 19,
          f"{name}: frozen leaves changed: {moved}; {trained_moved} trained "
          "leaves moved")
    check_train(name, summary, STAGE2_PER_STEP)
    return launches, k2_grad


def k3_on_frame_tiles(knn, tiles, pverts):
    """K3 on whole tiles of the no-grid full frame (their ray-ordered
    pass-1 points, recorded from the render): bit-equal to its plain
    version; per tile launch its time, the plain version's and the
    cdist chain's, and the bound of the pairs the data needs
    (`run_pairs` over the frame's run layout), means over the tiles."""
    m = pverts.shape[0]
    _, runs = knn.grid_layout(pverts)
    rows = []
    for src in tiles:
        n = src.shape[0]
        got = knn.min_dist(src, pverts)
        want = knn.min_dist_plain(src, pverts)
        differ = int((got != want).sum())
        check(differ == 0, f"K3 on a frame tile differs from its plain "
              f"version in {differ} values")
        times = timed_pair(lambda: knn.min_dist(src, pverts),
                           lambda: knn.min_dist_plain(src, pverts),
                           lambda: cdist_min(src, pverts), plain_iters=2)
        kth2 = kth_sq_dist(src, pverts, 1)
        needed = int(run_pairs(src, runs, m, kth2).sum())
        b, by = bound(OPS_PER_PAIR * needed, 4 * (n * 3 + m * 3 + n))
        ranked, swept, tested, full = knn.grid_dist_counts(src, pverts,
                                                           1).tolist()
        rows.append({"queries": n, "pairs_needed_per_query": needed / n,
                     "pairs_tested_per_query": tested / n,
                     "runs_swept_per_warp": swept / -(-n // 32),
                     "bound_ms": b, "bound_by": by, **times})
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in (
        "queries", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
        "pairs_needed_per_query", "pairs_tested_per_query",
        "runs_swept_per_warp")}
    mean.update(bound_by=rows[0]["bound_by"], tiles_timed=len(rows),
                share_of_bound=mean["bound_ms"] / mean["kernel_ms"],
                max_abs_err=0.0,
                library="torch.cdist(...).amin(1), chunks of 16384 queries")
    return mean


def phase_no_grid(k1, knn, full_item, grid_frame, grid_frame_stats):
    """Phase 14c: pass 1 without the distance grid (knn_grid_res 0). The
    evaluates of SDF-PDF, NeRF-PDF, NeuS-PDF and AlignedLBW held to the
    JAX package's no-grid PSNR and, view by view, to the grid evaluate of
    the same call (the same survivors, fewer candidates), K3 launched
    once a tile; then the 1000x1002 SDF-PDF frame without the grid: K3
    once a tile, its vertex layout built once, the survivors of the grid
    frame and its maps, its device time against the grid frame's, and K3
    per tile launch (`k3_on_frame_tiles`). Returns (each path's launches,
    K3's per-tile record)."""
    import torch

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine
    from animatable_nerf_tpu_torch.models import pdf

    paths = {}
    for family, grid_phase in (("sdf_pdf", "evaluate_sdf_pdf"),
                               ("nerf_pdf", "evaluate_nerf_pdf"),
                               ("neus_pdf", "evaluate_neus_pdf"),
                               ("aligned_lbw", "evaluate_aligned_lbw")):
        cfg = load_config(f"configs/synthetic_{family}.yaml",
                          ["knn_grid_res", "0"], run_type="evaluate")
        name = f"evaluate_no_grid_{family}"
        with no_plain_knn(knn):
            launches, _ = phase_evaluate(name, cfg, JAX_PSNR_NO_GRID[family],
                                         k1, knn)
        tiles = launches["knn_blend"]
        grid = EVAL_ITEMS[grid_phase]
        views = [{"psnr_minus_grid_db": it["psnr"] - g["psnr"],
                  "candidates": it["n_candidates"],
                  "grid_candidates": g["n_candidates"],
                  "survivors": it["n_survivors"],
                  "grid_survivors": g["n_survivors"]}
                 for it, g in zip(EVAL_ITEMS[name], grid)]
        emit({"phase": f"{name}_vs_grid", "views": views,
              "tol_db": NO_GRID_VS_GRID_DB})
        check(launches["min_dist"] == tiles >= len(grid)
              and launches["kth_distance"] == launches["knn_blend_blocked"]
              == launches["knn_blend_celled"] == 0,
              f"{name} launched {launches}")
        check(all(v["survivors"] == v["grid_survivors"]
                  and v["candidates"] < v["grid_candidates"]
                  and abs(v["psnr_minus_grid_db"]) <= NO_GRID_VS_GRID_DB
                  for v in views), f"{name}: differs from {grid_phase}")
        paths[name] = launches

    cfg_grid = load_config("configs/synthetic_sdf_pdf.yaml", [],
                           run_type="evaluate")
    cfg = load_config("configs/synthetic_sdf_pdf.yaml", ["knn_grid_res", "0"],
                      run_type="evaluate")
    eng = Engine(cfg, "cuda")
    eng.load_params()
    with no_plain_knn(knn):
        frame_launches, out = phase_full_frame(
            "full_frame_no_grid_sdf_pdf", eng, full_item, k1, knn)
    stats = dict(eng.stats)
    # the vertex layout K3 walks, built once for the frame's tiles
    eng.clear_frame_cache()
    builds0 = knn._grid_layout.builds
    eng.render_item(full_item)
    builds = knn._grid_layout.builds - builds0
    # the frame's pass-1 points, tile by tile
    real, recorded = pdf.min_dist, []

    def recording(src, ref):
        recorded.append(src)
        return real(src, ref)

    pdf.min_dist = recording
    try:
        eng.render_item(full_item)
    finally:
        pdf.min_dist = real
    pverts = eng._device_frame(full_item)["pvertices"]
    step = max(1, len(recorded) // K3_TILE_SAMPLES)
    k3 = k3_on_frame_tiles(knn, recorded[::step][:K3_TILE_SAMPLES], pverts)
    k3.update(launches_per_frame=frame_launches["min_dist"],
              tiles=stats["tiles"], layout_builds_per_frame=builds)
    del recorded
    eng_grid = Engine(cfg_grid, "cuda")
    eng_grid.load_params()
    eng_grid.render_item(full_item)
    times = {}
    for key, e in (("no_grid", eng), ("grid", eng_grid)):
        e.clear_frame_cache()
        times[key] = device_breakdown(lambda: e.render_item(full_item),
                                      host=False)
    err = {k: float(np.abs(out[k] - grid_frame[k]).max()) for k in out}
    record = {"phase": "no_grid_frame_vs_grid", **stats,
              "grid_candidates": grid_frame_stats["n_candidates"],
              "grid_survivors": grid_frame_stats["n_survivors"],
              "max_abs_err_vs_grid": err, "tol": NO_GRID_FRAME_TOL,
              "k3_per_tile": k3,
              "device_ms": {k: v["device_ms"] for k, v in times.items()},
              "wall_ms": {k: v["wall_ms"] for k, v in times.items()},
              "idle_share": {k: v["idle_share"] for k, v in times.items()},
              "own_kernels_ms": {k: v.get("own_kernels_ms")
                                 for k, v in times.items()}}
    emit(record)
    check(frame_launches["min_dist"] == stats["tiles"]
          == frame_launches["knn_blend"] and builds == 1,
          f"full_frame_no_grid_sdf_pdf launched {frame_launches} over "
          f"{stats['tiles']} tiles, {builds} layout builds")
    check(stats["n_survivors"] == grid_frame_stats["n_survivors"]
          and stats["n_candidates"] < grid_frame_stats["n_candidates"]
          and max(err.values()) <= NO_GRID_FRAME_TOL,
          f"the no-grid frame differs from the grid frame: {stats}, {err}")
    paths["full_frame_no_grid_sdf_pdf"] = frame_launches
    return paths, k3


# ---------------------------------------------------------------- phase 15
# The posed mesh of frame 0 of each family at configs/synthetic.yaml's
# voxel_size of 0.02 (`mesh_summary`: vertices, faces, the centroid, the
# bounding box's min and max corners in metres and the total area in
# m^2), from the JAX package on the CPU. The aligned families read the
# composed weights, written first by
#   python -m animatable_nerf_tpu_torch.compat.compose
# then, for each family with its config and mesh dataset opts of
# MESH_FAMILIES:
#   JAX_PLATFORMS=cpu python run.py --type visualize --cfg_file <config> vis_posed_mesh True test.num_sampler_ind 1 <opts>
#   python -c "import numpy as np, chip_smoke as c; m = np.load('data/animation/<exp_name>/posed_mesh/0000.npy', allow_pickle=True).item(); print(c.mesh_summary(m['vertex'], m['triangle']))"
# (about 45 s a family on the CPU).
JAX_MESH = {
    "aninerf": [48456, 97040, -0.05174681082163704, -0.08029483773142705,
                -0.013659514538299207, -0.707118809223175, -1.0789086818695068,
                -0.23331284523010254, 0.8558607697486877, 0.7585856914520264,
                0.3069174289703369, 5.130843240654749],
    "nerf_pdf": [3409, 6810, 0.005637097704896622, -0.03947952238476217,
                 0.013922553812174127, -0.6262914538383484, -0.4539731740951538,
                 -0.05996263027191162, 0.16963422298431396, 0.5953516960144043,
                 0.0794655829668045, 0.3088013282209488],
    "sdf_pdf": [12180, 24356, -0.0013015728014280823, -0.1130066749240862,
                -0.02215909160946401, -0.23492655158042908, -0.7788168787956238,
                -0.19434724748134613, 0.22849240899085999, 0.5879079103469849,
                0.16828487813472748, 1.4815175638229539],
    "neus_pdf": [15452, 30900, 0.06417320299553918, -0.1510550288981845,
                 -0.02087129097166596, -0.19542117416858673, -0.9972540140151978,
                 -0.13600794970989227, 0.49663352966308594, 0.6433131694793701,
                 0.16826428472995758, 1.5612858305713249],
    "aligned_lbw": [3156, 6300, 0.009892427007206191, -0.04937698371963356,
                    0.015899629963630355, -0.6103987097740173,
                    -0.4602084755897522, -0.04865136742591858,
                    0.15963220596313477, 0.5966198444366455,
                    0.07831121981143951, 0.28005813429390153],
    "aligned_pbw": [3160, 6308, 0.009744554361965084, -0.049070184404336956,
                    0.016061527942177616, -0.6103273034095764,
                    -0.46025246381759644, -0.04866582155227661,
                    0.16233456134796143, 0.5966199636459351,
                    0.07831121981143951, 0.28089343367855635],
    "aligned_smpl": [3170, 6328, 0.009508753744209602, -0.04869180630058144,
                     0.016054123005468386, -0.6104569435119629,
                     -0.4602472186088562, -0.04866780340671539,
                     0.16244781017303467, 0.5966199636459351,
                     0.07831121981143951, 0.28076055120809273],
    "aligned_lbw_pdf": [3394, 6776, 0.006454861086821233, -0.03943510089260589,
                        0.013889643405912621, -0.6262885332107544,
                        -0.4539487957954407, -0.05995674431324005,
                        0.16892898082733154, 0.5953516960144043,
                        0.0794655829668045, 0.3075910948961457],
}
SDF_MESH = ["test_dataset_module", "lib.datasets.anisdf_mesh_dataset"]
PDF_MESH = ["test_dataset_module", "lib.datasets.aninerf_pdf_mesh_dataset"]
MESH_FAMILIES = {  # family: (config, the opts that select its mesh dataset)
    "aninerf": ("configs/synthetic.yaml", []),
    "nerf_pdf": ("configs/synthetic_nerf_pdf.yaml", PDF_MESH),
    "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml", SDF_MESH),
    "neus_pdf": ("configs/synthetic_neus_pdf.yaml", SDF_MESH),
    **{f"aligned_{f}": (f"configs/synthetic_aligned_{f}.yaml", PDF_MESH)
       for f in ("lbw", "pbw", "smpl", "lbw_pdf")},
}
# K1 launches a sweep tile: AniNeRF's blend-weight field and density
# trunk; the aligned families' learned blend-weight field, NeRF-PDF's
# and LBWPDF's displacement field (their NeRF network and the SDF
# network are weight-normalized softplus stacks in plain PyTorch, as in
# every earlier phase). K2 once a tile but for AniNeRF, whose filter
# reads its posed volume. The SDF re-pose adds, a chunk of 65,536
# vertices, K2 once and the displacement field twice (under the
# gradient, then for the sdf at v + resd(v)).
MESH_K1_PER_TILE = {"aninerf": 2, "nerf_pdf": 1, "sdf_pdf": 0, "neus_pdf": 0,
                    "aligned_lbw": 1, "aligned_pbw": 1, "aligned_smpl": 0,
                    "aligned_lbw_pdf": 2}
REPOSE_K1_PER_CHUNK = 2
# The limits of the posed mesh against JAX's, stated before the first
# run on the card. The card's K1 (3xTF32) differs from the CPU's float32
# by about 1e-6 of the field's scale, which moves a vertex along its
# grid edge by far less than a voxel, but may push a node near the
# level set across it and change the triangles of its cubes; the CPU
# port matches JAX's counts exactly at voxel 0.1 and 0.05
# (tests/test_torch_mesh.py).
MESH_COUNT_RTOL = 0.01  # vertices and faces, relative
MESH_CENTROID_TOL = 1e-3  # metres
MESH_BBOX_TOL = 0.02  # metres: one voxel
MESH_AREA_RTOL = 0.01
# full size: the shipped configs' voxel (configs/aninerf_s9p.yaml:64)
FULL_VOXEL = 0.005
MESH_FULL_FAMILIES = ("aninerf", "sdf_pdf")
# the full-size sweep against the same sweep with K1's and K2's plain
# versions on the card: the field at every node within MESH_FIELD_REL_TOL
# of max(1, max |plain|) (two 8x256 stacks of 3xTF32 against float32,
# AniNeRF's with the LBS warp between them), and no node whose filter
# flips: the filters read the posed volume (AniNeRF) or K2, which is
# bit-equal to its plain version (phase 3)
MESH_FIELD_REL_TOL = 1e-3
MESH_MAX_FLIPS = 0


def mesh_summary(verts, faces):
    """[vertices, faces, centroid x y z, bbox min x y z, bbox max x y z,
    total area] of a mesh, in float64."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    area = 0.5 * np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]],
                                         v[f[:, 2]] - v[f[:, 0]]), axis=1).sum()
    return [len(v), len(f), *v.mean(0).tolist(), *v.min(0).tolist(),
            *v.max(0).tolist(), float(area)]


def mesh_cfg(family, opts=()):
    from animatable_nerf_tpu_torch.config import load_config

    config, select = MESH_FAMILIES[family]
    return load_config(config, ["vis_posed_mesh", "True", *select, *opts],
                       run_type="visualize")


def sweep_tiles(cfg):
    """The tiles of frame 0's grid (65,536 points each)."""
    from animatable_nerf_tpu_torch.engine import make_dataset
    from animatable_nerf_tpu_torch.render.mesh import SWEEP_TILE

    n = int(np.prod(np.shape(make_dataset(cfg, "test")[0]["pts"])[:3]))
    return n, -(-n // SWEEP_TILE)


def phase_mesh_parity(k1, knn):
    """Phase 15a: for each family, `run_visualize` with vis_posed_mesh on
    frame 0 at voxel 0.02 (composed weights for the aligned families,
    written first), its posed mesh held to the JAX package's
    (`JAX_MESH`: counts within MESH_COUNT_RTOL, centroid within
    MESH_CENTROID_TOL, bounding box within MESH_BBOX_TOL, area within
    MESH_AREA_RTOL), K1 MESH_K1_PER_TILE times a tile and K2 once a tile;
    then `run_animation` of SDF-PDF over the four test frames, one vertex
    count for all. Returns each path's launches."""
    from animatable_nerf_tpu_torch.compat.compose import write_aligned
    from animatable_nerf_tpu_torch.engine import run_animation, run_visualize

    paths = {}
    for family, want in JAX_MESH.items():
        if family.startswith("aligned_"):
            write_aligned(family[len("aligned_"):])
        cfg = mesh_cfg(family, ["test.num_sampler_ind", "1"])
        points, tiles = sweep_tiles(cfg)
        reset_counts(k1, knn)
        t0 = time.time()
        with no_plain_knn(knn):
            records = run_visualize(cfg, "cuda")
        wall = time.time() - t0
        launches = launch_counts(k1, knn)
        mesh = np.load(os.path.join("data/animation", cfg.exp_name,
                                    "posed_mesh", "0000.npy"),
                       allow_pickle=True).item()
        got = mesh_summary(mesh["vertex"], mesh["triangle"])
        dev = {"count_rel": max(abs(got[i] / want[i] - 1) for i in (0, 1)),
               "centroid_m": max(abs(got[i] - want[i]) for i in range(2, 5)),
               "bbox_m": max(abs(got[i] - want[i]) for i in range(5, 11)),
               "area_rel": abs(got[11] / want[11] - 1)}
        sdf = family in ("sdf_pdf", "neus_pdf")
        k1_sweep = launches["skip_mlp"] - (REPOSE_K1_PER_CHUNK if sdf else 0)
        k2_want = (0 if family == "aninerf" else tiles) + (1 if sdf else 0)
        emit({"phase": f"mesh_{family}", "voxel": 0.02, "points": points,
              "tiles": tiles, "summary": got, "jax_summary": want,
              "deviation": dev, "records": records, "launches": launches,
              "wall_s": wall})
        check(len(records) == 1 and dev["count_rel"] <= MESH_COUNT_RTOL
              and dev["centroid_m"] <= MESH_CENTROID_TOL
              and dev["bbox_m"] <= MESH_BBOX_TOL
              and dev["area_rel"] <= MESH_AREA_RTOL,
              f"mesh_{family}: the posed mesh differs from JAX's: {dev}")
        # the density filters force a point on in every tile, so every
        # tile launches its K1 stacks
        check(k1_sweep == MESH_K1_PER_TILE[family] * tiles
              and launches["knn_blend"] == k2_want
              and all(launches[k] == 0 for k in KNN_WRAPPERS[1:]),
              f"mesh_{family} launched {launches}")
        paths[f"mesh_{family}"] = launches
    cfg = mesh_cfg("sdf_pdf", ["test.frame_sampler_interval", "1"])
    reset_counts(k1, knn)
    t0 = time.time()
    with no_plain_knn(knn):
        counts = run_animation(cfg, "cuda")
    launches = launch_counts(k1, knn)
    emit({"phase": "mesh_animation_sdf_pdf", "frames": len(counts),
          "vertices": counts, "launches": launches,
          "wall_s": time.time() - t0})
    check(len(counts) == 4 and len(set(counts)) == 1
          and launches["knn_blend"] >= 4,
          f"mesh_animation_sdf_pdf: {counts} vertices, {launches}")
    paths["animation_sdf_pdf"] = launches
    return paths


class plain_k1_k2:
    """Within the block K1 and K2 on the card run their plain versions
    (a comparison, not the main path)."""

    def __init__(self, k1, knn):
        self.k1, self.knn = k1, knn

    def __enter__(self):
        k1, knn = self.k1, self.knn
        self.real = (k1._forward, knn._knn_blend_cuda)

        def k1_plain(x, layers, skips, act, act_last, packed=None):
            return k1.skip_mlp_plain(x, layers, skips, act, act_last)

        def k2_plain(src, ref, values, k, eps, counts=None, indices=False):
            return knn.knn_blend_plain(src, ref, values, k, eps, indices=indices)

        k1._forward, knn._knn_blend_cuda = k1_plain, k2_plain
        return self

    def __exit__(self, *exc):
        self.k1._forward, self.knn._knn_blend_cuda = self.real


def phase_mesh_full(family, k1, knn):
    """Phase 15b: one full-size extraction at FULL_VOXEL of frame 0
    (`Engine.extract_mesh`, profiled: K1's and K2's launches from the
    profiler and from the wrappers, device and wall time, the host's
    marching cubes and largest component, the re-pose), then the sweep
    alone with the kernels (profiled) and with K1's and K2's plain
    versions, the field held within MESH_FIELD_REL_TOL and its filter's
    flips counted. Returns the launches of the extraction."""
    import torch

    from animatable_nerf_tpu_torch.engine import Engine, make_dataset
    from animatable_nerf_tpu_torch.models.pdf import SDF_FILL

    cfg = mesh_cfg(family, ["voxel_size", f"[{FULL_VOXEL}, {FULL_VOXEL}, {FULL_VOXEL}]"])
    eng = Engine(cfg, "cuda")
    eng.load_params()
    t0 = time.time()
    item = make_dataset(cfg, "test")[0]
    item_s = time.time() - t0
    out = {}
    reset_counts(k1, knn)
    with no_plain_knn(knn):
        prof = device_breakdown(lambda: out.update(mesh=eng.extract_mesh(item)),
                                host=False)
    launches = launch_counts(k1, knn)
    stats = dict(eng.mesh_stats)
    with no_plain_knn(knn):
        sweep_prof = device_breakdown(
            lambda: out.update(kernel=eng.sweep_field(item)[0]), host=False)
    t0 = time.time()
    with plain_k1_k2(k1, knn):
        plain = eng.sweep_field(item)[0]
        torch.cuda.synchronize()
    plain_s = time.time() - t0
    fill = SDF_FILL if family in ("sdf_pdf", "neus_pdf") else 0.0
    got = out["kernel"]
    flips = int(((got == fill) != (plain == fill)).sum())
    both = (got != fill) & (plain != fill)
    err = float((got - plain)[both].abs().max())
    scale = max(1.0, float(plain[both].abs().max()))
    emit({"phase": f"mesh_full_{family}", "voxel": FULL_VOXEL,
          "grid": list(np.shape(item["pts"])[:3]), "points": stats["points"],
          "tiles": stats["tiles"], "vertices": stats["vertices"],
          "faces": stats["faces"], "launches": launches,
          "profiler_launches": prof.get("own_kernels_launches"),
          "extract_wall_ms": prof["wall_ms"],
          "extract_device_ms": prof["device_ms"],
          "extract_idle_share": prof["idle_share"],
          "sweep_wall_ms": stats["sweep_s"] * 1e3,
          "sweep_device_ms": sweep_prof["device_ms"],
          "sweep_alone_wall_ms": sweep_prof["wall_ms"],
          "sweep_kernels": sweep_prof["kernels"],
          "marching_cubes_ms": stats["marching_cubes_s"] * 1e3,
          "largest_component_ms": stats["largest_component_s"] * 1e3,
          "repose_ms": stats.get("repose_s", 0.0) * 1e3,
          "item_host_ms": item_s * 1e3, "plain_sweep_wall_ms": plain_s * 1e3,
          "max_abs_err_vs_plain": err, "scale": scale,
          "tol_abs": MESH_FIELD_REL_TOL * scale, "filter_flips": flips,
          "max_flips": MESH_MAX_FLIPS})
    check(stats["faces"] > 0 and math.isfinite(err)
          and err <= MESH_FIELD_REL_TOL * scale and flips <= MESH_MAX_FLIPS,
          f"mesh_full_{family}: the sweep differs from its plain versions' "
          f"by {err} (scale {scale}), {flips} flipped nodes")
    # the profiler's counts are printed beside the wrappers'; in a whole
    # run of this script it has missed one of 103 K2 launches, so only
    # its sighting of each kernel is held
    by_profiler = prof.get("own_kernels_launches")
    check(launches["skip_mlp"] > 0
          and (family == "aninerf" or launches["knn_blend"] >= stats["tiles"])
          and (by_profiler is None or (
              by_profiler["skip_mlp_kernel"] > 0
              and (by_profiler["knn_blend_kernel"] > 0) == (
                  launches["knn_blend"] > 0))),
          f"mesh_full_{family} launched {launches}, the profiler saw "
          f"{by_profiler}")
    del eng, item, out, plain, got
    torch.cuda.empty_cache()
    return launches


# Phase 16: rendered visualizations (`--type visualize` with
# vis_novel_view / vis_pose_sequence, `--type raster`). Each case renders
# item 0 of its dataset (view 0 of the 50-view spiral around frame 0, or
# the first frame of the pose sequence from the split's first camera) at
# ratio 0.5 with the distance grid at 24^3 (VIS_SMALL: the port's CPU
# render of the same item stays within seconds), carved by the training
# views' masks. JAX_VIS: [mean r, g, b over the item's rays, acc sum,
# rays with acc > 0.5, mean depth] of the JAX package's
# `render_item(params, item, visibility=True)`, computed on the CPU with
# (<name> a key of VIS_CASES; for AlignedLBW first
# `python -m animatable_nerf_tpu_torch.compat.compose lbw`):
#   JAX_PLATFORMS=cpu python -c "import jax, chip_smoke as c; from animatable_nerf_tpu import engine as e; from animatable_nerf_tpu.config import load_config as l; n = '<name>'; cfg = l(c.VIS_CASES[n][0], c.vis_opts(n), run_type='visualize'); eng = e.Engine(cfg); ds = e.make_dataset(cfg, 'test'); p = eng.load_params(eng.init_params(jax.random.PRNGKey(0), ds)); print(c.vis_summary(eng.render_item(p, ds[0], visibility=True)[0]))"
# (about 20 s a case on the CPU).
NV_PDF = ["test_dataset_module", "lib.datasets.tpose_pdf_novel_view_dataset"]
PS_PDF = ["test_dataset_module", "lib.datasets.tpose_pdf_pose_sequence_dataset"]
VIS_CASES = {  # name: (config, the opts that select the visualization)
    "novel_view_aninerf": ("configs/synthetic.yaml", ["vis_novel_view", "True"]),
    "novel_view_sdf_pdf": ("configs/synthetic_sdf_pdf.yaml",
                           ["vis_novel_view", "True", *NV_PDF]),
    "novel_view_neus_pdf": ("configs/synthetic_neus_pdf.yaml",
                            ["vis_novel_view", "True", *NV_PDF]),
    "novel_view_aligned_lbw": ("configs/synthetic_aligned_lbw.yaml",
                               ["vis_novel_view", "True", *NV_PDF]),
    "pose_sequence_novel_pose": (NOVEL_POSE_CFG, [
        "vis_pose_sequence", "True", "test_novel_pose", "True",
        "exp_name", "synthetic_2f_anim"]),
    "pose_sequence_nerf_pdf": ("configs/synthetic_nerf_pdf.yaml",
                               ["vis_pose_sequence", "True", *PS_PDF]),
}
VIS_SMALL = ["ratio", "0.5", "knn_grid_res", "24"]
JAX_VIS = {
    "novel_view_aninerf": [0.2839642917342055, 0.27063273298397783,
                           0.016208402074590646, 518.0463975593448, 557,
                           1.059778192216794],
    "novel_view_sdf_pdf": [0.03698448831714242, 0.039318713733113415,
                           0.014424896159697874, 99.30025419220328, 92,
                           0.23423048327651505],
    "novel_view_neus_pdf": [0.031239885601464436, 0.034777437255951914,
                            0.009799556714759966, 65.4055828708224, 0,
                            0.15297036158821745],
    "novel_view_aligned_lbw": [0.03460981630081226, 0.03438672570244635,
                               0.010883523265243649, 71.32544300123118, 27,
                               0.16838713700584418],
    "pose_sequence_novel_pose": [0.295392272658158, 0.19715189926307375,
                                 0.07093753225416753, 1059.6670664910052,
                                 1104, 1.066579714352275],
    "pose_sequence_nerf_pdf": [0.10102802553614057, 0.06841834014003015,
                               0.03892766482959848, 270.67816821450833, 241,
                               0.4903844459791303],
}
# K1 launches a tile: AniNeRF's blend-weight field (or, for novel poses,
# its novel-pose field) and NeRF trunk; the displacement field of the
# PDF families; AlignedLBW's blend-weight field. K2 once a tile and K3
# once a frame (the grid) for the KNN families.
VIS_K1_PER_TILE = {"novel_view_aninerf": 2, "novel_view_sdf_pdf": 1,
                   "novel_view_neus_pdf": 1, "novel_view_aligned_lbw": 1,
                   "pose_sequence_novel_pose": 2, "pose_sequence_nerf_pdf": 1}
# The limits of a case against JAX's summary and the port's CPU render,
# stated before the first run on the card: K1's 3xTF32 against float32
# moves a map by about 1e-6 (phase 13's items: 1.5e-6), so the means
# within VIS_MEAN_TOL, the acc sum within VIS_ACC_RTOL, at most
# VIS_ACC_FLIPS rays across acc 0.5, and the CPU's maps within
# VIS_CPU_TOL, with the same candidates, survivors and carved survivors.
VIS_MEAN_TOL = 1e-4
VIS_ACC_RTOL = 1e-4
VIS_ACC_FLIPS = 2
VIS_CPU_TOL = 1e-4
# `run_raster` of frame 0 at voxel 0.02 (the configs' voxel), view 0:
# the covered pixels and their mean depth (m) in the JAX package's raster,
# computed on the CPU with (<config> and <opts> of RASTER_CASES):
#   JAX_PLATFORMS=cpu python run.py --type raster --cfg_file <config> vis_posed_mesh True test.num_sampler_ind 1 <opts>
#   python -c "import numpy as np; d = np.load('data/raster/<exp_name>/frame0000_view0000_depth.npy'); print([int((d > 0).sum()), float(d[d > 0].mean())])"
RASTER_CASES = {"aninerf": ("configs/synthetic.yaml", []),
                "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml", SDF_MESH)}
JAX_RASTER = {"aninerf": [4818, 2.5025246143341064],
              "sdf_pdf": [2119, 2.5386552810668945]}
# a mesh from the card's sweep against JAX's moves the silhouette by
# less than a pixel along its edge (phase 15: counts within 1%)
RASTER_COVER_RTOL = 0.01
RASTER_DEPTH_TOL = 1e-3  # metres
# the full-size carved view against the uncarved render of the same
# rays, on the rays whose samples every training view sees: the same
# survivors there, their MLP rows batched with other rows
VIS_FRAME_TOL = 1e-5
VIS_FULL_FAMILIES = ("novel_view_aninerf", "novel_view_sdf_pdf")


def vis_opts(name):
    """The opts of a VIS_CASES case, as the JAX constants were computed."""
    return [*VIS_CASES[name][1], *VIS_SMALL]


def vis_summary(out):
    """[mean r, g, b, acc sum, rays with acc > 0.5, mean depth] of a
    render's maps over its rays, in float64."""
    rgb = np.asarray(out["rgb_map"], np.float64)
    acc = np.asarray(out["acc_map"], np.float64)
    depth = np.asarray(out["depth_map"], np.float64)
    return [*rgb.mean(0).tolist(), float(acc.sum()), int((acc > 0.5).sum()),
            float(depth.mean())]


class recorded_renders:
    """Within the block every `Engine.render_item` call's item, output
    and counts are kept in `calls` (the main path's own render, read
    after it)."""

    def __enter__(self):
        from animatable_nerf_tpu_torch.engine import Engine

        self.cls, self.real, self.calls = Engine, Engine.render_item, []
        calls, real = self.calls, self.real

        def render_item(eng, item, visibility=False):
            out = real(eng, item, visibility=visibility)
            calls.append((item, out[0], dict(eng.stats)))
            return out

        Engine.render_item = render_item
        return self

    def __exit__(self, *exc):
        self.cls.render_item = self.real


def phase_vis_parity(k1, knn):
    """Phase 16a: for each VIS_CASES case, `run_visualize` of item 0 on
    the card (composed weights for AlignedLBW, written first), the file
    in JAX's layout, its render held to the JAX package's summary
    (JAX_VIS) and to the port's CPU render of the same item, K1
    VIS_K1_PER_TILE times a tile, K2 once a tile and K3 once (the grid)
    for the KNN families; then `run_raster` of frame 0 of AniNeRF and
    SDF-PDF held to JAX's covered pixels and depth (JAX_RASTER). Returns
    each path's launches."""
    from animatable_nerf_tpu_torch.compat.compose import write_aligned
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine, run_raster, run_visualize

    paths = {}
    write_aligned("lbw")
    for name, want in JAX_VIS.items():
        cfg = load_config(VIS_CASES[name][0], vis_opts(name),
                          run_type="visualize")
        reset_counts(k1, knn)
        t0 = time.time()
        with no_plain_knn(knn), recorded_renders() as rec:
            (record,) = run_visualize(cfg, "cuda", max_items=1)
        wall = time.time() - t0
        launches = launch_counts(k1, knn)
        (item, out, stats), = rec.calls
        cpu = Engine(cfg, "cpu")
        cpu.load_params()
        t0 = time.time()
        cpu_out, _ = cpu.render_item(item, visibility=True)
        cpu_s = time.time() - t0
        got = vis_summary(out)
        err = {k: float(np.abs(out[k] - cpu_out[k]).max()) for k in cpu_out}
        dev = {"mean": max(abs(got[i] - want[i]) for i in (0, 1, 2, 5)),
               "acc_sum_rel": abs(got[3] / want[3] - 1),
               "acc_flips": abs(got[4] - want[4])}
        tiles = stats["tiles"]
        knn_family = name not in ("novel_view_aninerf", "pose_sequence_novel_pose")
        emit({"phase": f"vis_{name}", "file": record["path"],
              "rays": record["rays"], "stats": stats, "cpu_stats": dict(cpu.stats),
              "summary": got, "jax_summary": want, "deviation": dev,
              "max_abs_err_vs_cpu": err, "launches": launches,
              "wall_s": wall, "render_s": record["seconds"], "cpu_render_s": cpu_s})
        check(os.path.exists(record["path"]) and dev["mean"] <= VIS_MEAN_TOL
              and dev["acc_sum_rel"] <= VIS_ACC_RTOL
              and dev["acc_flips"] <= VIS_ACC_FLIPS,
              f"vis_{name}: the render differs from JAX's: {dev}")
        check(stats == cpu.stats and max(err.values()) <= VIS_CPU_TOL
              and 0 < stats["n_carved"] < stats["n_survivors"],
              f"vis_{name}: the card differs from the CPU: {err}, {stats} "
              f"against {cpu.stats}")
        check(launches["skip_mlp"] == VIS_K1_PER_TILE[name] * tiles
              and launches["knn_blend"] == (tiles if knn_family else 0)
              and launches["min_dist"] == (1 if knn_family else 0)
              and all(launches[k] == 0 for k in KNN_WRAPPERS[2:]),
              f"vis_{name} launched {launches} over {tiles} tiles")
        paths[f"vis_{name}"] = launches
    for family, want in JAX_RASTER.items():
        config, select = RASTER_CASES[family]
        cfg = load_config(config, ["vis_posed_mesh", "True",
                                   "test.num_sampler_ind", "1", *select],
                          run_type="raster")
        reset_counts(k1, knn)
        t0 = time.time()
        with no_plain_knn(knn):
            frames = run_raster(cfg, "cuda")
        wall = time.time() - t0
        launches = launch_counts(k1, knn)
        depth = np.load(os.path.join("data/raster", cfg.exp_name,
                                     "frame0000_view0000_depth.npy"))
        got = [int((depth > 0).sum()), float(depth[depth > 0].mean())]
        dev = {"cover_rel": abs(got[0] / want[0] - 1),
               "depth_m": abs(got[1] - want[1])}
        emit({"phase": f"raster_{family}", "frames": frames, "summary": got,
              "jax_summary": want, "deviation": dev, "launches": launches,
              "wall_s": wall})
        check(frames == [0] and dev["cover_rel"] <= RASTER_COVER_RTOL
              and dev["depth_m"] <= RASTER_DEPTH_TOL
              and launches["skip_mlp"] > 0
              and (family == "aninerf" or launches["knn_blend"] > 0),
              f"raster_{family}: {dev}, launched {launches}")
        paths[f"raster_{family}"] = launches
    return paths


def full_novel_view_item(ds, item):
    """The novel view's camera at FULL_H x FULL_W (K's rows scaled to the
    size), its rays through the frame's box, and the training views'
    masks resized to that size with their cameras scaled alike."""
    from animatable_nerf_tpu_torch.data.novel_view import get_rays_within_bounds

    H0, W0 = int(item["H"]), int(item["W"])
    scale = np.array([[FULL_W / W0], [FULL_H / H0], [1.0]])
    RT = ds.render_w2c[int(item["view_index"])]
    ray_o, ray_d, near, far, mab = get_rays_within_bounds(
        FULL_H, FULL_W, ds.K_render * scale, RT[:3, :3].astype(np.float32),
        RT[:3, 3].astype(np.float32), item["wbounds"])
    annot_pos = ds.cfg.begin_ith_frame * ds.cfg.frame_interval
    return dict(item, ray_o=ray_o, ray_d=ray_d, near=near, far=far,
                mask_at_box=mab, H=FULL_H, W=FULL_W,
                msks=ds._train_view_masks(annot_pos, FULL_H, FULL_W),
                Ks=(item["Ks"] * scale[None]).astype(np.float32),
                K_render=ds.K_render * scale, RT_render=RT)


def carved_rays(pts, item):
    """The rays (indices into the item's rays) that hold the world points
    pts (N, 3): each point projected by the item's render camera onto the
    pixel whose ray it lies on."""
    import torch

    K, RT = (torch.as_tensor(np.asarray(a, np.float32), device=pts.device)
             for a in (item["K_render"], item["RT_render"]))
    pix = (pts @ RT[:3, :3].T + RT[:3, 3]) @ K.T
    u = torch.round(pix[:, 0] / pix[:, 2]).long().cpu().numpy()
    v = torch.round(pix[:, 1] / pix[:, 2]).long().cpu().numpy()
    mab = np.asarray(item["mask_at_box"]).reshape(-1)
    ray_of_pixel = np.cumsum(mab) - 1
    pixel = v * int(item["W"]) + u
    check(bool(mab[pixel].all()), "a carved point projects off the item's rays")
    return np.unique(ray_of_pixel[pixel])


def phase_vis_full(name, k1, knn):
    """Phase 16b: one FULL_H x FULL_W novel view carved by the training
    views' masks at that size, timed after a warm-up and profiled on the
    device; the carve's own device time, profiled over the points the
    timed render carved (each tile's exact survivors); its survivors with
    and without the carve; the uncarved render of the same rays within
    VIS_FRAME_TOL on every ray the carve removed no survivor from (the
    rays of the carved survivors found by projecting their points onto
    the view). Returns the launches of the timed carved render."""
    import torch

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset

    cfg = load_config(VIS_CASES[name][0], VIS_CASES[name][1], run_type="visualize")
    ds = make_dataset(cfg, "test")
    item = full_novel_view_item(ds, ds[0])
    eng = Engine(cfg, "cuda")
    eng.load_params()
    real_carve, calls = eng._carve, []

    def recorded_carve(it):
        fn = real_carve(it)

        def run(pts):
            seen = fn(pts)
            calls.append((pts, seen))
            return seen
        return run

    eng._carve = recorded_carve
    with no_plain_knn(knn):
        eng.render_item(item, visibility=True)  # allocator warm-up
        torch.cuda.synchronize()
        eng.clear_frame_cache()
        calls.clear()
        reset_counts(k1, knn)
        t0 = time.time()
        out, n_rays = eng.render_item(item, visibility=True)
        frame_s = time.time() - t0
        launches = launch_counts(k1, knn)
        stats = dict(eng.stats)
        carved = carved_rays(torch.cat([p[~seen] for p, seen in calls]), item)
        tiles_pts = [p for p, _ in calls]
        eng.clear_frame_cache()
        prof_frame = device_breakdown(lambda: eng.render_item(item, visibility=True),
                                      host=False)
        inside = real_carve(item)
        prof_carve = device_breakdown(lambda: [inside(p) for p in tiles_pts],
                                      host=False)
        plain, _ = eng.render_item(item)
        plain_stats = dict(eng.stats)
    kept = np.ones(n_rays, bool)
    kept[carved] = False
    err = {k: float(np.abs(out[k] - plain[k])[kept].max()) for k in out}
    emit({"phase": f"vis_full_{name}", "H": FULL_H, "W": FULL_W, "rays": n_rays,
          "stats": stats, "uncarved_stats": plain_stats, "s_per_frame": frame_s,
          "device_ms": prof_frame["device_ms"], "idle_share": prof_frame["idle_share"],
          "kernels": prof_frame["kernels"],
          "carve_device_ms": prof_carve["device_ms"],
          "carve_points": int(sum(len(p) for p in tiles_pts)),
          "launches": launches, "rays_with_carved_survivors": int(len(carved)),
          "max_abs_err_vs_uncarved_elsewhere": err, "tol": VIS_FRAME_TOL,
          "acc_mean": float(out["acc_map"].mean()),
          "uncarved_acc_mean": float(plain["acc_map"].mean())})
    check(stats["n_survivors"] == plain_stats["n_survivors"]
          and 0 < stats["n_carved"] < stats["n_survivors"]
          and 0 < len(carved) < n_rays and max(err.values()) <= VIS_FRAME_TOL
          and all(np.isfinite(v).all() for v in out.values())
          and launches["skip_mlp"] > 0,
          f"vis_full_{name}: {stats} against {plain_stats}, {err} on the "
          "rays the carve left whole")
    del eng, item, out, plain, calls, tiles_pts
    torch.cuda.empty_cache()
    return launches


# Phase 17: the image-space baselines NHR and NT on the capsule's baseline
# copy (animatable_nerf_tpu_torch/data/baseline_prep.py: lbs/bigpose_bw.npy
# and uv/ added), from the port's seeded start (engine.write_initial_start).
# Per-view PSNR of the JAX package on the CPU, on the same copy and start
# (<f> is nhr or nt):
#   python -m animatable_nerf_tpu_torch.data.baseline_prep data/synthetic/capsule data/synthetic/capsule_baseline
#   python -c "from animatable_nerf_tpu_torch.config import load_config as c; from animatable_nerf_tpu_torch.engine import write_initial_start as w; w(c('configs/synthetic_<f>.yaml', ['exp_name', 'jax_<f>']))"
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_<f>.yaml exp_name jax_<f>
#   python -c "import numpy as np; print(np.load('data/result/deform/jax_<f>/metrics.npy', allow_pickle=True).item()['psnr'])"
# and after 50 steps from that start (the start written as above under
# exp_name jax50_<f>; about 7 min for NHR and 1.5 min for NT):
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file configs/synthetic_<f>.yaml exp_name jax50_<f> train.epoch 1 ep_iter 50 resume True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_<f>.yaml exp_name jax50_<f>
JAX_PSNR_BASELINE = {
    "nhr": [-0.27591211662144954, 0.39966107539427187, 1.4730780960561412,
            2.426096112877643],
    "nt": [-2.205190022237952, -1.695512908441042, -1.2610817486250514,
           -0.7936716580793975]}
JAX_PSNR_TRAIN_BASELINE = {
    "nhr": [16.993471380688607, 17.73007421174262, 18.79078593320474,
            21.259465706498155],
    "nt": [16.983174977928943, 17.267473319935657, 17.749946351903866,
           18.410506562415893]}
# The port's PSNR after BASELINE_TRAIN_STEPS steps (20; these are the
# JAX run's after 50) is printed beside these, not held to them: the
# trajectories are chaotic. Adam's first steps move every
# weight by about lr whatever its gradient's size, and where float32
# resolves a gradient's sign differently (0.17% of NT's weights at step 1,
# measured on the CPU) the runs part: four CPU runs of the port from the
# same start, differing only in torch's thread count, ended -1.77 to
# +1.83 dB (NHR) and +0.07 to +0.21 dB (NT) from the JAX run's views.
# The card's steps are held at matched weights instead: at each step
# of BASELINE_MATCHED_STEPS the CPU takes the card's weights and Adam
# state, and its loss (TRAIN_LOSS_RTOL), its clipped gradient as one
# vector (TRAIN_GRAD_REL; NHR's both by `held_by_control`, below) and
# Adam's update and moments from the card's gradient (TRAIN_GRAD_REL of their
# L2 norms) must agree with the card's step. A CPU step of NHR takes
# some 3-5 s (twice that with its control), so four of the 20 are
# matched: the first two, while Adam's moments fill, then two later.
BASELINES = ("nhr", "nt")
BASELINE_TRAIN_STEPS = 20
BASELINE_UPSAMPLE = 8  # the 128x128 copy at 1024x1024
BASELINE_FULL_STEPS = 5
# an item's rgb and mask, card against CPU (the same plain PyTorch; cuDNN's
# and the CPU's convolutions sum in other orders); at 1024x1024 cuDNN takes
# other algorithms (FFT, implicit GEMM) and each batch norm sums a channel
# over 1M pixels: NT's frame differed by 1.02e-4 there on an H100
BASELINE_ITEM_TOL = 1e-4
BASELINE_FULL_TOL = 3e-4
# NHR against the CPU: PointNet++'s 16 batch norms over a few points each
# double a rounding difference a level, so NHR's item and steps are held
# by `held_by_control`: within the larger of the base bound and twice
# what one ulp of the canonical vertices moves the CPU's own result. That
# control is the program's own, so each bound has a fixed ceiling, from
# the largest controls of the port's CPU runs on the copy: the test
# item's forward 1.73e-3 (on the H100's host); at the start, over the 12
# train items, the loss 1e-6 to 6.6e-5 (relative) and the gradient 9.5e-3
# to 9.0e-2 of its L2 norm; over 50 CPU steps, at most 2.1e-5 and 4.4e-2.
# A run whose control passes a ceiling fails.
BASELINE_NHR_FWD_CEIL = 5e-3
BASELINE_NHR_LOSS_CEIL = 3e-4
BASELINE_NHR_GRAD_CEIL = 0.25
BASELINE_MATCHED_STEPS = (1, 2, 10, 20)


def baseline_cfg(copy, fam, tmp, name, image_size=None, run_type="",
                 extra=()):
    """configs/synthetic_<fam>.yaml on the baseline copy `copy`, its
    model, result and record directories under tmp/<name>."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.data.baseline_prep import config_opts

    opts = config_opts(copy, image_size) + [
        "exp_name", f"chip_smoke_{name}",
        "trained_model_dir", os.path.join(tmp, name, "model"),
        "result_dir", os.path.join(tmp, name, "result"),
        "record_dir", os.path.join(tmp, name, "record"), *extra]
    cfg = load_config(f"configs/synthetic_{fam}.yaml", opts, run_type=run_type)
    cfg.eval = bool(run_type)
    return cfg


def baseline_frame(model, item, device):
    import torch

    return {k: torch.as_tensor(np.asarray(item[k], np.float32), device=device)
            for k in model.frame_keys}


def phase_baseline_evaluate(fam, cfg, k1, knn):
    """The port's `run --type evaluate` of the start on the card, each
    view held to the JAX package's PSNR; no kernel of K1-K6 launched."""
    from animatable_nerf_tpu_torch.engine import run_evaluate

    reset_counts(k1, knn)
    t0 = time.time()
    res = run_evaluate(cfg, "cuda")
    wall = time.time() - t0
    launches = launch_counts(k1, knn)
    items, jax_psnr = res["items"], JAX_PSNR_BASELINE[fam]
    dpsnr = [it["psnr"] - ref for it, ref in zip(items, jax_psnr)]
    emit({"phase": f"baseline_evaluate_{fam}", "items": items,
          "psnr_mean": res["psnr"], "jax_psnr": jax_psnr,
          "delta_psnr_db": dpsnr, "tol_db": PSNR_TOL_DB, "launches": launches,
          "wall_s": wall, "s_per_frame": [it["seconds"] for it in items]})
    check(len(items) == len(jax_psnr), f"{fam}: expected {len(jax_psnr)} items")
    check(all(abs(d) <= PSNR_TOL_DB for d in dpsnr),
          f"baseline_evaluate_{fam}: PSNR differs from JAX by {dpsnr} dB")
    check(not any(launches.values()), f"{fam} launched {launches}")
    return launches


def nudged(item, key):
    """`item` with its `key` array one float32 ulp up."""
    a = np.asarray(item[key], np.float32)
    return {**item, key: np.nextafter(a, np.float32(np.inf))}


def grad_rel_l2(got, want):
    return math.sqrt(
        sum(float(((got[n] - g).double() ** 2).sum()) for n, g in want.items())
        / sum(float((g.double() ** 2).sum()) for g in want.values()))


def held_by_control(base, control, ceiling):
    """NHR's bound: the larger of `base` and twice the CPU's ulp control,
    which must stay within `ceiling` (None without a control: `base`)."""
    if control is None:
        return base, True
    tol = max(base, 2 * control)
    return tol, tol <= ceiling


def phase_baseline_item_vs_cpu(fam, cfg, k1, knn):
    """One test item's forward on the card against the port's CPU forward
    of it from the start's weights, rgb and mask within BASELINE_ITEM_TOL;
    for NHR within `held_by_control` of the CPU forward on the canonical
    vertices one ulp up and BASELINE_NHR_FWD_CEIL."""
    import torch

    from animatable_nerf_tpu_torch.engine import initial_model, make_dataset

    item = make_dataset(cfg, "test")[0]
    reset_counts(k1, knn)
    runs = [("cpu", item), ("cuda", item)]
    if fam == "nhr":
        runs.append(("cpu", nudged(item, "tpose")))
    outs, secs = [], []
    for device, it in runs:
        model = initial_model(cfg).to(device).eval()
        t0 = time.time()
        with torch.no_grad():
            o = model(baseline_frame(model, it, device))
            outs.append({k: o[k].float().cpu() for k in ("rgb_map", "mask")})
        secs.append(time.time() - t0)
    launches = launch_counts(k1, knn)
    cpu_out, gpu_out = outs[:2]
    err = {k: float((gpu_out[k] - cpu_out[k]).abs().max()) for k in cpu_out}
    control = (max(float((outs[2][k] - cpu_out[k]).abs().max())
                   for k in cpu_out) if len(outs) > 2 else None)
    tol, within = held_by_control(BASELINE_ITEM_TOL, control,
                                  BASELINE_NHR_FWD_CEIL)
    emit({"phase": f"baseline_item_vs_cpu_{fam}", "H": int(item["img"].shape[0]),
          "W": int(item["img"].shape[1]), "max_abs_err": err,
          "tolerance": f"rgb and mask within {tol}",
          "ulp_control_cpu": control, "ceiling": BASELINE_NHR_FWD_CEIL,
          "forward_s": {"cpu": secs[0], "cuda": secs[1]},
          "launches": launches})
    check(within, f"{fam}: the CPU's ulp control {control} passes the ceiling")
    check(max(err.values()) <= tol,
          f"{fam}: the card's item differs from the CPU's by {err}")
    check(not any(launches.values()), f"{fam} launched {launches}")


def matched_step(step, card, cpu, item, control=False):
    """`step` (BaselineTrainer.train_step) of the card's trainer `card` on
    `item`, held at matched weights by the CPU's trainer `cpu`: it takes
    the card's weights and Adam state from before the step, computes the
    loss and the clipped gradient of the same item (with `control`, also
    on the canonical vertices one ulp up), then Adam's update from
    the card's gradient at the card's update count. Returns the card's
    stats, its step's seconds and the comparison."""
    import torch

    from animatable_nerf_tpu_torch.train.optim import CLIP_VALUE

    named = dict(card.model.named_parameters())
    before = {k: v.detach().to("cpu", copy=True)
              for k, v in card.model.state_dict().items()}
    moments = {n: {k: v.detach().to("cpu", copy=True) if torch.is_tensor(v)
                   else v for k, v in card.optimizer.state[p].items()}
               for n, p in named.items() if p in card.optimizer.state}
    updates = card.updates
    t0 = time.time()
    stats = step(card, item)
    secs = time.time() - t0
    card_grad = {n: p.grad.detach().cpu() for n, p in named.items()
                 if p.grad is not None}
    card_after = {n: p.detach().cpu() for n, p in named.items()}
    card_moments = {n: {k: v.detach().cpu() if torch.is_tensor(v) else v
                        for k, v in card.optimizer.state[p].items()}
                    for n, p in named.items() if p in card.optimizer.state}

    cpu_named = dict(cpu.model.named_parameters())
    cpu.model.load_state_dict(before, strict=True)

    def loss_and_grad(it):
        cpu.optimizer.zero_grad(set_to_none=True)
        loss, _ = cpu.loss(cpu.frame(it))
        loss.backward()
        torch.nn.utils.clip_grad_value_(cpu.params, CLIP_VALUE)
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in
                                      cpu_named.items() if p.grad is not None}

    loss_cpu, cpu_grad = loss_and_grad(item)
    if control:
        loss_n, grad_n = loss_and_grad(nudged(item, "tpose"))
        control = {"loss_rel_err": abs(loss_n / loss_cpu - 1),
                   "grad_rel_l2": grad_rel_l2(grad_n, cpu_grad)}
    else:
        control = None
    # Adam from the card's gradient and moments
    cpu.optimizer.state.clear()
    for n, p in cpu_named.items():
        p.grad = card_grad.get(n)
        if n in moments:
            cpu.optimizer.state[p] = moments[n]
    for group in cpu.optimizer.param_groups:
        group["lr"] = cpu.sched(updates)
    cpu.optimizer.step()
    trained = [n for n in cpu_named if n in card_grad]

    def moved(params):
        return {n: params[n].detach() - before[n] for n in trained}

    moment_rel = {k: grad_rel_l2({n: card_moments[n][k] for n in trained},
                                 {n: cpu.optimizer.state[cpu_named[n]][k]
                                  for n in trained})
                  for k in ("exp_avg", "exp_avg_sq")}
    return stats, secs, {
        "step": updates + 1, "loss_cuda": stats["loss"], "loss_cpu": loss_cpu,
        "loss_rel_err": abs(stats["loss"] / loss_cpu - 1),
        "grad_rel_l2": (grad_rel_l2(card_grad, cpu_grad)
                        if set(card_grad) == set(cpu_grad) else math.inf),
        "ulp_control_cpu": control,
        "update_rel_l2": grad_rel_l2(moved(card_after), moved(cpu_named)),
        "moments_rel_l2": moment_rel}


def phase_baseline_train(fam, copy, tmp, k1, knn):
    """BASELINE_TRAIN_STEPS steps of `run_train` on the card from the
    start, each step of BASELINE_MATCHED_STEPS held at matched weights
    (`matched_step`: the loss within TRAIN_LOSS_RTOL and the gradient
    within TRAIN_GRAD_REL of its L2 norm, NHR's by `held_by_control`
    under BASELINE_NHR_LOSS_CEIL and BASELINE_NHR_GRAD_CEIL; Adam's
    update and moments within TRAIN_GRAD_REL); then the port's evaluate of its
    checkpoint, each view's PSNR printed beside the JAX CPU run of the
    same steps (not held: see JAX_PSNR_TRAIN_BASELINE); the card's
    s/step, data ms, and the device ms and idle share of more steps, the
    loss at the first and last step."""
    import torch

    from animatable_nerf_tpu_torch.engine import (
        initial_model, make_dataset, run_evaluate, run_train,
        write_initial_start)
    from animatable_nerf_tpu_torch.train import baseline

    steps = ["train.epoch", "1", "ep_iter", str(BASELINE_TRAIN_STEPS)]
    cfg = baseline_cfg(copy, fam, tmp, f"{fam}_train", extra=steps)
    write_initial_start(cfg)
    cpu = baseline.BaselineTrainer(cfg, initial_model(cfg).train(), "cpu")
    losses, card_s, matched = [], [], []
    step = baseline.BaselineTrainer.train_step

    def recorded(self, item):
        if len(card_s) + 1 in BASELINE_MATCHED_STEPS:
            stats, secs, cmp = matched_step(step, self, cpu, item,
                                            control=fam == "nhr")
            matched.append(cmp)
        else:
            t0 = time.time()
            stats = step(self, item)
            secs = time.time() - t0
        card_s.append(secs)
        losses.append(stats["loss"])
        return stats

    baseline.BaselineTrainer.train_step = recorded
    reset_counts(k1, knn)
    try:
        t0 = time.time()
        trainer, recorder = run_train(cfg, "cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        baseline.BaselineTrainer.train_step = step
    launches = launch_counts(k1, knn)
    steps_done = trainer.step
    item = make_dataset(cfg, "train")[0]

    # NHR's step is some 80,000 launches, which the profiler takes long to
    # aggregate: one step of it, five of NT's
    n_prof = 1 if fam == "nhr" else 5

    def steps():
        for _ in range(n_prof):
            trainer.train_step(item)

    prof = device_breakdown(steps, top=8, host=False)
    res = run_evaluate(baseline_cfg(copy, fam, tmp, f"{fam}_train",
                                    run_type="evaluate"), "cuda")
    jax_psnr = JAX_PSNR_TRAIN_BASELINE[fam]
    psnr = [it["psnr"] for it in res["items"]]
    for m in matched:
        control = m["ulp_control_cpu"] or {}
        m["loss_tol"], loss_ok = held_by_control(
            TRAIN_LOSS_RTOL, control.get("loss_rel_err"), BASELINE_NHR_LOSS_CEIL)
        m["grad_tol"], grad_ok = held_by_control(
            TRAIN_GRAD_REL, control.get("grad_rel_l2"), BASELINE_NHR_GRAD_CEIL)
        m["control_within_ceilings"] = loss_ok and grad_ok
    emit({"phase": f"baseline_train_{fam}", "steps": steps_done,
          "wall_s": wall, "card_s_per_step_mean": float(np.mean(card_s)),
          "card_s_per_step_median": float(np.median(card_s)),
          "data_ms_per_step": recorder.data_time.global_avg * 1e3,
          "profile": {
              "steps": n_prof, "wall_ms_per_step": prof["wall_ms"] / n_prof,
              "device_ms_per_step": None if prof["device_ms"] is None
              else prof["device_ms"] / n_prof, "idle_share": prof["idle_share"],
              "kernels": prof["kernels"]},
          "loss_step_1": losses[0], "loss_step_last": losses[-1],
          "matched": matched,
          "tolerance": "at matched weights: the loss within loss_tol "
          "(relative), the gradient within grad_tol of its L2 norm; Adam's "
          f"update and moments from the card's gradient within {TRAIN_GRAD_REL}",
          "eval_items": res["items"], "jax_psnr_not_held": jax_psnr,
          "delta_psnr_db": [p - ref for p, ref in zip(psnr, jax_psnr)],
          "gain_over_start_db": [p - ref for p, ref in
                                 zip(psnr, JAX_PSNR_BASELINE[fam])],
          "launches": launches})
    check(steps_done == BASELINE_TRAIN_STEPS
          and len(losses) == BASELINE_TRAIN_STEPS
          and all(math.isfinite(v) for v in losses),
          f"baseline_train_{fam}: {steps_done} steps, losses {losses[-3:]}")
    check(not any(launches.values()), f"{fam} launched {launches}")
    check([m["step"] for m in matched] == list(BASELINE_MATCHED_STEPS),
          f"baseline_train_{fam}: matched steps {[m['step'] for m in matched]}")
    for m in matched:
        check(m["control_within_ceilings"]
              and m["loss_rel_err"] <= m["loss_tol"]
              and m["grad_rel_l2"] <= m["grad_tol"]
              and m["update_rel_l2"] <= TRAIN_GRAD_REL
              and max(m["moments_rel_l2"].values()) <= TRAIN_GRAD_REL,
              f"baseline_train_{fam}: step {m['step']} at matched weights: {m}")
    check(len(psnr) == len(jax_psnr) and all(map(math.isfinite, psnr)),
          f"baseline_train_{fam}: PSNR {psnr}")
    return launches


def fps_chain_ms(model, frame):
    """NHR's four furthest-point samplings of one forward (6890 -> 4096 ->
    1024 -> 256 -> 64), alone: wall ms (CUDA events), device ms and
    kernel launches (one profile of the device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from animatable_nerf_tpu_torch.ops import pointnet2 as pn2

    with torch.no_grad():
        pverts, _ = model.posed_vertices(frame)

        def chain():
            xyz = pverts[None]
            for sa in model.pointnet.SA_modules:
                xyz = pn2.gather_points(xyz, pn2.furthest_point_sample(
                    xyz, sa.npoint))
            return xyz

        wall = cuda_ms(chain, warmup=1, iters=1)
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            chain()
            torch.cuda.synchronize()
    events = [e for e in p.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in events)
    device = sum(getattr(e, "device_time_total", 0) or 0 for e in events) / 1e3
    steps = sum(sa.npoint - 1 for sa in model.pointnet.SA_modules)
    return {"wall_ms": wall, "device_ms": device, "kernel_launches": launches,
            "steps": steps, "launches_per_step": launches / steps}


def phase_baseline_full(fam, copy, tmp, k1, knn):
    """One evaluate item and BASELINE_FULL_STEPS train steps at
    1024x1024, full widths, from the start: s per frame and step, device
    ms, idle share, peak memory and the top device ops; NHR's FPS. NT's
    forward is held to the port's CPU forward (within BASELINE_FULL_TOL;
    some 17 s on the CPU). NHR's is checked finite with its mask in
    [0, 1] only: its CPU forward at this size takes minutes (its 128x128
    item is held to the CPU's in phase_baseline_item_vs_cpu)."""
    import torch

    from animatable_nerf_tpu_torch.engine import initial_model, make_dataset
    from animatable_nerf_tpu_torch.train.baseline import BaselineTrainer

    size = 128 * BASELINE_UPSAMPLE
    cfg = baseline_cfg(copy, fam, tmp, f"{fam}_full", size, "evaluate")
    train_cfg = baseline_cfg(copy, fam, tmp, f"{fam}_full", size)
    item = make_dataset(cfg, "test")[0]
    train_item = make_dataset(train_cfg, "train")[0]
    check(item["img"].shape[:2] == (size, size), f"{fam}: {item['img'].shape}")
    reset_counts(k1, knn)
    model = initial_model(cfg).cuda().eval()
    frame = baseline_frame(model, item, "cuda")
    with torch.no_grad():
        model(frame)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = model(frame)
        rgb = out["rgb_map"].cpu()
        mask = out["mask"].cpu()
        s_frame = time.time() - t0
        eval_peak = torch.cuda.max_memory_allocated()
        prof = device_breakdown(lambda: model(frame), top=8, host=False)
    record = {"phase": f"baseline_full_{fam}", "H": size, "W": size,
              "s_per_frame": s_frame, "eval_device_ms": prof["device_ms"],
              "eval_idle_share": prof["idle_share"],
              "eval_top_kernels": prof["kernels"],
              "eval_peak_memory_gib": eval_peak / 2**30}
    if fam == "nhr":
        record["fps_per_forward"] = fps_chain_ms(model, frame)
    else:
        cpu_model = initial_model(cfg).eval()
        t0 = time.time()
        with torch.no_grad():
            want = cpu_model(baseline_frame(cpu_model, item, "cpu"))
        record["cpu_forward_s"] = time.time() - t0
        err = max(float((rgb - want["rgb_map"]).abs().max()),
                  float((mask - want["mask"]).abs().max()))
        record["max_abs_err_vs_cpu"] = err
        check(err <= BASELINE_FULL_TOL, f"{fam}: full frame differs by {err}")
    check(bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(mask).all())
          and float(mask.min()) >= 0 and float(mask.max()) <= 1,
          f"{fam}: the full frame is not finite or its mask leaves [0, 1]")

    trainer = BaselineTrainer(train_cfg, model.train(), "cuda")
    trainer.train_step(train_item)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    losses = [trainer.train_step(train_item)["loss"]
              for _ in range(BASELINE_FULL_STEPS)]
    s_step = (time.time() - t0) / BASELINE_FULL_STEPS
    train_peak = torch.cuda.max_memory_allocated()
    prof = device_breakdown(lambda: trainer.train_step(train_item), top=8,
                            host=False)
    launches = launch_counts(k1, knn)
    record.update({
        "s_per_step": s_step, "train_peak_memory_gib": train_peak / 2**30,
        "train_device_ms": prof["device_ms"],
        "train_idle_share": prof["idle_share"],
        "train_top_kernels": prof["kernels"], "losses": losses,
        "launches": launches})
    emit(record)
    check(all(math.isfinite(v) for v in losses), f"{fam}: losses {losses}")
    check(not any(launches.values()), f"{fam} launched {launches}")
    return launches


def phase_baselines(k1, knn, tmp):
    """Phase 17: the baseline copy (and its 1024x1024 form) in the
    temporary directory `tmp` (phase 22 trains on them too; main deletes
    them), then per family the evaluate, the item and step against the
    CPU, the train run and the full-size phase. Returns the launches of
    each path (all 0) and the two copies."""
    from animatable_nerf_tpu_torch.data.baseline_prep import write_baseline_copy
    from animatable_nerf_tpu_torch.engine import write_initial_start

    paths = {}
    t0 = time.time()
    copy = write_baseline_copy("data/synthetic/capsule",
                               os.path.join(tmp, "capsule"))
    big = write_baseline_copy("data/synthetic/capsule",
                              os.path.join(tmp, "capsule_1024"),
                              upsample=BASELINE_UPSAMPLE)
    emit({"phase": "baseline_copies", "copy_s": time.time() - t0})
    for fam in BASELINES:
        cfg = baseline_cfg(copy, fam, tmp, fam, run_type="evaluate")
        write_initial_start(cfg)
        paths[f"baseline_evaluate_{fam}"] = phase_baseline_evaluate(
            fam, cfg, k1, knn)
        phase_baseline_item_vs_cpu(fam, cfg, k1, knn)
        paths[f"baseline_train_{fam}"] = phase_baseline_train(
            fam, copy, tmp, k1, knn)
        paths[f"baseline_full_{fam}"] = phase_baseline_full(
            fam, big, tmp, k1, knn)
    return paths, (copy, big)


# Phase 18: train-time survivor compaction (`train_keep_frac` > 0). Per-view
# PSNR (frames 0-3, view 3) of the JAX package after one epoch of 50
# compacted steps from the tracked weights with a fresh Adam, perturb 0
# and the ray draw seeded, computed on the CPU with (<f>, <cfg>, <src>:
# aninerf, configs/synthetic.yaml, synthetic; then sdf,
# configs/synthetic_sdf_pdf.yaml, synthetic_sdf_pdf):
#   python -c "from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start as w; w('data/trained_model/deform/<src>/latest.flax', 'data/trained_model/deform/train50_<f>_kf_jax')"
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file <cfg> exp_name train50_<f>_kf_jax train.epoch 1 perturb 0 fix_random True train.num_workers 2 resume True train_keep_frac 0.9
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file <cfg> exp_name train50_<f>_kf_jax
#   python -c "import numpy as np; print(np.load('data/result/deform/train50_<f>_kf_jax/metrics.npy', allow_pickle=True).item()['psnr'])"
# JAX's capacities at 0.9 held every step's survivors (its
# compact_overflow stats were 0 on all 50 steps of both runs); SDF-PDF's
# run read the 64^3 distance grid of its frame store.
JAX_PSNR_TRAIN_COMPACT = {
    "aninerf": [12.317907193214774, 13.114527366629893, 13.21228437992665,
                14.903743959903998],
    "sdf_pdf": [21.103187352721545, 22.830978406957843, 24.091206746979264,
                24.91536959068873],
}
TRAIN_KEEP_FRAC = 0.9
COMPACT_FAMILIES = {  # family: (config, the kernels' launches a step)
    "aninerf": ("configs/synthetic.yaml", {"skip_mlp": 3}),
    "nerf_pdf": ("configs/synthetic_nerf_pdf.yaml",
                 {"skip_mlp": 1, "knn_blend": 1}),
    "sdf_pdf": (TRAIN_SDF_CFG, {"skip_mlp": 2, "knn_blend": 1}),
    "neus_pdf": ("configs/synthetic_neus_pdf.yaml",
                 {"skip_mlp": 2, "knn_blend": 1}),
    **{f"aligned_{f}": (f"configs/synthetic_aligned_{f}.yaml",
                        ALIGNED_PER_STEP[f]) for f in ALIGNED},
}
# the compacted step on the card against the CPU's: the item's first 64
# rays (4,096 points) and a 16^3 grid, since the CPU's plain K3 takes
# some 20 s for the 64^3 grid of the card's steps
COMPACT_CPU_RAYS = 64
COMPACT_CPU_GRID = 16
# held there by the whole gradient (the aligned families as in phase 13).
# NeuS-PDF's displacement field at that size: its observed-space normal
# jumps where a unit lies at its relu kink, which K1's 3xTF32 rounding
# can cross (tests/test_torch_train_pdf_families.py KINK_BAND); with
# 4,096 points such a point moves `resd_linears.6.weight` by 1.5e-2 of
# its largest entry on an H100 (NVIDIA H100 80GB HBM3, 700 W; the whole
# gradient 3.9e-4 of its L2 norm), the dense step at the same size by
# the same 1.5e-2. That dense step runs beside it as the control.
COMPACT_WHOLE_GRADIENT = ("neus_pdf",)
COMPACT_PROFILE_STEPS = 3
COMPACT_WALL_STEPS = 10
COMPACT_GRID_BUILDS = 10


class recorded_rows:
    """Within the block, the rows of the train path's compactions (pass
    1's candidates, then the exact survivors), K2's queries (the filter,
    and the aligned families' canonical prior) and K1's rows, call by
    call."""

    def __enter__(self):
        from animatable_nerf_tpu_torch.fields import mlp
        from animatable_nerf_tpu_torch.models import aligned, aninerf, pdf

        self.compactions, self.k2, self.k1 = [], [], []
        self.patched = []

        def patch(module, name, record):
            real = getattr(module, name)

            def recording(x, *args, **kwargs):
                out = real(x, *args, **kwargs)
                record.append(int((out if name == "compact_indices"
                                   else x).shape[0]))
                return out

            self.patched.append((module, name, real))
            setattr(module, name, recording)

        for module in (pdf, aninerf):
            patch(module, "compact_indices", self.compactions)
        for module in (pdf, aligned):
            patch(module, "sample_blend_closest_points", self.k2)
        patch(mlp, "skip_mlp", self.k1)
        return self

    def __exit__(self, *exc):
        for module, name, real in self.patched:
            setattr(module, name, real)


def step_walls(trainers, batch, n=COMPACT_WALL_STEPS):
    """The median wall (host clock around a step that ends on the host)
    of `n` single train steps of each trainer, taken in turns after one
    warm-up step each: ms by trainer name."""
    import torch

    walls = {name: [] for name in trainers}
    for trainer in trainers.values():
        trainer.train_step(batch)
    for _ in range(n):
        for name, trainer in trainers.items():
            torch.cuda.synchronize()
            t0 = time.time()
            trainer.train_step(batch)  # floats: waits for the device
            walls[name].append((time.time() - t0) * 1e3)
    return {name: float(np.median(w)) for name, w in walls.items()}


def device_steps(trainer, batch, wall_ms, n=COMPACT_PROFILE_STEPS):
    """A device-only profile of `n` train steps: device ms a step, its
    idle share against the step's median wall `wall_ms`, K1's, K2's and
    K3's ms a step, the top kernels."""
    prof = device_breakdown(lambda: [trainer.train_step(batch)
                                     for _ in range(n)], top=5, host=False)
    out = {"wall_ms": wall_ms, "device_ms": None, "idle_share": None}
    if prof["kernels"] is not None:
        own = prof["own_kernels_ms"]
        out.update(device_ms=prof["device_ms"] / n,
                   idle_share=max(0.0, 1.0 - prof["device_ms"] / n / wall_ms),
                   k1_ms=own["skip_mlp_kernel"] / n,
                   k1_bf16_ms=own["skip_mlp_bf16_kernel"] / n,
                   k2_ms=own["knn_blend_kernel"] / n,
                   k3_ms=own["min_dist_kernel"] / n,
                   top=[dict(k, ms=k["ms"] / n) for k in prof["kernels"]])
    return out


def grid_builds(verts, n=COMPACT_GRID_BUILDS):
    """The train frame's 64^3 grid built on `n` fresh copies of its
    vertices (each builds its run layout too, as a frame's first step
    does): the whole build's ms by CUDA events (the copy included), and
    by the profiler its device ms and K3's; and K3's bound at this grid,
    counted as at the 96^3 one (phase 3): the vertices of the runs each
    node's walk must reach (`run_pairs`), 9 operations a pair, against
    each node and vertex read and each distance written once."""
    from animatable_nerf_tpu_torch.ops import knn
    from animatable_nerf_tpu_torch.ops.knn import build_pdist_payload
    from animatable_nerf_tpu_torch.train.trainer import TRAIN_GRID_RES

    fresh = [verts.clone() for _ in range(n)]
    prof = device_breakdown(lambda: [build_pdist_payload(
        v, res=TRAIN_GRID_RES) for v in fresh], top=3, host=False)
    nodes, _, _ = knn.pdist_grid_nodes(verts, TRAIN_GRID_RES)
    n3, m = nodes.shape[0], verts.shape[0]
    _, runs = knn.grid_layout(verts)
    needed = int(run_pairs(nodes, runs, m, kth_sq_dist(nodes, verts, 1)).sum())
    b, by = bound(OPS_PER_PAIR * needed, 4 * (n3 * 3 + m * 3 + n3))
    k3_ms = (None if prof["kernels"] is None
             else prof["own_kernels_ms"]["min_dist_kernel"] / n)
    return {"res": TRAIN_GRID_RES, "builds": n,
            "call_fresh_ms": cuda_ms(lambda: build_pdist_payload(
                verts.clone(), res=TRAIN_GRID_RES)),
            "device_ms": None if prof["kernels"] is None
            else prof["device_ms"] / n,
            "k3_ms": k3_ms, "queries": n3, "vertices": m,
            "pairs_needed": needed, "pairs_needed_per_query": needed / n3,
            "bound_ms": b, "bound_by": by,
            "share_of_bound": None if k3_ms is None else b / k3_ms}


def phase_compaction_step(family, k1, knn):
    """One family's compacted step at its synthetic config (512 rays x 64
    samples, the tracked or composed weights, item 0 seeded): on the
    card the dense step and the compacted one from the same weights,
    their loss, stats and gradients held to each other, the launches of
    the compacted step's first (K3 once: the frame's 64^3 grid) and
    second (K3 none) steps, pass 1's candidates, the survivors, and K2's
    and K1's rows; the compacted step on the card against the CPU
    (`phase_train_step_vs_cpu`, COMPACT_CPU_RAYS rays); and both steps
    timed and profiled. Returns (the compacted step's first launches,
    the row counts)."""
    import torch

    from animatable_nerf_tpu_torch.compat.compose import compose_aligned
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_dataset, make_model
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec
    from animatable_nerf_tpu_torch.train.trainer import (
        Trainer, collate_rays, stack_batch)

    cfg_file, per_step = COMPACT_FAMILIES[family]
    aligned = family.startswith("aligned_")
    keep = ["perturb", "0", "train_keep_frac", str(TRAIN_KEEP_FRAC)]
    cfgs = {"dense": load_config(cfg_file, keep[:2]),
            "compacted": load_config(cfg_file, keep)}
    params = (compose_aligned(family[len("aligned_"):]) if aligned else
              read_checkpoint(os.path.join(
                  "data/trained_model", cfgs["dense"].task,
                  cfgs["dense"].exp_name, "latest.flax"))["params"])
    state_dict = param_codec(make_model(cfgs["dense"]))[0](params)
    ds = make_dataset(cfgs["dense"], "train")
    ds._rng = np.random.RandomState(0)
    item = ds[0]
    n_rays = int(cfgs["dense"].N_rand)
    batch = stack_batch([collate_rays(item, n_rays)])
    knn_family = family != "aninerf"
    first_want = dict(per_step, **({"min_dist": 1} if knn_family else {}))

    steps, trainers = {}, {}
    for path, cfg in cfgs.items():
        model = make_model(cfg)
        model.load_state_dict(state_dict)
        trainer = trainers[path] = Trainer(cfg, model.to("cuda"), "cuda")
        runs = []
        for _ in range(2):  # the frame's first step, then its second
            reset_counts(k1, knn)
            with recorded_rows() as rows:
                out = train_step_grads(trainer, batch)
            torch.cuda.synchronize()
            runs.append((out, launch_counts(k1, knn), rows))
        steps[path] = runs
    (d_loss, d_stats, d_grads), d_first, _ = steps["dense"][0]
    (c_loss, c_stats, c_grads), c_first, c_rows = steps["compacted"][0]
    c_second = steps["compacted"][1][1]
    rel = {n: (c_grads[n] - g).abs().max().item()
           / max(g.abs().max().item(), 1e-30) for n, g in d_grads.items()}
    worst = max(rel, key=rel.get)
    stats_rel = {k: abs(c_stats[k] / v - 1) if v else abs(c_stats[k])
                 for k, v in d_stats.items()}
    survivors = c_rows.compactions[-1]
    candidates = c_rows.compactions[0] if len(c_rows.compactions) > 1 else None
    row_counts = {"points": n_rays * int(cfgs["dense"].N_samples),
                  "pass1_candidates": candidates, "survivors": survivors,
                  "k2_rows": c_rows.k2, "k1_rows": c_rows.k1,
                  "dense_k2_rows": steps["dense"][0][2].k2,
                  "dense_k1_rows": steps["dense"][0][2].k1}
    row_counts["survivor_share"] = survivors / row_counts["points"]

    # the card's compacted step against the CPU's, at COMPACT_CPU_RAYS
    small = ["N_rand", str(COMPACT_CPU_RAYS)]
    cpu_batch = stack_batch([collate_rays(item, COMPACT_CPU_RAYS)])
    whole = aligned or family in COMPACT_WHOLE_GRADIENT
    rtol = ALIGNED_LOSS_RTOL.get(family[len("aligned_"):], TRAIN_LOSS_RTOL)
    phase_train_step_vs_cpu(
        f"compaction_{family}_step_vs_cpu", load_config(cfg_file, keep + small + [
            "knn_grid_res", str(COMPACT_CPU_GRID)]), state_dict, cpu_batch,
        k1, knn, first_want, whole_gradient=whole, loss_rtol=rtol)
    if family in COMPACT_WHOLE_GRADIENT:
        phase_train_step_vs_cpu(
            f"compaction_{family}_dense_control_vs_cpu",
            load_config(cfg_file, keep[:2] + small), state_dict, cpu_batch,
            k1, knn, per_step, whole_gradient=True, loss_rtol=rtol)

    # K3 alone: the 64^3 grid on fresh copies of the frame's vertices
    row_counts["grid_build"] = (grid_builds(trainers["compacted"]._frame(
        {k: v[0] for k, v in batch.items()})["pvertices"])
        if knn_family else None)
    walls = step_walls(trainers, batch)
    emit({"phase": f"compaction_{family}", "config": cfg_file, "opts": keep,
          "rays": n_rays, "samples": int(cfgs["dense"].N_samples),
          "loss_dense": d_loss, "loss_compacted": c_loss,
          "loss_rel_err": abs(c_loss / d_loss - 1), "stats_rel_err": stats_rel,
          "grad_max_rel_err": rel[worst], "grad_worst_leaf": worst,
          "launches": {"dense": d_first, "compacted_first": c_first,
                       "compacted_second": c_second},
          **row_counts,
          **{path: device_steps(trainer, batch, walls[path])
             for path, trainer in trainers.items()},
          "tolerance": f"loss and stats rtol {rtol}, each gradient leaf "
          f"max |d| <= {TRAIN_GRAD_REL} x its max |g| (the dense step on "
          "the card)"})
    dense_want = {k: per_step.get(k, 0) for k in d_first}
    check(d_first == dense_want
          and c_first == {k: first_want.get(k, 0) for k in c_first}
          and c_second == dense_want,
          f"compaction_{family}: launches dense {d_first}, compacted "
          f"{c_first} then {c_second}")
    check(len(c_rows.compactions) == (2 if knn_family else 1)
          and 0 < survivors < row_counts["points"]
          and (candidates is None or survivors <= candidates)
          and c_rows.k2[:1] == ([candidates] if knn_family else [])
          and len(c_rows.k1) == per_step.get("skip_mlp", 0)
          and all(n == survivors for n in c_rows.k1),
          f"compaction_{family}: rows {row_counts}")
    check(all(v <= rtol for v in stats_rel.values()),
          f"compaction_{family}: stats differ from the dense step: {stats_rel}")
    check(rel[worst] <= TRAIN_GRAD_REL and all(
        bool(g.isfinite().all()) for g in c_grads.values()),
          f"compaction_{family}: gradient {worst} {rel[worst]} of its scale")
    return c_first, row_counts


def phase_compaction(k1, knn):
    """Phase 18: every family's compacted step (`phase_compaction_step`),
    then 50 compacted steps of SDF-PDF and of AniNeRF, each evaluate held
    to the JAX CPU run of the same steps. Returns the launches of each
    path and the row counts by family."""
    from animatable_nerf_tpu_torch.engine import make_dataset
    from animatable_nerf_tpu_torch.train.trainer import _FRAME_CACHE

    t0 = time.time()
    paths, rows = {}, {}
    for family in COMPACT_FAMILIES:
        paths[f"compaction_step_{family}"], rows[family] = (
            phase_compaction_step(family, k1, knn))
    for family, jax_psnr in JAX_PSNR_TRAIN_COMPACT.items():
        cfg_file, per_step = COMPACT_FAMILIES[family]
        exp = f"chip_smoke_train_compact_{family}"
        opts = (["exp_name", exp] + TRAIN_OPTS[2:]
                + ["train_keep_frac", str(TRAIN_KEEP_FRAC)])
        run = train_and_evaluate(cfg_file, opts, exp, jax_psnr, k1, knn)
        cfg, trainer, _, launches, _, _, _ = run
        summary = train_summary(*run, jax_psnr)
        ds = make_dataset(cfg, "train")
        # K3 once for each frame the trainer uploads
        frames = len(ds) // ds.num_cams if family != "aninerf" else 0
        emit({"phase": f"train_compact_{family}", "config": cfg_file,
              "opts": opts, **summary,
              "launches_per_step": {k: v / trainer.step
                                    for k, v in launches.items()},
              "grid_builds": launches["min_dist"], "frames": frames})
        want = {k: per_step.get(k, 0) * summary["steps"] for k in launches}
        check(frames <= _FRAME_CACHE and launches == dict(want, min_dist=frames),
              f"train_compact_{family}: launched {launches} over {frames} "
              "frames")
        check_train(f"train_compact_{family}", dict(summary, launches={
            k: v for k, v in launches.items() if k != "min_dist"}), per_step)
        paths[f"train_compact_{family}"] = launches
    emit({"phase": "compaction", "phase_seconds": time.time() - t0,
          "survivor_share": {f: r["survivor_share"] for f, r in rows.items()}})
    return paths, rows


# Phase 19: the host pipeline and the rest of the CLI. The read-ahead
# train runs use phase 12's real-camera copy at 1024x1024 (AniNeRF's
# novel-pose config, the synthetic_2f weights, fix_random): 20 steps at
# `train.num_workers` 2 (one reader thread) and 8 (four).
HOST_TRAIN_STEPS = 20
HOST_THREADS = {1: "2", 4: "8"}  # reader threads: train.num_workers
LIGHT_STAGE_POINTS = 100_000
LPIPS_FULL = (FULL_H, FULL_W)  # the pair timed at full size


class recorded_steps:
    """Within the block, each `Trainer.train_step`'s batch digest (SHA-1
    over its arrays, keys in order) and loss, step by step."""

    def __enter__(self):
        import hashlib

        from animatable_nerf_tpu_torch.train.trainer import Trainer

        self.digests, self.losses = [], []
        self.real = real = Trainer.train_step

        def recording(trainer, batch):
            h = hashlib.sha1()
            for k in sorted(batch):
                h.update(k.encode())
                h.update(np.ascontiguousarray(batch[k]).tobytes())
            self.digests.append(h.hexdigest())
            stats = real(trainer, batch)
            self.losses.append(stats["loss"])
            return stats

        Trainer.train_step = recording
        return self

    def __exit__(self, *exc):
        from animatable_nerf_tpu_torch.train.trainer import Trainer

        Trainer.train_step = self.real


def host_train_runs(k1, knn, big):
    """`run_train` on the copy at 1024x1024 from one fresh start, at one
    and at four reader threads: per run s/step, data s/step (the wait
    for the next item), the device's idle share over the run (a
    device-only profile), K1's launches, each step's batch digest and
    loss. Returns (records by thread count, launches by path)."""
    import torch

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.data.distorted_copy import config_opts
    from animatable_nerf_tpu_torch.engine import run_train
    from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start

    ckpt = "data/trained_model/deform/synthetic_2f/latest.flax"
    runs, paths = {}, {}
    for threads, workers in HOST_THREADS.items():
        cfg = load_config(NOVEL_POSE_CFG, config_opts(big) + [
            "exp_name", f"chip_smoke_host_{threads}", "train.epoch", "1",
            "ep_iter", str(HOST_TRAIN_STEPS), "train.num_workers", workers]
            + TRAIN_OPTS[4:])
        write_fresh_start(ckpt, cfg.trained_model_dir)
        out = {}

        def train():
            out["trainer"], out["recorder"] = run_train(cfg, "cuda")

        reset_counts(k1, knn)
        with recorded_steps() as steps:
            prof = device_breakdown(train, top=3, host=False)
        torch.cuda.synchronize()
        paths[f"train_read_ahead_{threads}"] = launches = launch_counts(k1, knn)
        rec = out["recorder"]
        runs[threads] = {
            "threads": threads, "train.num_workers": int(workers),
            "steps": out["trainer"].step, "wall_s": prof["wall_ms"] / 1e3,
            "s_per_step_mean": rec.batch_time.global_avg,
            "s_per_step_median": rec.batch_time.median,
            "data_s_per_step_mean": rec.data_time.global_avg,
            "data_s_per_step_median": rec.data_time.median,
            "device_ms": prof["device_ms"], "idle_share": prof["idle_share"],
            "launches": launches, "losses": steps.losses,
            "digests": steps.digests}
    return runs, paths


def phase_host_pipeline(k1, knn):
    """Phase 19: the read-ahead loader on the train path (one and four
    reader threads: the same batches, bit for bit, and the same losses),
    the pipelined evaluate with `eval_timing`, and `--type dataset`,
    `network` (with a trace), `evaluate_nv`, `lpips` and `light_stage`.
    Returns the launches of each path that runs a kernel."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from animatable_nerf_tpu_torch import run
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.data.distorted_copy import write_distorted_copy
    from animatable_nerf_tpu_torch.data.occupancy import (
        BB_MAX, BB_MIN, RES, get_scaled_model)
    from animatable_nerf_tpu_torch.engine import (
        Engine, make_dataset, run_evaluate_external)
    from animatable_nerf_tpu_torch.evaluators import lpips
    from animatable_nerf_tpu_torch.data.loader import make_test_loader

    t_phase = time.time()
    tmp = tempfile.mkdtemp(prefix="host_pipeline_")
    try:
        # ---- training, read ahead
        t0 = time.time()
        big = write_distorted_copy("data/synthetic/human",
                                   os.path.join(tmp, "human_1024"),
                                   upsample=CAMERA_UPSAMPLE)
        copy_s = time.time() - t0
        runs, paths = host_train_runs(k1, knn, big)
        one, four = runs[1], runs[4]
        same_batches = one["digests"] == four["digests"]
        same_losses = one["losses"] == four["losses"]
        emit({"phase": "host_train_read_ahead", "copy_s": copy_s,
              "source_frame": [128 * CAMERA_UPSAMPLE] * 2,
              "runs": [{k: v for k, v in r.items() if k != "digests"}
                       for r in runs.values()],
              "batches_equal": same_batches, "losses_equal": same_losses,
              "data_s_per_step_4_over_1": four["data_s_per_step_mean"]
              / one["data_s_per_step_mean"]})
        for r in runs.values():
            check(r["steps"] == HOST_TRAIN_STEPS
                  and r["launches"]["skip_mlp"] == 3 * HOST_TRAIN_STEPS
                  and all(math.isfinite(x) for x in r["losses"]),
                  f"host_train_read_ahead: {r['threads']} threads ran "
                  f"{r['steps']} steps, launches {r['launches']}")
        check(same_batches and len(one["digests"]) == HOST_TRAIN_STEPS,
              "host_train_read_ahead: the batches differ between 1 and 4 "
              "reader threads")
        check(same_losses, "host_train_read_ahead: the losses differ between "
              f"1 and 4 reader threads: {one['losses']} {four['losses']}")

        # ---- the pipelined evaluate with eval_timing (phase 4's)
        cfg = load_config("configs/synthetic.yaml", [
            "eval_timing", "True", "result_dir", os.path.join(tmp, "result")],
            run_type="evaluate")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            launches, _ = phase_evaluate("evaluate_pipelined", cfg, JAX_PSNR,
                                         k1, knn)
        lines = printed.getvalue().splitlines()
        timing = [json.loads(l)["eval_timing_per_frame"] for l in lines
                  if l.startswith('{"eval_timing_per_frame"')]
        pipeline = [l for l in lines if l.startswith("eval pipeline:")]
        for line in lines:  # phase_evaluate's own line, and the engine's
            print(line, flush=True)
        paths["evaluate_pipelined"] = launches
        items = EVAL_ITEMS["evaluate_pipelined"]
        emit({"phase": "eval_timing", "eval_timing_per_frame": timing,
              "pipeline": pipeline})
        check(len(timing) == 1 and len(pipeline) == 1
              and timing[0]["n_items"] == len(JAX_PSNR)
              and timing[0]["device_ms"] > 0
              and "relay_floor_s" not in timing[0]
              and launches["skip_mlp"] > 0,
              f"eval_timing: {timing} {pipeline} {launches}")

        # ---- --type dataset
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            n = run.main(["--type", "dataset", "--cfg_file",
                          "configs/synthetic.yaml"])
        dataset_s = time.time() - t0

        # ---- --type network with a trace: K1's launches against the
        # same frames rendered by render_item
        trace_dir = os.path.join(tmp, "trace")
        reset_counts(k1, knn)
        t0 = time.time()
        mean = run.main(["--type", "network", "--cfg_file",
                         "configs/synthetic.yaml", "profile_dir", trace_dir])
        network_s = time.time() - t0
        paths["network"] = net = launch_counts(k1, knn)
        ecfg = load_config("configs/synthetic.yaml", [])
        eng = Engine(ecfg, "cuda")
        eng.load_params()
        ds = make_dataset(ecfg, "test")
        frames = list(make_test_loader(ecfg, ds))[:10]
        reset_counts(k1, knn)
        for item in frames:
            eng.render_item(item)
        torch.cuda.synchronize()
        direct = launch_counts(k1, knn)
        del eng
        traces = os.listdir(trace_dir)
        trace_mb = sum(os.path.getsize(os.path.join(trace_dir, f))
                       for f in traces) / 1e6

        # ---- --type evaluate_nv on the evaluate's comparison PNGs
        nv = run_evaluate_external(load_config(
            "configs/synthetic.yaml", ["result_dir", os.path.join(tmp, "result")],
            run_type="evaluate"))
        nv_items = np.load(os.path.join(cfg.result_dir, "metrics.npy"),
                           allow_pickle=True).item()
        # |d PSNR| from an error below 1/255 a channel (the PNG's
        # truncation): at most 20 log10(1 + (1/255) / rmse)
        nv_rows = []
        for it, psnr in zip(items, nv_items["psnr"]):
            rmse = min(10 ** (-it["psnr"] / 20), 10 ** (-psnr / 20))
            nv_rows.append({"psnr_evaluate": it["psnr"], "psnr_nv": psnr,
                            "delta_db": psnr - it["psnr"],
                            "bound_db": 20 * math.log10(1 + (1 / 255) / rmse)})

        # ---- --type lpips: seeded alex weights, on the card and the CPU
        params = lpips.random_params("alex", seed=0)
        weights = os.path.join(tmp, "lpips_alex.npz")
        np.savez(weights, arch="alex", **{k: v.numpy() for k, v in
                                          params.items() if k != "arch"})
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            card = run.main(["--type", "lpips", "--cfg_file",
                             "configs/synthetic.yaml", "result_dir",
                             os.path.join(tmp, "result"),
                             "lpips_weights", weights])
            lpips_s = time.time() - t0
            cpu = lpips.score_comparison_dir(cfg.result_dir, weights,
                                             device="cpu")
        lpips_err = max(abs(a - b) for a, b in zip(card["lpips"], cpu["lpips"]))
        gen = torch.Generator(device="cuda").manual_seed(0)
        pair = [torch.rand(1, *LPIPS_FULL, 3, device="cuda", generator=gen)
                for _ in range(2)]
        cuda_params = {k: (v.cuda() if torch.is_tensor(v) else v)
                       for k, v in params.items()}
        with torch.no_grad():
            pair_ms = cuda_ms(lambda: lpips.lpips_distance(cuda_params, *pair),
                              warmup=1, iters=5)

        # ---- --type light_stage on a seeded binary PLY
        root = os.path.join(tmp, "light_stage")
        os.makedirs(os.path.join(root, "point_cloud", "s"))
        rng = np.random.RandomState(0)
        pts = (rng.randn(LIGHT_STAGE_POINTS, 3) * [0.25, 0.8, 0.15]
               + [0.1, 1.0, -0.3]).astype(np.float32)
        with open(os.path.join(root, "point_cloud", "s", "0.ply"), "wb") as f:
            f.write(("ply\nformat binary_little_endian 1.0\nelement vertex "
                     f"{len(pts)}\nproperty float x\nproperty float y\n"
                     "property float z\nend_header\n").encode())
            f.write(pts.tobytes())
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            (written,) = run.main(["--type", "light_stage", "--cfg_file",
                                   "configs/synthetic.yaml",
                                   "train_dataset.data_root", root])
        light_s = time.time() - t0
        with np.load(written) as z:
            grid = np.unpackbits(z["compressed_occupancies"]).reshape((RES,) * 3)
        # the numpy floor reference: cells half a step below each node
        model, _ = get_scaled_model(pts)
        step = (BB_MAX - BB_MIN) / (RES - 1)
        lo = np.float32(BB_MIN - step / 2)
        scale = np.float32(RES) / (np.float32(BB_MAX + step / 2) - lo)
        idx = np.floor((model - lo) * scale).astype(np.int64)
        idx = idx[((idx >= 0) & (idx < RES)).all(1)]
        ref = np.zeros((RES,) * 3, np.uint8)
        ref[idx[:, 0], idx[:, 1], idx[:, 2]] = 1

        emit({"phase": "run_types",
              "dataset": {"items": n, "s": dataset_s, "it_per_s": n / dataset_s},
              "network": {"mean_forward_s": mean, "wall_s": network_s,
                          "frames": len(frames), "launches": net,
                          "launches_render_item": direct,
                          "trace_files": len(traces), "trace_mb": trace_mb},
              "evaluate_nv": {"psnr_mean": nv["psnr"], "views": nv_rows},
              "lpips": {"pairs": len(card["names"]), "mean": card["mean"],
                        "max_abs_err_vs_cpu": lpips_err, "wall_s": lpips_s,
                        "pair_ms_full": pair_ms, "full_size": list(LPIPS_FULL)},
              "light_stage": {"points": len(pts), "occupied": int(grid.sum()),
                              "occupied_ref": int(ref.sum()),
                              "cells_differing": int((grid != ref).sum()),
                              "wall_s": light_s}})
        check(n == 20, f"dataset iterated {n} items")
        check(mean > 0 and net == direct and net["skip_mlp"] > 0
              and len(traces) == 1 and trace_mb > 0,
              f"network: launches {net} against render_item's {direct}, "
              f"traces {traces}")
        check(len(nv_rows) == len(items) and all(
            abs(r["delta_db"]) <= r["bound_db"] for r in nv_rows),
              f"evaluate_nv: {nv_rows}")
        check(lpips_err <= 1e-5 and len(card["names"]) == len(JAX_PSNR),
              f"lpips: card against CPU {lpips_err}")
        check(int((grid != ref).sum()) == 0 and grid.sum() > 1000,
              "light_stage: the occupancy differs from the numpy reference")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "host_pipeline", "phase_seconds": time.time() - t_phase})
    return paths


# ---- phase 20: the evaluation options
# Per-view PSNR (frames 0-3, view 3) of the JAX package's evaluates with
# each option, computed on the CPU as JAX_PSNR's (the metrics.npy of
# each run), with the option added:
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic.yaml compute_dtype bfloat16
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_sdf_pdf.yaml compute_dtype bfloat16
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic.yaml use_importance True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_sdf_pdf.yaml use_importance True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic_neus_pdf.yaml use_importance True
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file configs/synthetic.yaml slab_filter 8 slab_box_capacity 2048
# (about 2, 5, 6, 27, 26 and 2 min on the CPU, two at a time).
JAX_PSNR_BF16 = [7.659306805589303, 7.57391872921992, 8.058705345492855,
                 9.422306090147135]
JAX_PSNR_BF16_SDF = [19.846270759943337, 22.100835056894965,
                     23.787624394011576, 24.988880770616596]
JAX_PSNR_IMPORTANCE = {
    "aninerf": [7.654412079611278, 7.563348142283794, 8.041916327702605,
                9.40486019002475],
    "sdf_pdf": [8.960980030508079, 10.263170974793292, 11.553656491291152,
                13.247235821442432],
    "neus_pdf": [20.721092236570733, 22.90968500427176, 24.100641664713176,
                 24.847191334410635],
}
JAX_PSNR_SLAB = [7.655750694805134, 7.5696494082365495, 8.05470772363299,
                 9.417616795213712]
# K1's bf16 form against its plain bf16 version: two bf16 steps of the
# output's largest value (both round every layer to bf16; a float32 sum
# in another order moves a product across a rounding boundary, and the
# next layers carry it)
K1_BF16_REL_TOL = 2e-2
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
# JAX's guard of its bf16 render against float32 (bench.py:272-292)
BF16_RGB_GUARD = 0.02
# the synthetic subject's distance volume at norm_th 0.25 has 1,412
# occupied supercells: the default list of 1,024 overflows and keeps
# every segment, so the slab phase takes a list that holds them
SLAB_OPTS = ["slab_filter", "8", "slab_box_capacity", "2048"]
SLAB_RTOL, SLAB_ATOL = 1e-4, 1e-5  # JAX tests/test_render.py:364-366
# family: (config, the kernels' launches a tile of one pass)
IMPORTANCE = {
    "aninerf": ("configs/synthetic.yaml", {"skip_mlp": 2}),
    "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml",
                {"skip_mlp": 1, "knn_blend": 1}),
    "neus_pdf": ("configs/synthetic_neus_pdf.yaml",
                 {"skip_mlp": 1, "knn_blend": 1}),
}


def ptxas_of(log, kernel):
    """ptxas's lines about `kernel` in a build log."""
    lines, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = kernel + "E" in line
        if on and ("registers" in line or "spill" in line
                   or "Performance Loss" in line):
            lines.append(line.strip())
    return lines


def spill_bytes(ptxas_lines):
    """Spill stores plus spill loads, in bytes, from ptxas's lines."""
    return sum(int(m) for line in ptxas_lines
               for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))


def k1_bf16_case(k1, wiring, n_rows, gen, tag=""):
    """One wiring of K1's bf16 form at `n_rows` rows (inputs drawn from
    `gen`) against its plain bf16 version, timed with its bound, the
    bf16 addmm chain and the float32 form. Returns (the row, and x, the
    layers, the bf16 pack and the call's keywords for more timings)."""
    import torch

    name, din, dims, skips, act_last = wiring
    x = (torch.rand(n_rows, din, device="cuda", generator=gen) * 2
         - 1).to(torch.bfloat16)
    layers = [
        (torch.randn(i, o, device="cuda", generator=gen) / math.sqrt(i),
         torch.randn(o, device="cuda", generator=gen) * 0.1)
        for i, o in dims
    ]
    wb = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in layers]
    kwargs = dict(skips=skips, act="relu", act_last=act_last)

    def library():
        h = x
        for j, (w, b) in enumerate(wb):
            h = torch.addmm(b, h, w)
            if j < len(wb) - 1 or act_last:
                h = torch.relu_(h)
                if j in skips and j < len(wb) - 1:
                    h = torch.cat([x, h], dim=-1)
        return h

    before = k1.skip_mlp.launches_bf16
    got = k1.skip_mlp(x, layers, **kwargs)  # packs the weights itself
    torch.cuda.synchronize()
    check(k1.skip_mlp.launches_bf16 == before + 1,
          f"K1 bf16 {tag}{name}: the bf16 kernel was not launched")
    ref = k1.skip_mlp_plain(x, layers, **kwargs)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(math.isfinite(err) and err <= K1_BF16_REL_TOL * max(scale, 1.0),
          f"K1 bf16 {tag}{name}: max abs err {err} vs output scale {scale}")
    packed = k1.pack_layers(layers, skips, dtype=torch.bfloat16)
    times = timed_pair(lambda: k1.skip_mlp(x, layers, packed=packed, **kwargs),
                       lambda: k1.skip_mlp_plain(x, layers, **kwargs),
                       library, plain_iters=10)
    x32 = x.float()
    packed32 = k1.pack_layers(layers, skips)
    f32_ms = cuda_ms(lambda: k1.skip_mlp(x32, layers, packed=packed32,
                                         **kwargs))
    flops = 2 * n_rows * sum(i * o for i, o in dims)
    nbytes = (2 * n_rows * din + 4 * n_rows * dims[-1][1]
              + sum(2 * i * o + 4 * o for i, o in dims))
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    row = {
        "wiring": name, "rows": n_rows, "din": din,
        "dout": dims[-1][1], "layers": len(dims),
        "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
        "tol_abs": K1_BF16_REL_TOL * max(scale, 1.0), **times,
        "flops": flops, "bytes": nbytes,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "share_of_bound": bound_ms / times["kernel_ms"],
        "kernel_tflops": flops / (times["kernel_ms"] * 1e-3) / 1e12,
        "f32_kernel_ms": f32_ms,
    }
    return row, (x, layers, packed, kwargs)


def phase_k1_bf16(k1, n_rows=K1_ROWS):
    """K1's bf16 form against its plain bf16 version at `n_rows` rows of
    each wiring (`k1_bf16_case`), with the bytes its weight stream reads
    from L2 a call (every 128-row tile streams the packed stack once: no
    tile shares a chunk), the rate that implies, and the rate of the
    stream alone (`weight_stream_bf16`: the kernel's ring on its grid,
    no products). Returns one row per wiring."""
    import torch
    from animatable_nerf_tpu_torch.ops import build

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for wiring in k1_wirings():
        row, (_, _, packed, _) = k1_bf16_case(k1, wiring, n_rows, gen)
        l2_bytes = k1.weight_stream_bf16(n_rows, packed, "cuda")
        stream_ms = cuda_ms(lambda: k1.weight_stream_bf16(n_rows, packed, "cuda"))
        row.update(l2_bytes=l2_bytes,
                   l2_tbps_implied=l2_bytes / (row["kernel_ms"] * 1e-3) / 1e12,
                   l2_stream_ms=stream_ms,
                   l2_stream_tbps=l2_bytes / (stream_ms * 1e-3) / 1e12)
        rows.append(row)
    ptxas = ptxas_of(build.build_log("skip_mlp"), "skip_mlp_bf16_kernel")
    sass = sass_counts(build.library_path("skip_mlp"))
    emit({"phase": "k1_bf16_vs_plain", "tolerance": (
        f"max abs err <= {K1_BF16_REL_TOL} x max(1, max |plain|): bf16 "
        "products summed in float32 in another order, each layer rounded "
        "to bf16"),
          "bound": "max(FLOP / 989 TFLOP/s (bf16), bytes / 3.35 TB/s)",
          "library": "torch.addmm + relu + cat in bf16",
          "ptxas": ptxas, "spill_bytes": spill_bytes(ptxas),
          "serialized": any("Performance Loss" in line for line in ptxas),
          "hgmma": (sass or {}).get("skip_mlp_bf16_kernel", {}).get("HGMMA"),
          "sass": sass, "wirings": rows,
          "total_ms": sum(r["kernel_ms"] for r in rows),
          "total_bound_ms": sum(r["bound_ms"] for r in rows),
          "total_f32_ms": sum(r["f32_kernel_ms"] for r in rows),
          "total_library_ms": sum(r["library_ms"] for r in rows)})
    check(spill_bytes(ptxas) == 0 and not any(
        "Performance Loss" in line for line in ptxas),
          f"K1 bf16: ptxas spills or serializes: {ptxas}")
    return rows


def eval_views(cfg_file, opts_by_name):
    """Each eval view of `cfg_file` rendered by an engine on the card per
    entry of `opts_by_name` (name: extra opts), in turns: {name: [(maps,
    stats), ...]}."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.data.loader import eval_indices
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset

    engines = {}
    for name, opts in opts_by_name.items():
        cfg = load_config(cfg_file, list(opts), run_type="evaluate")
        cfg.eval = True
        engines[name] = Engine(cfg, "cuda")
        engines[name].load_params()
    ds = make_dataset(cfg, "test")
    out = {name: [] for name in engines}
    for i in eval_indices(cfg, ds):
        item = ds[i]
        for name, eng in engines.items():
            maps, _ = eng.render_item(item)
            out[name].append((maps, dict(eng.stats)))
    return out


def phase_bf16(k1, knn):
    """compute_dtype bfloat16: the AniNeRF and SDF-PDF evaluates held to
    the JAX bf16 PSNR, each view against the port's float32 view, and
    one 1000x1002 AniNeRF frame in bf16 beside float32. Returns the
    paths' launches."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset

    bf16 = ["compute_dtype", "bfloat16"]
    paths = {}
    for name, cfg_file, jax_psnr in (
            ("evaluate_bf16", "configs/synthetic.yaml", JAX_PSNR_BF16),
            ("evaluate_bf16_sdf_pdf", "configs/synthetic_sdf_pdf.yaml",
             JAX_PSNR_BF16_SDF)):
        cfg = load_config(cfg_file, bf16, run_type="evaluate")
        launches, _ = phase_evaluate(name, cfg, jax_psnr, k1, knn)
        check(launches["skip_mlp_bf16"] > 0 and launches["skip_mlp"] == 0,
              f"{name} launched {launches}")
        paths[name] = launches
        views = eval_views(cfg_file, {"f32": [], "bf16": bf16})
        deltas = [float(np.abs(a[0]["rgb_map"] - b[0]["rgb_map"]).max())
                  for a, b in zip(views["f32"], views["bf16"])]
        same = [a[1]["n_survivors"] == b[1]["n_survivors"]
                for a, b in zip(views["f32"], views["bf16"])]
        emit({"phase": f"{name}_vs_f32", "max_rgb_delta": deltas,
              "guard": BF16_RGB_GUARD, "same_survivors": same})
        check(all(0 < d <= BF16_RGB_GUARD for d in deltas) and all(same),
              f"{name}: rgb deltas {deltas} against float32, survivors {same}")
    cfg = load_config("configs/synthetic.yaml", [], run_type="evaluate")
    ds = make_dataset(cfg, "test")
    item = full_frame_item(ds, ds[0])
    share = {}
    for name, opts in (("full_frame_f32", []), ("full_frame_bf16", bf16),
                       ("full_frame_f32_again", [])):
        c = load_config("configs/synthetic.yaml", opts, run_type="evaluate")
        c.eval = True
        eng = Engine(c, "cuda")
        eng.load_params()
        launches, _ = phase_full_frame(name, eng, item, k1, knn)
        prof = FRAME_PROFILES[name]
        kernel = "skip_mlp_bf16_kernel" if opts else "skip_mlp_kernel"
        if prof["kernels"] is not None:
            share[name] = {"device_ms": prof["device_ms"],
                           "k1_ms": prof["own_kernels_ms"][kernel],
                           "k1_share": prof["own_kernels_ms"][kernel]
                           / prof["device_ms"]}
        want = "skip_mlp_bf16" if opts else "skip_mlp"
        check(launches[want] == 2 * eng.stats["tiles"]
              and launches["skip_mlp" if opts else "skip_mlp_bf16"] == 0,
              f"{name} launched {launches} over {eng.stats['tiles']} tiles")
        if name != "full_frame_f32_again":
            paths[name] = launches
        del eng
    emit({"phase": "full_frame_bf16_vs_f32", "k1_share": share})
    return paths


def phase_importance(k1, knn):
    """use_importance: the AniNeRF, SDF-PDF and NeuS-PDF evaluates held to
    the JAX PSNR, with K1 and K2 launched a tile on both passes. Returns
    the paths' launches."""
    from animatable_nerf_tpu_torch.config import load_config

    paths = {}
    for family, (cfg_file, per_tile) in IMPORTANCE.items():
        name = f"evaluate_importance_{family}"
        cfg = load_config(cfg_file, ["use_importance", "True"],
                          run_type="evaluate")
        launches, _ = phase_evaluate(name, cfg, JAX_PSNR_IMPORTANCE[family],
                                     k1, knn)
        tiles = sum(it["tiles"] for it in EVAL_ITEMS[name])
        emit({"phase": f"{name}_launches", "tiles": tiles,
              "per_tile_both_passes": {k: launches[k] / tiles
                                       for k in per_tile}})
        check(all(launches[k] == 2 * n * tiles for k, n in per_tile.items()),
              f"{name} launched {launches} over {tiles} tiles")
        paths[name] = launches
    return paths


def phase_slab(k1, knn):
    """AniNeRF's slab pre-filter: the evaluate held to the JAX PSNR and,
    view by view, to the flat render; one 1000x1002 frame beside the
    flat one; and SDF-PDF with seg_filter 4, which renders as without
    it. Returns the paths' launches."""
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset

    cfg = load_config("configs/synthetic.yaml", SLAB_OPTS, run_type="evaluate")
    launches, _ = phase_evaluate("evaluate_slab", cfg, JAX_PSNR_SLAB, k1, knn)
    paths = {"evaluate_slab": launches}
    views = eval_views("configs/synthetic.yaml",
                       {"flat": [], "slab": SLAB_OPTS})
    diffs, counts = [], []
    for (flat, fs), (slab, ss) in zip(views["flat"], views["slab"]):
        for k in ("rgb_map", "acc_map", "depth_map"):
            np.testing.assert_allclose(slab[k], flat[k], rtol=SLAB_RTOL,
                                       atol=SLAB_ATOL)
        diffs.append(max(float(np.abs(slab[k] - flat[k]).max())
                         for k in ("rgb_map", "acc_map", "depth_map")))
        counts.append({"flat_candidates": fs["n_candidates"],
                       "slab_points": ss["n_slab_points"],
                       "slab_candidates": ss["n_candidates"],
                       "survivors": [fs["n_survivors"], ss["n_survivors"]]})
        check(fs["n_survivors"] == ss["n_survivors"],
              f"evaluate_slab: survivors {fs} against the flat {ss}")
    emit({"phase": "evaluate_slab_vs_flat", "max_abs_diff": diffs,
          "rtol": SLAB_RTOL, "atol": SLAB_ATOL, "counts": counts})
    ds = make_dataset(cfg, "test")
    item = full_frame_item(ds, ds[0])
    frames = {}
    for name, opts in (("full_frame_flat", []), ("full_frame_slab", SLAB_OPTS),
                       ("full_frame_flat_again", [])):
        c = load_config("configs/synthetic.yaml", opts, run_type="evaluate")
        c.eval = True
        eng = Engine(c, "cuda")
        eng.load_params()
        frame_launches, out = phase_full_frame(name, eng, item, k1, knn)
        frames[name] = (out, dict(eng.stats), FRAME_PROFILES[name]["device_ms"])
        if name == "full_frame_slab":
            paths[name] = frame_launches
        del eng
    (flat, fstats, fdev), (slab, sstats, sdev) = (frames["full_frame_flat"],
                                                  frames["full_frame_slab"])
    for k in ("rgb_map", "acc_map", "depth_map"):
        np.testing.assert_allclose(slab[k], flat[k], rtol=SLAB_RTOL,
                                   atol=SLAB_ATOL)
    emit({"phase": "full_frame_slab_vs_flat", "flat": fstats, "slab": sstats,
          "device_ms": {"flat": fdev, "slab": sdev,
                        "flat_again": frames["full_frame_flat_again"][2]}})
    views = eval_views("configs/synthetic_sdf_pdf.yaml",
                       {"plain": [], "seg_filter": ["seg_filter", "4"]})
    equal = [all(np.array_equal(a[0][k], b[0][k]) for k in a[0])
             for a, b in zip(views["plain"], views["seg_filter"])]
    emit({"phase": "seg_filter_sdf_pdf", "views_equal": equal})
    check(all(equal), f"seg_filter 4 changed the SDF-PDF render: {equal}")
    return paths


# Phase 21: the training options. Per-view PSNR (frames 0-3, view 3) of
# the JAX package after one epoch of 50 steps in compute_dtype bfloat16
# from the tracked weights with a fresh Adam at step 0, perturb 0 and the
# ray draw seeded, the checkpoint evaluated in float32, computed on the
# CPU with (<c> configs/synthetic.yaml, <s> synthetic, <e>
# train50_bf16_jax; then configs/synthetic_sdf_pdf.yaml,
# synthetic_sdf_pdf, train50_sdf_bf16_jax):
#   python -c "from animatable_nerf_tpu_torch.train.checkpoints import write_fresh_start as w; w('data/trained_model/deform/<s>/latest.flax', 'data/trained_model/deform/<e>')"
#   JAX_PLATFORMS=cpu python train_net.py --cfg_file <c> exp_name <e> train.epoch 1 perturb 0 fix_random True train.num_workers 2 resume True compute_dtype bfloat16
#   JAX_PLATFORMS=cpu python run.py --type evaluate --cfg_file <c> exp_name <e>
#   python -c "import numpy as np; print(np.load('data/result/deform/<e>/metrics.npy', allow_pickle=True).item()['psnr'])"
JAX_PSNR_TRAIN_BF16 = [12.341704060349091, 13.116076382974267,
                       13.217863323819355, 14.878381509405584]
JAX_PSNR_TRAIN_BF16_SDF = [21.18200163566368, 22.81313407001105,
                           24.03067748370863, 24.837970131231188]
BF16 = ["compute_dtype", "bfloat16"]
# K1's bf16 form at a train step's rows: (case, rows, wirings)
BF16_TRAIN_ROWS = (
    ("dense", TRAIN_ROWS, ("bw_field", "tpose_trunk", "resd_field")),
    ("compacted_aninerf", 24323, ("bw_field", "tpose_trunk")),
    ("compacted_knn", 16673, ("resd_field",)),
    ("stage2", ANIM_ROWS, ("bw_field", "tpose_trunk")),
)
# a bf16 step on the card against the port's plain bf16 step on the CPU
# (the item's first BF16_STEP_RAYS rays): the loss within
# BF16_STEP_LOSS_RTOL, the whole
# gradient within BF16_STEP_GRAD_REL of its L2 norm. K1's bf16 form sums
# its float32 products in another order than the plain form and rounds
# each layer to bf16 (up to 7.4e-3 of a wiring's output scale, phase
# 20), so a value a rounding apart moves the step by a bf16 step (2^-8)
# where the CPU tests see 4e-3 between XLA's and the plain form's
# roundings (tests/test_torch_train_bf16.py).
BF16_STEP_RAYS = 128
BF16_STEP_LOSS_RTOL = 1e-2
BF16_STEP_GRAD_REL = 5e-2
# the stage-2 bf16 step against the CPU at fewer points a branch than a
# real step's 65,536 (k1_bf16_train_rows times the form at those)
BF16_ANIM_ROWS = 16384
OPTIM_KINDS = {"adam": ["train.optim", "adam"],
               "radam": ["train.optim", "radam"],
               "sgd": ["train.optim", "sgd"],
               "adamw": ["train.optim", "adam", "train.weight_decay", "0.01"]}
OPTIM_STEPS = 5
# the card's optimizer against the CPU's on the card's gradient and
# state: float32 elementwise arithmetic on both (rtol, atol)
OPTIM_RTOL, OPTIM_ATOL = 1e-5, 1e-7
EVAL_EP_OPTS = ["train.epoch", "2", "ep_iter", "10", "eval_ep", "1",
                "perturb", "0", "fix_random", "True", "resume", "True"]
CHUNK_ROWS = 8192  # NeRF-PDF's 512 x 64 points in 4 chunks
CHUNK_BIG_RAYS = 4096  # 262,144 points: 2 chunks at the default bound


def k1_bf16_train_rows(k1):
    """K1's bf16 form at the rows of a train step (BF16_TRAIN_ROWS,
    `k1_bf16_case`), with its backward (the plain vjp, which recomputes
    the plain forward)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    wirings = {w[0]: w for w in k1_wirings()}
    rows = []
    for case, n_rows, names in BF16_TRAIN_ROWS:
        for name in names:
            row, (x, layers, packed, kwargs) = k1_bf16_case(
                k1, wirings[name], n_rows, gen, f"{case} ")
            leaves = [t.requires_grad_() for wb in layers for t in wb]
            out = k1.skip_mlp(x, layers, packed=packed, **kwargs)
            g = torch.randn_like(out)
            row.update(case=case, backward_ms=cuda_ms(
                lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)))
            rows.append(row)
    return rows


def phase_train_bf16_rows(k1):
    """K1's bf16 form at the train rows (`k1_bf16_train_rows`) and the
    bf16 repack a step of AniNeRF's two trunks beside the float32 one.
    Returns the rows."""
    import torch

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_model

    rows = k1_bf16_train_rows(k1)
    model = make_model(load_config("configs/synthetic.yaml", BF16)).to("cuda")
    repack = {"f32": repack_ms(model), "bf16": repack_ms(model, torch.bfloat16)}
    emit({"phase": "k1_bf16_train_rows", "tolerance": (
        f"max abs err <= {K1_BF16_REL_TOL} x max(1, max |plain|)"),
          "bound": "max(FLOP / 989 TFLOP/s (bf16), bytes / 3.35 TB/s)",
          "library": "torch.addmm + relu + cat in bf16", "rows": rows,
          "repack_ms_per_step": repack})
    return rows


def start_state_dict(cfg, aligned=None):
    """The state dict a config's steps start from: its tracked
    checkpoint, or the `aligned` family's composed tree."""
    from animatable_nerf_tpu_torch.compat.compose import compose_aligned
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.engine import make_model
    from animatable_nerf_tpu_torch.train.checkpoints import param_codec

    params = (compose_aligned(aligned) if aligned else read_checkpoint(
        os.path.join("data/trained_model", cfg.task, cfg.exp_name,
                     "latest.flax"))["params"])
    return param_codec(make_model(cfg))[0](params)


def seeded_batch(cfg, n_rays=None, index=0):
    from animatable_nerf_tpu_torch.engine import make_dataset
    from animatable_nerf_tpu_torch.train.trainer import collate_rays, stack_batch

    ds = make_dataset(cfg, "train")
    ds._rng = np.random.RandomState(0)
    return stack_batch([collate_rays(ds[index], n_rays or int(cfg.N_rand))])


def phase_train_bf16_steps(k1, knn):
    """One bf16 step of each family, of AniNeRF's compacted step and of
    its stage 2 on the card against the port's plain bf16 step on the
    CPU: K1's bf16 form as often as the float32 step launches the
    float32 form, the float32 form never. Returns the card's launches by
    path."""
    from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
    from animatable_nerf_tpu_torch.compat.jax_params import aninerf_state_dict
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import write_initial_start
    from animatable_nerf_tpu_torch.train.animation import AnimationTrainer

    paths = {}
    for family, (cfg_file, per_step) in COMPACT_FAMILIES.items():
        cfg = load_config(cfg_file, ["perturb", "0", *BF16])
        expect = {("skip_mlp_bf16" if k == "skip_mlp" else k): n
                  for k, n in per_step.items()}
        name = f"train_bf16_{family}_step_vs_cpu"
        aligned = family[len("aligned_"):] if family.startswith(
            "aligned_") else None
        phase_train_step_vs_cpu(name, cfg, start_state_dict(cfg, aligned),
                                seeded_batch(cfg, BF16_STEP_RAYS), k1, knn,
                                expect, whole_gradient=True,
                                loss_rtol=BF16_STEP_LOSS_RTOL,
                                grad_rel=BF16_STEP_GRAD_REL)
        paths[name] = STEP_LAUNCHES[name]
    # AniNeRF's compacted step: the trunks on the exact survivors
    cfg = load_config("configs/synthetic.yaml", [
        "perturb", "0", "train_keep_frac", str(TRAIN_KEEP_FRAC), *BF16])
    name = "train_bf16_compact_aninerf_step_vs_cpu"
    phase_train_step_vs_cpu(name, cfg, start_state_dict(cfg),
                            seeded_batch(cfg, BF16_STEP_RAYS), k1, knn,
                            {"skip_mlp_bf16": 3}, whole_gradient=True,
                            loss_rtol=BF16_STEP_LOSS_RTOL,
                            grad_rel=BF16_STEP_GRAD_REL)
    paths[name] = STEP_LAUNCHES[name]
    cfg = load_config(NOVEL_POSE_CFG, ANIM_OPTS + BF16 + [
        "exp_name", "chip_smoke_train_anim_bf16",
        "n_anim_samples", str(BF16_ANIM_ROWS)])
    write_initial_start(cfg)
    start = read_checkpoint(os.path.join(cfg.trained_model_dir,
                                         "latest.flax"))["params"]
    name = "train_anim_bf16_step_vs_cpu"
    with fixed_box_points(BF16_ANIM_ROWS):
        phase_train_step_vs_cpu(name, cfg, aninerf_state_dict(start),
                                seeded_batch(cfg), k1, knn,
                                {"skip_mlp_bf16": 6},
                                trainer_cls=AnimationTrainer,
                                whole_gradient=True,
                                loss_rtol=BF16_STEP_LOSS_RTOL,
                                grad_rel=BF16_STEP_GRAD_REL)
    paths[name] = STEP_LAUNCHES[name]
    return paths


def phase_train_bf16_runs(k1, knn):
    """50 bf16 steps of AniNeRF and of SDF-PDF through `run_train`, each
    checkpoint's evaluate held to the JAX CPU run of the same steps in
    bf16; then bf16 steps against float32 ones in turns (the median wall
    of 10, the device ms and idle share of 3 by the profiler). Returns
    the runs' launches."""
    import torch

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_model
    from animatable_nerf_tpu_torch.train.trainer import Trainer

    paths, turns = {}, {}
    for name, cfg_file, jax_psnr, per_step in (
            ("train_bf16", "configs/synthetic.yaml", JAX_PSNR_TRAIN_BF16,
             {"skip_mlp_bf16": 3}),
            ("train_bf16_sdf_pdf", TRAIN_SDF_CFG, JAX_PSNR_TRAIN_BF16_SDF,
             {"skip_mlp_bf16": 2, "knn_blend": 1})):
        exp = f"chip_smoke_{name}"
        opts = ["exp_name", exp] + TRAIN_OPTS[2:] + BF16
        run = train_and_evaluate(cfg_file, opts, exp, jax_psnr, k1, knn)
        cfg, trainer, _, launches, _, _, _ = run
        summary = train_summary(*run, jax_psnr)
        emit({"phase": name, "config": cfg_file, "opts": opts, **summary,
              "launches_per_step": {k: v / trainer.step
                                    for k, v in launches.items()}})
        check_train(name, summary, per_step)
        paths[name] = launches
        # bf16 against float32, in turns, from the tracked weights
        f32 = load_config(cfg_file, TRAIN_OPTS[2:])
        state_dict = start_state_dict(f32)
        batch = seeded_batch(f32)
        trainers = {}
        for dtype, c in (("f32", f32), ("bf16", cfg)):
            model = make_model(c)
            model.load_state_dict(state_dict)
            trainers[dtype] = Trainer(c, model.to("cuda"), "cuda")
        walls = step_walls(trainers, batch)
        turns[name] = {dtype: device_steps(t, batch, walls[dtype])
                       for dtype, t in trainers.items()}
        torch.cuda.synchronize()
    emit({"phase": "train_bf16_vs_f32", "steps": turns,
          "note": f"wall: the median of {COMPACT_WALL_STEPS} steps in "
          "turns; device ms and idle share: the profiler over "
          f"{COMPACT_PROFILE_STEPS} steps"})
    return paths


def phase_train_optim(k1, knn):
    """Five AniNeRF steps on the card under Adam, RAdam, SGD and AdamW,
    each held at matched weights: the CPU port's optimizer, holding the
    card's weights and state before the step, takes the card's gradient
    and must land on the card's weights; each update (the clip and the
    optimizer) timed, and under Adam torch.optim.Adam's foreach update
    timed beside it on the same weights and gradient; then a checkpoint
    written and read back through the port's loader (count, weights,
    moments). Returns the launches by path."""
    import tempfile

    import torch

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_model
    from animatable_nerf_tpu_torch.train.checkpoints import (
        load_checkpoint, optimizer_slots, save_checkpoint)
    from animatable_nerf_tpu_torch.train.optim import CLIP_VALUE, make_optimizer
    from animatable_nerf_tpu_torch.train.trainer import Trainer

    paths = {}
    for kind, opts in OPTIM_KINDS.items():
        cfg = load_config("configs/synthetic.yaml", ["perturb", "0", *opts])
        state_dict = start_state_dict(cfg)
        batch = seeded_batch(cfg)
        trainers = {}
        for device in ("cuda", "cpu"):
            model = make_model(cfg)
            model.load_state_dict(state_dict)
            trainers[device] = Trainer(cfg, model.to(device), device)
        card, cpu = trainers["cuda"], trainers["cpu"]
        card_named = dict(card.model.named_parameters())
        cpu_named = dict(cpu.model.named_parameters())
        errs, losses = [], []
        reset_counts(k1, knn)
        for _ in range(OPTIM_STEPS):
            card.optimizer.zero_grad(set_to_none=True)
            loss, _, _ = card.loss({k: v[0] for k, v in batch.items()})
            loss.backward()
            for n, p in cpu_named.items():
                g = card_named[n].grad
                p.grad = None if g is None else g.detach().cpu()
            card.apply_gradients()
            cpu.apply_gradients()
            losses.append(float(loss.detach()))
            errs.append(max(
                (p.detach().cpu() - cpu_named[n].detach()).abs().max().item()
                / (OPTIM_ATOL + OPTIM_RTOL * cpu_named[n].detach().abs().max().item())
                for n, p in card_named.items()))
        torch.cuda.synchronize()
        launches = launch_counts(k1, knn)
        # the update (the clip and the optimizer) timed on copies of the
        # weights with the last step's gradient; under Adam the
        # library's (torch.optim.Adam, foreach) beside it
        copies = [p.detach().clone().requires_grad_() for p in card.params]
        for c, p in zip(copies, card.params):
            c.grad = p.grad.detach().clone()

        def update(opt):
            torch.nn.utils.clip_grad_value_(copies, CLIP_VALUE)
            opt.step()

        port_opt = make_optimizer(cfg, copies)
        update_ms = cuda_ms(lambda: update(port_opt))
        library_ms = None
        if kind == "adam":
            library = torch.optim.Adam(copies, lr=float(cfg.train.lr),
                                       eps=1e-8, foreach=True)
            library_ms = cuda_ms(lambda: update(library))
        with tempfile.TemporaryDirectory(dir="build") as tmp:
            save_checkpoint(tmp, card.model, card.optimizer, 0, card.step,
                            {"step": card.step}, latest=True)
            model = make_model(cfg)
            back = Trainer(cfg, model.to("cuda"), "cuda")
            out = load_checkpoint(tmp, back.model, back.optimizer)
        count, slots = optimizer_slots(card.model, card.optimizer)
        count_back, slots_back = optimizer_slots(back.model, back.optimizer)
        same = (all(torch.equal(p, dict(back.model.named_parameters())[n])
                    for n, p in card_named.items())
                and all(torch.equal(v, slots_back[s][n])
                        for s in slots for n, v in slots[s].items()))
        emit({"phase": f"train_optim_{kind}", "opts": opts,
              "steps": OPTIM_STEPS, "losses": losses,
              "worst_over_tolerance": errs, "launches": launches,
              "update_ms": update_ms, "library_update_ms": library_ms,
              "params": len(copies),
              "checkpoint": {"count": count, "count_read": count_back,
                             "loaded": list(out[:3]), "equal": same,
                             "slots": sorted(slots)},
              "tolerance": f"each weight after each step within {OPTIM_ATOL} "
              f"+ {OPTIM_RTOL} x its leaf's largest of the CPU optimizer's "
              "(the card's gradient and state, float32 on both)"})
        check(all(e <= 1.0 for e in errs) and all(map(math.isfinite, losses)),
              f"train_optim_{kind}: {errs}, losses {losses}")
        check(count == count_back == OPTIM_STEPS and out[2] == OPTIM_STEPS
              and same, f"train_optim_{kind}: the checkpoint read back "
              f"{count_back} of {count}, equal {same}")
        check(launches["skip_mlp"] == 3 * OPTIM_STEPS,
              f"train_optim_{kind}: launched {launches}")
        paths[f"train_optim_{kind}"] = launches
    return paths


def phase_train_eval_ep(k1, knn):
    """`run_train` of SDF-PDF for 2 epochs of 10 steps with `eval_ep 1`:
    two "val" lines, `best.flax` and `best.json` with the last improving
    val PSNR, and the kernels the two evaluations launch (K1, K2, K3).
    Returns the run's launches."""
    import torch

    from animatable_nerf_tpu_torch import engine
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.train.checkpoints import (
        best_metric, write_fresh_start)

    exp = "chip_smoke_train_eval_ep"
    cfg = load_config(TRAIN_SDF_CFG, ["exp_name", exp] + EVAL_EP_OPTS)
    write_fresh_start("data/trained_model/deform/synthetic_sdf_pdf/latest.flax",
                      cfg.trained_model_dir)
    evals, real = [], engine.periodic_eval

    def counted(*args):
        before = launch_counts(k1, knn)
        t0 = time.time()
        m = real(*args)
        torch.cuda.synchronize()
        after = launch_counts(k1, knn)
        evals.append({"metrics": m, "seconds": time.time() - t0,
                      "launches": {k: after[k] - before[k] for k in after}})
        return m

    engine.periodic_eval = counted
    reset_counts(k1, knn)
    try:
        t0 = time.time()
        trainer, _ = engine.run_train(cfg, "cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        engine.periodic_eval = real
    launches = launch_counts(k1, knn)
    lines = [json.loads(l) for l in open(os.path.join(cfg.record_dir,
                                                      "scalars.jsonl"))]
    val = [l["val"] for l in lines if "val" in l]
    best = best_metric(cfg.trained_model_dir)
    improving, top = [], -math.inf
    for v in val:
        if math.isfinite(v["val_psnr"]) and v["val_psnr"] > top:
            top = v["val_psnr"]
            improving.append(v["val_psnr"])
    emit({"phase": "train_eval_ep", "config": TRAIN_SDF_CFG,
          "opts": EVAL_EP_OPTS, "steps": trainer.step, "wall_s": wall,
          "val": val, "best": best, "evals": evals, "launches": launches})
    check(len(val) == 2 and len(evals) == 2 and best is not None
          and improving and best["metric"] == improving[-1]
          and os.path.exists(os.path.join(cfg.trained_model_dir, "best.flax")),
          f"train_eval_ep: val {val}, best {best}")
    check(all(e["launches"]["skip_mlp"] > 0 and e["launches"]["min_dist"] > 0
              for e in evals), f"train_eval_ep: evaluations launched "
          f"{[e['launches'] for e in evals]}")
    return launches


def phase_train_chunked(k1, knn):
    """Dense train steps above `dense_chunk_rows`: a NeRF-PDF step at 512
    rays with its trainer's dense_chunk_rows at 8192 (4 chunks, K1 and
    K2 once a chunk) on the card against the CPU's same step; a
    NeRF-PDF step at 4096 rays (262,144 points, 2 chunks at the default
    bound), timed and profiled. Returns the launches by path."""
    import torch

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_model
    from animatable_nerf_tpu_torch.train.trainer import Trainer

    def chunked_trainer(cfg, model, device):
        # the trainers chunk at the default bound, as JAX's: this step's
        # bound goes on its settings
        trainer = Trainer(cfg, model, device)
        trainer.settings = trainer.settings._replace(
            dense_chunk_rows=CHUNK_ROWS)
        return trainer

    cfg_file = "configs/synthetic_nerf_pdf.yaml"
    cfg = load_config(cfg_file, ["perturb", "0"])
    state_dict = start_state_dict(cfg)
    n_chunks = int(cfg.N_rand) * int(cfg.N_samples) // CHUNK_ROWS
    name = "train_chunked_step_vs_cpu"
    phase_train_step_vs_cpu(name, cfg, state_dict, seeded_batch(cfg), k1, knn,
                            {"skip_mlp": n_chunks, "knn_blend": n_chunks},
                            trainer_cls=chunked_trainer)
    paths = {name: STEP_LAUNCHES[name]}
    big = load_config(cfg_file, ["perturb", "0", "N_rand", str(CHUNK_BIG_RAYS)])
    model = make_model(big)
    model.load_state_dict(state_dict)
    trainer = Trainer(big, model.to("cuda"), "cuda")
    batch = seeded_batch(big)
    walls = step_walls({"big": trainer}, batch, n=5)
    reset_counts(k1, knn)
    trainer.train_step(batch)
    torch.cuda.synchronize()
    launches = launch_counts(k1, knn)
    points = CHUNK_BIG_RAYS * int(big.N_samples)
    chunks = -(-points // trainer.settings.dense_chunk_rows)
    emit({"phase": "train_chunked_big", "config": cfg_file,
          "rays": CHUNK_BIG_RAYS, "points": points, "chunks": chunks,
          "launches_per_step": launches,
          "step": device_steps(trainer, batch, walls["big"])})
    check(launches == {k: {"skip_mlp": chunks, "knn_blend": chunks}.get(k, 0)
                       for k in launches},
          f"train_chunked_big: a step launched {launches}")
    paths["train_chunked_big"] = launches
    return paths


def phase_train_options(k1, knn):
    """Phase 21: the training options. Returns (K1's bf16 rows at the
    train rows, the launches by path)."""
    t0 = time.time()
    rows = phase_train_bf16_rows(k1)
    paths = {**phase_train_bf16_steps(k1, knn),
             **phase_train_bf16_runs(k1, knn), **phase_train_optim(k1, knn),
             "train_eval_ep": phase_train_eval_ep(k1, knn),
             **phase_train_chunked(k1, knn)}
    emit({"phase": "train_options", "phase_seconds": time.time() - t0})
    return rows, paths


# Phase 22: the host tools and the baselines' VGG19 objective. NT's first
# step under `train.vgg_weights` (JAX's random_vgg19_head(0) through the
# port's converter, `vgg_weights_npz`) at phase 17's start (torch seed 42)
# on train item 0 of the capsule's baseline copy: the JAX package's
# vgg_loss and l1_loss, computed on the CPU with
#   JAX_PLATFORMS=cpu python tests/chip_constants.py
# which builds the same copy, weights and file (with the helpers below)
# and runs JAX's `BaselineTrainer._loss`; it also counts the drawn pixels
# of JAX's tools/render_skeleton.py (cv2) on `skeleton_root`.
JAX_VGG_NT = {"vgg_loss": 0.40503981709480286, "l1_loss": 0.23508207499980927}
JAX_SKELETON_PIXELS = 1147
VGG_LOSS_RTOL = 1e-4
VGG_FULL_STEPS = 5
IMPORT_PSNR_DB = 1e-6  # the imported checkpoint's views against the original's
SMPL_FACES = 13776  # SMPL's triangle count
SMPL_HOLD_POINTS = 4096  # grid points of one frame held to the CPU
SMPL_TIE_TOL = 1e-6  # a differing face must be a tie: the same distance
SMPL_DIST_TOL = 1e-6
SMPL_BARY_TOL = 1e-5
IMPORTED = {"aninerf": ("configs/synthetic.yaml", "evaluate"),
            "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml", "evaluate_sdf_pdf")}


def vgg_weights_npz(tmp):
    """JAX's `random_vgg19_head(0)` written as a torchvision vgg19 state
    dict (`features.{0,2,5,7}`), converted by the port's
    tools/convert_vgg_weights.py; returns the .npz path."""
    import torch

    from animatable_nerf_tpu_torch.tools import convert_vgg_weights
    from animatable_nerf_tpu_torch.train.perceptual import random_vgg19_head_arrays

    arrays = random_vgg19_head_arrays(0)
    sd = {}
    for ci, mi in enumerate(convert_vgg_weights.VGG19_HEAD_IDX):
        sd[f"features.{mi}.weight"] = torch.from_numpy(np.ascontiguousarray(
            arrays[f"conv{ci}_w"].transpose(3, 2, 0, 1)))
        sd[f"features.{mi}.bias"] = torch.from_numpy(arrays[f"conv{ci}_b"])
    pth, npz = os.path.join(tmp, "vgg19.pth"), os.path.join(tmp, "vgg19_head.npz")
    torch.save(sd, pth)
    convert_vgg_weights.main(["--arch", "vgg19_head", "--pth", pth, "--out", npz])
    return npz


def skeleton_root(tmp):
    """A root of the capsule's params and lbs/ (links) with its first
    camera alone; returns (data_dir, human)."""
    src = os.path.abspath("data/synthetic/capsule")
    root = os.path.join(tmp, "skeleton", "capsule")
    os.makedirs(root)
    for name in ("params", "lbs"):
        os.symlink(os.path.join(src, name), os.path.join(root, name))
    annots = np.load(os.path.join(src, "annots.npy"), allow_pickle=True).item()
    annots["cams"] = {k: np.asarray(v)[:1] for k, v in annots["cams"].items()}
    np.save(os.path.join(root, "annots.npy"), annots)
    return os.path.dirname(root), "capsule"


def vgg_head_ms(vgg, size):
    """The VGG head's forward and backward device ms (CUDA events) on
    (1, 4, size, size) prediction and target, as one step computes them."""
    import torch

    from animatable_nerf_tpu_torch.train.perceptual import perceptual_loss

    x = torch.rand(1, 4, size, size, device="cuda", requires_grad=True)
    t = torch.rand(1, 4, size, size, device="cuda")

    def fwd():
        with torch.no_grad():
            perceptual_loss(vgg, x, t)

    def fwd_bwd():
        sum(perceptual_loss(vgg, x, t)).backward()

    f = cuda_ms(fwd, warmup=1, iters=3)
    return {"forward_ms": f, "backward_ms": cuda_ms(fwd_bwd, warmup=1, iters=3) - f}


def steps_timed(trainer, item, n):
    """n steps after a warm-up: s/step (wall), device ms a step (CUDA
    events around them), peak memory."""
    import torch

    trainer.train_step(item)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
    t0 = time.time()
    ev[0].record()
    losses = [trainer.train_step(item)["loss"] for _ in range(n)]
    ev[1].record()
    torch.cuda.synchronize()
    return {"s_per_step": (time.time() - t0) / n,
            "events_ms_per_step": ev[0].elapsed_time(ev[1]) / n,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "losses": losses}


def phase_perceptual(k1, knn, copies, tmp):
    """Phase 22a: `train.vgg_weights` on the baseline copies of phase 17.
    One step of NHR and NT on the card against the CPU at matched weights
    (`matched_step`; NHR by `held_by_control`), NT's vgg_loss and l1_loss
    at the start held to JAX's (VGG_LOSS_RTOL); then at 1024x1024
    VGG_FULL_STEPS steps of each under the VGG objective beside the
    stand-in's, and the VGG head's forward and backward alone. None of
    K1-K6 launches."""
    import torch

    from animatable_nerf_tpu_torch.engine import initial_model, make_dataset
    from animatable_nerf_tpu_torch.train import baseline
    from animatable_nerf_tpu_torch.train.perceptual import load_vgg_npz

    copy, big = copies
    npz = vgg_weights_npz(tmp)
    vgg = ("train.vgg_weights", npz)
    size = 128 * BASELINE_UPSAMPLE
    reset_counts(k1, knn)
    for fam in BASELINES:
        cfg = baseline_cfg(copy, fam, tmp, f"{fam}_vgg", extra=vgg)
        item = make_dataset(cfg, "train")[0]
        card = baseline.BaselineTrainer(cfg, initial_model(cfg).cuda().train(),
                                        "cuda")
        cpu = baseline.BaselineTrainer(cfg, initial_model(cfg).train(), "cpu")
        stats, secs, m = matched_step(baseline.BaselineTrainer.train_step, card,
                                      cpu, item, control=fam == "nhr")
        control = m["ulp_control_cpu"] or {}
        m["loss_tol"], loss_ok = held_by_control(
            TRAIN_LOSS_RTOL, control.get("loss_rel_err"), BASELINE_NHR_LOSS_CEIL)
        m["grad_tol"], grad_ok = held_by_control(
            TRAIN_GRAD_REL, control.get("grad_rel_l2"), BASELINE_NHR_GRAD_CEIL)
        rec = {"phase": f"perceptual_step_{fam}", "stats": stats, "step_s": secs,
               "matched": m}
        if fam == "nt":
            rec["vs_jax"] = {k: stats[k] / JAX_VGG_NT[k] - 1 for k in JAX_VGG_NT}
        full = {}
        for name, extra in (("vgg", vgg), ("stand_in", ())):
            fcfg = baseline_cfg(big, fam, tmp, f"{fam}_vgg_full", size, extra=extra)
            trainer = baseline.BaselineTrainer(
                fcfg, initial_model(fcfg).cuda().train(), "cuda")
            full[name] = steps_timed(trainer, make_dataset(fcfg, "train")[0],
                                     VGG_FULL_STEPS)
            del trainer
        rec["full_1024"] = full
        emit(rec)
        check({"vgg_loss", "l1_loss"} <= set(stats) and "pyr_loss" not in stats,
              f"{fam}: stats {sorted(stats)}")
        check(loss_ok and grad_ok and m["loss_rel_err"] <= m["loss_tol"]
              and m["grad_rel_l2"] <= m["grad_tol"]
              and m["update_rel_l2"] <= TRAIN_GRAD_REL,
              f"perceptual_step_{fam}: the card's step against the CPU's: {m}")
        if fam == "nt":
            check(all(abs(v) <= VGG_LOSS_RTOL for v in rec["vs_jax"].values()),
                  f"perceptual_step_nt: against JAX {rec['vs_jax']}")
        check(all(math.isfinite(v) for r in full.values() for v in r["losses"]),
              f"{fam}: losses at 1024x1024 {full}")
    head = vgg_head_ms(load_vgg_npz(npz, "cuda"), size)
    launches = launch_counts(k1, knn)
    emit({"phase": "perceptual_vgg_head", "H": size, "W": size, **head,
          "launches": launches})
    check(not any(launches.values()), f"perceptual launched {launches}")
    return launches


def phase_import_export(k1, knn, tmp):
    """Phase 22b: the tracked AniNeRF and SDF-PDF checkpoints exported by
    the port's exporter to reference .pth files, each imported by `python
    -m animatable_nerf_tpu_torch.tools.import_torch_checkpoint` (both at
    once) into a model dir of its own, then evaluated on the card: each
    view's PSNR equal to phase 4's and 6's evaluate of the original
    (IMPORT_PSNR_DB) and within PSNR_TOL_DB of the JAX package's, the
    kernels launched as there. Returns each evaluate's launches."""
    from animatable_nerf_tpu_torch.compat.torch_export import (
        family_of, save_reference_checkpoint)
    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.engine import make_model
    from animatable_nerf_tpu_torch.train.checkpoints import load_checkpoint

    t0 = time.time()
    procs, dirs = {}, {}
    for name, (cfg_file, _) in IMPORTED.items():
        cfg = load_config(cfg_file, [])
        model = make_model(cfg)
        epoch = load_checkpoint(cfg.trained_model_dir, model)[0]
        pth = os.path.join(tmp, f"{name}.pth")
        save_reference_checkpoint(pth, family_of(model), model.state_dict(),
                                  epoch=epoch)
        dirs[name] = ["trained_model_dir", os.path.join(tmp, f"imported_{name}"),
                      "result_dir", os.path.join(tmp, f"result_{name}")]
        procs[name] = subprocess.Popen(
            [sys.executable, "-m",
             "animatable_nerf_tpu_torch.tools.import_torch_checkpoint",
             "--cfg_file", cfg_file, "--pth", pth, *dirs[name][:2]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out = p.communicate(timeout=300)[0]
        check(p.returncode == 0, f"import of {name} failed: {out[-2000:]}")
    import_s = time.time() - t0
    paths = {}
    for name, (cfg_file, ref) in IMPORTED.items():
        cfg = load_config(cfg_file, dirs[name], run_type="evaluate")
        jax_psnr = JAX_PSNR if name == "aninerf" else JAX_PSNR_SDF
        launches, _ = phase_evaluate(f"import_evaluate_{name}", cfg, jax_psnr,
                                     k1, knn)
        got = [it["psnr"] for it in EVAL_ITEMS[f"import_evaluate_{name}"]]
        want = [it["psnr"] for it in EVAL_ITEMS[ref]]
        emit({"phase": f"import_export_{name}", "import_s": import_s,
              "delta_vs_original_db": [g - w for g, w in zip(got, want)],
              "tol_db": IMPORT_PSNR_DB, "launches": launches})
        check(len(got) == len(want) and all(
            abs(g - w) <= IMPORT_PSNR_DB for g, w in zip(got, want)),
              f"import_evaluate_{name}: {got} against the original's {want}")
        paths[f"import_evaluate_{name}"] = launches
    return paths


def smpl_sized_body(seed=0):
    """An SMPL-sized body from the capsule: its 6890 T-pose vertices and
    skinning weights, SMPL_FACES distinct triangles of nearby corners
    (each vertex with two of its nearest three), a J_regressor of three
    vertices a joint and 10 shape directions, drawn from `seed`."""
    import torch

    lbs = "data/synthetic/capsule/lbs"
    tv = np.load(os.path.join(lbs, "tvertices.npy")).astype(np.float64)
    t = torch.as_tensor(tv)
    near = torch.cdist(t, t).topk(4, largest=False).indices[:, 1:].numpy()
    idx = np.arange(len(tv))
    faces = np.concatenate([np.stack([idx, near[:, a], near[:, b]], 1)
                            for a, b in ((0, 1), (1, 2), (0, 2))])
    _, first = np.unique(np.sort(faces, 1), axis=0, return_index=True)
    faces = faces[np.sort(first)[:SMPL_FACES]].astype(np.int64)
    assert len(faces) == SMPL_FACES
    r = np.random.RandomState(seed)
    J = np.zeros((24, len(tv)))
    for j in range(24):
        J[j, r.randint(0, len(tv), 3)] = 1.0 / 3.0
    kt = np.zeros((2, 24), np.int64)
    kt[0] = np.load(os.path.join(lbs, "parents.npy"))
    return {"v_template": tv, "shapedirs": r.randn(len(tv), 3, 10) * 0.01,
            "J_regressor": J, "weights": np.load(os.path.join(lbs, "weights.npy")),
            "kintree_table": kt, "f": faces}


def phase_smpl_prep(k1, knn, tmp):
    """Phase 22c: `prepare_lbs_meta` and `prepare_blend_weights` on a copy
    of the capsule's 4 frames (params with zero `shapes`, vertices) with
    the SMPL-sized body: the blend-weight grids' closest-point queries on
    the card (s and device ms per grid, peak memory), SMPL_HOLD_POINTS
    grid points of frame 0 held to the port's CPU query (the face equal
    but at ties, dist and bary within their tolerances). None of K1-K6
    launches."""
    import pickle

    import torch

    from animatable_nerf_tpu_torch.smpl import SMPLModel, closest_point_on_mesh
    from animatable_nerf_tpu_torch.tools import prepare_blend_weights, prepare_lbs_meta

    src = "data/synthetic/capsule"
    base = os.path.join(tmp, "smpl")
    root = os.path.join(base, "capsule")
    for d in ("params", "vertices"):
        os.makedirs(os.path.join(root, d))
    for i in range(4):
        p = np.load(os.path.join(src, "params", f"{i}.npy"), allow_pickle=True).item()
        p["shapes"] = np.zeros((1, 10))
        np.save(os.path.join(root, "params", f"{i}.npy"), p)
        os.symlink(os.path.abspath(os.path.join(src, "vertices", f"{i}.npy")),
                   os.path.join(root, "vertices", f"{i}.npy"))
    smpl = smpl_sized_body()
    smpl_path = os.path.join(tmp, "smpl.pkl")
    with open(smpl_path, "wb") as f:
        pickle.dump(smpl, f)
    reset_counts(k1, knn)
    t0 = time.time()
    prepare_lbs_meta.prepare_human(base, "capsule", smpl_path)
    lbs_s = time.time() - t0

    grids = []
    query = prepare_blend_weights.closest_point_on_mesh

    def timed(pts, verts, faces, device=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        t1 = time.time()
        ev[0].record()
        res = query(pts, verts, faces, device=device)
        ev[1].record()
        torch.cuda.synchronize()
        grids.append({"points": len(pts), "faces": len(faces),
                      "s": time.time() - t1,
                      "events_ms": ev[0].elapsed_time(ev[1]),
                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
        return res

    prepare_blend_weights.closest_point_on_mesh = timed
    try:
        t0 = time.time()
        prepare_blend_weights.prepare_human(base, "capsule", smpl_path, device="cuda")
        bw_s = time.time() - t0
    finally:
        prepare_blend_weights.closest_point_on_mesh = query
    launches = launch_counts(k1, knn)

    # frame 0's grid points, SMPL_HOLD_POINTS of them, card against CPU
    model = SMPLModel(smpl)
    params = np.load(os.path.join(root, "params", "0.npy"), allow_pickle=True).item()
    _, R, Th, _, _, _ = model.transform_params(params)
    verts = np.load(os.path.join(root, "vertices", "0.npy"))
    pxyz = np.dot(verts - Th, R).astype(np.float32)
    pts = prepare_blend_weights.grid_points(pxyz).reshape(-1, 3).astype(np.float32)
    pts = pts[np.linspace(0, len(pts) - 1, SMPL_HOLD_POINTS).astype(np.int64)]
    faces = smpl["f"]
    card = closest_point_on_mesh(pts, pxyz, faces)
    t0 = time.time()
    cpu = closest_point_on_mesh(pts, pxyz, faces, chunk=512, device="cpu")
    cpu_s = time.time() - t0
    differ = card["face"] != cpu["face"]
    tie_gap = max([abs(float(closest_point_on_mesh(
        p[None], pxyz, faces[[f]], device="cpu")["dist"][0]) - float(d))
        for p, f, d in zip(pts[differ], card["face"][differ],
                           cpu["dist"][differ])] or [0.0])
    same = ~differ
    dist_err = float(np.abs(card["dist"] - cpu["dist"]).max())
    bary_err = float(np.abs(card["bary"][same] - cpu["bary"][same]).max())
    bw = np.load(os.path.join(root, "lbs", "bweights", "0.npy"))
    emit({"phase": "smpl_prep", "faces": len(faces), "vertices": len(pxyz),
          "lbs_meta_s": lbs_s, "blend_weights_s": bw_s, "grids": grids,
          "pairs": sum(g["points"] * g["faces"] for g in grids),
          "hold": {"points": SMPL_HOLD_POINTS, "faces_differing_at_ties":
                   int(differ.sum()), "tie_gap": tie_gap,
                   "dist_max_abs_err": dist_err, "bary_max_abs_err": bary_err,
                   "cpu_s": cpu_s},
          "bweights_0_shape": list(bw.shape), "launches": launches})
    check(len(grids) == 6 and bw.shape[-1] == 25 and np.isfinite(bw).all(),
          f"smpl_prep: {len(grids)} grids, {bw.shape}")
    check(tie_gap <= SMPL_TIE_TOL and dist_err <= SMPL_DIST_TOL
          and bary_err <= SMPL_BARY_TOL,
          f"smpl_prep: card against CPU: ties {tie_gap}, dist {dist_err}, "
          f"bary {bary_err}")
    check(not any(launches.values()), f"smpl_prep launched {launches}")
    return launches


def phase_render_skeleton(tmp):
    """Phase 22d: tools/render_skeleton.py's CLI for one frame and one
    camera; its PNG's drawn pixels equal to JAX's cv2 drawing's count."""
    import importlib.util

    from animatable_nerf_tpu_torch.tools import render_skeleton
    from animatable_nerf_tpu_torch.visualizers.image import read_png

    data_dir, human = skeleton_root(tmp)
    t0 = time.time()
    render_skeleton.main(["--data_dir", data_dir, "--humans", human,
                          "--max_frames", "1"])
    img = read_png(os.path.join(data_dir, human, "skeleton", "0_0.png"))
    pixels = int((img.sum(-1) > 0).sum())
    emit({"phase": "render_skeleton", "s": time.time() - t0, "pixels": pixels,
          "jax_pixels": JAX_SKELETON_PIXELS, "shape": list(img.shape),
          "cv2_present": importlib.util.find_spec("cv2") is not None})
    check(pixels == JAX_SKELETON_PIXELS,
          f"render_skeleton: {pixels} drawn pixels, JAX's {JAX_SKELETON_PIXELS}")


def phase_host_tools(k1, knn, copies):
    """Phase 22: the VGG objective, reference .pth import and export, the
    SMPL prep tools and the skeleton render, in a temporary directory.
    Returns the launches of each path."""
    tmp = tempfile.mkdtemp(prefix="host_tools_")
    t0 = time.time()
    try:
        paths = {"perceptual": phase_perceptual(k1, knn, copies, tmp)}
        paths.update(phase_import_export(k1, knn, tmp))
        paths["smpl_prep"] = phase_smpl_prep(k1, knn, tmp)
        phase_render_skeleton(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "host_tools", "phase_s": time.time() - t0})
    return paths


def main():
    import torch

    t_start = _LAST_LINE[0] = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2

    from animatable_nerf_tpu_torch.config import load_config
    from animatable_nerf_tpu_torch.device import select_device
    from animatable_nerf_tpu_torch.engine import Engine, make_dataset
    from animatable_nerf_tpu_torch.models import common
    from animatable_nerf_tpu_torch.ops import build, knn
    from animatable_nerf_tpu_torch.ops import skip_mlp as k1

    select_device("cuda")
    card = card_line()

    # ---- phase 1: card + build (one nvcc per source, all at once)
    sources = ["skip_mlp", "knn"]
    t0 = time.time()
    build.build_libraries(sources)
    build_s = time.time() - t0
    emit({"phase": "build", "card": card,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": {name: [l.strip() for l in build.build_log(name).splitlines()
                           if "registers" in l or "spill" in l
                           or "Performance Loss" in l]
                    for name in sources},
          "k1_sass": sass_counts(build.library_path("skip_mlp"))})

    # ---- phase 2: K1 vs plain
    k1_rows = phase_k1(k1.skip_mlp, k1.skip_mlp_plain, k1.pack_layers)

    # ---- phase 3: K2-K6 vs plain, on one capsule frame's vertices
    cfg_sdf = load_config("configs/synthetic_sdf_pdf.yaml", [], run_type="evaluate")
    cfg_sdf.eval = True
    ds_sdf = make_dataset(cfg_sdf, "test")
    item_sdf = ds_sdf[0]
    pverts = torch.as_tensor(item_sdf["pvertices"], device="cuda")
    weights = torch.as_tensor(np.asarray(item_sdf["weights"], np.float32),
                              device="cuda")
    k2_row, k3_row, k4_row, k5_row, k6_row = phase_knn(knn, common, pverts,
                                                       weights)

    # ---- phase 4: AniNeRF evaluate (the first slice's path)
    cfg = load_config("configs/synthetic.yaml", [], run_type="evaluate")
    eval_launches, _ = phase_evaluate("evaluate", cfg, JAX_PSNR, k1, knn)
    check(eval_launches["skip_mlp"] > 0, "evaluate did not launch K1")

    # ---- phase 5: device profile of one AniNeRF eval frame, then one
    # full-size frame (frame 0, view 3, K scaled) timed and profiled
    ds = make_dataset(cfg, "test")
    eng = Engine(cfg, "cuda")
    eng.load_params()
    item = dict(ds[0])
    eng.render_item(item)  # warm-up
    emit({"phase": "eval_frame_profile", "rays": len(item["ray_o"]),
          **device_breakdown(lambda: eng.render_item(item))})
    frame_launches, _ = phase_full_frame("full_frame", eng,
                                         full_frame_item(ds, item), k1, knn)

    # ---- phase 6: SDF-PDF evaluate (this slice's path) and full frame
    sdf_launches, sdf_counts = phase_evaluate("evaluate_sdf_pdf", cfg_sdf,
                                              JAX_PSNR_SDF, k1, knn)
    for kernel in FILTER_KERNELS:
        check(sdf_launches[kernel] > 0, f"evaluate_sdf_pdf did not launch {kernel}")
    eng_sdf = Engine(cfg_sdf, "cuda")
    eng_sdf.load_params()
    full_item_sdf = full_frame_item(ds_sdf, item_sdf)
    sdf_frame_launches, sdf_frame = phase_full_frame(
        "full_frame_sdf_pdf", eng_sdf, full_item_sdf, k1, knn)
    sdf_path = {"eval": sdf_launches, "eval_counts": sdf_counts,
                "frame": sdf_frame_launches, "frame_stats": dict(eng_sdf.stats)}
    del eng_sdf

    # ---- phase 7: the same with knn_blocked (K4 d5 grid, K5 pass 2); the
    # JAX package's CPU run takes its flat path, so its PSNR is phase 6's
    cfg_blk = load_config("configs/synthetic_sdf_pdf.yaml", ["knn_blocked", "True"],
                          run_type="evaluate")
    blk_launches, _ = phase_evaluate("evaluate_sdf_pdf_blocked", cfg_blk,
                                     JAX_PSNR_SDF, k1, knn)
    n_frames = len(JAX_PSNR_SDF)
    check(blk_launches["kth_distance"] == n_frames
          and blk_launches["knn_blend_blocked"] >= n_frames
          and blk_launches["knn_blend"] == 0
          and blk_launches["skip_mlp"] > 0 and blk_launches["min_dist"] > 0,
          f"evaluate_sdf_pdf_blocked launched {blk_launches}")
    eng_blk = Engine(cfg_blk, "cuda")
    eng_blk.load_params()
    blk_frame_launches, _ = phase_full_frame(
        "full_frame_sdf_pdf_blocked", eng_blk, full_item_sdf, k1, knn)
    check(blk_frame_launches["knn_blend"] == 0
          and blk_frame_launches["kth_distance"] == 1,
          f"full_frame_sdf_pdf_blocked launched {blk_frame_launches}")
    frame_points = phase_blocked_vs_flat(eng_blk, full_item_sdf, sdf_frame,
                                         knn, common)
    del eng_blk, eng

    # ---- phase 7b: NeRF-PDF and NeuS-PDF evaluate and full frame, their
    # point filter held to phase 6's
    fam = {family: phase_pdf_family(family, jax_psnr, full_item_sdf,
                                    sdf_path, k1, knn)
           for family, jax_psnr in (("nerf_pdf", JAX_PSNR_NERF_PDF),
                                    ("neus_pdf", JAX_PSNR_NEUS_PDF))}

    # ---- phase 8: training of AniNeRF (K1 with its gradient)
    phase_k1_grad(k1)
    train_launches = phase_train(k1, knn)

    # ---- phase 9: training of SDF-PDF (K1 twice a step, differentiated
    # twice; K2 once a step on the dense points)
    sdf_train_launches, k2_train = phase_train_sdf_pdf(k1, knn)

    # ---- phase 10: training of NeRF-PDF (K1 and K2 once a step) and
    # NeuS-PDF (K1 twice, K2 once) on SDF-PDF's dense path
    fam_train = {
        family: phase_train_pdf_family(family, jax_psnr, per_step, k1, knn)
        for family, jax_psnr, per_step in (
            ("nerf_pdf", JAX_PSNR_TRAIN_NERF_PDF,
             {"skip_mlp": 1, "knn_blend": 1}),
            ("neus_pdf", JAX_PSNR_TRAIN_NEUS_PDF,
             {"skip_mlp": 2, "knn_blend": 1}))}

    # ---- phase 11: AniNeRF stage 2, the novel-pose evaluate and full
    # frame, then stage-2 training (K1 six times a step)
    novel_launches, novel_frame_launches = phase_novel_pose(k1, knn)
    anim_launches, k1_anim_rows = phase_train_animation(k1, knn)
    train_paths = {"train": train_launches, "train_sdf_pdf": sdf_train_launches,
                   **{f"train_{f}": n for f, n in fam_train.items()},
                   "train_animation": anim_launches}

    # ---- phase 12: real cameras (lens distortion, ratio 0.5, half-size
    # masks): three evaluates, AniNeRF's train step, a 512x512 frame
    camera_paths = phase_camera(k1, knn)

    # ---- phase 13: the aligned families on composed weights: evaluates,
    # an item and a train step against the CPU, 50 steps each, K2's
    # differentiable form, two full frames
    aligned_paths, k2_grad = phase_aligned(full_item_sdf, k1, knn)

    # ---- phase 14: the aligned families' novel poses (four evaluates,
    # stage 2 of LBW and LBWPDF) and pass 1 without the distance grid
    # (four evaluates, a full frame, K3 on its tiles)
    phase14_paths = phase_novel_pose_aligned(k1, knn)
    k2_stage2 = None
    for family in STAGE2_FAMILIES:
        launches, grad = phase_train_animation_aligned(family, k1, knn)
        phase14_paths[f"train_anim_aligned_{family}"] = launches
        k2_stage2 = grad or k2_stage2
    no_grid_paths, k3_tile = phase_no_grid(k1, knn, full_item_sdf, sdf_frame,
                                           sdf_path["frame_stats"])
    phase14_paths.update(no_grid_paths)

    # ---- phase 15: meshes, every family's posed mesh at voxel 0.02 held
    # to the JAX package's, the SDF animation, and the full-size sweeps
    # at voxel 0.005 held to K1's and K2's plain versions
    phase15_paths = phase_mesh_parity(k1, knn)
    for family in MESH_FULL_FAMILIES:
        phase15_paths[f"mesh_full_{family}"] = phase_mesh_full(family, k1, knn)

    # ---- phase 16: rendered visualizations, six carved views or frames
    # held to the JAX package's and to the CPU, two rasters, and two
    # full-size carved novel views
    phase16_paths = phase_vis_parity(k1, knn)
    for name in VIS_FULL_FAMILIES:
        phase16_paths[f"full_frame_vis_{name}"] = phase_vis_full(name, k1, knn)

    # ---- phase 17: the image-space baselines NHR and NT: evaluates and
    # 50 steps held to the JAX package's PSNR, an item and a step against
    # the CPU, and 1024x1024 frames and steps; none of K1-K6 runs there
    baseline_tmp = tempfile.mkdtemp(prefix="baseline_copy_")
    atexit.register(shutil.rmtree, baseline_tmp, True)
    phase17_paths, baseline_copies = phase_baselines(k1, knn, baseline_tmp)

    # ---- phase 18: train-time survivor compaction (train_keep_frac > 0):
    # every family's compacted step against its dense step and the CPU,
    # K3 once a train frame, then 50 compacted steps of SDF-PDF and
    # AniNeRF held to the JAX package's PSNR
    phase18_paths, compact_rows = phase_compaction(k1, knn)

    # ---- phase 19: the host pipeline and the rest of the CLI: 20 train
    # steps on the 1024x1024 copy at one and four reader threads (the
    # same batches and losses), the pipelined evaluate with eval_timing,
    # and --type dataset, network, evaluate_nv, lpips and light_stage
    phase19_paths = phase_host_pipeline(k1, knn)

    # ---- phase 20: the evaluation options: K1's bf16 form, the bf16
    # evaluates and frame, importance sampling, AniNeRF's slab
    # pre-filter and its frame, seg_filter ignored
    k1_bf16_rows = phase_k1_bf16(k1)
    phase20_paths = {**phase_bf16(k1, knn), **phase_importance(k1, knn),
                     **phase_slab(k1, knn)}

    # ---- phase 21: the training options: K1's bf16 form at the train
    # rows, a bf16 step of every family and of stage 2 against the CPU,
    # 50 bf16 steps of AniNeRF and SDF-PDF held to JAX's bf16 runs and
    # timed beside float32, RAdam, SGD and AdamW, eval_ep with
    # best.flax, and dense steps in ray chunks
    k1_bf16_train, phase21_paths = phase_train_options(k1, knn)

    # ---- phase 22: the host tools and the baselines' VGG19 objective: a
    # VGG step of NHR and NT against the CPU and JAX, their 1024x1024 steps
    # beside the stand-in's; the tracked AniNeRF and SDF-PDF checkpoints
    # exported to .pth, imported by the CLI and evaluated (K1-K3); the
    # SMPL prep tools' closest-point grids on the card; the skeleton render
    phase22_paths = phase_host_tools(k1, knn, baseline_copies)
    shutil.rmtree(baseline_tmp, ignore_errors=True)

    # ---- kernel table
    def k1_sum(key):
        return sum(r[key] for r in k1_rows)

    def knn_entry(row, source_line, eval_launches, frame_launches, on_frame=None):
        """Launches: on the SDF-PDF path that runs the kernel (flat for
        K2, blocked for K4 and K5; K3 on both; K6 on none). ms is the
        kernel's own time; call_ms, where present, the whole wrapper's;
        K2 and K5 also on the full frame's pass-2 points (`on_frame`)."""
        name = row["name"]
        call = {key: row[key] for key in (
            "call_ms", "call_fresh_ms", "kernel_ms_from", "bound_allpairs_ms",
            "bound_band_ms", "bound_kept_blocks_ms", "share_of_bound",
            "runs_swept_per_warp", "pairs_tested", "pairs_full",
            "pairs_needed", "build_cell_knn_ms") if key in row}
        if on_frame is not None:
            call["frame_points"] = {
                "per_tile_launch": frame_points["tile_launches"][on_frame],
                f"per_{K2_ROWS}": frame_points[f"launches_of_{K2_ROWS}"][on_frame]}
        return {
            "name": name, "route": "cuda",
            "source": "animatable_nerf_tpu_torch/csrc/knn.cu",
            "replaces": f"animatable_nerf_tpu/ops/knn_pallas.py:{source_line}",
            "launches": eval_launches[name],
            "launches_full_frame": frame_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "kernel_ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library": row["library"],
            **call,
        }

    def family_paths(entry, name):
        """The NeRF-PDF and NeuS-PDF paths' launches of K2 or K3 (phase
        7b) and the SDF-PDF and NeRF-PDF evaluates on the distorted copy
        (phase 12), added to an entry of the SDF-PDF path."""
        entry["launches"] += sum(ev[name] for ev, _ in fam.values())
        entry["launches_by_path"] = {
            "evaluate_sdf_pdf": sdf_launches[name],
            **{f"evaluate_{f}": ev[name] for f, (ev, _) in fam.items()}}
        for path in ("evaluate_camera_sdf_pdf", "evaluate_camera_nerf_pdf"):
            entry["launches"] += camera_paths[path][name]
            entry["launches_by_path"][path] = camera_paths[path][name]
        entry["launches_full_frame_by_path"] = {
            "full_frame_sdf_pdf": sdf_frame_launches[name],
            **{f"full_frame_{f}": fr[name] for f, (_, fr) in fam.items()}}
        return entry

    def aligned_launches(entry, name, paths=None):
        """The aligned paths' launches (phase 13, or `paths`): evaluates
        and train runs into `launches`, each path by name, and the full
        frames."""
        for path, n in (aligned_paths if paths is None else paths).items():
            if path.startswith("full_frame"):
                entry.setdefault("launches_full_frame_by_path", {})[path] = n[name]
            else:
                entry["launches"] += n[name]
                entry.setdefault("launches_by_path", {})[path] = n[name]
        return entry

    k2_entry = aligned_launches(aligned_launches(aligned_launches(
        aligned_launches(family_paths(
            knn_entry(k2_row, 55, sdf_launches, sdf_frame_launches, "k2"),
            "knn_blend"), "knn_blend"), "knn_blend", phase14_paths),
        "knn_blend", phase15_paths), "knn_blend", phase16_paths)
    # K2 also runs once a step on the PDF families' dense train points
    for path, launches in train_paths.items():
        if path != "train":
            k2_entry["launches"] += launches["knn_blend"]
            k2_entry["launches_by_path"][path] = launches["knn_blend"]
    k2_entry.update(
        launches_per_train_step={
            path: launches["knn_blend"] / 50
            for path, launches in (*train_paths.items(),
                                   *aligned_paths.items(),
                                   *phase14_paths.items())
            if path.startswith("train")},
        # the consistency target's prior on LBW's canonical points: the
        # launch with its selection, and the plain vjp over it
        differentiable_tpose_points={k: k2_grad[k] for k in (
            "queries", "max_abs_err", "indices_equal", "kernel_ms",
            "kernel_without_indices_ms", "plain_ms", "backward_ms",
            "bound_ms", "bound_by", "backward_bound_ms", "library_ms",
            "grad_rel_err_vs_cpu")},
        # the same at a stage-2 step's canonical points (LBW, 65,536)
        differentiable_stage2_points={k: k2_stage2[k] for k in (
            "queries", "max_abs_err", "indices_equal", "kernel_ms",
            "kernel_without_indices_ms", "plain_ms", "backward_ms",
            "bound_ms", "bound_by", "backward_bound_ms", "library_ms",
            "grad_rel_err_vs_cpu")},
        train_points={k: k2_train[k] for k in (
            "queries", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "share_of_bound", "pairs_band_per_query",
            "pairs_tested_per_query", "filter_pass_share")})
    k1_entry = {
        "name": "skip_mlp",
        "route": "cuda",
        "source": "animatable_nerf_tpu_torch/csrc/skip_mlp.cu",
        "replaces": "animatable_nerf_tpu/ops/mlp_pallas.py:108",
        # the evaluate paths (AniNeRF, SDF-PDF, NeRF-PDF, NeuS-PDF,
        # AniNeRF's novel pose; the real-camera and aligned ones are
        # added below) and the 50 steps of each training (the forward;
        # the backward and its derivative are plain PyTorch)
        "launches": eval_launches["skip_mlp"] + sdf_launches["skip_mlp"]
        + sum(ev["skip_mlp"] for ev, _ in fam.values())
        + novel_launches["skip_mlp"]
        + sum(n["skip_mlp"] for n in train_paths.values())
        + sum(n["skip_mlp"] for path, n in camera_paths.items()
              if not path.startswith("frame")),
        "launches_by_path": {
            "evaluate": eval_launches["skip_mlp"],
            "evaluate_sdf_pdf": sdf_launches["skip_mlp"],
            **{f"evaluate_{f}": ev["skip_mlp"]
               for f, (ev, _) in fam.items()},
            "evaluate_novel_pose": novel_launches["skip_mlp"],
            **{path: n["skip_mlp"] for path, n in train_paths.items()},
            **{path: n["skip_mlp"] for path, n in camera_paths.items()
               if not path.startswith("frame")}},
        "launches_per_train_step": {
            **{path: n["skip_mlp"] / 50 for path, n in train_paths.items()},
            "train_camera": camera_paths["train_camera"]["skip_mlp"]
            / CAMERA_TRAIN_STEPS},
        "launches_full_frame": {
            "full_frame": frame_launches["skip_mlp"],
            "full_frame_sdf_pdf": sdf_frame_launches["skip_mlp"],
            **{f"full_frame_{f}": fr["skip_mlp"]
               for f, (_, fr) in fam.items()},
            "full_frame_novel_pose": novel_frame_launches["skip_mlp"],
            "frame_camera_512": camera_paths["frame_camera_512"]["skip_mlp"]},
        # the two wirings of a stage-2 step at its 65,536 rows
        "stage2_step_rows": [
            {k: r[k] for k in ("wiring", "rows", "max_abs_err",
                               "kernel_ms", "plain_ms", "library_ms",
                               "bound_ms", "share_of_bound")}
            for r in k1_anim_rows],
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        # one call of each wiring (bw field, NeRF trunk, resd field)
        # at K1_ROWS rows
        "ms": k1_sum("kernel_ms"),
        "kernel_ms": k1_sum("kernel_ms"),
        "plain_ms": k1_sum("plain_ms"),
        # 3 x FLOP over the TF32 rate (the FP32-accurate tensor-core
        # bound); the FP32 CUDA-core one beside it
        "bound_ms": k1_sum("bound_ms"),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in k1_rows) else "bytes",
        "bound_fp32_ms": k1_sum("bound_fp32_ms"),
        "share_of_bound": k1_sum("bound_ms") / k1_sum("kernel_ms"),
        "library_ms": k1_sum("library_ms"),
    }
    aligned_launches(k1_entry, "skip_mlp")
    aligned_launches(k1_entry, "skip_mlp", phase14_paths)
    aligned_launches(k1_entry, "skip_mlp", phase15_paths)
    aligned_launches(k1_entry, "skip_mlp", phase16_paths)
    aligned_launches(k1_entry, "skip_mlp", phase18_paths)
    aligned_launches(k1_entry, "skip_mlp", phase19_paths)
    aligned_launches(k1_entry, "skip_mlp", phase20_paths)
    aligned_launches(k1_entry, "skip_mlp", phase21_paths)
    # the compacted train steps' rows (phase 18): each K1 launch on the
    # exact survivors, K2 on pass 1's candidates (and the aligned
    # families' canonical prior on the survivors), K3 once a frame
    compacted_rows = {f: {k: r[k] for k in (
        "points", "pass1_candidates", "survivors", "survivor_share",
        "k2_rows", "k1_rows")} for f, r in compact_rows.items()}
    k1_entry["compacted_train_step_rows"] = compacted_rows
    k1_entry["launches_per_train_step"].update(
        {path: n["skip_mlp"] / 50
         for path, n in (*aligned_paths.items(), *phase14_paths.items())
         if path.startswith("train")})
    k1_entry["launches_full_frame"].update(
        k1_entry.pop("launches_full_frame_by_path"))
    aligned_launches(k2_entry, "knn_blend", phase18_paths)
    aligned_launches(k2_entry, "knn_blend", phase20_paths)
    aligned_launches(k2_entry, "knn_blend", phase21_paths)
    k2_entry["compacted_train_step_rows"] = compacted_rows
    kernels = [
        k1_entry,
        k2_entry,
        dict(aligned_launches(aligned_launches(aligned_launches(
            aligned_launches(family_paths(
                knn_entry(k3_row, 129, sdf_launches, sdf_frame_launches),
                "min_dist"), "min_dist"), "min_dist", phase14_paths),
            "min_dist", phase16_paths), "min_dist", phase18_paths),
            # without the distance grid: once a tile on the tile's points
            per_tile_no_grid=k3_tile,
            # the compacted train path's 64^3 grid, once a train frame
            train_grid=compact_rows["sdf_pdf"]["grid_build"]),
        knn_entry(k4_row, 240, blk_launches, blk_frame_launches),
        knn_entry(k5_row, 460, blk_launches, blk_frame_launches, "k5"),
        knn_entry(k6_row, 760, blk_launches, blk_frame_launches),
    ]
    # K3 on the phase-20 paths (the SDF-PDF and NeuS-PDF evaluates' grids)
    aligned_launches(kernels[2], "min_dist", phase20_paths)
    aligned_launches(kernels[2], "min_dist", phase21_paths)
    # K1's bf16 form: one call of each wiring at K1_ROWS rows, its
    # launches on the bf16 paths (phase 20)
    def bf16_sum(key):
        return sum(r[key] for r in k1_bf16_rows)

    k1_bf16_entry = aligned_launches({
        "name": "skip_mlp_bf16",
        "route": "cuda",
        "source": "animatable_nerf_tpu_torch/csrc/skip_mlp.cu",
        "replaces": "animatable_nerf_tpu/ops/mlp_pallas.py:108",
        "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in k1_bf16_rows),
        "ms": bf16_sum("kernel_ms"),
        "kernel_ms": bf16_sum("kernel_ms"),
        "plain_ms": bf16_sum("plain_ms"),
        # FLOP over the bf16 tensor-core rate
        "bound_ms": bf16_sum("bound_ms"),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in k1_bf16_rows) else "bytes",
        "share_of_bound": bf16_sum("bound_ms") / bf16_sum("kernel_ms"),
        "library_ms": bf16_sum("library_ms"),
        "library": "torch.addmm + relu + cat in bf16",
    }, "skip_mlp_bf16", phase20_paths)
    aligned_launches(k1_bf16_entry, "skip_mlp_bf16", phase21_paths)
    k1_bf16_entry["launches_full_frame"] = k1_bf16_entry.pop(
        "launches_full_frame_by_path")
    # phase 21: a bf16 train step's launches (the 50-step runs, the single
    # steps), and the form at the train steps' rows
    k1_bf16_entry["launches_per_train_step"] = {
        path: n["skip_mlp_bf16"] / (50 if path.startswith("train_bf16") and
                                    not path.endswith("_vs_cpu") else 1)
        for path, n in phase21_paths.items() if "bf16" in path}
    k1_bf16_entry["train_step_rows"] = [
        {k: r[k] for k in ("case", "wiring", "rows", "max_abs_err",
                           "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                           "share_of_bound", "f32_kernel_ms", "backward_ms")}
        for r in k1_bf16_train]
    kernels.insert(1, k1_bf16_entry)
    # the imported checkpoints' evaluates (phase 22): K1, and K2 and K3 on
    # SDF-PDF's
    imported = {p: n for p, n in phase22_paths.items() if p.startswith("import")}
    for entry in kernels:
        if entry["name"] in ("skip_mlp", "knn_blend", "min_dist"):
            aligned_launches(entry, entry["name"], imported)
    # the baselines' paths (phase 17) and the tools' (phase 22) launch none
    for entry in kernels:
        entry["launches_baseline_paths"] = {
            path: n[entry["name"]] for path, n in phase17_paths.items()}
        entry["launches_tool_paths"] = {
            path: n[entry["name"]] for path, n in phase22_paths.items()
            if not path.startswith("import")}
    emit({"kernels": kernels})
    emit({"script_seconds": time.time() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
