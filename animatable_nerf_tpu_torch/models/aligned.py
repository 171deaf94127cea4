"""The aligned families: AlignedLBW, AlignedPBW, AlignedSMPL and
AlignedLBWPDF, their eval and dense train paths.

JAX counterpart: animatable_nerf_tpu/models/aligned.py (`PoseCondBWField`
:53, `_AlignedBase` :71 with `_filter_th` :127, `_head` :138, `_bw_mask`
:206, `_eval_compacted` :271, `_train_compacted` :324 and the dense
train branch of `__call__` :402-433; `AlignedLBW` :436, `AlignedPBW` :467, `AlignedSMPL` :491,
`AlignedLBWPDF` :508; reference aligned_aninerf_{lbw,pbw,smpl,lbw_pdf}
_network.py).

Every family is a KNN family with NeRF-PDF's canonical head, so its eval
tile is `KNNFamily.forward` (models/pdf.py): pass 1 on the K3 distance
grid (or, with knn_grid_res <= 1, K3 on the tile's points), exact
compaction, K2's prior on the candidates, the exact
weighted-distance filter with its argmin forced, the family's deform
(`_warp`), the head, the canonical box grown by 0.05. The families
differ in the deform and the filter's threshold:
  * LBW: the learned blend weights over the KNN prior (a
    BlendWeightField, frame latent `latent_index + 1`), the LBS warp to
    the big pose; threshold `norm_th`;
  * PBW: the same with the pose-conditioned field (`PoseCondBWField`,
    the frame's pose vector); threshold `norm_th`;
  * SMPL: the KNN prior itself; threshold 0.1;
  * LBWPDF: LBW's warp plus a displacement field at the big pose;
    threshold 0.1.
SMPL and LBWPDF hard-code 0.1 in their reference forwards (JAX
`_filter_th`).

The train path is JAX's dense masked one by default (`train_keep_frac`
0): the filter and the prior from one K2 launch on the step's posed
points (`KNNFamily._dense_filter`), the deform and the head on every
point, rgb and alpha zeroed outside the filter and the box. With
`train_keep_frac` > 0 it is JAX's compacted one (:324-384): the PDF
families' compacted filter (`KNNFamily._train_filter`: pass 1 on the
frame's distance grid, K2 on the candidates, the exact filter), then
the deform, the head and the consistency pair on the exact survivors
alone. For the
families with a learned field the consistency pair: `pbw` at the posed
points and `tbw`, the field at latent 0 (PBW: a zero pose) over the KNN
prior of the canonical points against the canonical vertices. That prior
is differentiated with respect to the canonical points, as JAX
differentiates its XLA `sample_blend_closest_points`: K2's
differentiable form (ops/knn.py `KNNBlendFunction`). `bw_mask` is the
final alpha above `train_th` with its argmax forced; LBWPDF also returns
its displacement and mask for the offset loss.

Novel poses (JAX `_anim_select` :161, `animation_from_pose` :169,
`animation_from_canonical` :189, the `novel_pose_bw` fields :446, :524
and their use in `_deform` :452-461, :531-538): LBW and LBWPDF built
with `num_eval_frames` > 0 hold a second blend-weight field,
`novel_pose_bw`, one latent per novel-pose frame. A frame marked
`novel_pose` (the engine's `test_novel_pose`) warps through it at its
`bw_latent_index` (models/common.py `FrameBlendWeights`); PBW and SMPL
render such a frame through their stage-1 deform, as JAX does (their
`_deform` takes `novel_pose` and ignores it). Stage 2 fits
`novel_pose_bw` by the consistency pairs `animation_from_pose` and
`animation_from_canonical` (train/animation.py): the KNN prior of the
posed points, the novel-pose field, the LBS warp posed -> T-pose -> big
pose (LBS alone: LBWPDF's displacement field takes no part, as in JAX),
and there the frozen stage-1 field at latent 0 over the prior of the
canonical points, that prior differentiated with respect to them (K2's
differentiable form); the selection is the density above `train_th`
among the points in the canonical box whose posed (or canonical) KNN
distance is under the configured norm_th, its argmax forced
(`consistency_select`). That threshold is `stage2_norm_th`, the
configured value: LBWPDF's forward filter reads the hard-coded 0.1, its
stage 2 does not (JAX :186, :202). PBW and SMPL have no novel-pose
field, so their stage 2 does not exist (engine.py `model_class` refuses
it; the JAX package's raises an AttributeError).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.knn import sample_blend_closest_points
from ..core.lbs import pose_points_to_tpose_points, tpose_points_to_pose_points
from ..fields.fields import (
    BlendWeightField,
    PoseCondBWField,
    displacement,
    displacement_layers,
    set_compute_dtype,
)
from .common import FrameBlendWeights, consistency_select, inside_bounds
from .pdf import NORM_TH, TBOUNDS_PAD, KNNFamily, NeRFHead


class _AlignedBase(NeRFHead, KNNFamily):
    """The families' shared part. The module holds its blend-weight field
    at the top level (`bw_latent`, `bw_linears`, `bw_fc`, as the
    reference networks do), `tpose_human` with NeRF-PDF's head, and
    LBWPDF the displacement field (`resd_linears`, `resd_fc`), so its
    state dict has the reference's names.

    num_latents: num_train_frame, the color latent table's rows (the
    frame-latent field has one more, row 0 the canonical one).
    dtype: the fields' compute dtype, float32 or bfloat16 (JAX
    aligned.py:58-100, :443-526)."""

    # the canonical vertices serve the consistency target's KNN prior,
    # and stage 2 draws its posed points in the world box
    train_frame_keys = KNNFamily.frame_keys + ("tvertices", "wbounds")
    # whether the filter reads the configured norm_th (LBW, PBW) or the
    # reference's hard-coded 0.1 (SMPL, LBWPDF; JAX aligned.py:127-136)
    reads_norm_th = True

    def _aligned_init(self, num_latents: int, norm_th: float,
                      train_th: float, tpose_viewdir: bool,
                      dtype: torch.dtype):
        self.tpose_human = self._canonical(num_latents)
        set_compute_dtype(self, dtype)
        self.tpose_viewdir = bool(tpose_viewdir)
        self.norm_th = float(norm_th) if self.reads_norm_th else NORM_TH
        # stage 2's selection reads the configured value (JAX :186, :202)
        self.stage2_norm_th = float(norm_th)
        self.train_th = float(train_th)

    def _deform(self, pose_pts, pose_dirs, init_pbw, frame):
        """Posed points, their directions and KNN prior (N, 24) ->
        (canonical points, their directions, {"pbw": the learned blend
        weights, "resd": the displacement} where the family has them)."""
        raise NotImplementedError

    def _canonical_bw(self, tpose, init_tbw, frame):
        """The learned field at the canonical points, over their prior."""
        raise NotImplementedError

    def _warp(self, pose_pts, pose_dirs, pbw, frame):
        return self._deform(pose_pts, pose_dirs, pbw, frame)[:2]

    def train_forward(self, wpts, viewdir, z_vals, frame):
        """Train forward (JAX aligned.py:402-433 dense, :324-384
        compacted): wpts (R, S, 3), viewdir (R, 3), z_vals (R, S) -> raw
        (R, S, 4) zeroed outside the box and off the rows (the filter,
        or the exact survivors: `_train_filter`); with a learned field
        pbw and tbw (rows, 24) and bw_mask (rows,); LBWPDF also resd
        (rows, 3) and its mask."""
        rows, pose_pts, pose_dirs, init_pbw, vd = self._train_filter(
            wpts, viewdir, z_vals, frame)
        tpose, tdirs, extras = self._deform(pose_pts, pose_dirs, init_pbw,
                                            frame)
        rgb, alpha = self._eval_head(
            tpose, tdirs if self.tpose_viewdir else vd,
            int(frame["latent_index"]), rows.index, z_vals)
        raw = torch.cat([rgb, alpha[:, None]], dim=-1)
        inside = inside_bounds(tpose, frame["tbounds"], pad=TBOUNDS_PAD)
        raw = torch.where(inside[:, None], raw, 0.0)
        out = {"raw": rows.dense(raw)}
        if "pbw" in extras:
            # the consistency target (:424-430): the prior at the canonical
            # points differentiated with respect to them
            init_tbw, _ = sample_blend_closest_points(
                tpose, frame["tvertices"], frame["weights"])
            # the final alpha above train_th, its argmax forced over the
            # rows (:206-214); compaction is stable, so that is the
            # compacted stream's first maximum, as in JAX (:367-377)
            a_sel = torch.where(rows.mask, raw[:, 3].detach(), float("-inf"))
            bw_mask = a_sel > self.train_th
            bw_mask[torch.argmax(a_sel)] = True
            out.update(pbw=extras["pbw"],
                       tbw=self._canonical_bw(tpose, init_tbw, frame),
                       bw_mask=bw_mask)
        if "resd" in extras:
            out.update(resd=extras["resd"], resd_mask=rows.mask)
        return out


class AlignedLBW(FrameBlendWeights, _AlignedBase, BlendWeightField):
    """Learned blend-weight field with frame latents (JAX aligned.py:436;
    reference aligned_aninerf_lbw_network.py), and with
    `num_eval_frames` > 0 the novel-pose field `novel_pose_bw`."""

    def __init__(self, num_latents: int, norm_th: float = 0.05,
                 train_th: float = 0.0, tpose_viewdir: bool = True,
                 xyz_res: int = 10, num_eval_frames: int = 0,
                 dtype: torch.dtype = torch.float32):
        BlendWeightField.__init__(self, num_latents + 1, xyz_res)
        if num_eval_frames > 0:
            self.novel_pose_bw = BlendWeightField(num_eval_frames, xyz_res)
        self._aligned_init(num_latents, norm_th, train_th, tpose_viewdir,
                           dtype)

    def _learned_warp(self, pose_pts, pose_dirs, init_pbw, frame):
        pbw = self.pose_blend_weights(pose_pts, init_pbw, frame)
        bigpose, dirs = self._to_bigpose(pose_pts, pose_dirs, pbw, frame)
        return bigpose, dirs, pbw

    def _deform(self, pose_pts, pose_dirs, init_pbw, frame):
        tpose, dirs, pbw = self._learned_warp(pose_pts, pose_dirs, init_pbw,
                                              frame)
        return tpose, dirs, {"pbw": pbw}

    def _canonical_bw(self, tpose, init_tbw, frame):
        return self.blend_weights(tpose, init_tbw, 0)

    # ------------------------------------------------------- stage 2
    def _novel_pose_bw(self, pose_pts, init_pbw, frame):
        return self.novel_pose_bw.blend_weights(
            pose_pts, init_pbw, int(frame["bw_latent_index"]))

    def animation_from_pose(self, pose_pts, frame):
        """The stage-2 pair at posed points (JAX aligned.py:169-187;
        reference aninerf_sample_animation_trainer.py:51-88
        `ppts_to_tpose`): the KNN prior (K2, data), `novel_pose_bw` (K1),
        the warp posed -> T-pose -> big pose, and there the frozen
        stage-1 field at latent 0 (K1) over the prior of the canonical
        vertices (K2's differentiable form); both take their gradient
        through their input. Returns (pbw (N, 24), tbw (N, 24), select
        (N,))."""
        init_pbw, pnorm = sample_blend_closest_points(
            pose_pts, frame["pvertices"], frame["weights"])
        pbw = self._novel_pose_bw(pose_pts, init_pbw, frame)
        tpose = pose_points_to_tpose_points(pose_pts, pbw, frame["A"])
        tpose = tpose_points_to_pose_points(tpose, pbw, frame["big_A"])
        init_tbw, _ = sample_blend_closest_points(
            tpose, frame["tvertices"], frame["weights"])
        tbw = self._canonical_bw(tpose, init_tbw, frame)
        keep = (inside_bounds(tpose, frame["tbounds"])
                & (pnorm[:, 0] < self.stage2_norm_th))
        with torch.no_grad():
            sigma = self.tpose_human.nerf_network(tpose)[:, 0]
        return pbw, tbw, consistency_select(sigma, keep, self.train_th)

    def animation_from_canonical(self, tpts, frame):
        """The stage-2 pair at canonical points (JAX aligned.py:189-205;
        reference aninerf_sample_animation_trainer.py:91-121
        `tpose_to_ppts`): the frozen stage-1 field at latent 0 over the
        canonical prior, the forward warp big pose -> T-pose -> posed,
        and there `novel_pose_bw` over the posed prior. Only
        `novel_pose_bw` sees a trained input, so the rest runs without a
        graph. Returns (pbw, tbw, select) as `animation_from_pose`."""
        with torch.no_grad():
            init_tbw, tnorm = sample_blend_closest_points(
                tpts, frame["tvertices"], frame["weights"])
            tbw = self._canonical_bw(tpts, init_tbw, frame)
            sigma = self.tpose_human.nerf_network(tpts)[:, 0]
            t = pose_points_to_tpose_points(tpts, tbw, frame["big_A"])
            ppts = tpose_points_to_pose_points(t, tbw, frame["A"])
            init_pbw, _ = sample_blend_closest_points(
                ppts, frame["pvertices"], frame["weights"])
        pbw = self._novel_pose_bw(ppts, init_pbw, frame)
        keep = tnorm[:, 0] < self.stage2_norm_th
        return pbw, tbw, consistency_select(sigma, keep, self.train_th)


class AlignedPBW(_AlignedBase, PoseCondBWField):
    """Pose-vector-conditioned blend-weight field (ablation; JAX
    aligned.py:467; reference aligned_aninerf_pbw_network.py). It has no
    novel-pose field, in the reference nor in JAX: a novel-pose frame
    warps through the stage-1 field, and there is no stage 2."""

    def __init__(self, num_latents: int, norm_th: float = 0.05,
                 train_th: float = 0.0, tpose_viewdir: bool = True,
                 xyz_res: int = 10, dtype: torch.dtype = torch.float32):
        PoseCondBWField.__init__(self, num_latents + 1, xyz_res)
        self._aligned_init(num_latents, norm_th, train_th, tpose_viewdir,
                           dtype)

    def _deform(self, pose_pts, pose_dirs, init_pbw, frame):
        pbw = self.blend_weights(pose_pts, init_pbw, frame["poses"])
        tpose, dirs = self._to_bigpose(pose_pts, pose_dirs, pbw, frame)
        return tpose, dirs, {"pbw": pbw}

    def _canonical_bw(self, tpose, init_tbw, frame):
        return self.blend_weights(tpose, init_tbw,
                                  torch.zeros_like(frame["poses"]))


class AlignedSMPL(_AlignedBase, nn.Module):
    """The KNN prior's SMPL weights alone, no learned deformation
    (ablation; JAX aligned.py:491; reference
    aligned_aninerf_smpl_network.py); its filter threshold is 0.1."""

    reads_norm_th = False

    def __init__(self, num_latents: int, norm_th: float = 0.05,
                 train_th: float = 0.0, tpose_viewdir: bool = True,
                 xyz_res: int = 10, dtype: torch.dtype = torch.float32):
        nn.Module.__init__(self)
        self.xyz_res = xyz_res
        self._aligned_init(num_latents, norm_th, train_th, tpose_viewdir,
                           dtype)

    def _deform(self, pose_pts, pose_dirs, init_pbw, frame):
        tpose, dirs = self._to_bigpose(pose_pts, pose_dirs, init_pbw, frame)
        return tpose, dirs, {}


class AlignedLBWPDF(AlignedLBW):
    """Learned blend weights and a displacement field at the big pose
    (ablation; JAX aligned.py:508; reference
    aligned_aninerf_lbw_pdf_network.py:89-121); its filter threshold is
    0.1, whatever norm_th says (stage 2 reads norm_th). Stage 2 is
    LBW's: the displacement field takes no part in it."""

    reads_norm_th = False

    def __init__(self, num_latents: int, norm_th: float = 0.05,
                 train_th: float = 0.0, tpose_viewdir: bool = True,
                 xyz_res: int = 10, num_eval_frames: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_latents, norm_th, train_th, tpose_viewdir,
                         xyz_res, num_eval_frames, dtype)
        self.resd_linears, self.resd_fc = displacement_layers(xyz_res)

    def residual(self, pts, pose_vec):
        """The displacement (N, 3). K1's packed weights of this stack are
        kept on its layer list, apart from the blend-weight field's,
        which are kept on the model."""
        return displacement(self.resd_linears,
                            [*self.resd_linears, self.resd_fc], pts,
                            pose_vec, self.xyz_res, self.dtype)

    def _deform(self, pose_pts, pose_dirs, init_pbw, frame):
        bigpose, dirs, pbw = self._learned_warp(pose_pts, pose_dirs,
                                                init_pbw, frame)
        resd = self.residual(bigpose, frame["poses"])
        return bigpose + resd, dirs, {"pbw": pbw, "resd": resd}
