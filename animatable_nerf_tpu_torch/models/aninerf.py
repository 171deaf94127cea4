"""AniNeRF: neural blend-weight field + canonical NeRF, eval and train
paths.

JAX counterpart: animatable_nerf_tpu/models/aninerf.py (`AniNeRF`,
eval branch: `_compact_inputs` :231, `_conservative_dist_rows` :266,
`_eval_compacted` :595, `_eval_finish` :625; the dense train branch of
`__call__` :740-861; reference tpose_nerf_network.py:139-215).

The point filter keeps the JAX semantics exactly:
  * pass 1 interpolates only the distance channel, from corners rounded
    to bf16, against a threshold widened by a certified bound on that
    rounding, and forces the argmin of those values on: a superset of
    the exact survivors;
  * pass 2 re-applies the exact f32 filter (norm_th) on the 25-channel
    interpolation of the pass-1 candidates and forces the argmin over
    those candidates.
With `slab_filter` > 1 (JAX `_eval_slab` :419-594, its dispatch
:760-767), a pass 0 comes first: the occupied supercell boxes of the
distance volume, each ray's slab union span over them and the segments
of `slab_filter` samples whose z range meets it (models/common.py
`occupied_supercell_boxes`, `slab_span`, `slab_segment_keep`); pass 1
then runs on the kept segments' samples alone, its argmin forced over
that stream, as JAX forces it over its candidate stream. A box list
over `slab_box_capacity` keeps every segment. JAX rebuilds the
candidates' z and points from packed ray rows and one-hot matmuls (TPU
gathers); the port gathers the tile's own points. The path runs only on
the plain stratified grid (`analytic_z`: no importance sampling), with
`eval_keep_frac` > 0 and `slab_filter` dividing N_samples, as in JAX;
otherwise the flat filter above runs.
Forcing happens once per call, i.e. once per eval tile. The JAX package
compacts into fixed capacities and escalates a capacity ladder until
nothing overflows; PyTorch has dynamic shapes, so both passes compact
exactly with torch.nonzero, and the MLPs run on the exact survivors only
(the JAX code runs them on every candidate and zeroes alpha after; the
composited maps are the same). The multi-view carve of the
visualizations drops survivors the same way, after the exact filter.

The train path (`train_forward`) is by default JAX's dense masked one
(`train_keep_frac` 0): every sampled point runs both blend-weight passes
and the canonical NeRF, masked points on a substituted safe point, and
the filter's argmin and the consistency selection's argmax are forced
over the whole step's points. With `train_keep_frac` > 0 it is JAX's
compacted one (`_train_compacted` :678): the same filter, its argmin
forced over the step, then the three passes on the exact survivors
alone; raw scatters back to the (R, S) grid, the consistency pair stays
on the survivors.

Stage 2 (novel pose; JAX `novel_pose_bw` :151-155, `pose_to_canonical`
:157-167 and `_bw_consistency_select` :189, shared with the aligned
families as models/common.py `FrameBlendWeights` and
`consistency_select`; `animation_from_pose` :197,
`animation_from_canonical` :215): with `num_eval_frames` > 0 the model
holds a third blend-weight field, `novel_pose_bw`, one latent per
novel-pose frame. Its consistency pairs (`animation_from_pose`,
`animation_from_canonical`) are what stage-2 training fits
(train/animation.py); the frozen stage-1 field and the density trunk
take part only through their inputs, and the density only in the
selection, so it runs without a graph. A frame with `novel_pose` set
(the engine's `test_novel_pose`) warps through `novel_pose_bw` at its
`bw_latent_index` instead of the stage-1 field at `latent_index + 1`.
"""

from __future__ import annotations

import torch

from ..core.composite import composite_compacted
from ..core.grid import pts_sample_blend_weights
from ..core.lbs import (
    pose_points_to_tpose_points,
    tpose_points_to_pose_points,
    world_dirs_to_pose_dirs,
    world_points_to_pose_points,
)
from ..core.sampling import z_vals_to_dists
from ..fields.fields import BlendWeightField, TPoseNeRF, set_compute_dtype
from .common import (
    FrameBlendWeights,
    TrainRows,
    compact_indices,
    consistency_select,
    inside_bounds,
    keep_mask_with_argmin,
    occupied_supercell_boxes,
    raw_alpha_from_sigma,
    scatter_compacted,
    slab_segment_keep,
    slab_span,
    substitute_masked,
    volume_lipschitz_bound,
)

# the mesh sweep's filter threshold, fixed whatever norm_th says
# (tpose_nerf_network.py:113-115)
MESH_NORM_TH = 0.1


class AniNeRF(FrameBlendWeights, BlendWeightField):
    """Grid-based blend-weight AniNeRF.

    The module is the blend-weight field itself plus `tpose_human`, as
    the reference network holds `bw_latent`/`bw_linears`/`bw_fc` at its
    top level; so its state dict has the reference's names.

    num_train_frames: rows of the appearance latent table; the bw latent
    table has num_train_frames + 1 rows (row 0 canonical, row i+1 frame
    i — tpose_nerf_network.py:17,96,173).
    num_eval_frames: rows of the novel-pose field's latent table; 0 (no
    `novel_pose_bw`) unless the run trains or evaluates novel poses
    (JAX models/registry.py:87).
    dtype: the fields' compute dtype (float32 or bfloat16).
    eval_keep_frac, slab_filter, slab_supercell, slab_box_capacity: the
    slab pre-filter's gate and settings (JAX aninerf.py:119-145); the
    fraction sizes a JAX capacity, so here only its sign matters.
    """

    # the per-frame tensors the engine moves to the device (training
    # also reads the canonical volume `tbw`, and stage 2 the world box
    # `wbounds`)
    frame_keys = ("A", "pbw", "pbounds", "tbounds", "R", "Th")
    train_frame_keys = frame_keys + ("tbw", "wbounds")
    knn_pass1 = False
    # > 0: the train forward runs on the exact survivors alone; the
    # engine sets it from the config
    train_keep_frac = 0.0

    def __init__(self, num_train_frames: int, norm_th: float = 0.05,
                 xyz_res: int = 10, view_res: int = 4,
                 train_th: float = 0.0, num_eval_frames: int = 0,
                 dtype: torch.dtype = torch.float32,
                 eval_keep_frac: float = 0.25, slab_filter: int = 0,
                 slab_supercell: int = 4, slab_box_capacity: int = 1024):
        super().__init__(num_latents=num_train_frames + 1, xyz_res=xyz_res)
        self.tpose_human = TPoseNeRF(num_train_frames, xyz_res, view_res)
        if num_eval_frames > 0:
            self.novel_pose_bw = BlendWeightField(num_eval_frames, xyz_res)
        self.norm_th = float(norm_th)
        self.train_th = float(train_th)
        self.eval_keep_frac = float(eval_keep_frac)
        self.slab_filter = int(slab_filter)
        self.slab_supercell = int(slab_supercell)
        self.slab_box_capacity = int(slab_box_capacity)
        set_compute_dtype(self, dtype)

    def _conservative_dist_rows(self, frame):
        """bf16-rounded distance volume (D, H, W, 1) and the widened
        pass-1 threshold: norm_th + (norm_th + lip * |cell|) * 2^-8
        bounds the bf16 rounding of every corner near the shell for a
        lip-Lipschitz field (JAX aninerf.py:266-284)."""
        dist_vol = frame["pbw"][..., 24:25]
        bounds = frame["pbounds"]
        lip = volume_lipschitz_bound(dist_vol[..., 0], bounds)
        sizes = torch.tensor(dist_vol.shape[:3], dtype=torch.float32,
                             device=dist_vol.device)
        cell = (bounds[1] - bounds[0]) / (sizes - 1.0)
        corner_bound = self.norm_th + lip * torch.linalg.norm(cell)
        th = self.norm_th + corner_bound * (2.0 ** -8)
        return dist_vol.to(torch.bfloat16), th

    def _compact_inputs(self, pose_pts, frame):
        """Pass 1: indices (ascending) of the conservative candidates."""
        dist_bf16, th = self._conservative_dist_rows(frame)
        pnorm = pts_sample_blend_weights(pose_pts, dist_bf16,
                                         frame["pbounds"])[..., 0]
        keep = keep_mask_with_argmin(pnorm, th)
        return torch.nonzero(keep).squeeze(1)

    def _slab_points(self, wpts, viewdir, z_vals, frame):
        """Pass 0 of the slab pre-filter (JAX aninerf.py:466-496): the
        flat indices (ascending) of the samples of every segment whose z
        range meets its ray's slab span over the occupied supercell
        boxes; every segment where the box list overflows. The ray
        origins come from the first samples, as in JAX."""
        seg = self.slab_filter
        ray_o = wpts[:, 0, :] - viewdir * z_vals[:, 0:1]
        lo, hi, overflow = occupied_supercell_boxes(
            frame["pbw"][..., 24], frame["pbounds"], self.norm_th,
            self.slab_supercell, self.slab_box_capacity)
        if overflow:
            keep = torch.ones(z_vals.numel() // seg, dtype=torch.bool,
                              device=z_vals.device)
        else:
            span_lo, span_hi = slab_span(
                world_points_to_pose_points(ray_o, frame["R"], frame["Th"]),
                world_dirs_to_pose_dirs(viewdir, frame["R"]), lo, hi)
            keep = slab_segment_keep(span_lo, span_hi, z_vals, seg)
        segs = compact_indices(keep)
        offs = torch.arange(seg, device=segs.device)
        return (segs[:, None] * seg + offs).reshape(-1)

    def _eval_finish(self, cand, pose_pts, viewdir, dists, frame,
                     n_samples: int, wpts=None, carve=None):
        """Pass 2 on the candidates: exact filter, then the blend-weight
        warp and the canonical NeRF on the survivors. With `carve`, the
        survivors whose world points (`wpts`, flat) a training view does
        not see are dropped after the filter's argmin forcing: JAX zeroes
        their rgb and alpha there (aninerf.py:654-656), and an alpha of
        0 adds nothing to the composite. Returns (sidx flat sample
        indices, rgb (K, 3), alpha (K,), the exact survivors' count)."""
        c_pose = pose_pts[cand]
        c_init = pts_sample_blend_weights(c_pose, frame["pbw"], frame["pbounds"])
        sel = torch.nonzero(
            keep_mask_with_argmin(c_init[:, 24], self.norm_th)).squeeze(1)
        n_exact = sel.numel()
        if carve is not None:
            sel = sel[carve(wpts[cand[sel]])]
        sidx = cand[sel]
        s_pose = c_pose[sel]
        pbw = self.pose_blend_weights(s_pose, c_init[sel, :24], frame)
        tpose = pose_points_to_tpose_points(s_pose, pbw, frame["A"])
        sigma, rgb_logits = self.tpose_human(
            tpose, viewdir[sidx // n_samples], int(frame["latent_index"])
        )
        sigma = torch.where(inside_bounds(tpose, frame["tbounds"]), sigma, 0.0)
        alpha = raw_alpha_from_sigma(sigma, dists[sidx])
        return sidx, torch.sigmoid(rgb_logits), alpha, n_exact

    @torch.no_grad()
    def forward(self, wpts, viewdir, z_vals, frame, carve=None,
                analytic_z: bool = False, alpha_grid: bool = False):
        """Eval render of one tile: wpts (R, S, 3), viewdir (R, 3),
        z_vals (R, S) -> rgb_map (R, 3), acc_map (R,), depth_map (R,)
        plus the tile's candidate and survivor counts and the survivors
        the optional `carve` (world points -> seen by every training
        view) removed. `analytic_z` says that z_vals is the plain
        stratified grid, which the slab pre-filter needs; with it the
        output also counts the kept segments' samples (n_slab_points).
        With `alpha_grid` (the coarse pass of importance sampling) the
        output holds `alpha` (R, S), the survivors' alpha and 0
        elsewhere, in place of the maps."""
        n_rays, n_samples = z_vals.shape
        slab = (analytic_z and self.eval_keep_frac > 0
                and self.slab_filter > 1 and n_samples % self.slab_filter == 0)
        flat = wpts.reshape(-1, 3)
        pose_pts = world_points_to_pose_points(flat, frame["R"], frame["Th"])
        counts = {}
        if slab:
            pts = self._slab_points(wpts, viewdir, z_vals, frame)
            cand = pts[self._compact_inputs(pose_pts[pts], frame)]
            counts["n_slab_points"] = pts.numel()
        else:
            cand = self._compact_inputs(pose_pts, frame)
        sidx, rgb, alpha, n_exact = self._eval_finish(
            cand, pose_pts, viewdir, z_vals_to_dists(z_vals).reshape(-1),
            frame, n_samples, flat, carve,
        )
        counts.update(n_candidates=cand.numel(), n_survivors=n_exact,
                      n_carved=n_exact - sidx.numel())
        if alpha_grid:
            return {"alpha": scatter_compacted(alpha, sidx, n_rays,
                                               n_samples), **counts}
        rgb_map, acc_map, depth_map = composite_compacted(
            sidx, rgb, alpha, z_vals, n_rays, n_samples
        )
        return {"rgb_map": rgb_map, "acc_map": acc_map,
                "depth_map": depth_map, **counts}

    def train_forward(self, wpts, viewdir, z_vals, frame):
        """Train forward (JAX aninerf.py:808-861 dense, :678-737
        compacted): wpts (R, S, 3), viewdir (R, 3), z_vals (R, S) -> raw
        (R, S, 4), and per row (every point, or with `train_keep_frac` >
        0 the exact survivors alone) the blend weights pbw (rows, 24) at
        the posed points and tbw (rows, 24) at their canonical images
        (the consistency pair), and bw_mask (rows,), the points the
        consistency loss reads."""
        n_rays, n_samples = z_vals.shape
        pose_pts = world_points_to_pose_points(
            wpts.reshape(-1, 3), frame["R"], frame["Th"])
        vd = viewdir[:, None, :].expand(n_rays, n_samples, 3).reshape(-1, 3)
        dists = z_vals_to_dists(z_vals).reshape(-1)

        # the filter on the posed volume's distance channel (:808-822);
        # the grid prior comes in under stop-gradient
        if self.train_keep_frac > 0:
            # the distance channel alone, then the three K1 passes on the
            # survivors (:689-712)
            pnorm = pts_sample_blend_weights(
                pose_pts, frame["pbw"][..., 24:], frame["pbounds"])[:, 0]
            sidx = compact_indices(keep_mask_with_argmin(pnorm, self.norm_th))
            rows = TrainRows.compacted(sidx, n_rays, n_samples)
            pose_pts, vd, dists = pose_pts[sidx], vd[sidx], dists[sidx]
            init_pbw = pts_sample_blend_weights(
                pose_pts, frame["pbw"], frame["pbounds"]).detach()
        else:
            init_pbw = pts_sample_blend_weights(
                pose_pts, frame["pbw"], frame["pbounds"]).detach()
            pind = keep_mask_with_argmin(init_pbw[:, 24], self.norm_th)
            rows = TrainRows(pind, n_rays, n_samples)
            safe = (frame["pbounds"][0] + frame["pbounds"][1]) * 0.5
            safe_bw = pts_sample_blend_weights(safe[None], frame["pbw"],
                                               frame["pbounds"])
            pose_pts = substitute_masked(pose_pts, pind, safe)
            init_pbw = torch.where(pind[:, None], init_pbw, safe_bw[0])

        latent_index = int(frame["latent_index"])
        pbw = self.pose_blend_weights(pose_pts, init_pbw[:, :24], frame)
        tpose = pose_points_to_tpose_points(pose_pts, pbw, frame["A"])
        # the consistency target: the field at latent 0 on the canonical
        # points, over the canonical volume's prior (:835-845)
        init_tbw = pts_sample_blend_weights(tpose, frame["tbw"],
                                            frame["tbounds"])
        tbw = self.blend_weights(tpose, init_tbw[:, :24], 0)

        sigma, rgb_logits = self.tpose_human(tpose, vd, latent_index)
        sigma = torch.where(inside_bounds(tpose, frame["tbounds"]), sigma, 0.0)
        alpha = raw_alpha_from_sigma(sigma, dists)
        raw = torch.cat([torch.sigmoid(rgb_logits), alpha[:, None]], dim=-1)

        # density above train_th, the argmax forced on over the rows
        # (:852-859); compaction is stable, so over the survivors that is
        # the dense path's point (:721-725)
        d_sel = torch.where(rows.mask, sigma.detach(), float("-inf"))
        bw_mask = d_sel > self.train_th
        bw_mask[torch.argmax(d_sel)] = True
        return {"raw": rows.dense(raw), "pbw": pbw, "tbw": tbw,
                "bw_mask": bw_mask}

    @torch.no_grad()
    def density(self, wpts, frame):
        """The canonical density at world points, the mesh sweep's field
        (JAX aninerf.py:169-186; reference tpose_nerf_network.py:105-137):
        wpts (N, 3) -> sigma (N,), 0 outside the posed volume's distance
        filter at MESH_NORM_TH with its argmin forced. The survivors
        alone go through the blend-weight field at `latent_index + 1`
        (K1), the LBS warp and the density trunk (K1); JAX evaluates
        every point and zeroes after, to the same values."""
        pose_pts = world_points_to_pose_points(wpts, frame["R"], frame["Th"])
        init_pbw = pts_sample_blend_weights(pose_pts, frame["pbw"],
                                            frame["pbounds"])
        keep = keep_mask_with_argmin(init_pbw[:, 24], MESH_NORM_TH)
        idx = torch.nonzero(keep).squeeze(1)
        pbw = self.blend_weights(pose_pts[idx], init_pbw[idx, :24],
                                 int(frame["latent_index"]) + 1)
        tpose = pose_points_to_tpose_points(pose_pts[idx], pbw, frame["A"])
        sigma = torch.zeros_like(wpts[:, 0])
        sigma[idx] = self.tpose_human.density(tpose)
        return sigma

    # ------------------------------------------------------- stage 2
    def animation_from_pose(self, pose_pts, frame):
        """The stage-2 consistency pair at posed points (JAX :197-213;
        reference aninerf_animation_trainer.py:58-93 `ppts_to_tpose`):
        `novel_pose_bw` at the frame's bw_latent_index, the LBS warp to
        the canonical points, and there the frozen stage-1 field at
        latent 0 over the canonical volume's prior, its gradient taken
        through its input. Returns (pbw (N, 24), tbw (N, 24), select
        (N,))."""
        pbw25 = pts_sample_blend_weights(pose_pts, frame["pbw"],
                                         frame["pbounds"])
        pbw = self.novel_pose_bw.blend_weights(
            pose_pts, pbw25[:, :24], int(frame["bw_latent_index"]))
        tpose = pose_points_to_tpose_points(pose_pts, pbw, frame["A"])
        tbw25 = pts_sample_blend_weights(tpose, frame["tbw"], frame["tbounds"])
        tbw = self.blend_weights(tpose, tbw25[:, :24], 0)
        keep = (inside_bounds(tpose, frame["tbounds"])
                & (pbw25[:, 24] < self.norm_th))
        with torch.no_grad():
            sigma = torch.where(keep, self.tpose_human.density(tpose), 0.0)
        return pbw, tbw, consistency_select(sigma, keep, self.train_th)

    def animation_from_canonical(self, tpts, frame):
        """The stage-2 pair at canonical points (JAX :215-229; reference
        aninerf_animation_trainer.py:96-122 `tpose_to_ppts`): the frozen
        stage-1 field at latent 0, the forward LBS warp to the posed
        points, and there `novel_pose_bw`. Only `novel_pose_bw` sees a
        trained input, so the rest runs without a graph. Returns (pbw,
        tbw, select) as `animation_from_pose`, every point kept."""
        with torch.no_grad():
            tbw25 = pts_sample_blend_weights(tpts, frame["tbw"],
                                             frame["tbounds"])
            tbw = self.blend_weights(tpts, tbw25[:, :24], 0)
            sigma = self.tpose_human.density(tpts)
            pose_pts = tpose_points_to_pose_points(tpts, tbw, frame["A"])
            pbw25 = pts_sample_blend_weights(pose_pts, frame["pbw"],
                                             frame["pbounds"])
        pbw = self.novel_pose_bw.blend_weights(
            pose_pts, pbw25[:, :24], int(frame["bw_latent_index"]))
        keep = torch.ones_like(sigma, dtype=torch.bool)
        return pbw, tbw, consistency_select(sigma, keep, self.train_th)
