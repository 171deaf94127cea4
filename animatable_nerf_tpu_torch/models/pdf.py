"""The displacement-field (PDF) families: NeRF-PDF, SDF-PDF and
NeuS-PDF, their eval paths and their train paths, dense or compacted.

JAX counterpart: animatable_nerf_tpu/models/pdf.py (`_PDFBase._warp`
:103, `_filter` :131, `_compact_inputs` :138 conservative branch,
`_eval_compacted` :282; `NeRFPDF` :353 with its `_eval_head` :379 and
the train branches of `__call__` :401-468; `SDFPDF` :470 with
`_sdf_and_grad` :492, `_observed_grad` :509, `_eval_head` :542,
`_train_compacted` :552 and the dense train branch of `__call__`
:658-700; `NeuSPDF` :701 with `_eval_compacted_neus` :718,
`_train_compacted_neus` :867 and the dense train branch of `__call__`
:953-990; the mesh sweeps' fields, `density` :370-377 with
aligned.py:147-153, `canonical_sdf` and `canonical_resd` :519-533;
reference aligned_aninerf_pdf_network.py, anisdf_pdf_network.py,
anisdf_neus_pdf_network.py).

The eval path (`KNNFamily.forward`) is the families' shared part, also
the aligned families' (models/aligned.py, which give it their deform
and threshold), and keeps the JAX semantics:
  * pass 1 reads the per-frame nearest-vertex distance grid (built by
    kernel K3, `grid_pdist_keep`): a certified superset of the
    survivors, with the argmin of the bound forced on; without a grid
    (knn_grid_res <= 1) K3 gives every point of the tile its exact
    nearest-vertex distance, kept under the threshold with the tile's
    argmin forced (JAX pdf.py:171-178), also a superset;
  * pass 2 runs kernel K2 on the candidates (or, with `knn_blocked`,
    K5 over the vertex blocks within each candidate tile's certified
    5-NN radius): IDW blend weights over the posed vertices and the
    weighted distance, whose exact filter (< norm_th, NORM_TH for these
    families) is re-applied with its argmin over the candidates forced
    on;
  * the family's deform (`_warp`: here the LBS warp and the
    displacement field, K1) on the exact survivors, then its canonical
    head (`_eval_head`), and
    rgb and alpha zeroed outside the canonical box grown by
    TBOUNDS_PAD;
  * the visualizations' multi-view carve (`carve`) on the exact
    survivors' world points: it drops survivors from the filter, or,
    for NeuS-PDF, zeroes their rgb and alpha after the head.
Forcing happens once per call, i.e. once per eval tile. The JAX package
compacts into fixed capacities twice (pass 1, then the stage-2
re-compaction to the exact survivors, `stage2_ratio`) and parks dead
slots on bone 0; the port compacts exactly with torch.nonzero, so it has
neither capacities nor dead slots.

The heads: NeRF-PDF's softplus NeRF takes alpha over the real sample
spacing; SDF-PDF's VolSDF the reference's fixed 0.005 step; NeuS-PDF's
opacity couples consecutive samples of a ray, so its head scatters the
survivors' sdf into the tile's ray-ordered (R, S) grid, +10 elsewhere,
and reads `neus_alpha` back at the survivors (JAX's dense oracle form,
pdf.py:851-865; tiles hold whole rays). A survivor outside the box
keeps its true sdf in its neighbours' CDF and loses only its own alpha
and rgb.

The train path is shared by the three families up to the canonical
points (`_PDFBase._train_warp`, on `KNNFamily._train_filter`, which the
aligned families share too). By default (`train_keep_frac` 0) it is
JAX's dense masked one: every sampled point is filtered by one K2
launch (argmin forced over the whole step), masked points are moved
onto the first posed vertex, and the displacement field (K1) runs on
all of them. With `train_keep_frac` > 0 it is JAX's compacted one
(pdf.py:401-445, :552-633, :867-933): pass 1 on the frame's distance
grid (K3 once a train frame, built by the trainer), K2 on its
candidates, the exact filter, and everything after it on the exact
survivors alone; JAX's capacities, overflow and stage-2 re-compaction
do not exist here. Then each family's `train_forward` adds its head on
the rows (every point, or the survivors): NeRF-PDF's softplus NeRF with
alpha over the real (perturbed) sample spacing; the SDF families
(`_SDFFamily.train_forward`) the SDF network with its normals kept on
the graph, the color network, the family's opacity (VolSDF per point;
NeuS on the step's (R, S) grid of sdf, +10 off the rows) and the
observed-space eikonal term, which differentiates sdf(x + resd(x))
with respect to x with a graph, so the loss reaches the displacement
field through K1's gradient of a gradient (ops/skip_mlp.py). The
survivors' gather and scatters stay on that graph.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.composite import composite_compacted
from ..core.knn import sample_blend_closest_points
from ..core.lbs import (
    backward_warp_points_dirs,
    world_dirs_to_pose_dirs,
    world_points_to_pose_points,
)
from ..core.sampling import z_vals_to_dists
from ..core.sdf import neus_alpha, sigma_to_alpha, volsdf_sigma
from ..fields.fields import (
    BetaNetwork,
    ColorNetwork,
    GeometricFieldNetwork,
    ResidualField,
    SingleVarianceNetwork,
    set_compute_dtype,
)
from ..ops.knn import min_dist
from .common import (
    SDF_FILL,
    TrainRows,
    compact_indices,
    grid_pdist_keep,
    inside_bounds,
    keep_mask_with_argmin,
    knn_blend_for_frame,
    raw_alpha_from_sigma,
    scatter_compacted,
    substitute_masked,
)

NORM_TH = 0.1  # hard-coded in the pdf models (anisdf_pdf_network.py:172)
TBOUNDS_PAD = 0.05  # canonical bbox growth (JAX pdf.py:344)
# |sdf| below which a point enters the observed-space eikonal term
# (JAX pdf.py:692-694; reference anisdf_pdf_network.py:194-199)
OBSERVED_GRAD_BAND = 0.02


class Canonical(nn.Module):
    """The canonical networks under the reference's `tpose_human.`
    prefix, registered (and initialized) in the order given: SDF-PDF's
    `sdf_network`, `beta_network`, `color_network`; NeRF-PDF's
    `nerf_network`, `color_network`; NeuS-PDF's `sdf_network`,
    `variance_network`, `color_network`."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, module in modules.items():
            self.add_module(name, module)


class KNNFamily:
    """The KNN families' shared part, mixed into an nn.Module: the eval
    tile body (`forward`) and the dense train filter (`_dense_filter`)
    of the displacement-field families here and of the aligned families
    (models/aligned.py). A family gives its deform, posed SMPL points to
    canonical ones (`_warp`), and its canonical head (`_eval_head`);
    the filter's threshold on K2's weighted distance is `norm_th`."""

    # pass 1 reads the per-frame distance grid (ops/knn.py
    # build_pdist_payload) where the engine attaches one to the frame
    knn_pass1 = True
    # the per-frame tensors the engine moves to the device
    frame_keys = ("A", "big_A", "poses", "weights", "pvertices", "tbounds",
                  "R", "Th")
    # training reads the same frame tensors; the trainer adds the
    # distance grid for the compacted path (`train_keep_frac` > 0)
    train_frame_keys = frame_keys
    norm_th = NORM_TH
    # > 0: the train forward runs on the exact survivors alone
    # (`_train_filter`); the engine sets it from the config
    train_keep_frac = 0.0
    # whether the multi-view carve acts after the head (zeroing rgb and
    # alpha, the survivor kept in the head's inputs) rather than in the
    # filter: NeuS-PDF's, whose alpha reads its ray neighbours' sdf
    carve_in_head = False

    def _warp(self, pose_pts, pose_dirs, pbw, frame):
        """The family's deform of posed points with their KNN prior pbw
        (N, 24) and view directions: (canonical points, their
        directions)."""
        raise NotImplementedError

    def _eval_head(self, tpose, dirs, latent_index: int, sidx, z_vals):
        """The family's canonical head on the survivors: tpose (N, 3),
        dirs (N, 3), their flat sample indices sidx (N,) and the tile's
        z_vals (R, S) -> rgb (N, 3), alpha (N,)."""
        raise NotImplementedError

    def _to_bigpose(self, pose_pts, pose_dirs, pbw, frame):
        """The LBS part of the warp: (init_bigpose, bigpose dirs)."""
        dirs_in = pose_dirs if self.tpose_viewdir else None
        return backward_warp_points_dirs(pose_pts, dirs_in, pbw, frame["A"],
                                         frame["big_A"])

    def _dense_filter(self, wpts, viewdir, z_vals, frame):
        """The filter of the dense masked train forward (JAX pdf.py:131-136,
        :447-454; aligned.py:408-413): wpts (R, S, 3), viewdir (R, 3),
        z_vals (R, S) -> per point (N = R*S rows) the filter mask pind,
        the posed points with the masked ones moved onto the first posed
        vertex (:664-666), their posed view directions, their KNN prior
        pbw (N, 24) and the world view directions.

        One K2 launch serves the filter and the prior: JAX runs the KNN
        again on the substituted points, whose blend at a kept point is
        the filter's and at a masked one that of the first vertex, the
        launch's extra last query. Data only; the argmin is forced over
        the step's points."""
        n_rays, n_samples = z_vals.shape
        pose_pts = world_points_to_pose_points(
            wpts.reshape(-1, 3), frame["R"], frame["Th"])
        vd = viewdir[:, None, :].expand(n_rays, n_samples, 3).reshape(-1, 3)
        pose_dirs = world_dirs_to_pose_dirs(vd, frame["R"])
        safe = frame["pvertices"][0]
        pbw, pnorm = sample_blend_closest_points(
            torch.cat([pose_pts, safe[None]]), frame["pvertices"],
            frame["weights"])
        pind = keep_mask_with_argmin(pnorm[:-1, 0], self.norm_th)
        pose_pts = substitute_masked(pose_pts, pind, safe)
        pbw = torch.where(pind[:, None], pbw[:-1], pbw[-1])
        return pind, pose_pts, pose_dirs, pbw, vd

    def _train_filter(self, wpts, viewdir, z_vals, frame):
        """The train forward's filter: (TrainRows, the rows' posed points,
        their posed view directions, KNN prior pbw (rows, 24), world
        view directions). With `train_keep_frac` 0 every point is a row
        (`_dense_filter`). Otherwise the rows are the exact survivors
        (JAX pdf.py:138-210, aligned.py:324-350): with the frame's
        distance grid, pass 1 on it (`grid_pdist_keep`, its bound's
        argmin forced), then K2 on the candidates, whose exact filter
        forces its argmin over them; without the grid, K2 on every point
        gives the filter, its argmin forced over the step, as on the
        dense path. JAX's capacities, its stage-2 re-compaction
        (`_train_stage2`) and its dead slots parked on bone 0 have no
        counterpart: the compaction is exact."""
        if self.train_keep_frac <= 0:
            pind, *parts = self._dense_filter(wpts, viewdir, z_vals, frame)
            return (TrainRows(pind, *z_vals.shape), *parts)
        n_rays, n_samples = z_vals.shape
        pose_pts = world_points_to_pose_points(
            wpts.reshape(-1, 3), frame["R"], frame["Th"])
        cand = None
        if "pdist_packed" in frame:
            cand = compact_indices(grid_pdist_keep(pose_pts, frame,
                                                   self.norm_th))
            pose_pts = pose_pts[cand]
        pbw, pnorm = sample_blend_closest_points(
            pose_pts, frame["pvertices"], frame["weights"])
        sel = compact_indices(keep_mask_with_argmin(pnorm[:, 0], self.norm_th))
        sidx = sel if cand is None else cand[sel]
        vd = viewdir[sidx // n_samples]
        return (TrainRows.compacted(sidx, n_rays, n_samples), pose_pts[sel],
                world_dirs_to_pose_dirs(vd, frame["R"]), pbw[sel], vd)

    def _pass1_keep(self, pose_pts, frame):
        """Pass 1's mask over the tile's posed points (N, 3): from the
        frame's distance grid where the engine attached one
        (`grid_pdist_keep`, its bound's argmin forced); otherwise K3's
        nearest-vertex distance of every point, under norm_th with the
        tile's argmin forced (JAX pdf.py:171-178, aligned.py:243-255).
        Either is a superset of the exact filter's survivors."""
        if "pdist_packed" in frame:
            return grid_pdist_keep(pose_pts, frame, self.norm_th)
        return keep_mask_with_argmin(min_dist(pose_pts, frame["pvertices"]),
                                     self.norm_th)

    @torch.no_grad()
    def density(self, wpts, frame):
        """The canonical density at world points, the mesh sweep's field
        of NeRF-PDF and the aligned families (JAX pdf.py:370-377,
        aligned.py:147-153): wpts (N, 3) -> sigma (N,), the NeRF
        network's channel 0, 0 outside the KNN filter at NORM_TH (every
        family, whatever its norm_th) with its argmin forced. One K2
        launch gives the filter and the survivors' prior (JAX runs the
        KNN twice, to the same values); the survivors alone go through
        the family's stage-1 deform (`_warp`: K1 for a learned
        blend-weight or displacement field) and the NeRF network."""
        pose_pts = world_points_to_pose_points(wpts, frame["R"], frame["Th"])
        pbw, pnorm = sample_blend_closest_points(
            pose_pts, frame["pvertices"], frame["weights"])
        idx = torch.nonzero(keep_mask_with_argmin(pnorm[:, 0], NORM_TH)).squeeze(1)
        tpose, _ = self._warp(pose_pts[idx], None, pbw[idx],
                              {**frame, "novel_pose": False})
        sigma = torch.zeros_like(wpts[:, 0])
        sigma[idx] = self.tpose_human.nerf_network(tpose)[:, 0]
        return sigma

    @torch.no_grad()
    def forward(self, wpts, viewdir, z_vals, frame, carve=None,
                analytic_z: bool = False, alpha_grid: bool = False):
        """Eval render of one tile: wpts (R, S, 3), viewdir (R, 3),
        z_vals (R, S) -> rgb_map (R, 3), acc_map (R,), depth_map (R,)
        plus the tile's candidate and survivor counts. `carve`, where
        given, maps world points to whether every training view sees
        them; it joins the exact filter after its argmin forcing, on the
        survivors' own world points (JAX pdf.py:296-301,
        aligned.py:295-302), except where the head keeps the carved
        survivors (`carve_in_head`). `n_carved` counts the survivors it
        removed. `analytic_z` goes unread (no KNN family has a slab
        pre-filter, as in JAX). With `alpha_grid` (the coarse pass of
        importance sampling) the output holds `alpha` (R, S), the
        survivors' final alpha and 0 elsewhere, in place of the maps
        (NeuS-PDF's from its own (R, S) grid)."""
        n_rays, n_samples = z_vals.shape
        wpts = wpts.reshape(-1, 3)
        pose_pts = world_points_to_pose_points(wpts, frame["R"], frame["Th"])
        # pass 1: the conservative candidates, ascending
        cand = torch.nonzero(self._pass1_keep(pose_pts, frame)).squeeze(1)
        c_pose = pose_pts[cand]
        c_pbw, c_pnorm = knn_blend_for_frame(c_pose, frame)
        sel = torch.nonzero(
            keep_mask_with_argmin(c_pnorm[:, 0], self.norm_th)).squeeze(1)
        n_exact = sel.numel()
        seen = None
        if carve is not None:
            seen = carve(wpts[cand[sel]])
            if not self.carve_in_head:
                sel, seen = sel[seen], None
        sidx = cand[sel]
        s_dirs = viewdir[sidx // n_samples]
        tpose, tdirs = self._warp(
            c_pose[sel], world_dirs_to_pose_dirs(s_dirs, frame["R"]),
            c_pbw[sel], frame,
        )
        rgb, alpha = self._eval_head(
            tpose, tdirs if self.tpose_viewdir else s_dirs,
            int(frame["latent_index"]), sidx, z_vals,
        )
        keep = inside_bounds(tpose, frame["tbounds"], pad=TBOUNDS_PAD)
        if seen is not None:
            keep = keep & seen
        rgb = torch.where(keep[:, None], rgb, 0.0)
        alpha = torch.where(keep, alpha, 0.0)
        n_carved = (n_exact - sidx.numel() if seen is None
                    else int((~seen).sum()))
        counts = {"n_candidates": cand.numel(), "n_survivors": n_exact,
                  "n_carved": n_carved}
        if alpha_grid:
            return {"alpha": scatter_compacted(alpha, sidx, n_rays,
                                               n_samples), **counts}
        rgb_map, acc_map, depth_map = composite_compacted(
            sidx, rgb, alpha, z_vals, n_rays, n_samples
        )
        return {"rgb_map": rgb_map, "acc_map": acc_map,
                "depth_map": depth_map, **counts}


class _PDFBase(KNNFamily, ResidualField):
    """The displacement-field families' shared part. The module is the
    displacement field itself (`resd_linears`, `resd_fc` at the top
    level, as in the reference networks) plus `tpose_human`, the
    family's `_canonical` networks, so its state dict has the
    reference's names. Their filter threshold is NORM_TH.

    num_latents: rows of the color latent table (num_latent_code).
    dtype: the fields' compute dtype, float32 or bfloat16 (JAX
    pdf.py:94): the displacement field, the SDF or NeRF network and the
    color network compute in it, the normals come through it by
    autograd; the KNN, the warp and the opacity stay float32."""

    def __init__(self, num_latents: int, tpose_viewdir: bool = True,
                 xyz_res: int = 10, dtype: torch.dtype = torch.float32):
        super().__init__(xyz_res=xyz_res)
        self.tpose_human = self._canonical(num_latents)
        self.tpose_viewdir = bool(tpose_viewdir)
        set_compute_dtype(self, dtype)

    @staticmethod
    def _canonical(num_latents: int) -> Canonical:
        raise NotImplementedError

    def _warp(self, pose_pts, pose_dirs, pbw, frame):
        """Posed SMPL -> canonical big pose plus the residual
        displacement (JAX pdf.py:103). Returns (tpose, bigpose dirs)."""
        init_bigpose, tpose_dirs = self._to_bigpose(pose_pts, pose_dirs, pbw,
                                                    frame)
        tpose = init_bigpose + self.residual(init_bigpose, frame["poses"])
        return tpose, tpose_dirs

    def _train_warp(self, wpts, viewdir, z_vals, frame):
        """The families' shared part of the train forward (JAX
        pdf.py:447-454, :658-664, :953-958 dense; :401-421, :571-594,
        :876-900 compacted): wpts (R, S, 3), viewdir (R, 3), z_vals
        (R, S) -> the TrainRows of `_train_filter`, and per row
        init_bigpose, the displacement resd, the canonical points tpose
        = init_bigpose + resd, the head's view directions and the
        canonical box mask `inside`: the warp (:103-129), its parts kept
        for the loss."""
        rows, pose_pts, pose_dirs, pbw, vd = self._train_filter(
            wpts, viewdir, z_vals, frame)
        init_bigpose, tpose_dirs = self._to_bigpose(pose_pts, pose_dirs, pbw,
                                                    frame)
        resd = self.residual(init_bigpose, frame["poses"])
        tpose = init_bigpose + resd
        dirs = tpose_dirs if self.tpose_viewdir else vd
        inside = inside_bounds(tpose, frame["tbounds"], pad=TBOUNDS_PAD)
        return rows, init_bigpose, resd, tpose, dirs, inside


class NeRFHead:
    """NeRF-PDF's canonical head, shared with the aligned families (JAX
    pdf.py:379, aligned.py:96-101, :138-145): `tpose_human.nerf_network`
    (channel 0 the pre-activation density, 1: the feature) and
    `tpose_human.color_network` without normals."""

    @staticmethod
    def _canonical(num_latents: int) -> Canonical:
        return Canonical(
            nerf_network=GeometricFieldNetwork(),
            color_network=ColorNetwork(num_latents, use_normals=False),
        )

    def _eval_head(self, tpose, dirs, latent_index: int, sidx, z_vals):
        """rgb and alpha = 1 - exp(-relu(sigma) * dist) over the real
        sample spacing, the last interval repeated (JAX pdf.py:379);
        sidx may be slice(None), every sample of the grid (training)."""
        out = self.tpose_human.nerf_network(tpose)
        dists = z_vals_to_dists(z_vals).reshape(-1)[sidx]
        alpha = raw_alpha_from_sigma(out[:, 0], dists)
        rgb = self.tpose_human.color_network(tpose, None, dirs, out[:, 1:],
                                             latent_index)
        return rgb, alpha


class NeRFPDF(NeRFHead, _PDFBase):
    """Displacement field + softplus canonical NeRF (JAX pdf.py:353;
    reference aligned_aninerf_pdf_network.py), with `NeRFHead`."""

    def train_forward(self, wpts, viewdir, z_vals, frame):
        """Train forward (JAX pdf.py:447-468 dense, :401-445 compacted):
        wpts (R, S, 3), viewdir (R, 3), z_vals (R, S) -> raw (R, S, 4),
        rgb and the alpha over the sample spacing (`_eval_head` on
        every row) zeroed outside the box and off the rows (the filter,
        or the survivors), and per row resd and its mask; the loss is
        then the offset and the image terms."""
        rows, _, resd, tpose, dirs, inside = self._train_warp(
            wpts, viewdir, z_vals, frame)
        rgb, alpha = self._eval_head(tpose, dirs, int(frame["latent_index"]),
                                     rows.index, z_vals)
        raw = torch.cat([rgb, alpha[:, None]], dim=-1)
        return {"raw": rows.dense(torch.where(inside[:, None], raw, 0.0)),
                "resd": resd, "resd_mask": rows.mask}


class _SDFFamily(_PDFBase):
    """The families with an SDF network (`tpose_human.sdf_network`):
    its normals, the observed-space normal and the dense train forward,
    which differ between the families only in the opacity
    (`_train_alpha`)."""

    def _sdf_and_grad(self, tpose, create_graph: bool = False):
        """sdf (N, 1), feature (N, 256) and d sdf / d point (N, 3) (JAX
        pdf.py:492). The network is pointwise, so the gradient of the
        summed sdf is every point's own. For eval it runs under
        enable_grad on a detached copy, inside an otherwise gradient-free
        render, and returns detached values; with `create_graph`
        (training) it differentiates `tpose` itself and the gradient
        stays on the graph, so a loss on it reaches every weight."""
        if create_graph:
            if not tpose.requires_grad:
                tpose = tpose.detach().requires_grad_(True)
            out = self.tpose_human.sdf_network(tpose)
            (grad,) = torch.autograd.grad(out[:, 0].sum(), tpose,
                                          create_graph=True)
            return out[:, :1], out[:, 1:], grad
        with torch.enable_grad():
            x = tpose.detach().requires_grad_(True)
            out = self.tpose_human.sdf_network(x)
            (grad,) = torch.autograd.grad(out[:, 0].sum(), x)
        out = out.detach()
        return out[:, :1], out[:, 1:], grad

    def _observed_grad(self, init_bigpose, frame, create_graph: bool = True):
        """d/dx [sdf(x + resd(x))] at the detached big-pose points (JAX
        pdf.py:509; reference anisdf_pdf_network.py:140-154): the
        displacement field's second K1 launch of a step, differentiated
        with a graph, so the eikonal loss on it reaches the displacement
        field through the gradient of K1's gradient. Without
        `create_graph` (the mesh re-pose) it returns a detached value and
        may run inside no_grad."""
        with torch.enable_grad():
            x = init_bigpose.detach().requires_grad_(True)
            sdf = self.tpose_human.sdf_network(
                x + self.residual(x, frame["poses"]))[:, 0]
            (grad,) = torch.autograd.grad(sdf.sum(), x,
                                          create_graph=create_graph)
        return grad

    # ------------------------------------------------ mesh extraction
    @torch.no_grad()
    def canonical_sdf(self, tpose):
        """The sdf at canonical points (N, 3) -> (N,) (JAX pdf.py:519;
        sdf_mesh_renderer.py:51-81)."""
        return self.tpose_human.sdf_network(tpose)[:, 0]

    @torch.no_grad()
    def canonical_resd(self, tpose, frame):
        """The displacement field at canonical points (JAX pdf.py:523)."""
        return self.residual(tpose, frame["poses"])

    def _train_alpha(self, sdf_grid):
        """The family's opacity of the dense train points: the step's
        (R, S) grid of sdf, SDF_FILL on masked points (whose alpha the
        caller zeroes) -> alpha (R, S)."""
        raise NotImplementedError

    def train_forward(self, wpts, viewdir, z_vals, frame):
        """Train forward (JAX pdf.py:658-700, :953-990 dense; :552-633,
        :867-933 compacted): wpts (R, S, 3), viewdir (R, 3), z_vals
        (R, S) -> raw (R, S, 4) zeroed outside the box and off the rows,
        sdf (R, S) with SDF_FILL off the rows, and per row resd and its
        mask, the canonical normals `gradients` and their mask, and the
        observed-space normals `observed_gradients` with their mask (rows
        whose |sdf| < OBSERVED_GRAD_BAND). The opacity reads the (R, S)
        sdf grid, so NeuS's CDF sees the dense path's fill at every
        sample off the rows."""
        rows, init_bigpose, resd, tpose, dirs, inside = self._train_warp(
            wpts, viewdir, z_vals, frame)
        sdf, feat, gradients = self._sdf_and_grad(tpose, create_graph=True)
        sdf = sdf[:, 0]
        sdf_grid = rows.dense(sdf, SDF_FILL)
        alpha = self._train_alpha(sdf_grid).reshape(-1)[rows.index]
        rgb = self.tpose_human.color_network(tpose, gradients, dirs, feat,
                                             int(frame["latent_index"]))
        raw = torch.cat([rgb, alpha[:, None]], dim=-1)
        og_mask = rows.mask & (torch.abs(sdf.detach()) < OBSERVED_GRAD_BAND)
        return {
            "raw": rows.dense(torch.where(inside[:, None], raw, 0.0)),
            "sdf": sdf_grid, "resd": resd, "resd_mask": rows.mask,
            "gradients": gradients, "grad_mask": rows.mask,
            "observed_gradients": self._observed_grad(init_bigpose, frame),
            "observed_grad_mask": og_mask,
        }


class SDFPDF(_SDFFamily):
    """Displacement field + VolSDF canonical surface (JAX pdf.py:470;
    reference anisdf_pdf_network.py): `tpose_human.sdf_network`,
    `beta_network` and `color_network` with normals."""

    @staticmethod
    def _canonical(num_latents: int) -> Canonical:
        return Canonical(
            sdf_network=GeometricFieldNetwork(),
            beta_network=BetaNetwork(),
            color_network=ColorNetwork(num_latents),
        )

    def _eval_head(self, tpose, dirs, latent_index: int, sidx=None,
                   z_vals=None):
        """rgb (N, 3) and VolSDF alpha (N,) (JAX pdf.py:542); pointwise,
        with the reference's fixed step, so sidx and z_vals go unread."""
        sdf, feat, normals = self._sdf_and_grad(tpose)
        sigma = volsdf_sigma(sdf[:, 0], self.tpose_human.beta_network())
        rgb = self.tpose_human.color_network(tpose, normals, dirs, feat,
                                             latent_index)
        return rgb, sigma_to_alpha(sigma)

    def _train_alpha(self, sdf_grid):
        """VolSDF's pointwise alpha at the fixed step (JAX pdf.py:668-671)."""
        return sigma_to_alpha(volsdf_sigma(sdf_grid,
                                           self.tpose_human.beta_network()))


class NeuSPDF(_SDFFamily):
    """Displacement field + NeuS canonical surface (JAX pdf.py:701;
    reference anisdf_neus_pdf_network.py): `tpose_human.sdf_network`,
    `variance_network` (the inverse variance) and `color_network` with
    normals. The multi-view carve zeroes a survivor's rgb and alpha but
    leaves its sdf in the (R, S) grid its neighbours' opacity reads (JAX
    pdf.py:755-790, the carve beside the sdf fill, not in it)."""

    carve_in_head = True

    @staticmethod
    def _canonical(num_latents: int) -> Canonical:
        return Canonical(
            sdf_network=GeometricFieldNetwork(),
            variance_network=SingleVarianceNetwork(),
            color_network=ColorNetwork(num_latents),
        )

    def _eval_head(self, tpose, dirs, latent_index: int, sidx, z_vals):
        """rgb (N, 3) and the NeuS alpha (N,) of the survivors (JAX
        pdf.py:851-865): every survivor's sdf, the point the argmin
        forcing turned on included, at its place in the tile's (R, S)
        grid and SDF_FILL at every other sample, so a sample's CDF
        neighbour is the next sample of its ray; the last sample of a
        ray takes the residual before it."""
        sdf, feat, normals = self._sdf_and_grad(tpose)
        rgb = self.tpose_human.color_network(tpose, normals, dirs, feat,
                                             latent_index)
        n_rays, n_samples = z_vals.shape
        grid = torch.full((n_rays * n_samples,), SDF_FILL, dtype=sdf.dtype,
                          device=sdf.device)
        grid[sidx] = sdf[:, 0]
        alpha = neus_alpha(grid.reshape(n_rays, n_samples),
                           self.tpose_human.variance_network())
        return rgb, alpha.reshape(-1)[sidx]

    def _train_alpha(self, sdf_grid):
        """NeuS's alpha on the step's own (R, S) grid (JAX pdf.py:962-966):
        every point of a ray is in it, so a sample's CDF neighbour is the
        next sample of its ray with no scatter; the gradient reaches the
        SDF network, the displacement field and the variance through the
        kept points' sdf."""
        return neus_alpha(sdf_grid, self.tpose_human.variance_network())
