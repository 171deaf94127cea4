"""SDF-PDF: pose-dependent displacement field + VolSDF canonical
surface, eval path.

JAX counterpart: animatable_nerf_tpu/models/pdf.py (`_PDFBase._warp`
:103, `_compact_inputs` :138 conservative branch, `_eval_compacted`
:282, `SDFPDF` :470 with `_sdf_and_grad` :492 and `_eval_head` :542;
reference anisdf_pdf_network.py). NeRF-PDF and NeuS-PDF are not ported
yet.

The point filter keeps the JAX semantics:
  * pass 1 reads the per-frame nearest-vertex distance grid (built by
    kernel K3, `grid_pdist_keep`): a certified superset of the
    survivors, with the argmin of the bound forced on;
  * pass 2 runs kernel K2 on the candidates (or, with `knn_blocked`,
    K5 over the vertex blocks within each candidate tile's certified
    5-NN radius): IDW blend weights over the posed vertices and the
    weighted distance, whose exact filter (< NORM_TH) is re-applied with
    its argmin over the candidates forced on.
Forcing happens once per call, i.e. once per eval tile. The JAX package
compacts into fixed capacities twice (pass 1, then the stage-2
re-compaction to the exact survivors, `stage2_ratio`) and parks dead
slots on bone 0; the port compacts exactly with torch.nonzero, so it has
neither capacities nor dead slots. The warp, the displacement field
(K1), the SDF network with its autograd normals and the color network
run on the exact survivors only.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.composite import composite_compacted
from ..core.lbs import (
    backward_warp_points_dirs,
    world_dirs_to_pose_dirs,
    world_points_to_pose_points,
)
from ..core.sdf import sigma_to_alpha, volsdf_sigma
from ..fields.fields import (
    BetaNetwork,
    ColorNetwork,
    GeometricFieldNetwork,
    ResidualField,
)
from .common import (
    grid_pdist_keep,
    inside_bounds,
    keep_mask_with_argmin,
    knn_blend_for_frame,
)

NORM_TH = 0.1  # hard-coded in the pdf models (anisdf_pdf_network.py:172)
TBOUNDS_PAD = 0.05  # canonical bbox growth (JAX pdf.py:344)


class TPoseSDF(nn.Module):
    """The canonical networks, under the reference's `tpose_human.`
    prefix: `sdf_network`, `beta_network`, `color_network`."""

    def __init__(self, num_latents: int):
        super().__init__()
        self.sdf_network = GeometricFieldNetwork()
        self.beta_network = BetaNetwork()
        self.color_network = ColorNetwork(num_latents)


class SDFPDF(ResidualField):
    """The module is the displacement field itself (`resd_linears`,
    `resd_fc` at the top level, as in the reference network) plus
    `tpose_human`, so its state dict has the reference's names.

    num_latents: rows of the color latent table (num_latent_code)."""

    # pass 1 needs the per-frame distance grid (ops/knn.py
    # build_pdist_payload), which the engine attaches to the frame
    knn_pass1 = True
    # the per-frame tensors the engine moves to the device
    frame_keys = ("A", "big_A", "poses", "weights", "pvertices", "tbounds",
                  "R", "Th")

    def __init__(self, num_latents: int, tpose_viewdir: bool = True,
                 xyz_res: int = 10):
        super().__init__(xyz_res=xyz_res)
        self.tpose_human = TPoseSDF(num_latents)
        self.tpose_viewdir = bool(tpose_viewdir)

    def _warp(self, pose_pts, pose_dirs, pbw, frame):
        """Posed SMPL -> canonical big pose plus the residual
        displacement (JAX pdf.py:103). Returns (tpose, bigpose dirs)."""
        dirs_in = pose_dirs if self.tpose_viewdir else None
        init_bigpose, tpose_dirs = backward_warp_points_dirs(
            pose_pts, dirs_in, pbw, frame["A"], frame["big_A"]
        )
        tpose = init_bigpose + self.residual(init_bigpose, frame["poses"])
        return tpose, tpose_dirs

    def _sdf_and_grad(self, tpose):
        """sdf (N, 1), feature (N, 256) and d sdf / d point (N, 3) (JAX
        pdf.py:492). The network is pointwise, so the gradient of the
        summed sdf is every point's own; it runs under enable_grad on a
        detached copy, inside an otherwise gradient-free render."""
        with torch.enable_grad():
            x = tpose.detach().requires_grad_(True)
            out = self.tpose_human.sdf_network(x)
            (grad,) = torch.autograd.grad(out[:, 0].sum(), x)
        out = out.detach()
        return out[:, :1], out[:, 1:], grad

    def _eval_head(self, tpose, dirs, latent_index: int):
        """rgb (N, 3) and VolSDF alpha (N,) (JAX pdf.py:542)."""
        sdf, feat, normals = self._sdf_and_grad(tpose)
        sigma = volsdf_sigma(sdf[:, 0], self.tpose_human.beta_network())
        rgb = self.tpose_human.color_network(tpose, normals, dirs, feat,
                                             latent_index)
        return rgb, sigma_to_alpha(sigma)

    @torch.no_grad()
    def forward(self, wpts, viewdir, z_vals, frame):
        """Eval render of one tile: wpts (R, S, 3), viewdir (R, 3),
        z_vals (R, S) -> rgb_map (R, 3), acc_map (R,), depth_map (R,)
        plus the tile's candidate and survivor counts."""
        n_rays, n_samples = z_vals.shape
        pose_pts = world_points_to_pose_points(
            wpts.reshape(-1, 3), frame["R"], frame["Th"]
        )
        # pass 1: the conservative candidates, ascending
        cand = torch.nonzero(
            grid_pdist_keep(pose_pts, frame, NORM_TH)).squeeze(1)
        c_pose = pose_pts[cand]
        c_pbw, c_pnorm = knn_blend_for_frame(c_pose, frame)
        exact = keep_mask_with_argmin(c_pnorm[:, 0], NORM_TH)
        sidx = cand[exact]
        s_dirs = viewdir[sidx // n_samples]
        tpose, tdirs = self._warp(
            c_pose[exact], world_dirs_to_pose_dirs(s_dirs, frame["R"]),
            c_pbw[exact], frame,
        )
        rgb, alpha = self._eval_head(
            tpose, tdirs if self.tpose_viewdir else s_dirs,
            int(frame["latent_index"]),
        )
        keep = inside_bounds(tpose, frame["tbounds"], pad=TBOUNDS_PAD)
        rgb = torch.where(keep[:, None], rgb, 0.0)
        alpha = torch.where(keep, alpha, 0.0)
        rgb_map, acc_map, depth_map = composite_compacted(
            sidx, rgb, alpha, z_vals, n_rays, n_samples
        )
        return {
            "rgb_map": rgb_map, "acc_map": acc_map, "depth_map": depth_map,
            "n_candidates": cand.numel(), "n_survivors": sidx.numel(),
        }
