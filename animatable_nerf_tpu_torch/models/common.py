"""Shared helpers of the model layer.

JAX counterpart: animatable_nerf_tpu/models/common.py (the subset the
AniNeRF and displacement-field eval and train paths use, the compacted
train paths' `compact_payload` :530 and `scatter_compacted_raw` :566,
and the slab pre-filter's `compact_segments` :263,
`occupied_supercell_boxes` :288, `slab_span` :348 and
`slab_segment_keep` :398, all without their capacities' dead slots: the
port compacts exactly).
"""

from __future__ import annotations

import torch

from ..core.grid import grid_corner_distance_bound, grid_corner_distance_upper
from ..core.knn import sample_blend_closest_points
from ..ops.knn import knn_blend_blocked

# sdf of masked points (anisdf_pdf_network.py:218-219), and NeuS's fill
# of the non-survivors in a ray's CDF (sdf_utils.py:40-61)
SDF_FILL = 10.0
# the slab boxes' "infinity" (far beyond any scene coordinate or ray
# parameter, small enough that the slab arithmetic stays finite) and
# their inflation against float32 rounding (JAX common.py:276-281)
SLAB_BIG = 1e8
SLAB_EPS = 1e-4


def keep_mask_with_argmin(norm_vals, threshold):
    """mask = norm_vals < threshold, with the argmin point forced on
    (the reference's keep-at-least-one, tpose_nerf_network.py:153-154).
    Non-finite values become +inf first, so they never win the argmin;
    ties go to the first index, as in jnp.argmin."""
    norm_vals = torch.where(
        torch.isfinite(norm_vals), norm_vals,
        torch.full_like(norm_vals, float("inf")),
    )
    mask = norm_vals < threshold
    if mask.numel():
        mask[torch.argmin(norm_vals)] = True
    return mask


def compact_indices(keep):
    """The exact, stable compaction of a keep mask (N,): the indices of
    its True entries, ascending (JAX `compact_payload` without a
    capacity, so without dead slots or overflow)."""
    return torch.nonzero(keep).squeeze(1)


def scatter_compacted(rows, sidx, n_rays: int, n_samples: int,
                      fill: float = 0.0):
    """Survivors' rows (K, ...) at their flat sample indices sidx (K,)
    laid out over the dense (R, S, ...) grid, `fill` at every other
    sample: the raw (K, 4) with fill 0 (JAX `scatter_compacted_raw`),
    the sdf (K,) with SDF_FILL (JAX pdf.py:619-621). Out of place, so it
    stays on the graph, and its gradient, a gather, stays differentiable
    under create_graph."""
    out = rows.new_full((n_rays * n_samples, *rows.shape[1:]), fill)
    return out.index_put((sidx,), rows).reshape(n_rays, n_samples,
                                                 *rows.shape[1:])


class TrainRows:
    """Where a train forward's rows lie among the step's R*S sampled
    points (flat index r * S + s). On the dense masked path
    (`train_keep_frac` 0) a row is every point and `mask` is the filter;
    on the compacted path a row is an exact survivor, at its ascending
    flat index in `sidx`, and `mask` is all True. Either way the losses'
    point terms are masked means over `mask`, so they agree. `index`
    selects the rows from a flat per-point tensor."""

    def __init__(self, mask, n_rays: int, n_samples: int, sidx=None):
        self.mask, self.sidx = mask, sidx
        self.index = slice(None) if sidx is None else sidx
        self.n_rays, self.n_samples = n_rays, n_samples

    @classmethod
    def compacted(cls, sidx, n_rays: int, n_samples: int):
        return cls(torch.ones_like(sidx, dtype=torch.bool), n_rays,
                   n_samples, sidx)

    def dense(self, x, fill: float = 0.0):
        """Per-row x (rows, ...) -> (R, S, ...): `fill` off the mask
        (dense) or off the survivors (compacted)."""
        if self.sidx is not None:
            return scatter_compacted(x, self.sidx, self.n_rays,
                                     self.n_samples, fill)
        m = self.mask.reshape(-1, *[1] * (x.dim() - 1))
        return torch.where(m, x, fill).reshape(self.n_rays, self.n_samples,
                                               *x.shape[1:])


def consistency_select(sigma, keep, train_th: float):
    """The points a stage-2 consistency loss reads: the density sigma
    (N,) above train_th among `keep` (N,), the argmax of that masked
    density forced on over the call's points (JAX aninerf.py:189-195,
    aligned.py:161-167; reference aninerf_animation_trainer.py:85-90,
    aninerf_sample_animation_trainer.py:113-121). sigma carries no
    graph."""
    d = torch.where(keep, sigma, float("-inf"))
    select = d > train_th
    select[torch.argmax(d)] = True
    return select


class FrameBlendWeights:
    """The posed points' learned blend weights of a model that is its own
    stage-1 `BlendWeightField` and, for novel poses, holds a second one,
    `novel_pose_bw` (AniNeRF, AlignedLBW, AlignedLBWPDF)."""

    def pose_blend_weights(self, pose_pts, smpl_bw, frame):
        """With the frame's `novel_pose`, `novel_pose_bw` at its
        `bw_latent_index`; otherwise the stage-1 field at `latent_index +
        1` (JAX aninerf.py:157-167, aligned.py:452-461, :531-538)."""
        if frame.get("novel_pose"):
            return self.novel_pose_bw.blend_weights(
                pose_pts, smpl_bw, int(frame["bw_latent_index"]))
        return self.blend_weights(pose_pts, smpl_bw,
                                  int(frame["latent_index"]) + 1)


def substitute_masked(pose_pts, pind, safe_point):
    """Masked-out rows of pose_pts (N, 3) replaced by `safe_point` (3,)
    before the blend-weight field and the LBS warp (JAX common.py:25).
    The dense train path evaluates every point; far from the body the
    learned blend can drift to a singular LBS matrix, and its inverse
    would send inf/NaN back through the masked loss (nan * 0 = nan in
    both the value and the gradient). Their raw is zeroed and the loss
    masks depend on geometry only, so the loss is unchanged."""
    return torch.where(pind[:, None], pose_pts, safe_point)


def inside_bounds(pts, bounds, pad: float = 0.0):
    """Strict all-axes AABB membership of the box grown by `pad`:
    (N, 3), (2, 3) -> (N,) bool (JAX common.py:166; reference
    tpose_nerf_network.py:186-188)."""
    lo = bounds[0] - pad
    hi = bounds[1] + pad
    return torch.all((pts > lo) & (pts < hi), dim=-1)


def grid_pdist_keep(pose_pts, frame, threshold: float):
    """Conservative pass-1 keep mask from the per-frame packed
    nearest-vertex distance grid (JAX common.py:74; the grid is
    ops/knn.py `build_pdist_payload`, attached by the engine).

    The bound is the 8-corner Lipschitz maximum of
    `grid_corner_distance_bound` minus the border-clamp excess of points
    outside the grid; points farther than `threshold` outside the grid
    bounds are dropped. The result is a superset of {min-dist <
    threshold}, hence of the exact IDW-weighted filter set, with the
    argmin of the bound forced on and 1e-5 of slack."""
    lb, excess = _frame_grid_read(grid_corner_distance_bound, pose_pts, frame,
                                  "pdist_packed")
    inside = inside_bounds(pose_pts, frame["pdist_bounds"], pad=threshold)
    return keep_mask_with_argmin(
        torch.where(inside, lb - excess, torch.full_like(lb, float("inf"))),
        threshold + 1e-5,
    )


def _frame_grid_read(reader, pose_pts, frame, key):
    """reader(packed, pts01, cell) over the frame's corner-packed grid
    `key` on the box frame["pdist_bounds"], and each point's distance
    outside that box (the border clamp's excess)."""
    mn, mx = frame["pdist_bounds"][0], frame["pdist_bounds"][1]
    res_cells = torch.tensor(frame[key].shape[:3], dtype=torch.float32,
                             device=pose_pts.device)
    bound = reader(frame[key], (pose_pts - mn) / (mx - mn), (mx - mn) / res_cells)
    excess = torch.linalg.norm(
        torch.clamp(torch.maximum(mn - pose_pts, pose_pts - mx), min=0.0),
        dim=-1,
    )
    return bound, excess


def grid_d5_upper(pose_pts, frame):
    """Certified upper bound (N,) of each point's 5th-nearest-vertex
    distance from the frame's d5 grid (JAX common.py:123; the grid is
    ops/knn.py `build_d5_payload`, on the box of the distance grid): the
    8-corner Lipschitz minimum of `grid_corner_distance_upper` plus the
    border-clamp excess and 1e-5 of slack. It drives K5's cull."""
    ub, excess = _frame_grid_read(grid_corner_distance_upper, pose_pts, frame,
                                  "d5_packed")
    return ub + excess + 1e-5


def knn_blend_for_frame(pose_pts, frame):
    """Pass-2 KNN over the frame's posed vertices (JAX common.py:144):
    (N, 3) -> (pbw (N, 24), wdist (N, 1)).

    When the engine attached the blocked tensors (`knn_blocked`:
    d5_packed, knn_verts, knn_values, knn_bboxes), the block-culled K5
    under the grid_d5_upper radius; otherwise the flat K2. On the CPU
    each takes its plain version. Unlike JAX, which takes the blocked
    path only on a TPU (common.py:155) and the flat one elsewhere, the
    port takes it on every device. The two agree except on exact-distance
    ties, which K5 breaks in Morton order."""
    if "knn_verts" in frame:
        return knn_blend_blocked(
            pose_pts.contiguous(), grid_d5_upper(pose_pts, frame),
            frame["knn_verts"], frame["knn_values"], frame["knn_bboxes"],
        )
    return sample_blend_closest_points(pose_pts, frame["pvertices"],
                                       frame["weights"])


def raw_alpha_from_sigma(sigma, dists):
    """alpha = 1 - exp(-relu(sigma) * dists) (tpose_nerf_network.py:201)."""
    return 1.0 - torch.exp(-torch.relu(sigma) * dists)


def volume_lipschitz_bound(vol, bounds):
    """Certified Lipschitz bound of a trilinearly interpolated volume
    vol (D, H, W) over bounds (2, 3): per-axis max adjacent-sample
    difference over the cell size, combined in the 2-norm."""
    sizes = torch.tensor(vol.shape, dtype=vol.dtype, device=vol.device)
    cell = (bounds[1] - bounds[0]) / torch.clamp(sizes - 1.0, min=1.0)
    lx = torch.max(torch.abs(torch.diff(vol, dim=0))) / cell[0]
    ly = torch.max(torch.abs(torch.diff(vol, dim=1))) / cell[1]
    lz = torch.max(torch.abs(torch.diff(vol, dim=2))) / cell[2]
    return torch.sqrt(lx * lx + ly * ly + lz * lz)


def occupied_supercell_boxes(dist_vol, bounds, threshold: float,
                             supercell: int, capacity: int):
    """World boxes of the occupied supercells of a trilinear distance
    volume dist_vol (D, H, W) over bounds (2, 3) (JAX common.py:288):
    a cell can hold a point whose interpolated distance is under
    `threshold` only if one of its corners is (the interpolant is
    multilinear), so the occupied cells are exact and conservative;
    they are grouped in supercell^3 blocks, and each occupied block
    gives a box grown by SLAB_EPS, its faces on the volume's border
    pushed to +-SLAB_BIG (border padding reads the border cell).
    Returns (lo (B, 3), hi (B, 3), overflow): the first `capacity`
    occupied blocks in index order, as JAX's stable compaction keeps
    them (JAX's dead slots are left out), and whether there were more,
    when the boxes are not conservative."""
    D, H, W = dist_vol.shape
    cmin = torch.minimum(dist_vol[:-1], dist_vol[1:])
    cmin = torch.minimum(cmin[:, :-1], cmin[:, 1:])
    cmin = torch.minimum(cmin[:, :, :-1], cmin[:, :, 1:])
    cells = (D - 1, H - 1, W - 1)
    s = supercell
    nd, nh, nw = (-(-c // s) for c in cells)
    occ = torch.zeros(nd * s, nh * s, nw * s, dtype=torch.bool,
                      device=dist_vol.device)
    occ[:cells[0], :cells[1], :cells[2]] = cmin < threshold
    sup = occ.reshape(nd, s, nh, s, nw, s).any(dim=5).any(dim=3).any(dim=1)
    idx = compact_indices(sup.reshape(-1))
    overflow = idx.numel() > capacity
    idx = idx[:capacity]
    lo_c = torch.stack([idx // (nh * nw), (idx // nw) % nh, idx % nw],
                       dim=-1) * s
    top = torch.tensor(cells, device=idx.device)
    hi_c = torch.minimum(lo_c + s, top)
    cell = (bounds[1] - bounds[0]) / (
        torch.tensor((D, H, W), dtype=dist_vol.dtype, device=idx.device) - 1.0)
    lo = bounds[0] + lo_c.to(dist_vol.dtype) * cell - SLAB_EPS
    hi = bounds[0] + hi_c.to(dist_vol.dtype) * cell + SLAB_EPS
    lo = torch.where(lo_c == 0, -SLAB_BIG, lo)
    hi = torch.where(hi_c == top, SLAB_BIG, hi)
    return lo, hi, bool(overflow)


def slab_span(ray_o, ray_d, lo, hi, chunk: int = 512):
    """Each ray's union span over the boxes it hits (JAX common.py:348):
    ray_o, ray_d (R, 3), boxes lo, hi (B, 3) -> (span_lo, span_hi) (R,),
    the least entry and the largest exit parameter t (point = ray_o + t
    ray_d), (+inf, -inf) where the ray hits none. Entry and exit are
    picked by the direction's sign; the boxes go in chunks, so the
    (R, chunk, 3) temporaries stay bounded."""
    inv = 1.0 / torch.where(torch.abs(ray_d) < 1e-12,
                            torch.full_like(ray_d, 1e-12), ray_d)
    pos = (inv >= 0)[:, None, :]
    n = ray_o.shape[0]
    span_lo = torch.full((n,), float("inf"), device=ray_o.device)
    span_hi = torch.full((n,), float("-inf"), device=ray_o.device)
    for c in range(0, lo.shape[0], chunk):
        t0 = (lo[None, c:c + chunk] - ray_o[:, None]) * inv[:, None]
        t1 = (hi[None, c:c + chunk] - ray_o[:, None]) * inv[:, None]
        enter = torch.where(pos, t0, t1).amax(dim=-1)
        exit_ = torch.where(pos, t1, t0).amin(dim=-1)
        hit = exit_ >= enter
        span_lo = torch.minimum(span_lo, torch.where(
            hit, enter, float("inf")).amin(dim=-1))
        span_hi = torch.maximum(span_hi, torch.where(
            hit, exit_, float("-inf")).amax(dim=-1))
    return span_lo, span_hi


def slab_segment_keep(span_lo, span_hi, z_vals, seg: int):
    """The segments of `seg` consecutive samples whose [z_first, z_last]
    meets their ray's span (JAX common.py:398): (R * S / seg,) bool, row
    major. A sample can pass the exact filter only inside an occupied
    box, hence inside its ray's span. Where no segment is kept, the
    first is, as JAX forces its argmax on."""
    n_rays, n_samples = z_vals.shape
    zs = z_vals.reshape(n_rays, n_samples // seg, seg)
    keep = ((span_lo[:, None] <= zs[..., -1])
            & (span_hi[:, None] >= zs[..., 0])).reshape(-1)
    keep[torch.argmax(keep.to(torch.uint8))] = True
    return keep
