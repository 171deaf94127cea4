"""Volume rendering: eval rays in fixed-size tiles, for every ported
model (AniNeRF, NeRF-PDF, SDF-PDF, NeuS-PDF, the aligned families), each
taking one tile's samples and compositing its own maps, optionally
carved by the training views' masks; and a training ray batch through a
model's dense train path, with the SDF models' silhouette tensors.

JAX counterpart: animatable_nerf_tpu/render/renderer.py (`pad_rays`
:63-88, `render_rays` :159-320 with the silhouette tensors :305-319,
`render_image` :329-384; the carve `inside_fn` :213-228; the
hierarchical importance sampling :187-214). A dense train call above
`dense_chunk_rows` points runs in ray chunks, as JAX's `apply_model`
(:92-156) runs it: each chunk forces its own filter argmin and density
argmax, so the chunking changes the step (`render_rays_train`). JAX
also chunks dense eval calls (`eval_keep_frac` 0), a path the port's
eval tiles do not take.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.composite import (
    alpha_weights,
    get_intersection_mask,
    raw2outputs,
    sample_pdf,
)
from ..core.sampling import stratified_z_vals, z_vals_to_pts

_IMAGE_OUTPUTS = ("rgb_map", "acc_map", "depth_map")
_COUNTS = ("n_candidates", "n_survivors", "n_carved")
# counts a model returns on some paths only (AniNeRF's slab pre-filter:
# the samples of its kept segments)
_OPTIONAL_COUNTS = ("n_slab_points",)


class RenderSettings(NamedTuple):
    n_samples: int = 64
    white_bkgd: bool = False
    eval_tile: int = 8192
    # training's stratified jitter (cfg.perturb > 0)
    perturb: bool = False
    # > 0: hierarchical importance sampling at eval (`use_importance`),
    # this many fine samples a ray
    n_importance: int = 0
    # a dense train call above this many points runs in ray chunks (0:
    # never); the trainers keep the default, as JAX's Trainer does
    # (train/trainer.py:263-268)
    dense_chunk_rows: int = 131072


def pad_rays(rays: dict, multiple: int):
    """Pad every per-ray numpy array to the next multiple; returns
    (rays, n_valid). Pad rays are parked far from the scene
    (ray_o = 1e4) so their samples do not pass the point filter, and a
    boolean 'mask' entry marks the real rays."""
    n = rays["ray_o"].shape[0]
    padded_n = int(np.ceil(n / multiple) * multiple)
    pad = padded_n - n
    out = {}
    for k, v in rays.items():
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
            cval = 1e4 if k == "ray_o" else 0
            v = np.pad(np.asarray(v), widths, constant_values=cval)
        out[k] = v
    mask = np.zeros(padded_n, dtype=bool)
    mask[:n] = rays.get("mask", np.ones(n, dtype=bool))
    out["mask"] = mask
    return out, n


def render_rays(model, rays: dict, frame: dict, settings: RenderSettings,
                carve=None):
    """Render one tile of eval rays: ray_o/ray_d (R, 3), near/far (R,),
    optional mask (R,). `carve`, where given, maps world points (N, 3)
    to whether every training view sees them (render/visibility.py
    `prepare_inside_mask`); the model applies it to its survivors' own
    world points (JAX renderer.py:213-228: on the survivors, not on
    every sample). Returns rgb_map/acc_map/depth_map and the model's
    candidate, survivor and carved counts.

    With `settings.n_importance` > 0 (JAX renderer.py:187-214) a coarse
    pass runs the model on the stratified grid and returns its alpha on
    the (R, S) grid (`alpha_grid`: the survivors' alpha, 0 elsewhere);
    `sample_pdf` draws n_importance fine z from the midpoints and the
    weights `raw2outputs` gives that alpha, bar the first and last, and
    the fine pass renders the sorted union of both sets. Only the fine
    pass is carved; a frame's novel pose reaches both. The counts are
    the fine pass's. Without it the model learns that z_vals is the
    plain stratified grid (`analytic_z`, the gate of AniNeRF's slab
    pre-filter)."""
    z_vals = stratified_z_vals(rays["near"], rays["far"], settings.n_samples)
    if settings.n_importance > 0:
        coarse = model(z_vals_to_pts(rays["ray_o"], rays["ray_d"], z_vals),
                       rays["ray_d"], z_vals, frame, alpha_grid=True)
        weights = alpha_weights(coarse["alpha"])
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_fine = sample_pdf(z_mid, weights[..., 1:-1], settings.n_importance)
        z_vals, _ = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1)
    wpts = z_vals_to_pts(rays["ray_o"], rays["ray_d"], z_vals)
    ret = model(wpts, rays["ray_d"], z_vals, frame, carve=carve,
                analytic_z=settings.n_importance == 0)
    rgb_map, acc_map, depth_map = (ret[k] for k in _IMAGE_OUTPUTS)
    if settings.white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    if "mask" in rays:
        m = rays["mask"]
        rgb_map = torch.where(m[:, None], rgb_map, 0.0)
        acc_map = torch.where(m, acc_map, 0.0)
        depth_map = torch.where(m, depth_map, 0.0)
    return {"rgb_map": rgb_map, "acc_map": acc_map, "depth_map": depth_map,
            **{k: ret[k] for k in (*_COUNTS, *_OPTIONAL_COUNTS) if k in ret}}


def render_image(model, rays: dict, frame: dict, settings: RenderSettings,
                 carve=None):
    """Whole-image render over tiles of `settings.eval_tile` rays; `rays`
    must be padded to a multiple of the tile (see pad_rays). The point
    filter's argmin forcing acts once per tile, as in JAX. `carve`: as
    in render_rays."""
    tile = settings.eval_tile
    n = rays["ray_o"].shape[0]
    if n % tile:
        raise ValueError("pad rays to a multiple of eval_tile first")
    outs = []
    for s in range(0, n, tile):
        chunk = {k: v[s:s + tile] for k, v in rays.items()}
        outs.append(render_rays(model, chunk, frame, settings, carve))
    result = {k: torch.cat([o[k] for o in outs]) for k in _IMAGE_OUTPUTS}
    for k in (*_COUNTS, *_OPTIONAL_COUNTS):
        if k in outs[0]:
            result[k] = sum(o[k] for o in outs)
    return result


def train_forward_chunked(model, wpts, viewdir, z_vals, frame, bound: int):
    """`model.train_forward`, in ray chunks of bound // n_samples rays
    where the call is dense (`train_keep_frac` 0) and has more than
    `bound` points (JAX renderer.py:99-156 `apply_model`): the last
    chunk padded with rays whose points sit at 1e4 (outside every
    filter), each chunk its own call, so each forces its own filter
    argmin and density argmax; the outputs, each led by the ray axis
    or by the point axis, joined and cut back to the real rays."""
    n_rays, n_samples = z_vals.shape
    if (not bound or n_rays * n_samples <= bound
            or getattr(model, "train_keep_frac", 0.0) > 0):
        return model.train_forward(wpts, viewdir, z_vals, frame)
    chunk = max(1, bound // n_samples)
    n_chunks = -(-n_rays // chunk)
    pad = n_chunks * chunk - n_rays

    def padded(a, cval):
        return torch.cat([a, a.new_full((pad, *a.shape[1:]), cval)]) \
            if pad else a

    wp, rd, zp = padded(wpts, 1e4), padded(viewdir, 0.0), padded(z_vals, 0.0)
    outs = [model.train_forward(wp[s:s + chunk], rd[s:s + chunk],
                                zp[s:s + chunk], frame)
            for s in range(0, n_chunks * chunk, chunk)]

    def unchunk(key):
        parts = [o[key] for o in outs]
        lead = parts[0].shape[0] if parts[0].dim() else None
        if lead not in (chunk, chunk * n_samples):
            raise ValueError(f"train_forward output {key!r} of shape "
                             f"{tuple(parts[0].shape)}: neither {chunk} "
                             f"rays nor {chunk * n_samples} points lead it")
        return torch.cat(parts)[:n_rays * (lead // chunk)]

    return {k: unchunk(k) for k in outs[0]}


def render_rays_train(model, rays: dict, frame: dict,
                      settings: RenderSettings,
                      generator: torch.Generator | None = None):
    """Render one training batch (JAX render_rays, train branch
    :159-230 with :282-305): z values jittered by `generator` when
    `settings.perturb`, the model's train forward (dense, or compacted
    to the exact survivors with `train_keep_frac` > 0), `raw2outputs`
    with `white_bkgd`, and the maps zeroed on pad rays (`mask`). Returns
    the model's dict (`train_forward_chunked`; AniNeRF: raw, pbw, tbw,
    bw_mask; NeRF-PDF: raw,
    resd, resd_mask; SDF-PDF and NeuS-PDF: raw, sdf, resd, gradients,
    observed_gradients and their masks) plus
    rgb_map, acc_map, depth_map, weights and z_vals; for a model that
    returns `sdf`, with the rays' `occupancy`, also the silhouette
    tensors: msk_sdf, each ray's least sdf; msk_free, the real rays
    outside the mask; msk_in, the real rays inside it whose samples
    never change sign (JAX :305-319, reference tpose_renderer.py:
    134-152)."""
    z_vals = stratified_z_vals(rays["near"], rays["far"], settings.n_samples,
                               perturb=settings.perturb, generator=generator)
    wpts = z_vals_to_pts(rays["ray_o"], rays["ray_d"], z_vals)
    ret = train_forward_chunked(model, wpts, rays["ray_d"], z_vals, frame,
                                settings.dense_chunk_rows)
    rgb_map, _, acc_map, weights, depth_map = raw2outputs(
        ret["raw"], z_vals, settings.white_bkgd)
    if "mask" in rays:
        m = rays["mask"]
        rgb_map = torch.where(m[:, None], rgb_map, 0.0)
        acc_map = torch.where(m, acc_map, 0.0)
        depth_map = torch.where(m, depth_map, 0.0)
    ret.update(rgb_map=rgb_map, acc_map=acc_map, depth_map=depth_map,
               weights=weights, z_vals=z_vals)
    if "sdf" in ret and "occupancy" in rays:
        sdf = ret["sdf"]
        inter = get_intersection_mask(sdf)
        occ = rays["occupancy"]
        valid = rays.get("mask", torch.ones_like(occ, dtype=torch.bool))
        # amin: a tie shares the gradient evenly, as jnp.min's does
        ret.update(msk_sdf=torch.amin(sdf, dim=-1),
                   msk_free=(occ == 0) & valid,
                   msk_in=(~inter) & (occ == 1) & valid)
    return ret
