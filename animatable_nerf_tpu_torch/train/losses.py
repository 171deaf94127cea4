"""The training loss of the ported families.

JAX counterpart: animatable_nerf_tpu/train/losses.py (`masked_mean`
:17, `smooth_l1` :35, `bce_with_logits` :41, `sdf_mask_alpha` :50,
`compute_losses` :70; reference lib/train/trainers/tpose_trainer.py:
21-73 and crit.py:5-19). Ported are the terms the AniNeRF and
displacement-field renders emit: the displacement offset, the two
eikonal terms, the blend-weight consistency, the SDF silhouette BCE and
the image MSE (NeRF-PDF's render emits only the offset's inputs; the
two SDF families', SDF-PDF's and NeuS-PDF's, all but the blend
weights').
"""

from __future__ import annotations

import torch

from ..core.numerics import safe_norm

# what the ported render returns beside the loss inputs; any other key
# belongs to a loss term of a family or an option not ported yet (JAX's
# train-time compaction reports compact_overflow*, which the port's exact
# compaction has no counterpart for)
_RENDER_KEYS = frozenset(("raw", "rgb_map", "acc_map", "depth_map",
                          "weights", "z_vals", "sdf"))
_LOSS_KEYS = frozenset((
    "pbw", "tbw", "bw_mask", "resd", "resd_mask", "gradients", "grad_mask",
    "observed_gradients", "observed_grad_mask", "msk_sdf", "msk_free",
    "msk_in"))
# the silhouette alpha doubles after each of these steps (crit.py:5-16)
MASK_ALPHA_MILESTONES = (10000, 20000, 30000, 40000, 50000)


def masked_mean(x, mask):
    """Mean of x over the rows where mask is True; 0 for an empty mask.
    A mask with fewer dims than x selects whole rows. where() rather
    than x * mask: a non-finite x in a masked-out row must not reach
    the sum (nan * 0 = nan)."""
    mask = mask.to(x.dtype)
    while mask.dim() < x.dim():
        mask = mask[..., None]
    mask = mask.expand(x.shape)
    count = torch.sum(mask)
    sel = torch.where(mask > 0, x, 0.0)
    return torch.sum(sel) / torch.clamp(count, min=1.0)


def smooth_l1(x, y):
    """Elementwise smooth-L1 (torch's default beta 1)."""
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def bce_with_logits(logits, labels):
    """Numerically stable binary cross entropy with logits."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sdf_mask_alpha(iter_step: int, alpha_max: float = 0.0) -> float:
    """The silhouette BCE's doubling alpha: 50 * 2^(milestones passed,
    strictly, by `iter_step`), capped at `alpha_max` when that is > 0
    (config `sdf_mask_alpha_max`; 0, the default, is the reference's
    schedule)."""
    alpha = 50.0 * 2.0 ** sum(int(iter_step) > m for m in MASK_ALPHA_MILESTONES)
    if alpha_max and alpha_max > 0:
        alpha = min(alpha, float(alpha_max))
    return alpha


def compute_losses(ret: dict, batch: dict, iter_step: int = 0,
                   mask_alpha_max: float = 0.0):
    """(loss, stats) of one rendered batch, the terms in JAX's order:
    0.01 x mean ||resd|| over resd_mask; 0.01 x the eikonal terms
    mean (||g|| - 1)^2 of `gradients` over grad_mask and of
    `observed_gradients` over observed_grad_mask (norms with a zero
    gradient at 0, `safe_norm`); the blend-weight consistency
    smooth_l1(pbw, tbw) over bw_mask; the silhouette BCE on
    -alpha x msk_sdf (label msk_in, over msk_free | msk_in) over alpha,
    alpha from `sdf_mask_alpha(iter_step, mask_alpha_max)`; and the
    image MSE over the rays inside the box (`mask_at_box`) and not
    padding (`mask`). `iter_step` counts the frames trained on before
    this step. Every point term is a masked mean, so the compacted train
    forward's rows (the exact survivors, mask all True) give the dense
    path's value. Raises on any output of a loss family or option that
    is not ported."""
    unknown = set(ret) - _RENDER_KEYS - _LOSS_KEYS
    if unknown:
        raise NotImplementedError(
            f"loss terms for {sorted(unknown)} are not ported yet")
    stats = {}
    loss = 0.0
    if "resd" in ret:
        offset_loss = masked_mean(safe_norm(ret["resd"], dim=-1),
                                  ret["resd_mask"])
        stats["offset_loss"] = offset_loss
        loss = loss + 0.01 * offset_loss
    for key, mask, name in (("gradients", "grad_mask", "grad_loss"),
                            ("observed_gradients", "observed_grad_mask",
                             "ograd_loss")):
        if key in ret:
            term = masked_mean((safe_norm(ret[key], dim=-1) - 1.0) ** 2,
                               ret[mask])
            stats[name] = term
            loss = loss + 0.01 * term
    if "pbw" in ret and "tbw" in ret:
        bw_loss = masked_mean(smooth_l1(ret["pbw"], ret["tbw"]),
                              ret["bw_mask"])
        stats["bw_loss"] = bw_loss
        loss = loss + bw_loss
    if "msk_sdf" in ret:
        alpha = sdf_mask_alpha(iter_step, mask_alpha_max)
        logits = -alpha * ret["msk_sdf"]
        labels = ret["msk_in"].to(logits.dtype)  # 1 inside, 0 free
        mask_loss = masked_mean(bce_with_logits(logits, labels),
                                ret["msk_free"] | ret["msk_in"]) / alpha
        stats["mask_loss"] = mask_loss
        loss = loss + mask_loss
    sel = batch["mask_at_box"]
    if "mask" in batch:
        sel = sel & batch["mask"]
    img_loss = masked_mean((ret["rgb_map"] - batch["rgb"]) ** 2, sel)
    stats["img_loss"] = img_loss
    loss = loss + img_loss
    stats["loss"] = loss
    return loss, stats
