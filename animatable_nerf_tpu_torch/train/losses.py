"""The training loss of the ported families.

JAX counterpart: animatable_nerf_tpu/train/losses.py (`masked_mean`
:17, `smooth_l1` :35, `compute_losses` :70; reference
lib/train/trainers/tpose_trainer.py:21-73). Ported are the terms that
AniNeRF's render emits: the blend-weight consistency and the image MSE.
"""

from __future__ import annotations

import torch

# what the ported render returns beside the loss inputs; any other key
# belongs to a loss term of a family not ported yet
_RENDER_KEYS = frozenset(("raw", "rgb_map", "acc_map", "depth_map",
                          "weights", "z_vals"))
_LOSS_KEYS = frozenset(("pbw", "tbw", "bw_mask"))


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


def compute_losses(ret: dict, batch: dict):
    """(loss, stats) of one rendered batch: the blend-weight consistency
    smooth_l1(pbw, tbw) over bw_mask, plus the image MSE over the rays
    inside the box (`mask_at_box`) and not padding (`mask`). Raises on
    any output of a loss family that is not ported."""
    unknown = set(ret) - _RENDER_KEYS - _LOSS_KEYS
    if unknown:
        raise NotImplementedError(
            f"loss terms for {sorted(unknown)} are not ported yet")
    stats = {}
    loss = 0.0
    if "pbw" in ret and "tbw" in ret:
        bw_loss = masked_mean(smooth_l1(ret["pbw"], ret["tbw"]),
                              ret["bw_mask"])
        stats["bw_loss"] = bw_loss
        loss = loss + bw_loss
    sel = batch["mask_at_box"]
    if "mask" in batch:
        sel = sel & batch["mask"]
    img_loss = masked_mean((ret["rgb_map"] - batch["rgb"]) ** 2, sel)
    stats["img_loss"] = img_loss
    loss = loss + img_loss
    stats["loss"] = loss
    return loss, stats
