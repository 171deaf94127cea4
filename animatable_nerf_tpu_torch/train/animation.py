"""Stage-2 training: fit the novel-pose blend-weight field by
consistency with the frozen stage-1 canonical field.

JAX counterpart: animatable_nerf_tpu/train/animation.py
(`uniform_box_points` :29, `animation_loss` :47-68, `AnimationTrainer`
:71-116; reference lib/train/trainers/aninerf_animation_trainer.py).
Each step draws `n_anim_samples` uniform points in the frame's world box
and as many in the canonical box, takes each branch's consistency pair
(`animation_from_pose`, `animation_from_canonical` of AniNeRF,
models/aninerf.py, on its blend-weight volumes; of AlignedLBW and
AlignedLBWPDF, models/aligned.py, on the KNN prior of the frame's posed
and canonical vertices) and sums the smooth-L1 of each pair over its
selected points. Only
`novel_pose_bw` trains: every other parameter is frozen
(`requires_grad_(False)`) and outside the optimizer, so its update is
exactly 0, as JAX's optax.multi_transform with set_to_zero makes it
(train/optim.py:83-95). The points come from the trainer's explicit
torch.Generator, not from JAX's PRNG, so the two packages draw different
points from one seed.
"""

from __future__ import annotations

import torch

from ..core.lbs import world_points_to_pose_points
from .losses import masked_mean, smooth_l1
from .trainer import Trainer

N_ANIM_SAMPLES = 1024 * 64  # aninerf_animation_trainer.py:131


def uniform_box_points(generator: torch.Generator, bounds, n: int):
    """n points uniform in the box bounds (2, 3), drawn from `generator`
    on its device (blend_utils.py:171-181)."""
    u = torch.rand((n, 3), generator=generator, device=bounds.device)
    return bounds[0] + (bounds[1] - bounds[0]) * u


def animation_loss(model, frame: dict, generator: torch.Generator,
                   n_samples: int = N_ANIM_SAMPLES):
    """The stage-2 loss of one frame: (loss, {bw_loss0, bw_loss1,
    loss})."""
    wpts = uniform_box_points(generator, frame["wbounds"], n_samples)
    ppts = world_points_to_pose_points(wpts, frame["R"], frame["Th"])
    pbw0, tbw0, sel0 = model.animation_from_pose(ppts, frame)
    tpts = uniform_box_points(generator, frame["tbounds"], n_samples)
    pbw1, tbw1, sel1 = model.animation_from_canonical(tpts, frame)
    bw_loss0 = masked_mean(smooth_l1(pbw0, tbw0), sel0)
    bw_loss1 = masked_mean(smooth_l1(pbw1, tbw1), sel1)
    loss = bw_loss0 + bw_loss1
    return loss, {"bw_loss0": bw_loss0, "bw_loss1": bw_loss1, "loss": loss}


class AnimationTrainer(Trainer):
    """The stage-2 trainer: `Trainer` with the consistency loss. The
    loader, the dataset's ray draw (unused by the loss, so the numpy
    stream stays JAX's), the epoch loop, the recorder and the
    checkpoints are shared. `model` (AniNeRF, AlignedLBW or
    AlignedLBWPDF) needs its `novel_pose_bw` and the two
    `animation_from_*` pairs; the rest of it is frozen here, before the
    optimizer is made over the trainable set."""

    def __init__(self, cfg, model, device):
        model.requires_grad_(False)
        model.novel_pose_bw.requires_grad_(True)
        super().__init__(cfg, model, device)
        self.n_anim = int(cfg.get("n_anim_samples", N_ANIM_SAMPLES))

    def loss(self, batch):
        """(loss, stats, None) of one frame's collated batch at the
        current weights; the points come from `self.generator`."""
        loss, stats = animation_loss(self.model, self._frame(batch),
                                     self.generator, self.n_anim)
        return loss, stats, None
