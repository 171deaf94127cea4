"""The optimizer and learning-rate schedules.

JAX counterpart: animatable_nerf_tpu/train/optim.py (`exponential_lr`
:13, `make_schedule` :39, `make_optimizer` :64; reference
lib/train/optimizer.py, lib/utils/optimizer/lr_scheduler.py, the value
clip 40 of trainer.py:67). JAX chains optax.clip(40) and optax.adam with
the schedule evaluated at the optimizer's update count; here
`clip_grad_value_(40)` and `torch.optim.Adam(eps=1e-8)`, whose learning
rate the trainer sets from the schedule before every update. Only Adam
without weight decay is ported; `radam`, `sgd` and `weight_decay` > 0
raise. Stage 2 gives the optimizer only the trainable set
(`novel_pose_bw`), the rest frozen: JAX's optax.multi_transform of the
chain and set_to_zero (:83-95) leaves those exactly as they are too.
"""

from __future__ import annotations

import torch

CLIP_VALUE = 40.0


def exponential_lr(base_lr: float, gamma: float, decay_epochs: int,
                   ep_iter: int):
    """lr(step) = base_lr * gamma ** ((step // ep_iter) / decay_epochs)."""

    def sched(step):
        return base_lr * gamma ** ((step // ep_iter) / decay_epochs)

    return sched


def multi_step_lr(base_lr: float, milestones, gamma: float, ep_iter: int):
    """MultiStepLR: base_lr * gamma ** (milestones passed by the epoch)."""

    def sched(step):
        epoch = step // ep_iter
        return base_lr * gamma ** sum(epoch >= m for m in milestones)

    return sched


def make_schedule(cfg):
    """The config's schedule: `exponential`, `multi_step`, or
    `warmup_multi_step` (a linear warmup from warmup_factor over
    warmup_iters, then the multi-step decay)."""
    s = cfg.train.scheduler
    ep_iter = max(cfg.ep_iter, 1)
    if s["type"] == "exponential":
        return exponential_lr(cfg.train.lr, s["gamma"], s["decay_epochs"],
                              ep_iter)
    base = multi_step_lr(cfg.train.lr, s["milestones"], s["gamma"], ep_iter)
    if s["type"] != "warmup_multi_step":
        return base
    warmup_iters = int(s.get("warmup_iters", 500))
    warmup_factor = float(s.get("warmup_factor", 1.0 / 3))

    def sched(step):
        if step >= warmup_iters:
            return base(step)
        frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        return base(step) * (warmup_factor * (1 - frac) + frac)

    return sched


def make_optimizer(cfg, params):
    """Adam (betas 0.9, 0.999; eps 1e-8) over `params`; its lr is set
    per update by the trainer from `make_schedule(cfg)`."""
    name = cfg.train.get("optim", "adam")
    if name != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported (adam is)")
    if float(cfg.train.get("weight_decay", 0.0)) > 0:
        raise NotImplementedError("weight decay (adamw) is not ported")
    return torch.optim.Adam(params, lr=float(cfg.train.lr),
                            betas=(0.9, 0.999), eps=1e-8)
