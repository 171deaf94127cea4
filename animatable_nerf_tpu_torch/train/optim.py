"""The optimizers and learning-rate schedules.

JAX counterpart: animatable_nerf_tpu/train/optim.py (`exponential_lr`
:13, `make_schedule` :39, `make_optimizer` :60-96; reference
lib/train/optimizer.py, lib/utils/optimizer/lr_scheduler.py, the value
clip 40 of trainer.py:67). JAX chains optax.clip(40) with the config's
optimizer, its learning rate the schedule at the update count: `optim
adam` is optax.adam, or optax.adamw with `weight_decay` > 0; `radam` is
optax.radam; any other name optax.sgd with momentum 0.9. RAdam and SGD
ignore `weight_decay`. Here the trainer clips with
`clip_grad_value_(40)` and sets each update's learning rate from the
schedule. Each optimizer is `OptaxUpdate`, which computes optax's
update itself (torch.optim.RAdam, for one, tests its rectification
with a strict > and adds eps to the uncorrected root). Stage 2 gives the
optimizer only the trainable set (`novel_pose_bw`), the rest frozen:
JAX's optax.multi_transform of the chain and set_to_zero leaves those
exactly as they are too, weight decay included.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_VALUE = 40.0
# optax's defaults for adam, adamw and radam, and sgd's momentum here
B1, B2, EPS = 0.9, 0.999, 1e-8
MOMENTUM = 0.9
RADAM_THRESHOLD = 5.0


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


class OptaxUpdate(torch.optim.Optimizer):
    """optax's adam, adamw, radam or sgd (momentum 0.9) update as a torch
    optimizer; each group's `lr` is the schedule's rate, set by the
    trainer before the update. Per parameter the state is optax's:
    `step` (the update count), and `exp_avg`, `exp_avg_sq` (mu, nu) or
    `momentum_buffer` (sgd's trace). Each update is a few `torch._foreach_*`
    calls over the parameters of one count, in optax's order of float32
    operations; factors that depend on the count alone are computed in
    float32, as optax computes them (transform.py `scale_by_adam`,
    `scale_by_radam`, tree_utils `tree_bias_correction`)."""

    KINDS = ("adam", "adamw", "radam", "sgd")

    def __init__(self, params, kind: str, lr: float,
                 weight_decay: float = 0.0):
        if kind not in self.KINDS:
            raise ValueError(f"no optax update {kind!r}")
        super().__init__(params, {"lr": lr})
        self.kind = kind
        self.weight_decay = float(weight_decay) if kind == "adamw" else 0.0

    @staticmethod
    def _factors(count: int):
        """(1 - b1^t, 1 - b2^t, the rectification r or None) at update
        count t, in float32."""
        f = np.float32
        t = f(count)
        b1t, b2t = f(B1) ** t, f(B2) ** t
        ro_inf = f(2.0 / (1.0 - B2) - 1.0)
        ro = ro_inf - f(2.0) * t * b2t / (f(1.0) - b2t)
        r = None
        if ro >= RADAM_THRESHOLD:
            r = np.sqrt((ro - f(4)) * (ro - f(2)) * ro_inf
                        / ((ro_inf - f(4)) * (ro_inf - f(2)) * ro))
        return float(f(1) - b1t), float(f(1) - b2t), r

    def _slots(self, p) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = 0
            keys = (("momentum_buffer",) if self.kind == "sgd"
                    else ("exp_avg", "exp_avg_sq"))
            for key in keys:
                state[key] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            # the parameters with a gradient, by their update count (one
            # count unless a parameter went without a gradient)
            by_count = {}
            for p in group["params"]:
                if p.grad is not None:
                    state = self._slots(p)
                    state["step"] += 1
                    by_count.setdefault(state["step"], []).append(p)
            for count, params in by_count.items():
                self._update(params, count, float(group["lr"]))

    def _update(self, params, count: int, lr: float):
        grads = [p.grad for p in params]
        states = [self.state[p] for p in params]
        if self.kind == "sgd":
            # optax.trace: g + decay * trace
            u = [s["momentum_buffer"] for s in states]
            torch._foreach_mul_(u, MOMENTUM)
            torch._foreach_add_(u, grads)
            u = torch._foreach_mul(u, -lr)
            torch._foreach_add_(params, u)
            return
        mu = [s["exp_avg"] for s in states]
        nu = [s["exp_avg_sq"] for s in states]
        # (1 - b1) g + b1 mu; (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - B1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - B2)
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, g2)
        c1, c2, r = self._factors(count)
        u = torch._foreach_div(mu, c1)
        radam = self.kind == "radam"
        if not radam or r is not None:
            # [r] mu_hat / (sqrt(nu_hat) + eps); RAdam before its
            # rectification starts takes mu_hat alone
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, EPS)
            if radam:
                torch._foreach_mul_(u, float(r))
            torch._foreach_div_(u, denom)
        if self.weight_decay:  # adamw: the decayed weights
            torch._foreach_add_(u, torch._foreach_mul(params,
                                                      self.weight_decay))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(params, u)


def optimizer_kind(cfg) -> str:
    """The optax optimizer JAX `make_optimizer` builds for the config:
    adam, adamw (adam with weight_decay > 0), radam or sgd (any other
    name)."""
    name = cfg.train.get("optim", "adam")
    if name == "adam":
        return "adamw" if float(cfg.train.get("weight_decay", 0.0)) > 0 \
            else "adam"
    return "radam" if name == "radam" else "sgd"


def make_optimizer(cfg, params):
    """The config's optimizer over `params` (`optimizer_kind`, betas
    0.9, 0.999, eps 1e-8) as an `OptaxUpdate`; its lr is set per update
    by the trainer from `make_schedule(cfg)`."""
    return OptaxUpdate(params, optimizer_kind(cfg), float(cfg.train.lr),
                       float(cfg.train.get("weight_decay", 0.0)))
