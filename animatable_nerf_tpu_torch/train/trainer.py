"""The training step and the epoch loop, single device, one frame a step.

JAX counterpart: animatable_nerf_tpu/train/trainer.py (`collate_rays`
:92, `stack_batch` :134, `Trainer._loss_one` :365, `_train_step` :382,
`train_epoch` :556; reference lib/train/trainers/trainer.py:50-102 and
tpose_trainer.py). One step: the render of one frame's rays, the loss,
its gradient, the value clip at 40 and an Adam update at the schedule's
rate for the update count. The step counter counts the frames trained
on, as in JAX; the loss reads it (the SDF silhouette alpha's schedule).
The model is AniNeRF, a displacement-field family (NeRF-PDF, SDF-PDF,
NeuS-PDF) or an aligned family (LBW, PBW, SMPL, LBWPDF); its
`train_frame_keys` name the frame tensors the trainer moves to the
device. The optimizer takes the parameters that require a
gradient; stage 2 (train/animation.py `AnimationTrainer`) freezes all
but the novel-pose field before it is made. With `train_keep_frac` > 0
the model's train forward runs on each step's exact survivors alone,
and a KNN family's frame carries its nearest-vertex distance grid at
`knn_grid_res` (64 by default on this path, JAX engine.py:1265-1279),
built by kernel K3 once a frame uploaded. JAX builds that grid only into
its device frame store (`frame_store_mb` > 0), which has no counterpart
here; the loss is the same with or without it. JAX's fused multi-step
dispatch (`steps_per_dispatch`), packed stats, device frame store,
compaction capacities with their overflow stats and fallback, and
shard_map data parallelism serve its TPU and its remote relay; the port
has none of them and raises on a config that asks for more than one
step a dispatch or more than one frame a step.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from ..ops.knn import build_pdist_payload
from ..render.renderer import RenderSettings, render_rays_train
from .losses import compute_losses
from .optim import CLIP_VALUE, make_optimizer, make_schedule

RAY_KEYS = ("ray_o", "ray_d", "near", "far", "mask", "occupancy", "rgb",
            "mask_at_box")
# per-frame metadata a collated item carries (JAX trainer.py:27)
FRAME_KEYS = (
    "R", "Th", "A", "big_A", "poses", "weights", "pvertices", "tvertices",
    "pbw", "tbw", "pbounds", "tbounds", "wbounds", "latent_index",
    "bw_latent_index",
)
# device copies of recent frames the trainer keeps (the dataset keeps
# as many host copies)
_FRAME_CACHE = 8
# the compacted path's distance grid (JAX engine.py:1272; eval's is 96)
TRAIN_GRID_RES = 64


def collate_rays(item: dict, n_rays: int) -> dict:
    """One item's rays cut or zero-padded to exactly n_rays, with `mask`
    marking the real ones and `mask_at_box` limited to them, plus the
    item's frame metadata and frame index, the key of the trainer's
    frame cache (JAX trainer.py:92-131, without a frame store)."""
    out = {}
    n = len(item["ray_o"])
    for k in RAY_KEYS:
        if k not in item:
            continue
        v = np.asarray(item[k])
        if len(v) >= n_rays:
            v = v[:n_rays]
        else:
            v = np.pad(v, [(0, n_rays - len(v))] + [(0, 0)] * (v.ndim - 1))
        out[k] = v
    mask = np.zeros(n_rays, dtype=bool)
    mask[: min(n, n_rays)] = True
    if "mask_at_box" in out:
        out["mask_at_box"] = out["mask_at_box"].astype(bool) & mask
    out["mask"] = mask
    for k in FRAME_KEYS:
        if k in item:
            out[k] = np.asarray(item[k])
    if "occupancy" in out:
        out["occupancy"] = out["occupancy"].astype(np.int32)
    for k in ("latent_index", "bw_latent_index"):
        if k in out:
            out[k] = np.asarray(out[k], np.int32)
    if "frame_index" in item:
        out["frame_index"] = np.asarray(item["frame_index"], np.int32)
    return out


def stack_batch(items):
    """Collated items stacked along a leading frame axis."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def check_train_config(cfg):
    """Raise on what the port's trainer does not do."""
    if int(cfg.train.get("batch_size", 1)) != 1:
        raise NotImplementedError("only one frame a step (train.batch_size 1) "
                                  "is ported")
    if int(cfg.train.get("steps_per_dispatch", 1) or 1) != 1:
        raise NotImplementedError("steps_per_dispatch > 1 is a JAX dispatch "
                                  "mechanism with no counterpart in the port")


class Trainer:
    """Train steps of `model` (any family with a `train_forward`) on
    `device`."""

    def __init__(self, cfg, model, device):
        check_train_config(cfg)
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.settings = RenderSettings(
            n_samples=int(cfg.N_samples), white_bkgd=bool(cfg.white_bkgd),
            perturb=cfg.perturb > 0,
        )
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(cfg, self.params)
        self.sched = make_schedule(cfg)
        self.mask_alpha_max = float(cfg.get("sdf_mask_alpha_max", 0.0))
        self.step = 0  # frames trained on
        self.updates = 0  # optimizer updates (the schedule's count)
        # the jitter of the z values; seeded by the caller
        self.generator = torch.Generator(device=self.device)
        self._frames = OrderedDict()
        # the compacted path's per-frame distance grid (a KNN family's pass
        # 1); none with knn_grid_res <= 1, where K2 filters every point
        self.pdist_res = 0
        if model.knn_pass1 and getattr(model, "train_keep_frac", 0.0) > 0:
            res = int(cfg.get("knn_grid_res", TRAIN_GRID_RES))
            self.pdist_res = res if res > 1 else 0

    def _frame(self, batch) -> dict:
        """The frame's tensors on the device, and its latent indices,
        kept for the last _FRAME_CACHE frames uploaded; on the compacted
        path of a KNN family also its packed distance grid, margin and
        bounds (`build_pdist_payload`, K3 on the card), built once when
        the frame is uploaded (JAX trainer.py:190-200)."""
        key = int(batch["frame_index"])
        frame = self._frames.get(key)
        if frame is None:
            frame = {k: torch.as_tensor(np.asarray(batch[k], np.float32),
                                        device=self.device)
                     for k in self.model.train_frame_keys}
            for k in ("latent_index", "bw_latent_index"):
                frame[k] = int(batch[k])
            if self.pdist_res:
                packed, margin, bounds = build_pdist_payload(
                    frame["pvertices"], res=self.pdist_res)
                frame.update(pdist_packed=packed, pdist_margin=margin,
                             pdist_bounds=bounds)
            self._frames[key] = frame
            if len(self._frames) > _FRAME_CACHE:
                self._frames.popitem(last=False)
        return frame

    def _rays(self, batch) -> dict:
        return {k: torch.as_tensor(np.asarray(batch[k]), device=self.device)
                for k in RAY_KEYS if k in batch}

    def loss(self, batch):
        """(loss, stats, ret) of one frame's collated batch (no leading
        axis) at the current weights and step (JAX `_loss_one`)."""
        rays = self._rays(batch)
        ret = render_rays_train(self.model, rays, self._frame(batch),
                                self.settings, self.generator)
        loss, stats = compute_losses(ret, rays, self.step,
                                     mask_alpha_max=self.mask_alpha_max)
        return loss, stats, ret

    def apply_gradients(self):
        """The update from the parameters' .grad: the value clip at 40,
        then Adam at the schedule's rate for the update count (JAX
        optax.chain(clip(40), adam(sched)))."""
        torch.nn.utils.clip_grad_value_(self.params, CLIP_VALUE)
        for group in self.optimizer.param_groups:
            group["lr"] = self.sched(self.updates)
        self.optimizer.step()
        self.updates += 1

    def train_step(self, batch) -> dict:
        """One update from a stacked batch of one frame (JAX
        `_train_step` at B = 1); returns the stats as floats."""
        if batch["ray_o"].shape[0] != 1:
            raise NotImplementedError("one frame a step is ported")
        self.optimizer.zero_grad(set_to_none=True)
        loss, stats, _ = self.loss({k: v[0] for k, v in batch.items()})
        loss.backward()
        self.apply_gradients()
        self.step += 1
        return {k: float(v.detach()) for k, v in stats.items()}

    def train_epoch(self, loader, recorder, epoch: int, max_iter: int,
                    log_interval: int = 20, record_interval: int = 20):
        """One epoch over `loader` (JAX trainer.py:556-710 at one step a
        dispatch): per step, the recorder's step, batch and data times,
        the stats and rays/s; a console line every `log_interval` steps
        and a JSONL record every `record_interval`. The data time is the
        wait for the loader's next item and its collation: the loader
        reads ahead, so it is the part of the read the step does not
        hide."""
        loader.set_epoch(epoch)
        recorder.epoch = epoch
        n_rays = int(self.cfg.N_rand)
        end = time.time()
        for item in loader:
            batch = stack_batch([collate_rays(item, n_rays)])
            data_time = time.time() - end
            stats = self.train_step(batch)  # floats: waits for the device
            batch_time = time.time() - end
            recorder.step += 1
            recorder.batch_time.update(batch_time)
            recorder.data_time.update(data_time)
            stats["rays_per_sec"] = n_rays / max(batch_time, 1e-9)
            recorder.update_stats(stats)
            if recorder.step % log_interval == 0:
                print(recorder.log_line(max_iter, self.sched(self.step)),
                      flush=True)
            if recorder.step % record_interval == 0:
                recorder.record("train")
            end = time.time()
