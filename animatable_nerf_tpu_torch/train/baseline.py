"""The trainer of the image-space baselines NHR and NT: one whole image
a step.

JAX counterpart: animatable_nerf_tpu/train/baseline.py
(`_image_pyramid_l1` :41, `BaselineTrainer` :57; reference
lib/train/trainers/nhr.py, nt.py). The loss is JAX's objective without
VGG weights: the image MSE, plus 0.1 x the L1 of the images over a
3-level pyramid of 2x2 average pools, plus 0.1 x the MSE of the
predicted mask against the image's mask; the stats add the PSNR over
the masked pixels. With `train.vgg_weights` (a converted VGG19 head,
tools/convert_vgg_weights.py) the loss is the reference's objective
instead (JAX :100-115; nhr.py:25-31): rgb and image masked by `msk >
0`, each stacked with a mask channel (the predicted mask against the
image's), the VGG19 feature L1 plus the image L1 of
train/perceptual.py `perceptual_loss`; the stats name the two
`vgg_loss` and `l1_loss`. The update is the config's optimizer, as the
volumetric families' (train/optim.py): the value clip at 40, then Adam
at the schedule's rate for the update count.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.nn import functional as F

from .optim import CLIP_VALUE, make_optimizer, make_schedule
from .perceptual import load_vgg_npz, perceptual_loss


PYRAMID_LEVELS = 3


def image_pyramid_l1(pred, gt):
    """The mean of the L1 of (H, W, 3) images at PYRAMID_LEVELS scales,
    each a 2x2 average pool (no padding) of the one before."""
    loss = torch.mean(torch.abs(pred - gt))
    p, g = pred.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None]
    for _ in range(PYRAMID_LEVELS - 1):
        p, g = F.avg_pool2d(p, 2), F.avg_pool2d(g, 2)
        loss = loss + torch.mean(torch.abs(p - g))
    return loss / PYRAMID_LEVELS


class BaselineTrainer:
    """Train steps of an NHR or NT `model` on `device`."""

    def __init__(self, cfg, model, device):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(cfg, self.params)
        self.sched = make_schedule(cfg)
        self.step = 0  # images trained on
        self.updates = 0  # optimizer updates (the schedule's count)
        # the VGG19 head of `train.vgg_weights`, loaded once; None: the
        # stand-in objective
        path = cfg.train.get("vgg_weights", "")
        self.vgg = load_vgg_npz(path, self.device) if path else None

    def frame(self, item) -> dict:
        """The item's model inputs, image and mask on the device."""
        return {k: torch.as_tensor(np.asarray(item[k], np.float32),
                                   device=self.device)
                for k in self.model.frame_keys + ("img", "msk")}

    def loss(self, frame):
        """(loss, stats) of one frame at the current weights."""
        out = self.model(frame)
        pred, gt = out["rgb_map"], frame["img"]
        m = frame["msk"][..., None]
        img_loss = torch.mean((pred - gt) ** 2)
        mskf = (frame["msk"] > 0).float()
        if self.vgg is not None:
            x = torch.cat([pred * mskf[..., None], out["mask"][..., None]], -1)
            target = torch.cat([gt * mskf[..., None], mskf[..., None]], -1)
            feat_loss, l1_loss = perceptual_loss(
                self.vgg, x.permute(2, 0, 1)[None], target.permute(2, 0, 1)[None])
            loss = feat_loss + l1_loss
            extra = {"vgg_loss": feat_loss, "l1_loss": l1_loss}
        else:
            pyr = image_pyramid_l1(pred, gt)
            mask_loss = torch.mean((out["mask"] - mskf) ** 2)
            loss = img_loss + 0.1 * pyr + 0.1 * mask_loss
            extra = {"pyr_loss": pyr, "mask_loss": mask_loss}
        mse = torch.sum(((pred - gt) * m) ** 2) / torch.clamp(torch.sum(m) * 3.0,
                                                             min=1.0)
        psnr = -10.0 * torch.log(torch.clamp(mse, min=1e-10)) / math.log(10.0)
        return loss, {"loss": loss, "img_loss": img_loss, **extra,
                      "psnr": psnr}

    def train_step(self, item) -> dict:
        """One update from one item; returns the stats as floats."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, stats = self.loss(self.frame(item))
        loss.backward()
        torch.nn.utils.clip_grad_value_(self.params, CLIP_VALUE)
        for group in self.optimizer.param_groups:
            group["lr"] = self.sched(self.updates)
        self.optimizer.step()
        self.updates += 1
        self.step += 1
        return {k: float(v.detach()) for k, v in stats.items()}

    def train_epoch(self, loader, recorder, epoch: int, max_iter: int,
                    log_interval: int = 20):
        """One epoch over `loader` (JAX engine.py:1392-1415): per step the
        recorder's step, batch and data times (the data time: the wait
        for the loader's next item, which it reads ahead) and the stats;
        a console line every `log_interval` steps."""
        loader.set_epoch(epoch)
        recorder.epoch = epoch
        end = time.time()
        for item in loader:
            data_time = time.time() - end
            stats = self.train_step(item)  # floats: waits for the device
            recorder.step += 1
            recorder.batch_time.update(time.time() - end)
            recorder.data_time.update(data_time)
            recorder.update_stats(stats)
            if recorder.step % log_interval == 0:
                print(recorder.log_line(max_iter, self.sched(self.step)),
                      flush=True)
            end = time.time()
