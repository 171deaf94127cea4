"""Eval frame sampling.

JAX counterpart: animatable_nerf_tpu/data/loader.py (`FrameSampler`;
reference samplers.py:134-152).
"""

from __future__ import annotations

import numpy as np


class FrameSampler:
    """Evaluate every k-th frame: the frame WINDOW [begin : begin +
    count] is cut first (count = -1 falls back to `default_count`, the
    config's num_train_frame, per the reference), then strided by
    `interval`; all views of a kept frame are yielded."""

    def __init__(self, dataset, interval: int = 30, begin: int = 0,
                 count: int = -1, default_count: int | None = None):
        n_frames = len(dataset) // dataset.num_cams
        inds = np.arange(len(dataset)).reshape(n_frames, dataset.num_cams)
        if count < 0:
            count = default_count if default_count is not None else n_frames
        self.inds = inds[begin : begin + count][::interval].ravel()

    def __iter__(self):
        return iter(self.inds.tolist())

    def __len__(self):
        return len(self.inds)


def eval_indices(cfg, dataset) -> list:
    """Item order of the eval split (JAX engine.make_test_loader)."""
    if cfg.test.get("sampler") == "FrameSampler":
        return list(FrameSampler(
            dataset,
            interval=cfg.test.frame_sampler_interval,
            begin=cfg.test.get("begin_sampler_ind", 0),
            count=cfg.test.get("num_sampler_ind", -1),
            default_count=cfg.num_train_frame,
        ))
    return list(range(len(dataset)))
