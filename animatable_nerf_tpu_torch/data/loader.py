"""Eval frame sampling and the training item order.

JAX counterpart: animatable_nerf_tpu/data/loader.py (`FrameSampler`,
reference samplers.py:134-152; `Loader` :90-160). The JAX Loader reads
items ahead on worker threads; the port reads them in order on the
caller's thread, so the items, and the ray draws of the dataset's one
random state, come in the order of the index list.
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


class Loader:
    """Training items of `dataset` in epochs (JAX loader.py:90-160): the
    indices shuffled by RandomState(epoch) (JAX's seed + epoch at its
    seed 0; the reference's
    epoch-seeded DistributedSampler, samplers.py:107-115), then repeated
    and cut to `max_iter` items when max_iter > 0 (iteration-based
    epochs, `ep_iter`)."""

    def __init__(self, dataset, shuffle: bool = True, max_iter: int = -1):
        self.dataset = dataset
        self.shuffle = shuffle
        self.max_iter = max_iter
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> list:
        inds = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(inds)
        if self.max_iter > 0:
            reps = int(np.ceil(self.max_iter / max(len(inds), 1)))
            inds = (inds * reps)[: self.max_iter]
        return inds

    def __len__(self):
        return len(self.indices())

    def __iter__(self):
        for idx in self.indices():
            yield self.dataset[idx]
