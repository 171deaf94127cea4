"""Eval frame sampling, and the loader that reads items ahead on threads.

JAX counterpart: animatable_nerf_tpu/data/loader.py (`FrameSampler`,
reference samplers.py:134-152; `Loader` :90-191) and engine.py:97-109
(`make_test_loader`). As in JAX, worker threads read items ahead of the
caller, at most `prefetch + num_threads` of them in flight, and the
items come out in index order. Unlike JAX's workers, which draw the train
split's rays from the dataset's one random state in whatever order they
reach it, the port's workers run only the part of an item that draws no
random numbers (`dataset.read`); the caller's thread finishes each item
(`dataset.draw`) in index order. So the items are the same at any number
of threads, and equal to JAX's at one.
"""

from __future__ import annotations

import queue
import threading

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


def make_test_loader(cfg, dataset) -> "Loader":
    """The eval split's loader (JAX engine.py:97-109): `eval_indices`'
    order, two reader threads."""
    return Loader(dataset, shuffle=False, sampler=eval_indices(cfg, dataset),
                  num_threads=2)


class Loader:
    """Items of `dataset` in epochs (JAX loader.py:90-191): the indices
    of `sampler`, or every index shuffled by RandomState(seed + epoch)
    (the reference's epoch-seeded DistributedSampler,
    samplers.py:107-115), then repeated and cut to `max_iter` items when
    max_iter > 0 (iteration-based epochs, `ep_iter`).

    `num_threads` daemon threads read items ahead (`dataset.read`); a
    semaphore keeps at most `prefetch + num_threads` items in flight, so
    a slow item at the head does not let the workers buffer the epoch.
    The caller's thread takes them in index order and finishes each
    (`dataset.draw`; a dataset whose items draw no random numbers reads
    them whole and returns them from `draw` as they are). An exception
    raised by a read is raised on the caller's thread at its item.
    Leaving the iteration early (a break, an exception) stops the
    workers: each ends after the read it is in."""

    def __init__(self, dataset, shuffle: bool = True, max_iter: int = -1,
                 sampler=None, seed: int = 0, prefetch: int = 4,
                 num_threads: int = 4):
        self.dataset = dataset
        self.shuffle = shuffle
        self.max_iter = max_iter
        self.sampler = sampler
        self.seed = seed
        self.prefetch = prefetch
        self.num_threads = max(1, int(num_threads))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> list:
        if self.sampler is not None:
            inds = list(self.sampler)
        else:
            inds = list(range(len(self.dataset)))
            if self.shuffle:
                np.random.RandomState(self.seed + self.epoch).shuffle(inds)
        if self.max_iter > 0:
            reps = int(np.ceil(self.max_iter / max(len(inds), 1)))
            inds = (inds * reps)[: self.max_iter]
        return inds

    def __len__(self):
        return len(self.indices())

    def __iter__(self):
        inds = self.indices()
        read, draw = self.dataset.read, self.dataset.draw
        done: queue.Queue = queue.Queue()
        stop = threading.Event()
        todo = iter(enumerate(inds))
        lock = threading.Lock()
        tickets = threading.Semaphore(self.prefetch + self.num_threads)

        def worker():
            while not stop.is_set():
                if not tickets.acquire(timeout=0.1):
                    continue
                with lock:
                    pos, idx = next(todo, (None, None))
                if pos is None:
                    tickets.release()
                    return
                try:
                    part = read(idx)
                except Exception as e:  # raised on the caller's thread
                    part = e
                done.put((pos, part))

        threads = [
            threading.Thread(target=worker, daemon=True,
                             name=f"Loader-reader-{i}")
            for i in range(min(self.num_threads, max(len(inds), 1)))
        ]
        for t in threads:
            t.start()
        parked = {}
        try:
            for pos, idx in enumerate(inds):
                while pos not in parked:
                    got, part = done.get()
                    parked[got] = part
                part = parked.pop(pos)
                tickets.release()
                if isinstance(part, Exception):
                    raise part
                yield draw(idx, part)
        finally:
            stop.set()
