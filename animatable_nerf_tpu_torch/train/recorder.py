"""Training recorder: windowed-median scalars, console lines with an
ETA, and a JSONL file of scalars.

JAX counterpart: animatable_nerf_tpu/train/recorder.py:19-114
(reference lib/train/recorder.py). The machines the port runs on have
no tensorboardX, so the scalars go to `<record_dir>/scalars.jsonl` only,
one line per record as JAX writes it.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from collections import defaultdict, deque

import numpy as np


class SmoothedValue:
    """Windowed median and average (recorder.py:10-37)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        v = float(value)
        self.deque.append(v)
        self.count += 1
        self.total += v

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class Recorder:
    """Scalars of a run under `record_dir`; a fresh run (resume False)
    wipes the directory first (recorder.py:46-48)."""

    def __init__(self, record_dir: str, resume: bool = True):
        self.record_dir = record_dir
        self.step = 0
        self.epoch = 0
        self.scalars = defaultdict(SmoothedValue)
        self.batch_time = SmoothedValue()
        self.data_time = SmoothedValue()
        if not resume and os.path.isdir(record_dir):
            shutil.rmtree(record_dir, ignore_errors=True)
        os.makedirs(record_dir, exist_ok=True)
        self._jsonl = open(os.path.join(record_dir, "scalars.jsonl"), "a")

    def close(self):
        self._jsonl.close()

    def update_stats(self, stats: dict):
        for k, v in stats.items():
            self.scalars[k].update(float(v))

    def record(self, prefix: str = "train", extra: dict | None = None):
        """One JSONL line {prefix: {step, epoch, the scalars' medians,
        `extra`}} (JAX recorder.py:78; the periodic evaluation's "val"
        line carries its `val_<metric>` in `extra`)."""
        payload = {
            "step": self.step,
            "epoch": self.epoch,
            **{k: v.median for k, v in self.scalars.items()},
            **(extra or {}),
        }
        self._jsonl.write(json.dumps({prefix: payload}) + "\n")
        self._jsonl.flush()

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state.get("step", 0))

    def log_line(self, max_iter: int, lr: float) -> str:
        """Console progress line (trainer.py:87-97)."""
        eta_sec = self.batch_time.global_avg * (max_iter - self.step)
        eta = time.strftime("%H:%M:%S", time.gmtime(max(eta_sec, 0)))
        parts = [f"eta: {eta}", f"epoch: {self.epoch}", f"step: {self.step}"]
        parts += [f"{k}: {v.median:.4f}" for k, v in self.scalars.items()]
        parts += [f"data: {self.data_time.median:.4f}",
                  f"batch: {self.batch_time.median:.4f}", f"lr: {lr:.6f}"]
        return "  ".join(parts)
