"""Profiling and throughput helpers.

JAX counterpart: animatable_nerf_tpu/utils/profiling.py:
  * `profile_trace`: a torch.profiler trace of the enclosed block (the
    host, and the device where there is one), written as a Chrome trace
    (open in chrome://tracing or Perfetto) under `log_dir`;
  * `ThroughputMeter`: windowed items per second;
  * `StepTimer`: device-synchronized section times, by CUDA events on
    the card and by the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed block with torch.profiler (CPU activity, and
    CUDA where a GPU is present) and write the trace to
    <log_dir>/trace_<pid>_<ms>.json when the block ends. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


class ThroughputMeter:
    """Windowed throughput: call `update(n_items, seconds)` per step."""

    def __init__(self, window: int = 20):
        self._samples = deque(maxlen=window)

    def update(self, n_items: float, seconds: float):
        if seconds > 0:
            self._samples.append((n_items, seconds))

    @property
    def per_sec(self) -> float:
        if not self._samples:
            return 0.0
        items = sum(n for n, _ in self._samples)
        secs = sum(s for _, s in self._samples)
        return items / max(secs, 1e-9)


class StepTimer:
    """Synchronized section timing on `device` (cuda by default when a GPU
    is present):

        with StepTimer() as t:
            out = step(...)
        print(t.ms)

    On a CUDA device, events recorded on the current stream at the
    block's start and end, read after the end event completes; on the
    CPU, the host clock."""

    def __init__(self, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.cuda = torch.device(device).type == "cuda"
        self.ms = 0.0

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        return self

    def sync(self, _out=None):
        """Wait for the device's work so far (JAX `block_until_ready`)."""
        if self.cuda:
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = (time.perf_counter() - self._t0) * 1e3
        return False
