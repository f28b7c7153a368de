"""Tracing and timing helpers (counterpart of star_tpu/utils/profiling.py;
the reference has none).

* trace(log_dir): a context manager over torch.profiler.profile (CPU and,
  where there is a card, CUDA activities) that writes a Chrome trace into
  `log_dir` (open it in chrome://tracing or Perfetto).
* annotate(name): torch.profiler.record_function, a named region that
  shows in the trace's timeline.
* sync(x): waits for the CUDA stream of the first tensor in `x`.
* StepTimer: host wall-clock times with the device synchronised, medians
  by name.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; its Chrome trace goes to log_dir/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def sync(x) -> None:
    """Wait until the work that produces `x` is done: the current CUDA
    stream of the first tensor found in `x` (a tensor, or lists, tuples and
    dicts of them) is synchronised. Nothing to wait for on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class StepTimer:
    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        """Host seconds of the block (synchronise inside it to time the
        device)."""
        t0 = time.perf_counter()
        yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, warmup: int = 2, iters: int = 5):
        """fn(*args) `warmup` times untimed, then `iters` times, each timed
        to its synchronised result; returns the last result."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
            sync(out)
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            sync(out)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, float]:
        return {k: float(np.median(v)) for k, v in self.times.items()}
