"""The port's spans (counterpart of star_tpu/utils/profiling.py; the
reference has none).

* trace(log_dir): a context manager over torch.profiler.profile (CPU and,
  where there is a card, CUDA activities) that writes a Chrome trace into
  `log_dir` (open it in chrome://tracing or Perfetto).
* annotate(name): a named range (a RecordFunction on the profiler's
  host timeline; the profiler also projects it onto the card's timeline,
  spanning the kernels launched inside it) while a profiler runs, else a
  shared no-op context: entering a RecordFunction costs microseconds even
  with no profiler, and the kernel launchers open one per launch.
* spanned(name): a decorator, the function run inside annotate(name).
* gc_spans(): while open, each garbage collection is a `gc` range on the
  thread that collected, its generation the range's argument.

Span names are dotted by layer (`jobs.*`, `sr.*`, `sampler.step`,
`unet.call`, `dit.call`, `train.*`, `batch.*`, `kernel.K*`, `gc`); none is
a kernel's compiled name, since a trace reader tells a range's device
projection from a kernel by its name.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import os

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


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


def annotate(name: str, args: str | None = None):
    """The range `name` (with the string `args`) while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name, args)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: each call of the function runs inside annotate(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return run
    return wrap


class _GcRanges:
    """gc.callbacks hook: a `gc` range from a collection's start to its
    stop. Collections never overlap (one runs at a time, under the
    interpreter lock), so one open range is all there can be."""

    def __init__(self):
        self.open = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == 'start':
            span = annotate('gc', str(info['generation']))
            if span is not _NO_SPAN:
                span.__enter__()
                self.open = span
        elif self.open is not None:
            span, self.open = self.open, None
            span.__exit__(None, None, None)


@contextlib.contextmanager
def gc_spans():
    """Record each garbage collection inside the block as a `gc` range
    (nothing while no profiler runs)."""
    hook = _GcRanges()
    gc.callbacks.append(hook)
    try:
        yield
    finally:
        gc.callbacks.remove(hook)
