"""Tracing and step timing.

Counterpart of ``nuwa_tpu/utils/profiling.py``:

- ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
  where there is a card, CUDA activities) that writes one trace,
  ``<logdir>/<host>_<pid>.<time>.pt.trace.json``, which Perfetto
  (ui.perfetto.dev) and TensorBoard's profiler plugin load. It yields the
  profiler, whose ``key_averages()`` tables the run.
- ``annotate(name)``: names a region in the trace
  (``torch.profiler.record_function``).
- ``force_completion(x)``: reads one element of the first tensor of ``x``
  back to the host, which waits for the work that makes it.
- ``StepTimer``: wall time per step, the first ``warmup`` steps skipped; it
  synchronises the card on entry and at exit, so a step's time is the
  device's.
- ``accum_log``: the trainers' accumulator of logged metrics.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from ..train.data import accum_log  # noqa: F401  (re-export)


@contextlib.contextmanager
def trace(logdir):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ) as prof:
        yield prof


def annotate(name):
    return torch.profiler.record_function(name)


def _first_tensor(x):
    if torch.is_tensor(x):
        return x
    values = x.values() if isinstance(x, dict) else x
    for v in values:
        found = _first_tensor(v)
        if found is not None:
            return found
    return None


def force_completion(x):
    """Wait until ``x`` (a tensor or a tree of them) is computed: read a
    scalar of its first tensor back."""
    return float(_first_tensor(x).reshape(-1)[:1].float().sum())


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Per-step wall times, the card synchronised at both ends of a step;
    skips ``warmup`` steps (the first calls build and tune)."""

    def __init__(self, warmup=1):
        self.warmup = warmup
        self.times = []
        self._seen = 0
        self._t0 = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self):
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self):
        return float(np.median(self.times)) if self.times else float("nan")

    def summary(self):
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.median(arr)),
            "min_s": float(arr.min()),
            "max_s": float(arr.max()),
        }
