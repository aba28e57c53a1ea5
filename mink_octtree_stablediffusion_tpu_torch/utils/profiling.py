"""Profiling and timing helpers.

Port of `mink_octtree_stablediffusion_tpu/utils/profiling.py`: a `Timer`
with min/max/avg reporting (the reference's `examples/common.py:32-60`),
`trace`, a context manager around ``torch.profiler`` that writes a Chrome
trace, and `synced_time`, the seconds per call of a function with the
device synchronized around the timed calls.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class Timer:
    """Wall-clock timer with running stats."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.calls = 0
        self.min = float("inf")
        self.max = 0.0
        self._t0: Optional[float] = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.calls += 1
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)
        return dt

    @property
    def avg(self) -> float:
        return self.total / max(self.calls, 1)

    def __str__(self):
        return (f"Timer(calls={self.calls}, avg={self.avg:.4f}s, "
                f"min={self.min:.4f}s, max={self.max:.4f}s)")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the CPU, and CUDA where there is
    a card); writes ``<logdir>/trace.json`` (Chrome's trace format) and
    yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def synced_time(fn, *args, iters: int = 10, warmup: int = 1, **kw) -> float:
    """Mean seconds per call of ``fn(*args, **kw)`` over ``iters`` calls
    after ``warmup``, the device synchronized before and after."""
    for _ in range(warmup):
        fn(*args, **kw)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    _sync()
    return (time.perf_counter() - t0) / iters
