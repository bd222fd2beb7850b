"""Profiling / tracing hooks (port of ``speechmix_tpu.utils.profiling``).

  * trace(logdir): a ``torch.profiler`` trace of the enclosed block, CPU
    activity and, where CUDA is present, the card's kernels; written to
    `logdir` as ``*.pt.trace.json``, which TensorBoard and Perfetto open
  * annotate(name): a named span in that trace (``record_function``); on
    the card also an NVTX range, so Nsight Systems shows it too
  * StepTimer: host-side rolling step timing with compile-step detection
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace for the enclosed block:
        with profiling.trace('/tmp/trace'):
            train_step(...)
    View with TensorBoard or Perfetto."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


@contextlib.contextmanager
def annotate(name: str):
    """Span annotation visible in profiler timelines."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Rolling wall-clock stats; flags compile steps (>5x median)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last = None

    def tick(self) -> Optional[dict]:
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        return {
            "step_time_s": dt,
            "median_step_time_s": med,
            "likely_compile": dt > 5 * med and len(self.times) > 3,
        }
