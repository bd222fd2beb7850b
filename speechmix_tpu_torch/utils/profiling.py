"""Profiling / tracing hooks (port of ``speechmix_tpu.utils.profiling``).

  * trace(logdir): a ``torch.profiler`` trace of the enclosed block, CPU
    activity and, where CUDA is present, the card's kernels; written to
    `logdir` as ``*.pt.trace.json``, which TensorBoard and Perfetto open
  * annotate(name): the port's span, a context manager.  Off unless a
    ``torch.profiler`` is recording on the calling thread (``trace`` above,
    or any ``torch.profiler.profile``): then the span only checks that, and
    pushes no NVTX range either.  On, it is a range of the profiler's host
    timeline (on the profiler's clock, beside the card's kernels), an NVTX
    range on the card for Nsight Systems, and an entry in the in-memory
    totals per name: count, host seconds, and self seconds (the seconds
    its child spans on the same thread do not cover)
  * span_totals() / reset_spans(): read and clear those totals

The range is a ``RecordFunction`` of function scope
(``torch._C._profiler._RecordFunctionFast``), a host event like an aten
op.  ``torch.profiler.record_function`` is not used: the profiler copies
each of its user annotations onto the card's timeline as a device event
that spans the kernels launched inside it, and a reader of device
intervals would count a span as device time.

Each thread keeps its own stack of open spans: the backward's kernels
launch from autograd's device thread, where a span is a root of its own.
A root span (``root=True``: ``generate``, ``train_step``) records the next
call index of the process as its keyword ``call``, which the exported
trace shows under ``record_shapes=True``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

_enabled = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter_ns
_lock = threading.Lock()
_local = threading.local()
# name -> [count, total ns, self ns]
_totals: dict = {}
_calls = itertools.count()
_nvtx = None  # whether to push NVTX ranges: decided at the first span on


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


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    """The span while no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "root", "_range", "_outer", "_start", "_child")

    def __init__(self, name, root):
        self.name = name
        self.root = root

    def __enter__(self):
        global _nvtx
        outer = _clock()
        if self.root:
            self._range = _record(self.name, (), {"call": next(_calls)})
        else:
            self._range = _record(self.name)
        self._range.__enter__()
        if _nvtx is None:
            _nvtx = torch.cuda.is_available()
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        _stack().append(self)
        self._child = 0
        self._outer = outer
        self._start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        stack = _stack()
        stack.pop()
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        total = end - self._start
        if stack:
            # the parent's self time leaves out this span's own cost too
            stack[-1]._child += _clock() - self._outer
        with _lock:
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += total
            t[2] += total - self._child
        return False


def annotate(name: str, root: bool = False):
    """A named span, as a context manager (module docstring):

        with profiling.annotate("generate.decode"):
            ...

    Whether it is on is decided here: a span made while no profiler
    records stays off."""
    if not _enabled():
        return _OFF
    return _Span(name, root)


def span_totals() -> dict:
    """{name: {"count", "total_s", "self_s"}} of the spans closed since the
    last reset_spans(), on every thread."""
    with _lock:
        return {name: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
                for name, (c, t, s) in _totals.items()}


def reset_spans():
    with _lock:
        _totals.clear()
