"""The port's utils/profiling.py against the JAX package's: StepTimer gives
the same dicts for the same clock readings (the window, the median and the
likely_compile rule), and on the CPU trace() writes a Chrome-format trace
that holds the annotate() span names around PyTorch ops."""

import glob
import json
import os

import pytest
import torch

from speechmix_tpu.utils import profiling as j_prof
from speechmix_tpu_torch.utils import profiling as t_prof
from torch_threads import one_torch_thread  # noqa: F401


def _ticks(mod, times, window, monkeypatch):
    clock = iter(times)
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
    timer = mod.StepTimer(window=window)
    return [timer.tick() for _ in times]


@pytest.mark.parametrize("window", [3, 50])
def test_step_timer_matches_jax(window, monkeypatch):
    # steady steps, one slow (compile-like) step, a window overflow
    gaps = [0.0, 1.0, 0.1, 0.1, 0.1, 0.1, 2.0, 0.1, 0.12, 0.09, 0.6, 0.1]
    times, t = [], 100.0
    for g in gaps:
        t += g
        times.append(t)
    got = _ticks(t_prof, times, window, monkeypatch)
    want = _ticks(j_prof, times, window, monkeypatch)
    assert got == want
    assert got[0] is None
    # a window of 3 never holds more than 3 times: no step is flagged
    assert any(r["likely_compile"] for r in got[1:]) == (window > 3)


def test_trace_holds_the_annotated_spans(tmp_path):
    logdir = str(tmp_path / "trace")
    with t_prof.trace(logdir):
        with t_prof.annotate("outer_span"):
            x = torch.randn(32, 32)
            with t_prof.annotate("inner_span"):
                y = x @ x
            y.relu_()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"outer_span", "inner_span"} <= names
    assert any(str(n).startswith("aten::mm") for n in names)


def test_annotate_outside_a_trace_is_a_no_op():
    with t_prof.annotate("alone"):
        assert torch.ones(2).sum().item() == 2.0
