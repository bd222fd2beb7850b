"""The port's utils/profiling.py: on the CPU trace() writes a Chrome-format
trace that holds the annotate() span names around PyTorch ops (the spans
themselves: test_torch_spans.py)."""

import glob
import json
import os

import torch

from speechmix_tpu_torch.utils import profiling as t_prof
from torch_threads import one_torch_thread  # noqa: F401


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
