"""The device-time arithmetic of ``benchmark/trace.py``: the union of
overlapping intervals, the idle gaps and what the host ran in them, and a
profiled CPU run read end to end."""

from benchmark import trace


def test_union_counts_overlap_once():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50), (50, 55)]
    assert trace.union(spans) == [(0, 15), (20, 30), (40, 55)]
    busy = lambda lo, hi: sum(e - s for s, e in trace.union(
        trace.clip(spans, lo, hi)))
    assert busy(0, 60) == 15 + 10 + 15
    # a summed busy share would read 46 of 60
    assert sum(e - s for s, e in spans) == 46
    assert busy(8, 22) == (15 - 8) + (22 - 20)


def test_gaps_and_the_host_op_in_them():
    busy = trace.union([(10, 20), (30, 40)])
    assert trace.gaps(busy, 0, 50) == [(0, 10), (20, 30), (40, 50)]
    host = sorted([("step", 0, 50), ("cudaLaunchKernel", 21, 29),
                   ("aten::item", 41, 49)], key=lambda h: h[1])
    starts = [h[1] for h in host]
    assert trace.host_op_at(host, starts, 5) == "step"
    assert trace.host_op_at(host, starts, 25) == "cudaLaunchKernel"
    assert trace.host_op_at(host, starts, 45) == "aten::item"
    assert trace.host_op_at(host, starts, 60) == "(no host event)"


def test_a_profiled_cpu_run_has_no_device_reading():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(trace.CALL_RANGE):
                torch.ones(64, 64) @ torch.ones(64, 64)
    dev, host = trace.events(prof)
    assert not dev
    assert sum(name == trace.CALL_RANGE for name, _, _ in host) == 2
    assert all(e >= s for _, s, e in host)
    # no device interval: no reading, so no device metric is reported
    assert trace.read(prof, 2) is None
