"""What the metric files of the port's program spans read: the totals of
``speechmix_tpu_torch.utils.profiling.span_totals()`` (count, host seconds
and self host seconds per span name).

A span records only while a ``torch.profiler`` records, and in a run only
the traced calls (``--trace 1``, ``core.TRACE_CALLS`` of them) run under
one: the totals cover exactly those calls.  Without ``trace_calls`` in the
run's record, or where the program has no such span (a program without
``span_totals``, or a span that was never recorded), a reading is None and
the metric is left out of the line.
"""


def totals(run):
    """The program's span totals after a traced run, or None."""
    if not run.get("trace_calls"):
        return None
    from speechmix_tpu_torch.utils import profiling
    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else None


def per_call_ms(run, *names):
    """Host ms a traced call spends in the named spans (their totals
    summed), or None where none of them was recorded."""
    t = totals(run)
    found = [t[n] for n in names if t and n in t]
    if not found:
        return None
    return 1e3 * sum(s["total_s"] for s in found) / run["trace_calls"]


def launch_us(run):
    """The mean host us of one port kernel launch: the self time of every
    ``launch.<symbol>`` span over their count, or None without one."""
    t = totals(run) or {}
    launches = [s for n, s in t.items() if n.startswith("launch.")]
    count = sum(s["count"] for s in launches)
    if not count:
        return None
    return 1e6 * sum(s["self_s"] for s in launches) / count
