"""What the metric files of ``metrics/`` read from a run's record (see
``core.run_cell``): the window's calls, seconds, dispatch seconds and
model FLOPs, the peak memory, and with the trace the profiled window's
union of device intervals and each kernel family's bound and device
time (the bound None where the family's launches disagree with the port's
counters).  Shares are percent."""


def dispatch_ms(run):
    return 1e3 * run["dispatch_s"] / run["calls"]


def mfu(run):
    return 100.0 * run["model_flops"] / (run["window_s"] * run["peak_flops"])


def kernel_roofline(run):
    used = [f for f in (run.get("families") or {}).values()
            if f["bound_s"] and f["device_s"] > 0]
    if not used:
        return None
    return 100.0 * sum(f["bound_s"] for f in used) / sum(
        f["device_s"] for f in used)


def device_idle(run):
    t = run.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def peak_mem_gib(run):
    return run["peak_mem_bytes"] / 2 ** 30 if run["peak_mem_bytes"] else None


def audio_s_per_s(run):
    return run["audio_s"] / run["window_s"]


def setup_s(run):
    return run["setup_s"]
