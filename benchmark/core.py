"""One run of one cell: load its files by name, set up, time the window,
trace a few calls when asked, check the output, print the result line.

Everything that belongs to a configuration, a traffic mix, a per-layer
metric or a kernel family is a file of its own, found by the name that
``BENCHMARK.json`` gives:

  configs/<config>.json   the configuration as run ("file" in BENCHMARK.json)
  traffic/<mix>.json      the mix's parameters (``traffic.py`` reads them)
  limits/<cell>.json      the limit of each number the check compares
  metrics/<metric>.py     read(run) -> the metric's value, or None
  kernels/<family>.py     a port kernel family's device-kernel names,
                          launchers and work(op, element_size) ->
                          (FLOPs, bytes, launches) or None
"""

from __future__ import annotations

import glob
import importlib.util
import json
import math
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_CALLS = 2
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
FORBIDDEN = ("jax", "jaxlib", "flax", "speechmix_tpu")
# a port kernel's name in the profiler: its identifier at the start, after
# the return type, or after the anonymous namespace of its source
KERNEL_PREFIX = r"(?:^|\s|\(anonymous namespace\)::)"


def _load(path):
    name = "benchmark_file_" + re.sub(r"\W", "_", os.path.relpath(path, HERE))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """(benchmark, cell, configuration file, mix, limits) by cell name."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_file = _json(os.path.join(root, config["file"]))
    mix = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", name + ".json"))
    return bench, cell, cfg_file, mix, limits


def cell_metrics(bench, cell, trace):
    """The metric entries this cell reports in a run with or without the
    trace: those whose "workloads" list it, or that have no such list."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell["name"] in m["workloads"]]


def families():
    return {os.path.basename(p)[:-3]: _load(p)
            for p in sorted(glob.glob(os.path.join(HERE, "kernels", "*.py")))}


def reader(name):
    return _load(os.path.join(HERE, "metrics", name + ".py")).read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def roofline(ops_per_call, device_s, launches, dtype):
    """Per family: the summed bound and device seconds of the profiled
    calls, the operations it took, the launches they take by the family's
    count ("counted") and by the port's counters ("launches").  Where the
    two differ, ``flops.py``'s copy of the port's gates no longer says
    which operations the family carried out: its bound is None, and
    ``kernel_roofline`` leaves the family out."""
    es = 2 if dtype == "bfloat16" else 4
    out = {}
    for fam, mod in families().items():
        bound, n_ops, counted = 0.0, 0, 0
        for ops in ops_per_call:
            for op in ops:
                w = mod.work(op, es)
                if w is not None:
                    bound += max(w[0] / PEAK_FLOPS[dtype], w[1] / PEAK_BYTES)
                    n_ops += 1
                    counted += w[2]
        pattern = re.compile(KERNEL_PREFIX + "(" + mod.DEVICE_KERNELS +
                             r")(?=[<(])")
        dev = sum(s for name, s in device_s.items() if pattern.search(name))
        runs = sum(n for sym, n in launches.items()
                   if re.match(mod.LAUNCHERS, sym))
        out[fam] = {"bound_s": bound if counted == runs else None,
                    "device_s": dev, "ops": n_ops, "counted": counted,
                    "launches": runs}
    return out


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_cell(cell, cfg_file, mix, limits, seed, seconds, trace, device,
             t_start, session_hook=None):
    """Set up, time, trace and check one run; returns (the run's record,
    correct, [[number, value, limit]]).  session_hook(session) may replace
    parts of the session (the fault tests)."""
    import torch
    from . import check, program, trace as trace_lib
    from .reference.precision import full_f32_library

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # the configurations state float32: library products and convolutions
    # run in full float32, not PyTorch's default TF32 convolutions
    full_f32_library()
    if cuda:
        from speechmix_tpu_torch.ops import kernels
        built = kernels.build_all()
        _log(f"kernels built in {built:.1f} s")
    kind = {"generate": program.Transcribe, "train_step": program.Train}
    session = kind[mix["entry"]](cfg_file, mix, seed, device)
    if session_hook is not None:
        session_hook(session)
    session.warm()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    first = program.FIRST_STEPS if session.train else 0

    # the window: back-to-back calls, each ending in a synchronize
    calls, audio, dispatch = 0, 0.0, 0.0
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        audio += session.call(first + calls)
        dispatch += time.perf_counter() - c0
        sync()
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = {"entry": mix["entry"], "train": session.train, "calls": calls,
           "rows": 1 if session.train else mix["batch"],
           "window_s": window_s, "audio_s": audio, "dispatch_s": dispatch,
           "setup_s": setup_s, "peak_mem_bytes": peak, "dtype":
           ("bfloat16" if session.train and session.recipe.get("bf16")
            else mix.get("dtype", "float32"))}
    run["model_flops"] = sum(
        program.flops.model_flops(session.ops(first + i), session.train)
        for i in range(calls))
    run["peak_flops"] = PEAK_FLOPS[run["dtype"]]

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        if cuda:
            kernels.reset_launch_counts()
        at = first + calls
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            for i in range(TRACE_CALLS):
                with record_function(trace_lib.CALL_RANGE):
                    session.call(at + i)
                    sync()
        reading = trace_lib.read(prof, TRACE_CALLS)
        run["trace"] = reading
        if reading is not None:
            launches = ({k.symbol: k.launches for k in kernels.kernels()}
                        if cuda else {})
            run["families"] = roofline(
                [session.ops(at + i) for i in range(TRACE_CALLS)],
                reading["device_s"], launches, run["dtype"])
            for fam, f in run["families"].items():
                bound = ("left out: the counters disagree"
                         if f["bound_s"] is None
                         else f"{f['bound_s'] * 1e3:.3f} ms")
                _log(f"family {fam}: ops {f['ops']}, launches counted "
                     f"{f['counted']}, by the counters {f['launches']}, "
                     f"bound {bound}, device {f['device_s'] * 1e3:.3f} ms "
                     f"over {TRACE_CALLS} calls")
        run["trace_calls"] = TRACE_CALLS
        del prof

    session.release()
    if cuda:
        torch.cuda.empty_cache()
    values, details = check.numbers(session, seed)
    correct, compared = check.judge(values, limits)
    _log(f"check details: {json.dumps(details)}")
    return run, correct, compared


def result_line(bench, cell, run, correct, compared, trace, chips):
    import torch
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = reader(m["name"])(run)
        if value is None or not math.isfinite(value):
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu"),
              "count": chips, "memory_peak_bytes": run["peak_mem_bytes"]}
    out = {"correct": correct,
           "attempted": run["calls"] * run["rows"],
           "failed": 0, "metrics": metrics, "device": device}
    if trace and run.get("trace"):
        t = run["trace"]
        n = run["trace_calls"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        top = sorted(t["device_s"].items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(t["idle_s"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v / n] for k, v in top],
                            "idle_gaps": [[k, v / n] for k, v in idle]}
    out["compared"] = compared
    return out


def main(args, t_start):
    import torch
    bench, cell, cfg_file, mix, limits = load_cell(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"{cell['name']} needs {chips} CUDA device(s); found {found}")
        return 3
    run, correct, compared = run_cell(cell, cfg_file, mix, limits, args.seed,
                                      args.seconds, args.trace, "cuda",
                                      t_start)
    found = forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {', '.join(found)}")
        return 4
    line = result_line(bench, cell, run, correct, compared, args.trace,
                       chips)
    for name, value, limit in compared:
        _log(f"compared {name}: {value!r} (limit {limit!r})")
    print(json.dumps(line), flush=True)
    return 0
