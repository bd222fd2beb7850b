"""The metrics of the port's program spans (``benchmark/spans.py`` and its
eleven metric files): fed a fake run record and fake span totals, a record
without ``trace_calls`` or a program without ``span_totals`` reads None,
and the per-call division is right; a traced tiny run on the CPU prints the
phase metrics (no port kernel launches there, so no ``launch_us``)."""

import json
import math
import os
import time

import pytest

import bench_tiny
from benchmark import core, spans

PHASES = {
    "encode_ms.transcribe": ("generate.encode_speech", "generate.text_encode"),
    "decode_ms.transcribe": ("generate.decode",),
    "forward_ms.train": ("train_step.forward",),
    "forward_ms.train_bf16": ("train_step.forward",),
    "backward_ms.train": ("train_step.backward",),
    "backward_ms.train_bf16": ("train_step.backward",),
    "optimizer_ms.train": ("train_step.optimizer",),
    "optimizer_ms.train_bf16": ("train_step.optimizer",),
}
LAUNCHES = ["launch_us.transcribe", "launch_us.train", "launch_us.train_bf16"]
TOTALS = {
    "generate": {"count": 2, "total_s": 2.4, "self_s": 0.002},
    "generate.encode_speech": {"count": 2, "total_s": 0.5, "self_s": 0.3},
    "generate.text_encode": {"count": 2, "total_s": 0.1, "self_s": 0.05},
    "generate.decode": {"count": 2, "total_s": 1.7, "self_s": 0.2},
    "train_step.forward": {"count": 2, "total_s": 0.8, "self_s": 0.1},
    "train_step.backward": {"count": 2, "total_s": 1.0, "self_s": 0.9},
    "train_step.optimizer": {"count": 2, "total_s": 0.2, "self_s": 0.2},
    "launch.smx_a": {"count": 300, "total_s": 0.009, "self_s": 0.006},
    "launch.smx_b": {"count": 100, "total_s": 0.003, "self_s": 0.002},
}


@pytest.fixture
def fake_totals(monkeypatch):
    from speechmix_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "span_totals", lambda: TOTALS)


@pytest.mark.parametrize("name", [*PHASES, *LAUNCHES])
def test_no_trace_reads_none(fake_totals, name):
    assert core.reader(name)({"calls": 30}) is None
    assert core.reader(name)({"calls": 30, "trace_calls": 0}) is None


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_ms_per_traced_call(fake_totals, name):
    want = 1e3 * sum(TOTALS[n]["total_s"] for n in PHASES[name]) / 2
    assert core.reader(name)({"trace_calls": 2}) == pytest.approx(want)


@pytest.mark.parametrize("name", LAUNCHES)
def test_launch_us_is_self_time_per_launch(fake_totals, name):
    assert core.reader(name)({"trace_calls": 2}) == pytest.approx(
        1e6 * (0.006 + 0.002) / 400)


def test_unrecorded_spans_read_none(monkeypatch):
    from speechmix_tpu_torch.utils import profiling
    # the ed variant has no text encoder: its speech encoder alone
    only = {"generate.encode_speech": TOTALS["generate.encode_speech"]}
    monkeypatch.setattr(profiling, "span_totals", lambda: only)
    run = {"trace_calls": 2}
    assert spans.per_call_ms(run, "generate.encode_speech",
                             "generate.text_encode") == pytest.approx(250.0)
    assert spans.per_call_ms(run, "generate.decode") is None
    assert spans.launch_us(run) is None
    # a program without span totals (the parent of this reader)
    monkeypatch.delattr(profiling, "span_totals")
    assert spans.totals(run) is None
    for name in [*PHASES, *LAUNCHES]:
        assert core.reader(name)(run) is None


def _bench():
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("entry, cell", [
    ("generate", "w2v2b-bartb.transcribe-f32-b128"),
    ("train_step", "xlsr1b-bartl.train-bf16-b16"),
])
def test_a_traced_tiny_run_prints_the_phases(entry, cell):
    from speechmix_tpu_torch.utils import profiling
    profiling.reset_spans()
    bench = _bench()
    entry_of = {w["name"]: w for w in bench["workloads"]}[cell]
    _, f = bench_tiny.config()
    with open(os.path.join(core.HERE, "limits", cell + ".json")) as fh:
        limits = json.load(fh)
    run, correct, compared = core.run_cell(
        {"name": cell}, f, bench_tiny.MIXES[entry], limits, 2 ** 31 + 9,
        0.01, 1, "cpu", time.perf_counter())
    assert correct, compared
    line = core.result_line(bench, entry_of, run, correct, compared, 1, 1)
    metrics = line["metrics"]
    wanted = [n for n in PHASES if n in {
        m["name"] for m in core.cell_metrics(bench, entry_of, 1)}]
    assert wanted
    for name in wanted:
        assert math.isfinite(metrics[name]["value"]), name
        assert metrics[name]["value"] > 0, name
    # the CPU runs the kernels' plain versions: no port launch to read
    assert not any(n.startswith("launch_us") for n in metrics)
    if entry == "generate":
        total = profiling.span_totals()["generate"]["total_s"]
        assert (metrics["encode_ms.transcribe"]["value"]
                + metrics["decode_ms.transcribe"]["value"]
                <= 1e3 * total / run["trace_calls"])
