"""The port's program spans (``utils/profiling.annotate``) on the CPU.

With no profiler recording a span enters no ``RecordFunction`` and adds
nothing to the totals.  On, a span is a host op of the profiler, not a
user annotation (which the profiler mirrors onto the card's timeline), and
a root span carries its call index.  Under ``torch.profiler.profile`` a
tiny ``generate`` and a tiny train step record their phases (one
``generate`` with its encoders and its decode loop, ``decode.step`` once a
step; the step's work over the leaves before and after its micro-batches,
forward and backward once a micro-batch, the optimizer once), as host
events of the profiler nested inside the root span, with self <= total
and the children's totals within the parent's.  A port kernel's launch is
a ``launch.<symbol>`` span and still counts.  Each thread keeps its own
stack, and self time is the total less what the child spans on the same
thread take.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import generation
from speechmix_tpu_torch.models import speechmix as smx
from speechmix_tpu_torch.ops.kernels import _cuda
from speechmix_tpu_torch.training import trainer
from speechmix_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

MAX_LENGTH = 6
GENERATE_SPANS = ("generate", "generate.encode_speech",
                  "generate.text_encode", "generate.decode")


@pytest.fixture(autouse=True)
def fresh_totals():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _cfg(variant="eed"):
    enc = dataclasses.replace(tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
                              num_layers=2)
    dec = tcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"]
    return tcfg.SpeechMixConfig(encoder=enc, decoder=dec, down_scale=2,
                                variant=variant)


def _wav(rows=2):
    wav = np.random.RandomState(0).randn(rows, 8000).astype(np.float32) * 0.1
    wav[1, 6000:] = 0.0
    return wav, np.array([8000, 6000][:rows], np.int64)


def _generate(cfg, **kw):
    params = smx.init_speechmix(cfg, torch.Generator().manual_seed(0), "cpu")
    wav, lens = _wav()
    return generation.generate(params, cfg, wav, lens, max_length=MAX_LENGTH,
                               device="cpu", **kw)


def _host_events(prof, names):
    """{name: [(start_ns, end_ns)]} of the profiler's host events."""
    out = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        if e.name() in out:
            start = e.start_ns()
            out[e.name()].append((start, start + e.duration_ns()))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _check_self_within_total(totals):
    for name, t in totals.items():
        assert 0 <= t["self_s"] <= t["total_s"], (name, t)


def test_off_spans_enter_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span entered a RecordFunction while off")
    monkeypatch.setattr(profiling, "_record", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.annotate("alone") is profiling.annotate("other")
    tokens, lengths = _generate(_cfg())
    assert tokens.shape == (2, MAX_LENGTH)
    assert profiling.span_totals() == {}


def test_spans_are_host_ops_and_roots_carry_the_call_index(tmp_path):
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for _ in range(2):
            with profiling.annotate("generate", root=True):
                with profiling.annotate("generate.decode"):
                    torch.ones(4).sum()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("name") in ("generate", "generate.decode")]
    assert len(events) == 4
    assert {e["cat"] for e in events} == {"cpu_op"}
    calls = [e["args"]["call"] for e in events if e["name"] == "generate"]
    assert len(calls) == 2 and calls[1] == calls[0] + 1
    assert all("call" not in e["args"] for e in events
               if e["name"] == "generate.decode")


@pytest.mark.parametrize("variant, kw", [
    ("eed", dict()),
    ("eed", dict(num_beams=2)),
    ("ed", dict()),
], ids=["greedy", "beam-2", "ed-greedy"])
def test_generate_records_its_phases(variant, kw):
    cfg = _cfg(variant)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _generate(cfg, **kw)
    totals = profiling.span_totals()
    phases = [n for n in GENERATE_SPANS
              if variant != "ed" or n != "generate.text_encode"]
    assert set(totals) == {*phases, "decode.step", "speech_encoder.layer"}
    for name in phases:
        assert totals[name]["count"] == 1, name
    assert totals["decode.step"]["count"] == MAX_LENGTH
    assert totals["speech_encoder.layer"]["count"] == cfg.encoder.num_layers
    _check_self_within_total(totals)
    children = sum(totals[n]["total_s"] for n in phases[1:])
    assert children <= totals["generate"]["total_s"]
    assert (totals["decode.step"]["total_s"]
            <= totals["generate.decode"]["total_s"])
    # the self time of the root is what its phases leave
    assert totals["generate"]["self_s"] <= (totals["generate"]["total_s"]
                                            - children)

    events = _host_events(prof, [*phases, "decode.step",
                                 "speech_encoder.layer"])
    (root,) = events["generate"]
    for name in phases[1:]:
        (span,) = events[name]
        assert _inside(span, root), name
    (decode,) = events["generate.decode"]
    assert len(events["decode.step"]) == MAX_LENGTH
    assert all(_inside(s, decode) for s in events["decode.step"])
    (speech,) = events["generate.encode_speech"]
    assert all(_inside(s, speech) for s in events["speech_encoder.layer"])


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_records_its_phases(grad_accum):
    cfg = _cfg()
    tc = trainer.TrainConfig(grad_accum=grad_accum, dropout=False,
                             warmup_steps=2)
    state = trainer.create_train_state(torch.Generator().manual_seed(0),
                                       cfg, tc, device="cpu")
    step_fn = trainer.make_train_step(cfg, tc, state.params, device="cpu")
    wav, lens = _wav()
    rng = np.random.RandomState(1)
    batch = {"input_values": torch.from_numpy(wav),
             "lengths": torch.from_numpy(lens),
             "labels": torch.from_numpy(rng.randint(3, 384, (2, 8)))}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, batch)
    totals = profiling.span_totals()
    assert totals["train_step"]["count"] == 1
    assert totals["train_step.leaves"]["count"] == 2
    assert totals["train_step.forward"]["count"] == grad_accum
    assert totals["train_step.backward"]["count"] == grad_accum
    assert totals["train_step.optimizer"]["count"] == 1
    assert (totals["speech_encoder.layer"]["count"]
            == grad_accum * cfg.encoder.num_layers)
    _check_self_within_total(totals)
    phases = [f"train_step.{n}" for n in ("leaves", "forward", "backward",
                                          "optimizer")]
    assert (sum(totals[n]["total_s"] for n in phases)
            <= totals["train_step"]["total_s"])
    events = _host_events(prof, ["train_step", *phases])
    (root,) = events["train_step"]
    for name, spans in events.items():
        assert spans and all(_inside(s, root) for s in spans), name


def test_a_launch_is_a_span_and_still_counts(monkeypatch):
    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    kernel = _cuda.CudaKernel("none.cu", "smx_test_kernel", [])
    try:
        calls = []
        kernel._fn = lambda *args: calls.append(args) or 0
        kernel.launch()
        assert profiling.span_totals() == {}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            kernel.launch(7)
        assert calls == [(0,), (7, 0)]
        assert kernel.launches == 2
        totals = profiling.span_totals()
        assert totals["launch.smx_test_kernel"]["count"] == 1
        assert _host_events(prof, ["launch.smx_test_kernel"])[
            "launch.smx_test_kernel"]
        kernel._fn = lambda *args: 2
        with pytest.raises(RuntimeError, match="cudaError_t 2"):
            with profile(activities=[ProfilerActivity.CPU]):
                kernel.launch()
        assert kernel.launches == 2
    finally:
        _cuda._REGISTRY.remove(kernel)


def _fake_clock(monkeypatch):
    """profiling's clock as a counter: each reading 1000 ns after the
    last, so that each span's total and self time is a count of readings."""
    ticks = iter(range(0, 10 ** 9, 1000))
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    monkeypatch.setattr(profiling, "_enabled", lambda: True)
    monkeypatch.setattr(profiling, "_record", lambda *args: _NoRange())


class _NoRange:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_self_time_leaves_out_the_children(monkeypatch):
    _fake_clock(monkeypatch)
    with profiling.annotate("outer", root=True):
        with profiling.annotate("inner"):
            pass
        with profiling.annotate("inner"):
            pass
    t = profiling.span_totals()
    # a span reads the clock twice on entry (before and after its own
    # cost) and once on exit, once more when it has a parent: an inner
    # span's total is 1 reading, the 3 before its parent's child time
    assert t["inner"] == {"count": 2, "total_s": 2e-6, "self_s": 2e-6}
    assert t["outer"] == {"count": 1, "total_s": 9e-6, "self_s": 3e-6}
    profiling.reset_spans()
    assert profiling.span_totals() == {}


def test_a_decode_loop_left_early_closes_its_step(monkeypatch):
    # greedy's early_stop leaves the loop with a break
    _fake_clock(monkeypatch)
    for t in generation._steps(5):
        assert [s.name for s in profiling._stack()] == ["decode.step"]
        if t == 2:
            break
    assert profiling._stack() == []
    assert profiling.span_totals()["decode.step"]["count"] == 3


def test_each_thread_keeps_its_own_stack(monkeypatch):
    _fake_clock(monkeypatch)
    opened, release = threading.Event(), threading.Event()
    seen = {}

    def other():
        with profiling.annotate("other.outer"):
            seen["stack"] = [s.name for s in profiling._stack()]
            opened.set()
            release.wait(10)

    with profiling.annotate("main.outer"):
        thread = threading.Thread(target=other)
        thread.start()
        assert opened.wait(10)
        # the other thread's open span is not on this thread's stack
        assert [s.name for s in profiling._stack()] == ["main.outer"]
        with profiling.annotate("main.inner"):
            assert len(profiling._stack()) == 2
        release.set()
        thread.join(10)
    assert seen["stack"] == ["other.outer"]
    assert profiling._stack() == []
    # readings: main.outer 0, 1; other.outer 2, 3; main.inner 4, 5, 6, 7;
    # other.outer's end 8; main.outer's end 9.  The other thread's span,
    # open inside main.outer, is no child of it: main.outer's self time
    # leaves out main.inner's 3 readings alone
    assert profiling.span_totals() == {
        "main.outer": {"count": 1, "total_s": 8e-6, "self_s": 5e-6},
        "main.inner": {"count": 1, "total_s": 1e-6, "self_s": 1e-6},
        "other.outer": {"count": 1, "total_s": 5e-6, "self_s": 5e-6}}
