"""A run with its timed path broken underneath comes out not correct, under
the limits the cells commit: the harness's look for a card is skipped and
the rest of a run (set-up, window, check) is driven on the CPU at a tiny
size.  Faults: a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; a token altered where it is
produced (the second, which later positions read, and the last, which
none reads).  (No cell spans chips, so there is no exchange to leave out.)"""

import json
import os
import time

import pytest
import torch

import bench_tiny
from benchmark import core, faults

SEED = 2 ** 31 + 77


def _limits(cell):
    with open(os.path.join(core.HERE, "limits", cell + ".json")) as f:
        return json.load(f)


def _run(entry, cell, hook=None):
    _, f = bench_tiny.config()
    _, correct, compared = core.run_cell(
        {"name": cell}, f, bench_tiny.MIXES[entry], _limits(cell), SEED,
        0.01, 0, "cpu", time.perf_counter(), session_hook=hook)
    return correct, dict((n, v) for n, v, _ in compared)


TRAIN_CELLS = ["w2v2b-bartb.train-f32-b32", "xlsr1b-bartl.train-bf16-b16"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_sound_train_run_is_correct(cell):
    correct, values = _run("train_step", cell)
    assert correct, values


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [faults.unchanged_state, faults.half_batch])
def test_broken_train_step_is_not_correct(cell, fault):
    correct, values = _run("train_step", cell, fault)
    assert not correct, values


def test_sound_transcription_is_correct():
    correct, values = _run("generate", "w2v2b-bartb.transcribe-f32-b128")
    assert correct, values


@pytest.mark.parametrize("fault", [faults.altered_token,
                                   faults.altered_last_token])
def test_altered_token_is_not_correct(fault):
    correct, values = _run("generate", "w2v2b-bartb.transcribe-f32-b128",
                           fault)
    assert not correct, values


def test_a_last_token_off_the_argmax_is_served_gaps_to_catch():
    """A last token that is not the argmax of its scores leaves the scores'
    error as it was: only served_gap sees it."""
    limits = _limits("w2v2b-bartb.transcribe-f32-b128")
    _, sound = _run("generate", "w2v2b-bartb.transcribe-f32-b128")
    _, values = _run("generate", "w2v2b-bartb.transcribe-f32-b128",
                     faults.altered_last_token)
    assert values["score_err"] == sound["score_err"] <= limits["score_err"]
    assert values["served_gap"] > limits["served_gap"] >= sound["served_gap"]


def test_no_card_no_result(monkeypatch, capsys):
    """run.py exits non-zero and prints no result line without a card."""
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "w2v2b-bartb.train-f32-b32", "--seed",
                     "1", "--seconds", "1"])
    assert code != 0
    assert capsys.readouterr().out == ""
