"""The control at a size a test run holds: the reference computed one
precision below the cell's (tf32 below float32, fp8 below bfloat16) in the
program's place comes out not correct under each cell's committed limits,
where the program itself comes out correct.  On the card the same readings
at the cells' own sizes are ``benchmark/control.py``'s."""

import json
import os

import pytest

import bench_tiny
from benchmark import check, control, core

CELLS = [("w2v2b-bartb.transcribe-f32-b128", "generate", "tf32"),
         ("w2v2b-bartb.train-f32-b32", "train_step", "tf32"),
         ("xlsr1b-bartl.train-bf16-b16", "train_step", "fp8")]


@pytest.mark.parametrize("cell,entry,low", CELLS)
def test_control_is_not_correct(cell, entry, low):
    with open(os.path.join(core.HERE, "limits", cell + ".json")) as f:
        limits = json.load(f)
    _, cfg_file = bench_tiny.config()
    for out in control.readings(cfg_file, bench_tiny.MIXES[entry], [5, 6],
                                2, low, "cpu", calls=4):
        program = {k: out["program"][k] for k in limits}
        ctl = {k: out[low][k] for k in limits}
        assert check.judge(program, limits)[0], (out["seed"], program)
        assert not check.judge(ctl, limits)[0], (out["seed"], ctl)
