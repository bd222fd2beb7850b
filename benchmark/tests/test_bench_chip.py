"""On the card: one short traced run of each cell, its result line held
to the contract's keys; skipped where there is no card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import core


def _cells():
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", _cells())
def test_short_traced_run(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "3", "--trace", "1"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
    assert len(line["breakdown"]["device_ops"]) <= 10
