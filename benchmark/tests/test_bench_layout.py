"""The benchmark is data: BENCHMARK.json's cells, configurations, mixes,
limits and metrics are files found by name; the configuration files build
the port's configuration; nothing the benchmark runs imports JAX or the
JAX package, and the reference imports nothing of the port."""

import ast
import glob
import json
import os
import re

from benchmark import core

HERE = core.HERE
ROOT = core.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_loads_by_name():
    bench = _bench()
    for cell in bench["workloads"]:
        _, got, cfg_file, mix, limits = core.load_cell(cell["name"])
        assert got == cell
        assert mix["entry"] in ("generate", "train_step")
        assert set(limits) == ({"score_err", "served_gap"}
                               if mix["entry"] == "generate" else
                               {"loss_gap", "grad_gap", "delta_gap_worst",
                                "delta_gap_median", "layerdrop_mismatch"})
        assert "speechmix" in cfg_file
        for trace in (0, 1):
            names = [m["name"] for m in core.cell_metrics(bench, cell,
                                                          trace)]
            assert names, (cell["name"], trace)
            for name in names:
                assert callable(core.reader(name))
        e2e = [m["name"] for m in core.cell_metrics(bench, cell, 0)]
        assert "setup_s" in e2e and len(e2e) >= 2


def test_names_units_and_moves():
    bench = _bench()
    e2e = {m["name"] for m in bench["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", [
            w["name"] for w in bench["workloads"]]))
    for m in bench["end_to_end"]:
        assert m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                      "device_trace")


def test_configuration_files_build_the_port_config():
    from speechmix_tpu_torch.config import SpeechMixConfig
    from benchmark import program, weights
    for c in _bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg_file = json.load(f)
        cfg = program.port_config(cfg_file)
        assert isinstance(cfg, SpeechMixConfig)
        assert json.loads(cfg.to_json()) == cfg_file["speechmix"]
        assert weights.spec(cfg_file["speechmix"])


def test_a_new_metric_file_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "calls.train.py").write_text(
        "def read(run):\n    return float(run['calls'])\n")
    monkeypatch.setattr(core, "HERE", str(tmp_path))
    assert core.reader("calls.train")({"calls": 7}) == 7.0


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax",
                                      "speechmix_tpu"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        assert "speechmix_tpu_torch" not in set(_imports(path)), path
        # nor the benchmark's program driver
        text = open(path).read()
        assert "program" not in set(_imports(path))
        assert "speechmix_tpu_torch" not in text
