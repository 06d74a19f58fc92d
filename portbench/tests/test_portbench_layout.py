"""BENCHMARK.json against the contract's static rules, and the harness's
imports: nothing under portbench/ loads JAX or the JAX package, and the
plain reference loads nothing of the program."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "lynx_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_keys_names_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for name in list(configs) + list(cells) + metrics:
        assert NAME.match(name), name
    for config in configs.values():
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert len(config["why"]) <= 200 and len(config["source"]) <= 200
        assert (ROOT / config["file"]).is_file() and config["file"].startswith("portbench/")
        assert config["reduced"] == json.loads((ROOT / config["file"]).read_text())["reduced"]
    assert {w["config"] for w in cells.values()} == set(configs)
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    for cell in cells.values():
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{cell['name']}.json").is_file()


def test_every_cell_reports_setup_another_metric_and_a_layer():
    from portbench import harness

    for cell in BENCH["workloads"]:
        found = harness.find_cell(ROOT, cell["name"])
        e2e = [m["name"] for m in found.end_to_end()]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = found.per_layer()
        assert layers
        for metric in layers:
            assert metric["moves"] in e2e
            assert callable(harness.reader(ROOT, metric["name"]))


def test_bounds_and_metric_entries():
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["better"] in ("lower", "higher")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for metric in BENCH["per_layer"]:
        assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")


def test_check_fits_the_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in (ROOT / "portbench").rglob("*.py")))
def test_no_module_loads_jax_or_the_jax_package(path):
    names = top_level_imports(ROOT / path)
    assert not names & FORBIDDEN
    assert not names & {"chip_smoke", "bench", "benchmarks"}
    if path.startswith("portbench/reference/"):
        assert "lynx_tpu_torch" not in names


def test_refuses_without_a_card_and_without_the_program(tmp_path):
    import torch

    command = [sys.executable, "portbench/run.py", "--workload", "ares_ea.screen_b1",
               "--seed", "2147483659", "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        done = subprocess.run(command, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert done.returncode != 0 and done.stdout == ""
    # A checkout of only BENCHMARK.json and the benchmark's folder.
    subprocess.run(["cp", "-r", str(ROOT / "portbench"), str(tmp_path / "portbench")],
                   check=True)
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    done = subprocess.run(command, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""
