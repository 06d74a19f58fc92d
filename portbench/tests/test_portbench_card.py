"""The benchmark's own command on a CUDA card, each cell once untraced and
once traced, with a short window: the result line's keys, ``correct``, each
cell's metrics, and the traced run's device fields and breakdown.

    python -m pytest portbench/tests/test_portbench_card.py -q   # on a card
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_command_on_the_card(card, name, trace):
    from portbench import harness

    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed", str(2**31 + 3),
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    cell = harness.find_cell(ROOT, name)
    metrics = cell.per_layer() if trace else cell.end_to_end()
    assert set(line["metrics"]) == {m["name"] for m in metrics}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
