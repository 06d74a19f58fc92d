"""Each cell driven end to end at a small size on the CPU (the program's
plain versions and eager steps), the per-layer readers on a made-up trace,
and a new cell added purely as files."""

import json
import shutil

import pytest

from conftest import ROOT, SMALL
from portbench import harness, tracing
from portbench.run import run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    result = run_cell(ROOT, name, 2**31 + 11, 0.5, 0, device="cpu", overrides=SMALL[name],
                      log=lambda message: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    expected = {m["name"] for m in harness.find_cell(ROOT, name).end_to_end()}
    assert set(result["metrics"]) == expected
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["forbidden"] == []


def test_trace_reduction_and_readers():
    marker = tracing.MARKER
    device = ([(marker, 0, 1)] + [("moment_sweep_kernel<float>", 10, 30),
                                  ("aten::mm_kernel", 25, 40), ("aten::add_kernel", 60, 70)]
              + [(marker, 80, 81)])
    host = [("portbench.call", 2, 8), ("portbench.call", 41, 55), ("cudaStreamSynchronize", 45, 58)]
    trace = tracing.reduce(device, host, calls=2)
    assert trace.window_s == pytest.approx(60e-6) and trace.busy_s == pytest.approx(40e-6)
    assert trace.idle_gaps[0] == ("cudaStreamSynchronize", pytest.approx(20e-6))
    assert tracing.reduce(device[1:], host, calls=2) is None  # the lead markers lost

    class Context:
        calls = 2

        def __init__(self):
            self.trace = trace
            self.window = harness.Window(calls=4, seconds=120e-6, host=[0.008, 0.012])

        def graph_nodes(self):
            return 7

        def work(self):
            return 3.35e12 * 10e-6, 0.0  # 10 us of bytes

    ctx = Context()
    values = {name: harness.reader(ROOT, name)(ctx) for name in (
        "host_call_ms.ppo", "graph_nodes.tune", "torch_ops_ms.read", "roofline_share.tune",
        "device_idle.read")}
    assert values["host_call_ms.ppo"] == pytest.approx(10.0)  # the untraced window's
    assert values["graph_nodes.tune"] == 7
    assert values["torch_ops_ms.read"] == pytest.approx(0.0125)  # 25 us of aten, 2 calls
    assert values["roofline_share.tune"] == pytest.approx(50.0)  # 10 us of 20 us busy a call
    assert values["device_idle.read"] == pytest.approx(1 - 20 / 30)  # 20 us busy of 30 a call


def test_a_new_cell_is_new_files_only(tmp_path):
    """The whole-EA tuner (a cell left for later) added by a traffic file, a
    limits file, a reader and entries in BENCHMARK.json: nothing edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ares_ea.tune_small", "config": "ares_ea",
                               "traffic": "tune_small", "chips": 1, "why": "a test"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "tune_step_ms":
            metric["workloads"].append("ares_ea.tune_small")
    bench["per_layer"].append({"name": "calls.tune", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "tune_step_ms", "workloads": ["ares_ea.tune_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "portbench/traffic/tune_100k.json").read_text())
    traffic.update(settings=12, reference_block=6,
                   fields={"Quadrupole": {"range": [0.5, 3.0], "either_sign": True}})
    (tmp_path / "portbench/traffic/tune_small.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "portbench/limits/ares_full.tune_100k.json",
                tmp_path / "portbench/limits/ares_ea.tune_small.json")
    (tmp_path / "portbench/metrics/calls.py").write_text("def read(ctx):\n    return ctx.calls\n")
    result = run_cell(tmp_path, "ares_ea.tune_small", 77, 0.3, 0, device="cpu",
                      log=lambda message: None)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"tune_step_ms", "setup_s"}
    cell = harness.find_cell(tmp_path, "ares_ea.tune_small")
    assert [m["name"] for m in cell.per_layer()] == ["calls.tune"]
    assert harness.reader(tmp_path, "calls.tune")(type("C", (), {"calls": 5})()) == 5
