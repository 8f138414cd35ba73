"""The harness: ``BENCHMARK.json`` against the benchmark's contract, each
cell and metric found by name in files of its own, a new workload file
found with no edit, and ``run.py`` refusing to run without a card."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import cells

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and "bound" not in m
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = cells.load(cell)
    assert c.workload["name"] == cell
    assert (ROOT / "portbench" / "drivers" / f"{c.workload['driver']}.py").is_file()
    assert cells.driver(c.workload["driver"]).run
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_its_reader(metric):
    assert callable(cells.metric_reader(metric))


def test_every_config_serves_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_new_workload_file_is_found_with_no_edit(tmp_path):
    """A later change adds a cell by adding its files and its entry alone."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        dict(BENCH["workloads"][0], name="fl_sfl_n64", traffic="sfl_n64")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "portbench/traffic/sfl_n128.json").read_text())
    traffic["fl"]["n_selected"] = 64
    (tmp_path / "portbench/traffic/sfl_n64.json").write_text(json.dumps(traffic))
    wl = json.loads((ROOT / "portbench/workloads/fl_sfl_n128.json").read_text())
    (tmp_path / "portbench/workloads/fl_sfl_n64.json").write_text(json.dumps(dict(wl, name="fl_sfl_n64")))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench.harness import cells; "
            "c = cells.load('fl_sfl_n64'); print(c.traffic['fl']['n_selected'], c.workload['driver'], "
            "*sorted(m['name'] for m in c.end_to_end))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["64", "fl_round", "round_device_s", "setup_s"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"), "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, env=env,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_run_without_the_program_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card_is_correct(cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147483711", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0 and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["metrics"]["setup_s"]["value"] > 0


def test_the_trace_attributes_device_time_to_the_launching_range():
    """A kernel counts to the ranges its launch sat in on the host, found by
    its correlation id, however late it ran on the card."""
    from portbench.harness.trace import HOST_IDLE, WINDOW, parse

    X = lambda **e: dict(ph="X", **e)   # noqa: E731
    events = [
        X(name=WINDOW, cat="user_annotation", ts=0.0, dur=1000.0, tid=1),
        X(name="backend.train_s", cat="user_annotation", ts=50.0, dur=550.0, tid=1),
        X(name="kernels.agg_reduce", cat="user_annotation", ts=100.0, dur=100.0, tid=1),
        X(name="cudaLaunchKernel", cat="cuda_runtime", ts=150.0, dur=5.0, tid=1,
          args={"correlation": 1}),
        X(name="cudaLaunchKernel", cat="cuda_runtime", ts=400.0, dur=5.0, tid=1,
          args={"correlation": 2}),
        X(name="agg", cat="kernel", ts=300.0, dur=50.0, tid=7, args={"correlation": 1}),
        X(name="gemm", cat="kernel", ts=500.0, dur=100.0, tid=7, args={"correlation": 2}),
    ]
    tr = parse(events)
    assert tr.window_s == pytest.approx(1e-3) and tr.busy_s == pytest.approx(150e-6)
    assert tr.range_calls == {"backend.train_s": 1, "kernels.agg_reduce": 1}
    assert tr.range_device_s["kernels.agg_reduce"] == pytest.approx(50e-6)
    assert tr.range_device_s["backend.train_s"] == pytest.approx(150e-6)
    assert dict(tr.idle_gaps) == pytest.approx({"backend.train_s": 450e-6, HOST_IDLE: 400e-6})
    assert [n for n, _ in tr.device_ops] == ["gemm", "agg"]


def test_a_roofline_reader_reads_the_bound_over_the_ranges_time():
    from portbench.harness.trace import Trace
    from portbench.work.kernels import agg_reduce

    c = cells.load("fl_sfl_n128")
    rows = [{"involved": 127.0}, {"involved": 120.0}, {"involved": 0.0}]
    bound = sum(agg_reduce(128, n, 16, 4).bound_s() for _ in range(2)
                for n in (800, 32, 51200, 64, 6422528, 2048, 126976, 62))
    tr = Trace(window_s=5.0, busy_s=2.0, range_calls={"kernels.agg_reduce": 16},
               range_device_s={"kernels.agg_reduce": 2 * bound}, device_ops=[], idle_gaps=[])
    ctx = {"trace": tr, "traffic": c.traffic, "config": c.config, "traced_rows": rows}
    assert cells.metric_reader("agg_reduce_roofline")(ctx) == pytest.approx(50.0)
    tr.range_calls["kernels.agg_reduce"] = 15          # a call the trace lost: no reading
    assert cells.metric_reader("agg_reduce_roofline")(ctx) is None


def test_the_card_is_busy_for_the_union_of_its_operations():
    """Overlapping, nested and touching operations count once; the host's
    events and the card's ranges do not count."""
    import numpy as np
    from torch._C._autograd import DeviceType

    from portbench.harness.trace import device_intervals, union_seconds

    class Ev:
        def __init__(self, dev, kind, a, d):
            self.dev, self.kind, self.a, self.d = dev, kind, a, d

        def device_type(self):
            return self.dev

        def activity_type(self):
            return self.kind

        def start_ns(self):
            return self.a

        def duration_ns(self):
            return self.d

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Ev(cuda, "kernel", 100, 50), Ev(cuda, "kernel", 120, 10),
              Ev(cuda, "gpu_memcpy", 150, 30), Ev(cuda, "gpu_memset", 400, 100),
              Ev(cpu, "cuda_runtime", 0, 1000), Ev(cuda, "gpu_user_annotation", 0, 1000)]
    s, e, n = device_intervals(events)
    assert n == 4 and union_seconds(s, e) == 180
    assert union_seconds(np.array([], np.int64), np.array([], np.int64)) == 0.0
    assert union_seconds(np.array([5, 0]), np.array([6, 10])) == 10


def test_the_mfu_reads_the_model_flops_over_the_cards_busy_time():
    from portbench.work.models import cnn_train_flops_per_sample
    from portbench.work.peaks import PEAK_FLOPS

    c = cells.load("fl_sfl_n128")
    fl = c.traffic["fl"]
    rows = [{"involved": 127.0}, {"involved": 120.0}]
    flops = 247 * fl["local_steps"] * fl["local_batch"] * cnn_train_flops_per_sample(c.config)
    ctx = {"rows": rows, "traffic": c.traffic, "config": c.config,
           "device_busy_s": flops / PEAK_FLOPS["f32"] / 0.25, "window_s": 99.0}
    assert cells.metric_reader("fl.mfu")(ctx) == pytest.approx(25.0)
    assert cells.metric_reader("fl.round_wall_s")(ctx) == pytest.approx(49.5)
    assert cells.metric_reader("fl.mfu")(dict(ctx, device_busy_s=None)) is None
