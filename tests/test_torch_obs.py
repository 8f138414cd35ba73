"""repro_torch.obs: the tracer, the metrics registry, the context, the
profiler ranges and timings, the logging, and the wiring through the
drivers and the PON simulators — held against ``repro.obs`` where both
packages compute the same thing, and on the port's own terms (tracing moves
no History value, a replay is invisible, the disabled path costs nothing)
elsewhere. Mirrors tests/test_obs.py; the entry points' flags at the end."""
import argparse
import collections
import importlib
import importlib.util
import io
import json
import logging
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402
from test_torch_stub_library import stub_libraries  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.obs import logging as jlogging  # noqa: E402
from repro.obs.metrics import Histogram as JHistogram  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro_torch import fl, obs, runtime  # noqa: E402
from repro_torch.core.fedavg import FLConfig  # noqa: E402
from repro_torch.launch import femnist, femnist_async, train  # noqa: E402
from repro_torch.obs import obs_logging, profile  # noqa: E402
from repro_torch.obs.context import Obs  # noqa: E402
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: E402
from repro_torch.obs.tracer import NOOP_TRACER, Tracer  # noqa: E402
from repro_torch.pon import PonConfig  # noqa: E402
from repro_torch.pon.dba import make_dba  # noqa: E402
from repro_torch.pon.events import Topology, UpstreamJob, UpstreamSim  # noqa: E402
from repro_torch.pon.fast import FluidUpstreamSim  # noqa: E402

quantize = importlib.import_module("repro_torch.kernels.quantize")
agg = importlib.import_module("repro_torch.kernels.agg_reduce")
flash = importlib.import_module("repro_torch.kernels.flash_attention")
rglru = importlib.import_module("repro_torch.kernels.rglru_scan")
rwkv6 = importlib.import_module("repro_torch.kernels.rwkv6_scan")


# ------------------------------------------------------------------ tracer

def test_spans_nest_and_close_on_sim_clock():
    t = Tracer()
    sim = {"now": 0.0}
    clock = lambda: sim["now"]  # noqa: E731
    with t.span("outer", lane=("fl", "rounds"), clock=clock):
        sim["now"] = 1.0
        with t.span("inner", clock=clock):
            sim["now"] = 2.0
        sim["now"] = 3.0
    assert t._depth == 0
    assert [s.name for s in t.spans] == ["inner", "outer"]
    by = {s.name: (s.t0_s, s.t1_s) for s in t.spans}
    assert by == {"outer": (0.0, 3.0), "inner": (1.0, 2.0)}
    with pytest.raises(ValueError):
        t.span("no clock")


def test_wall_spans_unaffected_by_sim_offset():
    t = Tracer()
    t.offset_s = 1000.0
    t.add_span("sim", 0.0, 1.0)
    with t.wall_span("host-work"):
        pass
    sim_span, wall_span = t.spans
    assert (sim_span.t0_s, sim_span.t1_s) == (1000.0, 1001.0)
    assert wall_span.lane[0] == "wall" and 0.0 <= wall_span.t0_s <= wall_span.t1_s < 100.0


def test_non_finite_spans_and_instants_are_dropped():
    t = Tracer()
    t.add_span("bad", float("nan"), 1.0)
    t.add_span("bad", 0.0, float("inf"))
    t.instant("bad", float("nan"))
    t.counter("bad", float("inf"), {"v": 1})
    assert not t.spans and not t.instants and not t.counters


def test_chrome_export_equals_the_reference(tmp_path):
    """The same calls export the reference's Chrome trace-event dict."""
    docs = []
    for T in (Tracer, jobs.Tracer):
        t = T()
        t.add_span("grant", 1.0, 2.0, lane=("pon0", "onu3"), cat="grant", args={"wavelength": 0})
        t.instant("server-update", 2.5, lane=("server", "agg"))
        t.counter("dba", 1.5, {"queue_depth": 4}, lane=("pon0", "dba"))
        docs.append(t.to_chrome())
    assert docs[0] == docs[1]
    doc = docs[0]
    assert {e["ph"] for e in doc["traceEvents"]} == {"X", "i", "C", "M"}
    x = [e for e in doc["traceEvents"] if e["ph"] == "X"][0]
    assert (x["ts"], x["dur"]) == (1.0e6, 1.0e6)
    t = Tracer()
    assert json.load(open(t.write(str(tmp_path / "t.json")))) == t.to_chrome()


def test_noop_tracer_is_allocation_free_on_hot_paths():
    assert not NOOP_TRACER.enabled
    assert NOOP_TRACER.span("x") is NOOP_TRACER.wall_span("y")
    NOOP_TRACER.add_span("x", 0, 1)
    assert NOOP_TRACER.spans == () and NOOP_TRACER.to_chrome()["traceEvents"] == []
    # the grant machines drop a disabled tracer: completions never test it
    topo = Topology.uniform(2, 1, 1)
    assert UpstreamSim(topo, make_dba("fifo"), tracer=NOOP_TRACER)._tracer is None
    assert FluidUpstreamSim(topo, tracer=NOOP_TRACER)._tracer is None
    # and a disabled driver round formats no span argument
    exp, backend = _transport("sfl")
    calls = []
    spy = type("Spy", (), {"enabled": False, "offset_s": 0.0,
                           "add_span": lambda *a, **k: calls.append(a),
                           "counter": lambda *a, **k: calls.append(a),
                           "instant": lambda *a, **k: calls.append(a)})()
    fl.RoundLoop(exp, backend, obs=Obs(tracer=spy)).run()
    assert calls == []


def test_upstream_sim_emits_grant_spans_when_enabled():
    t = Tracer()
    reg = MetricsRegistry()
    sim = UpstreamSim(Topology.uniform(3, 1, 1), make_dba("fifo"), tracer=t, metrics=reg)
    for i in range(3):
        sim.submit(UpstreamJob(seq=i, onu=0, size_mbits=100.0, ready_s=float(i)))
    sim.drain()
    grants = [s for s in t.spans if s.cat == "grant"]
    assert len(grants) == 3 and {s.lane for s in grants} == {("pon", "onu0")}
    assert all(s.args["size_mbits"] == 100.0 and s.t1_s > s.t0_s for s in grants)
    assert reg.counter("pon.jobs_served").total == 300.0
    assert reg.counter("pon.wl0.busy_s").total == pytest.approx(3.0)
    assert reg.histogram("pon.dba.queue_depth").count > 0 and t.counters


# ----------------------------------------------------------------- metrics

def test_counter_take_is_bit_for_bit():
    c = Counter("pon.upstream_mbits")
    total = 0.0
    for v in (211.32, 0.1, 0.2, 1e-9, 3381.12):
        c.add(v)
        total += v
        assert c.take() == v
    assert c.total == total
    c.add(1.0)
    c.add(2.0)
    assert c.peek() == 3.0 and c.take() == 3.0 and c.peek() == 0.0


@settings(max_examples=40)
@given(adds=st.lists(st.tuples(st.floats(min_value=0.0, max_value=1e4), st.booleans()),
                     min_size=0, max_size=60))
def test_counter_total_equals_sum_of_drained_windows(adds):
    c = Counter("prop")
    windows = []
    for v, do_take in adds:
        c.add(v)
        if do_take:
            windows.append(c.take())
    windows.append(c.take())
    assert math.isclose(c.total, math.fsum(windows), rel_tol=1e-12, abs_tol=1e-9)
    assert c.n == len(adds) and c.peek() == 0.0


@pytest.mark.parametrize("name", ["pin", "fl.staleness"])
def test_histogram_reservoir_equals_the_reference(name):
    """Algorithm R seeded from crc32(name): the same observations keep the
    reference's samples, so the exported quantiles are equal."""
    h, j = Histogram(name, max_samples=32), JHistogram(name, max_samples=32)
    vals = [float(v) for v in range(500)]
    for v in vals:
        h.observe(v)
        j.observe(v)
    assert h.count == 500 and h.sum == sum(vals) and (h.min, h.max) == (0.0, 499.0)
    assert h.samples == j.samples and h.to_dict() == j.to_dict()
    assert any(v >= 32 for v in h.samples)


def test_histogram_merge_and_summaries():
    a, b = Histogram("m", max_samples=16), Histogram("m", max_samples=16)
    for v in range(40):
        a.observe(float(v))
    for v in range(40, 100):
        b.observe(float(v))
    a.merge_from(b)
    assert a.count == 100 and a.sum == sum(range(100)) and len(a.samples) <= 16
    g = Gauge("g")
    for v in (3.0, 1.0, 2.0):
        g.set(v)
    assert (g.value, g.min, g.max) == (2.0, 1.0, 3.0)
    assert Histogram("e").to_dict()["min"] is None and Gauge("e").to_dict()["min"] is None


def test_registry_jsonl_is_the_reference_schema(tmp_path):
    """Either package reads the other's metrics file; records and summary
    are the reference's for the same instruments and tags."""
    regs = []
    for R in (MetricsRegistry, JMetricsRegistry):
        reg = R()
        reg.tag("sim_engine", "fast")
        reg.counter("pon.upstream_mbits").add(1479.296)
        reg.gauge("fl.n_pons").set(4.0)
        reg.histogram("fl.involved").observe(13.0)
        regs.append(reg)
    assert regs[0].records() == regs[1].records() and regs[0].summary() == regs[1].summary()
    p = regs[0].write_jsonl(str(tmp_path / "m.jsonl"))
    assert jobs.read_jsonl(p) == obs.read_jsonl(p) == regs[1].records()
    assert [r["name"] for r in obs.read_jsonl(p)] == ["pon.upstream_mbits", "fl.n_pons",
                                                     "fl.involved"]
    assert obs.SCHEMA == jobs.SCHEMA == "repro.obs/v1"


def test_child_registries_merge_into_one_artifact():
    root = Obs()
    a, b = root.child(), root.child()
    a.metrics.counter("pon.upstream_mbits").add(1.0)
    b.metrics.counter("pon.upstream_mbits").add(2.0)
    assert a.tracer is root.tracer and a.health is root.health
    assert root.merged_metrics().counter("pon.upstream_mbits").total == 3.0


# --------------------------------------------- drivers: the bit-for-bit pin

def _transport(mode, n_pons=1, rounds=3, policy="sync", **pon_kw):
    pon = PonConfig(n_onus=4, clients_per_onu=5, n_pons=n_pons, **pon_kw)
    flc = FLConfig(n_onus=4, clients_per_onu=5, n_pons=n_pons, n_selected=8 * n_pons, pon=pon)
    counts = np.random.default_rng(0).integers(50, 400, flc.n_clients).astype(np.float32)
    onu = np.arange(flc.n_clients) // flc.clients_per_onu
    skw = fl.filter_strategy_kwargs(mode, {"n_pons": n_pons})
    backend = fl.TransportBackend(fl.make_strategy(mode, **skw), counts, onu)
    exp = fl.ExperimentConfig(fl=flc, strategy=fl.canonical_name(mode),
                              strategy_kwargs=tuple(sorted(skw.items())), n_rounds=rounds,
                              seed=3, policy=policy)
    return exp, backend


def _run(mode, n_pons=1, policy=None, obs_bundle=None, **kw):
    exp, backend = _transport(mode, n_pons, policy=policy or "sync", **kw)
    drv = (fl.RoundLoop(exp, backend, obs=obs_bundle) if policy is None
           else runtime.Orchestrator(exp, backend, obs=obs_bundle))
    return drv, drv.run()


def _no_host(rows):
    return [{k: v for k, v in r.items() if k not in ("wall_s", "dispatch_host_s")} for r in rows]


@pytest.mark.parametrize("mode,n_pons", [("classical", 1), ("sfl", 1), ("hier_sfl", 2)])
def test_registry_totals_match_history_bit_for_bit(mode, n_pons):
    loop, hist = _run(mode, n_pons)
    reg = loop.metrics
    assert reg.counter("pon.upstream_mbits").total == sum(hist.column("upstream_mbits"))
    assert loop.total_upstream_mbits == reg.counter("pon.upstream_mbits").total
    if n_pons > 1:
        assert reg.counter("metro.mbits").total == sum(hist.column("metro_mbits"))
        assert reg.counter("trunk.mbits").total == sum(hist.column("trunk_mbits"))
        assert reg.gauge("fl.n_pons").value == n_pons
        assert reg.gauge("pon.mbits_max").value == hist.column("pon_mbits_max")[-1]
    assert reg.histogram("fl.involved").count == len(hist)
    assert reg.tags == {"sim_engine": "event"}


@pytest.mark.parametrize("policy", ["semi_sync", "fedbuff"])
def test_orchestrator_totals_come_from_the_registry(policy):
    orch, hist = _run("hier_sfl", 2, policy=policy, rounds=4)
    reg = orch.metrics
    assert orch.total_upstream_mbits == reg.counter("pon.upstream_mbits").total
    assert orch.total_metro_mbits == reg.counter("metro.mbits").total
    assert reg.counter("pon.upstream_mbits").total >= sum(hist.column("upstream_mbits"))
    assert reg.histogram("fl.involved").count == len(hist)
    assert reg.histogram("fl.staleness").count == sum(hist.column("involved"))


@pytest.mark.parametrize("mode,n_pons,policy,pon_kw", [
    ("classical", 1, None, {}), ("sfl", 1, None, {}), ("hier_sfl", 2, None, {}),
    ("sfl", 1, None, dict(dba="fl_priority", n_wavelengths=2, background_load=0.3)),
    ("sfl", 1, None, dict(sim_engine="hybrid", background_load=0.3)),
    ("sfl", 1, "sync", {}), ("sfl", 1, "semi_sync", {}), ("classical", 1, "fedbuff", {}),
    ("hier_sfl", 2, "fedbuff", {}), ("sfl", 1, "fedbuff", dict(sim_engine="fast")),
])
def test_tracing_changes_no_history_values(mode, n_pons, policy, pon_kw):
    """An enabled tracer with health monitors is a pure observer: History
    keys and values equal an unobserved run's bit for bit (but the host
    times and the incident count), and the run's generator ends alike."""
    rounds = 4 if policy else 3
    base_drv, base = _run(mode, n_pons, policy, rounds=rounds, **pon_kw)
    sess = obs.session(trace_out="unused", health=True)
    try:
        drv, traced = _run(mode, n_pons, policy, rounds=rounds, **pon_kw)
    finally:
        sess.obs.tracer.write = lambda path: path      # nothing to disk
        sess.finish(quiet=True)
    assert len(sess.obs.tracer.spans) > 0
    strip = lambda rows: [{k: v for k, v in r.items() if k != "incidents"}  # noqa: E731
                          for r in _no_host(rows)]
    assert strip(base) == strip(traced)
    assert base_drv.rng.integers(1 << 30) == drv.rng.integers(1 << 30)


def test_round_loop_trace_covers_grants_and_tiers():
    enabled = Obs.enabled_tracing()
    with obs.use(enabled):
        _run("hier_sfl", 2, rounds=2)
    spans = enabled.tracer.spans
    assert {"grant", "agg", "client", "round"} <= {s.cat for s in spans}
    grant_lanes = {s.lane for s in spans if s.cat == "grant"}
    assert any(l[0].startswith("pon") and l[1].startswith("onu") for l in grant_lanes)
    assert any(l[1].startswith("olt") for l in grant_lanes)
    assert {"θ-gather", "Φ-gather", "Ψ-agg", "round"} <= {s.name for s in spans}
    window = PonConfig().sync_threshold_s
    assert sorted(s.t0_s for s in spans if s.name == "round") == [0.0, window]


def test_sync_policy_puts_spans_where_the_round_loop_does():
    """The sync policy and the RoundLoop emit one global timeline alike
    (``offset_s`` = round × window)."""
    traces = []
    for policy in (None, "sync"):
        enabled = Obs.enabled_tracing()
        with obs.use(enabled):
            _run("sfl", 1, policy, rounds=3, dba="fl_priority", background_load=0.3)
        traces.append(sorted((s.name, s.t0_s, s.t1_s, s.lane) for s in enabled.tracer.spans))
    assert traces[0] == traces[1] and len(traces[0]) > 0


def test_replay_is_invisible_to_obs():
    enabled = Obs.enabled_tracing()
    loop, hist = _run("sfl")
    rng = np.random.default_rng(loop.cfg.seed)
    with obs.use(enabled):
        fl.loop.replay_sync_round(loop.cfg, loop.backend, loop.cfg.make_failure_model(), rng, 0)
    assert enabled.tracer.spans == [] and enabled.metrics.names() == []
    rec = fl.loop.sync_round(loop.cfg, loop.backend, loop.cfg.make_failure_model(),
                             np.random.default_rng(loop.cfg.seed), 0, obs=Obs())
    assert rec["upstream_mbits"] == hist.column("upstream_mbits")[0]


def test_compressed_round_sets_the_wire_gauge():
    exp, backend = _transport("sfl")
    backend.strategy = fl.make_strategy("sfl", compress="int8")
    loop = fl.RoundLoop(exp, backend)
    hist = loop.run()
    g = loop.metrics.gauge("fl.wire_mbits")
    assert g.n == len(hist) and g.value == hist.column("wire_mbits")[-1] < PonConfig().model_mbits


# --------------------------------------------------------------- session/CLI

def test_session_from_cli_args_writes_artifacts(tmp_path):
    ap = argparse.ArgumentParser()
    obs.add_obs_cli_args(ap)
    trace_p, metrics_p = str(tmp_path / "trace.json"), str(tmp_path / "m.jsonl")
    args = ap.parse_args(["--trace-out", trace_p, "--metrics-out", metrics_p])
    prev = obs.get()
    sess = obs.session_from_args(args)
    try:
        assert obs.get() is sess.obs and sess.tracer.enabled
        _run("sfl")
    finally:
        sess.finish(quiet=True)
    assert obs.get() is prev
    assert json.load(open(trace_p))["traceEvents"]
    assert any(r["name"] == "pon.upstream_mbits" for r in obs.read_jsonl(metrics_p))


def test_disabled_session_is_noop_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    prev = obs.get()
    sess = obs.session()
    try:
        assert not sess.tracer.enabled and obs.get() is sess.obs
        _run("sfl")
    finally:
        sess.finish(quiet=True)
    assert obs.get() is prev and list(tmp_path.iterdir()) == []


def test_simulators_keep_torch_out_of_obs():
    """``obs.profile`` (torch.profiler) loads on first use only."""
    import subprocess
    import sys
    import os
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = ("import sys; import repro_torch.obs, repro_torch.obs.audit, repro_torch.pon; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules)); "
            "import repro_torch.obs as o; o.profile; print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": src})
    assert out.stdout.split() == ["[]", "True"]


# ----------------------------------------------------------------- profile

def test_timed_records_the_histogram_and_a_wall_span():
    reg, t = MetricsRegistry(), Tracer()
    t.offset_s = 500.0
    out, dt = profile.timed("backend.train_s", lambda x: x + 1, 1, metrics=reg, tracer=t)
    assert out == 2 and dt >= 0.0
    h = reg.histogram("backend.train_s")
    assert h.count == 1 and h.sum == dt
    (s,) = t.spans
    assert s.lane == ("wall", "compute") and s.cat == "profile" and s.t1_s < 100.0
    assert s.dur_s == pytest.approx(dt)
    assert profile.timed("x", lambda: 3)[0] == 3          # no registry, no tracer


def _ranges(fn):
    with torch.profiler.profile() as p:
        fn()
    return {e.key: e.count for e in p.key_averages() if e.key.startswith("kernels.")}


def test_each_kernel_wrapper_opens_one_range():
    """Every public wrapper runs inside ``kernels.<name>`` (the reference's
    names); a per-leaf form opens one range over its row form."""
    g = torch.Generator().manual_seed(0)
    x, n = torch.randn(3, 40, generator=g), torch.rand(3, 40, generator=g)
    w, seg = torch.rand(3, generator=g), np.array([0, 1, 1])
    q8 = quantize.quantize_rows(x, n, torch.ones(3), 127.0)
    calls = {
        "kernels.agg_reduce": [lambda: agg.segment_agg_reduce(x, w, seg, 2),
                               lambda: agg.agg_reduce(x, w, torch.ones(3))],
        "kernels.agg_reduce_quant": [lambda: agg.segment_agg_reduce_quant(x, w, seg, 2, n[:2]),
                                     lambda: agg.agg_reduce_quant(x, w, torch.ones(3), n[0])],
        "kernels.quantize_int8": [lambda: quantize.quantize_rows(x, n, torch.ones(3), 127.0),
                                  lambda: quantize.quantize_int8(x[0], n[0])],
        "kernels.quantize_int4": [lambda: quantize.quantize_rows(x, n, torch.ones(3), 7.0),
                                  lambda: quantize.quantize_int4(x[0], n[0])],
        "kernels.dequantize_int8": [lambda: quantize.dequantize_rows(q8, torch.ones(3)),
                                    lambda: quantize.dequantize_int8(q8[0], torch.tensor(1.0))],
        "kernels.topk_sparsify": [lambda: quantize.topk_mask_rows(x, torch.ones(3)),
                                  lambda: quantize.topk_mask(x[0], 0.5),
                                  lambda: quantize.topk_sparsify(x[0], 4)],
    }
    q = torch.randn(1, 2, 8, 16, generator=g)
    calls["kernels.flash_attention"] = [lambda: flash.flash_attention(q, q, q)]
    a, b = torch.rand(1, 6, 4, generator=g), torch.randn(1, 6, 4, generator=g)
    calls["kernels.rglru_scan"] = [lambda: rglru.rglru_scan(a, b)]
    r = torch.randn(1, 2, 6, 8, generator=g)
    calls["kernels.rwkv6_scan"] = [
        lambda: rwkv6.rwkv6_scan(r, r, r, -torch.rand(1, 2, 6, 8, generator=g), torch.randn(2, 8))]
    for name, fns in calls.items():
        for fn in fns:
            assert _ranges(fn) == {name: 1}, (name, fn)


def test_kernel_ranges_open_only_under_a_profiler(monkeypatch):
    """Outside a profiler a wrapper only tests for one: a range costs tens
    of microseconds of host time, a decode call's share of a step."""
    opened = []
    real = profile.named_scope
    monkeypatch.setattr(profile, "named_scope", lambda name: opened.append(name) or real(name))
    x, n = torch.randn(2, 8), torch.rand(2, 8)
    quantize.quantize_rows(x, n, torch.ones(2), 127.0)
    assert opened == []
    assert _ranges(lambda: quantize.quantize_rows(x, n, torch.ones(2), 127.0)) == {
        "kernels.quantize_int8": 1}
    assert opened == ["kernels.quantize_int8"]


def test_backward_kernels_open_one_range_a_launch(monkeypatch):
    """The hand-written backwards open ``kernels.<name>_bwd``, one range a
    call, which launches three kernels (flash, RWKV6) or one (the RG-LRU
    scan) on their ``launches_bwd`` counters: driven here through the
    stand-in libraries of tests/test_torch_stub_library.py (no build, no
    card), whose launch paths take CPU tensors."""
    stub_libraries(monkeypatch)
    for fn, names in ((flash.flash_attention, ("launches", "launches_tc", "launches_f32",
                                               "launches_bwd", "launches_bwd_tc",
                                               "launches_bwd_fma")),
                      (rglru.rglru_scan, ("launches", "launches_bwd")),
                      (rwkv6.rwkv6_scan, ("launches", "launches_chunked", "launches_decode",
                                          "launches_bwd"))):
        for name in names:
            monkeypatch.setattr(fn, name, 0)
    q, k = (torch.zeros(s, requires_grad=True) for s in ((1, 4, 8, 64), (1, 2, 8, 64)))
    a = torch.zeros((2, 5, 12), requires_grad=True)
    r, u = torch.zeros((2, 3, 9, 16), requires_grad=True), torch.zeros((3, 16))
    cases = [("kernels.flash_attention_bwd", flash.flash_attention, 3,
              lambda: flash._launch(q, k, k, True, 0, 0.125, 0.0)),
             ("kernels.rglru_scan_bwd", rglru.rglru_scan, 1,
              lambda: rglru._launch(a, a, None)[0]),
             ("kernels.rwkv6_scan_bwd", rwkv6.rwkv6_scan, 3,
              lambda: rwkv6._launch(r, r, r, r, u, 4, None)[0])]
    for name, wrapper, launches, forward in cases:
        out = forward()
        before = wrapper.launches_bwd
        assert _ranges(lambda: out.sum().backward()) == {name: 1}
        assert wrapper.launches_bwd == before + launches


# ------------------------------------------------ the FL round's stage ranges

HOST_KEYS = ("wall_s", "train_host_s", "aggregate_host_s")


def _cnn_rounds(strategy, profiled):
    """A reduced-width CNN RoundLoop (8 clients, 6 selected, chunks of 2,
    H = 2), traced, run for 2 rounds, under torch.profiler when
    ``profiled``: the loop, its History and the profiler's range counts."""
    from repro_torch import configs
    from repro_torch.data import femnist as fdata
    from repro_torch.models import femnist_cnn
    flc = FLConfig(n_onus=2, clients_per_onu=4, n_selected=6, local_steps=2, local_batch=4,
                   client_chunk=2)
    clients, eval_set = fdata.generate(fdata.FemnistConfig(n_clients=8, seed=1))
    backend = fl.ClientStackedBackend(
        flc, fl.make_strategy(strategy),
        femnist_cnn.init_params(configs.get("femnist_cnn").reduced(),
                                torch.Generator().manual_seed(0), "cpu"),
        clients, {k: torch.from_numpy(v) for k, v in eval_set.items()}, femnist_cnn.loss_fn)
    loop = fl.RoundLoop(fl.ExperimentConfig(fl=flc, seed=4, n_rounds=2), backend,
                        obs=Obs.enabled_tracing())
    if not profiled:
        return loop, loop.run(), {}
    with torch.profiler.profile() as p:
        hist = loop.run()
    return loop, hist, {e.key: e.count for e in p.key_averages()
                        if e.key.startswith(("fl.", "backend."))}


@pytest.mark.parametrize("strategy", ["sfl_two_step", "fedprox"])
def test_round_stages_open_their_ranges_under_a_profiler_alone(strategy, monkeypatch):
    """Under a profiler a round opens one ``fl.transport``, and where a
    client is involved one ``fl.minibatch``, ``fl.h2d`` and
    ``backend.aggregate_s``, and chunks × H of ``fl.grad``, ``fl.forward``
    and ``fl.sgd`` (``local_sgd`` under FedAvg, ``local_sgd_prox`` under
    FedProx): one a local step of a vmap'd chunk, not one a client.
    Without one no range opens, and the trained parameters (bit for bit),
    the History rows but their host times, the registry's names and the
    tracer's spans are the profiled run's."""
    opened = []
    real = profile.record_function
    monkeypatch.setattr(profile, "record_function",
                        lambda name, *a: opened.append(name) or real(name, *a))
    base, base_hist, _ = _cnn_rounds(strategy, profiled=False)
    assert opened == []
    loop, hist, counts = _cnn_rounds(strategy, profiled=True)
    fc = loop.backend.fl
    trained = [r for r in hist if r["involved"] > 0]
    steps = sum(-(-int(r["involved"]) // fc.client_chunk) for r in trained) * fc.local_steps
    assert steps > len(trained) * fc.local_steps       # a round of more than one chunk
    assert counts == {"fl.transport": len(hist), "fl.minibatch": len(trained),
                      "fl.h2d": len(trained), "backend.train_s": len(trained),
                      "backend.aggregate_s": len(trained), "backend.eval_s": len(trained),
                      "fl.grad": steps, "fl.forward": steps, "fl.sgd": steps}
    assert collections.Counter(n for n in opened if not n.startswith("kernels.")) == counts
    assert all(torch.equal(base.backend.params[k], loop.backend.params[k])
               for k in base.backend.params)
    strip = lambda rows: [{k: v for k, v in r.items() if k not in HOST_KEYS}  # noqa: E731
                          for r in rows]
    assert strip(base_hist) == strip(hist)
    assert base.metrics.names() == loop.metrics.names()
    spans = lambda lp: [(s.name, s.lane, s.cat) + ((s.t0_s, s.t1_s)  # noqa: E731
                                                   if s.lane[0] != "wall" else ())
                        for s in lp.obs.tracer.spans]
    assert spans(base) == spans(loop) and spans(base)


def test_the_stages_tool_reads_nested_ranges_from_a_trace():
    """``tools/fl_stages.py`` on a hand-built trace: ``fl.forward`` inside
    ``fl.grad`` inside ``backend.train_s``. A device operation counts to
    every range its launch sat in (by correlation id), on whichever thread
    it was launched (the backward's, here on thread 3, while ``fl.grad``
    waits), an idle gap to every range that holds it, and the breakdown
    gives each idle piece to the innermost range, else to the round
    loop."""
    spec = importlib.util.spec_from_file_location(
        "fl_stages", Path(__file__).resolve().parents[1] / "tools" / "fl_stages.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    X = lambda name, cat, ts, dur, **a: dict(ph="X", name=name, cat=cat, ts=ts, dur=dur,  # noqa: E731
                                             tid=a.pop("tid", 1), args=a)
    events = [X("window", "user_annotation", 0.0, 1000.0),
              X("backend.train_s", "user_annotation", 50.0, 550.0),
              X("fl.grad", "user_annotation", 100.0, 200.0),
              X("fl.forward", "user_annotation", 100.0, 80.0),
              X("kernels.agg_reduce", "user_annotation", 120.0, 10.0),
              X("fl.sgd", "user_annotation", 300.0, 50.0),
              X("fl.grad", "user_annotation", 400.0, 180.0),
              X("fl.forward", "user_annotation", 400.0, 50.0)]
    for corr, (launch, ts, dur) in enumerate(((110.0, 150.0, 50.0), (200.0, 250.0, 50.0),
                                              (320.0, 330.0, 30.0), (700.0, 720.0, 80.0))):
        events += [X("cudaLaunchKernel", "cuda_runtime", launch, 5.0, correlation=corr,
                     tid=3 if corr == 1 else 1),
                   X(f"k{corr}", "kernel", ts, dur, tid=7, correlation=corr)]
    st = tool.stages(events, "window")
    us = lambda d: {k: pytest.approx(v * 1e-6) for k, v in d.items()}  # noqa: E731
    assert st["window_s"] == pytest.approx(1e-3) and st["busy_s"] == pytest.approx(210e-6)
    assert st["calls"] == {"backend.train_s": 1, "fl.forward": 2, "fl.grad": 2, "fl.sgd": 1}
    assert st["host_s"] == us({"backend.train_s": 550, "fl.forward": 130, "fl.grad": 380,
                               "fl.sgd": 50})
    assert st["idle_s"] == us({"backend.train_s": 420, "fl.forward": 100, "fl.grad": 280,
                               "fl.sgd": 30})
    assert st["ops"] == {"backend.train_s": 3, "fl.forward": 1, "fl.grad": 2, "fl.sgd": 1}
    assert st["device_s"] == us({"backend.train_s": 130, "fl.forward": 50, "fl.grad": 100,
                                 "fl.sgd": 30})
    assert st["device_ops"] == 4 and st["top_ops"]["fl.grad"] == [
        ("k0", pytest.approx(50e-6)), ("k1", pytest.approx(50e-6))]
    assert st["idle_by_innermost"] == us({tool.LOOP: 370, "fl.grad": 180, "backend.train_s": 110,
                                          "fl.forward": 100, "fl.sgd": 30})
    assert list(st["idle_by_innermost"])[0] == tool.LOOP
    rnd = tool.per_round(st, [{"wall_s": 1.0, "train_host_s": 0.5}, {"wall_s": 2.0}])
    assert rnd["host_ms"]["fl.grad"] == pytest.approx(0.19) and rnd["ops"]["fl.grad"] == 1.0
    assert rnd["top_ops_ms"]["fl.sgd"] == [("k2", pytest.approx(0.015))]
    assert (rnd["rows_wall_s"], rnd["rows_train_host_s"], rnd["rows_aggregate_host_s"]) == (
        1.5, 0.25, 0.0)


def test_the_stages_tool_counts_kernel_ranges_apart():
    """``kernels.*`` ranges (one a wrapper call) are counted with the
    operations launched inside them, and change nothing of the stages:
    ``kernels.im2col`` twice inside one ``fl.forward``."""
    spec = importlib.util.spec_from_file_location(
        "fl_stages", Path(__file__).resolve().parents[1] / "tools" / "fl_stages.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    X = lambda name, cat, ts, dur, **a: dict(ph="X", name=name, cat=cat, ts=ts, dur=dur,  # noqa: E731
                                             tid=1, args=a)
    events = [X("window", "user_annotation", 0.0, 1000.0),
              X("fl.forward", "user_annotation", 100.0, 300.0)]
    for corr, (launch, ts, dur) in enumerate(((110.0, 200.0, 40.0), (150.0, 240.0, 10.0),
                                              (210.0, 250.0, 30.0))):
        events += [X("cudaLaunchKernel", "cuda_runtime", launch, 5.0, correlation=corr),
                   X(f"k{corr}", "kernel", ts, dur, correlation=corr)]
    bare = tool.stages(events, "window")
    events += [X("kernels.im2col", "user_annotation", 105.0, 10.0),
               X("kernels.im2col", "user_annotation", 205.0, 10.0)]
    st = tool.stages(events, "window")
    assert st["kernels"] == {"kernels.im2col": {"calls": 2, "ops": 2,
                                                "device_s": pytest.approx(70e-6)}}
    assert bare["kernels"] == {} and {k: v for k, v in st.items() if k != "kernels"} == {
        k: v for k, v in bare.items() if k != "kernels"}
    rnd = tool.per_round(st, [{"wall_s": 1.0}, {"wall_s": 1.0}])
    assert rnd["kernels"] == {"kernels.im2col": {"calls": 1.0, "ops": 1.0,
                                                 "device_ms": pytest.approx(0.035)}}


# ----------------------------------------------------------------- logging

def test_log_round_lines_equal_the_reference():
    recs = [{"round": 3, "loss": 1.23456, "involved": 7.0, "n_selected": 8,
             "upstream_mbits": 1690.6, "dt": 0.5, "t_s": 75.0}, {"round": "x", "acc": 0.5}]
    for rec in recs:
        lines = []
        for mod, name in ((obs_logging, "t.port"), (jlogging, "t.ref")):
            buf = io.StringIO()
            mod.log_round(mod.setup(stream=buf, name=name), rec)
            lines.append(buf.getvalue())
        assert lines[0] == lines[1] and lines[0].strip()
    buf = io.StringIO()
    lg = obs_logging.setup(json_mode=True, stream=buf, name="t.json")
    obs_logging.log_round(lg, recs[0])
    out = json.loads(buf.getvalue())
    assert out["msg"] == "round" and out["level"] == "info" and out["involved"] == 7.0
    lg.debug("hidden")
    assert buf.getvalue().count("\n") == 1
    assert obs_logging.setup(level="warning", name="t.json").level == logging.WARNING


# ------------------------------------------------------------ entry points

def _artifacts(tmp_path):
    names = ("trace.json", "metrics.jsonl", "report.json", "inc.jsonl")
    paths = [str(tmp_path / n) for n in names]
    argv = ["--trace-out", paths[0], "--metrics-out", paths[1], "--report-out", paths[2],
            "--health", "--incidents-out", paths[3]]
    return argv, paths


def _check_artifacts(paths, driver, n_rows):
    trace, metrics, report, incidents = paths
    assert json.load(open(trace))["traceEvents"]
    rows = {r["name"] for r in obs.read_jsonl(metrics)}
    assert "pon.upstream_mbits" in rows
    rep = obs.audit.RunReport.load(report)
    assert rep.driver == driver and len(rep.history) == n_rows and rep.config_hash
    assert rep.metrics and rep.trace["traceEvents"]
    assert open(incidents).read() == "".join(json.dumps(i) + "\n" for i in rep.incidents)
    return rep


def test_femnist_cli_writes_every_artifact(tmp_path, capsys):
    argv, paths = _artifacts(tmp_path)
    femnist.main(["--rounds", "2", "--n-selected", "6", "--onus", "4", "--clients-per-onu", "5",
                  "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "[obs] wrote run bundle" in out and "final accuracy" in out
    rep = _check_artifacts(paths, "round_loop", 2)
    assert rep.config["strategy"] == "sfl_two_step"
    assert {r["name"] for r in obs.read_jsonl(paths[1])} >= {"backend.train_s", "backend.eval_s"}


def test_femnist_async_cli_writes_every_artifact(tmp_path, capsys):
    argv, paths = _artifacts(tmp_path)
    femnist_async.main(["--rounds", "2", "--n-selected", "6", "--onus", "4",
                        "--clients-per-onu", "5", "--policy", "semi_sync", "--device", "cpu",
                        *argv])
    assert "[obs] wrote run bundle" in capsys.readouterr().out
    rep = _check_artifacts(paths, "orchestrator", 2)
    assert {"fl.staleness", "fl.involved"} <= {r["name"] for r in rep.metrics}


def test_train_cli_writes_every_artifact_and_logs_json(tmp_path, capsys):
    argv, paths = _artifacts(tmp_path)
    train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                "--log-every", "1", "--log-json", *argv])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["round"] for r in lines if r.get("msg") == "round"] == [0, 1]
    rep = _check_artifacts(paths, "round_loop", 2)
    (h,) = [r for r in rep.metrics if r["name"] == "backend.train_step_s"]
    assert h["count"] == 2
