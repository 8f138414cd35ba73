"""repro_torch.obs.audit against repro.obs.audit: the run bundles, the diff
engine, the HTML report and the health monitors.

Each parity case runs one config and seed through both packages' sessions
(``session(report_out=..., trace_out=..., metrics_out=..., health=True)``)
and holds the port's ``RunReport`` to the reference's: the config and its
hash, the metrics ``records()``, the incidents, the sim-clock spans, the
counter tracks and the instants exactly; the History exactly but for the
port's host-time keys (``wall_s``, ``*_host_s``); ``diff_bundles`` with
no hard diff both ways, with either package's engine. Only ``env`` is free.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import fl as jfl  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.core.fedavg import FLConfig as JFLConfig  # noqa: E402
from repro.data import femnist as jfemnist  # noqa: E402
from repro.models import femnist_cnn as jcnn  # noqa: E402
from repro.obs.audit import diff as jdiff  # noqa: E402
from repro.obs.audit import html as jhtml  # noqa: E402
from repro.obs.audit.bundle import RunReport as JRunReport  # noqa: E402
from repro.pon import PonConfig as JPonConfig  # noqa: E402
from repro_torch import fl, obs, runtime  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.fedavg import FLConfig  # noqa: E402
from repro_torch.launch import femnist as launch  # noqa: E402
from repro_torch.obs.audit import (  # noqa: E402
    BandwidthBudgetMonitor,
    ConvergenceStallMonitor,
    DeadlineMissMonitor,
    HealthEngine,
    Incident,
    RunReport,
    StragglerOnuMonitor,
    TrunkFlatnessMonitor,
    config_dict,
    config_hash,
    diff_bundles,
    render_diff_html,
    render_timeline_svg,
)
from repro_torch.obs.audit import diff as tdiff  # noqa: E402
from repro_torch.obs.audit.health import INCIDENT_SCHEMA, default_monitors  # noqa: E402
from repro_torch.obs.context import Obs  # noqa: E402
from repro_torch.obs.tracer import Span, Tracer  # noqa: E402
from repro_torch.pon import PonConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": (fl, runtime, obs, FLConfig, PonConfig),
        "ref": (jfl, jrt, jobs, JFLConfig, JPonConfig)}
LOADED = dict(dba="fl_priority", n_wavelengths=2, background_load=0.3)
HOST_KEYS = ("wall_s", "dispatch_host_s", "train_host_s", "aggregate_host_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ helpers

def _exp(pkg, mode="sfl", n_pons=1, seed=3, rounds=3, policy="sync", **pon_kw):
    F, _, _, FLC, PC = PKGS[pkg]
    pon = PC(n_onus=4, clients_per_onu=5, n_pons=n_pons, **pon_kw)
    flc = FLC(n_onus=4, clients_per_onu=5, n_pons=n_pons, n_selected=8 * n_pons, pon=pon)
    skw = F.filter_strategy_kwargs(mode, {"n_pons": n_pons})
    return F.ExperimentConfig(fl=flc, strategy=F.canonical_name(mode),
                              strategy_kwargs=tuple(sorted(skw.items())),
                              n_rounds=rounds, seed=seed, policy=policy)


def _backend(pkg, exp):
    F = PKGS[pkg][0]
    counts = np.random.default_rng(0).integers(50, 400, exp.fl.n_clients).astype(np.float32)
    onu = np.arange(exp.fl.n_clients) // exp.fl.clients_per_onu
    return F.TransportBackend(F.make_strategy(exp.strategy, **dict(exp.strategy_kwargs)),
                              counts, onu)


def _bundle(pkg, out, driver="round_loop", health=True, **kw):
    """One TransportBackend run through ``pkg``'s session, every artifact
    on; returns the bundle as that package loads it."""
    F, R, O = PKGS[pkg][:3]
    out.mkdir(parents=True, exist_ok=True)
    exp = _exp(pkg, **kw)
    sess = O.session(report_out=str(out / "report.json"), trace_out=str(out / "trace.json"),
                     metrics_out=str(out / "metrics.jsonl"), health=health, driver=driver)
    hist = None
    try:
        drv = (F.RoundLoop if driver == "round_loop" else R.Orchestrator)(exp, _backend(pkg, exp))
        hist = drv.run()
    finally:
        sess.finish(quiet=True, cfg=exp, history=hist)
    return O.audit.RunReport.load(str(out / "report.json"))


def _events(trace, ph):
    """A trace's events of phase ``ph`` with their lanes resolved to names."""
    procs, threads = {}, {}
    for e in trace.get("traceEvents", []):
        if e["ph"] == "M":
            if e["name"] == "process_name":
                procs[e["pid"]] = e["args"]["name"]
            else:
                threads[(e["pid"], e["tid"])] = e["args"]["name"]
    return [(e["name"], e["ts"], e.get("dur"), procs[e["pid"]], threads[(e["pid"], e["tid"])],
             json.dumps(e.get("args"), sort_keys=True))
            for e in trace.get("traceEvents", []) if e["ph"] == ph]


def _strip(rows):
    return [{k: v for k, v in r.items() if k not in HOST_KEYS} for r in rows]


def _assert_same_run(port, ref):
    assert (port.schema, port.driver, port.seed) == (ref.schema, ref.driver, ref.seed)
    assert port.config == ref.config and port.config_hash == ref.config_hash
    assert port.metrics == ref.metrics
    assert port.summary == ref.summary
    assert port.incidents == ref.incidents
    assert _strip(port.history) == ref.history
    assert all(set(r) - set(j) <= set(HOST_KEYS) for r, j in zip(port.history, ref.history))
    for ph in ("X", "C", "i"):
        assert _events(port.trace, ph) == _events(ref.trace, ph), ph
    assert jdiff._sim_spans(ref.trace) == tdiff._sim_spans(port.trace)
    assert len(tdiff._sim_spans(port.trace)) > 0
    # no hard diff both ways, with either engine on either bundle
    for engine, a, b in ((diff_bundles, port, ref), (diff_bundles, ref, port),
                         (jdiff.diff_bundles, ref, port), (jdiff.diff_bundles, port, ref)):
        d = engine(a, b)
        assert d.n_diffs == 0 and d.config_delta == [], [e.line() for e in d.entries]
        assert all(e.key.split(".")[-1] in HOST_KEYS for e in d.entries)


# -------------------------------------------------------- FLConfig parity

def _configs(pkg):
    F, _, _, FLC, PC = PKGS[pkg]
    return [
        F.ExperimentConfig(),
        F.ExperimentConfig(fl=FLC(pon=PC(**LOADED))),
        F.ExperimentConfig(fl=FLC(n_pons=2, pon=PC(n_pons=2)), strategy="hier_sfl",
                           strategy_kwargs=(("n_pons", 2),)),
        F.ExperimentConfig().with_strategy("fedopt", server_opt="yogi", server_lr=0.01),
    ]


@pytest.mark.parametrize("i", range(4), ids=["default", "fl_priority", "hier_sfl", "fedopt"])
def test_config_dict_and_hash_equal_the_reference(i):
    """FLConfig carries the reference's ``mode`` and ``seed`` in its field
    order, so a config resolves to the reference's dict and hash."""
    port, ref = _configs("port")[i], _configs("ref")[i]
    assert config_dict(port) == jobs.audit.config_dict(ref)
    assert list(config_dict(port)["fl"]) == list(jobs.audit.config_dict(ref)["fl"])
    assert config_hash(config_dict(port)) == jobs.audit.config_hash(jobs.audit.config_dict(ref))


# --------------------------------------------------------- bundle parity

LOOP_CASES = {"sfl": {}, "classical": dict(mode="classical"),
              "hier_sfl": dict(mode="hier_sfl", n_pons=2),
              "fl_priority": dict(mode="sfl", **LOADED),
              "fast": dict(mode="sfl", sim_engine="fast", **LOADED)}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_round_loop_bundle_equals_the_reference(case, tmp_path):
    kw = LOOP_CASES[case]
    port = _bundle("port", tmp_path / "port", **kw)
    ref = _bundle("ref", tmp_path / "ref", **kw)
    _assert_same_run(port, ref)
    # every artifact of the session: the trace, the merged metrics, the report
    for side in ("port", "ref"):
        doc = json.loads((tmp_path / side / "trace.json").read_text())
        assert doc["traceEvents"] and doc["displayTimeUnit"] == "ms"
    assert (jobs.read_jsonl(str(tmp_path / "port" / "metrics.jsonl"))
            == obs.read_jsonl(str(tmp_path / "ref" / "metrics.jsonl")))


@pytest.mark.parametrize("policy", ["sync", "semi_sync", "fedbuff"])
def test_orchestrator_bundle_equals_the_reference(policy, tmp_path):
    kw = dict(policy=policy, rounds=4, **LOADED)
    port = _bundle("port", tmp_path / "port", driver="orchestrator", **kw)
    ref = _bundle("ref", tmp_path / "ref", driver="orchestrator", **kw)
    _assert_same_run(port, ref)
    if policy != "sync":
        names = {e[0] for e in _events(port.trace, "X")}
        assert {"train+wireless", "θ-gather"} <= names
        assert any(e[0] == "server-update" for e in _events(port.trace, "i"))


def test_client_stacked_bundle_matches_the_reference(tmp_path):
    """The reduced-width CNN (2 local steps, 3 rounds) from the reference's
    init through both packages' sessions: everything equal but the host
    times; the History at rtol 1e-4; the ``backend.*_s`` histograms held by
    count (their timing fields are host seconds, which the diff engines
    treat as hard diffs: a property of the reference's names)."""
    cfg = jconfigs.get("femnist_cnn").reduced()
    pon = dict(n_onus=4, clients_per_onu=5)
    flc = JFLConfig(n_selected=8, local_steps=2, local_lr=0.06, pon=JPonConfig(**pon), **pon)
    data = jfemnist.generate(jfemnist.FemnistConfig(n_clients=flc.n_clients, seed=7))
    init, _ = jcnn.init_params(cfg, jax.random.PRNGKey(0))
    jsess = jobs.session(report_out=str(tmp_path / "ref.json"), health=True, driver="round_loop")
    try:
        backend = jfl.ClientStackedBackend(
            flc, jfl.make_strategy("sfl_two_step"), init, data[0],
            jax.tree.map(jnp.asarray, data[1]), jcnn.loss_fn,
            sample_counts=jfemnist.sample_counts(data[0]))
        jexp = jfl.ExperimentConfig(fl=flc, strategy="sfl_two_step", n_rounds=3, seed=0)
        jloop = jfl.RoundLoop(jexp, backend)
        jloop.run()
    finally:
        jsess.finish(quiet=True, cfg=jexp, history=jloop.history)
    sess = obs.session(report_out=str(tmp_path / "port.json"), health=True, driver="round_loop")
    try:
        loop = launch.run(n_rounds=3, n_selected=8, seed=0, modes=("sfl_two_step",),
                          pon=PonConfig(**pon), params=params_from_jax(init), device="cpu",
                          local_steps=2, data=data)["sfl_two_step"]["loop"]
    finally:
        sess.finish(quiet=True, cfg=loop.cfg, history=loop.history)
    port, ref = RunReport.load(str(tmp_path / "port.json")), JRunReport.load(str(tmp_path / "ref.json"))
    assert port.config_hash == ref.config_hash and port.config == ref.config
    assert port.incidents == ref.incidents
    assert tdiff._sim_spans(port.trace) == jdiff._sim_spans(ref.trace)
    timing = {("histogram", f"backend.{n}_s") for n in ("train", "eval")}
    counts = {(r["kind"], r["name"]): r["count"] for r in port.metrics if (r["kind"], r["name"]) in timing}
    assert counts == {(r["kind"], r["name"]): r["count"] for r in ref.metrics
                      if (r["kind"], r["name"]) in timing} == dict.fromkeys(timing, 3)
    assert ([r for r in port.metrics if (r["kind"], r["name"]) not in timing]
            == [r for r in ref.metrics if (r["kind"], r["name"]) not in timing])
    for engine, a, b in ((diff_bundles, port, ref), (jdiff.diff_bundles, ref, port)):
        hard = [e for e in engine(a, b, rtol=1e-4).entries if e.status != "warn"]
        assert all(e.section == "metrics" and e.key.startswith("histogram:backend.")
                   and not e.key.endswith((".count", ".n")) for e in hard), [e.line() for e in hard]
    assert all(set(r) - set(j) == {"wall_s", "train_host_s", "aggregate_host_s"}
               for r, j in zip(port.history, ref.history))
    got = params_to_jax(loop.backend.params)
    for k, want in jloop.backend.params.items():
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=0, atol=1e-4, err_msg=k)


def test_diff_html_is_byte_equal_across_the_packages(tmp_path):
    """The same pair of bundles (seeds 3 and 4, one from each package)
    renders to one HTML string in either package."""
    _bundle("port", tmp_path / "a", seed=3)
    _bundle("ref", tmp_path / "b", seed=4)
    a, b = (str(tmp_path / s / "report.json") for s in ("a", "b"))
    html = render_diff_html(diff_bundles(RunReport.load(a), RunReport.load(b)),
                            RunReport.load(a), RunReport.load(b))
    jhtml_out = jhtml.render_diff_html(jdiff.diff_bundles(JRunReport.load(a), JRunReport.load(b)),
                                       JRunReport.load(a), JRunReport.load(b))
    assert html == jhtml_out
    assert "first diverging round" in html and "<svg" in html


# ------------------------------------------------------ the port alone

def test_bundle_roundtrip_and_config_hash(tmp_path):
    rep = _bundle("port", tmp_path / "a", health=False)
    assert rep.schema == "repro.obs.audit/v1" and rep.driver == "round_loop"
    assert rep.seed == 3 and len(rep.history) == 3
    assert rep.metrics and rep.summary and rep.trace["traceEvents"]
    assert rep.env["python"] and rep.env["torch"] == torch.__version__ and "jax" not in rep.env
    d = config_dict(_exp("port"))
    assert rep.config_hash == config_hash(d) != config_hash(config_dict(_exp("port", seed=4)))
    assert rep.config["fl"]["pon"]["n_onus"] == 4
    json.dumps(rep.to_dict())
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": "something/else"}))
    with pytest.raises(ValueError):
        RunReport.load(str(p))


def test_differing_seeds_localize_first_diverging_round(tmp_path):
    a = _bundle("port", tmp_path / "a", seed=3)
    b = _bundle("port", tmp_path / "b", seed=4)
    d = diff_bundles(a, b)
    assert d.n_diffs > 0 and d.exit_code == 1
    assert [e.key for e in d.config_delta] == ["seed"]
    assert d.first_divergence["round"] == 0 and d.first_divergence["span"]


def test_diff_flags_missing_metrics_and_row_counts(tmp_path):
    a = _bundle("port", tmp_path / "a")
    b = _bundle("port", tmp_path / "b")
    assert diff_bundles(a, b).n_diffs == 0          # wall_s differs: a warning
    b.metrics = [m for m in b.metrics if m["name"] != "pon.upstream_mbits"]
    b.history = b.history[:-1]
    d = diff_bundles(a, b)
    assert "missing_b" in {e.status for e in d.entries}
    assert any(e.key == "n_rounds" for e in d.entries)
    w = diff_bundles(RunReport(metrics=[{"kind": "histogram", "name": "wall.train_s", "mean": 1.0}]),
                     RunReport(metrics=[{"kind": "histogram", "name": "wall.train_s", "mean": 5.0}]))
    assert w.n_diffs == 0 and w.n_warns == 1


def test_python_dash_m_repro_torch_obs_diff_exit_codes(tmp_path):
    """``python -m repro_torch.obs.diff A B [--html R]``: 0 for the same
    config and seed (one bundle from each package), 1 with the HTML's
    first diverging round for another seed; ``main`` returns the same."""
    _bundle("port", tmp_path / "a", seed=3)
    _bundle("ref", tmp_path / "b", seed=3)
    _bundle("port", tmp_path / "c", seed=4)
    a, b, c = (str(tmp_path / s / "report.json") for s in "abc")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = lambda *argv: subprocess.run([sys.executable, "-m", "repro_torch.obs.diff", *argv],  # noqa: E731
                                       capture_output=True, text=True, env=env, cwd=REPO)
    same = run(a, b)
    assert same.returncode == 0 and "0 diffs" in same.stdout, same.stdout + same.stderr
    html = str(tmp_path / "d.html")
    other = run(a, c, "--html", html)
    assert other.returncode == 1, other.stderr
    assert "first diverging round" in open(html).read()
    assert tdiff.main([a, b]) == 0 and tdiff.main([a, c]) == 1


def test_timeline_svg_renders_sim_lanes(tmp_path):
    svg = render_timeline_svg(_bundle("port", tmp_path / "a").trace)
    assert svg.startswith("<svg") and "onu" in svg and "wall" not in svg


# ------------------------------------------------------- health monitors

def test_convergence_stall_fires_once_per_streak():
    m = ConvergenceStallMonitor(window=3, min_delta=1e-3)
    incs = []
    for i, acc in enumerate([0.1, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]):
        incs += m.on_round({"round": i, "acc": acc})
    assert len(incs) == 1 and incs[0].kind == "convergence_stall" and incs[0].round == 4
    assert m.on_round({"round": 7, "acc": 0.9}) == []
    for i in range(8, 11):
        incs2 = m.on_round({"round": i, "acc": 0.9})
    assert len(incs2) == 1


def test_deadline_miss_slo():
    m = DeadlineMissMonitor(max_miss_rate=0.5)
    assert m.on_round({"round": 0, "n_selected": 10, "involved": 6.0}) == []
    incs = m.on_round({"round": 1, "n_selected": 10, "involved": 2.0})
    assert len(incs) == 1 and incs[0].kind == "deadline_slo" and incs[0].severity == "error"
    assert incs[0].data["miss_rate"] == pytest.approx(0.8)


def test_bandwidth_budget_against_the_oracle():
    from repro_torch.pon.metro import expected_segment_mbits
    exp = _exp("port")
    m = BandwidthBudgetMonitor(tol_rel=0.01)
    m.bind(exp)
    pon = exp.fl.pon_config()
    budget = expected_segment_mbits("sfl", pon.model_mbits, exp.fl.n_selected,
                                    n_active_onus=min(exp.fl.n_selected, pon.total_onus),
                                    n_active_pons=pon.n_pons)["pon"]
    assert m.on_round({"round": 0, "upstream_mbits": budget}) == []
    incs = m.on_round({"round": 1, "upstream_mbits": budget * 1.5})
    assert len(incs) == 1 and incs[0].data["segment"] == "pon"
    # a compressed row scales the budget by its wire size
    assert m.on_round({"round": 2, "upstream_mbits": budget * 0.3,
                       "wire_mbits": pon.model_mbits * 0.25}) != []


def test_trunk_flatness_hier_only():
    hier = _exp("port", mode="hier_sfl", n_pons=2)
    model = hier.fl.pon_config().model_mbits
    m = TrunkFlatnessMonitor()
    m.bind(hier)
    assert m.on_round({"round": 0, "trunk_mbits": model}) == []
    assert m.on_round({"round": 1, "trunk_mbits": 2.0 * model})[0].kind == "trunk_flatness"
    m2 = TrunkFlatnessMonitor()
    m2.bind(_exp("port"))
    assert m2.on_round({"round": 0, "trunk_mbits": 10.0 * model}) == []


def test_straggler_onu_from_grant_spans():
    m = StragglerOnuMonitor(k_sigma=2.0, min_delay_s=0.5, min_grants=3)
    m.on_spans([Span("grant", g, g + 0.5, ("pon", f"onu{onu}"), cat="grant",
                     args={"queue_s": 5.0 if onu == 8 else 0.1})
                for onu in range(9) for g in range(5)])
    incs = m.finish()
    assert len(incs) == 1 and incs[0].data["lane"] == ["pon", "onu8"]


def test_health_engine_surfaces_incidents_in_history_and_jsonl(tmp_path):
    exp = _exp("port")
    engine = HealthEngine([DeadlineMissMonitor(max_miss_rate=-1.0)])
    hist = fl.RoundLoop(exp, _backend("port", exp), obs=Obs(tracer=Tracer(), health=engine)).run()
    assert all(r.get("incidents") == 1 for r in hist) and len(engine.incidents) == len(hist)
    rows = [json.loads(line) for line in open(engine.write_jsonl(str(tmp_path / "inc.jsonl")))]
    assert len(rows) == len(hist)
    assert all(r["schema"] == INCIDENT_SCHEMA == "repro.obs.incident/v1" for r in rows)


@pytest.mark.parametrize("driver", ["round_loop", "orchestrator"])
def test_health_observation_does_not_perturb_history(driver):
    """A health engine observes: rows equal a health-free run's but for
    the host times and the ``incidents`` count, which a row carries only
    when a monitor fired (a healthy lockstep run has none; semi_sync
    windows carry several θs an ONU, past the lockstep budget oracle)."""
    exp = _exp("port", policy="semi_sync", rounds=4, **LOADED)
    make = fl.RoundLoop if driver == "round_loop" else runtime.Orchestrator
    base = make(exp, _backend("port", exp)).run()
    engine = HealthEngine(default_monitors(max_miss_rate=1.0))
    watched = make(exp, _backend("port", exp), obs=Obs(health=engine)).run()
    assert _strip(base) == [{k: v for k, v in r.items() if k != "incidents"}
                            for r in _strip(watched)]
    assert sum(r.get("incidents", 0) for r in watched) == len(engine.incidents)
    if driver == "round_loop":
        assert engine.incidents == [] and all("incidents" not in r for r in watched)


def test_health_cli_flags_build_engine(tmp_path):
    import argparse
    ap = argparse.ArgumentParser()
    obs.add_obs_cli_args(ap)
    inc = tmp_path / "inc.jsonl"
    args = ap.parse_args(["--health", "--incidents-out", str(inc),
                          "--slo-deadline-miss-rate", "0.25"])
    sess = obs.session_from_args(args)
    try:
        slos = [m for m in sess.obs.health.monitors if isinstance(m, DeadlineMissMonitor)]
        assert slos and slos[0].max_miss_rate == 0.25
        exp = _exp("port")
        loop = fl.RoundLoop(exp, _backend("port", exp))
        assert loop.obs.health is sess.obs.health
        loop.run()
    finally:
        sess.finish(quiet=True)
    assert inc.exists()


def test_incident_records_are_json_complete():
    d = Incident(kind="k", severity="warn", message="m", round=2, t_s=1.5, data={"x": 1}).to_dict()
    assert d["schema"] == INCIDENT_SCHEMA and json.loads(json.dumps(d)) == d
