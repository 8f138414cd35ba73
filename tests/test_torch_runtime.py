"""The event-driven runtime on the port — ``repro_torch.runtime`` (SimClock,
the Orchestrator with its sync, semi_sync and fedbuff policies, the fluid
grant machine, the backends' async seam) — against ``repro.runtime`` on the
same seeds at reduced size (4 ONUs × 5 clients a PON, N ≤ 8, H ≤ 2):
transport rows key for key, the run's Mbits totals and the generator state
exact; on ``ClientStackedBackend`` the parameters after every server update
and the eval within 1e-4 of the reference's, from its init bridged across.
Also the sync policy against the port's RoundLoop, the failure semantics,
the registry, the shared CLI and the ``launch.femnist_async`` entry point.

On the CPU every kernel wrapper runs its plain version; the kernels at the
runtime's shapes are held against those on the card (chip_smoke.py phase
17)."""
import argparse
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import fl as jfl  # noqa: E402
from repro import pon as jpon  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.core import fedavg as jfedavg  # noqa: E402
from repro.data import femnist as jfemnist  # noqa: E402
from repro.models import femnist_cnn as jcnn  # noqa: E402
from repro.pon import events as jevents  # noqa: E402
from repro.pon import fast as jfast  # noqa: E402
from repro.pon import topology as jtopology  # noqa: E402
from repro_torch import fl, runtime  # noqa: E402
from repro_torch import pon as tpon  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import compression as tc  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.kernels import segment_agg_reduce  # noqa: E402
from repro_torch.launch import femnist_async  # noqa: E402
from repro_torch.pon import events as tevents  # noqa: E402
from repro_torch.pon import fast as tfast  # noqa: E402
from repro_torch.pon import topology as ttopology  # noqa: E402
from repro_torch.runtime import clock as tclock  # noqa: E402
from repro_torch.runtime import failures as tfailures  # noqa: E402
from test_torch_compression import _jax_noise  # noqa: E402

# host-time keys of the port's rows; the reference's rows have none
HOST_KEYS = ("wall_s", "dispatch_host_s", "train_host_s", "aggregate_host_s")
LOADED = dict(dba="fl_priority", n_wavelengths=2, background_load=0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strip(rec, keys=HOST_KEYS):
    return {k: v for k, v in rec.items() if k not in keys}


def _running_sum(values):
    """Left to right, as the runtime's counter adds (``sum`` compensates)."""
    total = 0.0
    for v in values:
        total += v
    return total


# ------------------------------------------------------------------ SimClock

def _drive_clock(clock_mod, seed):
    """A schedule drawn from ``seed``: ties, cancels, callbacks that schedule
    into the past and the future, run_until and run with a budget; returns
    what fired, in order, with the clock's times."""
    rng = np.random.default_rng(seed)
    clock = clock_mod.SimClock()
    log, handles = [], []

    def fire(tag):
        log.append((tag, clock.now))
        if tag >= 1000:
            return
        if tag % 3 == 0:                     # a follow-up in the past: clamped
            clock.schedule(clock.now - 1.0, fire, tag + 1000)
        if tag % 5 == 0:
            handles.append(clock.after(float(rng.integers(0, 3)), fire, tag + 2000))

    for i in range(40):
        handles.append(clock.schedule(float(rng.integers(0, 10)), fire, i))
    for i in rng.choice(len(handles), 8, replace=False):
        handles[i].cancel()
    clock.run_until(4.0)
    log.append(("until", clock.now, clock.peek()))
    for h in handles[-5:]:
        h.cancel()
    end = clock.run(until_s=7.5)
    log.append(("run", end, clock.events_fired, clock.empty()))
    clock.run()
    log.append(("drained", clock.now, clock.events_fired, clock.empty()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clock_fires_as_the_reference(seed):
    """The same schedule through both clocks: the same callbacks at the same
    times, in (time, schedule order), past times clamped to now, cancelled
    events skipped lazily."""
    from repro.runtime import clock as jclock
    got, want = _drive_clock(tclock, seed), _drive_clock(jclock, seed)
    assert got == want
    assert any(isinstance(t, int) and t >= 1000 for t, *_ in got)


def test_clock_order_cancel_and_past_clamp():
    clock, fired = tclock.SimClock(), []
    for name, t in (("b", 2.0), ("a", 1.0), ("c", 2.0)):
        clock.schedule(t, fired.append, name)
    ev = clock.schedule(1.5, fired.append, "x")
    ev.cancel()
    clock.run_until(1.0)
    clock.schedule(0.0, fired.append, "late")     # the past: fires at now
    clock.run()
    assert fired == ["a", "late", "b", "c"] and clock.now == 2.0
    assert clock.events_fired == 4 and clock.empty() and clock.peek() is None


# ------------------------------------------------------- the fluid machine

ENGINE_CASES = [(e, d) for e in ("event", "fast", "hybrid") for d in ("fifo", "ipact",
                                                                     "fl_priority")]


@pytest.mark.parametrize("engine,dba", ENGINE_CASES, ids=[f"{e}-{d}" for e, d in ENGINE_CASES])
def test_orchestrator_engine_matches_reference(engine, dba):
    """The engine the Orchestrator bridges, over transports, loads about the
    fluid threshold and strict queueing: the reference's choice each time."""
    for transport in ("sfl", "classical", "hier"):
        for load in (0.0, 0.3, 0.9):
            for queueing in (False, True):
                kw = dict(sim_engine=engine, dba=dba, background_load=load,
                          sfl_queueing=queueing, fluid_threshold=0.8)
                want = jfast.orchestrator_engine(jpon.PonConfig(**kw), transport)
                assert tfast.orchestrator_engine(tpon.PonConfig(**kw), transport) == want
    with pytest.raises(ValueError, match="unknown sim_engine"):
        tfast.orchestrator_engine(tpon.PonConfig(sim_engine="bogus"), "sfl")


def _fluid_run(events_mod, fast_mod, topo, seed):
    rng = np.random.default_rng(seed)
    done = []
    sim = fast_mod.FluidUpstreamSim(topo, None, on_done=lambda j: done.append(j.seq))
    jobs = []
    t = 0.0
    for i in range(30):
        t += float(rng.exponential(0.5))
        j = events_mod.UpstreamJob(seq=i, onu=int(rng.integers(0, topo.n_onus)),
                                   size_mbits=float(rng.uniform(1, 300)), ready_s=t,
                                   kind="theta")
        sim.submit(j)
        jobs.append(j)
        if i % 7 == 6:
            sim.advance_to(t)
    first = sim.next_event_s()
    sim.drain()
    return ([(j.start_s, j.done_s, j.wavelength, j.grant_idx) for j in jobs], done,
            first, sim.now, sim.next_event_s())


@pytest.mark.parametrize("kind", ["uniform-1", "uniform-2", "skewed"])
def test_fluid_upstream_sim_matches_reference(kind):
    """Every job's start, done, wavelength and grant index, the completion
    order and the sim's clock, against the reference's FluidUpstreamSim; on
    the skewed tree an ONU reaches no wavelength and its jobs stay at inf."""
    def topo(mod):
        if kind == "skewed":        # a capped drop link, one wavelength, none
            onus = (mod.Onu(0, 3), mod.Onu(1, 9, link_mbps=40.0),
                    mod.Onu(2, 1, wavelengths=()), mod.Onu(3, 5, wavelengths=(1,)))
            return mod.Topology(onus, (mod.Wavelength(0, 100.0), mod.Wavelength(1, 50.0)))
        return mod.Topology.uniform(n_onus=4, clients_per_onu=5,
                                    n_wavelengths=int(kind[-1]))
    got = _fluid_run(tevents, tfast, topo(ttopology), 3)
    want = _fluid_run(jevents, jfast, topo(jtopology), 3)
    assert got == want
    if kind == "skewed":
        assert any(s == float("inf") for s, *_ in got[0])


# ------------------------------------------- transport-only orchestrations

def _pair(pk, flk, exp_kw, mode, skw=None, counts_seed=0):
    """The same experiment in both packages on TransportBackends."""
    skw = skw or {}
    n = flk["n_onus"] * flk["clients_per_onu"] * flk.get("n_pons", 1)
    counts = np.random.default_rng(counts_seed).integers(50, 400, n).astype(np.float32)
    onu = np.arange(n) // flk["clients_per_onu"]
    exp = fl.ExperimentConfig(fl=fedavg.FLConfig(pon=tpon.PonConfig(**pk), **flk),
                              strategy=mode, **exp_kw)
    jexp = jfl.ExperimentConfig(fl=jfedavg.FLConfig(pon=jpon.PonConfig(**pk), **flk),
                                strategy=mode, **exp_kw)
    return ((exp, lambda: fl.TransportBackend(fl.make_strategy(mode, **skw), counts, onu)),
            (jexp, lambda: jfl.TransportBackend(jfl.make_strategy(mode, **skw), counts, onu)))


def _same_runs(port, ref):
    """Rows key for key (the port's less its host-time keys), run totals and
    the generator state after the run."""
    (o, h), (jo, jh) = port, ref
    assert len(h) == len(jh)
    for r, j in zip(h, jh):
        assert _strip(r) == j, (r, j)
        assert all(type(r[k]) is type(j[k]) for k in j), j
    assert o.total_upstream_mbits == jo.total_upstream_mbits
    assert o.total_metro_mbits == jo.total_metro_mbits
    assert o.rng.integers(0, 1 << 30) == jo.rng.integers(0, 1 << 30)


def _run(pair, policy=None, n=None, until_s=None, start_round=0):
    out = []
    for (exp, mk), mod in zip(pair, (runtime, jrt)):
        o = mod.Orchestrator(exp, mk(), policy=policy)
        out.append((o, o.run(n, until_s=until_s, start_round=start_round)))
    return out


SYNC_CASES = [("sfl_two_step", 1), ("classical", 1), ("hier_sfl", 2)]


@pytest.mark.parametrize("mode,n_pons", SYNC_CASES, ids=[c[0] for c in SYNC_CASES])
def test_sync_policy_equals_roundloop_and_reference(mode, n_pons):
    """Orchestrator(policy="sync") with backups and failures: its rows are the
    reference Orchestrator's, and the port's RoundLoop's plus t_s = (i + 1)
    windows, policy and version; a resume at round 3 replays as the
    RoundLoop does; a 70 s budget holds two 25 s rounds."""
    flk = dict(n_onus=4, clients_per_onu=5, n_pons=n_pons, n_selected=8)
    exp_kw = dict(overselect=0.4, p_crash=0.1, p_transient=0.1, n_rounds=6)
    pair = _pair(dict(n_pons=n_pons, **LOADED), flk, exp_kw, mode,
                 {"n_pons": n_pons} if mode == "hier_sfl" else None)
    runs = _run(pair, policy="sync")
    _same_runs(*runs)
    (exp, mk), _ = pair
    loop = fl.RoundLoop(exp, mk())
    want = loop.run(6)
    got = runs[0][1]
    assert [_strip(r, HOST_KEYS + ("t_s", "policy", "version")) for r in got] == [
        _strip(r) for r in want]
    assert got.column("t_s") == [(i + 1) * 25.0 for i in range(6)]
    assert runs[0][0].total_upstream_mbits == _running_sum(want.column("upstream_mbits"))
    resumed = _run(pair, policy="sync", n=3, start_round=3)
    _same_runs(*resumed)
    # a resumed run counts its server versions afresh, as the reference's
    assert [_strip(r, HOST_KEYS + ("version",)) for r in resumed[0][1]] == [
        _strip(r, HOST_KEYS + ("version",)) for r in got.records[3:]]
    budget = _run(pair, policy="sync", n=10, until_s=70.0)
    _same_runs(*budget)
    assert len(budget[0][1]) == 2


ASYNC_SCENARIOS = {
    # (pon kwargs, FLConfig kwargs, experiment kwargs, strategy, strategy kwargs)
    "fl_priority_bg": (LOADED, dict(n_onus=4, clients_per_onu=5, n_selected=8), {},
                       "sfl_two_step", None),
    "classical_metro": (dict(n_pons=2, **LOADED),
                        dict(n_onus=4, clients_per_onu=5, n_pons=2, n_selected=8), {},
                        "classical", None),
    "hier_forest": (dict(n_pons=2, **LOADED),
                    dict(n_onus=4, clients_per_onu=5, n_pons=2, n_selected=8),
                    dict(onu_gather_s=2.0), "hier_sfl", {"n_pons": 2}),
    "sfl_metro": (dict(n_pons=2, dba="tdma"),
                  dict(n_onus=4, clients_per_onu=5, n_pons=2, n_selected=6), {},
                  "sfl_two_step", None),
    "failures": (dict(dba="ipact", background_load=0.2),
                 dict(n_onus=4, clients_per_onu=5, n_selected=8),
                 dict(overselect=0.3, p_crash=0.1, p_transient=0.2), "classical", None),
    "fluid": (dict(sim_engine="fast", **LOADED), dict(n_onus=4, clients_per_onu=5,
                                                      n_selected=8), {},
              "sfl_two_step", None),
}
ASYNC_CASES = [(p, s) for p in ("semi_sync", "fedbuff") for s in ASYNC_SCENARIOS]


@pytest.mark.parametrize("policy,scenario", ASYNC_CASES,
                         ids=[f"{p}-{s}" for p, s in ASYNC_CASES])
def test_async_transport_rows_equal_reference(policy, scenario):
    """semi_sync (6 windows) and fedbuff (buffer 3, 6 in flight, to 6 updates
    or 400 s) on TransportBackends: every row key for key (staleness,
    in-flight counts, a forest's metro Mbits), the totals and the
    generator state equal the reference's."""
    pk, flk, exp_kw, mode, skw = ASYNC_SCENARIOS[scenario]
    exp_kw = dict(exp_kw, policy=policy, buffer_k=3, concurrency=6, n_rounds=6)
    pair = _pair(pk, flk, exp_kw, mode, skw)
    runs = _run(pair, until_s=400.0)
    _same_runs(*runs)
    o, h = runs[0]
    assert len(h) > 0 and all(r["policy"] == policy for r in h)
    if scenario == "fluid":
        assert tfast.orchestrator_engine(o.pon_cfg, "sfl") == "fluid"
        assert isinstance(o._pons[0].sim, tfast.FluidUpstreamSim)
    if policy == "semi_sync":
        assert h.column("t_s") == [(i + 1) * 25.0 for i in range(6)]
        assert any(r["staleness_max"] >= 1.0 for r in h)
    else:
        assert all(a < b for a, b in zip(h.column("t_s"), h.column("t_s")[1:]))
        # the total also counts the bits served after the last update (its
        # adds are grouped otherwise than the rows' sum: a rounding apart)
        assert o.total_upstream_mbits >= _running_sum(h.column("upstream_mbits")) * (
            1 - 1e-12) > 0.0
    if "metro_mbits" in h.records[0]:
        assert o.total_metro_mbits > 0.0


def test_crash_transient_and_idle_tick_guard_match_reference():
    """Everyone crashed: fedbuff never dispatches, and without a budget the
    idle-tick guard ends the run (no rows, nothing billed); everyone
    transient: semi_sync bills the uploads but folds nothing in."""
    flk = dict(n_onus=4, clients_per_onu=5, n_selected=8)
    for until_s in (200.0, None):
        pair = _pair({}, flk, dict(policy="fedbuff", buffer_k=2, concurrency=4,
                                   p_crash=1.0), "sfl_two_step")
        runs = _run(pair, n=5, until_s=until_s)
        _same_runs(*runs)
        assert len(runs[0][1]) == 0 and runs[0][0].total_upstream_mbits == 0.0
    pair = _pair({}, flk, dict(policy="semi_sync", p_transient=1.0), "classical")
    runs = _run(pair, n=3)
    _same_runs(*runs)
    h = runs[0][1]
    assert all(r["involved"] == 0.0 and r["upstream_mbits"] > 0.0 for r in h)
    assert h.column("version") == [0, 0, 0]


def test_async_policy_rejects_a_sync_only_backend():
    """An async policy needs client_update/apply_updates: the port's
    GradientBackend has neither, and the reference's TypeError is raised;
    the sync policy takes it; semi_sync and fedbuff refuse a resume."""
    exp = fl.ExperimentConfig(fl=fedavg.FLConfig(n_onus=4, clients_per_onu=5),
                              policy="fedbuff")

    class SyncOnly:
        strategy = fl.make_strategy("sfl")
        sample_counts = np.ones(20, np.float32)
        onu_ids = np.zeros(20, np.int64)

        def run_round(self, *a):
            return {}

    assert not hasattr(fl.GradientBackend, "client_update")
    for policy in ("fedbuff", "semi_sync", "async"):
        with pytest.raises(TypeError, match="client_update"):
            runtime.Orchestrator(exp, SyncOnly(), policy=policy)
    runtime.Orchestrator(exp, SyncOnly(), policy="sync")
    small = dataclasses.replace(exp, fl=dataclasses.replace(exp.fl, n_onus=5))
    with pytest.raises(ValueError, match="size the backend"):
        runtime.Orchestrator(small, SyncOnly(), policy="sync")
    backend = fl.TransportBackend(fl.make_strategy("sfl"), np.ones(20, np.float32),
                                  np.arange(20) // 5)
    for policy in ("fedbuff", "semi_sync"):
        with pytest.raises(ValueError, match="start_round"):
            runtime.Orchestrator(exp, backend, policy=policy).run(2, start_round=1)


# ------------------------------------------------ the client-stacked backend

def _cnn_experiment(mode, policy, skw, n_pons, compress, local_steps=2):
    skw = dict(skw, **({"compress": compress} if compress != "none" else {}))
    flk = dict(n_onus=4, clients_per_onu=5, n_pons=n_pons, n_selected=8,
               local_steps=local_steps, local_lr=0.06)
    pk = dict(n_pons=n_pons, **LOADED)
    exp_kw = dict(strategy=mode, strategy_kwargs=tuple(sorted(skw.items())), policy=policy,
                  buffer_k=3, concurrency=6, seed=0)
    return (fl.ExperimentConfig(fl=fedavg.FLConfig(pon=tpon.PonConfig(**pk), **flk), **exp_kw),
            jfl.ExperimentConfig(fl=jfedavg.FLConfig(pon=jpon.PonConfig(**pk), **flk),
                                 **exp_kw))


def _jax_async(jexp, eval_every, n_updates):
    """examples/train_femnist_async.py's backend for ``jexp`` (reduced CNN,
    PRNGKey(0)); the params after every server update."""
    cfg = jconfigs.get("femnist_cnn").reduced()
    clients, eval_set = jfemnist.generate(
        jfemnist.FemnistConfig(n_clients=jexp.fl.n_clients, seed=jexp.seed + 7))
    params, _ = jcnn.init_params(cfg, jax.random.PRNGKey(0))
    backend = jfl.ClientStackedBackend(
        jexp.fl, jexp.make_strategy(), params, clients, jax.tree.map(jnp.asarray, eval_set),
        jcnn.loss_fn, sample_counts=jfemnist.sample_counts(clients), eval_every=eval_every)
    snaps = []
    orch = jrt.Orchestrator(jexp, backend, callbacks=[
        lambda o, r: snaps.append({k: np.asarray(v) for k, v in o.backend.params.items()})])
    orch.run(n_updates)
    return {k: np.asarray(v) for k, v in params.items()}, (clients, eval_set), orch, snaps


STACKED = [  # (strategy, policy, strategy kwargs, n_pons, compress, eval_every)
    ("sfl_two_step", "fedbuff", {}, 1, "none", 1),
    ("sfl_two_step", "semi_sync", {}, 1, "none", 2),
    ("classical", "semi_sync", {}, 1, "none", 1),
    ("fedopt", "fedbuff", {"server_opt": "yogi"}, 1, "none", 1),
    ("hier_sfl", "fedbuff", {"n_pons": 2}, 2, "none", 1),
    ("sfl_two_step", "fedbuff", {}, 1, "int8", 1),
]


@pytest.fixture
def jax_noise(monkeypatch):
    """The reference's rounding noise fed to the port's CompressionState."""
    def uniform_noise(self, call, shapes):
        return [u.to(self.device) for u in _jax_noise(call, shapes, self.seed)]
    monkeypatch.setattr(tc.CompressionState, "uniform_noise", uniform_noise)


@pytest.mark.parametrize("mode,policy,skw,n_pons,compress,eval_every", STACKED,
                         ids=[f"{c[0]}-{c[1]}-{c[4]}-e{c[5]}" for c in STACKED])
def test_client_stacked_async_matches_reference(mode, policy, skw, n_pons, compress,
                                                eval_every, jax_noise):
    """launch.femnist_async.run against the reference's Orchestrator on its
    ClientStackedBackend, 3 server updates from its init: every transport
    and count column exact, the parameters within 1e-4 after every update,
    the eval (every ``eval_every``-th update, carried between) within 1e-4;
    one client trained at each dispatch, its minibatch draw before its
    wireless draw, so the generator ends where the reference's does; on the
    CPU no kernel launches."""
    exp, jexp = _cnn_experiment(mode, policy, skw, n_pons, compress)
    init, data, jorch, jsnaps = _jax_async(jexp, eval_every, 3)
    snaps = []
    before = segment_agg_reduce.launches
    hist, orch = femnist_async.run(
        exp, n_updates=3, params=params_from_jax(init), device="cpu", data=data,
        eval_every=eval_every,
        callbacks=[lambda o, r: snaps.append(params_to_jax(o.backend.params))])
    assert segment_agg_reduce.launches == before
    jhist = jorch.history
    assert len(hist) == len(jhist) == len(snaps) == len(jsnaps) and len(hist) > 0
    for i, (r, j) in enumerate(zip(hist, jhist)):
        assert set(r) == set(j) | {"wall_s", "dispatch_host_s", "aggregate_host_s"}, (set(r), set(j))
        for key in j:
            if key in ("acc", "eval_loss"):
                assert r[key] == pytest.approx(j[key], abs=1e-4), (i, key)
            else:
                assert r[key] == j[key], (i, key, r[key], j[key])
        for k, want in jsnaps[i].items():
            np.testing.assert_allclose(snaps[i][k], want, rtol=0, atol=1e-4,
                                       err_msg=f"{k} after update {i}")
    assert orch.total_upstream_mbits == jorch.total_upstream_mbits
    assert orch.rng.integers(0, 1 << 30) == jorch.rng.integers(0, 1 << 30)
    if eval_every > 1:
        assert "eval_loss" not in hist.records[0]
        assert hist.records[2]["eval_loss"] == hist.records[1]["eval_loss"]
    if compress == "int8":
        assert orch.backend._comp._calls == jorch.backend._comp._calls == len(hist)


def test_sync_policy_on_client_stacked_is_the_roundloop():
    """Orchestrator(policy="sync") and the RoundLoop on the port's
    ClientStackedBackend from the same init, transient failures on: every
    column but the host-time keys equal and the parameters bit for bit
    after 2 rounds."""
    from repro_torch import configs
    from repro_torch.data import femnist
    from repro_torch.models import femnist_cnn
    exp, _ = _cnn_experiment("sfl_two_step", "sync", {}, 1, "none", local_steps=1)
    exp = dataclasses.replace(exp, p_transient=0.2)
    clients, eval_set = femnist.generate(femnist.FemnistConfig(n_clients=20, seed=7))

    def backend():
        p0 = femnist_cnn.init_params(configs.get("femnist_cnn").reduced(),
                                     torch.Generator().manual_seed(0), "cpu")
        return fl.ClientStackedBackend(
            exp.fl, exp.make_strategy(), p0, clients,
            {k: torch.from_numpy(v) for k, v in eval_set.items()}, femnist_cnn.loss_fn,
            sample_counts=femnist.sample_counts(clients))

    orch, loop = runtime.Orchestrator(exp, backend()), fl.RoundLoop(exp, backend())
    hist = orch.run(2)
    loop.run(2)
    assert [_strip(r, HOST_KEYS + ("t_s", "policy", "version")) for r in hist] == [
        _strip(r) for r in loop.history]
    assert all(torch.equal(orch.backend.params[k], loop.backend.params[k])
               for k in loop.backend.params)


# ---------------------------------------------- weights, registry, failures

def test_staleness_weights_and_registry_match_reference():
    rng = np.random.default_rng(4)
    w, tau = rng.uniform(10, 400, 12).astype(np.float32), rng.integers(0, 6, 12)
    for alpha in (0.0, 0.5, 1.3):
        got = runtime.staleness_weights(w, tau, alpha)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jrt.staleness_weights(w, tau, alpha))
    assert runtime.staleness_weights(np.array([100.0]), np.array([3.0]), 0.5)[0] == 50.0
    assert runtime.policy_names() == jrt.policy_names() == ["fedbuff", "semi_sync", "sync"]
    for name in ("async", "semi-sync", "sync", "fedbuff"):
        assert runtime.canonical_policy(name) == jrt.canonical_policy(name)
        assert runtime.make_policy(name).name == jrt.make_policy(name).name
    assert runtime.make_policy("sync").needs_async_backend is False
    with pytest.raises(KeyError, match="unknown aggregation policy"):
        runtime.canonical_policy("nope")


def test_failures_membership_and_renormalized_weights_match_reference():
    from repro.runtime import failures as jfailures
    a = tfailures.FailureModel(p_crash=0.2, p_transient=0.3, seed=5)
    b = jfailures.FailureModel(p_crash=0.2, p_transient=0.3, seed=5)
    for rnd in range(6):
        np.testing.assert_array_equal(a.step(rnd, 15), b.step(rnd, 15))
        ca, ta = a.step_components(rnd + 10, 15)
        cb, tb = b.step_components(rnd + 10, 15)
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(ta, tb)
    m, jm = runtime.MembershipTable(timeout_s=10.0), jrt.MembershipTable(timeout_s=10.0)
    for node, t in ((3, 0.0), (1, 5.0), (7, 12.0), (3, 14.0), (9, 1.0)):
        m.heartbeat(node, t)
        jm.heartbeat(node, t)
    for now in (10.0, 15.0, 24.0):
        np.testing.assert_array_equal(m.alive(now), jm.alive(now))
        np.testing.assert_array_equal(m.mask(8, now), jm.mask(8, now))
    w = np.array([3.0, 1.0, 4.0, 2.0], np.float32)
    for alive in (np.array([1, 0, 1, 1], np.float32), np.zeros(4, np.float32)):
        np.testing.assert_array_equal(runtime.renormalized_weights(w, alive),
                                      jrt.renormalized_weights(w, alive))


# ------------------------------------------------------------------ the CLI

def _both_configs(argv, **overrides):
    ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
    fl.add_experiment_cli_args(ap)
    jfl.add_experiment_cli_args(jap)
    return (fl.experiment_config_from_args(ap.parse_args(argv), **overrides),
            jfl.experiment_config_from_args(jap.parse_args(argv), **overrides))


CLI_CASES = [
    [],
    ["--policy", "semi_sync", "--window-s", "30", "--onu-gather-s", "0.5", "--overselect",
     "0.2", "--p-crash", "0.05", "--p-transient", "0.1", "--mean-recovery-rounds", "2",
     "--failure-seed", "9"],
    ["--policy", "async", "--buffer-k", "4", "--concurrency", "16", "--staleness-exp", "0",
     "--strategy", "fedopt", "--server-opt", "yogi", "--server-lr", "0.1", "--compress",
     "topk", "--topk-frac", "0.05", "--error-feedback", "--dba", "fl_priority",
     "--wavelengths", "2", "--bg-load", "0.3", "--sim-engine", "hybrid"],
    ["--strategy", "hier", "--n-pons", "3", "--onus", "4", "--clients-per-onu", "5",
     "--compress", "int8", "--metro-rate-mbps", "700", "--fedprox-mu", "0.1"],
]


@pytest.mark.parametrize("argv", CLI_CASES, ids=["defaults", "semi_sync", "fedbuff", "hier"])
def test_experiment_cli_round_trip(argv):
    """The shared flag set builds the reference's ExperimentConfig, field for
    field, FLConfig and PonConfig included (both FLConfigs carry the legacy
    ``mode`` and ``seed``, which no builder sets: the strategy holds the
    mode, the experiment the seed)."""
    got, jexp = _both_configs(argv, n_rounds=7)
    want = dataclasses.asdict(jexp)
    assert (want["fl"]["mode"], want["fl"]["seed"]) == ("sfl", 0)
    assert dataclasses.asdict(got) == want
    assert got.make_strategy() == fl.make_strategy(jexp.strategy, **dict(jexp.strategy_kwargs))


def test_femnist_async_cli_drives_and_refuses(capsys, monkeypatch, tmp_path):
    """The entry point on the CPU at reduced size prints one row a window and
    the summary; ``--trace-out`` writes a Chrome trace of the run (the live
    grant spans, θ-gather windows and server-update instants); without a
    card and without --device cpu it raises."""
    femnist_async.main(["--rounds", "2", "--n-selected", "6", "--onus", "4",
                        "--clients-per-onu", "5", "--policy", "semi_sync", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "policy=semi_sync strategy=sfl_two_step budget=50 sim-s" in out
    assert out.count(" update ") == 2 and "server updates in 50 simulated seconds" in out
    trace = tmp_path / "t.json"
    femnist_async.main(["--rounds", "1", "--n-selected", "6", "--onus", "4",
                        "--clients-per-onu", "5", "--policy", "semi_sync", "--device", "cpu",
                        "--trace-out", str(trace)])
    assert f"spans to {trace}" in capsys.readouterr().out
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"theta", "θ-gather", "train+wireless"} <= names, names
    assert any(e["ph"] == "i" and e["name"] == "server-update" for e in events)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp, _ = _cnn_experiment("sfl_two_step", "fedbuff", {}, 1, "none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        femnist_async.run(exp, n_updates=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        femnist_async.main(["--rounds", "1"])
