"""The port's PON transport (``repro_torch.pon``: the event simulator, its
DBA policies, wavelengths and background load, the metro forest and the
fast/hybrid engines) against the reference's ``repro.pon``, exactly: on
numpy inputs made from seeds, each call returns the reference's dict key by
key, bit for bit, and leaves the generator in the reference's state."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import pon as R  # noqa: E402
from repro_torch import pon as P  # noqa: E402
from repro_torch.pon import events, fast  # noqa: E402

DBAS = ("fifo", "tdma", "ipact", "fl_priority")


def _same(got: dict, want: dict) -> None:
    """The whole dict, key by key: arrays of one dtype and equal bits,
    scalars of one type and equal value."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            assert np.array_equal(g, w), k
        else:
            assert type(g) is type(w) and g == w, (k, g, w)


def _inputs(n_pons=1, n_onus=16, cpo=20, n_sel=128, seed=0):
    """Sample counts, PON-major global ONU ids and a selection."""
    rng = np.random.default_rng(seed)
    n = n_pons * n_onus * cpo
    counts = rng.integers(50, 400, n)
    return counts, np.arange(n) // cpo, rng.choice(n, min(n_sel, n), replace=False)


def _pair(fn_port, fn_ref, seed, *args, **kw):
    """Both simulators on one input from generators seeded alike: the
    dicts equal and the generators left in the same state."""
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = fn_port(*args, rng=r1, **kw), fn_ref(*args, rng=r2, **kw)
    _same(got, want)
    assert r1.bit_generator.state == r2.bit_generator.state
    return got


@pytest.mark.parametrize("queueing", [False, True])
@pytest.mark.parametrize("mode", ["sfl", "classical"])
@pytest.mark.parametrize("bg", [0.0, 0.5])
@pytest.mark.parametrize("n_w", [1, 2])
@pytest.mark.parametrize("dba", DBAS)
def test_simulate_round_equals_reference(dba, n_w, bg, mode, queueing):
    counts, onu, sel = _inputs(seed=n_w)
    kw = dict(dba=dba, n_wavelengths=n_w, background_load=bg, sfl_queueing=queueing)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    got = P.simulate_round(P.PonConfig(**kw), r1, sel, onu, counts, mode)
    want = R.simulate_round(R.PonConfig(**kw), r2, sel, onu, counts, mode)
    _same(got, want)
    assert r1.bit_generator.state == r2.bit_generator.state
    assert got["sim_engine"] == "event" and got["dba"] == P.make_dba(dba).name
    if bg == 0.0:
        assert got["bg_mbits_offered"] == 0.0


def _skewed_forest(mod, n_pons):
    """A forest of unequal trees: ONU counts and clients per ONU differ by
    PON, and so do the drop-link caps."""
    rng = np.random.default_rng(n_pons)
    pons = tuple(mod.Topology.skewed(rng.integers(0, 9, 3 + 2 * p), n_wavelengths=2,
                                     onu_link_mbps=(None, 60.0)[p % 2])
                 for p in range(n_pons))
    return mod.MetroTopology(pons=pons, metro_rate_mbps=400.0, metro_wavelengths=2)


@pytest.mark.parametrize("queueing", [False, True])
@pytest.mark.parametrize("mode", ["sfl", "classical", "hier"])
@pytest.mark.parametrize("n_pons", [2, 4])
def test_simulate_hier_round_equals_reference(n_pons, mode, queueing):
    """The uniform forest through round_times (its dispatch on n_pons),
    fl_priority, 2 wavelengths, background load 0.3."""
    counts, onu, sel = _inputs(n_pons=n_pons, n_onus=8, cpo=10, seed=n_pons)
    kw = dict(n_pons=n_pons, n_onus=8, clients_per_onu=10, dba="fl_priority",
              n_wavelengths=2, background_load=0.3, sfl_queueing=queueing,
              metro_rate_mbps=500.0)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    got = P.round_times(P.PonConfig(**kw), r1, sel, onu, counts, mode)
    want = R.round_times(R.PonConfig(**kw), r2, sel, onu, counts, mode)
    _same(got, want)
    assert r1.bit_generator.state == r2.bit_generator.state
    assert got["n_pons"] == n_pons and got["n_fl_jobs"] > 0


@pytest.mark.parametrize("mode", ["sfl", "classical", "hier"])
@pytest.mark.parametrize("n_pons", [2, 4])
def test_skewed_forest_equals_reference(n_pons, mode):
    """An explicit skewed MetroTopology (empty ONUs, capped links) with
    background load, ipact grants and the queued θ path."""
    forest, jforest = _skewed_forest(P, n_pons), _skewed_forest(R, n_pons)
    onu = forest.onu_of_client()
    assert np.array_equal(onu, jforest.onu_of_client())
    assert np.array_equal(forest.pon_of_onu(np.arange(forest.total_onus)),
                          jforest.pon_of_onu(np.arange(forest.total_onus)))
    rng = np.random.default_rng(n_pons)
    counts = rng.integers(50, 400, len(onu))
    sel = rng.choice(len(onu), min(40, len(onu)), replace=False)
    kw = dict(dba="ipact", n_wavelengths=2, background_load=0.4, sfl_queueing=True,
              n_pons=n_pons, metro_rate_mbps=400.0, metro_wavelengths=2)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    got = P.simulate_hier_round(P.PonConfig(**kw), r1, sel, onu, counts, mode, metro=forest)
    want = R.simulate_hier_round(R.PonConfig(**kw), r2, sel, onu, counts, mode,
                                 metro=jforest)
    _same(got, want)
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("n_w,queueing", [(1, False), (2, True)])
@pytest.mark.parametrize("n_pons", [1, 3])
@pytest.mark.parametrize("mode", ["sfl", "classical", "hier"])
@pytest.mark.parametrize("dba", DBAS)
@pytest.mark.parametrize("engine", ["fast", "hybrid"])
def test_fast_and_hybrid_engines_equal_reference(engine, dba, mode, n_pons, n_w, queueing):
    """The fast and hybrid engines against the reference's, through
    round_times; and fast against the port's own event engine (the same
    dict but its ``sim_engine`` stamp)."""
    counts, onu, sel = _inputs(n_pons=n_pons, n_onus=8, cpo=10, n_sel=48,
                               seed=n_pons + n_w)
    kw = dict(n_pons=n_pons, n_onus=8, clients_per_onu=10, dba=dba, n_wavelengths=n_w,
              background_load=0.5, sfl_queueing=queueing, sim_engine=engine)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    got = P.round_times(P.PonConfig(**kw), r1, sel, onu, counts, mode)
    want = R.round_times(R.PonConfig(**kw), r2, sel, onu, counts, mode)
    _same(got, want)
    assert r1.bit_generator.state == r2.bit_generator.state
    assert got["sim_engine"] == engine
    if engine == "fast":
        r3 = np.random.default_rng(5)
        event = P.round_times(P.PonConfig(**dict(kw, sim_engine="event")), r3, sel, onu,
                              counts, mode)
        _same(dict(got, sim_engine="event"), event)
        assert r3.bit_generator.state == r1.bit_generator.state


def _jobs(mod, rng, n, n_onus):
    kinds = ("fl", "theta", "bg")
    return [mod.UpstreamJob(seq=i, onu=int(rng.integers(0, n_onus)),
                            size_mbits=float(rng.exponential(40.0)),
                            ready_s=float(rng.uniform(0, 20)),
                            kind=kinds[int(rng.integers(0, 3))], client=i)
            for i in range(n)]


def _fields(jobs):
    return [(j.seq, j.start_s, j.done_s, j.wavelength, j.grant_idx) for j in jobs]


@pytest.mark.parametrize("n_w", [1, 3])
@pytest.mark.parametrize("dba", DBAS)
def test_incremental_upstream_equals_batch_and_reference(dba, n_w):
    """UpstreamSim fed job by job (each submitted at or before its ready
    time, the clock advanced in between) == the batch simulate_upstream
    == the reference's, float for float; on_done fires once per job in
    completion order. One ONU reaches only wavelength 0."""
    def topo(mod):
        onus = tuple(mod.Onu(i, 5, link_mbps=(None, 70.0)[i % 2],
                             wavelengths=(0,) if i == 0 else None) for i in range(6))
        return mod.Topology(onus, tuple(mod.Wavelength(w, 100.0) for w in range(n_w)))

    batch = _jobs(P, np.random.default_rng(n_w), 60, 6)
    want = _jobs(R, np.random.default_rng(n_w), 60, 6)
    P.simulate_upstream(batch, topo(P), P.make_dba(dba))
    R.simulate_upstream(want, topo(R), R.make_dba(dba))
    assert _fields(batch) == _fields(want)
    live = _jobs(P, np.random.default_rng(n_w), 60, 6)
    done = []
    sim = events.UpstreamSim(topo(P), P.make_dba(dba), on_done=done.append)
    for j in sorted(live, key=lambda j: j.ready_s):
        sim.advance_to(j.ready_s - 0.5)
        sim.submit(j)
    sim.drain()
    assert _fields(live) == _fields(batch)
    assert len(done) == 60 and [j.done_s for j in done] == sorted(j.done_s for j in done)
    assert sim.next_event_s() is None


@pytest.mark.parametrize("mode", ["classical", "sfl", "hier"])
def test_expected_segment_mbits_equals_reference(mode):
    for args in ((211.3, 128, 16, 1), (26.4, 40, 9, 3), (1.0, 0, 0, 0)):
        assert P.expected_segment_mbits(mode, *args) == R.expected_segment_mbits(mode, *args)


@pytest.mark.parametrize("queueing", [False, True])
@pytest.mark.parametrize("mode", ["sfl", "classical"])
@pytest.mark.parametrize("seed", [0, 17])
def test_round_times_fifo_is_the_event_simulator_under_defaults(seed, mode, queueing):
    """The closed form == round_times (the event simulator) at the paper
    defaults, and == the reference's closed form."""
    counts, onu, sel = _inputs(seed=seed)
    cfg = P.PonConfig(sfl_queueing=queueing)
    fifo = _pair(lambda rng: P.round_times_fifo(cfg, rng, sel, onu, counts, mode),
                 lambda rng: R.round_times_fifo(R.PonConfig(sfl_queueing=queueing), rng,
                                                sel, onu, counts, mode), seed)
    r = np.random.default_rng(seed)
    event = P.round_times(cfg, r, sel, onu, counts, mode)
    _same({k: event[k] for k in fifo}, fifo)


def test_config_properties_and_cli_equal_reference():
    """PonConfig's fields, defaults and derived properties; the CLI flags
    (every default and a full set of values) build the reference's config."""
    import argparse
    assert ([(f.name, f.default) for f in dataclasses.fields(P.PonConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(R.PonConfig)])
    kw = dict(n_pons=3, n_onus=7, metro_rate_mbps=250.0, metro_latency_ms=2.0)
    a, b = P.PonConfig(**kw), R.PonConfig(**kw)
    for name in ("n_clients", "total_onus", "upload_s", "metro_upload_s", "metro_latency_s"):
        assert getattr(a, name) == getattr(b, name), name
    argv = ["--dba", "ipact", "--wavelengths", "3", "--bg-load", "0.7", "--onus", "5",
            "--clients-per-onu", "3", "--sfl-queueing", "--slice-mbps", "50",
            "--model-mbits", "26.4", "--deadline-s", "30", "--bg-burst-mbits", "2",
            "--onu-link-mbps", "80", "--metro-wavelengths", "2", "--n-pons", "4",
            "--metro-rate-mbps", "700", "--metro-latency-ms", "1.5", "--sim-engine",
            "hybrid", "--fluid-threshold", "0.6"]
    for args in ([], argv):
        ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
        P.add_pon_cli_args(ap)
        R.add_pon_cli_args(jap)
        got = P.pon_config_from_args(ap.parse_args(args))
        want = R.pon_config_from_args(jap.parse_args(args))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_errors_equal_reference():
    """Unknown engine and DBA names, explicit overrides on the fast engine
    and on a forest, an ONU id outside the forest, a mispositioned id: the
    reference's exceptions and messages."""
    counts, onu, sel = _inputs(n_pons=2, n_onus=4, cpo=5, n_sel=10)

    def both(fn):
        with pytest.raises(ValueError) as got:
            fn(P)
        with pytest.raises(ValueError) as want:
            fn(R)
        assert str(got.value) == str(want.value)

    rng = np.random.default_rng
    both(lambda m: m.round_times(m.PonConfig(sim_engine="warp"), rng(0), sel[:4],
                                 onu[:80], counts, "sfl"))
    both(lambda m: m.simulate_round(m.PonConfig(sim_engine="fast"), rng(0), sel[:4], onu,
                                    counts, "sfl", dba=m.make_dba("fifo")))
    both(lambda m: m.simulate_round(m.PonConfig(n_pons=2, n_onus=4, clients_per_onu=5),
                                    rng(0), sel, onu, counts, "hier",
                                    topology=m.Topology.uniform(4, 5)))
    for engine in ("event", "fast"):
        both(lambda m: m.simulate_round(m.PonConfig(n_pons=2, n_onus=3, clients_per_onu=5,
                                                    sim_engine=engine),
                                        rng(0), sel, onu, counts, "hier"))
    both(lambda m: m.make_dba("round_robin"))
    both(lambda m: m.Topology((m.Onu(1, 3),), (m.Wavelength(0),)))
    both(lambda m: m.expected_segment_mbits("mesh", 1.0, 1, 1, 1))
    with pytest.raises(ValueError, match="unknown sim_engine"):
        fast.simulate_round_fast(P.PonConfig(sim_engine="event2"), rng(0), sel, onu, counts,
                                 "sfl")


def test_simulators_import_neither_torch_nor_jax():
    """The simulator modules are numpy and plain Python: importing them
    in a fresh interpreter loads neither torch nor jax."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = ("import sys; import repro_torch.pon, repro_torch.pon.fast; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": src})
    assert out.stdout.strip() == "[]"
