"""The strategies that ride the event-simulator transport — ``hier_sfl``
(the k-step aggregation over a PON forest), ``fedprox`` and ``fedopt`` —
against the JAX reference at reduced width on numpy inputs made from seeds:
HierSfl's aggregate (1e-6; with one PON bit for bit the port's
``sfl_two_step``), its int8 and int4 tiers with the reference's noise fed
in, ``local_sgd_prox``, FedOpt's server step, the composition defaults,
3-round RoundLoop slices (transport columns exact, parameters 1e-4), a
``TransportBackend`` sweep and the CLI round trips of ``launch.femnist``
and ``launch.train``.

On the CPU every kernel wrapper runs its plain version; the kernels at the
forest's shapes are held against those on the card (chip_smoke.py phase
16)."""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import fl as jfl  # noqa: E402
from repro import pon as jpon  # noqa: E402
from repro.core import compression as jc  # noqa: E402
from repro.core import fedavg as jfedavg  # noqa: E402
from repro.data import femnist as jfemnist  # noqa: E402
from repro.models import femnist_cnn as jcnn  # noqa: E402
from repro_torch import fl, hier  # noqa: E402
from repro_torch import pon as tpon  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import compression as tc  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.kernels import segment_agg_reduce  # noqa: E402
from repro_torch.launch import femnist as launch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import femnist_cnn  # noqa: E402
from test_torch_compression import _jax_noise  # noqa: E402

SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_noise(monkeypatch):
    """The reference's rounding noise fed to the port's CompressionState."""
    def uniform_noise(self, call, shapes):
        return [u.to(self.device) for u in _jax_noise(call, shapes, self.seed)]
    monkeypatch.setattr(tc.CompressionState, "uniform_noise", uniform_noise)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _forest_inputs(seed, C=26, n_onus=8, silent=1):
    """Client deltas (a conv weight's 4-d leaf and a vector), weights, a
    mask and global ONU ids over ``n_onus`` ONUs, the last ``silent`` of
    them without a client."""
    rng = np.random.default_rng(seed)
    deltas = {"b": rng.normal(size=(C, 7)).astype(np.float32),
              "k": rng.normal(size=(C, 2, 3, 2, 2)).astype(np.float32)}
    w = rng.uniform(1, 80, C).astype(np.float32)
    m = (rng.random(C) > 0.25).astype(np.float32)
    onu = rng.integers(0, n_onus - silent, C)
    return deltas, w, m, onu


# ------------------------------------------------------------ the aggregate

@pytest.mark.parametrize("n_pons", [2, 4])
def test_hier_aggregate_matches_reference(n_pons):
    """The last PON's ONUs are silent, so it sends no Φ."""
    deltas, w, m, onu = _forest_inputs(n_pons, silent=8 // n_pons)
    agg, stats = fl.make_strategy("hier_sfl", n_pons=n_pons).aggregate(
        _t(deltas), w, m, onu, 8)
    jagg, jstats = jfl.make_strategy("hier_sfl", n_pons=n_pons).aggregate(
        {k: jnp.asarray(v) for k, v in deltas.items()}, jnp.asarray(w), jnp.asarray(m),
        jnp.asarray(onu), 8)
    assert list(agg) == list(deltas)
    for k in deltas:
        np.testing.assert_allclose(agg[k].numpy(), np.asarray(jagg[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for key in ("uplink_models", "metro_models", "involved"):
        assert stats[key] == float(jstats[key]), key
    assert float(stats["K"]) == pytest.approx(float(jstats["K"]), rel=1e-6)
    assert stats["metro_models"] == n_pons - 1


def test_hier_with_one_pon_is_sfl_two_step_bit_for_bit():
    """n_pons = 1: the aggregate is the port's sfl_two_step's, bit for bit
    (and the reference's within 1e-6); and through the RoundLoop the
    transport rows of hier_sfl equal sfl_two_step's."""
    deltas, w, m, onu = _forest_inputs(1)
    a, sa = fl.make_strategy("hier_sfl").aggregate(_t(deltas), w, m, onu, 8)
    b, sb = fl.make_strategy("sfl_two_step").aggregate(_t(deltas), w, m, onu, 8)
    assert sa == sb and all(torch.equal(a[k], b[k]) for k in deltas)
    jagg, _ = jfl.make_strategy("hier_sfl").aggregate(
        {k: jnp.asarray(v) for k, v in deltas.items()}, jnp.asarray(w), jnp.asarray(m),
        jnp.asarray(onu), 8)
    for k in deltas:
        np.testing.assert_allclose(a[k].numpy(), np.asarray(jagg[k]), rtol=1e-6, atol=1e-6)
    rows = []
    for name in ("hier_sfl", "sfl_two_step"):
        backend = fl.TransportBackend(fl.make_strategy(name), np.full(40, 100.0),
                                      np.arange(40) // 5)
        exp = fl.ExperimentConfig(fl=fedavg.FLConfig(
            n_onus=8, clients_per_onu=5, n_selected=12,
            pon=tpon.PonConfig(dba="fl_priority", n_wavelengths=2, background_load=0.4)))
        loop = fl.RoundLoop(exp, backend)
        loop.run(3)
        rows.append([{k: v for k, v in r.items() if k != "wall_s"} for r in loop.history])
    assert rows[0] == rows[1]


def test_hier_rejects_an_indivisible_forest():
    deltas, w, m, onu = _forest_inputs(0, n_onus=6)
    for mod in (fl, jfl):
        with pytest.raises(ValueError, match="not divisible by n_pons=4"):
            mod.make_strategy("hier_sfl", n_pons=4).aggregate(
                _t(deltas) if mod is fl else {k: jnp.asarray(v) for k, v in deltas.items()},
                w, m, onu, 6)


def _levels(deltas, w, m, onu, n_onus, n_pons, qmax):
    """One quantization level of every row each tier sends, summed through
    the tiers, per leaf (float64, from the exact θ, Φ, Ψ): the most a
    one-level rounding flip at each tier can move the aggregate, times K."""
    pon_of_onu = np.arange(n_onus) // (n_onus // n_pons)
    out = {}
    for k, x in deltas.items():
        wx = x.reshape(len(x), -1).astype(np.float64) * (w * m)[:, None]
        theta = np.zeros((n_onus, wx.shape[1]))
        np.add.at(theta, onu, wx)
        phi = np.zeros((n_pons, wx.shape[1]))
        np.add.at(phi, pon_of_onu, theta)
        lv = sum(np.abs(r).max(1).sum() for r in (theta, phi, phi.sum(0, keepdims=True)))
        out[k] = lv / qmax
    return out


@pytest.mark.parametrize("scheme,ef", [("int8", False), ("int4", True)])
def test_compressed_tiers_match_reference_with_its_noise(scheme, ef, jax_noise):
    """θ, Φ and Ψ each through the wire (int8: θ on the fused aggregate +
    quantize route; int4 + EF: θ aggregated then quantized), the
    reference's noise fed in call by call. Each leaf of the aggregate
    within one level of every row of every tier (Σ level · 1.01 / K, plus
    1e-6) of the reference's, over two rounds for int8 (the noise call
    advancing 3 a round); the noise counters and EF tiers alike."""
    n_onus, n_pons = 8, 2
    qmax = 127.0 if scheme == "int8" else 7.0
    spec = dict(error_feedback=ef)
    st = tc.CompressionState(tc.CompressionSpec(scheme, **spec))
    jst = jc.CompressionState(jc.CompressionSpec(scheme, **spec))
    strat = fl.make_strategy("hier_sfl", n_pons=n_pons, compress=scheme)
    jstrat = jfl.make_strategy("hier_sfl", n_pons=n_pons, compress=scheme)
    for rnd in range(1 if ef else 2):
        deltas, w, m, onu = _forest_inputs(10 + rnd, n_onus=n_onus, silent=1 + 4 * rnd)
        agg, stats = strat.aggregate(_t(deltas), w, m, onu, n_onus, comp=st)
        jagg, jstats = jstrat.aggregate({k: jnp.asarray(v) for k, v in deltas.items()},
                                        jnp.asarray(w), jnp.asarray(m), jnp.asarray(onu),
                                        n_onus, comp=jst)
        K = float(stats["K"])
        for k, lv in _levels(deltas, w, m, onu, n_onus, n_pons, qmax).items():
            diff = np.abs(agg[k].double().numpy() - np.asarray(jagg[k], np.float64))
            assert diff.max() <= 1.01 * lv / K + 1e-6, (k, diff.max(), lv / K)
        assert stats["metro_models"] == float(jstats["metro_models"])
        assert st._calls == jst._calls == 3 * (rnd + 1)
    assert sorted(st._tier_err) == sorted(jst._tier_err) == (
        ["phi", "psi", "theta"] if ef else [])


# ------------------------------------------------- fedprox, fedopt, composition

def _cnn_inputs():
    cfg = jconfigs.get("femnist_cnn").reduced()
    params, _ = jcnn.init_params(cfg, jax.random.PRNGKey(SEED))
    clients, _ = jfemnist.generate(jfemnist.FemnistConfig(n_clients=1, seed=11))
    batches = jfemnist.client_minibatches(np.random.default_rng(0), clients[0], 3, 8)
    return _np(params), batches


def test_local_sgd_prox_and_fedprox_match_reference():
    """Three proximal SGD steps from the reference's init (mu 0.3): the
    parameters and the mean loss within 1e-5; FedProx's and HierSfl(mu)'s
    deltas equal each other bit for bit and the reference's within 1e-5."""
    params, batches = _cnn_inputs()
    tparams = params_from_jax(params)
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    jb = {k: jnp.asarray(v) for k, v in batches.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    p, loss = fedavg.local_sgd_prox(tparams, tb, femnist_cnn.loss_fn, 0.05, 3, 0.3, tparams)
    jp3, jloss = jfedavg.local_sgd_prox(jp, jb, jcnn.loss_fn, 0.05, 3, 0.3, jp)
    got = params_to_jax(p)
    for k in params:
        np.testing.assert_allclose(got[k], np.asarray(jp3[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    flc = fedavg.FLConfig(local_steps=3, local_batch=8, local_lr=0.05)
    d1, _ = fl.make_strategy("fedprox", mu=0.3).local_update(tparams, tb,
                                                             femnist_cnn.loss_fn, flc)
    d2, _ = fl.make_strategy("hier_sfl", mu=0.3).local_update(tparams, tb,
                                                              femnist_cnn.loss_fn, flc)
    jd, _ = jfl.make_strategy("fedprox", mu=0.3).local_update(
        jp, jb, jcnn.loss_fn, jfedavg.FLConfig(local_steps=3, local_batch=8, local_lr=0.05))
    got = params_to_jax(d1)
    for k in params:
        assert torch.equal(d1[k], d2[k]), k
        np.testing.assert_allclose(got[k], np.asarray(jd[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    assert not any(torch.equal(d1[k], fl.make_strategy("sfl").local_update(
        tparams, tb, femnist_cnn.loss_fn, flc)[0][k]) for k in ("fc1_w",))


@pytest.mark.parametrize("opt", ["adamw", "yogi", "sgdm"])
def test_fedopt_server_steps_match_reference(opt):
    """Three FedOpt server steps (the pseudo-gradient −Δ) from the same
    parameters and deltas: within 1e-6, the optimizer state's step count
    alike; the default server_lr is the reference's 0.03."""
    rng = np.random.default_rng(len(opt))
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    deltas = [{k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
               for k, v in params.items()} for _ in range(3)]
    s, js = fl.make_strategy("fedopt", server_opt=opt), jfl.make_strategy("fedopt",
                                                                           server_opt=opt)
    assert s.server_lr == js.server_lr == 0.03
    p, jp = _t(params), {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = s.init_state(p), js.init_state(jp)
    for d in deltas:
        p, state = s.server_update(p, _t(d), state)
        jp, jstate = js.server_update(jp, {k: jnp.asarray(v) for k, v in d.items()}, jstate)
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    if opt != "sgdm":
        assert int(state["t"]) == int(jstate["t"]) == 3


def test_hier_composition_defaults_match_reference():
    """Both axes off by default (no state, the plain apply at 1.0);
    server_opt alone takes FedOpt's 0.03, not the plain apply's 1.0; an
    explicit server_lr reaches either; each step equals the reference's."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    delta = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    jparams, jdelta = ({k: jnp.asarray(v) for k, v in t.items()} for t in (params, delta))
    base, jbase = fl.make_strategy("hier_sfl"), jfl.make_strategy("hier_sfl")
    assert (base.mu, base.server_opt, base.server_lr) == (jbase.mu, jbase.server_opt,
                                                          jbase.server_lr) == (0.0, None, None)
    assert base.init_state(_t(params)) is None
    for kw in ({}, {"server_lr": 0.5}, {"server_opt": "adamw"},
               {"server_opt": "yogi", "server_lr": 0.1}):
        s, js = fl.make_strategy("hier_sfl", **kw), jfl.make_strategy("hier_sfl", **kw)
        if "server_opt" in kw:
            assert s._fedopt() == fl.make_strategy("fedopt", **kw)
            assert s._fedopt().server_lr == js._fedopt().server_lr
        p, _ = s.server_update(_t(params), _t(delta), s.init_state(_t(params)))
        jp, _ = js.server_update(jparams, jdelta, js.init_state(jparams))
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-6,
                                   err_msg=str(kw))
    plain, _ = base.server_update(_t(params), _t(delta), None)
    want, _ = fl.make_strategy("sfl").server_update(_t(params), _t(delta), None)
    assert torch.equal(plain["w"], want["w"])


# ------------------------------------------------------- RoundLoop slices

TRANSPORT = ("round", "n_selected", "sim_engine", "involved", "upstream_mbits",
             "uplink_models", "metro_mbits", "trunk_mbits", "pon_mbits_max",
             "metro_mbits_max", "n_pons")


def _jax_slice(mode, pon_kw, skw, n_pons, rounds=3):
    """bench_accuracy.run's loop for one mode over a forest of ``n_pons``
    trees of 4 ONUs × 5 clients, N = 5 a PON; the params after each round."""
    cfg = jconfigs.get("femnist_cnn").reduced()
    flc = jfedavg.FLConfig(n_selected=5 * n_pons, local_steps=8, local_lr=0.06,
                           pon=jpon.PonConfig(**pon_kw), n_onus=4, clients_per_onu=5,
                           n_pons=n_pons)
    clients, eval_set = jfemnist.generate(
        jfemnist.FemnistConfig(n_clients=flc.n_clients, seed=SEED + 7))
    params, _ = jcnn.init_params(cfg, jax.random.PRNGKey(SEED))
    kw = jfl.filter_strategy_kwargs(mode, skw)
    backend = jfl.ClientStackedBackend(
        flc, jfl.make_strategy(mode, **kw), params, clients,
        jax.tree.map(jnp.asarray, eval_set), lambda p, b: jcnn.loss_fn(p, b),
        sample_counts=jfemnist.sample_counts(clients))
    exp = jfl.ExperimentConfig(fl=flc, strategy=jfl.canonical_name(mode),
                               strategy_kwargs=tuple(sorted(kw.items())), n_rounds=rounds,
                               seed=SEED)
    snaps = []
    loop = jfl.RoundLoop(exp, backend, callbacks=[
        lambda lp, rec: snaps.append(_np(lp.backend.params))])
    loop.run()
    return _np(params), loop, snaps


SLICES = [("hier_sfl", dict(dba="fl_priority", n_wavelengths=2, background_load=0.3), 2),
          ("sfl_two_step", dict(dba="fl_priority", n_wavelengths=2, background_load=0.3), 1),
          ("classical", dict(dba="fl_priority", n_wavelengths=2, background_load=0.3), 1)]


@pytest.mark.parametrize("mode,pon_kw,n_pons", SLICES, ids=[s[0] for s in SLICES])
def test_slice_matches_reference_round_loop(mode, pon_kw, n_pons):
    """launch.run against the JAX RoundLoop for 3 rounds from the
    reference's init: every transport column exact (the forest's
    per-segment Mbits too), the RNG stream after the run, parameters
    within 1e-4 after every round; on the CPU no kernel launches."""
    skw = {"n_pons": n_pons}
    init, jloop, jsnaps = _jax_slice(mode, pon_kw, skw, n_pons)
    before = segment_agg_reduce.launches
    loop = launch.run(n_rounds=0, n_selected=5 * n_pons, seed=SEED, modes=(mode,),
                      pon=tpon.PonConfig(n_onus=4, clients_per_onu=5, n_pons=n_pons,
                                         **pon_kw),
                      params=params_from_jax(init), device="cpu",
                      strategy_kwargs=skw)[mode]["loop"]
    for rnd in range(3):
        loop.run_round(rnd)
        got = params_to_jax(loop.backend.params)
        for k, want in jsnaps[rnd].items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-4,
                                       err_msg=f"{k} after round {rnd}")
    assert segment_agg_reduce.launches == before
    for r, j in zip(loop.history, jloop.history, strict=True):
        assert [k for k in TRANSPORT if k in r] == [k for k in TRANSPORT if k in j]
        for key in TRANSPORT:
            if key in j:
                assert r[key] == j[key] and type(r[key]) is type(j[key]), (key, r[key], j[key])
        assert r["acc"] == pytest.approx(j["acc"], abs=0.02)
    assert loop.rng.integers(0, 1 << 30) == jloop.rng.integers(0, 1 << 30)
    if n_pons > 1:
        assert all(r["trunk_mbits"] in (0.0, tpon.MODEL_UPDATE_MBITS) for r in loop.history)


@pytest.mark.parametrize("dba", ["fifo", "tdma", "ipact", "fl_priority"])
def test_transport_backend_sweep_rows_equal_reference(dba):
    """Transport-only RoundLoops over a 3-PON forest (2 wavelengths,
    background load 0.3, failures and backups): every row, key for key,
    the reference's (the port's adds wall_s)."""
    counts = np.random.default_rng(1).integers(50, 400, 60).astype(np.float32)
    onu = np.arange(60) // 5
    pon_kw = dict(dba=dba, n_wavelengths=2, background_load=0.3)
    exp_kw = dict(overselect=0.25, p_crash=0.1, p_transient=0.1, seed=2)
    for name in ("hier_sfl", "sfl_two_step", "classical"):
        flc = dict(n_onus=4, clients_per_onu=5, n_pons=3, n_selected=12)
        jexp = jfl.ExperimentConfig(fl=jfedavg.FLConfig(pon=jpon.PonConfig(**pon_kw), **flc),
                                    strategy=name, **exp_kw)
        exp = fl.ExperimentConfig(fl=fedavg.FLConfig(pon=tpon.PonConfig(**pon_kw), **flc),
                                  strategy=name, **exp_kw)
        skw = fl.filter_strategy_kwargs(name, {"n_pons": 3})
        jloop = jfl.RoundLoop(jexp, jfl.TransportBackend(
            jfl.make_strategy(name, **skw), counts, onu))
        loop = fl.RoundLoop(exp, fl.TransportBackend(fl.make_strategy(name, **skw), counts, onu))
        jloop.run(4)
        loop.run(4)
        for r, j in zip(loop.history, jloop.history, strict=True):
            assert {k: v for k, v in r.items() if k != "wall_s"} == j, (name, r, j)
        assert loop.rng.integers(0, 1 << 30) == jloop.rng.integers(0, 1 << 30)


def test_hier_map_and_forest_config():
    """repro_torch.hier is the reference's map; FLConfig's forest fields and
    PON-major client ids are the reference's."""
    assert hier.__all__ == __import__("repro.hier", fromlist=["x"]).__all__
    kw = dict(n_onus=3, clients_per_onu=4, n_pons=5)
    flc, jflc = fedavg.FLConfig(**kw), jfedavg.FLConfig(**kw)
    assert (flc.n_clients, flc.total_onus) == (jflc.n_clients, jflc.total_onus) == (60, 15)
    assert np.array_equal(fedavg.onu_of_client(flc), jfedavg.onu_of_client(jflc))
    pon = fedavg.FLConfig(pon=tpon.PonConfig(n_pons=9, dba="tdma"), **kw).pon_config()
    jp = jfedavg.FLConfig(pon=jpon.PonConfig(n_pons=9, dba="tdma"), **kw).pon_config()
    assert dataclasses.asdict(pon) == dataclasses.asdict(jp) and pon.n_pons == 5
    exp = fl.ExperimentConfig().with_strategy("hier", n_pons=2, mu=0.1)
    jexp = jfl.ExperimentConfig().with_strategy("hier", n_pons=2, mu=0.1)
    assert exp.strategy_kwargs == jexp.strategy_kwargs
    assert exp.make_strategy() == fl.HierSfl(n_pons=2, mu=0.1)


# ------------------------------------------------------------ CLI round trips

def _reference_args(argv):
    ap = argparse.ArgumentParser()
    jfl.add_experiment_cli_args(ap)
    return ap.parse_known_args(argv)[0]


CLI = ["--dba", "fl_priority", "--wavelengths", "2", "--bg-load", "0.3", "--onus", "4",
       "--clients-per-onu", "5", "--n-pons", "2", "--sim-engine", "fast",
       "--metro-rate-mbps", "700", "--strategy", "hier_sfl", "--server-opt", "yogi"]


def test_femnist_cli_round_trip(monkeypatch):
    """launch.femnist's flags build the reference's PonConfig and strategy
    kwargs; --per-pon-selected sets N per PON; the knob defaults are None,
    as the reference's."""
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return {m: {"accs": [0.5], "involved": [3.0], "loop": None} for m in kw["modes"]}

    monkeypatch.setattr(launch, "run", fake_run)
    for argv in ([], CLI + ["--per-pon-selected", "6", "--fedprox-mu", "0.2"]):
        launch.main(argv + ["--rounds", "1", "--device", "cpu"])
        jargs = _reference_args(argv)
        assert dataclasses.asdict(seen["pon"]) == dataclasses.asdict(
            jpon.pon_config_from_args(jargs))
        assert seen["strategy_kwargs"] == jfl.strategy_kwargs_from_args(jargs)
        assert list(seen["modes"]) == jfl.comparison_modes(jargs.strategy)
        name = seen["modes"][-1]
        assert (fl.filter_strategy_kwargs(name, seen["strategy_kwargs"])
                == jfl.filter_strategy_kwargs(name, jfl.strategy_kwargs_from_args(jargs)))
    assert seen["n_selected"] == 12 and seen["modes"] == ["classical", "hier_sfl"]
    ap = argparse.ArgumentParser()
    fl.add_strategy_cli_args(ap)
    assert vars(ap.parse_args([])) == {"fedprox_mu": None, "server_opt": None,
                                       "server_lr": None}


def test_train_cli_round_trip(monkeypatch):
    """launch.train's flags reach run() as the reference's driver builds its
    experiment: the PonConfig, the forest, the strategy and its kwargs."""
    seen = {}
    # run's stand-in returns its (empty) result dict, which main reads
    monkeypatch.setattr(train, "run", lambda arch, **kw: seen.update(kw, arch=arch) or {})
    train.main(["--smoke", "--device", "cpu"] + CLI)
    jexp = jfl.experiment_config_from_args(_reference_args(CLI))
    assert dataclasses.asdict(seen["pon"]) == dataclasses.asdict(jexp.fl.pon)
    assert (seen["onus"], seen["clients_per_onu"], seen["n_pons"]) == (
        jexp.fl.n_onus, jexp.fl.clients_per_onu, jexp.fl.n_pons)
    skw = fl.filter_strategy_kwargs(seen["strategy"], dict(seen["strategy_kwargs"],
                                                           compress=seen["compress"]))
    assert (fl.canonical_name(seen["strategy"]), tuple(sorted(skw.items()))) == (
        jexp.strategy, jexp.strategy_kwargs)
