"""The slice as a whole: repro_torch.launch.femnist.run against the JAX
RoundLoop + ClientStackedBackend on the same seed, topology and initial
parameters (bridged), for both strategies. Setup as tests/test_fl.py's
RoundLoop pin: PonConfig(n_onus=4, clients_per_onu=5), N = 10, 3 rounds,
seed 0, reduced CNN, 8 local steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import fl as jfl  # noqa: E402
from repro.core import fedavg as jfedavg  # noqa: E402
from repro.core.fedavg import FLConfig as JFLConfig  # noqa: E402
from repro.data import femnist as jfemnist  # noqa: E402
from repro.models import femnist_cnn as jcnn  # noqa: E402
from repro.pon import PonConfig as JPonConfig  # noqa: E402
from repro_torch import configs, fl  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.core.fedavg import FLConfig  # noqa: E402
from repro_torch.data import femnist  # noqa: E402
from repro_torch.kernels import segment_agg_reduce  # noqa: E402
from repro_torch.launch import femnist as launch  # noqa: E402
from repro_torch.models import femnist_cnn  # noqa: E402
from repro_torch.pon import PonConfig  # noqa: E402

ROUNDS, N_SELECTED, SEED = 3, 10, 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes, each beside JAX's own
    thread pool; torch's intra-op threads would only oversubscribe the
    cores, so these CPU tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_loop(mode, full=False, n_selected=N_SELECTED, rounds=ROUNDS,
              client_chunk=16, **strategy_kw):
    """bench_accuracy.run's loop for one mode, keeping the loop object;
    returns (initial params, loop, the params after each round).
    ``strategy_kw`` (e.g. compress=...) go to the strategy."""
    cfg = jconfigs.get("femnist_cnn")
    cfg = cfg if full else cfg.reduced()
    pon = JPonConfig(n_onus=4, clients_per_onu=5)
    flc = JFLConfig(n_selected=n_selected, local_steps=8, local_lr=0.06,
                    pon=pon, n_onus=4, clients_per_onu=5,
                    client_chunk=client_chunk)
    clients, eval_set = jfemnist.generate(
        jfemnist.FemnistConfig(n_clients=flc.n_clients, seed=SEED + 7))
    params, _ = jcnn.init_params(cfg, jax.random.PRNGKey(SEED))
    backend = jfl.ClientStackedBackend(
        flc, jfl.make_strategy(mode, **strategy_kw), params, clients,
        jax.tree.map(jnp.asarray, eval_set),
        lambda p, b: jcnn.loss_fn(p, b),
        sample_counts=jfemnist.sample_counts(clients))
    exp = jfl.ExperimentConfig(fl=flc, strategy=jfl.canonical_name(mode),
                               n_rounds=rounds, seed=SEED)
    snaps = []
    loop = jfl.RoundLoop(exp, backend, callbacks=[
        lambda lp, rec: snaps.append(
            {k: np.asarray(v) for k, v in lp.backend.params.items()})])
    loop.run()
    return {k: np.asarray(v) for k, v in params.items()}, loop, snaps


def _port_rounds(mode, init, rounds=ROUNDS, **run_kw):
    """launch.run's loop for one mode from the bridged ``init``, driven
    round by round; returns (loop, the params after each round in the
    reference's layout). ``run_kw`` (e.g. compress=...) go to run."""
    loop = launch.run(n_rounds=0, n_selected=N_SELECTED, seed=SEED,
                      modes=(mode,), pon=PonConfig(n_onus=4, clients_per_onu=5),
                      params=params_from_jax(init), device="cpu",
                      **run_kw)[mode]["loop"]
    snaps = []
    for rnd in range(rounds):
        loop.run_round(rnd)
        snaps.append(params_to_jax(loop.backend.params))
    return loop, snaps


TRANSPORT_COLUMNS = ("round", "n_selected", "involved", "upstream_mbits",
                     "uplink_models")


@pytest.mark.parametrize("mode", ["sfl_two_step", "classical"])
def test_slice_matches_reference_round_loop(mode):
    """Transport columns and the RNG stream exact; accuracy and eval loss
    of every round within tolerance; parameters within atol 1e-4 after
    every round (f32 sums run in another order in the two packages, and
    the port's convolutions are an f32 matmul over unfolded patches)."""
    init, jloop, jsnaps = _jax_loop(mode)
    before = segment_agg_reduce.launches
    loop, snaps = _port_rounds(mode, init)
    assert segment_agg_reduce.launches == before      # CPU: the plain version
    rows, jrows = list(loop.history), list(jloop.history)
    assert len(rows) == len(jrows) == ROUNDS
    for r, j in zip(rows, jrows):
        for key in TRANSPORT_COLUMNS:
            assert r[key] == j[key], (key, r[key], j[key])
        assert "wire_mbits" not in r and "compress" not in r
        assert r["acc"] == pytest.approx(j["acc"], abs=0.02)
        assert r["eval_loss"] == pytest.approx(j["eval_loss"], rel=1e-3)
    assert loop.rng.integers(0, 1 << 30) == jloop.rng.integers(0, 1 << 30)
    assert len(snaps) == len(jsnaps) == ROUNDS
    for rnd, (got, want) in enumerate(zip(snaps, jsnaps)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=f"{k} after round {rnd}")


@pytest.mark.parametrize("mode", ["sfl_two_step", "classical"])
def test_full_width_rounds_match_reference(mode):
    """The full-width CNN (6,603,710 parameters), N = 4 in chunks of 4, two
    rounds from the reference's init through the port's RoundLoop and
    ClientStackedBackend: transport columns exact; both packages sit on the
    uniform-logit plateau (eval_loss = ln 62, acc = 1/62) that the
    reference's init and lr 0.06 reach at this width (ROADMAP.md Queue 3);
    parameters within atol 1e-4 after both rounds, so the plateau is the
    reference's and not a fault of the port."""
    init, jloop, _ = _jax_loop(mode, full=True, n_selected=4, rounds=2,
                               client_chunk=4)
    flc = FLConfig(n_selected=4, local_steps=8, local_lr=0.06,
                   pon=PonConfig(n_onus=4, clients_per_onu=5), n_onus=4,
                   clients_per_onu=5, client_chunk=4)
    clients, eval_set = femnist.generate(
        femnist.FemnistConfig(n_clients=flc.n_clients, seed=SEED + 7))
    backend = fl.ClientStackedBackend(
        flc, fl.make_strategy(mode), params_from_jax(init), clients,
        {k: torch.from_numpy(v) for k, v in eval_set.items()},
        femnist_cnn.loss_fn, sample_counts=femnist.sample_counts(clients))
    loop = fl.RoundLoop(fl.ExperimentConfig(fl=flc, seed=SEED), backend)
    loop.run(2)
    for r, j in zip(loop.history, jloop.history, strict=True):
        for key in ("round", "n_selected", "involved", "upstream_mbits",
                    "uplink_models"):
            assert r[key] == j[key], (key, r[key], j[key])
        for row in (r, j):
            assert row["involved"] > 0
            assert row["eval_loss"] == pytest.approx(np.log(62), abs=1e-3)
            assert row["acc"] == pytest.approx(1 / 62, abs=1e-6)
        assert r["eval_loss"] == pytest.approx(j["eval_loss"], rel=1e-3)
    got = params_to_jax(loop.backend.params)
    assert got["fc1_w"].shape == (3136, 2048)
    for k, v in jloop.backend.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["sfl", "classical"])
def test_apply_round_matches_reference(mode):
    rng = np.random.default_rng(5)
    C, n_onus = 12, 4
    params = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    deltas = {k: rng.normal(size=(C,) + v.shape).astype(np.float32)
              for k, v in params.items()}
    w = rng.uniform(1, 80, C).astype(np.float32)
    m = (rng.random(C) > 0.3).astype(np.float32)
    onu = rng.integers(0, n_onus, C)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tdeltas = {k: torch.from_numpy(v) for k, v in deltas.items()}
    new, stats = fedavg.apply_round(tparams, tdeltas, w, m, onu, n_onus, mode)
    # the strategy the RoundLoop runs computes the same update
    strategy = fl.make_strategy(mode)
    assert strategy.transport == mode
    agg, sstats = strategy.aggregate(tdeltas, w, m, onu, n_onus)
    snew, _ = strategy.server_update(tparams, agg, None)
    assert sstats["uplink_models"] == stats["uplink_models"]
    assert all(torch.equal(snew[k], new[k]) for k in params)
    jnew, jstats = jfedavg.apply_round(
        params, {k: jnp.asarray(v) for k, v in deltas.items()},
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(onu), n_onus, mode)
    assert stats["uplink_models"] == float(jstats["uplink_models"])
    assert stats["involved"] == float(jstats["involved"])
    for k in params:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   rtol=1e-5, atol=1e-5)


def _tiny_loop(**exp_kw):
    cfg = configs.get("femnist_cnn").reduced()
    flc = FLConfig(n_onus=2, clients_per_onu=3, n_selected=4, local_steps=2,
                   local_batch=4, client_chunk=4)
    clients, eval_set = femnist.generate(femnist.FemnistConfig(n_clients=6, seed=1))
    backend = fl.ClientStackedBackend(
        flc, fl.make_strategy("sfl"),
        femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
        clients, {k: torch.from_numpy(v) for k, v in eval_set.items()},
        femnist_cnn.loss_fn)
    return fl.RoundLoop(fl.ExperimentConfig(fl=flc, seed=4, **exp_kw), backend)


def test_resume_replays_the_rng_stream():
    """run(start_round=2) on a fresh loop replays rounds 0-1's draws, so
    round 2's transport and the stream after it match an uninterrupted run."""
    full = _tiny_loop()
    full.run(3)
    resumed = _tiny_loop()
    resumed.run(1, start_round=2)
    a, b = full.history.last(), resumed.history.last()
    for key in ("round", "involved", "upstream_mbits", "uplink_models"):
        assert a[key] == b[key], key
    assert full.rng.integers(0, 1 << 30) == resumed.rng.integers(0, 1 << 30)


def test_idle_rounds_carry_the_last_eval():
    """Every client transiently failed: no training, no aggregation."""
    loop = _tiny_loop(p_transient=1.0)
    before = segment_agg_reduce.launches
    hist = loop.run(2)
    assert hist.column("involved") == [0.0, 0.0]
    assert hist.column("acc") == [0.0, 0.0]
    assert "uplink_models" not in hist.last()
    assert segment_agg_reduce.launches == before


def test_entry_points_refuse_to_fall_back_without_cuda(monkeypatch):
    """device defaults to 'cuda'; without a card the port raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("femnist_cnn").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        femnist_cnn.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run(n_rounds=1, n_selected=2)


@pytest.mark.parametrize("mode", ["sfl", "classical"])
def test_server_lr_round_matches_reference(mode):
    """The base Strategy's ``server_lr`` (0.5 here) scales the mean delta as
    the reference's ``server_update`` does: make_strategy keeps the key,
    and one round's transport columns are exact and its parameters within
    the slice test's atol 1e-4 of the reference RoundLoop's."""
    import dataclasses
    strategy = fl.make_strategy(mode, server_lr=0.5)
    assert strategy.server_lr == 0.5 and fl.make_strategy(mode).server_lr == 1.0
    init, jloop, jsnaps = _jax_loop(mode, rounds=1, server_lr=0.5)
    loop = launch.run(n_rounds=0, n_selected=N_SELECTED, seed=SEED, modes=(mode,),
                      pon=PonConfig(n_onus=4, clients_per_onu=5),
                      params=params_from_jax(init), device="cpu")[mode]["loop"]
    loop.backend.strategy = dataclasses.replace(loop.backend.strategy, server_lr=0.5)
    rec = loop.run_round(0)
    for key in TRANSPORT_COLUMNS:
        assert rec[key] == jloop.history.last()[key], key
    got = params_to_jax(loop.backend.params)
    moved = 0.0
    for k, want in jsnaps[0].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-4, err_msg=k)
        moved = max(moved, float(np.abs(want - init[k]).max()))
    assert moved > 1e-3       # the round moved the parameters by more than the tolerance
