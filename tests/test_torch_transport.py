"""repro_torch's numpy copies — data, selection, failures and the PON
closed form — against the reference, exactly: the port consumes the same
RNG draws, so the transport columns of its History equal the reference's."""
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import fl as jfl  # noqa: E402
from repro.core import fedavg as jfedavg  # noqa: E402
from repro.core import selection as jselection  # noqa: E402
from repro.core.fedavg import FLConfig as JFLConfig  # noqa: E402
from repro.data import femnist as jfemnist  # noqa: E402
from repro.fl.loop import _transport_stage as jax_transport_stage  # noqa: E402
from repro.pon import PonConfig as JPonConfig  # noqa: E402
from repro.pon import round_times as jround_times  # noqa: E402
from repro_torch import fl  # noqa: E402
from repro_torch.core import fedavg, selection  # noqa: E402
from repro_torch.data import femnist  # noqa: E402
from repro_torch.fl.loop import _transport_stage  # noqa: E402
from repro_torch.pon import PonConfig, round_times  # noqa: E402


def test_femnist_generate_equals_reference():
    cfg = dict(n_clients=12, seed=9)
    clients, eval_set = femnist.generate(femnist.FemnistConfig(**cfg))
    jclients, jeval = jfemnist.generate(jfemnist.FemnistConfig(**cfg))
    assert len(clients) == len(jclients)
    for a, b in zip(clients + [eval_set], jclients + [jeval]):
        for k in ("images", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert np.array_equal(femnist.sample_counts(clients),
                          jfemnist.sample_counts(jclients))
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    a = femnist.client_minibatches(r1, clients[3], 5, 7)
    b = jfemnist.client_minibatches(r2, jclients[3], 5, 7)
    assert all(np.array_equal(a[k], b[k]) for k in ("images", "labels"))


@pytest.mark.parametrize("overselect", [0.0, 0.5])
def test_select_clients_is_exact(overselect):
    r1, r2 = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(3):
        assert np.array_equal(
            selection.select_clients(r1, 320, 48, overselect),
            jselection.select_clients(r2, 320, 48, overselect))


@pytest.mark.parametrize("mode", ["classical", "sfl"])
@pytest.mark.parametrize("queueing", [False, True])
@pytest.mark.parametrize("seed", [0, 17])
def test_round_times_equals_reference_and_rng_state(mode, queueing, seed):
    """The closed form == the reference's round_times (its event simulator
    at the paper defaults), bit for bit, leaving the RNG in the same state."""
    rng = np.random.default_rng(3)
    onu = np.arange(320) // 20
    k = rng.integers(50, 400, 320)
    sel = np.random.default_rng(seed + 99).choice(320, 128, replace=False)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    a = round_times(PonConfig(sfl_queueing=queueing), r1, sel, onu, k, mode)
    b = jround_times(JPonConfig(sfl_queueing=queueing), r2, sel, onu, k, mode)
    for key in ("ready", "t_done", "involved"):
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key
    assert a["upstream_mbits"] == b["upstream_mbits"]
    assert a["upload_s"] == b["upload_s"]
    assert r1.integers(0, 1 << 30) == r2.integers(0, 1 << 30)


@pytest.mark.parametrize("mode", ["classical", "sfl"])
def test_round_transport_equals_reference(mode):
    """fedavg.round_transport: FLConfig's topology and deadline override
    an explicit PonConfig's, as in the reference. The port takes the mode
    as an argument (a Strategy's transport), the reference from FLConfig."""
    kw = dict(n_onus=4, clients_per_onu=5, n_selected=10, sync_threshold_s=12.0)
    flc = fedavg.FLConfig(pon=PonConfig(n_onus=9, sync_threshold_s=99.0), **kw)
    jflc = JFLConfig(pon=JPonConfig(n_onus=9, sync_threshold_s=99.0), mode=mode, **kw)
    counts = np.random.default_rng(1).integers(20, 300, 20).astype(np.float32)
    sel = np.random.default_rng(2).choice(20, 10, replace=False)
    a = fedavg.round_transport(flc, np.random.default_rng(0), sel, counts, mode=mode)
    b = jfedavg.round_transport(jflc, np.random.default_rng(0), sel, counts)
    assert np.array_equal(a["involved"], b["involved"])
    assert np.array_equal(a["t_done"], b["t_done"])
    assert a["upstream_mbits"] == b["upstream_mbits"]
    assert np.array_equal(fedavg.onu_of_client(flc), np.arange(20) // 5)


def test_transport_stage_with_failures_equals_reference():
    """selection → crash → transport → transient mask, with backups and
    both failure kinds, matches the reference's stage round for round."""
    counts = np.random.default_rng(0).integers(50, 400, 20).astype(np.float32)
    onu = np.arange(20) // 5
    kw = dict(overselect=0.5, p_crash=0.2, p_transient=0.2, seed=3)
    for name in ("sfl_two_step", "classical"):
        jexp = jfl.ExperimentConfig(
            fl=JFLConfig(n_onus=4, clients_per_onu=5, n_selected=8),
            strategy=name, **kw)
        exp = fl.ExperimentConfig(
            fl=fedavg.FLConfig(n_onus=4, clients_per_onu=5, n_selected=8), **kw)
        jbackend = jfl.TransportBackend(jexp.make_strategy(), counts, onu)
        backend = types.SimpleNamespace(strategy=fl.make_strategy(name),
                                        sample_counts=counts, onu_ids=onu)
        jfail, fail = jexp.make_failure_model(), exp.make_failure_model()
        r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
        masked = 0
        for rnd in range(6):
            sel, mask, rt = _transport_stage(exp, backend, fail, r1, rnd)
            jsel, jmask, jrt = jax_transport_stage(jexp, jbackend, jfail, r2, rnd)
            assert np.array_equal(sel, jsel) and np.array_equal(mask, jmask)
            assert rt["upstream_mbits"] == jrt["upstream_mbits"]
            assert np.array_equal(rt["t_done"], jrt["t_done"])
            masked += int((mask == 0).sum())
        assert masked > 0, name       # the failure path was exercised
