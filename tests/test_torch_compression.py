"""The compressed uplink of repro_torch against the reference's
``repro.core.compression`` and compressed RoundLoop: the per-row forms,
wire accounting, the stateful EF/noise seam, the wire-scaled transport and
the slice as a whole (launch.run with --compress against the JAX RoundLoop).

Wherever the reference draws noise from a key, the test draws it with
``jax.random`` and hands it to the port through
``CompressionState.uniform_noise`` (the ``jax_noise`` fixture), so both
sides round with the same numbers. On the CPU every kernel wrapper runs
its plain version; the kernels themselves are held against those on the
card (tests/test_torch_kernels.py, chip_smoke.py)."""
import math
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import fl as jfl  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import compression as jc  # noqa: E402
from repro.core.fedavg import FLConfig as JFLConfig  # noqa: E402
from repro.fl.loop import _transport_stage as jax_transport_stage  # noqa: E402
from repro.models import femnist_cnn as jcnn  # noqa: E402
from repro.pon import PonConfig as JPonConfig  # noqa: E402
from repro.pon import round_times as jround_times  # noqa: E402
from repro_torch import configs, fl  # noqa: E402
from repro_torch.core import compression as tc  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.fl import strategy as tstrategy  # noqa: E402
from repro_torch.fl.backends import backend_wire_scale  # noqa: E402
from repro_torch.fl.loop import _transport_stage  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    dequantize_rows,
    quantize_rows,
    segment_agg_reduce,
    segment_agg_reduce_quant,
    segment_agg_reduce_quant_plain,
    topk_mask_rows,
)
from repro_torch.models import femnist_cnn  # noqa: E402
from repro_torch.pon import PonConfig, round_times  # noqa: E402
from test_torch_fl import TRANSPORT_COLUMNS, _jax_loop, _port_rounds  # noqa: E402

KERNELS = (segment_agg_reduce, segment_agg_reduce_quant, quantize_rows,
           dequantize_rows, topk_mask_rows)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes, each beside JAX's own
    thread pool; torch's intra-op threads would only oversubscribe the
    cores, so these CPU tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_noise(call, shapes, seed=0):
    """The reference's noise for its roundtrip call number ``call``:
    fold_in(PRNGKey(seed), call), split per leaf, uniform of each leaf's
    shape. Shapes are the port's; a stacked conv weight (R, O, I, H, W) is
    drawn in the reference's (R, H, W, I, O) and transposed."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), call)
    out = []
    for k, shape in zip(jax.random.split(key, len(shapes)), shapes):
        if len(shape) == 5:
            R, O, I, H, W = shape
            u = np.asarray(jax.random.uniform(k, (R, H, W, I, O), jnp.float32)
                           ).transpose(0, 4, 3, 1, 2)
        else:
            u = np.asarray(jax.random.uniform(k, tuple(shape), jnp.float32))
        out.append(torch.from_numpy(np.array(u)))
    return out


@pytest.fixture
def jax_noise(monkeypatch):
    def uniform_noise(self, call, shapes):
        return [u.to(self.device) for u in _jax_noise(call, shapes, self.seed)]
    monkeypatch.setattr(tc.CompressionState, "uniform_noise", uniform_noise)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- row forms

@pytest.mark.parametrize("shape", [(4, 6, 2), (16, 62), (3, 5, 5, 1, 4), (5,)])
@pytest.mark.parametrize("bits", [8, 4])
def test_row_forms_match_reference_bit_for_bit(shape, bits):
    rng = np.random.default_rng(sum(shape) + bits)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-4, 4)).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    noise = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    q, s = tc.quantize_rows(_t(x), _t(noise), bits)
    jq, js = jc.quantize_rows(jnp.asarray(x), key, bits)
    assert q.shape == shape and _eq(q, jq) and _eq(s, js)
    assert _eq(tc.dequantize_rows(q, s), jc.dequantize_rows(jq, js))
    for frac in (0.01, 0.3, 1.0):
        assert _eq(tc.topk_rows(_t(x), frac), jc.topk_rows(jnp.asarray(x), frac))


@pytest.mark.parametrize("scheme", ["int8", "int4", "topk"])
def test_roundtrip_rows_leaf_with_residual_and_silent_rows(scheme):
    """The leaf step of the compressed transport (x + err → compress →
    decompress, masked rows send nothing and keep their residual)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 3, 7)).astype(np.float32)
    err = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    spec = tc.CompressionSpec(scheme, topk_frac=0.2, error_feedback=True)
    jspec = jc.CompressionSpec(scheme, topk_frac=0.2, error_feedback=True)
    sent, new_err = spec.roundtrip_rows_leaf(_t(x), _t(noise), err=_t(err),
                                             row_mask=_t(mask))
    jsent, jnew = jspec.roundtrip_rows_leaf(jnp.asarray(x), key, err=jnp.asarray(err),
                                            row_mask=jnp.asarray(mask))
    assert _eq(sent, jsent) and _eq(new_err, jnew)
    assert not sent[1].any() and _eq(new_err[1], err[1])


@pytest.mark.parametrize("C,N,n_seg,bits", [(14, 37, 4, 8), (128, 2048, 16, 4), (5, 1, 7, 8)])
def test_fused_plain_version_matches_segment_aggregate_then_quantize(C, N, n_seg, bits):
    """The fused kernel's plain version against the reference's θ
    (segment_aggregate) then quantize_rows with the same noise: q within
    one level, scales rtol 1e-5 (θ is summed in another order)."""
    rng = np.random.default_rng(C + N)
    x = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.uniform(1, 80, C).astype(np.float32)
    m = (rng.random(C) > 0.3).astype(np.float32)
    onu = rng.integers(0, n_seg, C)
    key = jax.random.PRNGKey(C)
    noise = np.asarray(jax.random.uniform(key, (n_seg, N), jnp.float32))
    _, thetas, _ = jagg.segment_aggregate({"x": jnp.asarray(x)}, jnp.asarray(w),
                                          jnp.asarray(m), jnp.asarray(onu), n_seg)
    jq, js = jc.quantize_rows(thetas["x"], key, bits)
    q, s = segment_agg_reduce_quant(_t(x), _t(w * m), onu, n_seg, _t(noise), bits)
    assert q.shape == (n_seg, N) and q.dtype == torch.int8
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    assert np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32)).max() <= 1
    zq, zs = segment_agg_reduce_quant_plain(torch.zeros((0, N)), torch.zeros(0),
                                            np.zeros(0, np.int64), n_seg,
                                            torch.zeros((n_seg, N)), bits)
    assert not zq.any() and bool((zs == 1.0).all())


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_fused_and_unfused_theta_routes_agree(scheme, jax_noise):
    """roundtrip_segments (the fused aggregate + quantize) == θ by
    segment_agg_reduce, then roundtrip: the same noise call, the same θ̂."""
    rng = np.random.default_rng(4)
    tree = {"w": _t(rng.normal(size=(12, 3, 5)).astype(np.float32)),
            "b": _t(rng.normal(size=(12, 5)).astype(np.float32))}
    wm = _t(rng.uniform(1, 50, 12).astype(np.float32))
    onu = rng.integers(0, 4, 12)
    mask = np.array([True, False, True, True])
    a = tc.CompressionState(tc.CompressionSpec(scheme))
    fused = a.roundtrip_segments("theta", tree, wm, onu, 4, row_mask=mask)
    b = tc.CompressionState(tc.CompressionSpec(scheme))
    thetas = {k: segment_agg_reduce(x.reshape(12, -1), wm, onu, 4).reshape((4,) + x.shape[1:])
              for k, x in tree.items()}
    unfused = b.roundtrip("theta", thetas, row_mask=mask)
    assert list(fused) == list(tree) and a._calls == b._calls == 1
    for k in tree:
        assert torch.equal(fused[k], unfused[k]) and not fused[k][1].any()


# ---------------------------------------------------------- wire accounting

def _trees(full):
    """The CNN's params: the reference's shapes (eval_shape) and the port's
    tensors (conv weights in another layout, the same sizes)."""
    cfg = jconfigs.get("femnist_cnn")
    cfg = cfg if full else cfg.reduced()
    jtree = jax.eval_shape(lambda: jcnn.init_params(cfg, jax.random.PRNGKey(0))[0])
    tcfg = configs.get("femnist_cnn")
    tcfg = tcfg if full else tcfg.reduced()
    return jtree, femnist_cnn.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("full", [False, True])
def test_wire_accounting_equals_reference(full):
    jtree, tree = _trees(full)
    assert tc.raw_bytes(tree) == jc.raw_bytes(jtree)
    if full:
        assert tc.raw_bytes(tree) == 4 * 6_603_710
    for scheme in tc.SCHEMES:
        for frac in (0.01, 0.1, 1.0):
            assert (tc.compressed_bytes(tree, scheme, topk_frac=frac)
                    == jc.compressed_bytes(jtree, scheme, topk_frac=frac))
            spec = tc.CompressionSpec(scheme, topk_frac=frac)
            jspec = jc.CompressionSpec(scheme, topk_frac=frac)
            assert spec.wire_scale(tree) == jspec.wire_scale(jtree)
            assert spec.wire_scale() == jspec.wire_scale()
    for scheme in ("int8", "int4"):
        assert tc.scheme_bits(scheme) == jc.scheme_bits(scheme)
        assert tc._qmax(tc.scheme_bits(scheme)) == jc._qmax(jc.scheme_bits(scheme))


@pytest.mark.parametrize("kw", [dict(scheme="zstd"), dict(scheme="topk", topk_frac=0.0),
                                dict(scheme="topk", topk_frac=1.5)])
def test_spec_validation_errors_equal_reference(kw):
    with pytest.raises(ValueError) as got:
        tc.CompressionSpec(**kw)
    with pytest.raises(ValueError) as want:
        jc.CompressionSpec(**kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown compression scheme"):
        tc.compressed_bytes({}, "zstd")


# ------------------------------------------------------- CompressionState

def _rows_tree(rng, rows):
    return {"w": rng.normal(size=(rows, 6, 2)).astype(np.float32),
            "b": rng.normal(size=(rows, 3)).astype(np.float32)}


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _eq(got[k], want[k]), k


@pytest.mark.parametrize("scheme", ["int8", "int4", "topk"])
def test_state_roundtrips_match_reference_with_replayed_noise(scheme, jax_noise):
    """Three θ-tier calls (silent rows) and three per-client calls (client
    ids repeated across calls, masked rows), EF on: outputs and residuals
    bit-exact with the reference's state, and the same call counter
    (top-k never advances it)."""
    rng = np.random.default_rng(3)
    spec = dict(topk_frac=0.25, error_feedback=True)
    st, jst = tc.CompressionState(tc.CompressionSpec(scheme, **spec)), \
        jc.CompressionState(jc.CompressionSpec(scheme, **spec))
    masks = [np.array([1, 1, 0, 1], np.float32), np.ones(4, np.float32),
             np.array([0, 1, 1, 0], np.float32)]
    for m in masks:
        tree = _rows_tree(rng, 4)
        out = st.roundtrip("theta", {k: _t(v) for k, v in tree.items()}, row_mask=m > 0)
        jout = jst.roundtrip("theta", {k: jnp.asarray(v) for k, v in tree.items()},
                             row_mask=jnp.asarray(m) > 0)
        assert list(out) == list(tree)
        _assert_trees_equal(out, jout)
        _assert_trees_equal(st._tier_err["theta"], jst._tier_err["theta"])
    for ids, m in (([5, 9, 2], [1, 1, 0]), ([9, 5, 5], [1, 1, 0]), ([2, 7, 9], [1, 0, 1])):
        tree = _rows_tree(rng, 3)
        m = np.asarray(m, np.float32)
        out = st.roundtrip_clients(ids, {k: _t(v) for k, v in tree.items()}, row_mask=m)
        jout = jst.roundtrip_clients(ids, {k: jnp.asarray(v) for k, v in tree.items()},
                                     row_mask=jnp.asarray(m))
        _assert_trees_equal(out, jout)
        assert sorted(st._client_err) == sorted(jst._client_err)
        for cid in jst._client_err:
            _assert_trees_equal(st._client_err[cid], jst._client_err[cid])
    assert st._calls == jst._calls == (0 if scheme == "topk" else 6)


def test_state_noise_is_seeded_and_advances():
    """The default noise: the same seed repeats, successive calls differ,
    and --compress none needs no state at all."""
    tree = {k: _t(v) for k, v in _rows_tree(np.random.default_rng(0), 4).items()}
    outs = [tc.CompressionState(tc.CompressionSpec("int8"), seed=3).roundtrip("theta", tree)
            for _ in range(2)]
    _assert_trees_equal(outs[0], outs[1])
    st = tc.CompressionState(tc.CompressionSpec("int8"), seed=3)
    first, second = st.roundtrip("theta", tree), st.roundtrip("theta", tree)
    assert any(not torch.equal(first[k], second[k]) for k in tree)
    inactive = tc.CompressionState(tc.CompressionSpec("none"))
    assert inactive.roundtrip("theta", tree) is tree and inactive._calls == 0


# ----------------------------------------------------- strategy and backend

def test_make_strategy_passes_fields_and_warns_once_on_unknown_keys(monkeypatch):
    monkeypatch.setattr(tstrategy, "_WARNED_DROPPED", set())
    s = fl.make_strategy("sfl", compress="topk", topk_frac=0.1, error_feedback=True)
    assert s.compression_spec() == tc.CompressionSpec("topk", 0.1, True)
    assert fl.make_strategy("classical").compression_spec().active is False
    assert fl.make_strategy("classical", server_lr=0.5).server_lr == 0.5
    with pytest.warns(UserWarning, match=r"dropped unknown kwargs \['mu'\]"):
        fl.make_strategy("classical", mu=0.1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fl.make_strategy("classical", mu=0.1)          # once per name


def test_backend_owns_state_only_when_active():
    cfg = configs.get("femnist_cnn").reduced()
    params = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def mk(**kw):
        return fl.ClientStackedBackend(fedavg.FLConfig(), fl.make_strategy("sfl", **kw),
                                       params, [], {}, femnist_cnn.loss_fn,
                                       sample_counts=np.ones(320), onu_ids=np.zeros(320, int))
    assert mk()._comp is None and backend_wire_scale(mk()) == 1.0
    b = mk(compress="topk", topk_frac=0.1, error_feedback=True)
    assert b._comp.spec.error_feedback and b._comp.device == torch.device("cpu")
    assert backend_wire_scale(b) == tc.CompressionSpec("topk", 0.1).wire_scale(params)


# ------------------------------------------------- wire-scaled transport

@pytest.mark.parametrize("mode", ["classical", "sfl"])
@pytest.mark.parametrize("scale", [1 / 4, 1 / 8, 0.0201])
def test_scaled_model_mbits_against_event_simulator(mode, scale):
    """The closed form billing a compressed model == the reference's event
    simulator (one wavelength, FIFO, no background load) handed the same
    model_mbits: involvement under the deadline moves with the wire size."""
    onu = np.arange(320) // 20
    k = np.random.default_rng(3).integers(50, 400, 320)
    sel = np.random.default_rng(5).choice(320, 128, replace=False)
    mbits = PonConfig().model_mbits * scale
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    a = round_times(PonConfig(model_mbits=mbits), r1, sel, onu, k, mode)
    b = jround_times(JPonConfig(model_mbits=mbits), r2, sel, onu, k, mode)
    for key in ("involved", "t_done"):
        assert _eq(a[key], b[key]), key
    assert a["upstream_mbits"] == b["upstream_mbits"]
    assert r1.integers(0, 1 << 30) == r2.integers(0, 1 << 30)
    full = round_times(PonConfig(), np.random.default_rng(1), sel, onu, k, mode)
    assert a["involved"].sum() >= full["involved"].sum()


@pytest.mark.parametrize("compress", ["int8", "int4", "topk"])
def test_transport_stage_bills_the_wire_like_reference(compress):
    """The loop's transport stage with compression: the scaled model size,
    the rows' wire_mbits/compress keys and the upstream bill equal the
    reference's, round for round."""
    counts = np.random.default_rng(0).integers(50, 400, 20).astype(np.float32)
    onu = np.arange(20) // 5
    jtree, tree = _trees(False)
    for name in ("sfl_two_step", "classical"):
        jexp = jfl.ExperimentConfig(fl=JFLConfig(n_onus=4, clients_per_onu=5,
                                                 n_selected=8), strategy=name, seed=3)
        exp = fl.ExperimentConfig(fl=fedavg.FLConfig(n_onus=4, clients_per_onu=5,
                                                     n_selected=8), seed=3)
        jbackend = types.SimpleNamespace(strategy=jfl.make_strategy(name, compress=compress),
                                         params=jtree, sample_counts=counts, onu_ids=onu)
        backend = types.SimpleNamespace(strategy=fl.make_strategy(name, compress=compress),
                                        params=tree, sample_counts=counts, onu_ids=onu)
        r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
        for rnd in range(4):
            sel, mask, rt = _transport_stage(exp, backend, None, r1, rnd)
            jsel, jmask, jrt = jax_transport_stage(jexp, jbackend, None, r2, rnd)
            assert _eq(sel, jsel) and _eq(mask, jmask)
            for key in ("upstream_mbits", "wire_mbits", "compress"):
                assert rt[key] == jrt[key], key
    assert "wire_mbits" not in fedavg.round_transport(
        exp.fl, np.random.default_rng(0), np.arange(4), counts, mode="sfl")


# ---------------------------------------------------- the slice as a whole

CASES = [("sfl_two_step", dict(compress="int8")),                       # fused θ route
         ("sfl_two_step", dict(compress="int4", error_feedback=True)),
         ("classical", dict(compress="topk", topk_frac=0.1)),
         ("classical", dict(compress="int8", error_feedback=True))]


@pytest.mark.parametrize("mode,kw", CASES, ids=[f"{m}-{k['compress']}"
                                                 + ("-ef" if k.get("error_feedback") else "")
                                                 for m, k in CASES])
def test_compressed_slice_matches_reference_round_loop(mode, kw, jax_noise, monkeypatch):
    """launch.run with compression against the JAX RoundLoop (reduced CNN,
    4 ONUs × 5 clients, N = 10, 3 rounds, the reference's init bridged):
    transport columns, wire_mbits and compress exact every round, and the
    RNG stream after the run; acc within 0.02 and eval_loss rtol 1e-3.

    Parameters after round 1: θ (or a client's δ) is summed in another
    order than the reference's, so an element within an ulp of a rounding
    or top-k threshold boundary may land on the other side. Each element is
    therefore held to one quantization level of every row it sums, at its
    weight (Σ_r level_r · w_r / K, with level_r the row's scale, or its
    threshold for top-k, and w_r = 1 for a θ row) plus 1e-5, and at most
    0.1% of a leaf (at least one element) may be off by more than 1e-5."""
    levels, seen = {}, {}
    real_dequant, real_topk, real_agg = tc._dequantize_kernel, tc.topk_mask_rows, fedavg.aggregate

    def spy_dequant(q, s, mask=None):
        levels.setdefault("rows", []).append(s.clone())
        return real_dequant(q, s, mask)

    def spy_topk(x, t, mask=None):
        levels.setdefault("rows", []).append(t.clone())
        return real_topk(x, t, mask)

    def spy_agg(deltas, weights, mask, onu_ids, n_onus, mode, **kwargs):
        agg, stats = real_agg(deltas, weights, mask, onu_ids, n_onus, mode, **kwargs)
        seen.setdefault("K", float(stats["K"]))
        seen.setdefault("w", np.asarray(weights, np.float64))
        seen.setdefault("names", sorted(deltas))
        return agg, stats

    monkeypatch.setattr(tc, "_dequantize_kernel", spy_dequant)
    monkeypatch.setattr(tc, "topk_mask_rows", spy_topk)
    monkeypatch.setattr(fedavg, "aggregate", spy_agg)
    init, jloop, jsnaps = _jax_loop(mode, **kw)
    before = [k.launches for k in KERNELS]
    loop, snaps = _port_rounds(mode, init, **kw)
    assert [k.launches for k in KERNELS] == before      # CPU: the plain versions
    jspec = jloop.backend.strategy.compression_spec()
    for r, j in zip(loop.history, jloop.history, strict=True):
        for key in TRANSPORT_COLUMNS + ("wire_mbits", "compress"):
            assert r[key] == j[key], (key, r[key], j[key])
        assert r["compress"] == kw["compress"]
        assert r["wire_mbits"] == (PonConfig().model_mbits
                                   * jspec.wire_scale(jloop.backend.params))
        assert r["acc"] == pytest.approx(j["acc"], abs=0.02)
        assert r["eval_loss"] == pytest.approx(j["eval_loss"], rel=1e-3)
    assert loop.rng.integers(0, 1 << 30) == jloop.rng.integers(0, 1 << 30)
    assert loop.backend._comp._calls == jloop.backend._comp._calls

    # round 1: 8 leaves in sorted order, the first 8 spied calls
    rows = levels["rows"][:len(seen["names"])]
    w = seen["w"] if mode == "classical" else None
    for name, lv in zip(seen["names"], rows):
        lv = lv.double().numpy()
        bound = float((lv * (w[:len(lv)] if w is not None else 1.0)).sum()) / seen["K"]
        diff = np.abs(snaps[0][name] - jsnaps[0][name])
        assert diff.max() <= bound + 1e-5, (name, diff.max(), bound)
        assert (diff > 1e-5).sum() <= max(1, math.floor(1e-3 * diff.size)), name
