"""repro_torch's kernels — agg_reduce and the aggregation built on it, the
fused aggregate + quantize, and the compressed uplink's quantize,
dequantize and top-k mask — held against the reference: the Pallas kernels
in interpret mode, their jnp oracles (kernels/ref.py) and core.aggregation. On the CPU the wrapper runs its
plain PyTorch version; the CUDA kernel is held against that plain version
by the ``cuda``-marked test (and by chip_smoke.py) on the card.

JAX comes in through the ``jx`` fixture, so the ``cuda`` tests also run on
a machine that has a card but no JAX:
``python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_stub_library import stub_libraries  # noqa: E402

from repro_torch.core import aggregation  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    agg_reduce,
    agg_reduce_quant,
    dequantize_rows,
    dequantize_rows_plain,
    quantize_rows,
    quantize_rows_plain,
    segment_agg_reduce,
    segment_agg_reduce_plain,
    segment_agg_reduce_quant,
    segment_agg_reduce_quant_plain,
    topk_mask_rows,
    topk_mask_rows_plain,
)
from repro_torch.kernels import quantize as kq  # noqa: E402
from repro_torch.kernels.agg_reduce import segment_agg_reduce_absmax  # noqa: E402

# the module (the package exports its function of the same name)
ka = importlib.import_module("repro_torch.kernels.agg_reduce")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: jnp, core.aggregation, kernels.ref, the Pallas
    agg_reduce."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import jax

    from repro.core import aggregation as jagg
    from repro.kernels import quantize as pallas_quant
    from repro.kernels import ref
    from repro.kernels.agg_reduce import agg_reduce as pallas_agg_reduce
    from repro.kernels.agg_reduce import agg_reduce_quant as pallas_agg_reduce_quant
    return types.SimpleNamespace(jax=jax, jnp=jnp, agg=jagg, ref=ref,
                                 pallas_agg_reduce=pallas_agg_reduce,
                                 pallas_agg_reduce_quant=pallas_agg_reduce_quant,
                                 quant=pallas_quant)


@pytest.fixture
def card():
    """Skips a ``cuda`` test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(C, N, dtype, seed):
    """x, weights, mask as numpy f32 (x rounded to bf16 first if asked, so
    both packages see the same values)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, N)).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    w = (rng.uniform(size=C) * 50).astype(np.float32)
    m = (rng.random(C) > 0.4).astype(np.float32)
    return x, w, m


# test_kernels.py's agg_reduce sweep: shapes and tolerances
@pytest.mark.parametrize("C,N,dtype", [
    (1, 128, "float32"), (20, 5000, "float32"), (7, 333, "float32"),
    (20, 4096, "bfloat16"), (64, 10000, "float32"),
])
def test_agg_reduce_matches_pallas_and_ref(jx, C, N, dtype):
    x, w, m = _inputs(C, N, dtype, seed=C * N)
    jdt = jx.jnp.bfloat16 if dtype == "bfloat16" else jx.jnp.float32
    jxx, jw, jm = jx.jnp.asarray(x, jdt), jx.jnp.asarray(w), jx.jnp.asarray(m)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = agg_reduce(tx, torch.from_numpy(w), torch.from_numpy(m)).numpy()
    assert got.shape == (N,) and got.dtype == np.float32
    # f32 summation-order tolerance scales with Σ|w|·|x|
    tol = 1e-3 if dtype == "float32" else 0.25
    for want in (jx.pallas_agg_reduce(jxx, jw, jm, interpret=True),
                 jx.ref.agg_reduce_ref(jxx, jw, jm)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=tol)


@pytest.mark.parametrize("C,N,n_seg", [(14, 37, 4), (128, 2048, 16), (5, 1, 7)])
def test_segmented_matches_segment_aggregate_theta(jx, C, N, n_seg):
    """Unsorted ONU ids in selection order, masked rows, empty segments."""
    x, w, m = _inputs(C, N, "float32", seed=C + N + n_seg)
    onu = np.random.default_rng(n_seg).integers(0, n_seg, C)
    _, thetas, _ = jx.agg.segment_aggregate(
        {"x": jx.jnp.asarray(x)}, jx.jnp.asarray(w), jx.jnp.asarray(m),
        jx.jnp.asarray(onu), n_seg)
    got = segment_agg_reduce(torch.from_numpy(x), torch.from_numpy(w * m),
                             onu, n_seg)
    assert got.shape == (n_seg, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(thetas["x"]),
                               rtol=1e-4, atol=1e-3)


def test_segment_and_classical_aggregate_match_reference(jx):
    """The port's two-step and classical aggregation over a multi-leaf tree
    == the reference's (agg, θ, K) and the float64 oracle."""
    jnp = jx.jnp
    rng = np.random.default_rng(3)
    C, n_onus = 14, 4
    shapes = {"conv_w": (8, 1, 5, 5), "b": (3,), "fc_w": (12, 7)}
    tree = {k: rng.normal(size=(C,) + s).astype(np.float32) for k, s in shapes.items()}
    w = rng.uniform(1, 80, C).astype(np.float32)
    m = (rng.random(C) > 0.4).astype(np.float32)
    onu = rng.integers(0, n_onus, C)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}

    agg, thetas, K = aggregation.segment_aggregate(ttree, w, m, onu, n_onus)
    jagg, jthetas, jK = jx.agg.segment_aggregate(
        jtree, jnp.asarray(w), jnp.asarray(m), jnp.asarray(onu), n_onus)
    cagg, cK = aggregation.classical_aggregate(ttree, w, m)
    jcagg, _ = jx.agg.classical_aggregate(jtree, jnp.asarray(w), jnp.asarray(m))
    np.testing.assert_allclose(float(K), float(jK), rtol=1e-6)
    assert float(cK) == float(K)
    for k in tree:
        np.testing.assert_allclose(thetas[k].numpy(), np.asarray(jthetas[k]),
                                   rtol=1e-4, atol=1e-3)
        want, K64 = aggregation.numpy_weighted_mean(tree[k], w, m)
        assert np.isclose(K64, float(K))
        for got, ref_ in ((agg[k], jagg[k]), (cagg[k], jcagg[k])):
            assert got.shape == tree[k].shape[1:]
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("C,N", [(0, 300), (6, 0), (0, 0)])
def test_zero_length_guards(jx, C, N):
    """C = 0 (every client of an ONU crashed) and N = 0 give zeros, as the
    reference's guard does (agg_reduce.py:66)."""
    x = torch.zeros((C, N))
    w, m = torch.ones(C), torch.ones(C)
    got = agg_reduce(x, w, m)
    want = jx.pallas_agg_reduce(jx.jnp.zeros((C, N)), jx.jnp.ones(C),
                                jx.jnp.ones(C), interpret=True)
    assert got.shape == (N,) and np.array_equal(got.numpy(), np.asarray(want))
    seg = segment_agg_reduce(x, w, np.zeros(C, np.int64), 3)
    assert seg.shape == (3, N) and not seg.any()


def test_wrapper_rejects_bad_inputs_and_other_devices():
    x = torch.ones((4, 8))
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        segment_agg_reduce(x, torch.ones(4), np.array([0, 1, 2, 0]), 2)
    with pytest.raises(ValueError):
        segment_agg_reduce(x, torch.ones(3), np.zeros(4, np.int64), 1)
    # a tensor on neither the CPU nor a CUDA card: raise, never fall back
    with pytest.raises(ValueError, match="cuda or cpu"):
        segment_agg_reduce(x.to("meta"), torch.ones(4, device="meta"),
                           np.zeros(4, np.int64), 1)


# ------------------------------- the launch path, through a stand-in library

def _no_upload(table, device):
    raise AssertionError("a one-segment launch copied a table to the device")


@pytest.mark.parametrize("absmax", [False, True])
def test_one_segment_launch_hands_the_kernel_no_table(monkeypatch, absmax):
    """One segment (classical FedAvg): no CSR, no host-to-device copy, one
    allocation; the kernel is told so by a null table."""
    libs = stub_libraries(monkeypatch)
    monkeypatch.setattr(ka, "_upload", _no_upload)
    empties = []
    real_empty = torch.empty
    monkeypatch.setattr(ka.torch, "empty", lambda *a, **k: empties.append(a) or real_empty(*a, **k))
    x, wm = torch.zeros((16, 64)), torch.ones(16)
    amax = real_empty((1, 3)) if absmax else None
    out = ka._launch(x, wm, np.zeros(16, np.int64), 1, amax)
    entry = "segment_agg_reduce_absmax_f32" if absmax else "segment_agg_reduce_f32"
    assert libs["agg_reduce"].calls == [entry] and len(empties) == 1
    args = libs["agg_reduce"].args[0]
    assert args[:7] == (x.data_ptr(), wm.data_ptr(), None, 16, 1, 64, out.data_ptr())
    assert args[7:-1] == ((amax.data_ptr(), 3) if absmax else ())
    assert out.shape == (1, 64)


def _stable_csr(seg, n_seg):
    rows = sorted(range(len(seg)), key=lambda r: (seg[r], r))
    return rows + [sum(1 for s in seg if s < k) for k in range(n_seg + 1)]


@pytest.mark.parametrize("C,n_seg", [(7, 5), (128, 16), (129, 3), (40, 129)])
def test_segmented_launch_hands_the_kernel_the_stable_csr(monkeypatch, C, n_seg):
    """Unsorted segment ids: the kernel gets their stable row permutation
    and the segment offsets, copied once to the device."""
    libs = stub_libraries(monkeypatch)
    tables, uploads = [], []
    real_csr = ka._csr
    monkeypatch.setattr(ka, "_csr", lambda seg, n: tables.append(real_csr(seg, n)) or tables[-1])

    def upload(table, device):
        uploads.append(torch.from_numpy(table))
        return uploads[-1]
    monkeypatch.setattr(ka, "_upload", upload)
    seg = (np.arange(C) * 7 + 3) % n_seg
    x, wm = torch.zeros((C, 12)), torch.ones(C)
    for dtype, entry in ((torch.float32, "segment_agg_reduce_f32"),
                         (torch.bfloat16, "segment_agg_reduce_bf16")):
        ka._launch(x.to(dtype), wm, seg, n_seg)
        table = tables[-1]
        assert table.dtype == np.int32 and table.tolist() == _stable_csr(seg.tolist(), n_seg)
        assert libs["agg_reduce"].calls[-1] == entry
        args = libs["agg_reduce"].args[-1]
        assert args[2] == uploads[-1].data_ptr() and len(uploads) == len(tables)
        assert uploads[-1].tolist() == table.tolist()
        assert args[3:6] == (C, n_seg, 12)


def test_kernel_entries_bound_once(monkeypatch):
    """Each ctypes entry's argument types are set once, when its library
    loads, however many launches follow."""
    libs = stub_libraries(monkeypatch)
    monkeypatch.setattr(ka, "_upload", lambda table, device: torch.from_numpy(table))
    x, wm, u = torch.zeros((4, 8)), torch.ones(4), torch.zeros((4, 8))
    s, m = torch.ones(4), torch.ones(4)
    for _ in range(2):
        for xx in (x, x.bfloat16()):
            for n_seg in (1, 3):   # no table, a table
                ka._launch(xx, wm, np.arange(4) % n_seg, n_seg)
                ka._launch(xx, wm, np.arange(4) % n_seg, n_seg, torch.empty((n_seg, 1)))
            kq.launch_quantize(xx, u, s, 127.0)
            for row_mask in (None, m):
                kq._call(f"topk_mask_rows_{kq._SUFFIX[xx.dtype]}", xx.data_ptr(),
                         s.data_ptr(), kq._ptr(row_mask), 4, 8, u.data_ptr(), device=x.device)
        kq._call("dequantize_rows_i8", x.data_ptr(), s.data_ptr(), None, 4, 8, u.data_ptr(),
                 device=x.device)
    assert libs["agg_reduce"].bound == {name: 1 for name in ka._ENTRIES}
    assert libs["quantize"].bound == {name: 1 for name in kq._ENTRIES}
    assert len(libs["agg_reduce"].calls) == 16 and len(libs["quantize"].calls) == 14


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_cuda_kernel_matches_plain_version():
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(128, 1 << 16, 16, torch.float32), (128, 1 << 16, 1, torch.float32),
             (20, 100_003, 4, torch.float32), (64, 1 << 14, 8, torch.bfloat16),
             (3, 7, 2, torch.bfloat16)]
    for C, N, n_seg, dtype in cases:
        x = torch.randn((C, N), generator=gen, device="cuda").to(dtype)
        wm = torch.rand(C, generator=gen, device="cuda") * 50
        seg = np.random.default_rng(C).integers(0, n_seg, C)
        before = segment_agg_reduce.launches
        got = segment_agg_reduce(x, wm, seg, n_seg)
        torch.cuda.synchronize()
        assert segment_agg_reduce.launches == before + 1
        want = segment_agg_reduce_plain(x, wm, seg, n_seg)
        # f32 sums in another order: error scales with Σ|w·x| per output
        abs_sum = segment_agg_reduce_plain(x.abs(), wm, seg, n_seg)
        assert bool(((got - want).abs() <= 1e-3 + 1e-4 * abs_sum).all())
        # fixed sum order, no atomics: a second launch repeats bit for bit
        assert torch.equal(got, segment_agg_reduce(x, wm, seg, n_seg))


@pytest.mark.cuda
def test_cuda_segmented_csr(card):
    """Segmented launches, at the main path's 128 rows over 16 segments and
    with more rows or segments than that: within the plain version's
    Σ|w·x| bound, repeatable bit for bit, pass A's θ equal."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for C, n_seg in ((128, 16), (128, 128), (129, 16), (64, 129), (300, 7)):
        for N, dtype in ((65_536, torch.float32), (100_003, torch.float32),
                         (65_536, torch.bfloat16)):
            x = torch.randn((C, N), generator=gen, device="cuda").to(dtype)
            wm = torch.rand(C, generator=gen, device="cuda") * 50
            seg = np.random.default_rng(C + n_seg).integers(0, n_seg, C)
            got = segment_agg_reduce(x, wm, seg, n_seg)
            want = segment_agg_reduce_plain(x, wm, seg, n_seg)
            abs_sum = segment_agg_reduce_plain(x.abs(), wm, seg, n_seg)
            what = (C, n_seg, N, dtype)
            assert bool(((got - want).abs() <= 1e-3 + 1e-4 * abs_sum).all()), what
            assert torch.equal(got, segment_agg_reduce(x, wm, seg, n_seg)), what
            assert torch.equal(segment_agg_reduce_absmax(x, wm, seg, n_seg)[0], got), what


@pytest.mark.cuda
def test_cuda_one_segment_sweep(card):
    """One segment (the identity rows, no table) at row counts around
    multiples of the kernel's 4-row load batch and at the main path's N,
    in both input types and from a misaligned base (the scalar path):
    within the plain version's Σ|w·x| bound, repeatable bit for bit, and
    pass A's θ equal to segment_agg_reduce's."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for C in (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 33, 128):
        for N in (4, 62, 100_003, 3136 * 2048):
            for dtype in (torch.float32, torch.bfloat16):
                for offset in (0, 1):
                    flat = torch.randn(C * N + offset, generator=gen, device="cuda")
                    x = flat.to(dtype)[offset:].view(C, N)
                    wm = torch.rand(C, generator=gen, device="cuda") * 50
                    seg = np.zeros(C, np.int64)
                    got = segment_agg_reduce(x, wm, seg, 1)
                    want = segment_agg_reduce_plain(x, wm, seg, 1)
                    abs_sum = segment_agg_reduce_plain(x.abs(), wm, seg, 1)
                    what = (C, N, dtype, offset)
                    assert bool(((got - want).abs() <= 1e-3 + 1e-4 * abs_sum).all()), what
                    assert torch.equal(got, segment_agg_reduce(x, wm, seg, 1)), what
                    theta, _ = segment_agg_reduce_absmax(x, wm, seg, 1)
                    assert torch.equal(theta, got), what
                    torch.testing.assert_close(agg_reduce(x, wm, torch.ones_like(wm)),
                                               got[0], rtol=0, atol=0)
                    del flat, x, got, want, abs_sum, theta


# ---------------------------------------------------------------------------
# the compressed uplink: quantize, dequantize, top-k mask, fused agg + quant
# ---------------------------------------------------------------------------

def _jax_vector(jx, N, dtype, seed):
    """x (numpy f32, bf16-rounded if asked), its JAX array, a key, and the
    key's U[0, 1) noise (what the Pallas wrapper draws from it)."""
    x = (np.random.default_rng(seed).normal(size=N) * 10.0 ** (seed % 7 - 3)
         ).astype(np.float32)
    jdt = jx.jnp.bfloat16 if dtype == "bfloat16" else jx.jnp.float32
    jxx = jx.jnp.asarray(x).astype(jdt)
    key = jx.jax.random.PRNGKey(seed)
    noise = np.asarray(jx.jax.random.uniform(key, (N,), jx.jnp.float32))
    tx = torch.from_numpy(np.array(jxx.astype(jx.jnp.float32))).to(getattr(torch, dtype))
    return tx, jxx, key, torch.from_numpy(noise.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [1, 127, 8191, 8192, 100_001])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_dequantize_match_pallas_bit_for_bit(jx, bits, N, dtype):
    """quantize_intb (int8/int4) and dequantize_int8 against the Pallas
    kernels in interpret mode and the jnp oracle, given the same noise:
    q, scale and the dequantized values identical (test_kernels.py:88)."""
    tx, jxx, key, noise = _jax_vector(jx, N, dtype, seed=N + bits)
    q, s = kq.quantize_intb(tx, noise, bits)
    for jq, js in (jx.quant.quantize_intb(jxx, key, bits, interpret=True),
                   jx.ref.quantize_intb_ref(jxx, key, bits)):
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
    xd = kq.dequantize_int4(q, s) if bits == 4 else kq.dequantize_int8(q, s)
    want = jx.quant.dequantize_int8(jx.jnp.asarray(q.numpy()), jx.jnp.float32(float(s)),
                                    interpret=True)
    assert np.array_equal(xd.numpy(), np.asarray(want))
    assert float((xd - tx.float()).abs().max()) <= float(s) * 1.01


@pytest.mark.parametrize("N,frac", [(1, 0.5), (127, 0.01), (8192, 0.1), (100_001, 0.01)])
def test_topk_mask_matches_pallas_bit_for_bit(jx, N, frac):
    """topk_sparsify / topk_mask against the Pallas kernel and the oracle;
    ties at the threshold are all kept (test_kernels.py:155)."""
    import math
    tx, jxx, _, _ = _jax_vector(jx, N, "float32", seed=N)
    tx = torch.round(tx * 4) / 4          # many ties at the threshold
    jxx = jx.jnp.asarray(tx.numpy())
    k = max(1, min(N, math.ceil(frac * N)))
    got = kq.topk_sparsify(tx, k)
    for want in (jx.quant.topk_sparsify(jxx, k, interpret=True),
                 jx.ref.topk_sparsify_ref(jxx, k)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    t = kq.topk_threshold(tx, k)
    assert float(t) == float(jx.quant.topk_threshold(jxx, k))
    assert np.array_equal(kq.topk_mask(tx, t).numpy(),
                          np.asarray(jx.quant.topk_mask(jxx, float(t), interpret=True)))
    assert int((got != 0).sum()) >= min(k, int((tx != 0).sum()))


@pytest.mark.parametrize("C,N,bits", [(1, 1, 8), (7, 333, 4), (20, 5000, 8), (24, 4000, 4)])
def test_agg_reduce_quant_matches_pallas(jx, C, N, bits):
    """The fused aggregate + quantize against the Pallas kernel and the
    unfused oracle: scale rtol 1e-5, q within one level
    (test_kernels.py:167-181; the sums run in another order)."""
    jax, jnp = jx.jax, jx.jnp
    key = jax.random.PRNGKey(C * N + bits)
    ks = jax.random.split(key, 3)
    x = jax.random.normal(ks[0], (C, N), jnp.float32)
    w = jax.random.uniform(ks[1], (C,)) * 10
    m = (jax.random.uniform(ks[2], (C,)) > 0.3).astype(jnp.float32)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (N,), jnp.float32)).copy())
    q, s = agg_reduce_quant(*(torch.from_numpy(np.asarray(a).copy()) for a in (x, w, m)),
                            noise, bits)
    assert q.shape == (N,) and q.dtype == torch.int8
    for jq, js in (jx.pallas_agg_reduce_quant(x, w, m, key, bits=bits, interpret=True),
                   jx.ref.agg_reduce_quant_ref(x, w, m, key, bits)):
        assert np.isclose(float(s), float(js), rtol=1e-5)
        assert np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32)).max() <= 1


def test_compression_zero_length_guards(jx):
    """N = 0 and C = 0 return empty / zeros and scale 1.0, as the
    reference's guards do (test_kernels.py:184-201)."""
    jnp, key = jx.jnp, jx.jax.random.PRNGKey(0)
    e = torch.zeros(0)
    for bits in (8, 4):
        q, s = kq.quantize_intb(e, e, bits)
        jq, js = jx.quant.quantize_intb(jnp.zeros((0,)), key, bits, interpret=True)
        assert q.shape == jq.shape == (0,) and float(s) == float(js) == 1.0
    assert kq.dequantize_int8(torch.zeros(0, dtype=torch.int8), torch.tensor(1.0)).shape == (0,)
    assert kq.topk_sparsify(e, 5).shape == (0,)
    assert kq.topk_mask(e, 0.5).shape == (0,)
    assert kq.pack_int4(torch.zeros(0, dtype=torch.int8)).shape == (0,)
    assert kq.unpack_int4(torch.zeros(0, dtype=torch.uint8), 0).shape == (0,)
    for shape in ((0, 7), (3, 0)):
        q, s = agg_reduce_quant(torch.zeros(shape), torch.zeros(shape[0]),
                                torch.zeros(shape[0]), torch.zeros(shape[1]))
        jq, js = jx.pallas_agg_reduce_quant(jnp.zeros(shape), jnp.zeros((shape[0],)),
                                            jnp.zeros((shape[0],)), key, interpret=True)
        assert q.shape == jq.shape == (shape[1],) and float(s) == float(js) == 1.0
        assert not q.any()


@pytest.mark.parametrize("N", [1, 2, 7, 1000])
def test_int4_packing_equals_reference(jx, N):
    q = np.random.default_rng(N).integers(-7, 8, N).astype(np.int8)
    packed = kq.pack_int4(torch.from_numpy(q))
    jpacked = jx.quant.pack_int4(jx.jnp.asarray(q))
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(), np.asarray(jpacked))
    back = kq.unpack_int4(packed, N)
    assert np.array_equal(back.numpy(), np.asarray(jx.quant.unpack_int4(jpacked, N)))
    assert np.array_equal(back.numpy(), q)


def test_compression_wrappers_reject_other_devices():
    """A tensor on neither the CPU nor a CUDA card: every new wrapper
    raises, never falls back."""
    meta = {k: torch.ones(s, device="meta") for k, s in
            (("x", (2, 8)), ("r", (2,)), ("n1", (1, 8)))}
    q = torch.ones((2, 8), dtype=torch.int8, device="meta")
    calls = [
        lambda: quantize_rows(meta["x"], meta["x"], meta["r"], 127.0),
        lambda: dequantize_rows(q, meta["r"]),
        lambda: topk_mask_rows(meta["x"], meta["r"]),
        lambda: segment_agg_reduce_quant(meta["x"], meta["r"], np.zeros(2, np.int64),
                                         1, meta["n1"]),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()
    with pytest.raises(ValueError, match="noise"):
        quantize_rows(torch.ones(2, 8), torch.ones(2, 7), torch.ones(2), 127.0)
    with pytest.raises(ValueError, match="unsupported quantization width"):
        kq.quantize_intb(torch.ones(4), torch.ones(4), 3)


@pytest.mark.cuda
def test_cuda_compression_kernels_match_plain_versions(card):
    """On the card: quantize, dequantize and the top-k mask bit for bit
    against their plain versions; the fused kernel's θ bit for bit
    segment_agg_reduce's, its q within one level of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for R, N, dtype in [(16, 1 << 16, torch.float32), (16, 62, torch.float32),
                        (5, 100_003, torch.float32), (16, 1 << 14, torch.bfloat16)]:
        x = torch.randn((R, N), generator=gen, device="cuda").to(dtype)
        u = torch.rand((R, N), generator=gen, device="cuda")
        s = x.float().abs().amax(1).clamp_min(1e-12) / 127.0
        m = (torch.arange(R, device="cuda") % 3 != 0).float()
        before = (quantize_rows.launches, dequantize_rows.launches, topk_mask_rows.launches)
        q = quantize_rows(x, u, s, 127.0)
        assert torch.equal(q, quantize_rows_plain(x, u, s, 127.0))
        assert torch.equal(dequantize_rows(q, s, m), dequantize_rows_plain(q, s, m))
        assert torch.equal(dequantize_rows(q, s), dequantize_rows_plain(q, s))
        t = kq.topk_thresholds(x, max(1, N // 100))
        assert torch.equal(topk_mask_rows(x, t, m), topk_mask_rows_plain(x, t, m))
        torch.cuda.synchronize()
        assert (quantize_rows.launches, dequantize_rows.launches,
                topk_mask_rows.launches) == (before[0] + 1, before[1] + 2, before[2] + 1)
    for C, N, n_seg in [(128, 1 << 16, 16), (16, 62, 1), (20, 100_003, 4)]:
        x = torch.randn((C, N), generator=gen, device="cuda")
        wm = torch.rand(C, generator=gen, device="cuda") * 50
        seg = np.random.default_rng(C).integers(0, n_seg, C)
        u = torch.rand((n_seg, N), generator=gen, device="cuda")
        theta, _ = segment_agg_reduce_absmax(x, wm, seg, n_seg)
        assert torch.equal(theta, segment_agg_reduce(x, wm, seg, n_seg))
        q, s = segment_agg_reduce_quant(x, wm, seg, n_seg, u, 8)
        qp, sp = segment_agg_reduce_quant_plain(x, wm, seg, n_seg, u, 8)
        torch.cuda.synchronize()
        assert torch.allclose(s, sp, rtol=1e-5, atol=0)
        assert int((q.int() - qp.int()).abs().max()) <= 1
        s_theta = theta.abs().amax(1).clamp_min(1e-12) / 127.0
        assert torch.equal(s, s_theta)
        assert torch.equal(q, quantize_rows_plain(theta, u, s_theta, 127.0))
