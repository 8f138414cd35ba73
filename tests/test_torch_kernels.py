"""repro_torch.kernels.agg_reduce and the aggregation built on it, held
against the reference: the Pallas kernel in interpret mode, its jnp oracle
(kernels/ref.py) and core.aggregation. On the CPU the wrapper runs its
plain PyTorch version; the CUDA kernel is held against that plain version
by the ``cuda``-marked test (and by chip_smoke.py) on the card.

JAX comes in through the ``jx`` fixture, so the ``cuda`` test also runs on
a machine that has a card but no JAX:
``python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import aggregation  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    agg_reduce,
    segment_agg_reduce,
    segment_agg_reduce_plain,
)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: jnp, core.aggregation, kernels.ref, the Pallas
    agg_reduce."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import aggregation as jagg
    from repro.kernels import ref
    from repro.kernels.agg_reduce import agg_reduce as pallas_agg_reduce
    return types.SimpleNamespace(jnp=jnp, agg=jagg, ref=ref,
                                 pallas_agg_reduce=pallas_agg_reduce)


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
