"""repro_torch's language-model kernels — flash attention, the RG-LRU scan
and the chunked RWKV6 scan — held against the reference: the jnp oracles
of ``repro.kernels.ref`` and the Pallas kernels in interpret mode, at
``tests/test_kernels.py``'s shapes cut to S <= 256 and its tolerances
(flash 2e-5 in f32 and 0.03 in bf16, rglru 1e-5, rwkv6 2e-3). On the CPU
each wrapper runs its plain PyTorch version; the CUDA kernels are held
against those plain versions by the ``cuda``-marked tests (and by
chip_smoke.py) on the card.

JAX comes in through the ``jx`` fixture, so the ``cuda`` tests also run on
a machine that has a card but no JAX:
``python -m pytest -q -m cuda tests/test_torch_lm_kernels.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
    rglru_scan,
    rglru_scan_plain,
    rwkv6_scan,
    rwkv6_scan_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: jnp, kernels.ref and the three Pallas kernels."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
    from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
    return types.SimpleNamespace(jnp=jnp, ref=ref, flash=pallas_flash,
                                 rglru=pallas_rglru, rwkv6=pallas_rwkv6)


@pytest.fixture
def card():
    """Skips a ``cuda`` test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _np(t):
    return np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ------------------------------------------------------------ flash attention

def _qkv(B, H, KV, S, hd, dtype, seed=0):
    """q, k, v as numpy f32 (rounded to bf16 first if asked) and as torch."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]
    ts = [torch.from_numpy(a) for a in arrs]
    if dtype == "bfloat16":
        ts = [t.to(torch.bfloat16) for t in ts]
        arrs = [t.float().numpy() for t in ts]
    return arrs, ts


def _jax_arrays(jx, arrs, dtype):
    return [jx.jnp.asarray(a).astype(jx.jnp.bfloat16 if dtype == "bfloat16"
                                     else jx.jnp.float32) for a in arrs]


# test_kernels.py's flash sweep, S cut to 256
@pytest.mark.parametrize("B,H,KV,S,hd,win,dtype", [
    (2, 4, 2, 256, 64, 0, "float32"),
    (1, 4, 1, 256, 128, 0, "float32"),       # MQA
    (2, 2, 2, 256, 64, 128, "float32"),      # sliding window
    (1, 8, 4, 256, 256, 0, "float32"),       # RG-size head_dim
    (1, 4, 4, 256, 64, 0, "bfloat16"),       # MHA bf16
    (1, 16, 1, 256, 256, 64, "bfloat16"),    # recurrentgemma: MQA, window, hd 256
])
def test_flash_matches_ref_and_pallas(jx, B, H, KV, S, hd, win, dtype):
    arrs, ts = _qkv(B, H, KV, S, hd, dtype)
    got = flash_attention(*ts, causal=True, window=win)
    assert got.shape == (B, H, S, hd) and got.dtype == ts[0].dtype
    ja = _jax_arrays(jx, arrs, dtype)
    tol = 2e-5 if dtype == "float32" else 0.03
    _close(got.float(), jx.ref.attention_ref(*ja, causal=True, window=win), tol)
    pallas = jx.flash(*ja, causal=True, window=win, bq=64, bk=64, interpret=True)
    _close(got.float(), pallas, tol)


@pytest.mark.parametrize("B,H,KV,S,hd,win", [
    (1, 4, 2, 100, 16, 0), (2, 4, 1, 130, 64, 48), (1, 2, 2, 1, 32, 0),
    (1, 4, 2, 300, 16, 7),
])
def test_flash_ragged_s_matches_ref(jx, B, H, KV, S, hd, win):
    """Any S (the TPU kernel asserts divisibility; the port masks the
    ragged tile), including S larger than one plain-version block."""
    arrs, ts = _qkv(B, H, KV, S, hd, "float32", seed=S)
    got = flash_attention(*ts, causal=True, window=win)
    _close(got, jx.ref.attention_ref(*_jax_arrays(jx, arrs, "float32"), causal=True,
                                     window=win), 2e-5)


def test_flash_non_causal_matches_ref(jx):
    arrs, ts = _qkv(1, 4, 2, 96, 32, "float32", seed=3)
    got = flash_attention(*ts, causal=False)
    _close(got, jx.ref.attention_ref(*_jax_arrays(jx, arrs, "float32"), causal=False),
           2e-5)


def test_flash_wrapper_rejects_bad_inputs_and_other_devices():
    q, k = torch.ones((1, 3, 8, 16)), torch.ones((1, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):
        flash_attention(q[0], k, k)
    q = torch.ones((1, 4, 8, 16), device="meta")
    k = torch.ones((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, k, k)


# ---------------------------------------------------------------------- rglru

def _ab(B, S, C, seed=0, with_h0=True):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, S, C))))).astype(np.float32)
    b = rng.normal(size=(B, S, C)).astype(np.float32)
    h0 = rng.normal(size=(B, C)).astype(np.float32) if with_h0 else None
    return a, b, h0


@pytest.mark.parametrize("B,S,C", [(1, 64, 128), (2, 256, 640), (3, 256, 896)])
def test_rglru_matches_ref_and_pallas(jx, B, S, C):
    a, b, h0 = _ab(B, S, C)
    out, h = rglru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    ja = [jx.jnp.asarray(x) for x in (a, b, h0)]
    for want_o, want_h in (jx.ref.rglru_scan_ref(*ja), jx.rglru(*ja, interpret=True)):
        _close(out, want_o, 1e-5)
        _close(h, want_h, 1e-5)


@pytest.mark.parametrize("B,S,C", [(2, 17, 7), (1, 1, 4096), (3, 5, 130)])
def test_rglru_odd_shapes_and_no_h0_match_ref(jx, B, S, C):
    """Odd widths (the kernel's scalar path), the decode shape S = 1, h0 absent."""
    a, b, _ = _ab(B, S, C, seed=C)
    out, h = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    want_o, want_h = jx.ref.rglru_scan_ref(jx.jnp.asarray(a), jx.jnp.asarray(b))
    _close(out, want_o, 1e-5)
    _close(h, want_h, 1e-5)


def test_rglru_wrapper_rejects_bad_inputs_and_other_devices():
    a = torch.ones((2, 3, 4))
    with pytest.raises(ValueError):
        rglru_scan(a, torch.ones((2, 3, 5)))
    with pytest.raises(ValueError, match="h0"):
        rglru_scan(a, a, torch.ones(4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rglru_scan(a.to("meta"), a.to("meta"))


# ---------------------------------------------------------------------- rwkv6

def _rkvwu(B, H, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, S, hd)).astype(np.float32) for _ in range(3))
    logw = (-np.exp(rng.normal(size=(B, H, S, hd)) * 0.5)).astype(np.float32)
    u = (rng.normal(size=(H, hd)) * 0.5).astype(np.float32)
    return r, k, v, logw, u


# test_kernels.py's rwkv6 sweep (S already <= 256)
@pytest.mark.parametrize("B,H,S,hd,chunk", [
    (1, 2, 128, 32, 64), (2, 3, 256, 64, 64), (1, 1, 64, 16, 16),
])
def test_rwkv6_matches_ref_and_pallas(jx, B, H, S, hd, chunk):
    arrs = _rkvwu(B, H, S, hd)
    o, s = rwkv6_scan(*(torch.from_numpy(x) for x in arrs), chunk=chunk)
    ja = [jx.jnp.asarray(x) for x in arrs]
    for want_o, want_s in (jx.ref.rwkv6_ref(*ja), jx.rwkv6(*ja, chunk=chunk, interpret=True)):
        _close(o, want_o, 2e-3)
        _close(s, want_s, 2e-3)


@pytest.mark.parametrize("B,H,S,hd,chunk", [
    (1, 2, 100, 16, 16), (2, 1, 13, 32, 8), (1, 3, 1, 64, 64),
])
def test_rwkv6_ragged_chunk_matches_ref(jx, B, H, S, hd, chunk):
    """A ragged last chunk (and S = 1, the decode shape)."""
    arrs = _rkvwu(B, H, S, hd, seed=S)
    o, s = rwkv6_scan(*(torch.from_numpy(x) for x in arrs), chunk=chunk)
    want_o, want_s = jx.ref.rwkv6_ref(*(jx.jnp.asarray(x) for x in arrs))
    _close(o, want_o, 2e-3)
    _close(s, want_s, 2e-3)


@pytest.mark.parametrize("split", [30, 64, 99])
def test_rwkv6_initial_state_chains(jx, split):
    """Two chained calls (the second from the first's S_final, as decode
    runs) equal one reference call over the whole sequence."""
    arrs = _rkvwu(1, 2, 100, 16, seed=split)
    u = torch.from_numpy(arrs[4])
    head = [torch.from_numpy(x[:, :, :split]) for x in arrs[:4]]
    tail = [torch.from_numpy(x[:, :, split:]) for x in arrs[:4]]
    o1, s1 = rwkv6_scan(*head, u, chunk=16)
    o2, s2 = rwkv6_scan(*tail, u, chunk=16, s0=s1)
    want_o, want_s = jx.ref.rwkv6_ref(*(jx.jnp.asarray(x) for x in arrs))
    _close(torch.cat([o1, o2], dim=2), want_o, 2e-3)
    _close(s2, want_s, 2e-3)


def test_rwkv6_wrapper_rejects_bad_inputs_and_other_devices():
    r = torch.ones((1, 2, 4, 8))
    with pytest.raises(ValueError, match="u must be"):
        rwkv6_scan(r, r, r, r, torch.ones((3, 8)))
    with pytest.raises(ValueError, match="s0 must be"):
        rwkv6_scan(r, r, r, r, torch.ones((2, 8)), s0=torch.ones((1, 2, 8)))
    m = r.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rwkv6_scan(m, m, m, m, torch.ones((2, 8), device="meta"))


# ------------------------------------------------- the kernels on the card

@pytest.mark.cuda
def test_cuda_flash_matches_plain_version(card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(2, 4, 2, 256, 64, 0, torch.float32), (1, 16, 1, 600, 256, 128, torch.bfloat16),
             (2, 4, 1, 130, 128, 0, torch.float32), (1, 4, 2, 77, 16, 5, torch.float32),
             (1, 8, 8, 64, 32, 0, torch.bfloat16), (1, 2, 1, 1, 256, 0, torch.float32)]
    for B, H, KV, S, hd, win, dtype in cases:
        q = torch.randn((B, H, S, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, KV, S, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, KV, S, hd), generator=gen, device="cuda").to(dtype)
        before = flash_attention.launches
        got = flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = flash_attention_plain(q, k, v, window=win)
        tol = 2e-5 if dtype == torch.float32 else 0.03
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # strided inputs: the model's (B, S, H, hd) activations, transposed
    q = torch.randn((2, 96, 4, 64), generator=gen, device="cuda").transpose(1, 2)
    k = torch.randn((2, 96, 2, 64), generator=gen, device="cuda").transpose(1, 2)
    torch.testing.assert_close(flash_attention(q, k, k, window=40),
                               flash_attention_plain(q, k, k, window=40),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_rglru_matches_plain_version_bit_for_bit(card):
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, S, C, with_h0 in ((4, 300, 4096, True), (4, 1, 4096, True), (2, 33, 7, False),
                             (3, 64, 130, True)):
        a = torch.rand((B, S, C), generator=gen, device="cuda")
        b = torch.randn((B, S, C), generator=gen, device="cuda")
        h0 = torch.randn((B, C), generator=gen, device="cuda") if with_h0 else None
        before = rglru_scan.launches
        out, h = rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        assert rglru_scan.launches == before + 1
        want_o, want_h = rglru_scan_plain(a, b, h0)
        assert torch.equal(out, want_o) and torch.equal(h, want_h)


@pytest.mark.cuda
def test_cuda_rwkv6_matches_plain_version(card):
    gen = torch.Generator(device="cuda").manual_seed(2)
    for B, H, S, hd, chunk, dtype, with_s0 in (
            (2, 3, 256, 64, 64, torch.float32, False), (1, 4, 100, 16, 8, torch.bfloat16, True),
            (2, 48, 1, 64, 64, torch.bfloat16, True), (1, 2, 77, 32, 16, torch.float32, True)):
        r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
                   .transpose(1, 2) for _ in range(3))
        logw = -torch.exp(0.5 * torch.randn((B, S, H, hd), generator=gen, device="cuda")
                          ).transpose(1, 2)
        u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
        s0 = torch.randn((B, H, hd, hd), generator=gen, device="cuda") if with_s0 else None
        before = rwkv6_scan.launches
        o, s = rwkv6_scan(r, k, v, logw, u, chunk=chunk, s0=s0)
        torch.cuda.synchronize()
        assert rwkv6_scan.launches == before + 1
        want_o, want_s = rwkv6_scan_plain(r, k, v, logw, u, chunk=chunk, s0=s0)
        torch.testing.assert_close(o, want_o, rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(s, want_s, rtol=2e-3, atol=2e-3)
