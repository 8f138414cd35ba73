"""repro_torch's language-model kernels — flash attention, the RG-LRU scan
and the chunked RWKV6 scan — held against the reference: the jnp oracles
of ``repro.kernels.ref`` and the Pallas kernels in interpret mode, at
``tests/test_kernels.py``'s shapes cut to S <= 256 and its tolerances
(flash 2e-5 in f32 and 0.03 in bf16, rglru 1e-5, rwkv6 2e-3); the three
kernels' gradients (their plain versions and autograd of the plain
forwards) against ``jax.grad`` of the reference's jnp forms. On the CPU
each wrapper runs its plain PyTorch version; the CUDA kernels are held
against those plain versions by the ``cuda``-marked tests (and by
chip_smoke.py) on the card.

JAX comes in through the ``jx`` fixture, so the ``cuda`` tests also run on
a machine that has a card but no JAX:
``python -m pytest -q -m cuda tests/test_torch_lm_kernels.py``.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_stub_library import stub_libraries  # noqa: E402

from repro_torch.kernels import (  # noqa: E402
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    rglru_scan,
    rglru_scan_bwd_plain,
    rglru_scan_plain,
    rwkv6_scan,
    rwkv6_scan_bwd_plain,
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


# ------------------------------------------------------------ flash attention's gradient

def _jax_attention(jx, q, k, v, causal, window, softcap):
    """The reference's attention as a jnp function of (q, k, v) in
    (B, heads, S, hd): ``kernels.ref.attention_ref``, or with a soft-cap
    the reference model's ``_attend_block`` over the KV heads expanded."""
    if not softcap:
        return jx.ref.attention_ref(q, k, v, causal=causal, window=window)
    from repro.models.layers import _attend_block
    S, g = q.shape[2], q.shape[1] // k.shape[1]
    idx = jx.jnp.arange(S)
    mask = idx[None, :] <= idx[:, None] if causal else jx.jnp.ones((S, S), bool)
    if window:
        mask = mask & (idx[None, :] > idx[:, None] - window)
    t = lambda x: x.transpose(0, 2, 1, 3)   # noqa: E731
    o = _attend_block(t(q), t(jx.jnp.repeat(k, g, 1)), t(jx.jnp.repeat(v, g, 1)),
                      mask[None, None], 1.0 / np.sqrt(q.shape[-1]), softcap)
    return t(o)


@pytest.mark.parametrize("B,H,KV,S,hd,causal,win,softcap", [
    (1, 4, 2, 40, 16, True, 0, 0.0),        # GQA
    (2, 4, 1, 33, 16, True, 0, 0.0),        # MQA
    (1, 2, 2, 50, 16, True, 7, 0.0),        # sliding window
    (1, 4, 2, 30, 16, True, 0, 5.0),        # soft-cap
    (1, 4, 1, 300, 16, True, 20, 3.0),      # ragged S over two plain blocks, window + cap
    (1, 2, 1, 24, 32, False, 0, 0.0),       # not causal
])
def test_flash_gradient_plain_versions_match_jax_grad(jx, B, H, KV, S, hd, causal, win,
                                                      softcap):
    """``flash_attention_bwd_plain`` (from the plain forward's output and
    log-sum-exp) and autograd of ``flash_attention_plain`` against
    ``jax.grad`` of the reference's attention, f32 within 1e-4; the
    log-sum-exp against jax's logsumexp of the masked scores."""
    import jax
    arrs, (q, k, v) = _qkv(B, H, KV, S, hd, "float32", seed=S + H)
    do = np.random.default_rng(S).normal(size=(B, H, S, hd)).astype(np.float32)
    kw = dict(causal=causal, window=win, softcap=softcap)
    ja = [jx.jnp.asarray(a) for a in arrs]
    want = jax.grad(lambda q_, k_, v_: jx.jnp.sum(
        _jax_attention(jx, q_, k_, v_, causal, win, softcap) * do), argnums=(0, 1, 2))(*ja)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_plain(q, k, v, o, lse, torch.from_numpy(do), **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(flash_attention(qa, ka, va, **kw), (qa, ka, va),
                               torch.from_numpy(do))
    for a, b in zip(auto, want):
        _close(a, b, 1e-4)
    # the log-sum-exp of the rows' visible scores (soft-capped as the kernel does)
    s = np.einsum("bhqd,bhkd->bhqk", arrs[0], np.repeat(arrs[1], H // KV, 1)) / np.sqrt(hd)
    if softcap:
        s = np.tanh(s / softcap) * softcap
    idx = np.arange(S)
    mask = (idx[None, :] <= idx[:, None]) if causal else np.ones((S, S), bool)
    if win:
        mask &= idx[None, :] > idx[:, None] - win
    _close(lse, jax.nn.logsumexp(jx.jnp.where(mask, s, -1e30), axis=-1), 1e-4)


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


# ------------------------------------------------- the scans' gradients

def _close_to_max(got, want, tol):
    """|got − want| <= tol·max|want| everywhere (``_within`` with no rtol)."""
    _within(got, want, 0.0, tol * float(np.abs(_np(want)).max()))


@pytest.mark.parametrize("B,S,C,with_h0,with_dl", [
    (2, 17, 7, True, True), (1, 33, 16, False, False), (3, 8, 130, True, False),
    (2, 1, 5, False, True),
])
def test_rglru_gradient_plain_versions_match_jax_grad(jx, B, S, C, with_h0, with_dl):
    """``rglru_scan_bwd_plain`` (from the plain forward's out) and autograd
    of the wrapper (the plain version, on the CPU) against ``jax.grad`` of
    ``kernels.ref.rglru_scan_ref`` (h0 where given; dh_last where h_last
    takes a gradient) and, from zeros, of the reference model's associative
    ``rglru_scan`` (dh_last joined to the last step's dout); rtol 1e-5, the
    forward's."""
    import jax

    from repro.models.rglru import rglru_scan as model_scan
    jnp = jx.jnp
    a, b, h0 = _ab(B, S, C, seed=S + C, with_h0=with_h0)
    rng = np.random.default_rng(C)
    dout = rng.normal(size=(B, S, C)).astype(np.float32)
    dl = rng.normal(size=(B, C)).astype(np.float32) if with_dl else None

    def ref_loss(a_, b_, *h):
        o, h_last = jx.ref.rglru_scan_ref(a_, b_, *h)
        return jnp.sum(o * dout) + (jnp.sum(h_last * dl) if with_dl else 0.0)
    args = [jnp.asarray(x) for x in (a, b) + ((h0,) if with_h0 else ())]
    want = jax.grad(ref_loss, argnums=tuple(range(len(args))))(*args)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    th0 = torch.from_numpy(h0) if with_h0 else None
    tdl = torch.from_numpy(dl) if with_dl else None
    out, _ = rglru_scan_plain(ta, tb, th0)
    got = rglru_scan_bwd_plain(ta, out, th0, torch.from_numpy(dout), tdl)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    ins = [t.clone().requires_grad_() for t in (ta, tb) + ((th0,) if with_h0 else ())]
    o, h_last = rglru_scan(*ins)
    auto = torch.autograd.grad((o, h_last) if with_dl else (o,), ins,
                               (torch.from_numpy(dout), tdl) if with_dl
                               else (torch.from_numpy(dout),))
    for g, w in zip(auto, want):
        _close(g, w, 1e-5)
    if not with_h0:
        dd = dout.copy()
        if with_dl:
            dd[:, -1] += dl
        wm = jax.grad(lambda a_, b_: jnp.sum(model_scan(a_, b_) * dd), argnums=(0, 1))(*args)
        for g, w in zip(got, wm):
            _close(g, w, 1e-5)


@pytest.mark.parametrize("B,H,S,hd,chunk,strong,pad_head", [
    (1, 2, 20, 8, 8, False, False),
    (2, 3, 37, 16, 8, True, True),       # ragged last chunk, strong decays, a padded head
    (1, 2, 45, 16, 4, False, True),
    (1, 1, 64, 32, 4, True, False),
])
def test_rwkv6_gradient_plain_versions_match_jax_grad(jx, B, H, S, hd, chunk, strong,
                                                      pad_head):
    """``rwkv6_scan_bwd_plain`` and autograd of the wrapper (the plain
    version, on the CPU) against ``jax.grad`` of ``kernels.ref.rwkv6_ref``
    (the exact token recurrence) with a dS_final: f32 within
    1e-4·max|grad|; ragged last chunks, chunks of 4 and 8 tokens, and a
    padded head whose do is 0, as the model's head mask makes it."""
    import jax
    jnp = jx.jnp
    arrs = (_strong_rkvwu if strong else _rkvwu)(B, H, S, hd, seed=S)
    rng = np.random.default_rng(S + 1)
    do = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    if pad_head:
        do[:, -1] = 0.0
    df = rng.normal(size=(B, H, hd, hd)).astype(np.float32)

    def loss(*xs):
        o, s_fin = jx.ref.rwkv6_ref(*xs)
        return jnp.sum(o * do) + jnp.sum(s_fin * df)
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x) for x in arrs))
    ts = [torch.from_numpy(x) for x in arrs]
    got = rwkv6_scan_bwd_plain(*ts, torch.from_numpy(do), chunk=chunk,
                               ds_final=torch.from_numpy(df))
    for g, w in zip(got, want):
        _close_to_max(g, w, 1e-4)
    ins = [t.clone().requires_grad_() for t in ts]
    o, s_fin = rwkv6_scan(*ins, chunk=chunk)
    auto = torch.autograd.grad((o, s_fin), ins, (torch.from_numpy(do), torch.from_numpy(df)))
    for g, w in zip(auto, want):
        _close_to_max(g, w, 1e-4)


@pytest.mark.parametrize("S,chunk", [(24, 8), (30, 8), (18, 4)])
def test_rwkv6_gradient_from_s0_matches_jax_chunk_body(jx, S, chunk):
    """From an initial state: ``rwkv6_scan_bwd_plain`` against ``jax.grad``
    of the reference model's ``_chunk_body`` chained over the chunks (its
    (B, W, H, hd) layout), every input's gradient and ds0 within
    1e-4·max|grad|, ragged last chunk included."""
    import jax

    from repro.models.rwkv6 import _chunk_body
    jnp = jx.jnp
    B, H, hd = 2, 2, 8
    arrs = _strong_rkvwu(B, H, S, hd, seed=S + chunk)
    rng = np.random.default_rng(S)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    do = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    df = rng.normal(size=(B, H, hd, hd)).astype(np.float32)

    def loss(r, k, v, logw, u, st):
        total = 0.0
        for t0 in range(0, S, chunk):
            t1 = min(S, t0 + chunk)
            tr = lambda x: x[:, :, t0:t1].transpose(0, 2, 1, 3)   # noqa: E731
            o, st = _chunk_body(tr(r), tr(k), tr(v), tr(logw), u, st, None)
            total = total + jnp.sum(o * tr(jnp.asarray(do)))
        return total + jnp.sum(st * df)
    want = jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(x) for x in arrs + (s0,)))
    got = rwkv6_scan_bwd_plain(*(torch.from_numpy(x) for x in arrs), torch.from_numpy(do),
                               chunk=chunk, s0=torch.from_numpy(s0),
                               ds_final=torch.from_numpy(df))
    for g, w in zip(got, want):
        _close_to_max(g, w, 1e-4)


# ------------------------------------- models of the redesigned kernels

def _within(got, want, rtol, atol):
    """chip_smoke.py's check: |got − want| <= atol + rtol·|want|, in f32."""
    got, want = (torch.as_tensor(np.array(x, np.float32)) if not torch.is_tensor(x)
                 else x.float() for x in (got, want))
    d = (got - want).abs()
    assert bool((d <= atol + rtol * want.abs()).all()), float(d.max())


FLASH_RTOL, FLASH_ATOL = 2.0 ** -7, 1e-5       # chip_smoke's bf16 flash bound
RWKV_TOL = 2e-3                                # chip_smoke's rwkv6 bound


def _flash_wgmma_model(q, k, v, *, causal=True, window=0, scale=None, softcap=0.0):
    """The bf16 tensor-core kernel's arithmetic in plain torch.

    Query groups of 64 rows (one consumer warpgroup each) walk the 64-key
    tiles their rows can see, as the kernel skips them; QKᵀ of bf16
    operands (exact products) summed in f32; scores masked at −1e30 and
    scaled to log2 units; online softmax with exp2; P split into bf16 hi
    and lo halves, each multiplied by V (exact in bf16) and summed in f32.
    """
    B, H, S, hd = q.shape
    g = H // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    out = torch.empty_like(q)
    for r0 in range(0, S, 64):
        r1 = min(S, r0 + 64)
        hi_t = (r1 - 1) // 64 if causal else (S - 1) // 64
        lo_t = (r0 - window + 1) // 64 if window and r0 - window + 1 > 0 else 0
        rows = torch.arange(r0, r1)[:, None]
        qf = q[:, :, r0:r1].float()
        m = torch.full((B, H, r1 - r0), -1e30)
        l = torch.zeros((B, H, r1 - r0))
        acc = torch.zeros((B, H, r1 - r0, hd))
        for kt in range(lo_t, hi_t + 1):
            k0, k1 = 64 * kt, min(S, 64 * kt + 64)
            x = qf @ kf[:, :, k0:k1].transpose(-1, -2) * scale
            if softcap:
                x = torch.tanh(x / softcap) * softcap
            cols = torch.arange(k0, k1)[None, :]
            ok = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool)
            if causal:
                ok &= cols <= rows
            if window:
                ok &= cols > rows - window
            x = torch.where(ok, x * (1 / math.log(2)), torch.tensor(-1e30))
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            p_hi = p.bfloat16().float()
            p_lo = (p - p_hi).bfloat16().float()
            acc = acc * corr[..., None] + p_hi @ vf[:, :, k0:k1] + p_lo @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, r0:r1] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


@pytest.mark.parametrize("B,H,KV,S,hd,win,softcap", [
    (1, 2, 1, 100, 16, 0, 0.0),
    (1, 4, 2, 130, 32, 48, 0.0),      # GQA H/KV = 2, window, ragged S
    (1, 2, 2, 200, 64, 0, 30.0),      # soft-cap
    (1, 16, 1, 150, 128, 64, 0.0),    # GQA H/KV = 16
    (1, 16, 1, 300, 256, 128, 0.0),   # recurrentgemma: MQA, window, hd 256
])
def test_flash_wgmma_model_matches_plain_version(B, H, KV, S, hd, win, softcap):
    """The tensor-core design's arithmetic (tiles, online softmax in base 2,
    P as bf16 hi + lo) stays within chip_smoke's bound of the plain version."""
    _, (q, k, v) = _qkv(B, H, KV, S, hd, "bfloat16", seed=S + hd)
    got = _flash_wgmma_model(q, k, v, window=win, softcap=softcap)
    want = flash_attention_plain(q, k, v, window=win, softcap=softcap)
    assert got.dtype == torch.bfloat16
    _within(got, want, FLASH_RTOL, FLASH_ATOL)


@pytest.mark.parametrize("B,H,KV,S,hd,win", [
    (1, 4, 2, 128, 64, 0), (1, 16, 1, 256, 256, 64), (2, 2, 1, 192, 32, 100),
])
def test_flash_wgmma_model_matches_pallas(jx, B, H, KV, S, hd, win):
    """… and of the TPU kernel (interpret mode), which multiplies P by V in f32."""
    arrs, (q, k, v) = _qkv(B, H, KV, S, hd, "bfloat16", seed=hd)
    got = _flash_wgmma_model(q, k, v, window=win)
    pallas = jx.flash(*_jax_arrays(jx, arrs, "bfloat16"), causal=True, window=win, bq=64,
                      bk=64, interpret=True)
    _within(got, np.asarray(pallas.astype(jx.jnp.float32)), FLASH_RTOL, FLASH_ATOL)


def _split(x):
    """x (f32) as the kernels carry it into a bf16 product: hi + lo halves."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _tile_visible(q0, k0, S, causal, window):
    """The kernel's ``all_visible``: a 64 × 64 tile that needs no mask."""
    return (q0 + 63 < S and k0 + 63 < S and (not causal or k0 + 63 <= q0)
            and (not window or q0 + 63 - window < k0))


def _flash_bwd_wgmma_model(q, k, v, o, lse, do, *, causal=True, window=0, scale=None,
                           softcap=0.0):
    """The bf16 wgmma backward's arithmetic in plain torch, tile by tile.

    prep: D = rowsum(dO ∘ O) and lse·log2(e). dK/dV: blocks of 128 keys
    (two warpgroups of 64) walk the GQA group's heads and the 64-row query
    tiles from the block's window, a warpgroup skipping tiles none of whose
    pairs it sees and masking only tiles that are not wholly visible; Sᵀ
    and dPᵀ of bf16 operands in f32, P = 2^(s·scale·log2(e) − lse·log2(e))
    (through tanh with a soft-cap), dS = P ∘ (dP − D) (∘ 1 − tanh²), then
    dV += Pᵀ·dO and dK += dSᵀ·Q with P and dS as bf16 hi + lo. dQ: blocks of
    128 queries walk the key tiles their rows see, dQ += dS·K the same way.
    At hd = 256 a block owns 64 rows (keys, then queries), which both
    warpgroups share: each computes the tile's Sᵀ and dPᵀ over the full hd
    (duplicated, not exchanged) and keeps its half of the output columns.
    """
    B, H, S, hd = q.shape
    KV = k.shape[1]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    log2e = 1.0 / math.log(2)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    D = (dof * o.float()).sum(-1)
    L2 = lse.float() * log2e
    split = hd > 128
    rows_per_block = 64 if split else 128
    # (first row, output columns) of each consumer warpgroup of a block at r0
    halves = (slice(0, hd // 2), slice(hd // 2, hd))
    warpgroups = ((lambda r0: [(r0, c) for c in halves]) if split
                  else (lambda r0: [(r0, slice(None)), (r0 + 64, slice(None))]))

    def tile(h, kvh, q0, k0):
        """(P, dS) of queries q0 + [0, 64) and keys k0 + [0, 64) of head h."""
        q1, k1 = min(q0 + 64, S), min(k0 + 64, S)
        s = qf[:, h, q0:q1] @ kf[:, kvh, k0:k1].transpose(-1, -2)
        dp = dof[:, h, q0:q1] @ vf[:, kvh, k0:k1].transpose(-1, -2)
        if softcap:
            th = torch.tanh(s * scale / softcap)
            p = torch.exp2(th * (softcap * log2e) - L2[:, h, q0:q1, None])
        else:
            p = torch.exp2(s * (scale * log2e) - L2[:, h, q0:q1, None])
        if not _tile_visible(q0, k0, S, causal, window):
            rows = torch.arange(q0, q1)[:, None]
            cols = torch.arange(k0, k1)[None, :]
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                ok &= cols <= rows
            if window:
                ok &= cols > rows - window
            p = torch.where(ok, p, torch.zeros(()))
        ds = p * (dp - D[:, h, q0:q1, None])
        if softcap:
            ds = ds * (1 - th * th)
        return p, ds

    dq = torch.zeros((B, H, S, hd))
    dk = torch.zeros((B, KV, S, hd))
    dv = torch.zeros((B, KV, S, hd))
    for kvh in range(KV):
        for k0 in range(0, S, rows_per_block):
            k_last = min(k0 + rows_per_block, S) - 1
            qt_lo = k0 // 64 if causal else 0
            qt_hi = (min(S - 1, k_last + window - 1) if window else S - 1) // 64
            for h in range(kvh * g, kvh * g + g):
                for qt in range(qt_lo, qt_hi + 1):
                    q0 = 64 * qt
                    q_last = min(q0 + 64, S) - 1
                    for kw0, cols in warpgroups(k0):
                        kw1 = min(kw0 + 63, S - 1)
                        if kw0 >= S or (causal and q_last < kw0) or (
                                window and q0 - window + 1 > kw1):
                            continue
                        p, ds = tile(h, kvh, q0, kw0)
                        kw_end = min(kw0 + 64, S)
                        rows = slice(q0, q_last + 1)
                        for half in _split(p):
                            dv[:, kvh, kw0:kw_end, cols] += (half.transpose(-1, -2)
                                                             @ dof[:, h, rows, cols])
                        for half in _split(ds):
                            dk[:, kvh, kw0:kw_end, cols] += (half.transpose(-1, -2)
                                                             @ qf[:, h, rows, cols])
    for h in range(H):
        kvh = h // g
        for q0 in range(0, S, rows_per_block):
            for wr0, cols in warpgroups(q0):
                if wr0 >= S:
                    continue
                r1 = min(wr0 + 64, S) - 1
                hi_t = r1 // 64 if causal else (S - 1) // 64
                lo_t = (wr0 - window + 1) // 64 if window and wr0 - window + 1 > 0 else 0
                for kt in range(lo_t, hi_t + 1):
                    _, ds = tile(h, kvh, wr0, 64 * kt)
                    k_end = min(64 * kt + 64, S)
                    for half in _split(ds):
                        dq[:, h, wr0:r1 + 1, cols] += half @ kf[:, kvh, 64 * kt:k_end, cols]
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype))


BWD_CASES = [   # (B, H, KV, S, hd, window, softcap)
    (1, 4, 2, 150, 64, 0, 0.0),       # GQA, ragged S: a block's second warpgroup past S
    (1, 14, 2, 200, 64, 0, 0.0),      # qwen2-0.5b's group of 7 heads
    (1, 2, 2, 260, 128, 0, 0.0),      # olmo-1b's MHA at hd 128, interior tiles unmasked
    (1, 4, 1, 200, 32, 70, 0.0),      # window
    (2, 4, 2, 77, 16, 0, 30.0),       # soft-cap
    (1, 2, 1, 300, 64, 100, 5.0),     # window and soft-cap over several tiles
    (1, 16, 1, 300, 256, 128, 0.0),   # recurrentgemma: MQA, window, hd 256 split by warpgroup
    (1, 4, 2, 200, 256, 0, 30.0),     # hd 256 with a soft-cap, GQA, ragged S
]


@pytest.mark.parametrize("B,H,KV,S,hd,win,softcap", BWD_CASES)
def test_flash_bwd_wgmma_model_matches_plain_version(B, H, KV, S, hd, win, softcap):
    """The wgmma backward's design (tile walk, per-warpgroup skips, masks
    only on the tiles that need one, P in base 2, P and dS as bf16 hi + lo;
    at hd 256 64-row blocks whose warpgroups split the columns and both
    compute the tile's scores) stays within chip_smoke's bound of the plain
    version: one bf16 rounding, 2^-7·|plain| + 1e-4·max|plain|."""
    _, (q, k, v) = _qkv(B, H, KV, S, hd, "bfloat16", seed=S + hd + 1)
    do = torch.from_numpy(np.random.default_rng(S).normal(size=(B, H, S, hd))
                          .astype(np.float32)).bfloat16()
    o, lse = flash_attention_plain(q, k, v, window=win, softcap=softcap, return_lse=True)
    got = _flash_bwd_wgmma_model(q, k, v, o, lse, do, window=win, softcap=softcap)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, window=win, softcap=softcap)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _within(g, w, 2.0 ** -7, 1e-4 * float(w.float().abs().max()))


@pytest.mark.parametrize("B,H,KV,S,hd,win,softcap", BWD_CASES[::2] + BWD_CASES[7:])
def test_flash_bwd_wgmma_model_matches_jax_grad(jx, B, H, KV, S, hd, win, softcap):
    """… and ``jax.grad`` of the reference's attention on the same bf16
    inputs in f32, at chip_smoke's autograd bound (the reference's D reads
    the unrounded o): 2^-6·|grad| + 1e-2·max|grad|."""
    import jax
    arrs, (q, k, v) = _qkv(B, H, KV, S, hd, "bfloat16", seed=S + hd + 1)
    do = torch.from_numpy(np.random.default_rng(S).normal(size=(B, H, S, hd))
                          .astype(np.float32)).bfloat16()
    o, lse = flash_attention_plain(q, k, v, window=win, softcap=softcap, return_lse=True)
    got = _flash_bwd_wgmma_model(q, k, v, o, lse, do, window=win, softcap=softcap)
    dof = do.float().numpy()
    want = jax.grad(lambda q_, k_, v_: jx.jnp.sum(
        _jax_attention(jx, q_, k_, v_, True, win, softcap) * dof), argnums=(0, 1, 2))(
        *[jx.jnp.asarray(a) for a in arrs])
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        _within(g, w, 2.0 ** -6, 1e-2 * float(np.abs(w).max()))


def _rwkv6_chunked_model(r, k, v, logw, u, *, chunk=64, s0=None):
    """The chunk-parallel kernel's arithmetic in plain torch, f32 products
    (the kernel's 3 × TF32 split carries about 21 bits of each operand).

    Chunks of W tokens zero-padded to 64 rows (logw = 0, k = 0), cumulative
    decays in log2 units; pass 1: every chunk's state U and decay e^{c_W};
    pass 2: the scan S_in(n + 1) = e^{c_W} ⊙ S_in(n) + U(n); pass 3: the
    outputs with 16-token sub-chunks, off-diagonal blocks of the pair
    matrix as (r̂_i ⊙ g_ij)·k̂_jᵀ with every exponent ≤ 0, diagonal blocks
    per pair (clamped at 0), and the u-bonus on the diagonal.
    """
    B, H, S, hd = r.shape
    W = min(chunk, S)
    nc = -(-S // W)
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, nc * W - S)).reshape(
        B, H, nc, W, hd)
    rows = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 64 - W))
    rc, kc, vc = (rows(pad(t)) for t in (r, k, v))
    c = torch.cumsum(rows(pad(logw)) / math.log(2), dim=-2)       # (B, H, nc, 64, hd)
    # pass 1
    U = (kc * torch.exp2(c[..., -1:, :] - c)).transpose(-1, -2) @ vc
    dec = torch.exp2(c[..., -1, :])
    # pass 2
    st = torch.zeros((B, H, hd, hd)) if s0 is None else s0.float()
    s_in = []
    for n in range(nc):
        s_in.append(st)
        st = dec[:, :, n, :, None] * st + U[:, :, n]
    s_in = torch.stack(s_in, 2)
    # pass 3
    c_excl = torch.nn.functional.pad(c[..., :-1, :], (0, 0, 1, 0))
    b0 = (torch.arange(64) // 16) * 16
    r_hat = rc * torch.exp2(c_excl - c_excl[..., b0, :])
    k_hat = kc * torch.exp2(c[..., b0 + 15, :] - c)
    A = torch.zeros(c.shape[:-2] + (64, 64))
    for i in range(4):
        ri = slice(16 * i, 16 * i + 16)
        for j in range(i):
            rj = slice(16 * j, 16 * j + 16)
            g = torch.exp2(c_excl[..., 16 * i, :] - c[..., 16 * j + 15, :])
            A[..., ri, rj] = (r_hat[..., ri, :] * g[..., None, :]) @ k_hat[..., rj, :].transpose(
                -1, -2)
        d = c_excl[..., ri, None, :] - c[..., None, ri, :]         # (…, 16, 16, hd)
        pair = (rc[..., ri, None, :] * kc[..., None, ri, :] * torch.exp2(d.clamp_max(0))).sum(-1)
        A[..., ri, ri] = torch.tril(pair, -1) + torch.diag_embed(
            (rc[..., ri, :] * u.float()[:, None, None, :] * kc[..., ri, :]).sum(-1))
    h = torch.exp2(c_excl[..., b0, :])
    o = (r_hat * h) @ s_in + A @ vc
    o = o[..., :W, :].reshape(B, H, nc * W, hd)[:, :, :S]
    return o, st


def _strong_rkvwu(B, H, S, hd, seed):
    """Decays as the model clamps them: logw = −exp(x), x in [−8, 3], so
    down to −20 per step (w ≈ 2e-9)."""
    r, k, v, _, u = _rkvwu(B, H, S, hd, seed=seed)
    x = np.random.default_rng(seed + 1).uniform(-8.0, 3.0, size=(B, H, S, hd))
    return r, k, v, (-np.exp(x)).astype(np.float32), u


@pytest.mark.parametrize("B,H,S,hd,chunk,strong,with_s0", [
    (1, 2, 128, 32, 64, False, False),
    (2, 2, 100, 16, 64, True, True),      # strong decays, ragged last chunk, s0
    (1, 3, 77, 64, 64, True, False),
    (1, 2, 45, 16, 8, False, True),       # the reduced configs' chunk of 8
    (1, 1, 50, 32, 16, True, True),
])
def test_rwkv6_chunked_model_matches_plain_version(B, H, S, hd, chunk, strong, with_s0):
    """The chunk-parallel design (sub-chunk factorisation, state scan)
    stays within chip_smoke's bound of the plain chunk loop, strong decays
    and a ragged chunk from s0 included: nothing overflows or drifts."""
    arrs = (_strong_rkvwu if strong else _rkvwu)(B, H, S, hd, seed=S)
    ts = [torch.from_numpy(x) for x in arrs]
    s0 = (torch.from_numpy(np.random.default_rng(7).normal(size=(B, H, hd, hd))
                           .astype(np.float32)) if with_s0 else None)
    o, st = _rwkv6_chunked_model(*ts, chunk=chunk, s0=s0)
    want_o, want_s = rwkv6_scan_plain(*ts, chunk=chunk, s0=s0)
    assert bool(torch.isfinite(o).all() and torch.isfinite(st).all())
    _within(o, want_o, RWKV_TOL, RWKV_TOL)
    _within(st, want_s, RWKV_TOL, RWKV_TOL)


@pytest.mark.parametrize("B,H,S,hd,chunk,strong", [
    (1, 2, 128, 32, 64, False), (2, 1, 128, 64, 64, True), (1, 2, 64, 16, 16, True),
])
def test_rwkv6_chunked_model_matches_ref_and_pallas(jx, B, H, S, hd, chunk, strong):
    arrs = (_strong_rkvwu if strong else _rkvwu)(B, H, S, hd, seed=hd)
    o, st = _rwkv6_chunked_model(*(torch.from_numpy(x) for x in arrs), chunk=chunk)
    ja = [jx.jnp.asarray(x) for x in arrs]
    for want_o, want_s in (jx.ref.rwkv6_ref(*ja), jx.rwkv6(*ja, chunk=chunk, interpret=True)):
        _within(o, want_o, RWKV_TOL, RWKV_TOL)
        _within(st, want_s, RWKV_TOL, RWKV_TOL)


def test_rwkv6_chunked_model_chains_decode_steps():
    """One prefill then S = 1 steps from its state (the decode route's
    shape) equal one longer call of the plain version."""
    arrs = _strong_rkvwu(1, 2, 40, 16, seed=3)
    ts = [torch.from_numpy(x) for x in arrs]
    o, st = _rwkv6_chunked_model(*(t[:, :, :36] for t in ts[:4]), ts[4], chunk=16)
    outs = [o]
    for t in range(36, 40):
        o, st = _rwkv6_chunked_model(*(x[:, :, t:t + 1] for x in ts[:4]), ts[4], s0=st)
        outs.append(o)
    want_o, want_s = rwkv6_scan_plain(*ts, chunk=16)
    _within(torch.cat(outs, 2), want_o, RWKV_TOL, RWKV_TOL)
    _within(st, want_s, RWKV_TOL, RWKV_TOL)


def _e2(x):
    """2^x of an exponent that is ≤ 0 in exact arithmetic (clamped at 0)."""
    return torch.exp2(x.clamp_max(0))


def _rwkv6_pair_sums(R, K, P, C, up, in_r=None, in_k=None):
    """Pass C's three pair sums as the kernel factors them, on (…, 64, 64)
    tiles: r, k, P = do·vᵀ and the inclusive log2 decays C. Four sub-chunks
    of 16 rows, b the first and e the last row of one; for t in sub-chunk i
    and j in m < i, e^{ce_t − c_j} splits into factors with exponents ≤ 0:

    - the pair matrix's off-diagonal block (i, m) is (r ⊙ 2^{ce_t −
      c_{e_m}})·(k ⊙ 2^{c_{e_m} − c_j})ᵀ, i.e. (r̂_i ⊙ g_im)·k̂_mᵀ;
    - dr's sum of rows i is 2^{ce_t − ce_{b_i}} ⊙ P_{i, <b_i}·(k ⊙ 2^{ce_{b_i}
      − c_j}), dk's sum of rows m is 2^{c_{e_m} − c_j} ⊙ P_{>e_m, m}ᵀ·(r ⊙
      2^{ce_t − c_{e_m}});
    - the four diagonal blocks take one exponential a pair and channel, the
      u-bonus on the pair matrix's diagonal.

    ``in_r`` (S_in·do) and ``in_k`` (dS_out·v), the terms of dr^w and dk^w
    through the chunk's states, enter as the kernel folds them: under the
    same outer factor, scaled by 2^{ce_{b_i}} and 2^{c_63 − c_{e_m}}.
    Returns (A, (dr^w, dk^w)), or (A, (dr's sum, dk's sum)) without them."""
    Ce = torch.nn.functional.pad(C[..., :-1, :], (0, 0, 1, 0))
    A = torch.zeros(P.shape)
    off_r, off_k = torch.zeros(R.shape), torch.zeros(R.shape)
    diag_r, diag_k = torch.zeros(R.shape), torch.zeros(R.shape)
    outer_r, outer_k = torch.ones(R.shape), torch.ones(R.shape)
    in_r = torch.zeros(R.shape) if in_r is None else in_r
    in_k = torch.zeros(R.shape) if in_k is None else in_k
    tri = torch.tril(torch.ones((16, 16), dtype=torch.bool), -1)
    for i in range(4):
        ri, b, e = slice(16 * i, 16 * i + 16), 16 * i, 16 * i + 15
        E = torch.where(tri[..., None], _e2(Ce[..., ri, None, :] - C[..., None, ri, :]), 0.0)
        A[..., ri, ri] = (R[..., ri, None, :] * K[..., None, ri, :] * E).sum(-1) + \
            torch.diag_embed((R[..., ri, :] * up * K[..., ri, :]).sum(-1))
        Pi = P[..., ri, ri]
        diag_r[..., ri, :] = (Pi[..., None] * K[..., None, ri, :] * E).sum(-2)
        diag_k[..., ri, :] = (Pi[..., None] * R[..., ri, None, :] * E).sum(-3)
        for m in range(i):
            rm, em = slice(16 * m, 16 * m + 16), 16 * m + 15
            A[..., ri, rm] = (R[..., ri, :] * _e2(Ce[..., ri, :] - C[..., em:em + 1, :])) @ (
                K[..., rm, :] * _e2(C[..., em:em + 1, :] - C[..., rm, :])).transpose(-1, -2)
        if i > 0:
            off_r[..., ri, :] = P[..., ri, :b] @ (K[..., :b, :] * _e2(Ce[..., b:b + 1, :]
                                                                       - C[..., :b, :]))
        if i < 3:
            off_k[..., ri, :] = P[..., e + 1:, ri].transpose(-1, -2) @ (
                R[..., e + 1:, :] * _e2(Ce[..., e + 1:, :] - C[..., e:e + 1, :]))
        outer_r[..., ri, :] = _e2(Ce[..., ri, :] - Ce[..., b:b + 1, :])
        outer_k[..., ri, :] = _e2(C[..., e:e + 1, :] - C[..., ri, :])
        in_r[..., ri, :] = in_r[..., ri, :] * _e2(Ce[..., b:b + 1, :])
        in_k[..., ri, :] = in_k[..., ri, :] * _e2(C[..., -1:, :] - C[..., e:e + 1, :])
    return A, (outer_r * (in_r + off_r) + diag_r, outer_k * (in_k + off_k) + diag_k)


def _rwkv6_bwd_kernel_model(r, k, v, logw, u, do, *, chunk=64, s0=None, ds_final=None):
    """The backward kernel's three passes in plain torch, f32 products (the
    kernel's 3 × TF32 split carries about 21 bits of each operand).

    Chunks of W tokens and hd channels zero-padded to 64 × 64 (logw = 0,
    r = k = v = do = 0), cumulative decays in log2 units; the forward's
    chunk states as its passes 1-2 leave them in the scratch. Pass A: every
    chunk's dU = (r ⊙ 2^{ce})ᵀ·do and decay; pass B: dS_out of each chunk
    from the last to the first, dS_in = 2^{c_63} ⊙ dS_out + dU, and dS0;
    pass C: P = do·vᵀ, the pair matrix and the pair sums of dr and dk
    factored over 16-token sub-chunks (``_rwkv6_pair_sums``), the products
    with S_in and dS_out folded into them as the kernel folds them, dv =
    Aᵀ·do + k̃·dS_out, X from the next chunk's S_in (or S_final), dlogw as
    the reverse sum over the chunk's 64 rows, du from one partial per chunk
    and batch row.
    """
    B, H, S, hd = r.shape
    W = min(chunk, S)
    nc = -(-S // W)
    F = torch.nn.functional

    def tile(t):       # (B, H, S, hd) -> (B, H, nc, 64, 64)
        t = F.pad(t.float(), (0, 0, 0, nc * W - S)).reshape(B, H, nc, W, hd)
        return F.pad(t, (0, 64 - hd, 0, 64 - W))
    sq = lambda m: F.pad(m.float(), (0, 64 - hd, 0, 64 - hd))       # noqa: E731
    R, K, V, D, L = (tile(t) for t in (r, k, v, do, logw))
    up = F.pad(u.float(), (0, 64 - hd))[None, :, None, None, :]        # (1, H, 1, 1, 64)
    C = torch.cumsum(L / math.log(2), dim=-2)
    Ce = F.pad(C[..., :-1, :], (0, 0, 1, 0))
    last = C[..., -1:, :]
    # the forward's states (passes 1-2)
    U = (K * torch.exp2(last - C)).transpose(-1, -2) @ V
    dec = torch.exp2(C[..., -1, :])
    st = torch.zeros((B, H, 64, 64)) if s0 is None else sq(s0)
    s_in = []
    for n in range(nc):
        s_in.append(st)
        st = dec[:, :, n, :, None] * st + U[:, :, n]
    s_in = torch.stack(s_in, 2)
    # pass A
    dU = (R * torch.exp2(Ce.clamp_max(0))).transpose(-1, -2) @ D
    # pass B
    dS = torch.zeros((B, H, 64, 64)) if ds_final is None else sq(ds_final)
    ds_out = [None] * nc
    for n in range(nc - 1, -1, -1):
        ds_out[n] = dS
        dS = dec[:, :, n, :, None] * dS + dU[:, :, n]
    G = torch.stack(ds_out, 2)
    # pass C
    s_next = torch.cat([s_in[:, :, 1:], st[:, :, None]], 2)
    X = (G * s_next).sum(-1)                                      # (B, H, nc, 64)
    P = D @ V.transpose(-1, -2)
    A, (drw, dkw) = _rwkv6_pair_sums(R, K, P, C, up, D @ s_in.transpose(-1, -2),
                                     V @ G.transpose(-1, -2))
    Ptt = torch.diagonal(P, dim1=-2, dim2=-1)[..., None]
    dr, dk = drw + up * K * Ptt, dkw + up * R * Ptt
    dv = A.transpose(-1, -2) @ D + (K * torch.exp2((last - C).clamp_max(0))) @ G
    q, kap = R * drw, K * dkw
    z = torch.flip(torch.cumsum(torch.flip(q - kap, (-2,)), -2), (-2,))
    dlogw = X[..., None, :] + z - q
    du = (R * K * Ptt).sum(-2).sum((0, 2))[:, :hd]
    untile = lambda t: t[..., :W, :hd].reshape(B, H, nc * W, hd)[:, :, :S]   # noqa: E731
    return (*(untile(t) for t in (dr, dk, dv, dlogw)), du, dS[..., :hd, :hd])


@pytest.mark.parametrize("B,H,S,hd,chunk,strong,with_s0,with_df", [
    (1, 2, 128, 32, 64, False, False, False),
    (2, 2, 100, 16, 64, True, True, True),     # strong decays, ragged last chunk, s0, dS_final
    (1, 3, 77, 64, 64, True, False, True),
    (1, 2, 45, 16, 8, False, True, False),     # the reduced configs' chunk of 8
    (1, 1, 1, 64, 64, False, True, True),      # one token
])
def test_rwkv6_bwd_kernel_model_matches_plain_version(B, H, S, hd, chunk, strong, with_s0,
                                                      with_df):
    """The backward kernel's design (padded 64 × 64 tiles, log2 decays, the
    three passes, X from the next chunk's state, dlogw as a reverse sum)
    within chip_smoke's bound of ``rwkv6_scan_bwd_plain``: 2e-3·|plain| +
    1e-3·max|plain| of each gradient."""
    arrs = (_strong_rkvwu if strong else _rkvwu)(B, H, S, hd, seed=S + hd)
    ts = [torch.from_numpy(x) for x in arrs]
    rng = np.random.default_rng(S)
    do = torch.from_numpy(rng.normal(size=(B, H, S, hd)).astype(np.float32))
    s0, df = (torch.from_numpy(rng.normal(size=(B, H, hd, hd)).astype(np.float32)) if w
              else None for w in (with_s0, with_df))
    got = _rwkv6_bwd_kernel_model(*ts, do, chunk=chunk, s0=s0, ds_final=df)
    want = rwkv6_scan_bwd_plain(*ts, do, chunk=chunk, s0=s0, ds_final=df)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _within(g, w, RWKV_TOL, 1e-3 * float(w.abs().max()))


@pytest.mark.parametrize("B,H,S,hd,chunk,strong", [
    (1, 2, 128, 32, 64, False),
    (2, 2, 100, 16, 64, True),      # strong decays, ragged last chunk
    (1, 3, 77, 64, 64, True),
    (1, 2, 45, 16, 8, False),       # the reduced configs' chunk of 8
    (1, 1, 1, 64, 64, False),       # one token
])
def test_rwkv6_bwd_factored_pair_sums_match_per_pair_sums(B, H, S, hd, chunk, strong):
    """Pass C's factored pair sums (sub-chunk products off the diagonal
    blocks, per-pair exponentials only on them) equal the three sums taken
    with one exponential a pair and channel, on the chunk tiles of the
    same inputs, strong decays included: each within 1e-5 of its largest
    value (f32 arithmetic in another order; nothing overflows)."""
    arrs = (_strong_rkvwu if strong else _rkvwu)(B, H, S, hd, seed=S + hd)
    r, k, v, logw, u = (torch.from_numpy(x) for x in arrs)
    do = torch.from_numpy(np.random.default_rng(S).normal(size=(B, H, S, hd)).astype(np.float32))
    W, F = min(chunk, S), torch.nn.functional
    nc = -(-S // W)

    def tile(t):
        t = F.pad(t.float(), (0, 0, 0, nc * W - S)).reshape(B, H, nc, W, hd)
        return F.pad(t, (0, 64 - hd, 0, 64 - W))
    R, K, V, D, L = (tile(t) for t in (r, k, v, do, logw))
    up = F.pad(u, (0, 64 - hd))[None, :, None, None, :]
    C = torch.cumsum(L / math.log(2), dim=-2)
    Ce = F.pad(C[..., :-1, :], (0, 0, 1, 0))
    P = D @ V.transpose(-1, -2)
    A, (sum_r, sum_k) = _rwkv6_pair_sums(R, K, P, C, up)
    tri = torch.tril(torch.ones((64, 64), dtype=torch.bool), -1)
    E = torch.where(tri[..., None], _e2(Ce[..., :, None, :] - C[..., None, :, :]), 0.0)
    want = ((R[..., :, None, :] * K[..., None, :, :] * E).sum(-1)
            + torch.diag_embed((R * up * K).sum(-1)),
            (P[..., None] * K[..., None, :, :] * E).sum(-2),
            (P[..., None] * R[..., :, None, :] * E).sum(-3))
    for got, w in zip((A, sum_r, sum_k), want):
        assert bool(torch.isfinite(got).all())
        _within(got, w, 1e-5, 1e-5 * float(w.abs().max()))


def test_kernel_routes_by_type_and_length(monkeypatch):
    """bf16 attention goes to the tensor-core kernel and f32 to the CUDA-core
    one; an RWKV6 call with S = 1 to the decode route, longer ones to the
    chunked route; each bumps its own counter and the sum. Nothing launches:
    the libraries are stand-ins and the tensors stay on the CPU."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    libs = stub_libraries(monkeypatch)
    for name in ("launches", "launches_tc", "launches_f32"):
        monkeypatch.setattr(flash_attention, name, 0)
    for name in ("launches", "launches_chunked", "launches_decode"):
        monkeypatch.setattr(rwkv6_scan, name, 0)

    q, k = torch.zeros((1, 4, 8, 64)), torch.zeros((1, 2, 8, 64))
    fa._launch(q.bfloat16(), k.bfloat16(), k.bfloat16(), True, 0, 0.125, 0.0)
    fa._launch(q, k, k, True, 0, 0.125, 0.0)
    fa._launch(q.bfloat16(), k.bfloat16(), k.bfloat16(), True, 4, 0.125, 30.0)
    assert libs["flash_attention_wgmma"].calls == ["flash_attention_wgmma_fwd"] * 2
    assert libs["flash_attention"].calls == ["flash_attention_fwd"]
    assert (flash_attention.launches_tc, flash_attention.launches_f32,
            flash_attention.launches) == (2, 1, 3)

    r, u = torch.zeros((2, 3, 9, 16)), torch.zeros((3, 16))
    one = r[:, :, :1]
    rw._launch(r, r, r, r, u, 4, None)
    rw._launch(one, one, one, one, u, 4, torch.zeros((2, 3, 16, 16)))
    rw._launch(one.bfloat16(), one.bfloat16(), one.bfloat16(), one, u, 4, None)
    assert libs["rwkv6_scan"].calls == ["rwkv6_scan_fwd", "rwkv6_decode_fwd",
                                        "rwkv6_decode_fwd"]
    assert (rwkv6_scan.launches_chunked, rwkv6_scan.launches_decode,
            rwkv6_scan.launches) == (1, 2, 3)
    assert [rw.route(S) for S in (1, 2, 4096)] == ["decode", "chunked", "chunked"]
    # each entry's argument types were set once, when its library loaded
    assert all(set(lib.bound.values()) == {1} for lib in libs.values())
    assert set(libs["rwkv6_scan"].bound) == {"rwkv6_scan_fwd", "rwkv6_decode_fwd"}


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_launch_reaches_its_entry_at_every_length(monkeypatch, with_h0):
    """S = 1 (a decode step) and S > 1 (prefill) both reach rglru_scan_f32
    with (B, S, C) and bump the count once each; the decode step makes one
    allocation, h_last a view beside out; the entry is bound once."""
    import importlib
    rg = importlib.import_module("repro_torch.kernels.rglru_scan")
    libs = stub_libraries(monkeypatch)
    monkeypatch.setattr(rglru_scan, "launches", 0)
    B, C = 2, 12
    h0 = torch.zeros((B, C)) if with_h0 else None
    for S in (1, 5, 1, 33):
        a = torch.zeros((B, S, C))
        out, h_last = rg._launch(a, a, h0)
        args = libs["rglru_scan"].args[-1]
        assert args[2] == (None if h0 is None else h0.data_ptr())
        assert args[3:8] == (out.data_ptr(), h_last.data_ptr(), B, S, C)
        assert out.shape == (B, S, C) and h_last.shape == (B, C)
        shared = out.untyped_storage().data_ptr() == h_last.untyped_storage().data_ptr()
        assert shared == (S == 1)
    assert libs["rglru_scan"].calls == ["rglru_scan_f32"] * 4
    assert rglru_scan.launches == 4
    # the library's two entries (forward and backward) bound once, when it loaded
    assert libs["rglru_scan"].bound == {"rglru_scan_f32": 1, "rglru_scan_bwd_f32": 1}


def test_flash_bf16_route_rejects_a_stride_tma_cannot_take(monkeypatch):
    """A bf16 stride that is not a multiple of 16 bytes raises: no copy."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    stub_libraries(monkeypatch)
    q = torch.zeros((1, 2, 8, 20), dtype=torch.bfloat16)[..., :16]   # row stride 20
    k = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa._launch(q, k, k, True, 0, 0.25, 0.0)
    fa._launch(q.contiguous(), k, k, True, 0, 0.25, 0.0)   # the same tensor, copied by the caller


def _stub_calls(lib, start):
    """(entry, argument count) of a stand-in library's calls from ``start``."""
    return [(e, len(a)) for e, a in zip(lib.calls[start:], lib.args[start:])]


def test_gradients_never_bypass_a_kernel(monkeypatch):
    """On the card, under grad with an input that requires it, every LM
    kernel goes through its autograd Function: the output has a grad_fn and
    its backward launches the kernel's backward entries. Flash attention's
    forward asks the kernel for the log-sum-exp and its backward makes three
    launches (counted by route in ``launches_bwd_tc`` and
    ``launches_bwd_fma``, and in ``launches_bwd``); the RG-LRU scan's
    backward is one launch of ``rglru_scan_bwd_f32``; the RWKV6 scan takes
    the chunked route at every S, a one-token call too, and its backward is
    one call of ``rwkv6_scan_bwd`` (three launches). Under
    ``torch.no_grad()`` every wrapper makes the calls that inputs without
    grad make (serving): the same entries with the same argument counts,
    flash with no log-sum-exp, RWKV6 at S = 1 on the decode route."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rg = importlib.import_module("repro_torch.kernels.rglru_scan")
    rw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    libs = stub_libraries(monkeypatch)
    for name in ("launches", "launches_tc", "launches_f32", "launches_bwd", "launches_bwd_tc",
                 "launches_bwd_fma"):
        monkeypatch.setattr(flash_attention, name, 0)
    for name in ("launches", "launches_bwd"):
        monkeypatch.setattr(rglru_scan, name, 0)
    for name in ("launches", "launches_chunked", "launches_decode", "launches_bwd"):
        monkeypatch.setattr(rwkv6_scan, name, 0)
    q, k = torch.zeros((1, 4, 8, 64)), torch.zeros((1, 2, 8, 64))
    a = torch.zeros((2, 5, 12))
    r, u = torch.zeros((2, 3, 9, 16)), torch.zeros((3, 16))
    one = torch.zeros((2, 3, 1, 16))

    def serve_calls():
        fa._launch(q.bfloat16(), k.bfloat16(), k.bfloat16(), True, 0, 0.125, 0.0)
        fa._launch(q, k, k, True, 4, 0.125, 30.0)
        rg._launch(a, a, None)
        rw._launch(r, r, r, r, u, 4, None)
        rw._launch(one, one, one, one, u, 4, None)

    serve_calls()
    served = {n: _stub_calls(lib, 0) for n, lib in libs.items()}
    assert all(args[4] is None for args in libs["flash_attention_wgmma"].args)  # no lse
    assert libs["rwkv6_scan"].calls == ["rwkv6_scan_fwd", "rwkv6_decode_fwd"]
    start = {n: len(lib.calls) for n, lib in libs.items()}
    for t in (q, k, a, r, one):
        t.requires_grad_(True)
    with torch.no_grad():
        serve_calls()
    assert {n: _stub_calls(lib, start[n]) for n, lib in libs.items()} == served

    out, h_last = rg._launch(a, a, None)
    assert out.grad_fn is not None and h_last.grad_fn is not None
    out.sum().backward()
    assert a.grad.shape == a.shape
    assert _stub_calls(libs["rglru_scan"], 2) == [("rglru_scan_f32", 9), ("rglru_scan_bwd_f32", 12)]
    before = len(libs["rwkv6_scan"].calls)
    for x in (r, one):
        o, s_out = rw._launch(x, x, x, x, u, 4, None)
        assert o.grad_fn is not None and s_out.grad_fn is not None
        o.sum().backward()
        assert x.grad.shape == x.shape
    assert libs["rwkv6_scan"].calls[before:] == ["rwkv6_scan_fwd"] * 2       # S = 1 too
    assert _stub_calls(libs["rwkv6_scan_bwd"], 0) == [("rwkv6_scan_bwd", 51)] * 2
    assert (rglru_scan.launches, rglru_scan.launches_bwd) == (3, 1)
    assert (rwkv6_scan.launches_chunked, rwkv6_scan.launches_decode, rwkv6_scan.launches_bwd,
            rwkv6_scan.launches) == (4, 2, 6, 6)
    for dtype, lib in ((torch.bfloat16, "flash_attention_wgmma"),
                       (torch.float32, "flash_attention")):
        qq, kk = (t.detach().to(dtype).requires_grad_() for t in (q, k))
        before = len(libs[lib].args)
        out = fa._launch(qq, kk, kk, True, 0, 0.125, 0.0)
        assert out.grad_fn is not None and out.shape == qq.shape
        assert libs[lib].args[before][4] is not None          # the lse pointer
        out.backward(torch.ones_like(out))
        assert qq.grad.shape == qq.shape and kk.grad.shape == kk.shape
    assert libs["flash_attention_bwd"].calls == ["flash_attention_bwd_prep",
                                                 "flash_attention_bwd_dkdv",
                                                 "flash_attention_bwd_dq"] * 2
    # the type flag of the prep pass, then the route: bf16 at hd 64 on the
    # tensor cores (2), f32 on the CUDA cores (0)
    assert [a[-2] for a in libs["flash_attention_bwd"].args] == [1, 2, 2, 0, 0, 0]
    assert (flash_attention.launches_bwd_tc, flash_attention.launches_bwd_fma,
            flash_attention.launches_bwd, flash_attention.launches) == (3, 3, 6, 6)
    assert all(set(lib.bound.values()) == {1} for lib in libs.values())


def test_scan_backwards_take_the_forward_s_tensors(monkeypatch):
    """Through the stand-in libraries, under grad: the RG-LRU Function
    hands ``rglru_scan_bwd_f32`` a, the forward's own out (the kernel reads
    h_{t-1} from it) and h0, dout, no dh_last where h_last took no gradient,
    and (B, S, C); the RWKV6 Function hands ``rwkv6_scan_bwd`` the chunk
    states the forward entry wrote (its scratch) and its S_final, a
    dS_final only where S_final took a gradient, the gradients laid out as
    the model's (B, S, H, hd), and (B, H, S, hd, W). One backward launch a
    RG-LRU call, three a RWKV6 call."""
    import importlib
    rg = importlib.import_module("repro_torch.kernels.rglru_scan")
    rw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    libs = stub_libraries(monkeypatch)
    monkeypatch.setattr(rglru_scan, "launches_bwd", 0)
    monkeypatch.setattr(rwkv6_scan, "launches_bwd", 0)
    B, S, C = 2, 6, 8
    a = torch.zeros((B, S, C), requires_grad=True)
    h0 = torch.zeros((B, C))
    out, h_last = rg._launch(a, a, h0)
    out.sum().backward()
    fwd, bwd = libs["rglru_scan"].args
    assert bwd[:3] == (a.data_ptr(), fwd[3], h0.data_ptr())
    assert bwd[4] is None and bwd[8:11] == (B, S, C)
    assert rglru_scan.launches_bwd == 1

    B, H, S, hd, W = 2, 3, 10, 16, 4
    r = torch.zeros((B, S, H, hd)).transpose(1, 2).requires_grad_()
    u = torch.zeros((H, hd))
    for with_final in (False, True):
        o, s_out = rw._launch(r, r, r, r, u, W, None)
        ((o.sum() + s_out.sum()) if with_final else o.sum()).backward()
        fwd = libs["rwkv6_scan"].args[-1]
        bwd = libs["rwkv6_scan_bwd"].args[-1]
        assert bwd[7] == fwd[9] and bwd[8] == fwd[8]       # S_in of each chunk, S_final
        assert (bwd[9] is not None) == with_final          # dS_final
        assert bwd[33:36] == (S * H * hd, hd, H * hd)      # dr in the model's layout
        assert bwd[-6:-1] == (B, H, S, hd, W)
    assert rwkv6_scan.launches_bwd == 6
    assert libs["rwkv6_scan_bwd"].bound == {"rwkv6_scan_bwd": 1}


@pytest.mark.parametrize("dtype,route,hd", [(torch.bfloat16, 2, 64), (torch.float32, 0, 64),
                                            (torch.bfloat16, 2, 256)],
                         ids=["dtype0-2", "dtype1-0", "bf16-hd256"])
def test_flash_backward_hands_its_passes_padded_rows(monkeypatch, dtype, route, hd):
    """The backward's three launches through a stand-in library: prep reads
    the forward's lse and writes L (lse in log2 units) and D, both (B, H, S)
    with S padded to a multiple of 64, from one allocation; both passes
    read those two; the bf16 (wgmma) route, hd 256 included, hands q, k, v
    and dO over with TMA-legal strides (a batch of one steps by 8
    elements), the f32 route with their own."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    libs = stub_libraries(monkeypatch)
    B, H, KV, S = 1, 4, 2, 70
    q, o, do = (torch.zeros((B, S, H, hd), dtype=dtype).transpose(1, 2) for _ in range(3))
    k = torch.zeros((B, S, KV, hd), dtype=dtype).transpose(1, 2)
    lse = torch.zeros((B, H, S))
    fa._backward(q, k, k, o, lse, do, True, 0, 0.125, 0.0)
    lib = libs["flash_attention_bwd"]
    assert lib.calls == list(fa._BWD_PASSES)
    prep, dkdv, dq = lib.args
    assert prep[2] == lse.data_ptr() and prep[-2] == int(dtype == torch.bfloat16)
    L, D = prep[3], prep[4]
    assert D - L == B * H * fa.BWD_ROW_PAD * 2 * 4          # S = 70 padded to 128
    assert dkdv[4:6] == dq[4:6] == (L, D)
    assert dkdv[:4] == dq[:4] == (q.data_ptr(), k.data_ptr(), k.data_ptr(), do.data_ptr())
    assert dkdv[-2] == dq[-2] == route and dkdv[34] == dq[34] == hd
    want = (8 if route == 2 else S * H * hd, hd, H * hd)   # q's (batch, head, sequence)
    assert dkdv[9:12] == dq[9:12] == want


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
def test_cuda_rglru_ring_sweep_bit_for_bit(card):
    """Lengths around the ring's 32-step stages (S = 1 is a decode step),
    a tile-aligned and a ragged channel count, one and four batch rows,
    with and without h0; then a base 4 bytes off 16-byte alignment (the
    scalar kernel). Every case equal to the plain version bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(B, S, C, with_h0, 0) for S in (1, 7, 31, 32, 33, 4096) for C in (4096, 100)
             for B in (1, 4) for with_h0 in (False, True)]
    for B, S, C, with_h0, offset in cases + [(2, 45, 64, True, 1)]:
        flat = torch.rand(2 * B * S * C + offset, generator=gen, device="cuda")
        a = flat[offset:offset + B * S * C].view(B, S, C)
        b = flat[offset + B * S * C:].view(B, S, C) - 0.5
        h0 = torch.randn((B, C), generator=gen, device="cuda") if with_h0 else None
        out, h = rglru_scan(a, b, h0)
        want_o, want_h = rglru_scan_plain(a, b, h0)
        assert torch.equal(out, want_o) and torch.equal(h, want_h), (B, S, C, with_h0, offset)


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


@pytest.mark.cuda
def test_cuda_flash_tensor_core_route_matches_plain_version(card):
    """The bf16 route at every head_dim the wrapper takes: ragged S, window
    and none, soft-cap, GQA at H/KV = 2 and 16, the model's strided
    (B, S, heads, hd) views; held at chip_smoke's 2^-7·|plain| + 1e-5."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(1, 4, 2, 200, hd, win, 0.0) for hd in HEAD_DIMS for win in (0, 64)]
    cases += [(2, 16, 1, 333, 128, 100, 0.0), (1, 16, 1, 130, 256, 0, 0.0),
              (1, 2, 2, 190, 64, 0, 30.0), (1, 4, 4, 1, 32, 0, 0.0)]
    for B, H, KV, S, hd, win, softcap in cases:
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda").bfloat16()
                   .transpose(1, 2) for n in (H, KV, KV))
        before = (flash_attention.launches_tc, flash_attention.launches_f32)
        got = flash_attention(q, k, v, window=win, softcap=softcap)
        torch.cuda.synchronize()
        assert (flash_attention.launches_tc, flash_attention.launches_f32) == (
            before[0] + 1, before[1])
        want = flash_attention_plain(q, k, v, window=win, softcap=softcap)
        _within(got, want, FLASH_RTOL, FLASH_ATOL)
    # contiguous (B, heads, S, hd) inputs go in as they are; causal and not
    q = torch.randn((1, 4, 150, 64), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, 2, 150, 64), generator=gen, device="cuda").bfloat16()
    for causal, win in ((True, 50), (False, 0), (False, 40)):
        _within(flash_attention(q, k, k, causal=causal, window=win),
                     flash_attention_plain(q, k, k, causal=causal, window=win),
                     FLASH_RTOL, FLASH_ATOL)
    # a row stride of 40 bytes is not a TMA stride: the wrapper raises, no copy
    q = torch.randn((1, 2, 8, 20), generator=gen, device="cuda").bfloat16()[..., :16]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(q, q, q)


@pytest.mark.cuda
def test_cuda_rwkv6_routes_match_plain_version(card):
    """The chunked route (prefill, from s0, a ragged chunk, strong decays)
    and the decode route (S = 1), and decode steps chained after one
    prefill against one call of the plain version over the whole sequence."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def inputs(B, H, S, hd, dtype, strong=False):
        r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
                   .transpose(1, 2) for _ in range(3))
        x = (torch.rand((B, S, H, hd), generator=gen, device="cuda") * 11 - 8 if strong
             else 0.5 * torch.randn((B, S, H, hd), generator=gen, device="cuda"))
        return r, k, v, -torch.exp(x).transpose(1, 2)

    for B, H, S, hd, chunk, dtype, with_s0, strong in (
            (2, 4, 300, 64, 64, torch.bfloat16, False, False),
            (2, 4, 300, 64, 64, torch.bfloat16, True, True),
            (1, 3, 77, 32, 16, torch.float32, True, True),
            (1, 2, 45, 16, 8, torch.float32, False, False),
            (4, 48, 1, 64, 64, torch.bfloat16, True, False),
            (2, 3, 1, 32, 64, torch.float32, False, True)):
        r, k, v, logw = inputs(B, H, S, hd, dtype, strong)
        u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
        s0 = torch.randn((B, H, hd, hd), generator=gen, device="cuda") if with_s0 else None
        counter = "launches_decode" if S == 1 else "launches_chunked"
        before = getattr(rwkv6_scan, counter)
        o, s = rwkv6_scan(r, k, v, logw, u, chunk=chunk, s0=s0)
        torch.cuda.synchronize()
        assert getattr(rwkv6_scan, counter) == before + 1
        want_o, want_s = rwkv6_scan_plain(r, k, v, logw, u, chunk=chunk, s0=s0)
        _within(o, want_o, RWKV_TOL, RWKV_TOL)
        _within(s, want_s, RWKV_TOL, RWKV_TOL)

    r, k, v, logw = inputs(2, 4, 68, 64, torch.bfloat16, strong=True)
    u = 0.5 * torch.randn((4, 64), generator=gen, device="cuda")
    o, s = rwkv6_scan(r[:, :, :64], k[:, :, :64], v[:, :, :64], logw[:, :, :64], u)
    outs = [o]
    for t in range(64, 68):
        o, s = rwkv6_scan(r[:, :, t:t + 1], k[:, :, t:t + 1], v[:, :, t:t + 1],
                          logw[:, :, t:t + 1], u, s0=s)
        outs.append(o)
    want_o, want_s = rwkv6_scan_plain(r, k, v, logw, u)
    _within(torch.cat(outs, 2), want_o, RWKV_TOL, RWKV_TOL)
    _within(s, want_s, RWKV_TOL, RWKV_TOL)


@pytest.mark.cuda
def test_cuda_flash_backward_matches_plain_versions(card):
    """The backward kernel's routes (wgmma for bf16, hd 256 split over the
    warpgroups; CUDA cores for f32) at every head_dim, f32 and bf16, GQA,
    MQA, window, soft-cap,
    ragged S, the model's strided views, and qwen2-0.5b's and olmo-1b's
    train shapes at batch 1: against ``flash_attention_bwd_plain`` on the
    same o and lse (f32 1e-4, bf16 one rounding: 2^-7·|plain| +
    1e-4·max|plain|) and against autograd of the plain version in f32 (bf16:
    its D reads the bf16-rounded o, and both round once, so 2^-6·|plain| +
    1e-2·max|plain|); the log-sum-exp of each forward route against the
    plain version's; a second backward call on the same inputs gives the
    same bits (no atomics: every sum in one block, in a fixed order)."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [(1, 4, 2, 150, hd, win, 0.0, dt) for hd in HEAD_DIMS for win in (0, 40)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 16, 1, 333, 256, 100, 0.0, torch.bfloat16),
              (2, 4, 1, 130, 64, 0, 30.0, torch.float32),
              (1, 14, 2, 77, 64, 0, 30.0, torch.bfloat16),
              (1, 14, 2, 2048, 64, 0, 0.0, torch.bfloat16),      # qwen2-0.5b's train shape
              (1, 16, 16, 2048, 128, 0, 0.0, torch.bfloat16)]    # olmo-1b's
    for B, H, KV, S, hd, win, cap, dt in cases:
        q, k, v, do = (torch.randn((B, S, n, hd), generator=gen, device="cuda").to(dt)
                       .transpose(1, 2) for n in (H, KV, KV, H))
        qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
        counter = "launches_bwd_tc" if dt == torch.bfloat16 else "launches_bwd_fma"
        before = (flash_attention.launches, getattr(flash_attention, counter))
        out = flash_attention(qa, ka, va, window=win, softcap=cap)
        dq, dk, dv = torch.autograd.grad(out, (qa, ka, va), do)
        torch.cuda.synchronize()
        assert (flash_attention.launches, getattr(flash_attention, counter)) == (
            before[0] + 1, before[1] + 3)
        o, lse = fa._forward(q, k, v, True, win, 1.0 / hd ** 0.5, cap, with_lse=True)
        po, plse = flash_attention_plain(q, k, v, window=win, softcap=cap, return_lse=True)
        _within(lse, plse, 1e-5, 1e-5)
        first = fa._backward(q, k, v, o, lse, do, True, win, 1.0 / hd ** 0.5, cap)
        again = fa._backward(q, k, v, o, lse, do, True, win, 1.0 / hd ** 0.5, cap)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, window=win, softcap=cap)
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        auto = torch.autograd.grad(flash_attention_plain(qf, kf, vf, window=win, softcap=cap),
                                   (qf, kf, vf), do.float())
        for got, w, a in zip((dq, dk, dv), want, auto):
            m = float(w.float().abs().max())
            if dt == torch.float32:
                _within(got, w, 1e-4, 1e-4 * m)
                _within(got, a, 1e-4, 1e-4 * m)
            else:
                _within(got, w, 2.0 ** -7, 1e-4 * m)
                _within(got, a, 2.0 ** -6, 1e-2 * m)


@pytest.mark.cuda
def test_cuda_scan_backwards_match_plain_versions(card):
    """Both backward kernels over S in {1, 7, 63, 64, 65, 2048}, with and
    without an initial state and a final state's gradient: the RG-LRU's bit
    for bit its plain version (f32, the type it takes), the RWKV6's in f32
    and bf16 within chip_smoke's bounds (2e-3·|plain| + 1e-3·max; bf16 dr,
    dk, dv 2^-7·|plain| + 1e-3·max); then through autograd (the Functions)
    against autograd of the plain forwards at S = 65."""
    import importlib
    rg = importlib.import_module("repro_torch.kernels.rglru_scan")
    rw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for S in (1, 7, 63, 64, 65, 2048):
        for with_state in (False, True):
            B, C = 2, 4096 if S == 2048 else 260
            a = torch.rand((B, S, C), generator=gen, device="cuda")
            b, dout = (torch.randn((B, S, C), generator=gen, device="cuda") for _ in range(2))
            h0, dl = ((torch.randn((B, C), generator=gen, device="cuda") for _ in range(2))
                      if with_state else (None, None))
            out, _ = rg._forward(a, b, h0, share=False)
            got = rg._backward(a, out, h0, dout, dl)
            want = rglru_scan_bwd_plain(a, out, h0, dout, dl)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), (S, with_state)
            for dtype in (torch.float32, torch.bfloat16):
                H, hd, W = 4, 64, 64
                r, k, v, do = (torch.randn((1, S, H, hd), generator=gen, device="cuda")
                               .transpose(1, 2) for _ in range(4))
                r, k, v = (t.to(dtype) for t in (r, k, v))
                logw = -torch.exp(torch.rand((1, S, H, hd), generator=gen, device="cuda") * 11
                                  - 8).transpose(1, 2)
                u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
                s0, df = ((torch.randn((1, H, hd, hd), generator=gen, device="cuda")
                           for _ in range(2)) if with_state else (None, None))
                Wc = min(W, S)
                o, s_out, scratch = rw._forward(r, k, v, logw, u, Wc, s0, "chunked")
                got = rw._backward(r, k, v, logw, u, s_out, scratch, do, df, Wc)
                want = rwkv6_scan_bwd_plain(r, k, v, logw, u, do, chunk=Wc, s0=s0, ds_final=df)
                for i, (g, w) in enumerate(zip(got, want)):
                    rtol = 2.0 ** -7 if i < 3 and dtype == torch.bfloat16 else RWKV_TOL
                    _within(g, w, rtol, 1e-3 * float(w.float().abs().max()))
    # end to end through the Functions at S = 65, against autograd of the plain forwards
    a = torch.rand((2, 65, 260), generator=gen, device="cuda")
    b = torch.randn((2, 65, 260), generator=gen, device="cuda")
    ins = [t.clone().requires_grad_() for t in (a, b)]
    before = rglru_scan.launches_bwd
    got = torch.autograd.grad(rglru_scan(*ins)[0].sum(), ins)
    assert rglru_scan.launches_bwd == before + 1
    ins = [t.clone().requires_grad_() for t in (a, b)]
    for g, w in zip(got, torch.autograd.grad(rglru_scan_plain(*ins)[0].sum(), ins)):
        _within(g, w, 1e-5, 1e-6 * float(w.abs().max()))
    r, k, v = (torch.randn((2, 65, 4, 64), generator=gen, device="cuda").bfloat16()
               .transpose(1, 2) for _ in range(3))
    logw = -torch.exp(0.5 * torch.randn((2, 65, 4, 64), generator=gen, device="cuda")
                      ).transpose(1, 2)
    u = 0.5 * torch.randn((4, 64), generator=gen, device="cuda")
    ins = [t.detach().requires_grad_() for t in (r, k, v, logw, u)]
    before = rwkv6_scan.launches_bwd
    got = torch.autograd.grad(rwkv6_scan(*ins)[0].sum(), ins)
    assert rwkv6_scan.launches_bwd == before + 3
    ins = [t.detach().requires_grad_() for t in (r, k, v, logw, u)]
    want = torch.autograd.grad(rwkv6_scan_plain(*ins)[0].sum(), ins)
    for i, (g, w) in enumerate(zip(got, want)):
        _within(g, w, 2.0 ** -7 if i < 3 else RWKV_TOL, 1e-3 * float(w.float().abs().max()))
