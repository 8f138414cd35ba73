"""The serving slice as a whole: repro_torch's language models against the
JAX reference at reduced width, on the same parameters (JAX's
``init_params``, bridged across) and the same numpy tokens — ``forward``,
``prefill`` and three teacher-forced ``decode_step``s, logits and caches
— in f32 within 1e-4 and in bf16 within the reference's own 0.08
(``tests/test_models.py``). The port's attention, RG-LRU and RWKV6 run
through their kernels' wrappers (the plain versions on the CPU), whose
f32 numerics differ from the reference's bf16-rounded logits on purpose.

Cases: recurrentgemma with a 5-layer plan (unit + the two-layer tail) and
window 8 at P = 8 and 16 (ring wrap); rwkv6 with chunk 8 at P = 16 and a
ragged 13; qwen2-0.5b (16 padded query heads > 4 real > 2 KV heads, QKV
bias, tied embeddings). At P = 12 with window 8 the reference's ring
layout is off (ROADMAP.md Queue 3), so there the port is held to its own
forward. Also: the config copies, the parameter trees at full width, the
exact bridge round trip, the kernel routing table, and the entry point.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import rglru as R  # noqa: E402
from repro_torch.models import rwkv6 as W  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCHS = ("recurrentgemma-9b", "rwkv6-3b", "qwen2-0.5b")
TOL = {"float32": 1e-4, "bfloat16": 0.08}
B, N_DECODE = 2, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: configs, transformer and no-op sharding rules."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.common.sharding import ShardingRules
    from repro.models import transformer as jtransformer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=jconfigs, tf=jtransformer,
        rules=ShardingRules(batch=None, fsdp=None, tensor=None, expert=None))


def _cfg(arch, dtype, **kw):
    """The reduced config of ``arch`` in both packages."""
    over = dict(dtype=dtype, **kw)
    return configs.get_smoke(arch, **over), over


def _tree_close(got, want, tol, where=""):
    """Every leaf of two numpy trees; integer leaves exactly."""
    assert sorted(got) == sorted(want), where
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], tol, f"{where}/{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (f"{where}/{k}", g.shape, w.shape)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{where}/{k}")
        else:
            np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                       rtol=tol, atol=tol, err_msg=f"{where}/{k}")


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _jax_model(jx, arch, over):
    """The reference's reduced config and its parameters (numpy tree)."""
    jcfg = jx.configs.get_smoke(arch, **over)
    jparams, _ = jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))
    return jcfg, jparams, jx.jax.tree.map(np.asarray, jparams)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_field_for_field(jx, arch):
    for port_cfg, ref_cfg in ((configs.get(arch), jx.configs.get(arch)),
                              (configs.get_smoke(arch), jx.configs.get_smoke(arch))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        for prop in ("n_units", "tail_pattern", "is_subquadratic", "param_count"):
            assert getattr(port_cfg, prop) == getattr(ref_cfg, prop), (arch, prop)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_tree_matches_reference(jx, arch):
    """Names, shapes and dtypes of every leaf at full width (padded head
    counts, stacked unit) against the reference's abstract init; the
    port's tree is built on the meta device, so nothing is allocated."""
    cfg = configs.get(arch)
    port = transformer._build_params(cfg, None, torch.device("meta"))
    ref, _ = jx.tf.init_params(jx.configs.get(arch), abstract=True)

    def leaves(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{pre}/{k}")
            else:
                yield f"{pre}/{k}", tuple(v.shape), str(v.dtype).replace("torch.", "")
    assert sorted(leaves(port)) == sorted(leaves(ref))
    n = sum(s and int(np.prod(s)) for _, s, _ in leaves(port))
    if arch == "recurrentgemma-9b":
        assert n == 10_444_771_328
    if arch == "rwkv6-3b":
        assert n == 3_315_831_808
        assert port["unit"]["0_rwkv"]["time"]["bonus_u"].shape == (32, 48, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_layout_and_scale(jx, arch):
    """The port's own init at reduced width: the reference's tree and
    dtypes, each normal leaf's spread at the reference's std."""
    cfg = configs.get_smoke(arch)
    port = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, _, ref = _jax_model(jx, arch, {})
    got = lm_params_to_jax(port)

    def walk(g, w, where):
        assert sorted(g) == sorted(w), where
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{where}/{k}")
                continue
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, (where, k)
            sg, sw = float(np.std(_f32(g[k]))), float(np.std(_f32(w[k])))
            if w[k].size >= 1024 and sw > 0:
                assert abs(sg / sw - 1) < 0.2, (where, k, sg, sw)
    walk(got, ref, "")
    # in bf16 the reference's re-draw skips the unit leaves: every unit
    # repeats the first, and so does the port's
    if cfg.n_units > 1:
        key = f"0_{cfg.block_pattern[0]}"
        for tree in (got, ref):
            leaf = next(v for v in _flat(tree["unit"][key]) if v.ndim >= 3)
            assert all(np.array_equal(leaf[0], leaf[i]) for i in range(cfg.n_units))


def _flat(tree):
    for v in tree.values():
        yield from (_flat(v) if isinstance(v, dict) else (v,))


def test_bridge_round_trip_is_exact(jx):
    for dtype in ("bfloat16", "float32"):
        _, _, ref = _jax_model(jx, "recurrentgemma-9b", {"dtype": dtype})
        port = lm_params_from_jax(ref)
        assert port["embed"].dtype == getattr(torch, dtype)
        back = lm_params_to_jax(port)

        def same(a, b):
            for k in b:
                if isinstance(b[k], dict):
                    same(a[k], b[k])
                else:
                    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                    assert a[k].tobytes() == b[k].tobytes(), k
        same(back, ref)


# ------------------------------------------------------ parity with the reference

CASES = [  # (arch, config overrides, prompt length)
    ("recurrentgemma-9b", dict(n_layers=5, window=8), 8),
    ("recurrentgemma-9b", dict(n_layers=5, window=8), 16),
    ("rwkv6-3b", dict(rwkv_chunk=8), 16),
    ("rwkv6-3b", dict(rwkv_chunk=8), 13),
    ("qwen2-0.5b", dict(), 16),
    # uneven GQA: 6 query heads over 4 KV heads, K and V expanded before the kernel
    ("qwen2-0.5b", dict(n_heads=6, n_kv_heads=4), 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw,P", CASES)
def test_serving_matches_reference(jx, arch, kw, P, dtype):
    """forward, prefill (logits and cache) and 3 teacher-forced decode steps
    (logits and cache after each) against the reference."""
    tol = TOL[dtype]
    cfg, over = _cfg(arch, dtype, **kw)
    jcfg, jparams, ref = _jax_model(jx, arch, over)
    params = lm_params_from_jax(ref)
    toks = _tokens(cfg, P + N_DECODE, seed=P)
    jnp, rules = jx.jnp, jx.rules

    x, _, _ = transformer.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    jxx, _, _ = jx.tf.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg, rules)
    np.testing.assert_allclose(_f32(transformer.unembed(params, x, cfg)),
                               _f32(jx.tf.unembed(jparams, jxx, jcfg, rules)),
                               rtol=tol, atol=tol)

    cache_len = P + N_DECODE
    logits, cache = transformer.prefill(params, {"tokens": torch.from_numpy(toks[:, :P])},
                                        cfg, cache_len)
    jlogits, jcache = jx.tf.prefill(jparams, {"tokens": jnp.asarray(toks[:, :P])}, jcfg,
                                    rules, cache_len)
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=tol, atol=tol)
    _tree_close(lm_params_to_jax(cache), jx.jax.tree.map(np.asarray, jcache), tol, "prefill")

    for i in range(N_DECODE):
        tok, pos = toks[:, P + i:P + i + 1], np.full((B, 1), P + i, np.int32)
        logits, cache = transformer.decode_step(
            params, {"tokens": torch.from_numpy(tok), "pos": torch.from_numpy(pos)}, cache, cfg)
        jlogits, jcache = jx.tf.decode_step(
            jparams, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)}, jcache, jcfg, rules)
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        _tree_close(lm_params_to_jax(cache), jx.jax.tree.map(np.asarray, jcache), tol,
                    f"decode step {i}")


@pytest.mark.parametrize("arch,kw,P", [
    ("recurrentgemma-9b", dict(n_layers=5, window=8), 12),
    ("recurrentgemma-9b", dict(n_layers=5, window=8), 21),
    ("rwkv6-3b", dict(rwkv_chunk=8), 13),
    ("qwen2-0.5b", dict(), 9),
])
def test_prefill_then_decode_equals_own_forward(arch, kw, P):
    """[prefill(P) then decode P..P+2] against the full forward's logits at
    those positions, in f32 — at P = 12 and 21 with window 8 the prompt
    outruns the window by a part of it, where the reference's ring is off."""
    cfg, _ = _cfg(arch, "float32", **kw)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(P), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, P + N_DECODE, seed=P)).long()
    x, _, _ = transformer.forward(params, {"tokens": toks}, cfg)
    want = transformer.unembed(params, x, cfg)
    logits, cache = transformer.prefill(params, {"tokens": toks[:, :P]}, cfg, P + N_DECODE)
    torch.testing.assert_close(logits, want[:, P - 1], rtol=1e-4, atol=1e-4)
    for i in range(N_DECODE):
        step = {"tokens": toks[:, P + i:P + i + 1],
                "pos": torch.full((B, 1), P + i, dtype=torch.int32)}
        logits, cache = transformer.decode_step(params, step, cache, cfg)
        torch.testing.assert_close(logits, want[:, P + i], rtol=1e-4, atol=1e-4)


def test_attention_layers_match_reference_with_softcap(jx):
    """The attention sublayer with a logit soft-cap (no ported config sets
    one; the kernel applies the reference's tanh) and padded heads."""
    from repro.models import layers as jlayers
    cfg, over = _cfg("qwen2-0.5b", "float32", logit_softcap=5.0, window=6)
    _, _, ref = _jax_model(jx, "qwen2-0.5b", over)
    p = lm_params_from_jax(ref)["unit"]["0_attn"]["attn"]
    p0 = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, 20, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (B, 20))
    got, (k, v) = L.self_attention(torch.from_numpy(h), p0, cfg, torch.from_numpy(pos.copy()),
                                   window=cfg.window)
    want, (jk, jv) = jlayers.self_attention(
        jx.jnp.asarray(h), {kk: jx.jnp.asarray(vv[0]) for kk, vv in ref["unit"]["0_attn"]["attn"].items()},
        configs.get_smoke("qwen2-0.5b", **over), jx.rules, jx.jnp.asarray(pos), window=cfg.window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(k), _f32(jk), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ kernel routing

def test_kernel_routing_table(monkeypatch):
    """Every attention layer's prefill goes through flash attention, every
    RG-LRU and RWKV6 layer through its scan, in prefill and in every decode
    step; decode attention is plain torch (the reference's jnp path)."""
    calls = {"flash": 0, "rglru": 0, "rwkv6": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(L, "flash_attention", spy("flash", L.flash_attention))
    monkeypatch.setattr(R, "rglru_scan", spy("rglru", R.rglru_scan))
    monkeypatch.setattr(W, "rwkv6_scan", spy("rwkv6", W.rwkv6_scan))
    for arch, kw, want_prefill, want_step in (
            ("recurrentgemma-9b", dict(n_layers=8, window=4), (2, 6, 0), (0, 6, 0)),
            ("rwkv6-3b", dict(n_layers=3), (0, 0, 3), (0, 0, 3))):
        cfg, _ = _cfg(arch, "float32", **kw)
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        toks = torch.from_numpy(_tokens(cfg, 10)).long()
        for k in calls:
            calls[k] = 0
        _, cache = transformer.prefill(params, {"tokens": toks}, cfg, 12)
        assert tuple(calls.values()) == want_prefill, (arch, calls)
        for k in calls:
            calls[k] = 0
        transformer.decode_step(params, {"tokens": toks[:, :1],
                                         "pos": torch.full((B, 1), 10, dtype=torch.int32)},
                                cache, cfg)
        assert tuple(calls.values()) == want_step, (arch, calls)


# ---------------------------------------------------------------- entry point

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_run_smoke_on_cpu(arch, capsys):
    res = serve.run(arch, smoke=True, batch=2, prompt_len=12, gen=4, device="cpu")
    out = capsys.readouterr().out
    assert "prefill 2x12" in out and "decode 4 steps" in out
    cfg = res["cfg"]
    assert res["tokens"].shape == (2, 5)
    assert int(res["tokens"].min()) >= 0 and int(res["tokens"].max()) < cfg.vocab_size
    assert res["logits"].shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(res["logits"].float()).all())
    # greedy: the first generated token is the prefill logits' argmax
    assert torch.equal(res["tokens"][:, 0], res["prefill_logits"].argmax(-1).cpu())
    # one seed, one run: the same tokens again
    again = serve.run(arch, smoke=True, batch=2, prompt_len=12, gen=4, device="cpu")
    assert torch.equal(again["tokens"], res["tokens"])


def test_serve_cli_and_sampling(capsys):
    serve.main(["--arch", "rwkv6-3b", "--smoke", "--batch", "1", "--prompt-len", "5",
                "--gen", "3", "--temperature", "0.8", "--device", "cpu"])
    assert "decode 3 steps" in capsys.readouterr().out


def test_serve_without_a_card_raises(monkeypatch):
    """``device="cuda"`` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run("rwkv6-3b", smoke=True, prompt_len=4, gen=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-3b", "--smoke"])


def test_unported_kinds_raise():
    """Every sublayer kind and frontend of the reference is ported (the MoE
    MLP, ``cross`` and the frame and patch frontends since ROADMAP.md item
    1c; ``tests/test_torch_families.py`` holds them against JAX), and
    ``remat="dots"`` since item 1d (``test_remat_dots_matches_reference``).
    A kind the reference lacks is refused."""
    for arch in ("qwen3-moe-30b-a3b", "musicgen-large", "llama-3.2-vision-90b"):
        params = transformer.init_params(configs.get_smoke(arch), device="cpu")
        assert ("frame_proj" in params) == (arch == "musicgen-large")
    with pytest.raises(ValueError):
        transformer.init_params(configs.get_smoke("rwkv6-3b", block_pattern=("conv",)),
                                device="cpu")


@pytest.mark.parametrize("arch,kw", [("qwen2-0.5b", {}), ("rwkv6-3b", dict(rwkv_chunk=8)),
                                     ("qwen2-0.5b", dict(n_heads=6, n_kv_heads=4))])
def test_remat_dots_matches_reference(jx, arch, kw):
    """``remat="dots"`` (the matmuls with no batch dimension saved, the rest
    recomputed): loss and every gradient of ``loss_fn`` against
    ``jax.value_and_grad`` of the reference's with the same policy, f32
    1e-4; uneven GQA (6 heads over 4 KV heads) through the same check."""
    cfg, over = _cfg(arch, "float32", remat="dots", **kw)
    jcfg, jparams, ref = _jax_model(jx, arch, over)
    params = lm_params_from_jax(ref)
    toks = _tokens(cfg, 12, seed=4)
    (jloss, _), jgrads = jx.jax.value_and_grad(
        lambda p: jx.tf.loss_fn(p, {"tokens": jx.jnp.asarray(toks)}, jcfg, jx.rules),
        has_aux=True)(jparams)
    leaves = list(_flat(params))
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = transformer.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg)
    grads = iter(torch.autograd.grad(loss, leaves))
    got = lm_params_to_jax(_rebuild(params, grads))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-4, abs=1e-4)
    _tree_close(got, jx.jax.tree.map(np.asarray, jgrads), 1e-4, f"{arch} {kw} grads")


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it).detach()
            for k, v in tree.items()}
