"""The model families of the MoE block, the frame frontend and
cross-attention on the port against the JAX reference, at reduced width on
numpy inputs made from a seed, with JAX's parameters bridged across:
qwen3-moe-30b-a3b (128 experts top-8, reduced to 8 top-2), arctic-480b
(MoE beside a dense residual MLP), musicgen-large (frame embeddings in,
GELU MLP, LayerNorm) and llama-3.2-vision-90b (tokens and patch
embeddings, a unit of 4 self-attention and 1 cross-attention layers).

Held here, all in f32: the MoE block, scatter dispatch and the einsum
oracle, against both of the reference's (output and aux 1e-5), once at
capacity factor 1.25 with tokens dropped and once at 8.0, where scatter
equals the oracle; its sequence chunks; ``forward`` and ``loss_fn`` (the
aux term included, 1e-4) and the FL-weighted losses; one sgd train step
of the two MoE models (parameters 1e-5); prefill and 4 decode steps of
qwen3-moe, musicgen (frames) and llama-vision (patches), logits and caches
1e-4; the configs field for field and their parameter trees; the bridge
on every new leaf; the serve and train entry points; and on the card
(``cuda``), reduced qwen3-moe serving against the CPU.

Top-k ties: the router's probabilities come from continuous random inputs
and weights in f32, where no two of a token's experts tie (a tie would let
``torch.topk`` and ``jax.lax.top_k`` pick differently); the tests assert
the two packages route every token alike.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.launch import serve, specs, train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b", "musicgen-large", "llama-3.2-vision-90b")
MOE = ARCHS[:2]
SERVED = ("qwen3-moe-30b-a3b", "musicgen-large", "llama-3.2-vision-90b")
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: configs, models, specs and no-op sharding rules."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.common.sharding import ShardingRules
    from repro.launch import specs as jspecs
    from repro.models import moe as jmoe
    from repro.models import transformer as jtf
    from repro.models.param import ParamBuilder as JParamBuilder
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=jconfigs, tf=jtf, moe=jmoe, specs=jspecs,
        ParamBuilder=JParamBuilder,
        rules=ShardingRules(batch=None, fsdp=None, tensor=None, expert=None))


def _np_tree(tree):
    """A JAX tree as writable numpy copies."""
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


def _tree_close(got, want, tol, where=""):
    """Every leaf of two numpy trees within tol (abs and rel); ints exact."""
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
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol, atol=tol,
                                       err_msg=f"{where}/{k}")


def _jax_model(jx, arch, **kw):
    """(port cfg, jax cfg, jax params, port params) at reduced width in f32.
    The reference's unit re-draw is keyed by ``hash(cfg.name)``, which
    Python randomises per process; the name's CRC-32 stands in for it, so
    every process draws the same parameters."""
    import builtins
    import zlib
    over = dict(dtype="float32", **kw)
    jcfg = jx.configs.get_smoke(arch, **over)
    jx.tf.hash = lambda x: zlib.crc32(x.encode()) if isinstance(x, str) else builtins.hash(x)
    try:
        jparams, _ = jx.tf.init_params(jcfg, jx.jax.random.PRNGKey(0))
    finally:
        del jx.tf.hash
    return (configs.get_smoke(arch, **over), jcfg, jparams,
            lm_params_from_jax(_np_tree(jparams)))


def _inputs(cfg, S, seed):
    """A numpy batch of S positions for the config's frontend."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        batch = {"frames": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(size=(B, cfg.n_frontend_tokens, cfg.d_model)
                                      ).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_field_for_field(jx, arch):
    for port_cfg, ref_cfg in ((configs.get(arch), jx.configs.get(arch)),
                              (configs.get_smoke(arch), jx.configs.get_smoke(arch))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        for prop in ("n_units", "tail_pattern", "is_subquadratic", "param_count",
                     "active_param_count"):
            assert getattr(port_cfg, prop) == getattr(ref_cfg, prop), (arch, prop)


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}/{k}")
        else:
            yield f"{pre}/{k}", tuple(v.shape), str(v.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_tree_matches_reference(jx, arch):
    """Names, shapes and dtypes of every leaf at full width (expert stacks,
    frame_proj / patch_proj, padded heads) against the reference's abstract
    init, built on the meta device; the count of parameters is the
    reference's tree's."""
    port = transformer._build_params(configs.get(arch), None, torch.device("meta"))
    ref, _ = jx.tf.init_params(jx.configs.get(arch), abstract=True)
    assert sorted(_leaves(port)) == sorted(_leaves(ref))
    n = sum(int(np.prod(s)) for _, s, _ in _leaves(port))
    want = {"qwen3-moe-30b-a3b": 30_079_125_504, "musicgen-large": 2_429_390_848,
            "llama-3.2-vision-90b": 87_733_903_360, "arctic-480b": 477_364_077_568}
    assert n == want[arch]


# ------------------------------------------------------------------ the MoE block

def _moe_inputs(jx, cfg, S, seed):
    """The reference's MoE parameters (f32) and an input whose tokens share
    a strong common direction, so the router crowds a few experts."""
    pb = jx.ParamBuilder(jx.jax.random.PRNGKey(seed), jx.jnp.float32)
    jx.moe.moe_params(pb, cfg)
    p = _np_tree(pb.params["moe"])
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.normal(size=(B, S, cfg.d_model))
         + rng.normal(size=(1, 1, cfg.d_model))).astype(np.float32)
    return x, p


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_block_matches_reference(jx, cf):
    """Scatter dispatch and the einsum oracle, each against the reference's
    pair: the same routing, output and aux within 1e-5. At 1.25 the
    crowded experts drop tokens (asserted); at 8.0 none are dropped and
    scatter equals the oracle."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-moe-30b-a3b", dtype="float32"),
                              capacity_factor=cf)
    S = 64
    x, p = _moe_inputs(jx, cfg, S, seed=3)
    tx, tp = torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}
    jxx, jp = jx.jnp.asarray(x), {k: jx.jnp.asarray(v) for k, v in p.items()}

    _, topi, _ = M._route(tx, tp, cfg)
    _, jtopi, _ = jx.moe._route(jxx, jp, cfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    C = M.capacity(cfg, S)
    assert C == jx.moe.capacity(cfg, S)
    _, keep = M._positions(topi, cfg.n_experts, C)
    drops = int((~keep).sum())
    assert (drops > 0) == (cf == 1.25), drops

    outs = {}
    for name in ("moe_block_scatter", "moe_block_einsum"):
        got, aux = getattr(M, name)(tx, tp, cfg)
        want, jaux = getattr(jx.moe, name)(jxx, jp, cfg, jx.rules)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5, err_msg=name)
        assert float(aux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-5)
        outs[name] = got
    if cf == 8.0:
        torch.testing.assert_close(outs["moe_block_scatter"], outs["moe_block_einsum"],
                                   rtol=1e-5, atol=1e-5)
    else:
        # the dropped assignments' share of the output is gone
        full, _ = M.moe_block_scatter(tx, tp, dataclasses.replace(cfg, capacity_factor=8.0))
        assert not torch.allclose(outs["moe_block_scatter"], full, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("S,chunks", [(36, 6), (37, 1), (32, 8)])
def test_moe_block_sequence_chunks_match_reference(jx, S, chunks, monkeypatch):
    """``moe_block``'s chunk count is the largest up to moe_seq_chunks (8)
    that divides S — a prime S runs one chunk at its own capacity — and
    aux is the chunks' mean."""
    cfg = configs.get_smoke("qwen3-moe-30b-a3b", dtype="float32", capacity_factor=1.0)
    x, p = _moe_inputs(jx, cfg, S, seed=S)
    seen = []
    real = M.moe_block_scatter

    def spy(x, p, cfg):
        seen.append(x.shape[1])
        return real(x, p, cfg)
    monkeypatch.setattr(M, "moe_block_scatter", spy)
    got, aux = M.moe_block(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                           cfg)
    assert seen == [S // chunks] * chunks
    want, jaux = jx.moe.moe_block(jx.jnp.asarray(x), {k: jx.jnp.asarray(v)
                                                      for k, v in p.items()}, cfg, jx.rules)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-5)


# ------------------------------------------------------------------ the models

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(jx, arch):
    """forward's logits and aux, and loss_fn (the aux term included for the
    MoE models), within 1e-4."""
    cfg, jcfg, jparams, params = _jax_model(jx, arch)
    batch = _inputs(cfg, 24, seed=1)
    x, _, aux = transformer.forward(params, _torch(batch), cfg)
    jxx, _, jaux = jx.tf.forward(jparams, _jnp(jx, batch), jcfg, jx.rules)
    np.testing.assert_allclose(_f32(transformer.unembed(params, x, cfg)),
                               _f32(jx.tf.unembed(jparams, jxx, jcfg, jx.rules)),
                               rtol=1e-4, atol=1e-4)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-4, abs=1e-4)
    assert (float(aux) > 0) == bool(cfg.n_experts)
    loss, m = transformer.loss_fn(params, _torch(batch), cfg)
    jloss, jm = jx.tf.loss_fn(jparams, _jnp(jx, batch), jcfg, jx.rules)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4, abs=1e-4)
    assert float(m["xent"]) == pytest.approx(float(jm["xent"]), rel=1e-4, abs=1e-4)
    if cfg.n_experts:
        assert float(loss) - float(m["xent"]) == pytest.approx(
            0.01 * float(aux) / cfg.n_layers, rel=1e-4)


def test_weighted_losses_carry_the_aux_term(jx):
    """``weighted_loss_fn`` and ``unnormalized_loss_fn`` of qwen3-moe (the
    aux term, scaled by max(Σ weight, 1) in the second), a client_weight
    with a zero row."""
    cfg, jcfg, jparams, params = _jax_model(jx, "qwen3-moe-30b-a3b")
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    w = np.array([0.0, 80.0, 7.0], np.float32)
    batch = {"tokens": toks, "client_weight": w}
    loss, m = specs.weighted_loss_fn(params, _torch(batch), cfg)
    jloss, jm = jx.specs.weighted_loss_fn(jparams, _jnp(jx, batch), jcfg, jx.rules)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
    assert float(m["aux"]) == pytest.approx(float(jm["aux"]), rel=1e-5)
    (t, c), (jt, jc) = (specs.unnormalized_loss_fn(params, _torch(batch), cfg),
                        jx.specs.unnormalized_loss_fn(jparams, _jnp(jx, batch), jcfg, jx.rules))
    assert float(c) == float(jc) == 87.0 * 11
    assert float(t) == pytest.approx(float(jt), rel=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_reference(jx, arch):
    """One sgd step through ``make_train_step`` from the same parameters
    and tokens, a client_weight with zero rows: loss and every updated
    parameter (the router and the expert stacks included) within 1e-5."""
    cfg, jcfg, jparams, params = _jax_model(jx, arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    w = np.array([120.0, 0.0, 37.0, 0.0], np.float32)
    from repro.optim import make_optimizer as jmake
    jstep = jx.jax.jit(jx.specs.make_train_step(jcfg, jx.rules, "sgd", 0.5, 1))
    jnew, _, jloss = jstep(jparams, jmake("sgd").init(jparams),
                           {"tokens": jx.jnp.asarray(toks), "client_weight": jx.jnp.asarray(w)})
    step = specs.make_train_step(cfg, "sgd", 0.5)
    new, _, loss = step(params, {}, {"tokens": torch.from_numpy(toks),
                                     "client_weight": torch.from_numpy(w)})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
    _tree_close(lm_params_to_jax(new), _np_tree(jnew), 1e-5, arch)
    moved = new["unit"]["0_attn"]["moe"]["router"] - params["unit"]["0_attn"]["moe"]["router"]
    assert float(moved.abs().max()) > 0


N_DECODE = 4


@pytest.mark.parametrize("arch", SERVED)
def test_serving_matches_reference(jx, arch):
    """prefill (logits and cache) and 4 decode steps (logits and cache after
    each): tokens for qwen3-moe, a fresh frame a step for musicgen, tokens
    with the same media at every step for llama-vision; within 1e-4."""
    cfg, jcfg, jparams, params = _jax_model(jx, arch)
    P = 16
    full = _inputs(cfg, P + N_DECODE, seed=P)
    key = "frames" if cfg.frontend == "frames" else "tokens"
    head = {k: (v[:, :P] if k in (key, "labels") else v) for k, v in full.items()}
    cache_len = P + N_DECODE
    logits, cache = transformer.prefill(params, _torch(head), cfg, cache_len)
    jlogits, jcache = jx.tf.prefill(jparams, _jnp(jx, head), jcfg, jx.rules, cache_len)
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-4, atol=1e-4)
    _tree_close(lm_params_to_jax(cache), _np_tree(jcache), 1e-4, "prefill")
    for i in range(N_DECODE):
        step = {key: full[key][:, P + i:P + i + 1], "pos": np.full((B, 1), P + i, np.int32)}
        if "patches" in full:
            step["media"] = full["patches"]
        logits, cache = transformer.decode_step(params, _torch(step), cache, cfg)
        jlogits, jcache = jx.tf.decode_step(jparams, _jnp(jx, step), jcache, jcfg, jx.rules)
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode step {i}")
        _tree_close(lm_params_to_jax(cache), _np_tree(jcache), 1e-4, f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_every_new_leaf(jx, arch):
    """JAX's reduced parameters through the bridge and back, bit for bit, in
    bf16 and f32: the expert stacks, the router, the dense residual MLP,
    frame_proj and patch_proj."""
    for dtype in ("bfloat16", "float32"):
        ref = _np_tree(jx.tf.init_params(jx.configs.get_smoke(arch, dtype=dtype),
                                         jx.jax.random.PRNGKey(0))[0])
        port = lm_params_from_jax(ref)
        back = lm_params_to_jax(port)
        names = {name for name, _, _ in _leaves(port)}
        for leaf in {"qwen3-moe-30b-a3b": ["/unit/0_attn/moe/wg", "/unit/0_attn/moe/router"],
                     "arctic-480b": ["/unit/0_attn/moe/wd", "/unit/0_attn/mlp/wu"],
                     "musicgen-large": ["/frame_proj", "/unit/0_attn/mlp/b1"],
                     "llama-3.2-vision-90b": ["/patch_proj", "/unit/4_cross/attn/wq"]}[arch]:
            assert leaf in names, leaf

        def same(a, b):
            for k in b:
                if isinstance(b[k], dict):
                    same(a[k], b[k])
                else:
                    assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        same(back, ref)


def test_flash_runs_every_self_attention_layer_and_no_cross_layer(monkeypatch):
    """llama-vision's prefill sends its 4 self-attention layers a unit
    through flash attention and its cross-attention layer through plain
    torch, as the reference computes it; decode reaches no kernel."""
    calls = []
    real = L.flash_attention
    monkeypatch.setattr(L, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = configs.get_smoke("llama-3.2-vision-90b", dtype="float32", n_layers=10)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _torch(_inputs(cfg, 10, seed=2))
    _, cache = transformer.prefill(params, batch, cfg, 12)
    assert len(calls) == 8
    transformer.decode_step(params, {"tokens": batch["tokens"][:, :1], "media": batch["patches"],
                                     "pos": torch.full((B, 1), 10, dtype=torch.int32)},
                            cache, cfg)
    assert len(calls) == 8


def test_cross_attention_matches_reference_across_query_blocks(jx):
    """The cross-attention sublayer with query blocks (q_chunk 4 of 10
    rows, the last ragged) against the reference's one block."""
    from repro.models import layers as jlayers
    cfg, jcfg, _, params = _jax_model(jx, "llama-3.2-vision-90b", q_chunk=4)
    p = {k: v[0] for k, v in params["unit"]["4_cross"]["attn"].items()}
    rng = np.random.default_rng(5)
    h = rng.normal(size=(B, 10, cfg.d_model)).astype(np.float32)
    media = rng.normal(size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    got = L.cross_attention(torch.from_numpy(h), p, cfg, torch.from_numpy(media))
    want = jlayers.cross_attention(jx.jnp.asarray(h), {k: jx.jnp.asarray(v.numpy())
                                                       for k, v in p.items()},
                                   jcfg, jx.rules, jx.jnp.asarray(media))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- entry points

def test_decode_frames_differ_per_step():
    """The counterpart of tests/test_lint.py::test_serve_decode_frames_differ_per_step:
    each decode step draws frames of its own; the same (seed, step) gives
    the same frames."""
    f0 = serve.decode_frames(0, 0, 2, 8, "cpu")
    f1 = serve.decode_frames(0, 1, 2, 8, "cpu")
    assert f0.shape == (2, 1, 8) and f0.dtype == torch.bfloat16
    assert not torch.equal(f0, f1), "consecutive decode steps saw equal frames"
    assert torch.equal(serve.decode_frames(0, 1, 2, 8, "cpu"), f1)
    assert not torch.equal(serve.decode_frames(1, 1, 2, 8, "cpu"), f1)


def test_serve_feeds_each_decode_step_its_own_frame(monkeypatch):
    """serve.run's musicgen decode hands every step a different frame at
    its position, and the patch model the same media at every step."""
    seen = []
    real = transformer.decode_step

    def spy(params, batch, cache, cfg):
        seen.append(batch)
        return real(params, batch, cache, cfg)
    monkeypatch.setattr(transformer, "decode_step", spy)
    serve.run("musicgen-large", smoke=True, batch=2, prompt_len=6, gen=3, device="cpu")
    frames = [b["frames"] for b in seen]
    assert [int(b["pos"][0, 0]) for b in seen] == [6, 7, 8] and "tokens" not in seen[0]
    assert all(not torch.equal(frames[i], frames[i + 1]) for i in range(2))
    seen.clear()
    res = serve.run("llama-3.2-vision-90b", smoke=True, batch=2, prompt_len=6, gen=2,
                    device="cpu")
    assert all(b["media"] is res["media"] for b in seen) and len(seen) == 2


@pytest.mark.parametrize("arch", SERVED)
def test_serve_run_takes_the_reference_inputs(jx, arch, capsys):
    """serve.run with JAX's parameters and inputs passed in (prompt=,
    frames=, media=): its prefill logits are the reference's prefill's."""
    cfg, jcfg, jparams, params = _jax_model(jx, arch)
    batch = _inputs(cfg, 12, seed=4)
    res = serve.run(cfg, batch=B, gen=3, device="cpu", params=params,
                    prompt=torch.from_numpy(batch["tokens"]) if "tokens" in batch else None,
                    frames=torch.from_numpy(batch["frames"]) if "frames" in batch else None,
                    media=torch.from_numpy(batch["patches"]) if "patches" in batch else None)
    assert "prefill 2x12" in capsys.readouterr().out
    jlogits, _ = jx.tf.prefill(jparams, _jnp(jx, batch), jcfg, jx.rules, 15)
    np.testing.assert_allclose(_f32(res["prefill_logits"]), _f32(jlogits), rtol=1e-4, atol=1e-4)
    assert res["tokens"].shape == (B, 4) and bool(torch.isfinite(res["logits"]).all())
    # the seeded inputs: one seed, one run
    runs = [serve.run(arch, smoke=True, batch=B, prompt_len=12, gen=3, device="cpu")
            for _ in range(2)]
    assert torch.equal(runs[0]["tokens"], runs[1]["tokens"])


@pytest.mark.parametrize("arch", MOE)
def test_train_run_trains_the_moe_models_on_cpu(arch, capsys):
    """launch.train through the RoundLoop and GradientBackend: 3 steps of
    the reduced MoE model, finite losses, the router's aux in the loss."""
    res = train.run(arch, smoke=True, steps=3, batch=4, seq=16, opt="sgdm", log_every=1,
                    device="cpu")
    hist = list(res["history"])
    assert len(hist) == 3 and all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in hist)
    assert "step 2: loss" in capsys.readouterr().out


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_cuda_moe_serving_matches_cpu():
    """Reduced qwen3-moe (f32) on the card against the CPU from the same
    weights and tokens: prefill and 3 teacher-forced decode steps, logits
    within 1e-4; the prefill's attention on flash's f32 route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import flash_attention
    cfg = configs.get_smoke("qwen3-moe-30b-a3b", dtype="float32")
    p_cpu = transformer.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 19)))
    out = []
    for dev in ("cuda", "cpu"):
        params = _to(p_cpu, dev)
        before = flash_attention.launches_f32
        logits, cache = transformer.prefill(params, {"tokens": toks[:, :16].to(dev)}, cfg, 19)
        if dev == "cuda":
            assert flash_attention.launches_f32 == before + cfg.n_layers
        steps = [logits.cpu()]
        for i in range(3):
            step = {"tokens": toks[:, 16 + i:17 + i].to(dev),
                    "pos": torch.full((B, 1), 16 + i, dtype=torch.int32, device=dev)}
            logits, cache = transformer.decode_step(params, step, cache, cfg)
            steps.append(logits.cpu())
        out.append(steps)
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
            for k, v in tree.items()}


@pytest.mark.parametrize("E,S,k", [(8, 64, 2), (128, 40, 8), (4, 1, 2)])
def test_positions_are_the_references_exclusive_count(E, S, k):
    """``_positions`` (a stable sort by expert) against the reference's
    formula, an exclusive cumulative sum of the one-hot over the flattened
    S·k axis, on routings crowded onto a few experts."""
    rng = np.random.default_rng(E + S)
    # each token's k distinct experts, from a skewed draw
    p = np.arange(E, 0, -1.0) ** 3
    topi = np.stack([[rng.choice(E, k, replace=False, p=p / p.sum()) for _ in range(S)]
                     for _ in range(B)])
    flat = topi.reshape(B, S * k)
    onehot = np.eye(E, dtype=np.int64)[flat]
    want = np.take_along_axis(np.cumsum(onehot, 1) - onehot, flat[..., None], 2)[..., 0]
    pos, keep = M._positions(torch.from_numpy(topi), E, 8)
    np.testing.assert_array_equal(pos.numpy().reshape(B, S * k), want)
    np.testing.assert_array_equal(keep.numpy().reshape(B, S * k), want < 8)
