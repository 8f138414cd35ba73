"""The LM gradient regime on the port against the JAX reference, at reduced
width on numpy inputs made from a seed: the token pipeline (equal), the
optimizers over 3 updates (f32 within 1e-6, bf16 within one bf16 ulp), the
cosine schedule, ``_xent`` and ``loss_fn`` (1e-5), one ``make_train_step``
step from JAX's parameters bridged across (sgd 1e-5, adamw 1e-4, with and
without micro-batching, a ``client_weight`` with zero rows), the loss
falling over 30 steps, ``GradientBackend`` under the RoundLoop (transport
columns exact), ``launch.train`` saving and resuming bit for bit, the
checkpoint format both ways, and the four dense configs of the slice. The
train step is held for the dense models and for the recurrent families
(rwkv6-3b, recurrentgemma-9b), whose scans differentiate through their
plain versions on the CPU.

The kernels' gradients (flash attention, the RG-LRU and RWKV6 scans) are
held against ``jax.grad`` in ``tests/test_torch_lm_kernels.py``.
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, fl  # noqa: E402
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.core.fedavg import FLConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.launch import specs, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import cosine_lr, make_optimizer  # noqa: E402
from repro_torch.pon import PonConfig  # noqa: E402
from reference_draws import reference_init  # noqa: E402

DENSE = ("qwen2-0.5b", "olmo-1b")
# the recurrent families train through the RG-LRU and RWKV6 scans' gradients
TRAINED = DENSE + ("rwkv6-3b", "recurrentgemma-9b")
NEW_CONFIGS = ("olmo-1b", "olmo-100m", "qwen1.5-110b", "deepseek-coder-33b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference of the training path."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import fl as jfl
    from repro import optim as joptim
    from repro.checkpoint import store as jstore
    from repro.common.sharding import ShardingRules
    from repro.core.fedavg import FLConfig as JFLConfig
    from repro.data import lm as jlm
    from repro.launch import specs as jspecs
    from repro.launch.mesh import make_test_mesh
    from repro.models import transformer as jtf
    from repro.pon import PonConfig as JPonConfig
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=jconfigs, fl=jfl, optim=joptim, store=jstore, lm=jlm,
        specs=jspecs, tf=jtf, FLConfig=JFLConfig, PonConfig=JPonConfig,
        mesh=make_test_mesh, rules=ShardingRules(batch=None, fsdp=None, tensor=None,
                                                 expert=None))


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _f32(a):
    return np.asarray(a, np.float32)


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


# ------------------------------------------------------------ data

@pytest.mark.parametrize("fn,args", [
    ("zipf_tokens", (500, 300)), ("markov_tokens", (700, 256)),
    ("lm_batches", (3, 4, 16, 256)), ("client_lm_batches", (5, 2, 3, 16, 100))])
def test_lm_tokens_equal_the_reference(jx, fn, args):
    def call(mod):
        f = getattr(mod, fn)
        if fn in ("zipf_tokens", "markov_tokens"):
            return f(np.random.default_rng(11), *args)
        out = f(11, *args)
        return [b["tokens"] for b in out] if fn == "lm_batches" else out["tokens"]
    np.testing.assert_array_equal(np.asarray(call(lm)), np.asarray(call(jx.lm)))


# ------------------------------------------------------------ optimizers

def _opt_tree(rng, dtype):
    tree = {"w": rng.normal(size=(3, 5)), "blk": {"b": rng.normal(size=(7,)),
                                                  "u": rng.normal(size=(2, 2, 4))}}

    def cast(t):
        return {k: cast(v) if isinstance(v, dict) else v.astype(np.float32) for k, v in t.items()}
    tree = cast(tree)
    if dtype == "bfloat16":
        import ml_dtypes
        tree = {k: _bf16_tree(v, ml_dtypes) if isinstance(v, dict) else v.astype(ml_dtypes.bfloat16)
                for k, v in tree.items()}
    return tree


def _bf16_tree(t, ml_dtypes):
    return {k: _bf16_tree(v, ml_dtypes) if isinstance(v, dict) else v.astype(ml_dtypes.bfloat16)
            for k, v in t.items()}


def _bf16_ulp(x):
    """One bf16 step at |x| (8 significant bits)."""
    x = np.abs(_f32(x))
    return np.exp2(np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sgd", "sgdm", "adamw", "yogi"])
def test_optimizer_matches_reference_over_three_updates(jx, name, dtype):
    """Parameters and state after each of 3 updates, from the same numpy
    parameters and gradients: f32 within 1e-6; bf16 parameters within one
    bf16 step of the reference's (each rounds an f32 update once)."""
    rng = np.random.default_rng(3)
    params_np = _opt_tree(rng, dtype)
    jopt, opt = jx.optim.make_optimizer(name), make_optimizer(name)
    jp = jx.jax.tree.map(jx.jnp.asarray, params_np)
    jstate = jopt.init(jp)
    p = lm_params_from_jax(params_np)
    state = opt.init(p)
    for step in range(3):
        grads = jx.jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 0.1,
                                _np_tree(jp))
        if dtype == "bfloat16":
            import ml_dtypes
            grads = jx.jax.tree.map(lambda g: g.astype(ml_dtypes.bfloat16), grads)
        jp, jstate = jopt.update(jp, jx.jax.tree.map(jx.jnp.asarray, grads), jstate, 1e-2)
        p, state = opt.update(p, lm_params_from_jax(grads), state, 1e-2)
        got, want = lm_params_to_jax(p), _np_tree(jp)
        if dtype == "float32":
            _tree_close(got, want, 1e-6, f"{name} step {step}")
        else:
            for k, w in jx.jax.tree_util.tree_leaves_with_path(want):
                g = got
                for part in k:
                    g = g[part.key]
                assert np.all(np.abs(_f32(g) - _f32(w)) <= _bf16_ulp(w)), (name, step, k)
        _tree_close(lm_params_to_jax(state), _np_tree(jstate), 1e-6, f"{name} state {step}")
    if name in ("adamw", "yogi"):
        assert int(state["t"]) == 3 and state["t"].dtype == torch.int32


def test_optimizer_defaults_are_the_reference_s():
    """AdamW b2 0.95, eps 1e-8; Yogi b2 0.99, eps 1e-3 (not torch.optim's)."""
    import inspect

    from repro_torch.optim import adamw_update, yogi_update
    a, y = inspect.signature(adamw_update).parameters, inspect.signature(yogi_update).parameters
    assert (a["b1"].default, a["b2"].default, a["eps"].default,
            a["weight_decay"].default) == (0.9, 0.95, 1e-8, 0.0)
    assert (y["b1"].default, y["b2"].default, y["eps"].default) == (0.9, 0.99, 1e-3)


def test_cosine_lr_equals_the_reference(jx):
    jlr, plr = jx.optim.cosine_lr(3e-3, 3, 10), cosine_lr(3e-3, 3, 10)
    got = [plr(s) for s in range(12)]
    want = [float(jlr(s)) for s in range(12)]
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert got[0] == 0.0 and got[3] == pytest.approx(3e-3) and got[10] == 0.0


# ------------------------------------------------------------ loss

def _jax_model(jx, arch, dtype="float32", **kw):
    """Reduced ``arch`` in both packages from JAX's init, its unit re-draw
    pinned (``reference_draws``); returns (port cfg, jax cfg, jax params,
    port params)."""
    jcfg = jx.configs.get_smoke(arch, dtype=dtype, **kw)
    jparams, _ = reference_init(jx.tf, jcfg, jx.jax.random.PRNGKey(0))
    return (configs.get_smoke(arch, dtype=dtype, **kw), jcfg, jparams,
            lm_params_from_jax(_np_tree(jparams)))


def test_xent_matches_reference(jx):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    t, c = transformer._xent(torch.from_numpy(logits), torch.from_numpy(labels),
                             torch.from_numpy(mask))
    jt, jc = jx.tf._xent(jx.jnp.asarray(logits), jx.jnp.asarray(labels), jx.jnp.asarray(mask))
    assert float(c) == float(jc)
    assert float(t) == pytest.approx(float(jt), rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("arch,kw", [("qwen2-0.5b", {}), ("olmo-1b", {"loss_chunks": 4})])
def test_loss_fn_matches_reference(jx, arch, kw):
    """Forward (through the units' remat), chunked head and loss, f32."""
    cfg, jcfg, jparams, params = _jax_model(jx, arch, **kw)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    loss, m = transformer.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg)
    jloss, jm = jx.tf.loss_fn(jparams, {"tokens": jx.jnp.asarray(toks)}, jcfg, jx.rules)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
    assert float(m["xent"]) == pytest.approx(float(jm["xent"]), rel=1e-5, abs=1e-5)


def test_weighted_loss_pieces_match_reference(jx):
    """``unnormalized_loss_fn``'s (Σ weighted nll, Σ weight) and
    ``weighted_loss_fn``, a client_weight with a zero row."""
    cfg, jcfg, jparams, params = _jax_model(jx, "qwen2-0.5b")
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    w = np.array([0.0, 80.0, 7.0], np.float32)
    batch = {"tokens": torch.from_numpy(toks), "client_weight": torch.from_numpy(w)}
    jbatch = {"tokens": jx.jnp.asarray(toks), "client_weight": jx.jnp.asarray(w)}
    (t, c), (jt, jc) = (specs.unnormalized_loss_fn(params, batch, cfg),
                        jx.specs.unnormalized_loss_fn(jparams, jbatch, jcfg, jx.rules))
    assert float(c) == float(jc) == 87.0 * 11
    assert float(t) == pytest.approx(float(jt), rel=1e-5)
    loss, _ = specs.weighted_loss_fn(params, batch, cfg)
    jloss, _ = jx.specs.weighted_loss_fn(jparams, jbatch, jcfg, jx.rules)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)


def test_remat_changes_nothing_but_memory():
    """remat='full' (checkpointed units), 'dots' (the projections' outputs
    kept) and 'none' give the same loss and gradient bit for bit on the
    CPU; the backward recomputes the units' projections under 'full' and
    none of them under 'dots' (``mm``, ``addmm`` and the batch-1 ``bmm`` an
    einsum such as "bsd,dhk->bshk" lowers to), attention's batched products
    under both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMatmuls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = {"projection": 0, "batched": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.counts["projection"] += 1
            elif func is torch.ops.aten.bmm.default:
                self.counts["projection" if args[0].shape[0] == 1 else "batched"] += 1
            return func(*args, **(kwargs or {}))

    cfg = configs.get_smoke("qwen2-0.5b", dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12)))
    out, recomputed = [], {}
    for remat in ("full", "dots", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        step = specs.make_train_step(c, "sgd", 0.1)
        p, _, loss = step(params, {}, {"tokens": toks})
        out.append((float(loss), lm_params_to_jax(p)))
        leaves = [t.requires_grad_(True) for t in specs._leaves(params)]
        loss, _ = transformer.loss_fn(params, {"tokens": toks}, c)
        with CountMatmuls() as mode:
            torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        recomputed[remat] = mode.counts
    for loss, p in out[1:]:
        assert loss == out[0][0]
        _tree_close(p, out[0][1], 0.0)
    # the units' projections run again in the backward under 'full' only
    assert recomputed["full"]["projection"] > recomputed["none"]["projection"]
    assert recomputed["dots"]["projection"] == recomputed["none"]["projection"]
    assert recomputed["full"]["batched"] == recomputed["dots"]["batched"] > \
        recomputed["none"]["batched"]


# ------------------------------------------------------------ the train step

@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("opt_name,tol", [("sgd", 1e-5), ("adamw", 1e-4)])
@pytest.mark.parametrize("arch", TRAINED)
def test_train_step_matches_reference(jx, arch, opt_name, tol, micro):
    """One step from the same parameters and tokens, a client_weight with
    zero rows: loss and every updated parameter within ``tol``. AdamW's
    first step moves every element by about ±lr, whatever the gradient's
    size, so where a gradient is f32 rounding noise the packages may step
    either way: its lr is the driver's default 3e-4, at which that stays
    inside 1e-4 while a wrong sign or bias correction (≥ 1.7e-4) does not.
    At some of the reference init's per-process draws an rwkv6-3b gradient
    sat within the packages' f32 disagreement (~1e-6) of zero, where
    AdamW's sign is a coin toss: ``_jax_model`` draws the same parameters
    in every process."""
    cfg, jcfg, jparams, params = _jax_model(jx, arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    w = np.array([120.0, 0.0, 37.0, 0.0], np.float32)
    lr = 3e-4 if opt_name == "adamw" else 0.5
    jopt = jx.optim.make_optimizer(opt_name)
    jstep = jx.jax.jit(jx.specs.make_train_step(jcfg, jx.rules, opt_name, lr, micro))
    jnew, jstate, jloss = jstep(jparams, jopt.init(jparams),
                                {"tokens": jx.jnp.asarray(toks),
                                 "client_weight": jx.jnp.asarray(w)})
    step = specs.make_train_step(cfg, opt_name, lr, micro)
    new, state, loss = step(params, make_optimizer(opt_name).init(params),
                            {"tokens": torch.from_numpy(toks),
                             "client_weight": torch.from_numpy(w)})
    assert float(loss) == pytest.approx(float(jloss), rel=tol, abs=tol)
    _tree_close(lm_params_to_jax(new), _np_tree(jnew), tol, f"{arch} {opt_name} micro {micro}")
    _tree_close(lm_params_to_jax(state), _np_tree(jstate), tol, "state")
    assert bool(torch.isfinite(step.grad_norm)) and float(step.grad_norm) > 0


def _int8_world_of_one(rank, world):
    """two_step_int8 and gspmd on a (1, 1) ("pod", "data") gloo world,
    adamw (the step's own noise from seed and step counter), 3 steps."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((1, 1), ("pod", "data"), "cpu")
    cfg = configs.get_smoke("qwen2-0.5b", dtype="float32")
    out = {}
    for transport in ("gspmd", "two_step_int8"):
        params = transformer.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
        opt = make_optimizer("adamw")
        state = opt.init(params)
        step = specs.make_train_step(cfg, "adamw", 3e-4, transport=transport, mesh=mesh)
        losses = []
        for b in lm.lm_batches(4, 3, 4, 16, cfg.vocab_size):
            params, state, loss = step(params, state, {"tokens": torch.from_numpy(b["tokens"]),
                                                       "client_weight": torch.ones(4)})
            losses.append(float(loss))
        out[transport] = losses
    with pytest.raises(ValueError, match="'pod' axis"):
        specs.make_train_step(cfg, transport="two_step_int8",
                              mesh=make_test_mesh((1, 1), ("data", "model"), "cpu"))
    return out


def test_two_step_int8_transport_on_a_world_of_one(tmp_path):
    """The int8 transport on one gloo rank (every collective the identity;
    its parity with the reference on 8 ranks is in
    tests/test_torch_collectives.py): step 0's loss equals gspmd's to f32
    rounding (the same parameters), the later ones stay within 1e-3 (the
    rounding noise moves the parameters a little); and without a 'pod'
    axis the transport raises."""
    from test_torch_collectives import _spawn
    (out,) = _spawn(tmp_path, 1, _int8_world_of_one)
    assert out["two_step_int8"][0] == pytest.approx(out["gspmd"][0], rel=1e-6)
    for a, b in zip(out["two_step_int8"], out["gspmd"]):
        assert a == pytest.approx(b, rel=1e-3)


def test_train_loss_decreases():
    """The counterpart of tests/test_system.py::test_train_loss_decreases:
    the reduced olmo learns the synthetic Markov stream."""
    cfg = configs.get_smoke("olmo_1b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer("adamw")
    state = opt.init(params)
    step = specs.make_train_step(cfg, "adamw", 3e-3)
    losses = []
    for b in lm.lm_batches(0, 30, 8, 64, cfg.vocab_size):
        params, state, loss = step(params, state,
                                   {"tokens": torch.from_numpy(b["tokens"]),
                                    "client_weight": torch.ones(8)})
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.2, losses[:3] + losses[-3:]


# ------------------------------------------------------------ backend and driver

def test_gradient_backend_round_loop_matches_reference(jx):
    """3 rounds of GradientBackend under each package's RoundLoop, from the
    same parameters: the transport columns equal the reference's exactly
    (the RNG stream is shared), the losses within 1e-4."""
    arch, batch, seq, seed = "qwen2-0.5b", 4, 16, 3
    jcfg = jx.configs.get_smoke(arch, dtype="float32")
    jpon = jx.PonConfig(n_onus=4, clients_per_onu=5)
    jflc = jx.FLConfig(n_onus=4, clients_per_onu=5, pon=jpon, n_selected=batch)
    counts = np.random.default_rng(seed).integers(50, 400, jflc.n_clients).astype(np.float32)
    onu = np.arange(jflc.n_clients) // 5
    mesh = jx.mesh((1, 1), ("data", "model"))
    with mesh:
        jb = jx.fl.GradientBackend(jcfg, jx.fl.make_strategy("sfl"), mesh, jx.rules,
                                   lr=1e-3, batch=batch, seq=seq, seed=seed,
                                   sample_counts=counts, onu_ids=onu)
        init = _np_tree(jb.params)
        jloop = jx.fl.RoundLoop(jx.fl.ExperimentConfig(fl=jflc, seed=seed, overselect=0.5,
                                                       p_transient=0.2), jb)
        jloop.run(3)
    flc = FLConfig(n_onus=4, clients_per_onu=5, pon=PonConfig(n_onus=4, clients_per_onu=5),
                   n_selected=batch)
    backend = fl.GradientBackend(configs.get_smoke(arch, dtype="float32"),
                                 fl.make_strategy("sfl"), lr=1e-3, batch=batch, seq=seq,
                                 seed=seed, sample_counts=counts, onu_ids=onu, device="cpu",
                                 params=lm_params_from_jax(init))
    loop = fl.RoundLoop(fl.ExperimentConfig(fl=flc, seed=seed, overselect=0.5,
                                            p_transient=0.2), backend)
    loop.run(3)
    for r, j in zip(loop.history, jloop.history, strict=True):
        for key in ("round", "n_selected", "involved", "upstream_mbits"):
            assert r[key] == j[key], (key, r[key], j[key])
        assert r["loss"] == pytest.approx(j["loss"], rel=1e-4, abs=1e-4)
    assert loop.history.column("n_selected")[0] > batch      # over-selection ran
    assert loop.rng.integers(0, 1 << 30) == jloop.rng.integers(0, 1 << 30)


def _run(tmp, steps, **kw):
    return train.run("qwen2-0.5b", smoke=True, steps=steps, batch=4, seq=16, ckpt=str(tmp),
                     ckpt_every=2, log_every=1, device="cpu", **kw)


def test_train_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """Save every 2 steps; a second run from step 2 takes steps 2-3 and
    ends bit for bit where the uninterrupted run ended."""
    full = _run(tmp_path / "a", 4, p_transient=0.3)
    assert latest_step(str(tmp_path / "a")) == 4
    os.makedirs(tmp_path / "b")
    os.rename(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    resumed = _run(tmp_path / "b", 4, p_transient=0.3)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["start_step"] == 2 and len(resumed["history"]) == 2
    for r, f in zip(resumed["history"], list(full["history"])[2:], strict=True):
        for key in ("round", "involved", "upstream_mbits", "loss", "grad_norm"):
            assert r[key] == f[key], key
    a = lm_params_to_jax({"p": full["backend"].params, "s": full["backend"].opt_state})
    b = lm_params_to_jax({"p": resumed["backend"].params, "s": resumed["backend"].opt_state})
    _tree_close(b, a, 0.0)


def test_train_cli_refuses_unported_flags(capsys, tmp_path):
    """The flags that were refused until the port had ``repro_torch.obs``
    now write their files: ``--trace-out`` a Chrome trace holding the rounds
    and the wall lane of ``backend.train_step_s``, ``--metrics-out`` the
    registry's JSONL with the upstream counter and the step histogram."""
    from repro_torch import obs

    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    train.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                "--trace-out", str(trace), "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    assert f"spans to {trace}" in out and f"merged metrics to {metrics}" in out
    spans = [e for e in json.loads(trace.read_text())["traceEvents"] if e["ph"] == "X"]
    assert sum(e["name"] == "round" for e in spans) == 2
    assert sum(e["name"] == "backend.train_step_s" for e in spans) == 2
    rows = {r["name"]: r for r in obs.read_jsonl(str(metrics))}
    assert rows["backend.train_step_s"]["count"] == 2
    assert rows["pon.upstream_mbits"]["n"] == 2
    assert all(r["obs_schema"] == "repro.obs/v1" for r in rows.values())


def test_train_runtime_driver_is_the_loop_and_resumes(tmp_path, capsys):
    """``--driver runtime`` (the Orchestrator's sync policy on the gradient
    regime) against ``--driver loop`` with transient failures: the same
    transport columns and losses bit for bit, t_s one 25 s window a round;
    a runtime run resumed from step 2 equals the uninterrupted one; an
    async --policy raises the reference's TypeError."""
    kw = dict(p_transient=0.3)
    loop = _run(tmp_path / "loop", 4, **kw)
    rt = _run(tmp_path / "rt", 4, driver="runtime", **kw)
    keys = ("round", "n_selected", "sim_engine", "involved", "upstream_mbits", "loss",
            "grad_norm")
    for r, want in zip(rt["history"], loop["history"], strict=True):
        assert {k: r[k] for k in keys} == {k: want[k] for k in keys}
        assert r["policy"] == "sync" and r["t_s"] == 25.0 * (r["round"] + 1)
    os.makedirs(tmp_path / "b")
    os.rename(tmp_path / "rt" / "step_2", tmp_path / "b" / "step_2")
    resumed = _run(tmp_path / "b", 4, driver="runtime", **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["start_step"] == 2
    for r, want in zip(resumed["history"], list(rt["history"])[2:], strict=True):
        assert {k: r[k] for k in keys + ("t_s",)} == {k: want[k] for k in keys + ("t_s",)}
    train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "8", "--device", "cpu",
                "--opt", "sgd", "--log-every", "1", "--driver", "runtime"])
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("step 1: loss") and last.endswith("t_sim 50s")
    for policy in ("semi_sync", "fedbuff"):
        with pytest.raises(TypeError, match="GradientBackend is sync-only"):
            train.run("qwen2-0.5b", smoke=True, steps=1, batch=2, seq=8, device="cpu",
                      driver="runtime", policy=policy)


def test_train_cli_bills_the_reference_driver_s_forest(jx, monkeypatch):
    """``--dba fl_priority --bg-load 0.5 --n-pons 2 --strategy hier_sfl``:
    every round's transport columns (the forest's per-segment Mbits
    included) equal those the reference's driver bills — its
    ExperimentConfig from the same flags, N = --batch, its sample counts —
    over a backend that trains nothing (the gradient regime's rounds draw
    nothing from the loop's RNG)."""
    import argparse
    flags = ["--dba", "fl_priority", "--bg-load", "0.5", "--n-pons", "2", "--strategy",
             "hier_sfl", "--onus", "4", "--clients-per-onu", "5", "--wavelengths", "2"]
    real_run, out = train.run, {}
    monkeypatch.setattr(train, "run", lambda *a, **k: out.setdefault("res", real_run(*a, **k)))
    train.main(["--smoke", "--steps", "3", "--batch", "4", "--seq", "8", "--device", "cpu",
                "--opt", "sgd", "--log-every", "1"] + flags)
    ap = argparse.ArgumentParser()
    jx.fl.add_experiment_cli_args(ap)
    jexp = jx.fl.experiment_config_from_args(ap.parse_known_args(flags)[0]).with_fl(
        n_selected=4)
    n = jexp.fl.n_clients
    backend = types.SimpleNamespace(
        strategy=jexp.make_strategy(), onu_ids=np.arange(n) // 5, run_round=lambda *a: {},
        sample_counts=np.random.default_rng(0).integers(50, 400, n).astype(np.float32))
    jloop = jx.fl.RoundLoop(jexp, backend)
    jloop.run(3)
    assert backend.strategy.transport == "hier" and n == 40
    keys = ("round", "n_selected", "sim_engine", "involved", "upstream_mbits", "metro_mbits",
            "trunk_mbits", "pon_mbits_max", "metro_mbits_max", "n_pons")
    for r, j in zip(out["res"]["history"], jloop.history, strict=True):
        for key in keys:
            assert r[key] == j[key], (key, r[key], j[key])
    assert out["res"]["backend"].strategy == fl.HierSfl(n_pons=2)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_train_compress_bills_the_reference_wire(jx, scheme, capsys):
    """``--compress`` on the gradient regime scales the wire the PON
    transport bills, as the reference's: each round's ``wire_mbits``,
    ``upstream_mbits`` and involvement equal the reference RoundLoop's over
    a backend holding the same parameter tree (top-k's ratio is exact from
    it)."""
    kw = dict(steps=3, batch=4, seq=8, opt="sgd", p_transient=0.2, onus=4, clients_per_onu=5,
              log_every=1, device="cpu")
    res = train.run("qwen2-0.5b", smoke=True, compress=scheme, **kw)
    jflc = jx.FLConfig(n_onus=4, clients_per_onu=5,
                       pon=jx.PonConfig(n_onus=4, clients_per_onu=5), n_selected=4)
    counts = np.random.default_rng(0).integers(50, 400, jflc.n_clients).astype(np.float32)
    backend = types.SimpleNamespace(
        strategy=jx.fl.make_strategy("sfl_two_step", compress=scheme),
        params=lm_params_to_jax(res["backend"].params), sample_counts=counts,
        onu_ids=np.arange(jflc.n_clients) // 5, run_round=lambda *a: {})
    jloop = jx.fl.RoundLoop(jx.fl.ExperimentConfig(fl=jflc, seed=0, p_transient=0.2), backend)
    jloop.run(3)
    for r, j in zip(res["history"], jloop.history, strict=True):
        for key in ("wire_mbits", "upstream_mbits", "involved", "compress"):
            assert r[key] == j[key], (scheme, key, r[key], j[key])
    train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq", "8", "--device", "cpu",
                "--opt", "sgd", "--compress", scheme])
    assert "step 0: loss" in capsys.readouterr().out


def test_train_cli_smoke_and_no_card(monkeypatch, capsys):
    train.main(["--arch", "olmo-1b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
                "--device", "cpu", "--log-every", "1", "--opt", "sgd"])
    assert "step 1: loss" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run("qwen2-0.5b", smoke=True, steps=1)


# ------------------------------------------------------------ checkpoints

def _ckpt_tree(jx):
    jnp = jx.jnp
    params = {"embed": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7,
              "unit": {"0_attn": {"wq": jnp.linspace(-1, 1, 10, dtype=jnp.float32)}}}
    state = {"m": {"w": jnp.ones((2,), jnp.float32)}, "t": jnp.asarray(7, jnp.int32)}
    return (params, state)


def _torch_like(tree):
    if isinstance(tree, tuple):
        return tuple(_torch_like(t) for t in tree)
    return lm_params_from_jax(_np_tree(tree))


def test_checkpoints_cross_between_packages(jx, tmp_path):
    """The reference's checkpoint restores in the port and the port's in the
    reference, bf16 and the 0-d int32 step included, with the same paths."""
    tree = _ckpt_tree(jx)
    jx.store.save_checkpoint(str(tmp_path / "j"), 3, tree, extra={"note": "x"})
    like = _torch_like(tree)
    got, extra, step = restore_checkpoint(str(tmp_path / "j"), 3, like)
    assert step == 3 and extra == {"note": "x"}
    assert got[0]["embed"].dtype == torch.bfloat16 and got[1]["t"].dtype == torch.int32
    _tree_close({"p": lm_params_to_jax(got[0]), "s": lm_params_to_jax(got[1])},
                {"p": _np_tree(tree[0]), "s": _np_tree(tree[1])}, 0.0)
    save_checkpoint(str(tmp_path / "t"), 3, got, extra={"note": "x"})
    back, _, _ = jx.store.restore_checkpoint(str(tmp_path / "t"), 3, tree)
    for a, b in zip(jx.jax.tree.leaves(back), jx.jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_f32(a), _f32(b))
    import json
    paths = [[e["path"] for e in json.load(open(tmp_path / d / "step_3" / "manifest.json"))
              ["entries"]] for d in ("j", "t")]
    assert paths[0] == paths[1] == ["0/embed", "0/unit/0_attn/wq", "1/m/w", "1/t"]


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4) / 3,
            "b": {"c": torch.ones(2), "t": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 5, tree, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 5
    restored, extra, step = restore_checkpoint(str(tmp_path), 5, tree)
    assert step == 5 and extra["note"] == "x"
    for k, want in (("a", tree["a"]), ("c", tree["b"]["c"]), ("t", tree["b"]["t"])):
        got = restored[k] if k == "a" else restored["b"][k]
        assert got.dtype == want.dtype and torch.equal(got, want), k


def test_checkpoint_atomicity(tmp_path):
    """A leftover tmp_ dir (crashed writer) never shadows a good step."""
    os.makedirs(tmp_path / "tmp_9")
    save_checkpoint(str(tmp_path), 9, {"a": torch.ones(4)})
    assert latest_step(str(tmp_path)) == 9
    assert not any(d.startswith("tmp_") for d in os.listdir(tmp_path))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(4)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.ones(5)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), 1, {"b": torch.ones(4)})


def test_bridge_carries_optimizer_state(jx):
    """AdamW's state, the 0-d int32 step included, crosses both ways exactly."""
    tree = _ckpt_tree(jx)
    state = jx.optim.make_optimizer("adamw").init(tree[0])
    state = dict(state, t=jx.jnp.asarray(5, jx.jnp.int32))
    got = lm_params_from_jax(_np_tree(state))
    assert got["t"].shape == () and got["t"].dtype == torch.int32 and int(got["t"]) == 5
    _tree_close(lm_params_to_jax(got), _np_tree(state), 0.0)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_config_copies_match_field_for_field(jx, arch):
    for port_cfg, ref_cfg in ((configs.get(arch), jx.configs.get(arch)),
                              (configs.get_smoke(arch), jx.configs.get_smoke(arch))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        for prop in ("n_units", "tail_pattern", "is_subquadratic", "param_count"):
            assert getattr(port_cfg, prop) == getattr(ref_cfg, prop), (arch, prop)


@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_full_width_parameter_tree_matches_reference(jx, arch):
    """Names, shapes and dtypes of every leaf at full width against the
    reference's abstract init, built on the meta device (nothing is
    allocated); the leaves hold at least ``param_count``, which leaves out
    the padded query heads, the biases and the norms."""
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
    n = sum(int(np.prod(s)) for _, s, _ in leaves(port))
    assert n >= cfg.param_count
    if arch == "olmo-1b":
        assert cfg.param_count == 1_176_764_416 and n == cfg.param_count
