"""The collective forms of the SFL aggregation on ``torch.distributed``
against the JAX reference: the mesh and the sharding rules, the two-step
and classical all-reduces with the int8 cross-pod hop, the per-leaf
compression API, and the ``two_step_int8`` train step.

The port runs on gloo groups of CPU processes (``_spawn``: spawned ranks,
a file rendezvous, results back through files, a join with a timeout).
The reference runs once per module in a subprocess with 8 fake host
devices on the same numpy inputs (``reference``); wherever it draws noise
from a key, the subprocess saves the ``jax.random.uniform`` arrays of its
split keys and the port is fed them, so both round with the same numbers.

Tolerances: the aggregator's inputs are dyadic (k/8 times integer
weights), so every partial sum is exact in any order and the port equals
the numpy oracle and the reference to f32 rounding of the final division
(1e-6), the int8 hop included. The int8 train step's pod sums differ from
the reference's by f32 rounding, which may move a stochastic rounding to
the next level; each parameter is held within ``lr`` times (1e-5 of its
leaf's largest gradient + one quantization level of each pod), with all
but 1% of them within the first term alone.
"""
import math
import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.common import sharding  # noqa: E402
from repro_torch.common.tree import flatten, unflatten  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 240


# ------------------------------------------------------------ gloo ranks

def _rank_main(rank, world, init, out_dir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                            world_size=world)
    try:
        torch.save(fn(rank, world, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(out_dir, world, fn, *args):
    """``fn(rank, world, *args)`` on each rank of a gloo world of ``world``
    spawned processes; returns the ranks' results in rank order. Keep
    ``args`` small (paths, not arrays): they are pickled to every rank."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.spawn(_rank_main, args=(world, os.path.join(out_dir, "init"), str(out_dir),
                                     fn, args), nprocs=world, join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in {TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    # files the ranks just wrote: numpy arrays inside, so not weights-only
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _paths(tree, prefix=""):
    """{"a/b": leaf} for a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat, prefix):
    """The nested dict of the entries of ``flat`` under ``prefix``."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *dirs, leaf = key[len(prefix):].split("/")
        d = out
        for part in dirs:
            d = d.setdefault(part, {})
        d[leaf] = v
    return out


# ------------------------------------------------------------ inputs

N_RANKS, POD, DATA = 8, 2, 4
LEAF_SHAPES = {"g": (6, 5), "b": (7,)}      # 30 and 7 elements: both padded to |data|
TRAIN = dict(arch="qwen2-0.5b", batch=16, seq=16)   # 2 rows a rank: micro 2 splits them


def _inputs():
    rng = np.random.default_rng(0)
    # dyadic values: every partial sum of x·w is exact in f32, in any order
    x = {k: (rng.integers(-32, 33, (N_RANKS,) + s) / 8).astype(np.float32)
         for k, s in LEAF_SHAPES.items()}
    w = rng.integers(1, 11, N_RANKS).astype(np.float32)
    cfg = configs.get_smoke(TRAIN["arch"], dtype="float32")
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN["batch"], TRAIN["seq"])).astype(np.int32)
    cw = rng.integers(0, 400, TRAIN["batch"]).astype(np.float32)
    cw[[1, 6, 11]] = 0.0                       # rows that carry no weight
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return dict(x_g=x["g"], x_b=x["b"], w=w, tokens=tokens, client_weight=cw,
                **{"params/" + k: v for k, v in _paths(lm_params_to_jax(params)).items()})


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import configs
    from repro.common.compat import shard_map
    from repro.common.sharding import ShardingRules
    from repro.core import aggregation as agg
    from repro.launch import specs
    from repro.launch.mesh import make_test_mesh
    from repro.optim import make_optimizer

    inp = dict(np.load(sys.argv[1]))
    out = {}

    def nest(prefix):
        tree = {}
        for key, v in inp.items():
            if key.startswith(prefix):
                *dirs, leaf = key[len(prefix):].split("/")
                d = tree
                for part in dirs:
                    d = d.setdefault(part, {})
                d[leaf] = jnp.asarray(v)
        return tree

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

    def noise(key, tree, shape_of):
        leaves, treedef = jax.tree.flatten(tree)
        keys = jax.random.split(key, len(leaves))
        return jax.tree.unflatten(treedef, [
            jax.random.uniform(k, shape_of(x), jnp.float32) for x, k in zip(leaves, keys)])

    mesh = make_test_mesh((2, 4), ("pod", "data"))
    x = {"g": jnp.asarray(inp["x_g"]), "b": jnp.asarray(inp["x_b"])}
    w = jnp.asarray(inp["w"])
    key = jax.random.PRNGKey(7)
    for mode, comp in (("two_step", None), ("classical", None), ("two_step", "int8")):
        f = agg.make_weighted_gradient_aggregator(mesh, mode, comp)

        def body(xs, ws):
            mean, K = f({k: v[0] * ws[0] for k, v in xs.items()}, ws[0], key)
            return mean, K
        spec = P(("pod", "data"))
        fn = shard_map(body, mesh=mesh, in_specs=({"g": spec, "b": spec}, spec),
                       out_specs=(P(), P()), check_vma=False)
        mean, K = jax.jit(fn)(x, w)
        put(f"agg/{mode}_{comp}/", mean)
        out[f"agg/{mode}_{comp}/K"] = np.asarray(K)
    # the per-shard noise each device drew: shard = ceil(numel / |data|)
    put("agg_noise/", noise(key, {"g": x["g"][0], "b": x["b"][0]},
                            lambda v: (-(-v.size // 4),)))

    cfg = configs.get_smoke("qwen2-0.5b", dtype="float32")
    params = nest("params/")
    rules = ShardingRules(batch=("pod", "data"), fsdp="data", tensor=None, expert=None)
    batch = {"tokens": jnp.asarray(inp["tokens"]),
             "client_weight": jnp.asarray(inp["client_weight"])}
    with mesh:
        # adamw, the step's own key: fold_in(PRNGKey(seed), t = 0)
        opt = make_optimizer("adamw")
        step = jax.jit(specs.make_train_step(cfg, rules, "adamw", 3e-4, 1,
                                             transport="two_step_int8", mesh=mesh, seed=0))
        new, state, loss = step(params, opt.init(params), batch)
        put("adamw/params/", new)
        put("adamw/m/", state["m"])
        out["adamw/loss"] = np.asarray(loss)
        put("adamw/noise/", noise(jax.random.fold_in(jax.random.PRNGKey(0), 0), params,
                                  lambda v: v.shape))
        # sgd, micro-batched, an explicit key
        key = jax.random.PRNGKey(11)
        step = jax.jit(specs.make_train_step(cfg, rules, "sgd", 0.5, 2,
                                             transport="two_step_int8", mesh=mesh, seed=0))
        new, _, loss = step(params, {}, batch, key)
        put("sgd/params/", new)
        out["sgd/loss"] = np.asarray(loss)
        put("sgd/noise/", noise(key, params, lambda v: v.shape))
    np.savez(sys.argv[2], **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference(tmp_path_factory, inputs):
    """The reference's aggregator and two_step_int8 steps on a (2, 4)
    ("pod", "data") mesh of 8 host devices, with the noise they drew."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("reference")
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "inputs.npz"),
                        str(d / "out.npz")], capture_output=True, text=True, cwd=ROOT,
                       env=env, timeout=TIMEOUT_S)
    assert "REFERENCE_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return types.SimpleNamespace(inputs=str(d / "inputs.npz"), out=str(d / "out.npz"),
                                 **{"get": dict(np.load(d / "out.npz"))})


# ------------------------------------------------------------ the (2, 4) world

def _eight_ranks(rank, world, inputs_npz, ref_npz):
    """The aggregator in four forms and the two int8 train steps, on this
    rank of the (2, 4) ("pod", "data") mesh."""
    inputs, ref = dict(np.load(inputs_npz)), dict(np.load(ref_npz))
    mesh = mesh_mod.make_test_mesh((POD, DATA), ("pod", "data"), "cpu")
    out = {"coords": mesh_mod.device_coords(mesh),
           "client_index": mesh_mod.client_index(mesh, ("pod", "data"))}
    w = float(inputs["w"][rank])
    local = {k: torch.from_numpy(inputs["x_" + k][rank]) * w for k in LEAF_SHAPES}
    agg_noise = _nest(ref, "agg_noise/")

    def ref_noise(tree):
        return lambda shapes: [torch.from_numpy(u) for u in flatten(tree)]
    for mode, comp in (("two_step", None), ("classical", None), ("two_step", "int8")):
        f = agg.make_weighted_gradient_aggregator(mesh, mode, comp)
        mean, K = f(local, w, ref_noise(agg_noise) if comp else None)
        out[f"agg/{mode}_{comp}"] = (_np(mean), float(K))
    # a generator seeded alike on every rank: the same noise everywhere
    mean, _ = agg.make_weighted_gradient_aggregator(mesh, "two_step", "int8")(
        local, w, torch.Generator().manual_seed(3))
    out["agg/generator"] = _np(mean)
    try:
        agg.two_step_allreduce(local, mesh, compress="int8")
    except ValueError as e:
        out["agg/no_noise"] = str(e)

    cfg = configs.get_smoke(TRAIN["arch"], dtype="float32")
    params = lm_params_from_jax(_nest(inputs, "params/"))
    batch = {"tokens": torch.from_numpy(inputs["tokens"]).long(),
             "client_weight": torch.from_numpy(inputs["client_weight"])}
    for opt_name, lr, micro in (("adamw", 3e-4, 1), ("sgd", 0.5, 2)):
        opt = make_optimizer(opt_name)
        step = specs.make_train_step(cfg, opt_name, lr, micro, transport="two_step_int8",
                                     mesh=mesh, seed=0)
        # FSDP over "data", as the reference's rules: the rank's shards in,
        # the gathered leaves out
        shards = step.layout.shard(params)
        new, state, loss = step(shards, opt.init(shards), batch,
                                noise=ref_noise(_nest(ref, f"{opt_name}/noise/")))
        new = step.layout.gather(new)
        state = step.layout.gather(state, step.layout.state_places(state))
        out[opt_name] = (lm_params_to_jax(new), lm_params_to_jax(state), float(loss),
                         float(step.grad_norm))
    try:
        step = specs.make_train_step(cfg, "sgd", 0.5, transport="two_step_int8", mesh=mesh)
        step(step.layout.shard(params), {}, batch)
    except ValueError as e:
        out["stateless"] = str(e)
    return out


@pytest.fixture(scope="module")
def eight(tmp_path_factory, reference):
    return _spawn(tmp_path_factory.mktemp("eight"), N_RANKS, _eight_ranks, reference.inputs,
                  reference.out)


@pytest.fixture(scope="module")
def levels(inputs):
    """Per leaf: one quantization level of each pod (max|pod's Σ gradient|
    / 127, from the port's plain gradients), summed, over K."""
    cfg = configs.get_smoke(TRAIN["arch"], dtype="float32")
    params = lm_params_from_jax(_nest(inputs, "params/"))
    n = TRAIN["batch"] // POD
    total, K = None, 0.0
    for pod in range(POD):
        rows = {"tokens": torch.from_numpy(inputs["tokens"][pod * n:(pod + 1) * n]).long(),
                "client_weight": torch.from_numpy(inputs["client_weight"][pod * n:(pod + 1) * n])}
        def objective():
            tot, cnt = specs.unnormalized_loss_fn(params, rows, cfg)
            return tot, cnt.detach()
        grads, cnt = specs._grads(params, objective)
        level = {k: float(g.abs().max()) / 127 for k, g in _paths(grads).items()}
        total = level if total is None else {k: total[k] + v for k, v in level.items()}
        K += float(cnt)
    return {k: v / K for k, v in total.items()}


def test_mesh_coordinates(eight):
    """Every rank sees the same rank -> (pod, data) map, row-major, and
    holds the batch shard of its own coordinate."""
    want = {r: (r // DATA, r % DATA) for r in range(N_RANKS)}
    for rank, out in enumerate(eight):
        assert out["coords"] == want
        assert out["client_index"] == (rank, N_RANKS)


@pytest.mark.parametrize("form", ["two_step_None", "classical_None"])
def test_aggregator_equals_oracle_and_reference(eight, reference, inputs, form):
    """two_step and classical on the (2, 4) world: the numpy oracle's
    weighted mean and K, and the reference's, on every rank."""
    reference = reference.get
    x = {k: inputs["x_" + k] for k in LEAF_SHAPES}
    for rank, out in enumerate(eight):
        mean, K = out[f"agg/{form}"]
        want = {k: agg.numpy_weighted_mean(x[k], inputs["w"], np.ones(N_RANKS))[0]
                for k in LEAF_SHAPES}
        assert K == inputs["w"].sum() == float(reference[f"agg/{form}/K"])
        for k in LEAF_SHAPES:
            np.testing.assert_allclose(mean[k], want[k], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(mean[k], reference[f"agg/{form}/{k}"], rtol=1e-6,
                                       atol=0)


def test_int8_aggregator_equals_reference(eight, reference, inputs):
    """The int8 cross-pod hop (one scale a shard, the reference's noise):
    the reference's mean on every rank to f32 rounding, and within one
    level of each pod's shard of the exact mean."""
    reference, w = reference.get, inputs["w"]
    for out in eight:
        mean, K = out["agg/two_step_int8"]
        assert K == float(reference["agg/two_step_int8/K"])
        for k in LEAF_SHAPES:
            want = reference[f"agg/two_step_int8/{k}"]
            np.testing.assert_allclose(mean[k], want, rtol=1e-6, atol=1e-7)
            x = inputs["x_" + k]
            wx = x * w.reshape((-1,) + (1,) * (x.ndim - 1))
            exact = wx.sum(0) / K
            # a stochastic rounding errs by less than one level, max|pod shard| / 127
            level = sum(np.abs(wx[p * DATA:(p + 1) * DATA].sum(0)).max()
                        for p in range(POD)) / 127 / K
            assert np.abs(mean[k] - exact).max() <= level * (1 + 1e-5)


def test_int8_aggregator_noise_is_alike_on_every_rank(eight):
    """Ranks holding generators seeded alike draw the same noise, so every
    rank ends with the same mean; without noise the int8 hop raises."""
    for out in eight[1:]:
        for k in LEAF_SHAPES:
            np.testing.assert_array_equal(out["agg/generator"][k], eight[0]["agg/generator"][k])
    assert "requires explicit noise" in eight[0]["agg/no_noise"]


@pytest.mark.parametrize("opt_name,lr", [("adamw", 3e-4), ("sgd", 0.5)])
def test_two_step_int8_step_equals_reference(eight, reference, inputs, levels, opt_name,
                                             lr):
    """The two_step_int8 train step on 8 gloo ranks against the reference's
    on 8 host devices, the same noise: the loss to f32 rounding; sgd
    (2 micro-batches) every parameter, adamw its first moment (0.1 × the
    gradient), within lr × (1e-5 of the leaf's largest gradient + one level
    of each pod), all but 1% within the first term; every rank alike."""
    ref = reference.get
    p0 = _paths(_nest(inputs, "params/"))
    for out in eight:
        new, state, loss, gnorm = out[opt_name]
        assert loss == pytest.approx(float(ref[f"{opt_name}/loss"]), rel=1e-5)
        assert math.isfinite(gnorm) and gnorm > 0
        got = _paths(state["m"] if opt_name == "adamw" else new)
        want = _paths(_nest(ref, f"{opt_name}/{'m' if opt_name == 'adamw' else 'params'}/"))
        assert sorted(got) == sorted(want)
        far, total = 0, 0
        for path, w in want.items():
            g = np.asarray(got[path], np.float32)
            if opt_name == "adamw":     # m = 0.1 g
                step, scale = np.abs(w), 0.1
            else:                       # new = p0 - lr g
                step, scale = np.abs(p0[path] - w), lr
            tight = 1e-5 * step.max() + 1e-7
            diff = np.abs(g - w)
            assert diff.max() <= tight + scale * levels[path], (opt_name, path, diff.max())
            far += int((diff > tight).sum())
            total += diff.size
        assert far <= 0.01 * total, (opt_name, far, total)
    if opt_name == "adamw":
        for out in eight[1:]:
            for path, leaf in _paths(out["adamw"][0]).items():
                np.testing.assert_array_equal(leaf, _paths(eight[0]["adamw"][0])[path])


def test_two_step_int8_stateless_optimizer_needs_noise(eight):
    assert "stateless optimizer needs an explicit noise=" in eight[0]["stateless"]


# ------------------------------------------------------------ the cost count

# (name, transport, rules) of the train step whose collectives are counted
COST_FORMS = (("two_step", "gspmd", sharding.ShardingRules()),
              ("classical", "gspmd", sharding.ShardingRules().replicated()),
              ("two_step_int8", "two_step_int8", sharding.ShardingRules()))
COST_BATCH, COST_SEQ = 8, 16


def _cost_ranks(rank, world, shape):
    """Per form, the collective bytes by mesh axis that this rank's train
    step records under a counter (reduced olmo-1b, sgd, f32; under FSDP
    from the rank's shards)."""
    from repro_torch.launch.roofline import Counter
    mesh = mesh_mod.make_test_mesh(tuple(shape.values()), tuple(shape), "cpu")
    cfg = configs.get_smoke("olmo-1b", dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((COST_BATCH, COST_SEQ), dtype=torch.int32),
             "client_weight": torch.ones(COST_BATCH)}
    out = {}
    for name, transport, rules in COST_FORMS:
        step = specs.make_train_step(cfg, "sgd", 0.1, transport=transport, mesh=mesh,
                                     rules=rules)
        kw = ({"noise": lambda shapes: [torch.rand(s) for s in shapes]}
              if transport == "two_step_int8" else {})
        held = params if step.layout is None else step.layout.shard(params)   # FSDP: shards
        with Counter() as c:
            step(held, {}, batch, **kw)
        out[name] = (c.coll, c.n_coll)
    return out


@pytest.fixture(scope="module", params=[{"pod": 2, "data": 2}, {"pod": 2, "data": 4}],
                ids=["pod2_data2", "pod2_data4"])
def cost_world(request, tmp_path_factory):
    shape = request.param
    return shape, _spawn(tmp_path_factory.mktemp("cost"), math.prod(shape.values()),
                         _cost_ranks, shape)


@pytest.mark.parametrize("form", [f[0] for f in COST_FORMS])
def test_collective_bytes_reckoned_on_meta_equal_a_gloo_run(cost_world, form):
    """The same step over an AbstractMesh of the same shape, on meta: every
    rank of the gloo world recorded the bytes the dry run reckons, by axis,
    exactly; and the paper's claim: SFL moves fewer pod bytes than the flat
    all-reduce."""
    from repro_torch.launch import segments
    from repro_torch.models.config import ShapeConfig
    shape, ranks = cost_world
    _, transport, rules = dict((f[0], f) for f in COST_FORMS)[form]
    cfg = configs.get_smoke("olmo-1b", dtype="float32")
    meta = segments.count_step(cfg, ShapeConfig("t", COST_SEQ, COST_BATCH, "train"), shape,
                               rules, "sgd", 1, transport)
    assert all(r[form] == (meta.coll, meta.n_coll) for r in ranks), (ranks[0][form], meta.coll)
    assert set(meta.coll) == {"pod", "data"}
    assert ranks[0]["two_step"][0]["pod"] < ranks[0]["classical"][0]["pod"]


# ------------------------------------------------------------ one process

def test_mesh_none_is_one_process():
    """Without a process group: make_test_mesh raises, the production mesh
    names the ranks it needs, and ``mesh=None`` reduces nothing (the
    aggregator's mean is local / K bit for bit)."""
    with pytest.raises(RuntimeError, match="initialized torch.distributed process group"):
        mesh_mod.make_test_mesh((1, 1), ("pod", "data"), "cpu")
    with pytest.raises(RuntimeError, match="need 256 devices, have 1"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices, have 1"):
        mesh_mod.make_production_mesh(multi_pod=True)
    tree = {"b": torch.randn(5), "a": {"z": torch.randn(3, 2)}}
    for mode in ("two_step", "classical"):
        mean, K = agg.make_weighted_gradient_aggregator(None, mode)(tree, 3.0)
        assert float(K) == 3.0
        for got, x in zip(flatten(mean), flatten(tree)):
            assert torch.equal(got, x / torch.tensor(3.0))
    assert (mesh_mod.size(None), mesh_mod.mesh_shape(None), mesh_mod.client_index(None, ("data",))
            ) == (1, {}, (0, 1))


def test_int8_hop_is_unbiased():
    """The counterpart of tests/test_aggregation.py::test_compressed_two_step_unbiased
    (its statistic and bound) on a world of one: 32 int8 hops with fresh
    noise, each within one level of x."""
    x = torch.linspace(-2, 2, 511)
    g = torch.Generator().manual_seed(0)
    outs = [agg.two_step_allreduce({"x": x}, None, compress="int8", noise=g)["x"]
            for _ in range(32)]
    assert abs(float(torch.stack(outs).mean()) - float(x.mean())) < 5e-3
    step = float(x.abs().max()) / 127
    assert all(float((o - x).abs().max()) <= step * 1.0001 for o in outs)


def test_tree_order_is_the_reference_s():
    """Leaves in jax.tree.flatten's order (sorted keys at every level);
    unflatten keeps the tree's own key order."""
    tree = {"b": 1, "a": {"z": 2, "c": {"y": 3, "x": 4}}, "0": 5}
    assert flatten(tree) == [5, 4, 3, 2, 1]
    assert unflatten(tree, [50, 40, 30, 20, 10]) == {"b": 10, "a": {"z": 20, "c": {"y": 30,
                                                                                 "x": 40}},
                                                     "0": 50}
    assert list(unflatten(tree, range(5))) == ["b", "a", "0"]


# ------------------------------------------------------------ the sharding rules

LOGICAL = [("embed", "mlp"), ("vocab_rows", "tensor_cols"), ("batch", None, "heads"),
           ("layers", "embed", "heads", "head_dim"), ("experts", "embed", "mlp"), (None,),
           ("sequence", "kv_heads"), ("lora", "state", "classes", "stack", "conv", "seq")]


@pytest.mark.parametrize("variant", ["default", "replicated", "degenerate", "table"])
def test_logical_to_physical_matches_reference(variant):
    """Every logical tuple through each rules variant: the reference's
    PartitionSpec, as a tuple, duplicate axes degraded to None."""
    jsh = pytest.importorskip("repro.common.sharding")
    kw = {"default": {}, "replicated": {}, "degenerate": {"fsdp": "model"},
          "table": {"table": {"mlp": ("pod", "data"), "embed": None}}}[variant]
    rules, jrules = sharding.ShardingRules(**kw), jsh.ShardingRules(**kw)
    if variant == "replicated":
        rules, jrules = rules.replicated(), jrules.replicated()
    for logical in LOGICAL:
        assert sharding.logical_to_physical(rules, logical) == tuple(
            jsh.logical_to_physical(jrules, logical)), (variant, logical)
    tree = {"w": ("embed", "mlp"), "blk": {"e": ("vocab_rows", "tensor_cols")}}
    assert sharding.spec_tree(rules, tree) == {
        "w": sharding.logical_to_physical(rules, ("embed", "mlp")),
        "blk": {"e": sharding.logical_to_physical(rules, ("vocab_rows", "tensor_cols"))}}


def test_filter_valid_spec_and_padding_match_reference():
    jsh = pytest.importorskip("repro.common.sharding")
    from jax.sharding import PartitionSpec as P
    shape = {"pod": 2, "data": 4, "model": 3}
    mesh = types.SimpleNamespace(shape=shape)
    for spec, dims in ((("data", "model"), (8, 9)), (("data", "model"), (6, 9)),
                       ((("pod", "data"), None), (16, 5)), ((("pod", "data"),), (12, 2)),
                       (("model",), (7, 3, 3))):
        assert sharding.filter_valid_spec(shape, spec, dims) == tuple(
            jsh.filter_valid_spec(mesh, P(*spec), dims)), (spec, dims)
    assert [sharding.pad_to_multiple(n, 16) for n in (0, 1, 16, 17, 56)] == [
        jsh.pad_to_multiple(n, 16) for n in (0, 1, 16, 17, 56)]
    x = torch.ones(3)
    assert sharding.constrain(x, sharding.ShardingRules(), ("embed",)) is x


def test_rules_choose_the_schedule():
    """FSDP on: the two-step schedule; replicated: the flat all-reduce;
    either beside tensor and expert parallelism over "model", whenever the
    mesh has that axis, of any size. Tensor or expert parallelism over
    another axis raises. The int8 transport holds FSDP shards and blocks
    over a "model" axis larger than 1, and a serving cell over one counts
    its "model" bytes."""
    rules = sharding.ShardingRules()
    assert sharding.reduce_schedule(rules, {"pod": 2, "data": 4, "model": 1}) == "two_step"
    assert sharding.reduce_schedule(rules.replicated(), {"data": 4, "model": 1}) == "classical"
    for shape in ({"data": 2, "model": 2}, {"pod": 2, "data": 16, "model": 16}):
        assert sharding.reduce_schedule(rules, shape) == "two_step"
        assert sharding.reduce_schedule(rules.replicated(), shape) == "classical"
    assert sharding.model_parallel(rules, {"data": 2, "model": 1}) == (True, True)
    assert sharding.model_parallel(rules, {"pod": 2, "data": 4}) == (False, False)
    assert sharding.model_parallel(rules.with_(expert=None), {"model": 4}) == (True, False)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        sharding.reduce_schedule(rules.with_(tensor=None, expert="data"), {"data": 2})
    cfg = configs.get_smoke("qwen2-0.5b")
    tp2 = mesh_mod.AbstractMesh({"pod": 2, "data": 2, "model": 2})
    from repro_torch.launch.roofline import Counter
    int8 = specs.make_train_step(cfg, mesh=tp2, transport="two_step_int8").layout
    assert int8.tp.size == 2 and int8.group is not None
    fn, args = specs.input_specs(cfg, ShapeConfig("p", 16, 4, "prefill"), {"data": 2, "model": 2})
    with Counter() as c:
        fn(*args)
    assert c.coll["model"] > 0 and c.coll["data"] > 0
    assert specs.make_train_step(cfg, mesh=tp2).layout.tp.size == 2


# ------------------------------------------------------------ the per-leaf API

@pytest.fixture(scope="module")
def jc():
    pytest.importorskip("jax")
    import jax

    from repro.core import compression as jcomp
    return types.SimpleNamespace(jax=jax, c=jcomp)


def _jax_noise(jc, key, tree):
    """The reference's quantize_tree noise: uniform(split(key, n)[i], shape)."""
    leaves = jc.jax.tree.leaves(tree)
    keys = jc.jax.random.split(key, len(leaves))
    arrays = [np.asarray(jc.jax.random.uniform(k, np.shape(x))) for x, k in zip(leaves, keys)]
    return lambda shapes: [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_tree_equals_reference(jc, seed, bits):
    """quantize_tree / dequantize_tree on a nested tree, the reference's
    noise: q and the scales bit for bit, and the round-trip error within
    one level (tests/test_substrate.py's bound)."""
    rng = np.random.default_rng(seed)
    tree = {"a": rng.normal(size=(64,)).astype(np.float32),
            "b": (rng.normal(size=(9, 5)) * 10).astype(np.float32),
            "c": {"d": rng.normal(size=(3, 2, 2)).astype(np.float32)}}
    key = jc.jax.random.PRNGKey(seed)
    jq, js = jc.c.quantize_tree(tree, key, bits)
    q, s = compression.quantize_tree(lm_params_from_jax(tree), _jax_noise(jc, key, tree), bits)
    for path, want in _paths(_np(jq)).items():
        np.testing.assert_array_equal(_paths(_np(q))[path], want)
        assert float(_paths(s)[path]) == float(_paths(_np(js))[path])
    deq = _paths(_np(compression.dequantize_tree(q, s)))
    for path, x in _paths(tree).items():
        np.testing.assert_array_equal(deq[path], _paths(_np(jc.c.dequantize_tree(jq, js)))[path])
        qmax = 2 ** (bits - 1) - 1
        assert np.abs(deq[path] - x).max() <= np.abs(x).max() / qmax * 1.01


def test_error_feedback_equals_reference(jc):
    """compress_with_error_feedback over 20 rounds from err=None: q, the
    scales and the residual bit for bit with the reference's, and the
    accumulated drift bounded as tests/test_substrate.py bounds it."""
    rng = np.random.default_rng(0)
    x = {"g": rng.normal(size=(256,)).astype(np.float32)}
    jerr, err = None, None
    acc_true, acc_sent = np.zeros(256), np.zeros(256)
    for i in range(20):
        key = jc.jax.random.PRNGKey(i)
        jq, js, jerr = jc.c.compress_with_error_feedback(x, jerr, key)
        q, s, err = compression.compress_with_error_feedback(
            lm_params_from_jax(x), err, _jax_noise(jc, key, x))
        np.testing.assert_array_equal(q["g"].numpy(), np.asarray(jq["g"]))
        assert float(s["g"]) == float(js["g"])
        np.testing.assert_array_equal(err["g"].numpy(), np.asarray(jerr["g"]))
        acc_true += x["g"]
        acc_sent += compression.dequantize_tree(q, s)["g"].numpy()
    assert np.abs(acc_true - acc_sent).max() <= 2 * np.abs(x["g"]).max() / 127 * 20 ** 0.5 + 0.05


def test_per_leaf_api_edges(jc):
    """Empty trees short-circuit (no noise needed), as the reference's;
    init_residual keeps the structure in the dtype asked for; no noise
    raises; the wire oracle counts nested trees."""
    assert compression.quantize_tree({}, None) == ({}, {})
    assert compression.compress_with_error_feedback({}, None, None) == ({}, {}, {})
    res = compression.init_residual({"a": torch.ones(2, dtype=torch.bfloat16),
                                     "b": {"c": torch.ones(3)}}, torch.float64)
    assert res["a"].dtype == res["b"]["c"].dtype == torch.float64 and res["b"]["c"].shape == (3,)
    with pytest.raises(ValueError, match="explicit noise"):
        compression.quantize_tree({"a": torch.ones(2)}, None)
    tree = {"a": np.zeros(100, np.float32), "b": {"c": np.zeros((3, 3), np.float32)}}
    for scheme in ("none", "int8", "int4", "topk"):
        assert compression.compressed_bytes(lm_params_from_jax(tree), scheme) == \
            jc.c.compressed_bytes(tree, scheme)
    assert compression.raw_bytes(lm_params_from_jax(tree)) == jc.c.raw_bytes(tree)
