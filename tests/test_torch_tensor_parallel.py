"""Tensor and expert parallelism over "model" — the reference's
``tensor="model"``, ``expert="model"`` rules — on gloo worlds of CPU ranks,
against one process and the JAX reference's GSPMD step.

``specs.make_train_step`` on a mesh with a "model" axis holds each leaf's
block over "model" (and its FSDP shard over "data") and runs the forward in
``core.tensor_parallel``'s region. The meshes: (1, 2) and (1, 4) ("data",
"model"), (2, 2) ("data", "model") and (2, 2, 2) ("pod", "data",
"model"). The architectures, at reduced width in f32, with parameters
built for the mesh (``init_params(..., tp=<"model" size>)``):
qwen2-0.5b with 6 heads over 2 KV heads (at 4 ranks padded to 8, so rank
1's heads 2-3 straddle the KV groups and rank 3 holds padding alone; tied
table), olmo-1b made MHA (4 KV heads, split with the query heads; tied
table), rwkv6-3b (its 4 heads padded to 16: ranks of padding alone),
recurrentgemma-9b (RG-LRU channels, windowed MQA) and qwen3-moe-30b-a3b
(experts over "model", the manual combine, an untied head). sgd (lr 0.5)
and adamw (lr 3e-4), micro-batches 1 and 2 on qwen2-0.5b. One step: loss,
gradient norm, every updated parameter and adamw's moments within the
tolerances of ``tests/test_torch_fsdp.py`` of one process's and of the
reference's GSPMD step on a (2, 2, 2) mesh of 8 host devices with its
parameters placed by its ``filter_valid_spec`` shardings. Ranks that share
a "model" coordinate hold the same shards bit for bit; each rank's leaves
have the shard's shape on the dimensions the reference shards. The MoE
block's manual combine equals the one-process gather path within 1e-4,
forward and gradients; a TP + FSDP checkpoint restores in one process and
back. The ranks run as in ``tests/test_torch_collectives.py`` (``_spawn``).
"""
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bridge import lm_params_to_jax  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.core.aggregation import all_reduce  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.train import build_rules  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from test_torch_collectives import ROOT, TIMEOUT_S, _nest, _paths, _spawn  # noqa: E402

ARCHS = {"qwen2-0.5b": dict(n_heads=6, n_kv_heads=2), "olmo-1b": dict(n_kv_heads=4),
         "rwkv6-3b": {}, "recurrentgemma-9b": {}, "qwen3-moe-30b-a3b": {}}
CASES = ([(arch, 1, opt) for arch in ARCHS for opt in ("sgd", "adamw")]
         + [("qwen2-0.5b", 2, opt) for opt in ("sgd", "adamw")])
LR = {"sgd": 0.5, "adamw": 3e-4}
PARAM_TOL = {"sgd": 1e-5, "adamw": 1e-4}
MESHES = {"model2": ((1, 2), ("data", "model")), "model4": ((1, 4), ("data", "model")),
          "data2_model2": ((2, 2), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
BATCH, SEQ, TOL = 8, 16, 1e-5
MOE = "qwen3-moe-30b-a3b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return configs.get_smoke(arch, dtype="float32", **ARCHS[arch])


def _tp(mesh_name):
    shape, axes = MESHES[mesh_name]
    return dict(zip(axes, shape))["model"]


def _params(arch, tp):
    return transformer.init_params(_cfg(arch), torch.Generator().manual_seed(5), device="cpu",
                                   tp=tp)


def _variants():
    """(arch, tp) of every parameter set the meshes need; a tp whose tree
    is tp 2's shares its results."""
    out = {}
    for arch in ARCHS:
        for tp in sorted({_tp(m) for m in MESHES}):
            shapes = {k: tuple(v.shape) for k, v in _paths(transformer.abstract_params(
                _cfg(arch), tp)[0]).items()}
            out[(arch, tp)] = next((v for v, s in out.values() if s == shapes and v[0] == arch),
                                   (arch, tp)), shapes
    return {k: v for k, (v, _) in out.items()}


VARIANT = _variants()


def _batch():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    w = rng.integers(1, 300, BATCH).astype(np.float32)
    w[[2, 5]] = 0.0
    return {"tokens": tokens, "client_weight": w}


def _step(arch, micro, opt_name, tp, mesh=None):
    """One step from ``_params(arch, tp)``: (the full updated parameters and
    optimizer state in the reference's layout, loss, gradient norm, the
    shapes this rank held, this rank's updated shards)."""
    rules = None if mesh is None else build_rules(mesh, "sfl")
    step = specs.make_train_step(_cfg(arch), opt_name, LR[opt_name], micro, mesh=mesh,
                                 rules=rules)
    params = _params(arch, tp)
    if mesh is not None:
        params = step.layout.shard(params)
    state = make_optimizer(opt_name).init(params)
    held = {k: tuple(v.shape) for k, v in _paths({"params": params, "state": state}).items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["tokens"] = batch["tokens"].long()
    new, state, loss = step(params, state, batch)
    local = _paths(new)
    cut = set() if mesh is None else {k for k, pl in _paths(step.layout.places).items() if pl}
    if mesh is not None:
        new = step.layout.gather(new)
        state = step.layout.gather(state, step.layout.state_places(state))
    return (lm_params_to_jax(new), lm_params_to_jax(state), float(loss),
            float(step.grad_norm), held, (local, cut))


def _moe_combine(mesh):
    """qwen3-moe's MoE block at capacity factor 8 on (4, 32, d) inputs
    (the reference's ``test_moe_manual_combine_multidevice``): this rank's
    rows through its experts and the manual combine, the output and the
    gradients of Σ out² (the parameters' summed over the client ranks)."""
    import dataclasses
    cfg = dataclasses.replace(_cfg(MOE), capacity_factor=8.0)
    p = _params(MOE, _tp("pod2_data2_model2"))["unit"]["0_attn"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32))
    layout = specs.make_train_step(cfg, "sgd", mesh=mesh, rules=build_rules(mesh, "sfl")).layout
    tp = layout.tp
    r, R = mesh_mod.client_index(mesh, ("pod", "data"))
    El = cfg.n_experts // tp.size
    local = {k: v if k == "router" else v[tp.index * El:(tp.index + 1) * El].clone()
             for k, v in p.items()}
    xr = x[r * 4 // R:(r + 1) * 4 // R].clone().requires_grad_(True)
    for v in local.values():
        v.requires_grad_(True)
    client = mesh_mod.axes_group(mesh, ("pod", "data"))
    out, _ = moe.moe_block_scatter(xr, local, cfg, client, tp)
    grads = torch.autograd.grad((out ** 2).sum(), [xr, *local.values()])
    return {"out": out.detach(), "x": grads[0],
            **{k: all_reduce(g, client) for k, g in zip(local, grads[1:])},
            "rows": (r, R), "experts": (tp.index, El)}


def _ranks(rank, world, shape, axes, ckpt_dir):
    """Every case on this rank of the mesh; on (2, 2) a TP + FSDP
    checkpoint of qwen3-moe's state and this rank's blocks of the
    one-process checkpoint; on (2, 2, 2) the manual combine."""
    mesh = mesh_mod.make_test_mesh(shape, axes, "cpu")
    tp = dict(zip(axes, shape))["model"]
    out = {"steps": {case: _step(*case, tp, mesh=mesh) for case in CASES},
           "coord": dict(zip(axes, mesh_mod.device_coords(mesh)[rank]))}
    if shape == MESHES["data2_model2"][0]:
        step = specs.make_train_step(_cfg(MOE), "adamw", 1e-3, mesh=mesh,
                                     rules=build_rules(mesh, "sfl"))
        lay = step.layout
        params = lay.shard(_params(MOE, tp))
        state = make_optimizer("adamw").init(params)
        places = (lay.shards, lay.state_places(state))
        save_checkpoint(os.path.join(ckpt_dir, "sharded"), 1, (params, state),
                        sharding_tree=places, group=lay.axis_groups)
        restored, _, _ = restore_checkpoint(os.path.join(ckpt_dir, "one"), 1, (params, state),
                                            places)
        out["restored"] = _paths({"got": dict(zip("ps", restored)),
                                  "want": {"p": params, "s": state}})
    if len(shape) == 3:
        out["combine"] = _moe_combine(mesh)
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A one-process checkpoint of qwen3-moe's parameters (built for 2
    model ranks) and adamw state."""
    d = tmp_path_factory.mktemp("tp_ckpt")
    full = _params(MOE, 2)
    save_checkpoint(str(d / "one"), 1, (full, make_optimizer("adamw").init(full)))
    return str(d)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, ckpt_dir):
    return {name: _spawn(tmp_path_factory.mktemp(name), int(np.prod(shape)), _ranks, shape,
                         axes, ckpt_dir)
            for name, (shape, axes) in MESHES.items()}


@pytest.fixture(scope="module")
def one_process():
    return {(case, VARIANT[(case[0], tp)][1]): _step(*case, VARIANT[(case[0], tp)][1])
            for case in CASES for tp in {_tp(m) for m in MESHES}}


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.common.sharding import ShardingRules, filter_valid_spec, spec_tree
    from repro.launch import specs
    from repro.launch.mesh import make_test_mesh
    from repro.models import transformer
    from repro.optim import make_optimizer

    inp = dict(np.load(sys.argv[1]))
    jobs = eval(sys.argv[3])           # [(key, arch, overrides, tp, [(micro, opt, lr)])]
    out = {}

    def nest(prefix):
        tree = {}
        for key, v in inp.items():
            if key.startswith(prefix):
                *dirs, leaf = key[len(prefix):].split("/")
                d = tree
                for part in dirs:
                    d = d.setdefault(part, {})
                d[leaf] = v
        return tree

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    rules = ShardingRules(batch=("pod", "data"), fsdp="data", tensor="model", expert="model")
    batch = {"tokens": jnp.asarray(inp["tokens"]), "client_weight": jnp.asarray(inp["w"])}
    batch = jax.device_put(batch, NamedSharding(mesh, P(("pod", "data"))))
    with mesh:
        for key, arch, over, tp, runs in jobs:
            cfg = configs.get_smoke(arch, dtype="float32", **over)
            _, logical = transformer.init_params(cfg, abstract=True, tp=tp)
            params = nest(f"{key}/")

            def fill(lg, tree):        # empty subtrees (no tail, a norm without weights)
                for k, v in lg.items():
                    if isinstance(v, dict):
                        fill(v, tree.setdefault(k, {}))
            fill(logical, params)
            shard = jax.tree.map(
                lambda x, s: NamedSharding(mesh, filter_valid_spec(mesh, s, x.shape)),
                params, spec_tree(rules, logical))
            params = jax.device_put(jax.tree.map(jnp.asarray, params), shard)
            for micro, opt_name, lr in runs:
                opt = make_optimizer(opt_name)
                step = jax.jit(specs.make_train_step(cfg, rules, opt_name, lr, micro))
                new, state, loss = step(params, opt.init(params), batch)
                name = f"{key}/{micro}/{opt_name}/"
                put(name + "params/", new)
                put(name + "state/", state)
                out[name + "loss"] = np.asarray(loss)
    np.savez(sys.argv[2], **out)
    print("REFERENCE_OK")
""")


def _key(arch, tp):
    return f"{arch}@{tp}"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's GSPMD step under tensor="model", expert="model" on a
    (2, 2, 2) mesh of 8 host devices, every case, from the port's
    parameters of each tp the meshes need."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("tp_reference")
    inputs = {"tokens": _batch()["tokens"], "w": _batch()["client_weight"]}
    jobs = []
    for arch, tp in sorted(set(VARIANT.values())):
        inputs.update({f"{_key(arch, tp)}/{k}": v for k, v in
                       _paths(lm_params_to_jax(_params(arch, tp))).items()})
        jobs.append((_key(arch, tp), arch, ARCHS[arch], tp,
                     [(micro, opt, LR[opt]) for a, micro, opt in CASES if a == arch]))
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "inputs.npz"),
                        str(d / "out.npz"), repr(jobs)], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=TIMEOUT_S)
    assert "REFERENCE_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _close(got, want, where, tol=TOL):
    got, want = _paths(got), _paths(want)
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol, err_msg=f"{where} {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,micro,opt", CASES)
def test_tp_step_equals_one_process_and_reference(worlds, one_process, reference, mesh,
                                                  arch, micro, opt):
    """Loss, gradient norm, every updated parameter and the optimizer's
    state on every rank within the tolerances of one process's and of the
    reference's GSPMD step, from parameters built for the mesh."""
    tp = VARIANT[(arch, _tp(mesh))][1]
    want, want_state, want_loss, want_norm, _, _ = one_process[((arch, micro, opt), tp)]
    key = f"{_key(arch, tp)}/{micro}/{opt}/"
    jnew, jstate = _nest(reference, key + "params/"), _nest(reference, key + "state/")
    for rank, out in enumerate(worlds[mesh]):
        new, state, loss, norm, _, _ = out["steps"][(arch, micro, opt)]
        where = f"{arch} micro {micro} {opt} {mesh} rank {rank}"
        assert loss == pytest.approx(want_loss, rel=TOL, abs=TOL), where
        assert loss == pytest.approx(float(reference[key + "loss"]), rel=TOL, abs=TOL), where
        assert norm == pytest.approx(want_norm, rel=TOL), where
        _close(new, want, where, PARAM_TOL[opt])
        _close(new, jnew, where + " vs JAX", PARAM_TOL[opt])
        _close(state, want_state, where + " state")
        _close(state, jstate, where + " state vs JAX")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_of_one_model_coordinate_agree_bit_for_bit(worlds, mesh):
    """The blocks a step leaves on the ranks of one "model" coordinate
    (data-parallel peers) are equal bit for bit, every case: every leaf
    where they also share the "data" coordinate, the leaves FSDP leaves
    whole otherwise; the gathered trees are equal on every rank."""
    by_coord = {}
    for out in worlds[mesh]:
        by_coord.setdefault(out["coord"]["model"], []).append(out)
    assert len(by_coord) == _tp(mesh)
    n_peers = 0
    for case in CASES:
        for peers in by_coord.values():
            first, cut = peers[0]["steps"][case][5]
            for out in peers[1:]:
                same_data = out["coord"]["data"] == peers[0]["coord"]["data"]
                for k, leaf in out["steps"][case][5][0].items():
                    if same_data or k not in cut:
                        assert torch.equal(leaf, first[k]), (mesh, case, k)
                n_peers += 1
        whole = _paths(worlds[mesh][0]["steps"][case][0])
        for out in worlds[mesh][1:]:
            for k, leaf in _paths(out["steps"][case][0]).items():
                np.testing.assert_array_equal(leaf, whole[k], err_msg=f"{mesh} {case} {k}")
    assert n_peers == (len(worlds[mesh]) // _tp(mesh) - 1) * _tp(mesh) * len(CASES)


def _leaf_spec(jsh, rules, logical, path):
    node = logical
    for part in path.split("/"):
        node = node[part]
    return jsh.logical_to_physical(rules, node)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_only_its_shards(worlds, one_process, mesh):
    """Every parameter and moment leaf a rank held: the full shape with each
    dimension the reference's ``filter_valid_spec`` shards over "data" or
    "model" divided by that axis's size, every other dimension whole."""
    jsh = pytest.importorskip("repro.common.sharding")
    jtf = pytest.importorskip("repro.models.transformer")
    jconfigs = pytest.importorskip("repro.configs")
    shape, axes = MESHES[mesh]
    mesh_shape = dict(zip(axes, shape))
    rules = jsh.ShardingRules(batch=("pod", "data") if "pod" in axes else ("data",),
                              fsdp="data", tensor="model", expert="model")
    fake = types.SimpleNamespace(shape=mesh_shape)
    for arch in ARCHS:
        tp = _tp(mesh)
        _, logical = jtf.init_params(jconfigs.get_smoke(arch, dtype="float32", **ARCHS[arch]),
                                     abstract=True, tp=tp)
        full = one_process[((arch, 1, "adamw"), VARIANT[(arch, tp)][1])][4]
        cut = {"data": 0, "model": 0}
        for out in worlds[mesh]:
            held = out["steps"][(arch, 1, "adamw")][4]
            assert sorted(held) == sorted(full)
            for k, shp in full.items():
                if k.startswith("state/t"):
                    assert held[k] == shp
                    continue
                leaf = k.split("/", 2)[-1] if k.startswith("state/") else k.split("/", 1)[1]
                spec = jsh.filter_valid_spec(fake, _leaf_spec(jsh, rules, logical, leaf), shp)
                want = []
                for n, ax in zip(shp, tuple(spec) + (None,) * len(shp)):
                    names = () if ax is None else (ax,) if isinstance(ax, str) else ax
                    for a in names:
                        n //= mesh_shape[a]
                        cut[a] += mesh_shape[a] > 1
                    want.append(n)
                assert held[k] == tuple(want), (mesh, arch, k, held[k], want)
        assert cut["model"] > 0, (mesh, arch)
        assert cut["data"] > 0 or mesh_shape["data"] == 1, (mesh, arch)


def test_manual_combine_equals_the_gather_path(worlds):
    """On (pod 2, data 2, model 2): each rank's rows through its experts and
    the manual combine (one all-reduce over "model") equal the one-process
    gather path on all rows, the output within 1e-4 and the gradients of Σ
    out² (the input's rows, the router, each rank's experts) within 1e-4 of
    each leaf's largest magnitude (the router's reaches 1.7e5: f32 sums in
    another order move it by ~3e-2)."""
    import dataclasses
    cfg = dataclasses.replace(_cfg(MOE), capacity_factor=8.0)
    p = _params(MOE, _tp("pod2_data2_model2"))["unit"]["0_attn"]["moe"]
    p = {k: v[0].clone().requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    out, _ = moe.moe_block_scatter(x, p, cfg)
    grads = dict(zip(["x", *p], torch.autograd.grad((out ** 2).sum(), [x, *p.values()])))
    for rank, res in enumerate(worlds["pod2_data2_model2"]):
        got = res["combine"]
        (r, R), (e, El) = got["rows"], got["experts"]
        rows = slice(r * 4 // R, (r + 1) * 4 // R)
        where = f"rank {rank}"
        torch.testing.assert_close(got["out"], out.detach()[rows], rtol=1e-4, atol=1e-4,
                                   msg=where)
        for k, g in grads.items():
            want = (g[rows] if k == "x" else g if k == "router" else g[e * El:(e + 1) * El])
            scale = max(1.0, float(want.abs().max()))
            assert float((got[k] - want).abs().max()) <= 1e-4 * scale, (where, k)


def test_tp_fsdp_checkpoint_restores_in_one_process_and_back(worlds, ckpt_dir):
    """The (data 2, model 2) ranks' checkpoint of leaves cut over "data" and
    "model" (rank 0 writes the gathered leaves) restores in one process to
    the full parameters and state; the one-process checkpoint restores onto
    each rank's blocks."""
    full = _params(MOE, 2)
    like = (full, make_optimizer("adamw").init(full))
    got, _, step = restore_checkpoint(os.path.join(ckpt_dir, "sharded"), 1, like)
    assert step == 1
    got = _paths(dict(zip("ps", got)))
    for k, v in _paths(dict(zip("ps", like))).items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    n_cut = 0
    for out in worlds["data2_model2"]:
        r = out["restored"]
        for k in [k for k in r if k.startswith("got/")]:
            np.testing.assert_array_equal(r[k].numpy(), r["want/" + k[4:]].numpy(), err_msg=k)
            n_cut += r[k].numel() < got[k[4:]].numel()
    assert n_cut > 0
