"""FSDP parameter sharding over "data" — the reference's ``fsdp="data"``
rules — on gloo worlds of CPU ranks, against one process and the JAX
reference's GSPMD step.

``specs.make_train_step`` under the sfl rules holds each parameter leaf,
and each optimizer moment, as this rank's shard along the dimension that
``param_shardings`` maps onto "data" (``train_step.layout``). The cases:
worlds of 2 and 4 on a (world, 1) ("data", "model") mesh and 4 ranks on a
(2, 2, 1) ("pod", "data", "model") mesh; qwen2-0.5b, rwkv6-3b and
qwen3-moe-30b-a3b at reduced width in f32; sgd (lr 0.5) and adamw (lr
1e-3); micro-batches 1 and 2. One step from the port's parameters on every
rank: loss, gradient norm, every updated parameter and adamw's moments
within 1e-5 of one process's and of the reference's GSPMD step on a
(2, 2, 1) mesh of 4 host devices with the parameters placed by its
``filter_valid_spec`` shardings; ranks alike bit for bit; each rank's
leaves the shard's shape, on the dimension the reference shards. Sharded
checkpoints restore on one process and the other way round, and
``launch.train.run`` on 2 ranks resumes qwen3-moe from one bit for bit.
The ranks run as in ``tests/test_torch_collectives.py`` (``_spawn``).
"""
import os
import shutil
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
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs, train  # noqa: E402
from repro_torch.launch.train import build_rules  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from test_torch_collectives import ROOT, TIMEOUT_S, _nest, _paths, _spawn  # noqa: E402

ARCHS = ("qwen2-0.5b", "rwkv6-3b", "qwen3-moe-30b-a3b")
CASES = [(arch, micro, opt) for arch in ARCHS for micro in (1, 2) for opt in ("sgd", "adamw")]
# AdamW's first step moves an element by about ±lr whatever its gradient's
# size, so where a gradient is f32 noise (a key bias's: the softmax ignores
# it) two sums may step either way: at lr 3e-4 that stays inside 1e-4,
# while a wrong sign or bias correction (≥ 1.7e-4) does not, as in
# tests/test_torch_train.py; its moments are held at 1e-5
LR = {"sgd": 0.5, "adamw": 3e-4}
PARAM_TOL = {"sgd": 1e-5, "adamw": 1e-4}
MESHES = {"data2": ((2, 1), ("data", "model")), "data4": ((4, 1), ("data", "model")),
          "pod2_data2": ((2, 2, 1), ("pod", "data", "model"))}
BATCH, SEQ, TOL = 8, 16, 1e-5
RUN = dict(batch=4, seq=16, opt="adamw", lr=0.01, log_every=100, device="cpu", ckpt_every=100)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return configs.get_smoke(arch, dtype="float32")


def _params(arch):
    return transformer.init_params(_cfg(arch), torch.Generator().manual_seed(5), device="cpu")


def _batch():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    w = rng.integers(1, 300, BATCH).astype(np.float32)
    w[[2, 5]] = 0.0
    return {"tokens": tokens, "client_weight": w}


def _step(arch, micro, opt_name, mesh=None):
    """One step from ``_params(arch)``: (the full updated parameters and
    optimizer state in the reference's layout, loss, gradient norm, the
    shapes this rank held). On a mesh the ranks hold shards."""
    rules = None if mesh is None else build_rules(mesh, "sfl")
    step = specs.make_train_step(_cfg(arch), opt_name, LR[opt_name], micro, mesh=mesh,
                                 rules=rules)
    params = _params(arch)
    if mesh is not None:
        params = step.layout.shard(params)
    state = make_optimizer(opt_name).init(params)
    held = {k: tuple(v.shape) for k, v in _paths({"params": params, "state": state}).items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["tokens"] = batch["tokens"].long()
    new, state, loss = step(params, state, batch)
    if mesh is not None:
        new = step.layout.gather(new)
        state = step.layout.gather(state, step.layout.state_places(state))
    return (lm_params_to_jax(new), lm_params_to_jax(state), float(loss),
            float(step.grad_norm), held)


def _ranks(rank, world, shape, axes, ckpt_dir):
    """Every case on this rank of the mesh; a sharded checkpoint of
    qwen3-moe's state after its adamw step, and this rank's slice of the
    one-process checkpoint."""
    mesh = mesh_mod.make_test_mesh(shape, axes, "cpu")
    out = {"steps": {case: _step(*case, mesh=mesh) for case in CASES}}
    arch = "qwen3-moe-30b-a3b"
    step = specs.make_train_step(_cfg(arch), "adamw", 1e-3, mesh=mesh,
                                 rules=build_rules(mesh, "sfl"))
    lay = step.layout
    params = lay.shard(_params(arch))
    state = make_optimizer("adamw").init(params)
    places = (lay.places, lay.state_places(state))
    save_checkpoint(os.path.join(ckpt_dir, f"sharded{world}"), 1, (params, state),
                    sharding_tree=places, group=lay.group)
    restored, _, _ = restore_checkpoint(os.path.join(ckpt_dir, "one"), 1, (params, state),
                                        places)
    out["restored"] = _paths({"got": dict(zip("ps", restored)), "want": {"p": params,
                                                                           "s": state}})
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A one-process checkpoint of qwen3-moe's parameters and adamw state."""
    d = tmp_path_factory.mktemp("fsdp_ckpt")
    full = _params("qwen3-moe-30b-a3b")
    save_checkpoint(str(d / "one"), 1, (full, make_optimizer("adamw").init(full)))
    return str(d)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, ckpt_dir):
    return {name: _spawn(tmp_path_factory.mktemp(name), int(np.prod(shape)), _ranks, shape,
                         axes, ckpt_dir)
            for name, (shape, axes) in MESHES.items()}


@pytest.fixture(scope="module")
def one_process():
    return {case: _step(*case) for case in CASES}


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

    mesh = make_test_mesh((2, 2, 1), ("pod", "data", "model"))
    rules = ShardingRules(batch=("pod", "data"), fsdp="data", tensor="model", expert="model")
    batch = {"tokens": jnp.asarray(inp["tokens"]), "client_weight": jnp.asarray(inp["w"])}
    batch = jax.device_put(batch, NamedSharding(mesh, P(("pod", "data"))))
    with mesh:
        for arch in sys.argv[3].split(","):
            cfg = configs.get_smoke(arch, dtype="float32")
            _, logical = transformer.init_params(cfg, abstract=True)
            params = nest(f"{arch}/")
            for k in logical:          # an empty subtree (a model without a tail)
                params.setdefault(k, {})
            shard = jax.tree.map(
                lambda x, s: NamedSharding(mesh, filter_valid_spec(mesh, s, x.shape)),
                params, spec_tree(rules, logical))
            params = jax.device_put(jax.tree.map(jnp.asarray, params), shard)
            for micro in (1, 2):
                for opt_name, lr in (("sgd", 0.5), ("adamw", 3e-4)):
                    opt = make_optimizer(opt_name)
                    step = jax.jit(specs.make_train_step(cfg, rules, opt_name, lr, micro))
                    new, state, loss = step(params, opt.init(params), batch)
                    key = f"{arch}/{micro}/{opt_name}/"
                    put(key + "params/", new)
                    put(key + "state/", state)
                    out[key + "loss"] = np.asarray(loss)
    np.savez(sys.argv[2], **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's GSPMD step under fsdp="data" on a (2, 2, 1) mesh of
    4 host devices, every case, from the port's parameters."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("fsdp_reference")
    inputs = {"tokens": _batch()["tokens"], "w": _batch()["client_weight"]}
    for arch in ARCHS:
        inputs.update({f"{arch}/{k}": v for k, v in
                       _paths(lm_params_to_jax(_params(arch))).items()})
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "inputs.npz"),
                        str(d / "out.npz"), ",".join(ARCHS)], capture_output=True, text=True,
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
def test_fsdp_step_equals_one_process_and_reference(worlds, one_process, reference, mesh,
                                                    arch, micro, opt):
    """Loss, gradient norm, every updated parameter and the optimizer's
    state on every rank within 1e-5 of one process's and the reference's
    GSPMD FSDP step; the ranks' gathered trees alike bit for bit."""
    want, want_state, want_loss, want_norm, _ = one_process[(arch, micro, opt)]
    key = f"{arch}/{micro}/{opt}/"
    jnew, jstate = _nest(reference, key + "params/"), _nest(reference, key + "state/")
    first = _paths(worlds[mesh][0]["steps"][(arch, micro, opt)][0])
    for rank, out in enumerate(worlds[mesh]):
        new, state, loss, norm, _ = out["steps"][(arch, micro, opt)]
        where = f"{arch} micro {micro} {opt} {mesh} rank {rank}"
        assert loss == pytest.approx(want_loss, rel=TOL, abs=TOL), where
        assert loss == pytest.approx(float(reference[key + "loss"]), rel=TOL, abs=TOL), where
        assert norm == pytest.approx(want_norm, rel=TOL), where
        _close(new, want, where, PARAM_TOL[opt])
        _close(new, jnew, where + " vs JAX", PARAM_TOL[opt])
        _close(state, want_state, where + " state")
        _close(state, jstate, where + " state vs JAX")
        for k, leaf in _paths(new).items():
            np.testing.assert_array_equal(leaf, first[k])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_only_its_shards(worlds, one_process, mesh):
    """Every parameter and moment leaf a rank held: the full shape with the
    dimension that the reference's ``filter_valid_spec`` shards over
    "data" divided by |data|, every other leaf whole."""
    jsh = pytest.importorskip("repro.common.sharding")
    jtf = pytest.importorskip("repro.models.transformer")
    shape, axes = MESHES[mesh]
    mesh_shape = dict(zip(axes, shape))
    n_data = mesh_shape["data"]
    rules = jsh.ShardingRules(batch=("pod", "data") if "pod" in axes else ("data",),
                              fsdp="data", tensor="model", expert="model")
    jconfigs = pytest.importorskip("repro.configs")
    fake = types.SimpleNamespace(shape=mesh_shape)
    for arch in ARCHS:
        _, logical = jtf.init_params(jconfigs.get_smoke(arch, dtype="float32"), abstract=True)
        full = one_process[(arch, 1, "adamw")][4]
        n_sharded = 0
        for out in worlds[mesh]:
            held = out["steps"][(arch, 1, "adamw")][4]
            assert sorted(held) == sorted(full)
            for k, shp in full.items():
                leaf = k.split("/", 2)[-1] if k.startswith("state/") else k.split("/", 1)[1]
                if k.startswith("state/t"):
                    assert held[k] == shp
                    continue
                spec = jsh.filter_valid_spec(fake, _leaf_spec(jsh, rules, logical, leaf), shp)
                want = tuple(n // n_data if ax is not None and "data" in
                             ((ax,) if isinstance(ax, str) else ax) else n
                             for n, ax in zip(shp, tuple(spec) + (None,) * len(shp)))
                assert held[k] == want, (mesh, arch, k, held[k], want)
                n_sharded += want != shp
        assert n_sharded > 0, (mesh, arch)


def _leaf_spec(jsh, rules, logical, path):
    node = logical
    for part in path.split("/"):
        node = node[part]
    return jsh.logical_to_physical(rules, node)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_checkpoint_restores_in_one_process_and_back(worlds, ckpt_dir, mesh):
    """The ranks' sharded checkpoint (rank 0 writes the gathered leaves)
    restores in one process to the full parameters and state; the
    one-process checkpoint restores onto each rank's shards."""
    world = int(np.prod(MESHES[mesh][0]))
    full = _params("qwen3-moe-30b-a3b")
    like = (full, make_optimizer("adamw").init(full))
    got, _, step = restore_checkpoint(os.path.join(ckpt_dir, f"sharded{world}"), 1, like)
    assert step == 1
    got = _paths(dict(zip("ps", got)))
    for k, v in _paths(dict(zip("ps", like))).items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    for out in worlds[mesh]:
        r = out["restored"]
        for k in [k for k in r if k.startswith("got/")]:
            np.testing.assert_array_equal(r[k].numpy(), r["want/" + k[4:]].numpy(), err_msg=k)


def _run_ranks(rank, world, ckpt):
    """qwen3-moe through launch.train.run: 4 steps straight, then 2 steps
    with a sharded checkpoint and a resumed run to 4."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    straight = train.run(cfg, steps=4, **RUN)
    first = train.run(cfg, steps=2, ckpt=ckpt, **RUN)
    resumed = train.run(cfg, steps=4, ckpt=ckpt, **RUN)
    lay = resumed["backend"].layout
    return {"straight": [r["loss"] for r in straight["history"]],
            "resumed": [r["loss"] for r in list(first["history"]) + list(resumed["history"])],
            "start": resumed["start_step"],
            "params": (_paths(lay.gather(straight["backend"].params)),
                       _paths(lay.gather(resumed["backend"].params)))}


def test_train_run_on_two_ranks_resumes_moe_from_sharded_checkpoint(tmp_path):
    """launch.train.run on 2 ranks (sfl: FSDP) trains qwen3-moe; a run
    resumed from its sharded checkpoint equals the uninterrupted one bit
    for bit, parameters too, and both equal one process's losses within
    1e-5."""
    ckpt = str(tmp_path / "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = _spawn(tmp_path / "ranks", 2, _run_ranks, ckpt)
    want = [r["loss"] for r in train.run(_cfg("qwen3-moe-30b-a3b"), steps=4,
                                         **RUN)["history"]]
    for o in out:
        assert o["start"] == 2
        assert o["resumed"] == o["straight"]
        assert o["straight"] == pytest.approx(want, rel=TOL)
        straight, resumed = o["params"]
        for k, v in straight.items():
            assert torch.equal(v, resumed[k]), k
