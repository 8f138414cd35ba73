"""The ``two_step_int8`` train step under FSDP and tensor parallelism: on a
(pod 2, data 2, model 2) gloo world of CPU ranks, against the replica
int8 form and the JAX reference's int8 step.

Four forms of the rules on the one mesh: full replicas over "data" and
nothing over "model" (the replica int8 form), FSDP over "data", tensor
and expert parallelism over "model" on full replicas over "data", and
both. Each rank sends its block of a pod-summed gradient across "pod" as
int8 at the whole leaf's scale (a max all-reduce over "data" and
"model"), quantized with its block's slice of the noise drawn at the
leaf's whole (padded) shape, so element for element the numbers are those
of the replica form: its updated parameters (sgd, so each is p − lr·g) and
loss equal the replica form's bit for bit, the TP forms' the TP replica
form's (the forward's rounding differs between a region and none). FSDP
and TP + FSDP are held against the reference's int8 step (manual over
"pod", GSPMD owning "data" and "model") on 8 host devices fed the same
noise, within the tolerance of ``tests/test_torch_collectives.py``'s
``test_two_step_int8_step_equals_reference``. Reckoned on ``meta``, each
rank's cross-pod int8 bytes are 1 / (|data|·|model|) of each leaf's.
"""
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bridge import lm_params_to_jax  # noqa: E402
from repro_torch.common.sharding import ShardingRules  # noqa: E402
from repro_torch.common.tree import flatten  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import segments, specs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from test_torch_collectives import ROOT, TIMEOUT_S, _nest, _paths, _spawn  # noqa: E402

POD, DATA, MODEL = 2, 2, 2
SHAPE, AXES = (POD, DATA, MODEL), ("pod", "data", "model")
ARCHS = {"qwen2-0.5b": dict(n_heads=6, n_kv_heads=2), "qwen3-moe-30b-a3b": {}}
CASES = (("qwen2-0.5b", 1), ("qwen2-0.5b", 2), ("qwen3-moe-30b-a3b", 1))
_BATCH = dict(batch=("pod", "data"))
FORMS = {"replica": ShardingRules(fsdp=None, tensor=None, expert=None, **_BATCH),
         "fsdp": ShardingRules(tensor=None, expert=None, **_BATCH),
         "tp": ShardingRules(fsdp=None, **_BATCH),
         "tp_fsdp": ShardingRules(**_BATCH)}
# each form and the form it equals bit for bit; the forms the reference runs
SAME = {"fsdp": "replica", "tp_fsdp": "tp"}
# the reference's runs: (form, arch, micro)
REFERENCE_CASES = (("fsdp", "qwen2-0.5b", 1), ("tp_fsdp", "qwen2-0.5b", 1),
                   ("tp_fsdp", "qwen2-0.5b", 2), ("tp_fsdp", "qwen3-moe-30b-a3b", 1))
REFERENCE_JOBS = [(form, arch, ARCHS[arch], micro) for form, arch, micro in REFERENCE_CASES]
B, S, LR, KEY = 16, 16, 0.5, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return configs.get_smoke(arch, dtype="float32", **ARCHS[arch])


def _params(arch):
    return transformer.init_params(_cfg(arch), torch.Generator().manual_seed(1), device="cpu",
                                   tp=MODEL)


def _inputs():
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    w = rng.integers(0, 400, B).astype(np.float32)
    w[[1, 6, 11]] = 0.0
    out = {"tokens": tokens, "client_weight": w}
    for arch in ARCHS:
        out.update({f"{arch}/{k}": v for k, v in _paths(lm_params_to_jax(_params(arch))).items()})
    return out


def _ranks(rank, world, inputs_npz, noise_npz):
    """Every form and case on this rank: (the gathered updated parameters
    in the reference's layout, the loss)."""
    inputs, noises = dict(np.load(inputs_npz)), dict(np.load(noise_npz))
    mesh = mesh_mod.make_test_mesh(SHAPE, AXES, "cpu")
    batch = {"tokens": torch.from_numpy(inputs["tokens"]).long(),
             "client_weight": torch.from_numpy(inputs["client_weight"])}
    out = {}
    for arch, micro in CASES:
        full = _params(arch)
        noise = [torch.from_numpy(noises[f"{arch}/{i}"]) for i in range(len(flatten(full)))]
        for form, rules in FORMS.items():
            step = specs.make_train_step(_cfg(arch), "sgd", LR, micro, "two_step_int8",
                                         mesh=mesh, rules=rules)
            layout = step.layout
            params = full if layout is None else layout.shard(full)
            new, _, loss = step(params, {}, batch, noise=lambda shapes: noise)
            if layout is not None:
                new = layout.gather(new)
            out[(form, arch, micro)] = (_paths(lm_params_to_jax(new)), float(loss))
    return out


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

    inp = dict(np.load(sys.argv[1]))
    jobs = eval(sys.argv[3])           # [(form, arch, overrides, micro)]
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
    forms = {"fsdp": ShardingRules(batch=("pod", "data"), fsdp="data", tensor=None,
                                   expert=None),
             "tp_fsdp": ShardingRules(batch=("pod", "data"), fsdp="data", tensor="model",
                                      expert="model")}
    batch = {"tokens": jnp.asarray(inp["tokens"]),
             "client_weight": jnp.asarray(inp["client_weight"])}
    batch = jax.device_put(batch, NamedSharding(mesh, P(("pod", "data"))))
    key = jax.random.PRNGKey(5)
    with mesh:
        for form, arch, over, micro in jobs:
            cfg = configs.get_smoke(arch, dtype="float32", **over)
            _, logical = transformer.init_params(cfg, abstract=True, tp=2)
            params = nest(f"{arch}/")

            def fill(lg, tree):        # empty subtrees (no tail)
                for k, v in lg.items():
                    if isinstance(v, dict):
                        fill(v, tree.setdefault(k, {}))
            fill(logical, params)
            rules = forms[form]
            shard = jax.tree.map(
                lambda x, s: NamedSharding(mesh, filter_valid_spec(mesh, s, x.shape)),
                params, spec_tree(rules, logical))
            placed = jax.device_put(jax.tree.map(jnp.asarray, params), shard)
            step = jax.jit(specs.make_train_step(cfg, rules, "sgd", 0.5, micro,
                                                 transport="two_step_int8", mesh=mesh))
            new, _, loss = step(placed, {}, batch, key)
            put(f"{form}/{arch}/{micro}/", new)
            out[f"{form}/{arch}/{micro}/loss"] = np.asarray(loss)
    np.savez(sys.argv[2], **out)
    print("REFERENCE_OK")
""")


def _noise(arch):
    """The reference's noise of the step's key: uniform(split(key, n)[i])
    at each leaf's whole shape, leaves in sorted-key order."""
    jax = pytest.importorskip("jax")
    leaves = flatten(lm_params_to_jax(_params(arch)))
    keys = jax.random.split(jax.random.PRNGKey(KEY), len(leaves))
    return [np.asarray(jax.random.uniform(k, x.shape)) for x, k in zip(leaves, keys)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("int8_parallel")
    np.savez(d / "inputs.npz", **_inputs())
    np.savez(d / "noise.npz", **{f"{arch}/{i}": u for arch in ARCHS
                                 for i, u in enumerate(_noise(arch))})
    return d


@pytest.fixture(scope="module")
def reference_run(paths):
    """The reference's int8 steps, started in a subprocess before the gloo
    world so that the two run side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(paths / "inputs.npz"),
                             str(paths / "out.npz"), repr(REFERENCE_JOBS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def reference(reference_run, paths):
    stdout, stderr = reference_run.communicate(timeout=TIMEOUT_S)
    assert "REFERENCE_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    return dict(np.load(paths / "out.npz"))


@pytest.fixture(scope="module")
def world(paths, reference_run, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world"), POD * DATA * MODEL, _ranks,
                  str(paths / "inputs.npz"), str(paths / "noise.npz"))


@pytest.mark.parametrize("form", list(SAME))
@pytest.mark.parametrize("arch,micro", [c for c in CASES if c[1] == 1])
def test_sharded_int8_step_equals_the_replica_form_bit_for_bit(world, form, arch, micro):
    """Every rank's updated parameters (p − lr · the pod sums / K) and loss
    equal the replica form's bit for bit: FSDP the replicas', TP + FSDP
    those of TP on replicas; and every rank ends with the same leaves. (With
    micro-batches FSDP sums each one's gradient over "data" before adding
    them, the replicas after: the f32 sums differ in order, so micro 2 is
    held against the reference alone.)"""
    for rank, out in enumerate(world):
        got, loss = out[(form, arch, micro)]
        want, want_loss = out[(SAME[form], arch, micro)]
        assert loss == want_loss, (form, arch, rank)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{form} {arch} rank {rank} {k}")
            np.testing.assert_array_equal(got[k], world[0][(form, arch, micro)][0][k])


def _levels(arch, inputs):
    """Per leaf: one quantization level of each pod (max|pod's Σ gradient|
    / 127, from one process's plain gradients), summed, over K."""
    cfg = _cfg(arch)
    params = _params(arch)
    n = B // POD
    total, K = None, 0.0
    for pod in range(POD):
        rows = {"tokens": torch.from_numpy(inputs["tokens"][pod * n:(pod + 1) * n]).long(),
                "client_weight": torch.from_numpy(inputs["client_weight"][pod * n:(pod + 1) * n])}

        def objective():
            tot, cnt = specs.unnormalized_loss_fn(params, rows, cfg)
            return tot, cnt.detach()
        grads, cnt = specs._grads(params, objective)
        level = {k: float(np.abs(g).max()) / 127
                 for k, g in _paths(lm_params_to_jax(grads)).items()}
        total = level if total is None else {k: total[k] + v for k, v in level.items()}
        K += float(cnt)
    return {k: v / K for k, v in total.items()}


@pytest.mark.parametrize("form,arch,micro", REFERENCE_CASES)
def test_sharded_int8_step_equals_reference(world, reference, paths, form, arch, micro):
    """FSDP and TP + FSDP against the reference's int8 step on the same mesh
    of host devices, fed the same noise: the loss to f32 rounding, every
    parameter within lr × (1e-5 of the leaf's largest step + one level of
    each pod), all but 1% within the first term."""
    inputs = dict(np.load(paths / "inputs.npz"))
    levels = _levels(arch, inputs)
    p0 = _paths(_nest(inputs, f"{arch}/"))
    want = _paths(_nest(reference, f"{form}/{arch}/{micro}/"))
    want_loss = float(want.pop("loss"))
    for out in world:
        got, loss = out[(form, arch, micro)]
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert sorted(got) == sorted(want)
        far, total = 0, 0
        for path, w in want.items():
            step = np.abs(p0[path] - w)
            tight = 1e-5 * step.max() + 1e-7
            diff = np.abs(np.asarray(got[path], np.float32) - w)
            assert diff.max() <= tight + LR * levels[path], (form, arch, path, diff.max())
            far += int((diff > tight).sum())
            total += diff.size
        assert far <= 0.01 * total, (form, arch, far, total)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_each_rank_sends_its_block_across_pod(arch):
    """Reckoned on ``meta`` for rank 0 of (pod 2, data 2, model 2): under
    TP + FSDP each leaf's ⌈n / (|data|·|model|)⌉ int8 bytes and one f32
    scale cross "pod" (an all-gather over 2 pods moves half its output a
    rank), plus the (Σ nll, K) pair's all-reduce: |model| times under the
    replica form's ⌈n / |data|⌉ a leaf."""
    cfg = _cfg(arch)
    shp, mesh = ShapeConfig("t", S, B, "train"), dict(zip(AXES, SHAPE))
    pod = {form: segments.count_step(cfg, shp, mesh, FORMS[form], "sgd", 1,
                                     "two_step_int8").coll["pod"]
           for form in ("replica", "tp_fsdp")}
    params = specs.param_shardings(cfg, mesh, FORMS["tp_fsdp"])[0]
    share = (POD - 1) / POD
    extra = sum(4 * POD * share for _ in flatten(params)) + 2 * 8 * share
    blocks = sum(math.ceil(x.numel() / (DATA * MODEL)) for x in flatten(params))
    whole = sum(math.ceil(x.numel() / DATA) for x in flatten(params))
    assert pod["tp_fsdp"] == blocks * POD * share + extra
    assert pod["replica"] == whole * POD * share + extra
    assert blocks * MODEL <= whole + MODEL * len(flatten(params))
