"""Serving over "model" — prefill and decode with the reference's
``tensor="model"``, ``expert="model"`` and ``fsdp="data"`` rules — on
gloo worlds of CPU ranks, against one process and the JAX reference's
jitted ``prefill_step`` / ``serve_step``.

``specs.make_prefill_step`` / ``make_serve_step`` on a mesh serve each
rank's rows from its FSDP shards (gathered a unit at a time) and its block
of the heads, channels, experts and vocabulary, with its block of the KV
cache: by KV heads where they divide the "model" axis, else by sequence,
whose decode combines the ranks' partial softmaxes. The meshes: (1, 2),
(1, 4) and (2, 2) ("data", "model"). The architectures, at reduced width
in f32, with parameters built for the mesh (``init_params(..., tp=<"model"
size>)``): qwen2-0.5b with 6 heads over 2 KV heads (by heads on 2 ranks,
by sequence on 4: a prompt of 5 in a 12-slot cache leaves ranks 2 and 3
empty, and the decode crosses into both), olmo-1b made MHA (4 KV heads:
by heads, K and V split with the queries), recurrentgemma-9b with a window
of 8 (MQA by sequence over the ring; prompts of 5, 8 and 16, under, equal
to and a multiple of the window, where the reference's positional ring
agrees with the port's rolled one), rwkv6-3b (its 4 heads padded to 16:
ranks of padding alone keep a zero state) and qwen3-moe-30b-a3b (experts
over "model", at capacity factor n_experts / top_k: no drops). The prefill
logits and every teacher-forced decode step's within 1e-4 of one
process's and of the reference's on a (2, 4) ("data", "model") mesh of 8
host devices with ``cache_struct_sharded``'s shardings; each rank's cache
has its block's shape. The combine's unit tests run in one process: shards
with no valid slot, the soft-cap, windows across shard edges.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bridge import lm_params_to_jax  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.train import build_rules  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models.rwkv6 import rwkv_heads  # noqa: E402
from test_torch_collectives import ROOT, TIMEOUT_S, _paths, _spawn  # noqa: E402

ARCHS = {"qwen2-0.5b": dict(n_heads=6, n_kv_heads=2), "olmo-1b": dict(n_kv_heads=4),
         "recurrentgemma-9b": dict(window=8, n_layers=4), "rwkv6-3b": {},
         "qwen3-moe-30b-a3b": dict(capacity_factor=4.0)}
# (arch, prompt length, decode steps): the cache holds prompt + steps
CASES = (("qwen2-0.5b", 5, 7), ("olmo-1b", 5, 3), ("recurrentgemma-9b", 5, 7),
         ("recurrentgemma-9b", 8, 4), ("recurrentgemma-9b", 16, 4), ("rwkv6-3b", 5, 3),
         ("qwen3-moe-30b-a3b", 5, 3))
MESHES = {"model2": ((1, 2), ("data", "model")), "model4": ((1, 4), ("data", "model")),
          "data2_model2": ((2, 2), ("data", "model"))}
BATCH, TOL = 4, 1e-4


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
    return transformer.init_params(_cfg(arch), torch.Generator().manual_seed(3), device="cpu",
                                   tp=tp)


def _tokens(P, G):
    return np.random.default_rng(P * 100 + G).integers(0, 256, (BATCH, P + G)).astype(np.int32)


def _serve(arch, P, G, tp, mesh=None, rules=None):
    """Prefill P tokens, then G teacher-forced decode steps: (the prefill
    logits and each step's, this rank's rows (first, last + 1), the cache's
    leaf shapes after prefill)."""
    cfg = _cfg(arch)
    tokens = torch.from_numpy(_tokens(P, G)).long()
    prefill = specs.make_prefill_step(cfg, P + G, mesh, rules)
    serve = specs.make_serve_step(cfg, mesh, rules)
    params = _params(arch, tp)
    if prefill.layout is not None:
        params = prefill.layout.shard(params)
    logits, cache = prefill(params, {"tokens": tokens[:, :P]})
    shapes = {k: tuple(v.shape) for k, v in _paths(cache).items()}
    out = [logits.numpy()]
    for t in range(G):
        batch = {"tokens": tokens[:, P + t:P + t + 1],
                 "pos": torch.full((BATCH, 1), P + t, dtype=torch.int32)}
        logits, cache = serve(params, batch, cache)
        out.append(logits.numpy())
    rows = (0, BATCH) if mesh is None else specs.serve_rows(mesh, BATCH)
    return np.stack(out), rows, shapes


def _ranks(rank, world, shape, axes):
    mesh = mesh_mod.make_test_mesh(shape, axes, "cpu")
    tp = dict(zip(axes, shape))["model"]
    rules = build_rules(mesh, "sfl")
    return {"coord": dict(zip(axes, mesh_mod.device_coords(mesh)[rank])),
            "cases": {case: _serve(*case, tp, mesh, rules) for case in CASES}}


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's jitted prefill and decode, started in a subprocess
    first so that it runs beside the gloo worlds."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("serve_reference")
    inputs, jobs = {}, []
    for arch, tp in sorted({(a, _tp(m)) for a, _, _ in CASES for m in MESHES}):
        inputs.update({f"{arch}@{tp}/{k}": v for k, v in
                       _paths(lm_params_to_jax(_params(arch, tp))).items()})
        for a, P, G in CASES:
            if a == arch:
                inputs[f"tokens/{P}/{G}"] = _tokens(P, G)
                jobs.append((f"{arch}@{tp}", arch, ARCHS[arch], tp, P, G))
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d / "inputs.npz"),
                             str(d / "out.npz"), repr(jobs)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def worlds(reference_run, tmp_path_factory):
    return {name: _spawn(tmp_path_factory.mktemp(name), int(np.prod(shape)), _ranks, shape,
                         axes)
            for name, (shape, axes) in MESHES.items()}


@pytest.fixture(scope="module")
def one_process():
    return {(case, tp): _serve(*case, tp) for case in CASES for tp in {_tp(m) for m in MESHES}}


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
    from repro.models.config import ShapeConfig

    inp = dict(np.load(sys.argv[1]))
    jobs = eval(sys.argv[3])           # [(key, arch, overrides, tp, P, G)]
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

    mesh = make_test_mesh((2, 4), ("data", "model"))
    rules = ShardingRules(batch=("data",), fsdp="data", tensor="model", expert="model")
    with mesh:
        for key, arch, over, tp, Pn, G in jobs:
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
            tokens = jnp.asarray(inp[f"tokens/{Pn}/{G}"])
            B = tokens.shape[0]
            rows = NamedSharding(mesh, P("data"))
            prefill = jax.jit(specs.make_prefill_step(cfg, rules, Pn + G))
            logits, cache = prefill(params, {"tokens": jax.device_put(tokens[:, :Pn], rows)})
            structs = specs.cache_struct_sharded(cfg, ShapeConfig("c", Pn + G, B, "decode"),
                                                 mesh, rules)
            cache = jax.tree.map(lambda x, s: jax.device_put(x, s.sharding), cache, structs)
            serve = jax.jit(specs.make_serve_step(cfg, rules))
            outs = [np.asarray(logits)]
            for t in range(G):
                batch = {"tokens": jax.device_put(tokens[:, Pn + t:Pn + t + 1], rows),
                         "pos": jax.device_put(jnp.full((B, 1), Pn + t, jnp.int32), rows)}
                logits, cache = serve(params, batch, cache)
                outs.append(np.asarray(logits))
            out[f"{key}/{Pn}/{G}"] = np.stack(outs)
    np.savez(sys.argv[2], **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, path = reference_run
    stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
    assert "REFERENCE_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,P,G", CASES)
def test_serving_equals_one_process_and_reference(worlds, one_process, reference, mesh, arch,
                                                  P, G):
    """Every rank's prefill logits and decode logits of its rows within 1e-4
    of one process's and of the reference's, from parameters built for the
    mesh; the ranks' rows cover the batch."""
    tp = _tp(mesh)
    want = one_process[((arch, P, G), tp)][0]
    ref = reference[f"{arch}@{tp}/{P}/{G}"]
    np.testing.assert_allclose(want, ref, rtol=TOL, atol=TOL, err_msg="one process vs JAX")
    covered = set()
    for rank, out in enumerate(worlds[mesh]):
        got, (lo, hi), _ = out["cases"][(arch, P, G)]
        where = f"{arch} P {P} {mesh} rank {rank}"
        assert got.shape == (G + 1, hi - lo, 256), where
        np.testing.assert_allclose(got, want[:, lo:hi], rtol=TOL, atol=TOL, err_msg=where)
        np.testing.assert_allclose(got, ref[:, lo:hi], rtol=TOL, atol=TOL,
                                   err_msg=where + " vs JAX")
        covered |= set(range(lo, hi))
    assert covered == set(range(BATCH))


def _block_shapes(arch, P, G, mesh_name):
    """Each cache leaf's shape on a rank: the reference's layout for the
    KV buffers (batch over "data"; KV heads over "model" where they divide
    it, else the sequence), the recurrent states the rank's channels or
    heads (the reference keeps those whole over "model")."""
    shape, axes = MESHES[mesh_name]
    m = dict(zip(axes, shape))
    cfg, tp = _cfg(arch), m["model"]
    B = BATCH // m["data"]
    clen = min(P + G, cfg.window) if cfg.window else P + G
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    kv = (B, clen, KV // tp, hd) if KV % tp == 0 else (B, clen // tp, KV, hd)
    r = cfg.rnn_width // tp
    Hp = rwkv_heads(cfg)[1] // tp
    want = {}
    for prefix, kinds, lead in (("unit", cfg.block_pattern, (cfg.n_units,)),
                                ("tail", cfg.tail_pattern, ())):
        for i, kind in enumerate(kinds):
            key = f"{prefix}/{i}_{kind}/"
            if kind == "attn":
                want.update({key + "k": lead + kv, key + "v": lead + kv, key + "pos": lead})
            elif kind == "rglru":
                want.update({key + "conv": lead + (B, cfg.conv_width - 1, r),
                             key + "h": lead + (B, r)})
            elif kind == "rwkv":
                want.update({key + "time/S": lead + (B, Hp, cfg.rwkv_head_dim,
                                                     cfg.rwkv_head_dim),
                             key + "time/shift": lead + (B, cfg.d_model),
                             key + "channel/shift": lead + (B, cfg.d_model)})
    return want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_block_of_the_cache(worlds, one_process, mesh):
    """Every cache leaf a rank holds after prefill has its block's shape,
    and the ranks' KV buffers together hold the whole cache's elements
    once: no rank holds more than its block."""
    for arch, P, G in CASES:
        whole = one_process[((arch, P, G), _tp(mesh))][2]
        want = _block_shapes(arch, P, G, mesh)
        kv_total = 0
        for out in worlds[mesh]:
            got = out["cases"][(arch, P, G)][2]
            assert got == want, (mesh, arch, P)
            kv_total += sum(int(np.prod(s)) for k, s in got.items() if k[-2:] in ("/k", "/v"))
        assert kv_total == sum(int(np.prod(s)) for k, s in whole.items()
                               if k[-2:] in ("/k", "/v")), (mesh, arch)


def _shards(q, k, v, valid, n, softcap=0.0):
    """The partials of ``n`` sequence shards stacked first, combined."""
    S = k.shape[1]
    parts = [layers.partial_decode_attention(q, k[:, i * S // n:(i + 1) * S // n],
                                             v[:, i * S // n:(i + 1) * S // n],
                                             valid[i * S // n:(i + 1) * S // n], softcap)
             for i in range(n)]
    o, lse = (torch.stack(t) for t in zip(*parts))
    return layers.combine_partial_attention(o, lse, lambda t: t.amax(0), lambda t: t.sum(0)), lse


def _qkv(seed, S=16, H=4, hd=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((2, 1, H, hd), generator=g), torch.randn((2, S, H, hd), generator=g),
            torch.randn((2, S, H, hd), generator=g))


@pytest.mark.parametrize("pos,window,softcap", [(2, 0, 0.0), (9, 0, 0.0), (15, 0, 5.0),
                                                (9, 5, 0.0), (13, 6, 3.0)],
                         ids=["empty_shards", "causal", "softcap", "window", "window_softcap"])
def test_combine_of_partials_equals_the_unsplit_softmax(pos, window, softcap):
    """Split into 4 shards of 4 slots: the combine equals the unsplit decode
    softmax (``_attend_block`` with the same mask) within 1e-5, finite;
    a shard with no valid slot has lse −inf and adds exactly 0."""
    q, k, v = _qkv(pos)
    idx = torch.arange(16)
    valid = idx <= pos
    if window:
        valid &= idx > pos - window
    got, lse = _shards(q, k, v, valid, 4, softcap)
    want = layers._attend_block(q, k, v, valid[None, None, None, :], 1.0 / np.sqrt(8), softcap)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    empty = [i for i in range(4) if not valid[4 * i:4 * i + 4].any()]
    for i in empty:
        assert torch.isneginf(lse[i]).all()
    if empty:
        rest = [i for i in range(4) if i not in empty]
        o, ls = _shards(q, k[:, 4 * rest[0]:4 * rest[-1] + 4], v[:, 4 * rest[0]:4 * rest[-1] + 4],
                        valid[4 * rest[0]:4 * rest[-1] + 4], len(rest), softcap)
        torch.testing.assert_close(got, o, rtol=0, atol=1e-6)
    assert empty or pos > 4


def test_cache_length_the_axis_does_not_divide_raises():
    """The sequence layout needs a cache length the "model" axis divides."""
    from repro_torch.core.tensor_parallel import TensorParallel
    cfg = _cfg("qwen2-0.5b")
    tp = TensorParallel(None, 4, 1)
    assert layers.kv_block(cfg, tp, 12) == (0, 2, 3, 3)
    assert layers.kv_block(cfg, TensorParallel(None, 2, 1), 12) == (1, 1, 0, 12)
    with pytest.raises(ValueError, match="does not split into 4 sequence shards"):
        layers.kv_block(cfg, tp, 10)
