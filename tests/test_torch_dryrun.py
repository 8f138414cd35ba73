"""The launch tooling as the H100 cost model (``launch.{hw,roofline,
segments,dryrun}``, ``specs``' abstract inputs, the kernels' cost
functions) against the JAX reference and against itself.

Parity with the reference (exact): the registry, shapes and cells, the
dry run's CLI tables and rules, the logical-axes trees at full size, the
production meshes' parameter specs, the abstract batch / optimizer /
cache structs, ``roofline_terms`` with the H100's constants. The reference
runs once per module in a subprocess with 512 fake host devices (its dry
run's meshes).

The count (exact wherever two routes reckon the same work): matmul flops
against an analytic sum; the segment identity against the direct count;
the CPU count against the ``meta`` count; a view moves nothing; every
kernel's cost function at its PERF.md §6 row's shape gives that row's
Bound ms; nothing takes ``meta`` outside a counter. The command: a record
with the reference's keys; on the production meshes train cells are
counted with the tensor-parallel region's "model" bytes and serving cells
raise; each rank's shard shapes there match the reference's; the
reference's (2, 2, 2) system checks on the port's abstract mesh.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.common.sharding import ShardingRules  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.launch import dryrun, hw, roofline, segments, specs  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, axes_group  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ALL_SHAPES, ShapeConfig, shape_by_name  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 600
LM_ARCHS = [a for a in configs.ARCH_IDS if a != "femnist_cnn"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
OVERRIDES = (["remat=dots", "q_chunk=256"], ["fsdp=data,pod", "expert=data"],
             ["fsdp=", "tie_embeddings=true", "rope_theta=5e5"])
# the reference's cell_cost of a reduced olmo-1b train cell on (pod 2, data 4)
COST_SHAPE = ("t", 32, 8, "train")

_REFERENCE = r'''
import contextlib, io, json, os, sys
OUT = sys.argv[1]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro import configs
from repro.launch import dryrun, hw, specs as S
from repro.launch.mesh import make_production_mesh, make_test_mesh
from repro.launch.roofline import SegmentCost, roofline_terms
from repro.launch.segments import cell_cost
from repro.models import transformer
from repro.models.config import ALL_SHAPES, ShapeConfig
out = {}
archs = [a for a in configs.ARCH_IDS if a != "femnist_cnn"]
out["arch_ids"] = list(configs.ARCH_IDS)
out["shapes"] = [[s.name, s.seq_len, s.global_batch, s.kind] for s in ALL_SHAPES]
out["runnable"] = {a: [s.name for s in dryrun.runnable_cells(configs.get(a))] for a in archs}
buf = io.StringIO()
sys.argv = ["dryrun", "--list"]
with contextlib.redirect_stdout(buf):
    dryrun.main()
out["list"] = buf.getvalue()
out["micro"] = dryrun.MICRO_DEFAULT
out["overrides"] = []
for sets in OVERRIDES:
    cfg, f, e = dryrun.apply_overrides(configs.get("qwen2-0.5b"), sets)
    out["overrides"].append([{k: (list(v) if isinstance(v, tuple) else v)
                              for k, v in cfg.__dict__.items()},
                             list(f) if isinstance(f, tuple) else f, e])

def spec(p):
    return [list(a) if isinstance(a, tuple) else a for a in p]

def paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from paths(v, f"{pre}/{k}")
        else:
            yield f"{pre}/{k}", v

meshes = {"single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True)}
out["rules"], out["trees"], out["specs"], out["batch"], out["cache"] = {}, {}, {}, {}, {}
for name, mesh in meshes.items():
    for mode in ("sfl", "classical"):
        r = dryrun.rules_for_mesh(mesh, mode, *((("data", "pod"), "data") if mode == "classical"
                                                else (None, None)))
        out["rules"][f"{name}/{mode}"] = {k: (list(v) if isinstance(v, tuple) else v)
                                          for k, v in r.__dict__.items() if k != "table"}
for a in archs:
    cfg = configs.get(a)
    out["trees"][a] = {}
    for tp in (1, 16):
        p, lg = transformer.init_params(cfg, abstract=True, tp=tp)
        flat_l = dict(paths(lg))
        out["trees"][a][str(tp)] = {k: [list(v.shape), list(flat_l[k])]
                                    for k, v in paths(p)}
    out["specs"][a] = {}
    for name, mesh in meshes.items():
        for mode in ("sfl", "classical"):
            _, shard = S.param_shardings(cfg, mesh, dryrun.rules_for_mesh(mesh, mode))
            out["specs"][a][f"{name}/{mode}"] = {
                k: spec(v.spec) for k, v in paths(shard)}
    mesh, rules = meshes["single"], dryrun.rules_for_mesh(meshes["single"])
    p16, _ = transformer.init_params(cfg, abstract=True, tp=16)
    _, shard = S.param_shardings(cfg, mesh, rules)
    flat_p = dict(paths(p16))
    out.setdefault("shard_shapes", {})[a] = {k: list(s.shard_shape(tuple(flat_p[k].shape)))
                                             for k, s in paths(shard)}
    out["batch"][a] = {}
    for kind, decode in (("train", False), ("prefill", False), ("decode", True)):
        shp = ShapeConfig("x", 64, 32, kind)
        b = S.batch_struct(cfg, shp, mesh, rules, decode=decode)
        out["batch"][a][kind] = {k: [list(v.shape), str(v.dtype)] for k, v in b.items()}
    c = S.cache_struct_sharded(cfg, ShapeConfig("x", 4096, 32, "decode"), mesh, rules)
    out["cache"][a] = {k: [list(v.shape), str(v.dtype)] for k, v in paths(c)}
p, _ = transformer.init_params(configs.get("qwen2-0.5b"), abstract=True, tp=16)
out["opt"] = {o: {k: [list(v.shape), str(v.dtype)] for k, v in paths(S.opt_state_struct(o, p))}
              for o in ("sgd", "sgdm", "adamw", "yogi")}
hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.ICI_BW, hw.DCI_BW = H100
cost = SegmentCost(3.7e15, 2.1e12, {"pod": 4.4e8, "data": 1.3e9}, 5.5e9)
out["roofline"] = roofline_terms(cost, meshes["single"])
mesh = make_test_mesh((2, 4, 1), ("pod", "data", "model"))
cfg = configs.get_smoke("olmo-1b")
out["cell_cost"] = {}
for mode in ("sfl", "classical"):
    segs = cell_cost(cfg, ShapeConfig(*COST_SHAPE), mesh, dryrun.rules_for_mesh(mesh, mode),
                     "sgd")
    out["cell_cost"][mode] = segs["total"].coll
with open(OUT, "w") as f:
    json.dump(out, f)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("dryrun_reference")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               REPRO_XLA_DUMP=str(d / "xla"))
    prelude = (f"OVERRIDES = {OVERRIDES!r}\nCOST_SHAPE = {COST_SHAPE!r}\n"
               f"H100 = ({hw.PEAK_FLOPS_BF16!r}, {hw.HBM_BW!r}, {hw.NVLINK_BW!r}, "
               f"{hw.IB_BW!r})\n")
    r = subprocess.run([sys.executable, "-c", prelude + _REFERENCE, str(d / "out.json")],
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=TIMEOUT_S)
    assert "REFERENCE_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    with open(d / "out.json") as f:
        return json.load(f)


def _paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{pre}/{k}")
        else:
            yield f"{pre}/{k}", v


def _spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s]


def _dtype(t):
    return str(t.dtype).replace("torch.", "")


# ------------------------------------------------------------ parity with the reference

def test_registry_shapes_and_cells_match_reference(ref):
    assert list(configs.ARCH_IDS) == ref["arch_ids"]
    assert set(configs.all_configs()) == set(ref["arch_ids"])
    assert [[s.name, s.seq_len, s.global_batch, s.kind] for s in ALL_SHAPES] == ref["shapes"]
    assert all(shape_by_name(s.name) is s for s in ALL_SHAPES)
    with pytest.raises(KeyError):
        shape_by_name("train_8k")
    assert {a: [s.name for s in dryrun.runnable_cells(configs.get(a))]
            for a in LM_ARCHS} == ref["runnable"]


def test_list_tables_and_overrides_match_reference(ref, capsys):
    dryrun.main(["--list"])
    assert capsys.readouterr().out == ref["list"]
    assert dryrun.MICRO_DEFAULT == ref["micro"]
    assert dryrun.OPT_DEFAULT == {"arctic_480b": "sgdm", "llama3_2_vision_90b": "sgdm",
                                  "qwen1_5_110b": "adamw"}
    for sets, (want_cfg, want_f, want_e) in zip(OVERRIDES, ref["overrides"]):
        cfg, f, e = dryrun.apply_overrides(configs.get("qwen2-0.5b"), sets)
        got = {k: (list(v) if isinstance(v, tuple) else v) for k, v in cfg.__dict__.items()}
        assert got == want_cfg and (list(f) if isinstance(f, tuple) else f) == want_f
        assert e == want_e
    with pytest.raises(SystemExit, match="unknown config field"):
        dryrun.apply_overrides(configs.get("qwen2-0.5b"), ["nope=1"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", ["sfl", "classical"])
def test_rules_for_mesh_match_reference(ref, mesh, mode):
    over = (("data", "pod"), "data") if mode == "classical" else (None, None)
    r = dryrun.rules_for_mesh(MESHES[mesh][1], mode, *over)
    got = {k: (list(v) if isinstance(v, tuple) else v) for k, v in r.__dict__.items()
           if k != "table"}
    assert got == ref["rules"][f"{mesh}/{mode}"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logical_tree_and_specs_match_reference(ref, arch):
    """Every leaf's shape and logical axes at full size (tp 1 and 16), and
    its spec on the 16 × 16 and 2 × 16 × 16 meshes, both modes."""
    cfg = configs.get(arch)
    for tp in (1, 16):
        p, lg = transformer.abstract_params(cfg, tp=tp)
        flat_l = dict(_paths(lg, ""))
        got = {k: [list(v.shape), list(flat_l[k])] for k, v in _paths(p)}
        assert got == ref["trees"][arch][str(tp)], (arch, tp)
        assert all(t.device.type == "meta" for _, t in _paths(p))
    for mesh, (shape, axes) in MESHES.items():
        for mode in ("sfl", "classical"):
            _, shard = specs.param_shardings(cfg, dict(zip(axes, shape)),
                                             dryrun.rules_for_mesh(axes, mode))
            got = {k: _spec(v) for k, v in _paths(shard)}
            assert got == ref["specs"][arch][f"{mesh}/{mode}"], (arch, mesh, mode)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rank_shard_shapes_match_reference_on_16x16(ref, arch):
    """The config oracle of tensor parallelism: the leaves rank 0 of the
    16 × 16 ("data", "model") mesh holds under the sfl rules (the train
    step's layout, FSDP over "data" and blocks over "model") have the
    shapes of the reference's ``NamedSharding.shard_shape`` there, every
    leaf of every architecture: a padded head count, or a dimension that
    ``filter_valid_spec`` leaves whole, cannot drift."""
    cfg = configs.get(arch)
    shape = {"data": 16, "model": 16}
    rules = dryrun.rules_for_mesh(shape)
    params, _ = specs.param_shardings(cfg, shape, rules)
    layout = specs.make_train_step(cfg, mesh=AbstractMesh(shape), rules=rules).layout
    held = layout.shard(params)
    got = {k: list(v.shape) for k, v in _paths(held)}
    assert got == ref["shard_shapes"][arch]
    assert all(v.device.type == "meta" for _, v in _paths(held))
    assert layout.tp.size == 16 and layout.tp.index == 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_structs_match_reference(ref, arch):
    cfg = configs.get(arch)
    for kind, decode in (("train", False), ("prefill", False), ("decode", True)):
        b = specs.batch_struct(cfg, ShapeConfig("x", 64, 32, kind), decode=decode)
        assert {k: [list(v.shape), _dtype(v)] for k, v in b.items()} == ref["batch"][arch][kind]
        assert all(v.device.type == "meta" for v in b.values())
    c = specs.cache_struct_sharded(cfg, ShapeConfig("x", 4096, 32, "decode"))
    assert {k: [list(v.shape), _dtype(v)] for k, v in _paths(c)} == ref["cache"][arch]


def test_opt_state_struct_matches_reference(ref):
    p, _ = specs.param_shardings(configs.get("qwen2-0.5b"), {"data": 16, "model": 16})
    for o, want in ref["opt"].items():
        got = specs.opt_state_struct(o, p)
        assert {k: [list(v.shape), _dtype(v)] for k, v in _paths(got)} == want, o
    with pytest.raises(ValueError):
        specs.opt_state_struct("lion", p)


def test_roofline_terms_are_the_reference_formula_with_h100_constants(ref):
    cost = roofline.SegmentCost(3.7e15, 2.1e12, {"pod": 4.4e8, "data": 1.3e9}, 5.5e9,
                                {"bf16": 3.7e15})
    got = roofline.roofline_terms(cost, {"data": 16, "model": 16})
    assert got == pytest.approx(ref["roofline"], rel=1e-12) and got.keys() == ref["roofline"].keys()
    # each type at its own peak
    mixed = roofline.SegmentCost(2e12, 0.0, {}, 0.0, {"bf16": 1e12, "f32": 1e12})
    assert roofline.roofline_terms(mixed)["compute_s"] == pytest.approx(
        1e12 / hw.PEAK_FLOPS_BF16 + 1e12 / hw.PEAK_FLOPS_FP32)


def test_segment_cost_arithmetic():
    a = roofline.SegmentCost(10.0, 5.0, {"pod": 2.0}, 7.0, {"bf16": 10.0})
    b = roofline.SegmentCost(4.0, 1.0, {"pod": 1.0, "data": 3.0}, 9.0, {"bf16": 3.0, "f32": 1.0})
    s = a + b
    assert (s.flops, s.bytes_hbm, s.coll, s.peak_mem, s.flops_by_type) == (
        14.0, 6.0, {"pod": 3.0, "data": 3.0}, 9.0, {"bf16": 13.0, "f32": 1.0})
    t = a.scaled(3)
    assert (t.flops, t.coll, t.peak_mem, t.flops_by_type) == (30.0, {"pod": 6.0}, 7.0,
                                                              {"bf16": 30.0})
    m = a.minus(b)
    assert (m.flops, m.bytes_hbm, m.coll, m.flops_by_type) == (6.0, 4.0, {"pod": 1.0},
                                                               {"bf16": 7.0})


# ------------------------------------------------------------ the count

def _smoke(arch, **kw):
    return dataclasses.replace(configs.get_smoke(arch), **kw)


def test_matmul_flops_equal_an_analytic_sum():
    """A reduced dense forward + head on meta: the aten products are
    2·M·N·K each, the attention's the kernel's 4·hd a visible pair."""
    cfg = _smoke("qwen2-0.5b", n_layers=3)
    B, S = 2, 16
    p, _ = transformer.abstract_params(cfg, tp=4)
    batch = specs.batch_struct(cfg, ShapeConfig("x", S, B, "prefill"))
    with roofline.Counter() as c:
        x, _, _ = transformer.forward(p, batch, cfg)
        transformer.unembed(p, x, cfg)
    T, d, H, KV, hd, ff, V = (B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              cfg.d_ff, cfg.vocab_size)
    per_layer = 2 * T * d * (H + 2 * KV) * hd + 2 * T * H * hd * d + 3 * 2 * T * d * ff
    attn = 4 * hd * B * H * S * (S + 1) // 2
    assert c.kernels["flash_attention"]["flops"] == {"bf16": cfg.n_layers * attn}
    assert c.flops == {"bf16": cfg.n_layers * (per_layer + attn) + 2 * T * d * V}


def test_a_view_moves_nothing():
    x = torch.empty((8, 16), device="meta")
    with roofline.Counter() as c:
        x.view(16, 8)
        x.t()
        x[2:]
        x.unsqueeze(0).expand(3, 8, 16)
    assert c.bytes == 0 and c.flops == {}
    with roofline.Counter() as c:
        y = x + 1
    assert c.bytes == 2 * 8 * 16 * 4 and c.peak == y.untyped_storage().nbytes()
    with roofline.Counter() as c:
        y.add_(1)
        torch.empty((4, 4), device="meta")
    assert c.bytes == 2 * 8 * 16 * 4


def test_peak_follows_storages_alive_at_once():
    x = torch.empty((1024,), device="meta")
    with roofline.Counter() as c:
        a = x * 2
        b = a.view(32, 32)
        del a
        d = b + 1
        del b, d
        e = x * 3
    assert c.peak == 2 * 4096 and c.live == 4096
    del e


# reduced cells: (config, its cut) — dense, MoE, RG-LRU (with a tail), RWKV6
CELLS = (("qwen2-0.5b", {"n_layers": 3}), ("qwen3-moe-30b-a3b", {"n_layers": 3}),
         ("recurrentgemma-9b", {"n_layers": 8}), ("rwkv6-3b", {"n_layers": 3}))
SHAPES = (ShapeConfig("t", 16, 4, "train"), ShapeConfig("p", 16, 2, "prefill"),
          ShapeConfig("d", 16, 2, "decode"))


@pytest.mark.parametrize("arch,cut", CELLS)
@pytest.mark.parametrize("shp", SHAPES, ids=lambda s: s.kind)
def test_segment_identity_equals_the_direct_count(arch, cut, shp):
    cfg = _smoke(arch, **cut)
    micro = 2 if shp.kind == "train" and arch == "qwen2-0.5b" else 1
    direct = segments.count_step(cfg, shp, opt_name="adamw", microbatches=micro).cost()
    segs = segments.cell_cost(cfg, shp, opt_name="adamw", microbatches=micro)
    total = segs["total"]
    assert total.flops_by_type == direct.flops_by_type
    assert total.flops == direct.flops
    assert segs["fused_bytes"] == direct.bytes_hbm
    assert total.bytes_hbm == direct.bytes_hbm + sum(
        segs["mixer_penalties"].get(k, 0.0) * n * micro for k, n in _kind_counts(cfg).items())
    assert ("tail" in segs) == bool(cfg.tail_pattern)


def _kind_counts(cfg):
    out = {}
    for k in list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern):
        out[k] = out.get(k, 0) + 1
    return out


@pytest.mark.parametrize("transport", ["gspmd", "gspmd_classical", "two_step_int8"])
def test_segment_identity_holds_for_collectives(transport):
    cfg = _smoke("olmo-1b", n_layers=3)
    rules = ShardingRules().replicated() if transport == "gspmd_classical" else None
    kw = dict(mesh_shape={"pod": 2, "data": 4}, rules=rules, opt_name="sgd",
              transport=transport.replace("_classical", ""))
    shp = ShapeConfig(*COST_SHAPE)
    direct = segments.count_step(cfg, shp, **kw).cost()
    total = segments.cell_cost(cfg, shp, **kw)["total"]
    assert total.coll == direct.coll and set(direct.coll) == {"pod", "data"}
    assert total.flops_by_type == direct.flops_by_type


def _train_args(cfg, device, opt_name="adamw", B=2, S=16):
    """(params, optimizer state, batch) from seed 0 on the CPU, or their
    like on meta."""
    g = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, g, device="cpu")
    state = make_optimizer(opt_name).init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     dtype=torch.int32),
             "client_weight": torch.ones(B)}
    args = (params, state, batch)
    if device == "meta":
        args = tuple(_tree(a, lambda t: torch.empty_like(t, device="meta")) for a in args)
    return args


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch,cut", CELLS)
def test_cpu_count_equals_meta_count(arch, cut):
    """One train step counted on the CPU (the kernels' plain versions,
    their backwards the plain backwards, none of their operators counted)
    and on meta: the same flops by type, bytes and kernel reports."""
    cfg = _smoke(arch, **cut)
    step = specs.make_train_step(cfg, "adamw")
    counts = []
    for device in ("cpu", "meta"):
        with roofline.Counter() as c:
            step(*_train_args(cfg, device))
        counts.append(c)
    cpu, meta = counts
    assert cpu.flops == meta.flops
    assert cpu.bytes == meta.bytes, roofline_diff(cpu, meta)
    assert cpu.kernels == meta.kernels and cpu.kernels


def roofline_diff(a, b):
    return {k: (a.by_op.get(k), b.by_op.get(k)) for k in set(a.by_op) | set(b.by_op)
            if a.by_op.get(k) != b.by_op.get(k)}


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_counting_leaves_cpu_results_alone(arch):
    """Under a counter the CPU step takes the kernels' plain forwards and
    plain backwards through their autograd Functions: the same step."""
    cfg = _smoke(arch, n_layers=3, dtype="float32")
    step = specs.make_train_step(cfg, "sgd", lr=0.1)
    plain = step(*_train_args(cfg, "cpu", "sgd"))
    with roofline.Counter():
        counted = step(*_train_args(cfg, "cpu", "sgd"))
    for (k, a), (_, b) in zip(_paths(plain[0]), _paths(counted[0])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=k)


# the PERF.md §6 rows: (kernel, cost function at the row's shape, Bound ms)
N_FC1 = 3136 * 2048
BF16 = torch.bfloat16


def _cost_rows():
    import importlib
    ag, kq, fa, rg, rw, ic = (importlib.import_module(f"repro_torch.kernels.{m}") for m in
                              ("agg_reduce", "quantize", "flash_attention", "rglru_scan",
                               "rwkv6_scan", "im2col"))
    return {"agg_reduce": (ag.agg_reduce_cost(128, N_FC1, 16, 4), 1.1043),
            "agg_reduce classical": (ag.agg_reduce_cost(16, N_FC1, 1, 4), 0.1304),
            "agg_reduce_quant": (ag.agg_reduce_quant_cost(128, N_FC1, 16, 4), 1.1350),
            "quantize_intb": (kq.quantize_cost(16, N_FC1, 4), 0.2761),
            "dequantize_int8": (kq.dequantize_cost(16, N_FC1, True), 0.1534),
            "topk_mask": (kq.topk_mask_cost(128, N_FC1, 4, True), 1.9632),
            "flash_attention": (fa.flash_attention_cost(4, 16, 1, 4096, 256, BF16, 2048),
                                0.4170),
            "rglru_scan": (rg.rglru_scan_cost(4, 4096, 4096, True), 0.2404),
            "rwkv6_scan": (rw.rwkv6_scan_cost(4, 48, 4096, 64, 64, BF16), 0.2113),
            "flash backward": (fa.flash_attention_bwd_cost(8, 14, 2, 2048, 64, BF16), 0.1521),
            "rglru_scan backward": (rg.rglru_scan_bwd_cost(8, 2048, 4096, False, False),
                                    0.4007),
            "rwkv6_scan backward": (rw.rwkv6_scan_bwd_cost(8, 48, 2048, 64, 64, BF16),
                                    0.4244),
            "im2col": (ic.im2col_cost(160, 32, 14, 14), 0.0312)}


@pytest.mark.parametrize("row", list(_cost_rows()))
def test_cost_function_gives_the_perf_rows_bound(row):
    work, want = _cost_rows()[row]
    assert round(work.bound()[0], 4) == want


def test_chip_smoke_holds_the_same_rows():
    """phase 19's table is this file's (the script cannot import tests)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    got = {name: (w, ms) for name, w, ms in chip_smoke.cost_rows()}
    want = _cost_rows()
    assert [ms for _, ms in got.values()] == [ms for _, ms in want.values()]
    assert [w for w, _ in got.values()] == [w for w, _ in want.values()]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _wrapper_calls():
    import importlib
    ag, kq, fa, rg, rw, ic = (importlib.import_module(f"repro_torch.kernels.{m}") for m in
                              ("agg_reduce", "quantize", "flash_attention", "rglru_scan",
                               "rwkv6_scan", "im2col"))
    x, wm, r = _meta(6, 40), _meta(6), _meta(3)
    seg = np.array([0, 1, 0, 2, 1, 0])
    q = _meta(2, 2, 24, 16, dtype=BF16)
    kv = _meta(2, 1, 24, 16, dtype=BF16)
    return {
        "segment_agg_reduce": (lambda: ag.segment_agg_reduce(x, wm, seg, 3), (3, 40)),
        "agg_reduce": (lambda: ag.agg_reduce(x, wm, wm), (40,)),
        "segment_agg_reduce_quant": (
            lambda: ag.segment_agg_reduce_quant(x, wm, seg, 3, _meta(3, 40))[0], (3, 40)),
        "quantize_rows": (lambda: kq.quantize_rows(x, _meta(6, 40), wm, 127.0), (6, 40)),
        "dequantize_rows": (lambda: kq.dequantize_rows(_meta(3, 40, dtype=torch.int8), r, r),
                            (3, 40)),
        "topk_mask_rows": (lambda: kq.topk_mask_rows(x, wm), (6, 40)),
        "flash_attention": (lambda: fa.flash_attention(q, kv, kv, window=8), (2, 2, 24, 16)),
        "rglru_scan": (lambda: rg.rglru_scan(_meta(2, 24, 8), _meta(2, 24, 8))[0], (2, 24, 8)),
        "rwkv6_scan": (lambda: rw.rwkv6_scan(q, q, q, _meta(2, 2, 24, 16), _meta(2, 16),
                                             chunk=8)[0], (2, 2, 24, 16)),
        "im2col": (lambda: ic.im2col(_meta(2, 3, 14, 14)), (2, 75, 196)),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_wrapper_takes_meta_only_while_counting(name):
    call, shape = _wrapper_calls()[name]
    with pytest.raises(ValueError, match="cuda or cpu"):
        call()
    with roofline.Counter() as c:
        out = call()
    assert tuple(out.shape) == shape and out.device.type == "meta"
    assert c.kernels and all(k["launches"] >= 1 for k in c.kernels.values())


@pytest.mark.parametrize("kind", ["all_gather", "reduce_scatter", "all_reduce"])
def test_collective_takes_meta_only_while_counting(kind):
    group = axes_group(AbstractMesh({"pod": 2, "data": 4}), ("pod", "data"))
    fn = getattr(agg, kind)
    x = _meta(16)
    with pytest.raises(ValueError, match="meta tensors only"):
        fn(x, group)
    with roofline.Counter() as c:
        out = fn(x, group)
        with pytest.raises(ValueError, match="real tensors only"):
            fn(torch.zeros(16), group)
    assert tuple(out.shape) == {"all_gather": (8, 16), "reduce_scatter": (2,),
                                "all_reduce": (16,)}[kind]
    nbytes = {"all_gather": 8 * 16 * 4, "reduce_scatter": 64, "all_reduce": 64}[kind]
    traffic = roofline.collective_traffic(kind.replace("_", "-"), nbytes, 8)
    assert c.coll == {"pod": traffic / 2, "data": traffic / 2} and c.n_coll == 1
    assert c.collectives().total() == traffic


def test_sfl_moves_fewer_pod_bytes_than_classical(ref):
    """The paper's claim in the port's explicit schedule, reckoned on meta
    over (pod 2, data 4); the reference's GSPMD schedule (which also
    reduces the loss over the batch axes) moves other bytes, printed."""
    cfg = _smoke("olmo-1b")
    shp = ShapeConfig(*COST_SHAPE)
    got = {}
    for mode in ("sfl", "classical"):
        rules = dryrun.rules_for_mesh(("pod", "data"), mode)
        got[mode] = segments.cell_cost(cfg, shp, {"pod": 2, "data": 4}, rules, "sgd")["total"].coll
    print(f"pod bytes, port: sfl {got['sfl']['pod']:,.0f}, classical "
          f"{got['classical']['pod']:,.0f}; reference (GSPMD): sfl "
          f"{ref['cell_cost']['sfl'].get('pod', 0):,.0f}, classical "
          f"{ref['cell_cost']['classical'].get('pod', 0):,.0f}")
    assert got["sfl"]["pod"] < got["classical"]["pod"]
    assert ref["cell_cost"]["sfl"]["pod"] < ref["cell_cost"]["classical"]["pod"]


# ------------------------------------------------------------ the command

REF_KEYS = {"arch", "shape", "mesh", "mode", "opt", "tag", "micro", "transport", "overrides",
            "params", "active_params", "compile_s", "memory", "whole_program", "roofline",
            "per_device", "model_flops_per_dev", "useful_ratio"}


def test_dryrun_card_record(tmp_path):
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh", "card",
                 "--out", str(tmp_path)])
    with open(tmp_path / "qwen2_0_5b__train_4k__card__sfl.json") as f:
        rec = json.load(f)
    assert REF_KEYS <= set(rec)
    assert rec["params"] == 499_540_864
    assert set(rec["memory"]) == {"argument_gb", "output_gb", "temp_gb", "alias_gb"}
    assert {"compute_s", "memory_s", "collective_s", "dominant", "roofline_frac",
            "coll_pod_bytes", "coll_ici_bytes", "peak_mem_gb", "memory_fused_s",
            "dominant_fused", "roofline_frac_fused"} <= set(rec["roofline"])
    cfg = configs.get("qwen2-0.5b")
    model_flops = 6.0 * cfg.active_param_count * 256 * 4096
    assert rec["model_flops_per_dev"] == model_flops
    assert rec["useful_ratio"] == model_flops / rec["per_device"]["flops"]
    # the segments' identity, on the full model
    assert rec["per_device"]["flops"] == rec["whole_program"]["flops_per_dev"]
    assert rec["per_device"]["bytes_fused"] == rec["whole_program"]["bytes_per_dev"]
    assert rec["roofline"]["compute_s"] == pytest.approx(
        rec["per_device"]["flops_by_type"]["bf16"] / hw.PEAK_FLOPS_BF16)


def test_data_parallel_record_reckons_the_pod_hop(tmp_path):
    dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--mesh", "pod=2,data=16",
                 "--set", "n_layers=2", "--no-segments", "--out", str(tmp_path)])
    with open(tmp_path / "olmo_1b__train_4k__pod2_data16__sfl.json") as f:
        rec = json.load(f)
    coll = rec["whole_program"]["coll_bytes_by_axis"]
    assert set(coll) == {"pod", "data"} and coll["pod"] < coll["data"]


@pytest.mark.parametrize("arch,mesh", [("qwen2-0.5b", "single"), ("qwen2-0.5b", "both")])
def test_meshes_the_port_does_not_run_raise_naming_1e(arch, mesh, tmp_path, capsys):
    """The reference's production meshes (tensor and expert parallelism
    over "model"), which the port now runs in full:
    a train cell and a prefill and a decode cell, each cut to 2 layers,
    write records with "model" bytes on each mesh; the decode's KV cache
    (qwen2-0.5b's 2 KV heads do not divide 16: the sequence layout) is
    1 / (clients · model) of the whole cache on a rank. Tensor
    parallelism over another axis still raises."""
    n = 2 if mesh == "both" else 1
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        dryrun.main(["--arch", arch, "--shape", shape_name, "--mesh", mesh, "--set",
                     "n_layers=2", "--no-segments", "--out", str(tmp_path / shape_name)])
        recs = [json.loads(f.read_text()) for f in sorted((tmp_path / shape_name).iterdir())]
        assert len(recs) == n
        for rec in recs:
            coll = rec["whole_program"]["coll_bytes_by_axis"]
            assert coll["model"] > 0 and coll["data"] > 0, (shape_name, rec["mesh"])
            assert ("pod" in coll) == (rec["mesh"] == "multi" and shape_name == "train_4k")
    cfg = dataclasses.replace(configs.get(arch), n_layers=2)
    whole = _kv_bytes(specs.cache_struct_sharded(cfg, shape_by_name("decode_32k")))
    for name in ("single", "multi")[:n]:
        shape = dryrun.parse_mesh(name)[1]
        rules = dryrun.rules_for_mesh(shape)
        clients = shape.get("pod", 1) * shape["data"]
        rank = _kv_bytes(specs.cache_struct_sharded(cfg, shape_by_name("decode_32k"), shape,
                                                    rules))
        assert rank * clients * shape["model"] == whole, name
    with pytest.raises(NotImplementedError, match="over 'model' alone"):
        dryrun._check_mesh({"data": 2, "model": 2}, dryrun.rules_for_mesh(
            {"data": 2, "model": 2}).with_(tensor="data"))


def _kv_bytes(cache):
    return sum(t.numel() * t.element_size() for k, t in _paths(cache)
               if k.endswith(("/k", "/v")))


POD2_DATA2_MODEL2 = {"pod": 2, "data": 2, "model": 2}


def test_dryrun_reduced_recurrentgemma_on_pod2_data2_model2():
    """The reference's ``test_dryrun_small_mesh_subprocess`` on the port's
    abstract (2, 2, 2) mesh: a reduced recurrentgemma-9b train cell (64 ×
    8, adamw) counts positive compute and collective terms, the cross-pod
    hop among its collectives, and the tensor-parallel region's "model"
    bytes."""
    cfg = configs.get_smoke("recurrentgemma_9b")
    shp = ShapeConfig("t", 64, 8, "train")
    rules = dryrun.rules_for_mesh(POD2_DATA2_MODEL2)
    fn, args = specs.input_specs(cfg, shp, POD2_DATA2_MODEL2, rules, "adamw")
    with roofline.Counter() as c:
        fn(*args)
    segs = segments.cell_cost(cfg, shp, POD2_DATA2_MODEL2, rules, "adamw")
    terms = roofline.roofline_terms(segs["total"], POD2_DATA2_MODEL2)
    assert terms["compute_s"] > 0 and terms["collective_s"] > 0
    assert segs["total"].coll.get("pod", 0) > 0
    assert segs["total"].coll.get("model", 0) > 0 and c.coll.get("model", 0) > 0


def test_sfl_moves_fewer_pod_bytes_than_classical_under_tensor_parallelism():
    """The reference's ``test_sfl_vs_classical_cross_pod_traffic`` on the
    port's abstract (2, 2, 2) mesh with ``tensor="model"``: the SFL
    schedule moves fewer cross-pod bytes than the classical flat
    all-reduce for a reduced olmo-1b (64 × 8, sgd), and both run the same
    "model" region."""
    cfg = configs.get_smoke("olmo_1b")
    shp = ShapeConfig("t", 64, 8, "train")
    coll = {mode: segments.cell_cost(cfg, shp, POD2_DATA2_MODEL2,
                                     dryrun.rules_for_mesh(POD2_DATA2_MODEL2, mode),
                                     "sgd")["total"].coll for mode in ("sfl", "classical")}
    assert coll["sfl"]["pod"] < coll["classical"]["pod"]
    assert coll["sfl"]["model"] == coll["classical"]["model"] > 0


def test_moe_cell_is_counted_on_data2(tmp_path):
    """qwen3-moe-30b-a3b's train cell on data=2 (cut to 2 layers) is
    counted: the router's statistics all-reduce over "data" beside the
    FSDP gathers, and the record keeps the whole model's parameter count."""
    dryrun.main(["--arch", "qwen3-moe-30b-a3b", "--shape", "train_4k", "--mesh", "data=2",
                 "--set", "n_layers=2", "--no-segments", "--out", str(tmp_path)])
    with open(tmp_path / "qwen3_moe_30b_a3b__train_4k__data2__sfl.json") as f:
        rec = json.load(f)
    cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b"), n_layers=2)
    assert rec["params"] == sum(t.numel() for t in roofline.tensors(
        specs.param_shardings(cfg, {"data": 2})[0]))
    assert set(rec["whole_program"]["coll_bytes_by_axis"]) == {"data"}
    assert rec["memory"]["argument_gb"] > 0


def test_fsdp_rank_reckons_its_shards_and_the_gathers(monkeypatch):
    """On data=4 under FSDP each rank's arguments hold 1/4 of every sharded
    leaf, parameters and AdamW's moments alike, the replicated leaves whole;
    its "data" collectives all-gather every sharded leaf whole at least
    once a step and reduce-scatter every gradient, the unit's once a unit."""
    cfg = _smoke("qwen2-0.5b")
    shp = ShapeConfig("t", 16, 8, "train")
    _, card_args = specs.input_specs(cfg, shp)
    fn, args = specs.input_specs(cfg, shp, {"data": 4})
    full = dict(_flat_items(card_args[0]))
    layout = specs.make_train_step(cfg, mesh=AbstractMesh({"data": 4})).layout
    places = dict(_flat_items(layout.places))
    held = dict(_flat_items(args[0]))
    sharded = 0
    for k, t in full.items():
        want = t.numel() // (4 if places[k] is not None else 1)
        assert held[k].numel() == want, k
        sharded += t.numel() * t.element_size() if places[k] is not None else 0
        for moment in ("m", "v"):
            assert dict(_flat_items(args[1][moment]))[k].numel() == want, (moment, k)
    assert sharded > 0
    seen = []
    real = kcost.report_collective
    monkeypatch.setattr(kcost, "report_collective",
                        lambda kind, axes, n, size: (seen.append((kind, axes, n)),
                                                     real(kind, axes, n, size)))
    with roofline.Counter() as c:
        fn(*args)
    gathered = sum(n for kind, axes, n in seen if kind == "all-gather" and axes == ("data",))
    scattered = sum(n for kind, axes, n in seen if kind == "reduce-scatter")
    assert gathered >= sharded and scattered >= sharded
    unit = sum(t.numel() * t.element_size() for k, t in full.items()
               if k.startswith("unit/") and places[k] is not None)
    assert scattered >= unit and c.coll["data"] > 0


def _flat_items(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{pre}{k}/")
        else:
            yield pre + k, v


def test_dryrun_allocates_nothing():
    fn, args = specs.input_specs(_smoke("qwen2-0.5b"), ShapeConfig("t", 16, 4, "train"))
    assert all(t.device.type == "meta" for t in roofline.tensors(args))
    with roofline.Counter() as c:
        out = fn(*args)
    assert all(t.device.type == "meta" for t in roofline.tensors(out))
    assert math.isclose(c.total_flops, sum(c.flops.values()))
    assert kcost.counting() is False
