"""Dry run of every (architecture × input-shape × mesh) cell on the H100
cost model — the counterpart of ``repro/launch/dryrun.py``.

For every cell:
  1. build the cell's step and its arguments on ``meta`` (``specs.
     input_specs``): nothing is allocated and nothing runs on a device;
  2. count one step directly (``launch.roofline.Counter``): flops by type,
     bytes, collective bytes by mesh axis, the kernels' reported work, the
     peak of live intermediates;
  3. count the segments (``launch.segments``) and derive the three roofline
     terms with the H100's constants (``launch.hw``).

Records go to ``results/dryrun_torch/<cell>.json`` with the reference's
keys (README.md lists the keys whose meaning differs).

Meshes: ``--mesh card`` (the default) is one H100. ``--mesh pod=2,data=16``
(any ``axis=size`` list over "pod", "data" and "model") runs the step
over an ``AbstractMesh`` as its rank 0, whose collectives report their
bytes: every rank takes the global batch and keeps the rows of its
("pod", "data") coordinate. Under ``--mode sfl`` a train cell is FSDP:
each rank holds its shards of the parameters and the optimizer's state
(``argument_gb`` counts the shards; ``params`` stays the whole model's
count), and the per-unit all-gathers and reduce-scatters are "data"
bytes; ``--transport two_step_int8`` holds the same shards and sends each
rank's block of a gradient across "pod" as int8; ``--mode classical``
holds whole leaves over "data". MoE cells count the router's statistics
all-reduced over the ranks. A "model" axis (``--mesh single|multi|both``:
the reference's 16×16 and 2×16×16 production meshes) runs tensor and
expert parallelism: the rank holds its block of the heads, channels,
experts and vocabulary, and the region's all-reduces and all-gathers are
"model" bytes (``coll_bytes_by_axis["model"]``, in the collective term
at NVLink's rate). Prefill and decode cells serve the rank's rows (all of
them where the batch does not split: ``long_500k``) from its FSDP shards,
gathered a unit at a time, with its block of the KV cache: by KV heads
where they divide "model", else by sequence, whose decode adds the
split-softmax combine's all-reduces and the query's all-gather over
"model".

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh card
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \\
      --mesh pod=2,data=4 --mode classical
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Tuple


def rules_for_mesh(mesh_axes, mode: str = "sfl", fsdp_override=None,
                   expert_override=None):
    """The reference's rules for a mesh of ``mesh_axes`` (its axis names,
    or a ``{axis: size}`` shape)."""
    from repro_torch.common.sharding import ShardingRules
    axes = tuple(mesh_axes)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    fsdp = "data"
    if fsdp_override is not None:
        fsdp = fsdp_override
    rules = ShardingRules(batch=batch, fsdp=fsdp, tensor="model",
                          expert=expert_override or "model")
    if mode == "classical":
        rules = rules.replicated()
    return rules


def runnable_cells(cfg):
    from repro_torch.models.config import ALL_SHAPES
    cells = []
    for shp in ALL_SHAPES:
        if shp.name == "long_500k" and not cfg.is_subquadratic:
            continue  # full-attention archs skip (DESIGN.md §4)
        cells.append(shp)
    return cells


def apply_overrides(cfg, sets):
    import dataclasses as dc
    fsdp_override = None
    expert_override = None
    kw = {}
    for s in sets or []:
        k, v = s.split("=", 1)
        if k == "fsdp":
            fsdp_override = tuple(v.split(",")) if "," in v else (v or None)
            continue
        if k == "expert":
            expert_override = v
            continue
        field = {f.name: f for f in dc.fields(cfg)}.get(k)
        if field is None:
            raise SystemExit(f"unknown config field {k}")
        ftype = type(getattr(cfg, k))
        if ftype is bool:
            kw[k] = v.lower() in ("1", "true", "yes")
        elif ftype is int:
            kw[k] = int(v)
        elif ftype is float:
            kw[k] = float(v)
        else:
            kw[k] = v
    return dc.replace(cfg, **kw), fsdp_override, expert_override


# per-arch gradient-accumulation defaults (bounds the remat-boundary stack
# L×B_micro×S×d; chosen so the per-device microbatch is 1-2 sequences)
MICRO_DEFAULT = {
    "arctic_480b": 8, "qwen3_moe_30b_a3b": 4, "musicgen_large": 4,
    "qwen1_5_110b": 16, "deepseek_coder_33b": 8, "olmo_1b": 1,
    "qwen2_0_5b": 1, "llama3_2_vision_90b": 16, "recurrentgemma_9b": 4,
    "rwkv6_3b": 4,
}

# per-arch optimizer defaults: the giants use sgdm (memory: DESIGN.md §5)
OPT_DEFAULT = {"arctic_480b": "sgdm", "llama3_2_vision_90b": "sgdm",
               "qwen1_5_110b": "adamw"}

# the reference's production meshes: tensor parallel over "model"
PRODUCTION_MESHES = {"single": {"data": 16, "model": 16},
                     "multi": {"pod": 2, "data": 16, "model": 16}}


def parse_mesh(spec: str) -> Tuple[str, Dict[str, int]]:
    """(the mesh's name in cell ids, its shape): "card" -> ("card", {});
    "pod=2,data=16" -> ("pod2_data16", {"pod": 2, "data": 16}); "single" or
    "multi" -> the production mesh."""
    if spec == "card":
        return "card", {}
    if spec in PRODUCTION_MESHES:
        return spec, dict(PRODUCTION_MESHES[spec])
    shape = {}
    for part in spec.split(","):
        axis, _, n = part.partition("=")
        if axis not in ("pod", "data", "model") or not n.isdigit() or int(n) < 1:
            raise SystemExit(f"bad mesh {spec!r}: want card, single, multi, both or "
                             "axis=size,... over pod, data, model")
        shape[axis] = int(n)
    return "_".join(f"{a}{n}" for a, n in shape.items()), shape


def _check_mesh(shape: Dict[str, int], rules) -> None:
    """Raise before counting for what the port does not run: tensor or
    expert parallelism over an axis other than "model"."""
    from repro_torch.common.sharding import reduce_schedule
    if math.prod(shape.values()) > 1:
        reduce_schedule(rules, shape)


def _gb(n: float) -> float:
    return n / 1e9


def run_cell(arch: str, shape_name: str, mesh_spec: str, mode: str, opt_name: str, sets,
             tag: str, out_dir: str, skip_existing: bool = False, segments: bool = True,
             microbatches: int = 0, transport: str = "gspmd"):
    from repro_torch import configs
    from repro_torch.launch import hw, roofline
    from repro_torch.launch import specs as S
    from repro_torch.models.config import shape_by_name

    mesh_name, shape = parse_mesh(mesh_spec)
    cell_id = f"{configs.canonical(arch)}__{shape_name}__{mesh_name}__{mode}"
    if tag:
        cell_id += f"__{tag}"
    out_path = os.path.join(out_dir, cell_id + ".json")
    if skip_existing and os.path.exists(out_path):
        print(f"[skip] {cell_id}")
        with open(out_path) as f:
            return json.load(f)

    cfg = configs.get(arch)
    cfg, fsdp_o, exp_o = apply_overrides(cfg, sets)
    shp = shape_by_name(shape_name)
    rules = rules_for_mesh(shape, mode, fsdp_o, exp_o)
    if transport == "two_step_int8":
        rules = rules.with_(table={"vocab_rows": None})
    _check_mesh(shape, rules)
    micro = microbatches or MICRO_DEFAULT.get(configs.canonical(arch), 1)
    if shp.kind != "train":
        micro = 1

    rec = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
           "mesh_shape": shape, "mode": mode, "opt": opt_name, "tag": tag, "micro": micro,
           "transport": transport, "overrides": list(sets or []),
           "active_params": cfg.active_param_count}
    t0 = time.time()
    fn, args = S.input_specs(cfg, shp, shape, rules, opt_name, micro, transport)
    # the whole model's count (a rank's arguments may hold FSDP shards)
    rec["params"] = sum(t.numel() for t in roofline.tensors(S.param_shardings(cfg, shape,
                                                                                rules)[0]))
    with roofline.Counter() as c:
        out = fn(*args)
    rec["compile_s"] = round(time.time() - t0, 2)
    arg_bytes = roofline.tree_bytes(args)
    arg_keys = {roofline.storage_key(t) for t in roofline.tensors(args)}
    outs = roofline.tensors(out)
    out_bytes = roofline.tree_bytes([t for t in outs if roofline.storage_key(t) not in arg_keys])
    alias_bytes = roofline.tree_bytes([t for t in outs if roofline.storage_key(t) in arg_keys])
    rec["memory"] = {
        "argument_gb": _gb(arg_bytes),
        "output_gb": _gb(out_bytes),
        "temp_gb": _gb(max(0, c.peak - out_bytes)),
        "alias_gb": _gb(alias_bytes),
    }
    rec["whole_program"] = {
        "flops_per_dev": c.total_flops,
        "flops_by_type": dict(c.flops),
        "bytes_per_dev": float(c.bytes),
        "coll_bytes_by_axis": dict(c.coll),
        "kernels": c.kernels,
        "note": "one step counted directly (eager: every unit runs); roofline uses segments",
    }
    del out
    print(f"[ok] {cell_id}: count {rec['compile_s']}s  "
          f"args {rec['memory']['argument_gb']:.2f} GB/dev  "
          f"temp {rec['memory']['temp_gb']:.2f} GB/dev")

    if segments:
        from repro_torch.launch.segments import cell_cost
        t1 = time.time()
        segs = cell_cost(cfg, shp, shape, rules, opt_name, microbatches=micro,
                         transport=transport)
        total = segs["total"]
        rec["roofline"] = roofline.roofline_terms(total, shape)
        rec["roofline"]["segment_compile_s"] = round(time.time() - t1, 2)
        mem_fused_s = segs["fused_bytes"] / hw.HBM_BW
        rec["roofline"]["memory_fused_s"] = mem_fused_s
        r = rec["roofline"]
        terms = {"compute": r["compute_s"], "memory": mem_fused_s,
                 "collective": r["collective_s"]}
        r["dominant_fused"] = max(terms, key=terms.get)
        bound = max(terms.values())
        r["roofline_frac_fused"] = r["compute_s"] / bound if bound else 0.0
        rec["per_device"] = {
            "flops": total.flops, "flops_by_type": total.flops_by_type,
            "bytes": total.bytes_hbm, "bytes_fused": segs["fused_bytes"],
            "coll_bytes_by_axis": total.coll,
            "mixer_penalties": segs["mixer_penalties"],
        }
        # MODEL_FLOPS = 6·N_active·D tokens (fwd+bwd) per device
        n_dev = math.prod(shape.values()) if shape else 1
        tokens = shp.global_batch * (1 if shp.kind == "decode" else shp.seq_len)
        mult = 6.0 if shp.kind == "train" else 2.0
        model_flops = mult * cfg.active_param_count * tokens / n_dev
        rec["model_flops_per_dev"] = model_flops
        rec["useful_ratio"] = model_flops / total.flops if total.flops else 0.0
        print(f"     roofline: compute {r['compute_s']*1e3:.2f} ms | "
              f"memory {r['memory_s']*1e3:.2f} ms "
              f"(fused {r['memory_fused_s']*1e3:.2f}) | "
              f"collective {r['collective_s']*1e3:.2f} ms | "
              f"dominant {r['dominant_fused']} | useful {rec['useful_ratio']:.2f} | "
              f"frac {r['roofline_frac_fused']:.3f}")

    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card",
                    help="card (one H100), axis=size,... over pod, data and model, or the "
                         "reference's single|multi|both (16x16, 2x16x16: tensor parallel "
                         "over model)")
    ap.add_argument("--mode", default="sfl", choices=["sfl", "classical"])
    ap.add_argument("--opt", default=None, help="sgd|sgdm|adamw (per-arch default)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    metavar="key=value")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-segments", action="store_true")
    ap.add_argument("--micro", type=int, default=0,
                    help="gradient-accumulation microbatches (0 = per-arch default)")
    ap.add_argument("--transport", default="gspmd",
                    choices=["gspmd", "two_step_int8"],
                    help="gradient transport (two_step_int8 = explicit SFL "
                         "schedule with compressed cross-pod hop)")
    args = ap.parse_args(argv)

    from repro_torch import configs

    arch_list = [a for a in configs.ARCH_IDS if a != "femnist_cnn"]
    if args.list:
        for a in arch_list:
            cfg = configs.get(a)
            cells = [s.name for s in runnable_cells(cfg)]
            print(f"{a:24s} {cells}")
        return

    targets = arch_list if (args.all or args.arch is None) else [args.arch]
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    failures = []
    t0 = time.time()
    for arch in targets:
        cfg = configs.get(arch)
        shapes = ([args.shape] if args.shape
                  else [s.name for s in runnable_cells(cfg)])
        for shape_name in shapes:
            for mesh in meshes:
                opt = args.opt or OPT_DEFAULT.get(configs.canonical(arch), "adamw")
                try:
                    run_cell(arch, shape_name, mesh, args.mode, opt, args.sets,
                             args.tag, args.out, args.skip_existing,
                             segments=not args.no_segments,
                             microbatches=args.micro,
                             transport=args.transport)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape_name, mesh, repr(e)))
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall requested cells counted OK in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
