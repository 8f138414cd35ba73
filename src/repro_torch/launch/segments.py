"""Segment counts of a cell — the counterpart of ``repro/launch/segments.py``.

    cost(cell) = C(model1) + (n_units − 1)·C(unit) + C(tail)

The reference lowers each segment apart because XLA's ``cost_analysis``
counts a scanned layer body once. The port counts eager PyTorch, which
runs every unit, so a whole step can be counted directly
(``launch.dryrun``'s ``whole_program``); the segments remain, counted on
``meta`` by ``launch.roofline.Counter`` through the cell's own step
(``specs.input_specs``), and their identity is exact:

* ``model1``: the full step of a one-unit model without its tail (embed,
  one unit, head, loss, gradients, collectives, optimizer);
* ``unit``: C(a two-unit model) − C(model1), all a unit adds to a step;
* ``tail``: C(model1 with the tail) − C(model1).

A step's count is affine in the number of units (the forward takes each
unit's parameters by one ``unbind`` a leaf, ``transformer._units``), so
the sum equals the direct count of the whole model, flops by type, bytes
and collective bytes alike (``tests/test_torch_dryrun.py``).

``mixer_fusion_penalty`` keeps the reference's meaning: per mixer kind,
the bytes the plain version (``kernels.*_plain``, counted op by op on
``meta``, with autograd's backward for a train cell) moves beyond the
kernel's reckoned I/O — what the kernel keeps on chip.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, Optional

import torch

from repro_torch.common.sharding import ShardingRules, pad_to_multiple
from repro_torch.launch import specs as S
from repro_torch.launch.roofline import Counter, SegmentCost
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.rwkv6 import rwkv_heads

# the kernel modules (``repro_torch.kernels`` exports functions of their names)
fa, rg, rw = (importlib.import_module(f"repro_torch.kernels.{m}")
              for m in ("flash_attention", "rglru_scan", "rwkv6_scan"))


def _acc(cfg: ModelConfig, pattern=None, n_layers=None) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        block_pattern=tuple(pattern or cfg.block_pattern),
        n_layers=int(n_layers if n_layers is not None else len(pattern or cfg.block_pattern)),
        scan_layers=False,
        attn_accounting=True,
    )


def count_step(cfg: ModelConfig, shp: ShapeConfig, mesh_shape=None,
               rules: Optional[ShardingRules] = None, opt_name: str = "adamw",
               microbatches: int = 1, transport: str = "gspmd") -> Counter:
    """The Counter of one step of the cell on ``meta``."""
    fn, args = S.input_specs(cfg, shp, mesh_shape, rules, opt_name, microbatches, transport)
    with Counter() as c:
        fn(*args)
    return c


def lower_model1_segment(cfg: ModelConfig, shp: ShapeConfig, mesh_shape=None,
                         rules: Optional[ShardingRules] = None, opt_name: str = "adamw",
                         microbatches: int = 1, transport: str = "gspmd") -> SegmentCost:
    """The full step of a one-unit model without its tail."""
    return count_step(_acc(cfg), shp, mesh_shape, rules, opt_name, microbatches,
                      transport).cost()


def lower_unit_segment(cfg: ModelConfig, shp: ShapeConfig, mesh_shape=None,
                       rules: Optional[ShardingRules] = None, opt_name: str = "adamw",
                       microbatches: int = 1, transport: str = "gspmd",
                       pattern=None) -> SegmentCost:
    """What one more unit adds to a step (``pattern=None``), or what the
    tail adds to model1 (``pattern=cfg.tail_pattern``)."""
    P = len(cfg.block_pattern)
    more = 2 * P if pattern is None else P + len(pattern)
    kw = dict(mesh_shape=mesh_shape, rules=rules, opt_name=opt_name,
              microbatches=microbatches, transport=transport)
    bigger = count_step(_acc(cfg, cfg.block_pattern, more), shp, **kw).cost()
    return bigger.minus(lower_model1_segment(cfg, shp, **kw))


def _plain_bytes(fn, args, train: bool) -> float:
    """Bytes the plain version moves on ``meta``, with autograd's backward
    when ``train``."""
    with Counter() as c:
        if train:
            args = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
            out = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            torch.autograd.grad(outs, [a for a in args if a.requires_grad],
                                [torch.empty_like(o) for o in outs])
        else:
            with torch.no_grad():
                fn(*args)
    return c.bytes


def _rank0_heads(cfg: ModelConfig, tp: int):
    """(query heads, KV heads) the flash kernel sees on rank 0 of a "model"
    axis of ``tp``: its real heads of the padded block, their KV heads in
    whole groups, else one a query head (expanded by the global map)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hp = pad_to_multiple(H, tp) if cfg.tp_pad_heads else H
    if Hp % tp:
        return H, KV if H % KV == 0 else H
    n = min(H, Hp // tp)
    g = H // KV if H % KV == 0 else 0
    return n, (n // g if g and n % g == 0 else n)


def mixer_fusion_penalty(cfg: ModelConfig, shp: ShapeConfig, mesh_shape=None,
                         rows: int = 0) -> Dict[str, float]:
    """Per mixer kind, the bytes its plain version moves beyond the
    kernel's reckoned I/O at the cell's shapes (forward, and backward for a
    train cell): the intermediates the kernel keeps on chip. A decode
    step's mixers have no such intermediates ({})."""
    if shp.kind == "decode":
        return {}
    train = shp.kind == "train"
    B, Sq = rows or shp.global_batch, shp.seq_len
    mk = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    kinds = set(cfg.block_pattern) | set(cfg.tail_pattern)
    tp = dict(mesh_shape or {}).get("model", 1)
    out: Dict[str, float] = {}

    def penalty(plain, args, fwd, bwd):
        ideal = fwd.nbytes + (bwd.nbytes if train else 0.0)
        return max(0.0, _plain_bytes(plain, args, train) - ideal)

    if "attn" in kinds and cfg.n_heads:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if tp > 1:
            # rank 0's block of the padded heads (layers.causal_attention)
            H, KV = _rank0_heads(cfg, tp)
        elif H % KV:
            KV = H
        args = (mk(B, H, Sq, hd), mk(B, KV, Sq, hd), mk(B, KV, Sq, hd))
        out["attn"] = penalty(
            lambda q, k, v: fa.flash_attention_plain(q, k, v, window=cfg.window,
                                                     softcap=cfg.logit_softcap),
            args, fa.flash_attention_cost(B, H, KV, Sq, hd, torch.bfloat16, cfg.window,
                                          with_lse=train),
            fa.flash_attention_bwd_cost(B, H, KV, Sq, hd, torch.bfloat16, cfg.window))
    if "rwkv" in kinds:
        # over "model": rank 0's block of the heads the model pads to 16
        Hp = rwkv_heads(cfg, tp)[1] if tp <= 1 else rwkv_heads(cfg)[1] // tp
        hd, W = cfg.rwkv_head_dim, min(cfg.rwkv_chunk, Sq)
        args = (mk(B, Hp, Sq, hd), mk(B, Hp, Sq, hd), mk(B, Hp, Sq, hd),
                mk(B, Hp, Sq, hd, dt=torch.float32), mk(Hp, hd, dt=torch.float32))
        out["rwkv"] = penalty(
            lambda r, k, v, lw, u: rw.rwkv6_scan_plain(r, k, v, lw, u, chunk=W), args,
            rw.rwkv6_scan_cost(B, Hp, Sq, hd, W, torch.bfloat16, chunk_states=train),
            rw.rwkv6_scan_bwd_cost(B, Hp, Sq, hd, W, torch.bfloat16, with_ds_final=True))
    if "rglru" in kinds:
        C = cfg.rnn_width
        C //= tp if C % tp == 0 else 1
        args = (mk(B, Sq, C, dt=torch.float32), mk(B, Sq, C, dt=torch.float32))
        out["rglru"] = penalty(
            lambda a, b: rg.rglru_scan_plain(a, b), args,
            rg.rglru_scan_cost(B, Sq, C, with_h0=False),
            rg.rglru_scan_bwd_cost(B, Sq, C, with_h0=False, with_dh_last=True))
    return out


def cell_cost(cfg: ModelConfig, shp: ShapeConfig, mesh_shape=None,
              rules: Optional[ShardingRules] = None, opt_name: str = "adamw",
              microbatches: int = 1, transport: str = "gspmd") -> Dict[str, object]:
    """All segments for one cell, combined per the identity; the
    reference's keys: unit, model1, (tail,) total, fused_bytes (the
    counted bytes: the kernels' own I/O), mixer_penalties. ``total``'s
    bytes add the plain versions' extra bytes of every mixer layer (the
    reference's unfused "bytes accessed")."""
    kw = dict(mesh_shape=mesh_shape, rules=rules, opt_name=opt_name,
              microbatches=microbatches, transport=transport)
    c_model1 = lower_model1_segment(cfg, shp, **kw)
    c_unit = lower_unit_segment(cfg, shp, **kw)
    c_tail = (lower_unit_segment(cfg, shp, pattern=cfg.tail_pattern, **kw)
              if cfg.tail_pattern else None)
    total = c_model1 + c_unit.scaled(cfg.n_units - 1)
    if c_tail is not None:
        total = total + c_tail
    # the rows a rank's mixers see at once (every row where they do not split)
    clients = math.prod(dict(mesh_shape or {}).get(a, 1) for a in ("pod", "data"))
    rows = shp.global_batch // clients if shp.global_batch % clients == 0 else shp.global_batch
    if shp.kind == "train":
        rows //= microbatches
    penalties = mixer_fusion_penalty(cfg, shp, mesh_shape, rows)
    kind_counts: Dict[str, int] = {}
    for k in list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern):
        kind_counts[k] = kind_counts.get(k, 0) + 1
    penalty_total = sum(penalties.get(k, 0.0) * n for k, n in kind_counts.items())
    if microbatches > 1 and shp.kind == "train":
        penalty_total *= microbatches
    fused_bytes = total.bytes_hbm
    total = dataclasses.replace(total, bytes_hbm=total.bytes_hbm + penalty_total)
    out = {"unit": c_unit, "model1": c_model1, "total": total,
           "fused_bytes": fused_bytes, "mixer_penalties": penalties}
    if c_tail is not None:
        out["tail"] = c_tail
    return out

