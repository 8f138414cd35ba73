"""Decoder assembly for the ported language models — port of
``repro/models/transformer.py``: init, forward, training's ``loss_fn``
and serving (prefill + decode) for every sublayer kind of the reference:

  * ``attn``  — self-attention (GQA/MQA, optional sliding window, optional
                QKV bias) + MLP or MoE (optionally with arctic's parallel
                dense residual MLP)
  * ``cross`` — cross-attention to stub media embeddings (VLM) + MLP
  * ``rglru`` — Griffin recurrent block + MLP
  * ``rwkv``  — RWKV6 time-mix + channel-mix

and its three frontends: tokens, precomputed frames (``frame_proj``, the
labels from the batch) and tokens with precomputed patches
(``patch_proj``, the media every ``cross`` sublayer attends to; decode
re-projects ``batch["media"]`` every step).

A model is a repeating unit of sublayers (``cfg.block_pattern``) applied
``cfg.n_units`` times, then a short tail. Parameters and caches keep the
reference's nested-dict layout, unit leaves stacked ``(n_units, …)``; a
Python loop over the units replaces ``lax.scan``. The reference's
sharding rules have no single-card counterpart and are left out of every
signature. Under grad, ``remat="full"`` recomputes each unit in the
backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does, and ``remat="dots"`` keeps only the outputs of
the matmuls with no batch dimension (selective checkpointing), as its
``checkpoint_dots_with_no_batch_dims`` policy does.

The cache is mutable: ``decode_step`` writes the new token's K/V into the
rings and the new recurrent states into the stacked buffers in place, and
returns the same dict. Each attention cache's ``pos`` is an int32 tensor
on the host (``(n_units,)`` for the unit, 0-d for the tail), read once per
step. Where the prompt outruns a sliding window, ``prefill`` keeps the
last ``window`` K/V rows so that position p sits in ring slot p % window,
the layout ``_decode_attention`` reads; the reference keeps them in
positional order, which agrees only when P % window == 0 (ROADMAP.md
Queue 3).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as device_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as W
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamBuilder

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _sublayer_params(pb: ParamBuilder, cfg: ModelConfig, kind: str, tp: int):
    if kind in ("attn", "cross"):
        L.norm_params(pb, "norm1", cfg.d_model, cfg.norm)
        L.attn_params(pb, cfg, tp)
        L.norm_params(pb, "norm2", cfg.d_model, cfg.norm)
        if cfg.n_experts:
            M.moe_params(pb, cfg)
            if cfg.dense_residual:
                L.mlp_params(pb, cfg)
        else:
            L.mlp_params(pb, cfg)
    elif kind == "rglru":
        L.norm_params(pb, "norm1", cfg.d_model, cfg.norm)
        R.rglru_params(pb, cfg)
        L.norm_params(pb, "norm2", cfg.d_model, cfg.norm)
        L.mlp_params(pb, cfg)
    elif kind == "rwkv":
        L.norm_params(pb, "norm1", cfg.d_model, cfg.norm)
        W.rwkv_time_params(pb, cfg)
        L.norm_params(pb, "norm2", cfg.d_model, cfg.norm)
        W.rwkv_channel_params(pb, cfg)
    else:
        raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: str | torch.device = "cuda", tp: int = 16) -> Dict[str, Any]:
    """Random parameters in the reference's layout, made on ``device`` leaf
    by leaf from ``generator`` (one on that device, seed 0 by default).

    The unit's leaves are drawn stacked ``(n_units, …)`` the way the
    reference re-draws them (see ``ParamBuilder``). The reference seeds
    that re-draw from ``hash(cfg.name)``, which Python randomises per
    process, so no port can repeat its numbers: the tests carry JAX's
    parameters across with ``repro_torch.bridge`` instead.
    """
    dev = device_mod.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _build_params(cfg, generator, dev, tp)


def _build_params(cfg: ModelConfig, generator, dev: torch.device, tp: int = 16):
    """``init_params`` on any device (``meta`` gives the shapes alone)."""
    pb = ParamBuilder(generator, _dtype(cfg), dev)
    V, d = cfg.vocab_size, cfg.d_model
    pb.param("embed", (V, d), scale=1.0)
    if cfg.frontend == "frames":
        pb.param("frame_proj", (d, d))
    if cfg.frontend == "patches":
        pb.param("patch_proj", (d, d))
    unit = ParamBuilder(generator, _dtype(cfg), dev, stack=cfg.n_units)
    pb.params["unit"] = unit.params
    for i, kind in enumerate(cfg.block_pattern):
        _sublayer_params(unit.sub(f"{i}_{kind}"), cfg, kind, tp)
    tail = pb.sub("tail")
    for i, kind in enumerate(cfg.tail_pattern):
        _sublayer_params(tail.sub(f"{i}_{kind}"), cfg, kind, tp)
    L.norm_params(pb, "final_norm", d, cfg.norm)
    if not cfg.tie_embeddings:
        pb.param("lm_head", (d, V))
    return pb.build()


def _index(tree, i: int):
    """Unit ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# sublayer application
# ---------------------------------------------------------------------------

def _apply_sublayer(x, p, cfg: ModelConfig, kind: str, positions, cache=None, media=None):
    """Returns (x, new_cache, aux). With cache=None an attention sublayer
    hands back its (k, v) for prefill's cache; a ``cross`` sublayer keeps
    its cache as it is. ``aux`` is the MoE router's load-balance loss (0.0
    without experts)."""
    aux = 0.0
    if kind in ("attn", "cross"):
        h = L.norm(x, p["norm1"], cfg.norm)
        if kind == "attn":
            a, new_cache = L.self_attention(h, p["attn"], cfg, positions, window=cfg.window,
                                            cache=cache)
        else:
            a, new_cache = L.cross_attention(h, p["attn"], cfg, media), cache
        x = x + a
        h = L.norm(x, p["norm2"], cfg.norm)
        if cfg.n_experts:
            mo, aux = M.moe_block(h, p["moe"], cfg)
            if cfg.dense_residual:
                mo = mo + L.mlp_block(h, p["mlp"], cfg)
        else:
            mo = L.mlp_block(h, p["mlp"], cfg)
        x = x + mo
    elif kind == "rglru":
        h = L.norm(x, p["norm1"], cfg.norm)
        a, new_cache = R.rglru_block(h, p["rglru"], cfg, state=cache)
        x = x + a
        h = L.norm(x, p["norm2"], cfg.norm)
        x = x + L.mlp_block(h, p["mlp"], cfg)
    elif kind == "rwkv":
        h = L.norm(x, p["norm1"], cfg.norm)
        a, tstate = W.rwkv_time_mix(h, p["time"], cfg,
                                    state=None if cache is None else cache["time"])
        x = x + a
        h = L.norm(x, p["norm2"], cfg.norm)
        c, cstate = W.rwkv_channel_mix(h, p["channel"], cfg,
                                       state=None if cache is None else cache["channel"])
        x = x + c
        new_cache = {"time": tstate, "channel": cstate}
    else:
        raise ValueError(kind)
    return x, new_cache, aux


def _apply_unit(x, unit_p, cfg: ModelConfig, positions, unit_cache=None, media=None):
    new_cache = {}
    aux_total = 0.0
    for i, kind in enumerate(cfg.block_pattern):
        key = f"{i}_{kind}"
        c = None if unit_cache is None else unit_cache.get(key)
        x, nc, aux = _apply_sublayer(x, unit_p[key], cfg, kind, positions, cache=c,
                                     media=media)
        new_cache[key] = nc
        aux_total = aux_total + aux
    return x, new_cache, aux_total


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed_tokens(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens].to(_dtype(cfg))
    # the reference multiplies by a weakly typed Python float: the factor is
    # rounded to the activation type first
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def _project(params, name: str, emb, cfg: ModelConfig):
    """Precomputed frame or patch embeddings through ``frame_proj`` /
    ``patch_proj``, in the model's type."""
    return torch.einsum("bsd,de->bse", emb.to(_dtype(cfg)), params[name])


def embed_inputs(params, batch: Dict[str, Any], cfg: ModelConfig):
    """Returns (x (B, S, d), media (B, T, d) or None, labels (B, S),
    positions (B, S)). Frames bring their labels; tokens are their own,
    shifted by one."""
    media = None
    if cfg.frontend == "frames":
        # musicgen: precomputed EnCodec frame embeddings (stub frontend)
        x = _project(params, "frame_proj", batch["frames"], cfg)
        labels = batch["labels"]
    else:
        tokens = batch["tokens"]
        x = _embed_tokens(params, tokens, cfg)
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        if cfg.frontend == "patches":
            media = _project(params, "patch_proj", batch["patches"], cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return x, media, labels, positions


def unembed(params, x, cfg: ModelConfig):
    x = L.norm(x, params["final_norm"], cfg.norm)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

_aten = torch.ops.aten


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy, the reference's
    ``checkpoint_dots_with_no_batch_dims``: keep the outputs of the matmuls
    with no batch dimension (``mm``, ``addmm``, and the batch-1 ``bmm`` an
    einsum such as "bsd,dhk->bshk" lowers to: the projections), recompute
    the rest (attention's batched products, flash, the scans, elementwise
    work)."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _unit_step(cfg: ModelConfig, positions, media=None):
    """One unit as the forward applies it. Under grad, ``remat="full"``
    recomputes its activations in the backward instead of keeping them (the
    reference's ``nothing_saveable`` policy) and ``remat="dots"`` keeps the
    outputs of its matmuls with no batch dimension (:func:`_save_dots`).
    The unit draws no random numbers, so no RNG state is saved for the
    recompute."""
    def step(x, unit_p):
        return _apply_unit(x, unit_p, cfg, positions, media=media)[::2]
    if cfg.remat not in ("full", "dots") or not torch.is_grad_enabled():
        return step
    kw = ({"context_fn": lambda: create_selective_checkpoint_contexts(_save_dots)}
          if cfg.remat == "dots" else {})
    return lambda x, unit_p: checkpoint(step, x, unit_p, use_reentrant=False,
                                        preserve_rng_state=False, **kw)


def forward(params, batch, cfg: ModelConfig):
    """Full forward: returns (pre-head activations, labels, aux)."""
    x, media, labels, positions = embed_inputs(params, batch, cfg)
    step = _unit_step(cfg, positions, media)
    aux_total = 0.0
    for i in range(cfg.n_units):
        x, aux = step(x, _index(params["unit"], i))
        aux_total = aux_total + aux
    for i, kind in enumerate(cfg.tail_pattern):
        x, _, aux = _apply_sublayer(x, params["tail"][f"{i}_{kind}"], cfg, kind, positions,
                                    media=media)
        aux_total = aux_total + aux
    return x, labels, aux_total


def _xent(logits, labels, mask):
    """Token-mean cross entropy pieces in f32: (Σ nll·mask, Σ mask). The
    gold logit is gathered (the reference sums a one-hot mask over the
    vocab for its sharding: the same value); the max is held out of the
    gradient, as the reference's ``stop_gradient``."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def loss_chunks(cfg: ModelConfig, S: int) -> int:
    """The sequence chunks the head and the loss run in: the largest count
    up to ``cfg.loss_chunks`` that divides S."""
    nc = max(1, min(cfg.loss_chunks, S))
    while S % nc:
        nc -= 1
    return nc


def chunked_xent(params, x, labels, mask, cfg: ModelConfig):
    """(Σ nll·mask, Σ mask) over the sequence in ``loss_chunks`` pieces, so
    the (B, S, vocab) logits never exist whole."""
    S = x.shape[1]
    nc = loss_chunks(cfg, S)
    tot = cnt = 0.0
    for i in range(nc):
        sl = slice(i * (S // nc), (i + 1) * (S // nc))
        t, c = _xent(unembed(params, x[:, sl], cfg), labels[:, sl], mask[:, sl])
        tot, cnt = tot + t, cnt + c
    return tot, cnt


def loss_mask(cfg: ModelConfig, B: int, S: int, device) -> torch.Tensor:
    """Ones, but the last position (its shifted label is void)."""
    mask = torch.ones((B, S), dtype=torch.float32, device=device)
    if cfg.frontend != "frames":
        mask[:, -1] = 0.0
    return mask


def aux_loss(cfg: ModelConfig, aux):
    """The MoE load-balance term added to the loss: 0.01 · aux / n_layers
    (0.0 without experts)."""
    return 0.01 * aux / max(1, cfg.n_layers) if cfg.n_experts else 0.0


def loss_fn(params, batch, cfg: ModelConfig):
    """Scalar mean loss (+ metrics dict), the head applied in sequence
    chunks; with experts, plus the router's load-balance term."""
    x, labels, aux = forward(params, batch, cfg)
    B, S, _ = x.shape
    mask = batch.get("loss_mask")
    if mask is None:
        mask = loss_mask(cfg, B, S, x.device)
    tot, cnt = chunked_xent(params, x, labels, mask, cfg)
    xent = tot / torch.clamp(cnt, min=1.0)
    return xent + aux_loss(cfg, aux), {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# serve: prefill + decode
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, cache_len: int) -> int:
    return min(cache_len, cfg.window) if cfg.window else cache_len


def _cache_struct(cfg: ModelConfig, kind: str, batch: int, cache_len: int, dtype, device):
    if kind == "attn":
        kv = (batch, _cache_len(cfg, cache_len), cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device),
                "pos": torch.zeros((), dtype=torch.int32)}
    if kind == "rglru":
        return R.rglru_init_state(cfg, batch, dtype, device)
    if kind == "rwkv":
        return W.rwkv_init_state(cfg, batch, dtype, device)
    if kind == "cross":
        # the media comes with every step (batch["media"]): no per-layer K/V
        return {"pos": torch.zeros((), dtype=torch.int32)}
    raise ValueError(kind)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: str | torch.device = "cuda"):
    """Cache tree: per unit sublayer stacked over n_units, plus the tail."""
    dtype = _dtype(cfg)
    unit = {f"{i}_{kind}": _stack([_cache_struct(cfg, kind, batch, cache_len, dtype, device)
                                   for _ in range(cfg.n_units)])
            for i, kind in enumerate(cfg.block_pattern)}
    tail = {f"{i}_{kind}": _cache_struct(cfg, kind, batch, cache_len, dtype, device)
            for i, kind in enumerate(cfg.tail_pattern)}
    return {"unit": unit, "tail": tail}


def _attn_prefill_cache(cfg: ModelConfig, kv, S: int, batch: int, cache_len: int):
    """Prefill's (k, v) of one attention layer -> its decode cache. Past the
    window, the last ``clen`` rows are rolled so position p is in slot p % clen."""
    k, v = kv
    clen = _cache_len(cfg, cache_len)
    if clen < S:
        k = torch.roll(k[:, S - clen:], shifts=S % clen, dims=1)
        v = torch.roll(v[:, S - clen:], shifts=S % clen, dims=1)
    else:
        buf = _cache_struct(cfg, "attn", batch, cache_len, k.dtype, k.device)
        buf["k"][:, :S], buf["v"][:, :S] = k, v
        k, v = buf["k"], buf["v"]
    return {"k": k, "v": v, "pos": torch.tensor(S, dtype=torch.int32)}


def prefill(params, batch, cfg: ModelConfig, cache_len: int):
    """Process a full prompt: returns (last-position logits (B, V), cache)."""
    x, media, _, positions = embed_inputs(params, batch, cfg)
    B, S = positions.shape

    def run(x, p, kind):
        x, nc, _ = _apply_sublayer(x, p, cfg, kind, positions, media=media)
        if kind == "attn":
            nc = _attn_prefill_cache(cfg, nc, S, B, cache_len)
        elif kind == "cross":
            nc = {"pos": torch.tensor(S, dtype=torch.int32)}
        return x, nc

    units = []
    for i in range(cfg.n_units):
        unit_p, nc = _index(params["unit"], i), {}
        for j, kind in enumerate(cfg.block_pattern):
            x, nc[f"{j}_{kind}"] = run(x, unit_p[f"{j}_{kind}"], kind)
        units.append(nc)
    tail = {}
    for j, kind in enumerate(cfg.tail_pattern):
        x, tail[f"{j}_{kind}"] = run(x, params["tail"][f"{j}_{kind}"], kind)
    logits = unembed(params, x[:, -1:], cfg)[:, -1]
    return logits, {"unit": _stack(units) if units else {}, "tail": tail}


def _write_back(dst, src):
    """Store a sublayer's new cache into ``dst`` (views into the stacked
    buffers, or the tail's own dict) in place."""
    for k, new in src.items():
        if isinstance(new, dict):
            _write_back(dst[k], new)
        elif isinstance(new, int):
            dst[k].fill_(new)
        elif new.data_ptr() != dst[k].data_ptr():
            dst[k].copy_(new)


def decode_step(params, batch, cache, cfg: ModelConfig):
    """One-position decode: batch = {'tokens': (B, 1)} or {'frames': (B, 1,
    d)}, with 'pos' (B, 1) and, for the patch frontend, 'media' (B, T, d),
    projected through ``patch_proj`` again at every step.

    Returns (logits (B, V), cache), the cache updated in place."""
    if cfg.frontend == "frames":
        x = _project(params, "frame_proj", batch["frames"], cfg)
    else:
        x = _embed_tokens(params, batch["tokens"], cfg)
    pos = batch["pos"]
    media = batch.get("media")
    if media is not None:
        media = _project(params, "patch_proj", media, cfg)
    for i in range(cfg.n_units):
        unit_c = _index(cache["unit"], i)
        x, nc, _ = _apply_unit(x, _index(params["unit"], i), cfg, pos, unit_cache=unit_c,
                               media=media)
        _write_back(unit_c, nc)
    for j, kind in enumerate(cfg.tail_pattern):
        key = f"{j}_{kind}"
        x, nc, _ = _apply_sublayer(x, params["tail"][key], cfg, kind, pos,
                                   cache=cache["tail"][key], media=media)
        _write_back(cache["tail"][key], nc)
    logits = unembed(params, x, cfg)[:, -1]
    return logits, cache
