"""Core language-model layers — port of ``repro/models/layers.py``: norms,
RoPE, causal attention (GQA / MQA / sliding window), cross-attention to
media embeddings and dense MLPs.

Parameters are the reference's nested dicts (built by ``ParamBuilder``),
activations keep its (B, S, heads, hd) layout, and each function keeps
its name and arguments, without the sharding ``rules``: the reference's
``constrain`` calls have no single-card counterpart. ``causal_attention``
runs through the flash-attention kernel; ``_decode_attention`` and
``cross_attention`` are plain torch, as the reference computes them in
jnp outside any kernel.

With ``tp`` (a ``core.tensor_parallel.TensorParallel``: a train or serve
step on a mesh with a "model" axis) attention runs on this rank's block of
the padded query heads (``wq``, ``bq``, ``wo`` its blocks; ``wo``
row-parallel) and the MLP on its block of the ``d_ff`` channels (``wg``,
``wu``, ``w1``/``b1`` column-parallel, ``wd``/``w2`` row-parallel). K and
V are split with the heads for MHA whose heads divide the axis, else
computed whole before the region and read by each local head through the
global query-to-KV map.

Serving over "model" keeps each attention layer's KV cache in the
reference's layout (``kv_block``): by KV heads where they divide the axis,
else by the sequence. A rank of the head layout decodes its heads against
its block alone; under the sequence layout every rank attends all heads
against its slots (``partial_decode_attention``) and the ranks' partial
softmaxes are combined by one max and one sum all-reduce
(``combine_partial_attention``), the split-softmax decode the reference
leaves to GSPMD.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.aggregation import all_reduce
from repro_torch.kernels.flash_attention import flash_attention

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm(x, p, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        y = y * (1.0 + p["scale"].float())
    elif kind == "ln":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * (1.0 + p["scale"].float()) + p["bias"].float()
    elif kind == "nonparam":   # olmo: LayerNorm without learnable params
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


def norm_params(pb, name: str, d: int, kind: str):
    sub = pb.sub(name)
    if kind in ("rms", "ln"):
        sub.param("scale", (d,), ("embed",), init="zeros")
    if kind == "ln":
        sub.param("bias", (d,), ("embed",), init="zeros")
    return sub


def group_rmsnorm(x, weight, n_heads: int, eps: float = 1e-6):
    """Per-head RMS norm over the trailing head_dim (RWKV output norm)."""
    B, S, H, hd = x.shape
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * weight.float().reshape(1, 1, H, hd)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float):
    return theta ** (-np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integer absolute positions."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(hd, theta)).to(x.device)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


def attn_params(pb, cfg, tp: int = 16):
    """QKV(+bias) + output projection, query heads padded to a multiple of
    ``tp`` (zero-init pad heads whose outputs are masked, as the reference).
    The KV heads' logical axis is "heads" (sharded with the query heads) for
    MHA whose heads divide ``tp``, else "kv_heads" (replicated), as the
    reference's."""
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    Hp = pad_to_multiple(H, tp) if cfg.tp_pad_heads else H
    shard_kv = cfg.shard_kv_mha and KV == H == Hp and H % tp == 0
    kv_ax = "heads" if shard_kv else "kv_heads"
    sub = pb.sub("attn")
    sub.param("wq", (d, Hp, hd), ("embed", "heads", "head_dim"))
    sub.param("wk", (d, KV, hd), ("embed", kv_ax, "head_dim"))
    sub.param("wv", (d, KV, hd), ("embed", kv_ax, "head_dim"))
    sub.param("wo", (Hp, hd, d), ("heads", "head_dim", "embed"))
    if cfg.qkv_bias:
        sub.param("bq", (Hp, hd), ("heads", "head_dim"), init="zeros")
        sub.param("bk", (KV, hd), (kv_ax, "head_dim"), init="zeros")
        sub.param("bv", (KV, hd), (kv_ax, "head_dim"), init="zeros")
    return Hp


def _qkv(x, p, cfg, tp=None, media=None):
    """q from ``x``; k and v from ``media`` (cross-attention: no K/V bias)
    or ``x``. Under ``tp`` the products are this rank's heads: q enters the
    region from ``x``, and K and V too where they split with the heads,
    else they are computed whole before the region and enter it as they
    are."""
    kv_in = x if media is None else media
    kv_split = tp is None or tp.splits_kv(cfg)
    if tp is not None:
        x = tp.copy(x)
        if kv_split:
            kv_in = x if media is None else tp.copy(media)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        if media is None:
            k = k + p["bk"]
            v = v + p["bv"]
    if not kv_split:
        k, v = tp.copy(k), tp.copy(v)
    return q, k, v


def _head_mask(Hl: int, H: int, dtype, device=None, lo: int = 0):
    """The mask of the padded query heads lo .. lo + Hl - 1: 1 for a real
    head (< H), 0 for padding."""
    return (torch.arange(lo, lo + Hl, device=device) < H).to(dtype)[None, None, :, None]


def _expand_kv(k, Hp: int, H: int, KV: int, lo: int = 0, kv_lo: int = 0):
    """Map KV heads onto (padded) query heads: head h reads
    min(h // (H // KV), KV - 1). ``lo``: the first query head of the block
    (``Hp`` heads from it), ``kv_lo``: the first KV head ``k`` holds."""
    group = np.minimum(np.arange(lo, lo + Hp) // max(1, H // KV), KV - 1) - kv_lo
    return k[:, :, torch.from_numpy(group).to(k.device)]


def _tp_heads(p, cfg, tp):
    """(tp or None where the heads do not split, the first global query
    head of this rank's block, its first KV head, the global padded head
    count)."""
    Hl = p["wq"].shape[1]
    if tp is None or not tp.splits_heads(cfg):
        return None, 0, 0, Hl
    lo = tp.index * Hl
    return tp, lo, lo if tp.splits_kv(cfg) else 0, Hl * tp.size


def _attend_block(q_blk, k_ctx, v_ctx, mask, scale, softcap=0.0):
    """One query block against a KV context. q_blk (B, C, H, hd)."""
    logits = torch.einsum("bqhk,bshk->bhqs", q_blk, k_ctx).float() * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", probs.to(v_ctx.dtype), v_ctx)


def causal_attention(q, k, v, cfg, *, window: int = 0, lo: int = 0, kv_lo: int = 0,
                     tp=None):
    """Causal (optionally sliding-window) attention through the flash kernel.

    q (B, S, Hp, hd); k, v (B, S, KV, hd) -> (B, S, Hp, hd). The kernel runs
    on the real query heads, head h reading KV head h // (H // KV) — the
    reference's ``_expand_kv`` map on the real heads — and the padded heads'
    output is zero, which is what the reference's head mask leaves. Where the
    real heads do not fall into whole groups (KV does not divide H), K and V
    are first expanded to one head per real query head by that map,
    min(h // max(1, H // KV), KV - 1).

    Under tensor parallelism ``q`` holds the query heads lo .. lo + Hp - 1
    of the padded whole and ``k``, ``v`` the KV heads from ``kv_lo``: a
    rank's real heads may split a group (qwen2-0.5b's 14 heads over 2 ranks:
    heads 0-6 read KV head 0, head 7 KV head 1), and then K and V are
    expanded by the global map. A block of padding alone launches no kernel
    (``tp.anchor`` keeps its inputs in the graph).
    """
    B, S, Hp, hd = q.shape
    H, KV = cfg.n_heads, cfg.n_kv_heads
    n = max(0, min(H - lo, Hp))
    if n == 0:
        return tp.anchor(torch.zeros_like(q), q, k, v)
    g = H // KV if H % KV == 0 else 0
    if g and lo % g == 0 and n % g == 0:
        # whole groups: the kernel reads KV head h // g of the block
        k, v = (t[:, :, lo // g - kv_lo:(lo + n) // g - kv_lo] for t in (k, v))
    else:
        # uneven groups: expand K and V by the reference's map, so the
        # kernel sees one KV head per query head
        k, v = _expand_kv(k, n, H, KV, lo, kv_lo), _expand_kv(v, n, H, KV, lo, kv_lo)
    o = flash_attention(q[:, :, :n].transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True, window=window, scale=1.0 / math.sqrt(hd),
                        softcap=cfg.logit_softcap).transpose(1, 2)
    if Hp != n:
        o = F.pad(o, (0, 0, 0, Hp - n))
    return o


def kv_block(cfg, tp, clen: int):
    """This rank's block of an attention layer's (B, clen, KV, hd) cache
    under ``tp``, in the reference's layout (``repro/launch/specs.py``'s
    ``cache_struct_sharded``): (its first KV head, its KV heads, its first
    slot, its slots). By KV heads where they divide the "model" axis, else
    by the sequence, whose length must then divide; whole without ``tp``,
    on an axis of one, or where the query heads do not split (attention
    then runs whole on every rank)."""
    KV = cfg.n_kv_heads
    if tp is None or tp.size == 1 or not tp.splits_heads(cfg):
        return 0, KV, 0, clen
    if KV % tp.size == 0:
        n = KV // tp.size
        H, Hl = cfg.n_heads, pad_to_multiple(cfg.n_heads, tp.size) // tp.size
        lo = tp.index * Hl
        read = np.minimum(np.arange(lo, min(lo + Hl, H)) // max(1, H // KV), KV - 1)
        if read.size and (read.min() < tp.index * n or read.max() >= (tp.index + 1) * n):
            raise NotImplementedError(
                f"query heads {lo}..{lo + Hl - 1} read KV heads outside their rank's block "
                f"of {n}: {cfg.n_heads} heads over {KV} KV heads in uneven groups")
        return tp.index * n, n, 0, clen
    if clen % tp.size:
        raise ValueError(f"a KV cache of {clen} slots does not split into {tp.size} sequence "
                         "shards over 'model': choose a cache length the axis divides")
    n = clen // tp.size
    return 0, KV, tp.index * n, n


def self_attention(x, p, cfg, positions, *, window: int = 0, cache=None, tp=None):
    """Full self-attention sublayer (projections + rope + attend + out-proj).

    cache: None for prefill / forward; dict(k, v, pos) for decode.
    Returns (out, (k, v) for prefill's cache, or the updated cache).
    ``tp``: this rank's block of the heads; in decode, ``cache`` is this
    rank's block of the layer's cache (:func:`kv_block`).
    """
    tp, lo, kv_lo, Hp = _tp_heads(p, cfg, tp)
    H = cfg.n_heads
    q, k, v = _qkv(x, p, cfg, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = causal_attention(q, k, v, cfg, window=window, lo=lo, kv_lo=kv_lo, tp=tp)
        new_kv = (k, v)
    else:
        o, new_kv = _decode_attention(q, k, v, cache, cfg, window, tp, lo, kv_lo)
    if Hp != H:
        o = o * _head_mask(o.shape[2], H, o.dtype, o.device, lo)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return (out if tp is None else tp.reduce(out)), new_kv


def partial_decode_attention(q, k, v, valid, softcap: float = 0.0):
    """One query position against one shard of a KV cache: (o, lse) of the
    softmax over the shard's valid slots alone, in f32.

    q (B, 1, H, hd); k, v (B, Sl, H, hd), already one KV head a query head;
    valid (Sl,) bool. o (B, 1, H, hd) is the shard's softmax-weighted sum,
    lse (B, 1, H) the log of its Σ exp of the (soft-capped) logits: −inf
    and o = 0 where the shard holds no valid slot, so that such a shard
    adds exactly 0 in :func:`combine_partial_attention`."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhk,bshk->bqhs", q.float(), k.float()) / math.sqrt(hd)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)
    den = e.sum(-1)
    o = torch.einsum("bqhs,bshk->bqhk", e, v.float()) / den.clamp_min(1e-30)[..., None]
    return o, m[..., 0] + torch.log(den)


def combine_partial_attention(o, lse, reduce_max, reduce_sum):
    """The softmax over every shard from the shards' partials:
    Σ_r exp(lse_r − m)·o_r / Σ_r exp(lse_r − m), m = max_r lse_r.
    ``reduce_max`` / ``reduce_sum`` take the max and the sum over the
    shards: all-reduces over "model", or a reduction of a stacked axis in
    one process (``o`` and ``lse`` then carry it first). A shard with lse
    −inf adds 0; at least one shard holds a valid slot."""
    m = reduce_max(lse)
    w = torch.exp(lse - m)
    both = reduce_sum(torch.cat([o * w[..., None], w[..., None]], dim=-1))
    return both[..., :-1] / both[..., -1:]


def decode_valid(slots, pos: int, Smax: int, window: int):
    """Which of the cache ``slots`` (global slot indices) a query at ``pos``
    attends, its K/V written: on a ring (a windowed layer, Smax <= window)
    every slot written so far, in-window by construction; else the
    positions up to ``pos``, within the window."""
    if window > 0 and Smax <= window:
        return slots < min(pos + 1, Smax)
    valid = slots <= pos
    if window:
        valid &= slots > pos - window
    return valid


def _decode_attention(q, k_new, v_new, cache, cfg, window: int, tp=None, lo: int = 0,
                      kv_lo: int = 0):
    """Single-token decode against a (possibly ring-buffered) KV cache.

    cache: {'k': (B, Smax, KV, hd), 'v': ..., 'pos': int}. For windowed
    layers Smax <= window and the buffer is a ring: position p lives in
    slot p % Smax. The new token's K/V are written into the buffers in
    place (the port's cache is mutable; the reference returns new arrays).

    Under ``tp`` the cache is this rank's block (:func:`kv_block`), ``q``
    its query heads from ``lo`` and ``k_new``, ``v_new`` the KV heads from
    ``kv_lo``. By KV heads the rank writes and attends its heads alone. By
    sequence the rank holds slots s_lo .. s_lo + Sl − 1 of every KV head:
    it writes the new token only if it owns its slot, attends every query
    head (q all-gathered over "model") against its slots, and the ranks'
    partials are combined (:func:`combine_partial_attention`); the rank
    keeps its own heads of the result.
    """
    B, one, Hl, hd = q.shape
    assert one == 1
    kc, vc, pos = cache["k"], cache["v"], int(cache["pos"])
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Sl = kc.shape[1]
    seq = tp is not None and tp.size > 1 and KV % tp.size != 0
    Smax = Sl * tp.size if seq else Sl
    c_lo, n, s_lo, _ = kv_block(cfg, tp, Smax)
    ring = window > 0 and Smax <= window
    slot = (pos % Smax if ring else pos) - s_lo
    if not seq or 0 <= slot < Sl:
        kc[:, slot] = k_new[:, 0, c_lo - kv_lo:c_lo - kv_lo + n]
        vc[:, slot] = v_new[:, 0, c_lo - kv_lo:c_lo - kv_lo + n]

    valid = decode_valid(s_lo + torch.arange(Sl, device=q.device), pos, Smax, window)
    new = {"k": kc, "v": vc, "pos": pos + 1}
    if not seq:
        kf = _expand_kv(kc, Hl, H, KV, lo, c_lo)
        vf = _expand_kv(vc, Hl, H, KV, lo, c_lo)
        return _attend_block(q, kf, vf, valid[None, None, None, :], 1.0 / np.sqrt(hd),
                             cfg.logit_softcap), new
    q_all = tp.gather(q, 2)
    Hp = q_all.shape[2]
    o, lse = partial_decode_attention(q_all, _expand_kv(kc, Hp, H, KV),
                                      _expand_kv(vc, Hp, H, KV), valid, cfg.logit_softcap)
    o = combine_partial_attention(
        o, lse, lambda t: all_reduce(t, tp.group, op=dist.ReduceOp.MAX),
        lambda t: all_reduce(t, tp.group))
    return o[:, :, lo:lo + Hl].to(q.dtype), new


def cross_attention(x, p, cfg, media_kv, tp=None):
    """Cross-attend text queries to (stub) media embeddings.

    media_kv: (B, T_media, d_model), the frontend's output. Every query
    sees the whole media sequence (no mask, no RoPE). The query rows go in
    blocks of ``cfg.q_chunk``, which bounds the f32 scores at (B, Hp,
    q_chunk, T) (the reference's are (B, Hp, S, T)); each row's softmax is
    the same either way. ``tp``: this rank's block of the heads, as
    :func:`self_attention`'s.
    """
    tp, lo, kv_lo, Hp = _tp_heads(p, cfg, tp)
    Hl = p["wq"].shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(x, p, cfg, tp, media_kv)
    kf = _expand_kv(k, Hl, H, KV, lo, kv_lo)
    vf = _expand_kv(v, Hl, H, KV, lo, kv_lo)
    n = max(1, cfg.q_chunk)
    o = torch.cat([_attend_block(q[:, i:i + n], kf, vf, None, 1.0 / np.sqrt(hd),
                                 cfg.logit_softcap) for i in range(0, q.shape[1], n)], dim=1)
    if Hp != H:
        o = o * _head_mask(Hl, H, o.dtype, o.device, lo)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out if tp is None else tp.reduce(out)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_params(pb, cfg, name: str = "mlp"):
    d, ff = cfg.d_model, cfg.d_ff
    sub = pb.sub(name)
    if cfg.mlp == "swiglu":
        sub.param("wg", (d, ff), ("embed", "mlp"))
        sub.param("wu", (d, ff), ("embed", "mlp"))
        sub.param("wd", (ff, d), ("mlp", "embed"))
    else:
        sub.param("w1", (d, ff), ("embed", "mlp"))
        sub.param("b1", (ff,), ("mlp",), init="zeros")
        sub.param("w2", (ff, d), ("mlp", "embed"))
        sub.param("b2", (d,), ("embed",), init="zeros")


def mlp_block(x, p, cfg, tp=None):
    """The dense MLP; with ``tp`` on this rank's block of the ``d_ff``
    channels where they split (column-parallel in, row-parallel out, the
    output bias added once after the reduce)."""
    if tp is not None and not tp.splits(cfg.d_ff):
        tp = None
    x_in = x if tp is None else tp.copy(x)
    if cfg.mlp == "swiglu":
        g = torch.einsum("bsd,df->bsf", x_in, p["wg"])
        u = torch.einsum("bsd,df->bsf", x_in, p["wu"])
        h = F.silu(g.float()).to(x.dtype) * u
        out = torch.einsum("bsf,fd->bsd", h, p["wd"])
        return out if tp is None else tp.reduce(out)
    h = torch.einsum("bsd,df->bsf", x_in, p["w1"]) + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)   # jax.nn.gelu's default
    out = torch.einsum("bsf,fd->bsd", h, p["w2"])
    return (out if tp is None else tp.reduce(out)) + p["b2"]
