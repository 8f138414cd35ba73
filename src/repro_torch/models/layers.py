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
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

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
        sub.param("scale", (d,), init="zeros")
    if kind == "ln":
        sub.param("bias", (d,), init="zeros")
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
    ``tp`` (zero-init pad heads whose outputs are masked, as the reference)."""
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    Hp = pad_to_multiple(H, tp) if cfg.tp_pad_heads else H
    sub = pb.sub("attn")
    sub.param("wq", (d, Hp, hd))
    sub.param("wk", (d, KV, hd))
    sub.param("wv", (d, KV, hd))
    sub.param("wo", (Hp, hd, d))
    if cfg.qkv_bias:
        sub.param("bq", (Hp, hd), init="zeros")
        sub.param("bk", (KV, hd), init="zeros")
        sub.param("bv", (KV, hd), init="zeros")
    return Hp


def _qkv(x, p, cfg, Hp):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _head_mask(Hp: int, H: int, dtype, device=None):
    if Hp == H:
        return None
    return (torch.arange(Hp, device=device) < H).to(dtype)[None, None, :, None]


def _expand_kv(k, Hp: int, H: int, KV: int):
    """Map KV heads onto (padded) query heads: head h reads
    min(h // (H // KV), KV - 1)."""
    group = np.minimum(np.arange(Hp) // max(1, H // KV), KV - 1)
    return k[:, :, torch.from_numpy(group).to(k.device)]


def _attend_block(q_blk, k_ctx, v_ctx, mask, scale, softcap=0.0):
    """One query block against a KV context. q_blk (B, C, H, hd)."""
    logits = torch.einsum("bqhk,bshk->bhqs", q_blk, k_ctx).float() * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", probs.to(v_ctx.dtype), v_ctx)


def causal_attention(q, k, v, cfg, *, window: int = 0):
    """Causal (optionally sliding-window) attention through the flash kernel.

    q (B, S, Hp, hd); k, v (B, S, KV, hd) -> (B, S, Hp, hd). The kernel runs
    on the H real query heads, head h reading KV head h // (H // KV) — the
    reference's ``_expand_kv`` map on the real heads — and the padded heads'
    output is zero, which is what the reference's head mask leaves. Where KV
    does not divide H, K and V are first expanded to H heads by that map,
    min(h // max(1, H // KV), KV - 1).
    """
    B, S, Hp, hd = q.shape
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if H % KV:
        # uneven groups: expand K and V by the reference's map, so the
        # kernel sees one KV head per query head
        k, v = _expand_kv(k, H, H, KV), _expand_kv(v, H, H, KV)
    o = flash_attention(q[:, :, :H].transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True, window=window, scale=1.0 / math.sqrt(hd),
                        softcap=cfg.logit_softcap).transpose(1, 2)
    if Hp != H:
        o = F.pad(o, (0, 0, 0, Hp - H))
    return o


def self_attention(x, p, cfg, positions, *, window: int = 0, cache=None):
    """Full self-attention sublayer (projections + rope + attend + out-proj).

    cache: None for prefill / forward; dict(k, v, pos) for decode.
    Returns (out, (k, v) for prefill's cache, or the updated cache).
    """
    Hp = p["wq"].shape[1]
    H = cfg.n_heads
    q, k, v = _qkv(x, p, cfg, Hp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = causal_attention(q, k, v, cfg, window=window)
        new_kv = (k, v)
    else:
        o, new_kv = _decode_attention(q, k, v, cache, cfg, window)
    hm = _head_mask(Hp, H, o.dtype, o.device)
    if hm is not None:
        o = o * hm
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, new_kv


def _decode_attention(q, k_new, v_new, cache, cfg, window: int):
    """Single-token decode against a (possibly ring-buffered) KV cache.

    cache: {'k': (B, Smax, KV, hd), 'v': ..., 'pos': int}. For windowed
    layers Smax <= window and the buffer is a ring: position p lives in
    slot p % Smax. The new token's K/V are written into the buffers in
    place (the port's cache is mutable; the reference returns new arrays).
    """
    B, one, Hp, hd = q.shape
    assert one == 1
    kc, vc, pos = cache["k"], cache["v"], int(cache["pos"])
    Smax = kc.shape[1]
    ring = window > 0 and Smax <= window
    slot = pos % Smax if ring else pos
    kc[:, slot] = k_new[:, 0]
    vc[:, slot] = v_new[:, 0]

    H, KV = cfg.n_heads, cfg.n_kv_heads
    kf = _expand_kv(kc, Hp, H, KV)
    vf = _expand_kv(vc, Hp, H, KV)
    idx = torch.arange(Smax, device=q.device)
    if ring:
        # every slot written so far is in-window by construction
        valid = idx < min(pos + 1, Smax)
    else:
        valid = idx <= pos
        if window:
            valid &= idx > pos - window
    o = _attend_block(q, kf, vf, valid[None, None, None, :], 1.0 / np.sqrt(hd),
                      cfg.logit_softcap)
    return o, {"k": kc, "v": vc, "pos": pos + 1}


def cross_attention(x, p, cfg, media_kv):
    """Cross-attend text queries to (stub) media embeddings.

    media_kv: (B, T_media, d_model), the frontend's output. Every query
    sees the whole media sequence (no mask, no RoPE). The query rows go in
    blocks of ``cfg.q_chunk``, which bounds the f32 scores at (B, Hp,
    q_chunk, T) (the reference's are (B, Hp, S, T)); each row's softmax is
    the same either way.
    """
    Hp = p["wq"].shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k = torch.einsum("btd,dhk->bthk", media_kv, p["wk"])
    v = torch.einsum("btd,dhk->bthk", media_kv, p["wv"])
    kf = _expand_kv(k, Hp, H, KV)
    vf = _expand_kv(v, Hp, H, KV)
    n = max(1, cfg.q_chunk)
    o = torch.cat([_attend_block(q[:, i:i + n], kf, vf, None, 1.0 / np.sqrt(hd),
                                 cfg.logit_softcap) for i in range(0, q.shape[1], n)], dim=1)
    hm = _head_mask(Hp, H, o.dtype, o.device)
    if hm is not None:
        o = o * hm
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_params(pb, cfg, name: str = "mlp"):
    d, ff = cfg.d_model, cfg.d_ff
    sub = pb.sub(name)
    if cfg.mlp == "swiglu":
        sub.param("wg", (d, ff))
        sub.param("wu", (d, ff))
        sub.param("wd", (ff, d))
    else:
        sub.param("w1", (d, ff))
        sub.param("b1", (ff,), init="zeros")
        sub.param("w2", (ff, d))
        sub.param("b2", (d,), init="zeros")


def mlp_block(x, p, cfg):
    if cfg.mlp == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
        u = torch.einsum("bsd,df->bsf", x, p["wu"])
        h = F.silu(g.float()).to(x.dtype) * u
        return torch.einsum("bsf,fd->bsd", h, p["wd"])
    h = torch.einsum("bsd,df->bsf", x, p["w1"]) + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)   # jax.nn.gelu's default
    return torch.einsum("bsf,fd->bsd", h, p["w2"]) + p["b2"]
