"""RWKV6 ("Finch") — linear attention with data-dependent per-channel decay;
port of ``repro/models/rwkv6.py``.

Recurrence per head (state S ∈ R^{hd×hd}):
    o_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t)
    S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t
with w_t = exp(-exp(ww_t)) data-dependent (LoRA on the shifted input).

The reference's whole chunk loop (``rwkv_time_mix``'s scan of
``_chunk_body``) runs through the RWKV6 scan kernel: from a zero state in
prefill, from the carried state in decode (S = 1). Where S is not a
multiple of the chunk the kernel takes a ragged last chunk; the reference
takes one chunk of S tokens there — the same function up to rounding.

With ``tp`` (the train step on a mesh with a "model" axis) the time mix
runs on this rank's block of the padded heads: ``wr``, ``wk``, ``wv``,
``wg``, ``decay_base``, ``decay_b``, ``ln_out`` and ``bonus_u`` its blocks,
``wo`` row-parallel. The data-dependent mixes (and the decay LoRA's first
product) are computed whole before the region. The heads pad to 16 at
every mesh, as the reference's ``rwkv_heads(cfg)``, so at reduced width a
rank may hold padding alone: it launches no scan. The channel mix splits
``d_ff``: ``wk`` column-parallel, ``wv`` row-parallel, ``wr`` replicated
(its gate computed before the region).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.layers import group_rmsnorm, pad_to_multiple


def rwkv_heads(cfg, tp: int = 16):
    H = cfg.d_model // cfg.rwkv_head_dim
    Hp = pad_to_multiple(H, tp) if cfg.tp_pad_heads else H
    return H, Hp


_STREAMS = ("r", "k", "v", "w", "g")


def rwkv_time_params(pb, cfg, name: str = "time"):
    d, hd, lora = cfg.d_model, cfg.rwkv_head_dim, cfg.rwkv_lora
    H, Hp = rwkv_heads(cfg)
    D = Hp * hd
    sub = pb.sub(name)
    sub.param("mu_base", (d,), ("embed",), init="uniform", scale=0.5)
    sub.param("lora_a", (d, lora), ("embed", "lora"), scale=0.5)
    for s in _STREAMS:
        sub.param(f"mu_{s}", (d,), ("embed",), init="uniform", scale=0.5)
        sub.param(f"lora_b_{s}", (lora, d), ("lora", "embed"), init="zeros")
    sub.param("wr", (d, D), ("embed", "mlp"))
    sub.param("wk", (d, D), ("embed", "mlp"))
    sub.param("wv", (d, D), ("embed", "mlp"))
    sub.param("wg", (d, D), ("embed", "mlp"))
    sub.param("wo", (D, d), ("mlp", "embed"))
    sub.param("decay_base", (D,), ("mlp",), init="linspace", scale=1.5)
    sub.param("decay_a", (d, lora), ("embed", "lora"), scale=0.5)
    sub.param("decay_b", (lora, D), ("lora", "mlp"), init="zeros")
    sub.param("bonus_u", (Hp, hd), ("heads", "head_dim"), init="uniform", scale=0.5)
    sub.param("ln_out", (Hp * hd,), ("mlp",), init="ones")


def rwkv_channel_params(pb, cfg, name: str = "channel"):
    d, ff = cfg.d_model, cfg.d_ff
    sub = pb.sub(name)
    sub.param("mu_k", (d,), ("embed",), init="uniform", scale=0.5)
    sub.param("mu_r", (d,), ("embed",), init="uniform", scale=0.5)
    sub.param("wk", (d, ff), ("embed", "mlp"))
    sub.param("wv", (ff, d), ("mlp", "embed"))
    sub.param("wr", (d, d), ("embed", None), scale=0.5)


def _token_shift(x, x_prev_last: Optional[torch.Tensor]):
    """x_{t-1} along the sequence; x_prev_last (B, d) carries across calls."""
    B, S, d = x.shape
    if x_prev_last is None:
        x_prev_last = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(x, xp, p, stream: str):
    """RWKV6 data-dependent lerp between x_t and x_{t-1}."""
    base = x + (xp - x) * p["mu_base"]
    lora = torch.tanh(torch.einsum("bsd,dl->bsl", base, p["lora_a"]))
    mix = p[f"mu_{stream}"] + torch.einsum("bsl,ld->bsd", lora, p[f"lora_b_{stream}"])
    return x + (xp - x) * mix


def _project_heads(x, w, Hp, hd):
    y = torch.einsum("bsd,de->bse", x, w)
    return y.reshape(x.shape[0], x.shape[1], Hp, hd)


def rwkv_time_mix(x, p, cfg, state=None, tp=None):
    """Time-mix sublayer. state: None (prefill / forward) or
    {'S': (B, Hp, hd, hd) f32, 'shift': (B, d)} (decode). ``tp``: this
    rank's block of the heads (its ``S`` too; a rank of padding alone
    keeps a zero state)."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H, Hp = rwkv_heads(cfg)
    if tp is not None and not tp.splits(Hp):
        tp = None
    Hl = p["bonus_u"].shape[0]                             # this rank's heads
    lo = 0 if tp is None else tp.index * Hl

    xp = _token_shift(x, None if state is None else state["shift"])
    xr, xk, xv, xw, xg = (_ddlerp(x, xp, p, s) for s in _STREAMS)
    lw = torch.tanh(torch.einsum("bsd,dl->bsl", xw, p["decay_a"]))
    if tp is not None:
        xr, xk, xv, xg, lw = (tp.copy(t) for t in (xr, xk, xv, xg, lw))
    r = _project_heads(xr, p["wr"], Hl, hd)
    k = _project_heads(xk, p["wk"], Hl, hd)
    v = _project_heads(xv, p["wv"], Hl, hd)
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["wg"]).float())

    ww = p["decay_base"].float() + torch.einsum("bsl,le->bse", lw.float(),
                                                p["decay_b"].float())
    # log w = -exp(ww)  (clamped for chunk numerics; w ∈ (~e^-20, 1))
    logw = -torch.exp(torch.clamp(ww, -8.0, 3.0)).reshape(B, S, Hl, hd)
    u = p["bonus_u"].float()

    if lo >= H:
        # padding alone: no scan; the zeros the head mask leaves
        o = tp.anchor(torch.zeros((B, S, Hl, hd), dtype=torch.float32, device=x.device),
                      r, k, v, logw, u)
        St = torch.zeros((B, Hl, hd, hd), dtype=torch.float32, device=x.device)
    else:
        o, St = rwkv6_scan(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           logw.transpose(1, 2), u, chunk=cfg.rwkv_chunk,
                           s0=None if state is None else state["S"])
        o = o.transpose(1, 2)                              # (B, S, Hl, hd) f32
        if lo + Hl > H:
            o = o * (torch.arange(lo, lo + Hl, device=x.device) < H).float()[
                None, None, :, None]
    o = o.to(x.dtype)
    o = group_rmsnorm(o, p["ln_out"].reshape(Hl, hd), Hl).reshape(B, S, Hl * hd)
    o = (o.float() * g).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", o, p["wo"])
    return (out if tp is None else tp.reduce(out)), {"S": St, "shift": x[:, -1, :]}


def rwkv_channel_mix(x, p, cfg, state=None, tp=None):
    """Channel-mix sublayer; ``tp``: this rank's block of ``d_ff``."""
    if tp is not None and not tp.splits(cfg.d_ff):
        tp = None
    xp = _token_shift(x, None if state is None else state["shift"])
    xk = x + (xp - x) * p["mu_k"]
    xr = x + (xp - x) * p["mu_r"]
    k = torch.einsum("bsd,df->bsf", xk if tp is None else tp.copy(xk), p["wk"])
    k = torch.square(F.relu(k.float())).to(x.dtype)
    rgate = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["wr"]).float())
    out = torch.einsum("bsf,fd->bsd", k, p["wv"])
    if tp is not None:
        out = tp.reduce(out)
    out = (out.float() * rgate).to(x.dtype)
    return out, {"shift": x[:, -1, :]}


def rwkv_init_state(cfg, batch: int, dtype, device=None, tp=None):
    """Zero decode state; with ``tp`` the time mix's ``S`` holds this rank's
    block of the padded heads (where they split), the shifts the whole
    residual stream every model rank holds."""
    hd = cfg.rwkv_head_dim
    _, Hp = rwkv_heads(cfg)
    if tp is not None and tp.splits(Hp):
        Hp //= tp.size
    return {
        "time": {"S": torch.zeros((batch, Hp, hd, hd), dtype=torch.float32, device=device),
                 "shift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)},
        "channel": {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)},
    }
