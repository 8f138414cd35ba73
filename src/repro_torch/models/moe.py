"""Mixture-of-Experts block with capacity-based scatter/gather dispatch —
port of ``repro/models/moe.py``.

Each token's router picks ``top_k`` of ``n_experts`` experts (softmax in
f32, the top-k weights renormalised). Every assignment gets a position in
its expert's queue in (s, k) scan order; an expert keeps its first C
(``capacity``) and drops the rest. The kept tokens are scattered into an
(E, C) slot grid per batch row, every expert's MLP runs on all of its C
slots as one batched product, and each token gathers its experts' outputs
back, weighted. ``moe_block_einsum`` is the reference's small-shape oracle
(one-hot dispatch tensors), ported too.

Layout. The reference lays the slot grid out (B, E, C, d) for its expert
sharding; the port keeps it (E, B·C, d), so the expert products are one
``torch.matmul`` over the expert axis with no copy in between. The values
are the same.

The scatter adds. A dropped assignment is clipped to slot C − 1 with a
zero update, as in the reference, so an assignment scatter would let that
zero overwrite the kept token there; ``index_add_`` sums one value with
exact zeros, which no order of the card's atomics changes. So one
``index_add_`` of all k assignments gives the reference's k scatters'
values (every slot gets at most one kept token), and one gather fetches
all k outputs; the weighted sum then adds them one k at a time in the
model's type, as the reference does.

``moe_combine``: the reference's ``"manual"`` falls back to the gather
path without a mesh and ``"gather_dshard"`` changes only sharding
constraints, so on one card every mode computes ``"gather"``.

Top-k ties: ``torch.topk`` does not promise the lower index on a tie as
``jax.lax.top_k`` does. The router's f32 probabilities of continuous
inputs do not tie in practice; the tests draw their inputs so.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def capacity(cfg, seq_len: int) -> int:
    """Slots per expert for a group of ``seq_len`` tokens: ceil(S·k·cf/E),
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(seq_len * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, ((c + 7) // 8) * 8)


def moe_params(pb, cfg, name: str = "moe"):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    sub = pb.sub(name)
    sub.param("router", (d, E), scale=0.1)
    if cfg.mlp == "swiglu":
        sub.param("wg", (E, d, ff))
        sub.param("wu", (E, d, ff))
        sub.param("wd", (E, ff, d))
    else:
        sub.param("w1", (E, d, ff))
        sub.param("w2", (E, ff, d))


def _route(x, p, cfg):
    """Router: (weights (B, S, k), expert ids (B, S, k), aux load loss)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    # switch-style load-balance loss: mean router probability times the
    # fraction routed (top-1 proxy)
    E = cfg.n_experts
    me = probs.mean((0, 1))
    ce = F.one_hot(topi[..., 0], E).float().mean((0, 1))
    return topv, topi, E * (me * ce).sum()


def _expert_ffn(xd, p, cfg):
    """xd: (E, N, d) -> (E, N, d); every expert's MLP on its N slots."""
    if cfg.mlp == "swiglu":
        g = torch.matmul(xd, p["wg"])
        h = F.silu(g.float()).to(xd.dtype)
        del g
        h = h * torch.matmul(xd, p["wu"])
        return torch.matmul(h, p["wd"])
    h = torch.matmul(xd, p["w1"])
    h = F.gelu(h.float(), approximate="tanh").to(xd.dtype)   # jax.nn.gelu's default
    return torch.matmul(h, p["w2"])


def _positions(topi, E: int, C: int):
    """Each assignment's position in its expert's queue, in (s, k) scan
    order: the number of earlier assignments (over the flattened S·k axis)
    to the same expert — the reference's exclusive cumulative sum of the
    one-hot, without the (B, S·k, E) one-hot. A stable sort by expert keeps
    each expert's assignments in scan order, so an assignment's rank in its
    expert's run of the sorted order is that count. Returns (pos (B, S, k),
    kept (B, S, k))."""
    B, S, k = topi.shape
    flat_e = topi.reshape(B, S * k)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    counts = torch.zeros((B, E), dtype=torch.long, device=topi.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(1) - counts                                # (B, E)
    ranks = torch.arange(S * k, device=topi.device) - starts.gather(1, sorted_e)
    pos = torch.empty_like(flat_e).scatter_(1, order, ranks).reshape(B, S, k)
    return pos, pos < C


def moe_block_scatter(x, p, cfg):
    """The dispatch of ``moe_block``: scatter-add into the slot grid, the
    experts, then a weighted gather. Returns (out (B, S, d), aux)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    topv, topi, aux = _route(x, p, cfg)
    pos, keep = _positions(topi, E, C)
    # slot of each assignment in the (E, B, C) grid; dropped ones clipped to
    # C − 1 with a zero update
    slot = (topi * B + torch.arange(B, device=x.device)[:, None, None]) * C \
        + pos.clamp(max=C - 1)

    slot = slot.reshape(-1)                                           # (b, s, k) order
    xd = x.new_zeros((E * B * C, d))
    xd.index_add_(0, slot, (x[:, :, None] * keep[..., None].to(x.dtype)).reshape(-1, d))
    yd = _expert_ffn(xd.view(E, B * C, d), p, cfg).reshape(E * B * C, d)
    del xd

    wts = (topv * keep.float()).to(x.dtype)                           # (B, S, k)
    g = yd.index_select(0, slot).view(B, S, k, d)
    out = torch.zeros_like(x)
    for kk in range(k):
        out = out + g[:, :, kk] * wts[..., kk:kk + 1]
    return out, aux


def moe_block_einsum(x, p, cfg):
    """One-hot einsum dispatch (the oracle; small shapes only)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    topv, topi, aux = _route(x, p, cfg)
    pos, keep = _positions(topi, E, C)
    keep = keep.float()
    pos = pos.clamp(max=C - 1)
    # dispatch tensor (B, S, k, E, C)
    de = F.one_hot(topi, E).float() * keep[..., None]
    dc = F.one_hot(pos, C).float()
    disp = torch.einsum("bske,bskc->bsec", de, dc)
    xd = torch.einsum("bsec,bsd->ebcd", disp, x.float()).to(x.dtype)
    yd = _expert_ffn(xd.reshape(E, B * C, d), p, cfg).view(E, B, C, d)
    comb = torch.einsum("bske,bskc,bsk->bsec", de, dc, topv)
    out = torch.einsum("bsec,ebcd->bsd", comb, yd.float()).to(x.dtype)
    return out, aux


def moe_block(x, p, cfg):
    """The MoE MLP over sequence chunks: the largest count up to
    ``cfg.moe_seq_chunks`` that divides S (S = 4097 gives one chunk, with
    the capacity of 4097 tokens). Returns (out, aux averaged over chunks)."""
    impl = moe_block_einsum if cfg.moe_impl == "einsum" else moe_block_scatter
    S = x.shape[1]
    nc = max(1, min(cfg.moe_seq_chunks, S))
    while S % nc:
        nc -= 1
    if nc == 1:
        return impl(x, p, cfg)
    outs, aux = [], 0.0
    n = S // nc
    for i in range(nc):
        o, a = impl(x[:, i * n:(i + 1) * n], p, cfg)
        outs.append(o)
        aux = aux + a
    return torch.cat(outs, dim=1), aux / nc
