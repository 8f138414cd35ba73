"""RecurrentGemma / Griffin recurrent block: RG-LRU + temporal conv —
port of ``repro/models/rglru.py``.

The recurrence h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t) runs
through the RG-LRU scan kernel in prefill (from zeros) and in the
one-token decode update (the scan at S = 1 from the carried state); the
reference uses ``associative_scan`` and a fused jnp update there. With
``tp`` (the train step on a mesh with a "model" axis) the block runs on
this rank's block of the ``rnn_width`` channels where they split: ``w_in``,
``w_gate``, ``w_rg``, ``w_ig``, ``conv_w``, ``conv_b`` and ``lam`` its
column blocks, ``w_out`` row-parallel, the scan on the local channels; in
decode the carried ``h`` and conv state are the rank's channels too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan

_C_RGLRU = 8.0  # Griffin's fixed gate sharpness


def rglru_params(pb, cfg, name: str = "rglru"):
    d, r, cw = cfg.d_model, cfg.rnn_width, cfg.conv_width
    sub = pb.sub(name)
    sub.param("w_in", (d, r), ("embed", "mlp"))
    sub.param("w_gate", (d, r), ("embed", "mlp"))
    sub.param("w_out", (r, d), ("mlp", "embed"))
    sub.param("conv_w", (cw, r), ("conv", "mlp"), scale=0.5)
    sub.param("conv_b", (r,), ("mlp",), init="zeros")
    # diagonal RG-LRU gates (per-channel linear + bias), as the reference
    sub.param("w_rg", (d, r), ("embed", "mlp"), scale=0.5)
    sub.param("w_ig", (d, r), ("embed", "mlp"), scale=0.5)
    sub.param("lam", (r,), ("mlp",), init="linspace", scale=2.0)   # Λ spread


def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv along time via shifted adds (exact, conv-free).

    u: (B, S, r). state: (B, cw-1, r) trailing context for decode.
    Returns (y, new_state).
    """
    B, S, r = u.shape
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((B, cw - 1, r), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)                    # (B, S+cw-1, r)
    y = torch.zeros_like(u)
    for i in range(cw):
        y = y + ext[:, i:i + S, :] * w[i]
    y = y + b
    return y, ext[:, ext.shape[1] - (cw - 1):, :]


def rglru_block(x, p, cfg, state=None, tp=None):
    """x: (B, S, d) -> (B, S, d); state: None (prefill / forward) or
    {'conv': (B, cw-1, r), 'h': (B, r) f32} (decode). Returns (out, new_state)."""
    if tp is not None and not tp.splits(cfg.rnn_width):
        tp = None
    x_in = x if tp is None else tp.copy(x)
    u = torch.einsum("bsd,dr->bsr", x_in, p["w_in"])
    g = F.gelu(torch.einsum("bsd,dr->bsr", x_in, p["w_gate"]).float(),
               approximate="tanh").to(x.dtype)            # jax.nn.gelu's default
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"],
                               None if state is None else state["conv"])
    rg = torch.sigmoid(torch.einsum("bsd,dr->bsr", x_in, p["w_rg"]).float())
    ig = torch.sigmoid(torch.einsum("bsd,dr->bsr", x_in, p["w_ig"]).float())
    log_a = -_C_RGLRU * rg * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    bx = beta * ig * u.float()
    h, new_h = rglru_scan(a.contiguous(), bx.contiguous(),
                          None if state is None else state["h"].contiguous())
    h = h.to(x.dtype) * g
    out = torch.einsum("bsr,rd->bsd", h, p["w_out"])
    return (out if tp is None else tp.reduce(out)), {"conv": new_conv, "h": new_h}


def rglru_init_state(cfg, batch: int, dtype, device=None, tp=None):
    """Zero decode state; with ``tp`` this rank's block of the channels
    (where they split), the channels its ``rglru_block`` reads."""
    r, cw = cfg.rnn_width, cfg.conv_width
    if tp is not None and tp.splits(r):
        r //= tp.size
    return {"conv": torch.zeros((batch, cw - 1, r), dtype=dtype, device=device),
            "h": torch.zeros((batch, r), dtype=torch.float32, device=device)}
