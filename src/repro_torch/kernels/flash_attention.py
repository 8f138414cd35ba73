"""Causal GQA flash attention (forward) — port of
``repro/kernels/flash_attention.py``.

    o[b, h, t] = softmax over the keys s ≤ t, s > t − window of
                 scale · q[b, h, t] · k[b, h // g, s], applied to v[b, h // g]

``flash_attention`` launches a hand-written CUDA kernel for CUDA tensors
and takes the plain PyTorch version beside it only for CPU tensors; any
other device raises. It routes by type, explicitly:

- bf16 -> ``csrc/flash_attention_wgmma.cu``: TMA-fed K/V ring, QKᵀ and
  P·V on the tensor cores (wgmma), P carried as two bf16 halves so the
  weighted sum keeps about 16 significant bits; counted in
  ``flash_attention.launches_tc``;
- f32 -> ``csrc/flash_attention.cu``: CUDA-core f32 FMAs; counted in
  ``flash_attention.launches_f32``.

``flash_attention.launches`` is their sum. Every route keeps the TPU
kernel's numerics: scores, softmax and the weighted sum in f32, masked
scores at −1e30, the output in q's type. Unlike the TPU kernel any S is
allowed (the ragged last tile is masked) and an optional logit soft-cap is
applied as the reference model's ``_attend_block`` does.

Inputs are (B, heads, S, hd) with hd contiguous; other strides are free
(for bf16 they must be multiples of 8 elements on a 16-byte aligned base,
the TMA descriptors' rule; the wrapper raises otherwise), so a transposed
view of the model's (B, S, heads, hd) activations goes in without a copy.
The output is (B, H, S, hd), laid out in memory as (B, S, H, hd), which is
the model's layout.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)
NEG_INF = -1e30
# the route of each input type: (library, entry point, launch counter)
ROUTES = {torch.bfloat16: ("flash_attention_wgmma", "flash_attention_wgmma_fwd", "launches_tc"),
          torch.float32: ("flash_attention", "flash_attention_fwd", "launches_f32")}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
TMA_ALIGN = 16   # bytes: the TMA descriptors' rule for strides and base addresses
PLAIN_Q_BLOCK = 256   # the plain version's query rows per step (bounds memory)


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, H, S, hd), k and v (B, KV, S, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    KV = k.shape[1]
    if KV == 0 or H % KV:
        raise ValueError(f"query heads {H} must be a multiple of KV heads {KV}")
    return B, H, KV, S, hd


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale=None, softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: q (B, H, S, hd), k, v (B, KV, S, hd) -> (B, H,
    S, hd) in q's type. Query blocks of ``PLAIN_Q_BLOCK`` rows against the
    keys they can see, each with a full f32 softmax (the kernel's function;
    its online softmax differs only by rounding)."""
    B, H, KV, S, hd = _check_shapes(q, k, v)
    g = H // KV
    scale = float(scale if scale is not None else 1.0 / math.sqrt(hd))
    qf = q.float().reshape(B, KV, g, S, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    for q0 in range(0, S, PLAIN_Q_BLOCK):
        q1 = min(S, q0 + PLAIN_Q_BLOCK)
        lo = max(0, q0 - window + 1) if window else 0
        hi = q1 if causal else S
        s = torch.einsum("bngqd,bnkd->bngqk", qf[:, :, :, q0:q1], kf[:, :, lo:hi]) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= cols <= rows
        if window:
            mask &= cols > rows - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bngqk,bnkd->bngqd", p, vf[:, :, lo:hi])
        out[:, q0:q1] = o.reshape(B, H, q1 - q0, hd).transpose(1, 2).to(q.dtype)
    return out.transpose(1, 2)


def _tma_strides(t: torch.Tensor, name: str):
    """(batch, head, sequence) element strides of a bf16 (B, heads, S, hd)
    tensor for a TMA descriptor: each a multiple of 16 bytes, on a 16-byte
    aligned base. An axis of size 1 is never stepped, so its stride is
    replaced by a legal one; any other stride that breaks the rule raises."""
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"{name} must start on a {TMA_ALIGN}-byte boundary for the "
                         "bf16 kernel's TMA loads")
    step = TMA_ALIGN // t.element_size()
    out = []
    for size, stride in zip(t.shape[:3], t.stride()[:3]):
        if size == 1:
            stride = step
        elif stride % step:
            raise ValueError(f"{name}'s strides {tuple(t.stride())} must be multiples of "
                             f"{step} elements for the bf16 kernel's TMA loads")
        out.append(stride)
    return out


def _launch(q, k, v, causal: bool, window: int, scale: float, softcap: float) -> torch.Tensor:
    """The kernel of q's type on (B, H, S, hd) tensors; returns o."""
    B, H, KV, S, hd = _check_shapes(q, k, v)
    lib, entry, counter = ROUTES[q.dtype]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        strides = [s for t, n in ((q, "q"), (k, "k"), (v, "v")) for s in _tma_strides(t, n)]
    else:
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    strides += out.stride()[:3]
    fn = getattr(build.load(lib, {entry: _ARGTYPES}), entry)
    err = build.on_device(q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides, B, H, KV, S, hd,
        int(causal), int(window), scale, float(softcap), stream))
    if err != 0:
        raise RuntimeError(f"{entry} failed: error {err}")
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, scale=None,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd), H a multiple of KV; f32 or
    bf16 -> (B, H, S, hd) in q's type. Query head h reads KV head h // (H//KV)."""
    B, H, KV, S, hd = _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous head_dim")
    scale = float(scale if scale is not None else 1.0 / math.sqrt(hd))
    return _launch(q, k, v, causal, window, scale, softcap)


# kernel launches, for chip_smoke's path check: by route, and their sum
flash_attention.launches = flash_attention.launches_tc = flash_attention.launches_f32 = 0
