"""Causal GQA flash attention (forward) — port of
``repro/kernels/flash_attention.py``.

    o[b, h, t] = softmax over the keys s ≤ t, s > t − window of
                 scale · q[b, h, t] · k[b, h // g, s], applied to v[b, h // g]

``flash_attention`` launches the hand-written CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors and takes the plain PyTorch
version beside it only for CPU tensors; any other device raises. Both
keep the TPU kernel's numerics: scores, softmax and the weighted sum in
f32, masked scores at −1e30, the output in q's type. Unlike the TPU
kernel any S is allowed (the ragged last tile is masked) and an optional
logit soft-cap is applied as the reference model's ``_attend_block`` does.

Inputs are (B, heads, S, hd) with hd contiguous; other strides are free,
so a transposed view of the model's (B, S, heads, hd) activations goes in
without a copy. The output is (B, H, S, hd), laid out in memory as
(B, S, H, hd), which is the model's layout.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous head_dim")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    scale = float(scale if scale is not None else 1.0 / math.sqrt(hd))
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), *strides, B, H, KV, S, hd, int(causal), int(window),
                 scale, float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # kernel launches, for chip_smoke's path check
