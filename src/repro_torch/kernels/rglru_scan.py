"""The RG-LRU linear recurrence — port of ``repro/kernels/rglru_scan.py``.

    h_t = a_t · h_{t-1} + b_t,  h_{-1} = h0 (zeros if absent)

``rglru_scan`` launches the hand-written CUDA kernel (``csrc/rglru_scan.cu``)
for CUDA tensors and takes the plain PyTorch version beside it only for
CPU tensors; any other device raises. The kernel is forward only: on the
card a call under grad with an input that requires it raises. Both
compute ``a·h`` and then ``+ b`` with a rounding each, so on the card they
agree bit for bit; the reference model's ``associative_scan`` rounds in
another order (rtol 1e-5).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_ENTRIES = {"rglru_scan_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}


def _check(a, b, h0):
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"want a, b (B, S, C); got {tuple(a.shape)}, {tuple(b.shape)}")
    if h0 is not None and h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be (B, C) = {(a.shape[0], a.shape[2])}, got "
                         f"{tuple(h0.shape)}")


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a loop over time, f32."""
    _check(a, b, h0)
    B, S, C = a.shape
    a, b = a.float(), b.float()
    h = (torch.zeros((B, C), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    out = torch.empty((B, S, C), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h.clone()


def _launch(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on checked (B, S, C) tensors -> (out, h_last). A decode
    step (S = 1) makes one allocation, h_last a view beside out: the model
    only reads both. A longer scan allocates h_last apart, so a cache that
    keeps h_last does not keep the whole of out alive. Forward only: raises
    where a gradient is wanted."""
    build.refuse_grad("rglru_scan", a, b, h0)
    B, S, C = a.shape
    if S == 1:
        both = torch.empty((2, B, C), dtype=torch.float32, device=a.device)
        out, h_last = both[0].unsqueeze(1), both[1]
    else:
        out = torch.empty((B, S, C), dtype=torch.float32, device=a.device)
        h_last = torch.empty((B, C), dtype=torch.float32, device=a.device)
    if B == 0 or C == 0:
        return out, h_last
    fn = build.load("rglru_scan", _ENTRIES).rglru_scan_f32
    args = (a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), h_last.data_ptr(), B, S, C)
    err = build.on_device(a.device, lambda stream: fn(*args, stream))
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return out, h_last


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, C) f32; h0: (B, C) f32 or None -> (out (B, S, C), h_last
    (B, C)), both f32."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {a.device}")
    ins = (a, b) if h0 is None else (a, b, h0)
    if any(t.dtype != torch.float32 or t.device != a.device or not t.is_contiguous()
           for t in ins):
        raise TypeError("a, b and h0 must be contiguous float32 on one device")
    return _launch(a, b, h0)


rglru_scan.launches = 0   # kernel launches, for chip_smoke's path check
