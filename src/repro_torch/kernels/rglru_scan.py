"""The RG-LRU linear recurrence — port of ``repro/kernels/rglru_scan.py``.

    h_t = a_t · h_{t-1} + b_t,  h_{-1} = h0 (zeros if absent)

``rglru_scan`` launches the hand-written CUDA kernel (``csrc/rglru_scan.cu``)
for CUDA tensors and takes the plain PyTorch version beside it only for
CPU tensors; any other device raises. On the card a call under grad with
an input that requires it goes through ``RglruScanFn``, whose backward is
the kernel's reverse scan (``rglru_scan_bwd_f32``, counted in
``rglru_scan.launches_bwd``); without grad the forward launches alone, as
serving calls it. Kernel and plain version compute ``a·h`` and then
``+ b`` (and the backward's products and sums) with a rounding each, so on
the card they agree bit for bit; the reference model's
``associative_scan`` rounds in another order (rtol 1e-5).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.obs.profile import kernel_scope

_ENTRIES = {"rglru_scan_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            "rglru_scan_bwd_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}


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


def rglru_scan_bwd_plain(a: torch.Tensor, out: torch.Tensor, h0: Optional[torch.Tensor],
                         dout: torch.Tensor, dh_last: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the gradient: a reverse loop over time from
    the forward's ``out`` -> (da, db, dh0), f32. dh_t = dout_t + a_{t+1}·dh_{t+1}
    (dh_last joins at the last step), db = dh, da_t = dh_t·h_{t-1} with
    h_{-1} = h0 or 0, dh0 = a_0·dh_0."""
    B, S, C = a.shape
    a, out, dout = a.float(), out.float(), dout.float()
    carry = (torch.zeros((B, C), dtype=torch.float32, device=a.device) if dh_last is None
             else dh_last.float())
    h_init = (torch.zeros((B, C), dtype=torch.float32, device=a.device) if h0 is None
              else h0.float())
    da, db = torch.empty_like(out), torch.empty_like(out)
    for t in range(S - 1, -1, -1):
        dh = dout[:, t] + carry
        db[:, t] = dh
        da[:, t] = dh * (out[:, t - 1] if t > 0 else h_init)
        carry = a[:, t] * dh
    return da, db, carry


def _forward(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor],
             share: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on checked (B, S, C) tensors -> (out, h_last). A decode
    step (S = 1) without grad (``share``) makes one allocation, h_last a
    view beside out: the model only reads both. Otherwise h_last is
    allocated apart, so a cache that keeps h_last does not keep the whole of
    out alive, and autograd sees two outputs of their own."""
    B, S, C = a.shape
    if S == 1 and share:
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


@kernel_scope("kernels.rglru_scan_bwd")
def _backward(a, out, h0, dout, dh_last):
    """The backward kernel on the forward's tensors -> (da, db, dh0); dout
    or dh_last None where that output took no gradient."""
    B, S, C = a.shape
    if dout is None:
        dout = torch.zeros_like(out)
    dout = dout.float().contiguous()
    if dh_last is not None:
        dh_last = dh_last.float().contiguous()
    da, db = torch.empty_like(out), torch.empty_like(out)
    dh0 = torch.empty((B, C), dtype=torch.float32, device=a.device)
    if B == 0 or C == 0:
        return da, db, dh0
    fn = build.load("rglru_scan", _ENTRIES).rglru_scan_bwd_f32
    args = (a.data_ptr(), out.data_ptr(), None if h0 is None else h0.data_ptr(),
            dout.data_ptr(), None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
            db.data_ptr(), dh0.data_ptr(), B, S, C)
    err = build.on_device(a.device, lambda stream: fn(*args, stream))
    if err != 0:
        raise RuntimeError(f"rglru_scan backward kernel launch failed: CUDA error {err}")
    rglru_scan.launches_bwd += 1
    return da, db, dh0


class RglruScanFn(torch.autograd.Function):
    """The scan with its hand-written backward: a, h0 and the forward's
    ``out`` are saved (the reverse scan reads h_{t-1} from it)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        out, h_last = _forward(a, b, h0, share=False)
        ctx.save_for_backward(a, out, h0)
        ctx.set_materialize_grads(False)
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        a, out, h0 = ctx.saved_tensors
        da, db, dh0 = _backward(a, out, h0, dout, dh_last)
        return da, db, dh0 if ctx.needs_input_grad[2] else None


def _launch(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels on checked (B, S, C) tensors: through ``RglruScanFn``
    where a gradient is wanted, else the forward alone."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (a, b, h0)):
        return RglruScanFn.apply(a, b, h0)
    return _forward(a, b, h0)


@kernel_scope("kernels.rglru_scan")
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


# kernel launches, for chip_smoke's path check: the forward's and the backward's
rglru_scan.launches = rglru_scan.launches_bwd = 0
