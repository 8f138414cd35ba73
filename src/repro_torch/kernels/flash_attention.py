"""Causal GQA flash attention and its gradient — port of
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

Training. Where grad is enabled and an input requires it, the call goes
through ``FlashAttentionFn``: the forward kernel also writes each row's
log-sum-exp, and the backward runs ``csrc/flash_attention_bwd.cu`` (D =
rowsum(dO ∘ O), then dK and dV, then dQ: three launches), routed
explicitly too:

- bf16 -> the tensor cores (wgmma on a TMA-fed ring, P and dS as bf16 hi +
  lo halves; at hd = 256 a block's two warpgroups split the head's
  columns); counted in ``flash_attention.launches_bwd_tc``;
- f32 -> CUDA-core f32 FMAs; counted in ``flash_attention.launches_bwd_fma``;

``flash_attention.launches_bwd`` is their sum. The TPU kernel has no
backward (the reference differentiates its jnp attention);
``flash_attention_bwd_plain`` is the plain version of this one. Otherwise
(serving, ``torch.no_grad``) no log-sum-exp is written and nothing is
saved.

Inputs are (B, heads, S, hd) with hd contiguous; other strides are free
(for bf16 they must be multiples of 8 elements on a 16-byte aligned base,
the TMA descriptors' rule; the wrapper raises otherwise), so a transposed
view of the model's (B, S, heads, hd) activations goes in without a copy.
The output and the gradients are (B, heads, S, hd), laid out in memory as
(B, S, heads, hd), which is the model's layout.

``flash_attention_cost`` and ``flash_attention_bwd_cost`` reckon a call's
work (``kernels.cost``) from the (query, key) pairs the causal window
admits. Under a counter each call reports it: on the card beside the
launches, on ``meta`` in place of any work, and on the CPU beside the
plain version, which then runs through ``FlashAttentionFn`` too (its
backward ``flash_attention_bwd_plain``), so every device reports the same
calls.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.cost import Work
from repro_torch.obs.profile import kernel_scope

HEAD_DIMS = (16, 32, 64, 128, 256)
NEG_INF = -1e30
# the route of each input type: (library, entry point, launch counter)
ROUTES = {torch.bfloat16: ("flash_attention_wgmma", "flash_attention_wgmma_fwd", "launches_tc"),
          torch.float32: ("flash_attention", "flash_attention_fwd", "launches_f32")}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# the backward's library: D = rowsum(dO ∘ O) beside lse·log2(e), both
# (B, H, S) with S padded to BWD_ROW_PAD, then dK and dV, then dQ; the route
# code the last two take, by input type and head_dim
TC_BWD_MAX_HEAD_DIM = 256
BWD_ROW_PAD = 64
_BWD_ROUTE_F32, _BWD_ROUTE_TC = 0, 2
_BWD_PASSES = ("flash_attention_bwd_prep", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
_BWD_ENTRIES = {
    "flash_attention_bwd_prep": ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6
                                 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    **dict.fromkeys(_BWD_PASSES[1:], [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 21
                    + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                    + [ctypes.c_int, ctypes.c_void_p])}
TMA_ALIGN = 16   # bytes: the TMA descriptors' rule for strides and base addresses
PLAIN_Q_BLOCK = 256   # the plain version's query rows per step (bounds memory)


def visible_pairs(S: int, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs the causal window admits: the attention's work."""
    if not causal:
        return S * S
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_attention_cost(B: int, H: int, KV: int, S: int, hd: int, dtype: torch.dtype,
                         window: int = 0, causal: bool = True, with_lse: bool = False
                         ) -> Work:
    """q, k, v read once and o (and the rows' f32 log-sum-exp) written
    once; 4·hd flops a visible pair (QKᵀ and P·V), on the tensor cores in
    bf16, the CUDA cores in f32."""
    size = dtype.itemsize
    return Work({cost.work_type(dtype): 4 * B * H * hd * visible_pairs(S, window, causal)},
                size * (B * H * S * hd + 2 * B * KV * S * hd),
                size * B * H * S * hd + 4 * B * H * S * with_lse)


def flash_attention_bwd_cost(B: int, H: int, KV: int, S: int, hd: int, dtype: torch.dtype,
                             window: int = 0, causal: bool = True) -> Work:
    """q, k, v, o, dO and the rows' log-sum-exp read once, dq, dk, dv
    written once; 10·hd flops a visible pair (QKᵀ, dO·Vᵀ, Pᵀ·dO, dS·K,
    dSᵀ·Q)."""
    size = dtype.itemsize
    return Work({cost.work_type(dtype): 10 * hd * B * H * visible_pairs(S, window, causal)},
                size * (3 * B * H * S * hd + 2 * B * KV * S * hd) + 4 * B * H * S,
                size * (B * H * S * hd + 2 * B * KV * S * hd))


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


def _scores(qf, kf, q0, q1, lo, hi, causal, window, scale, softcap):
    """Scaled (and soft-capped) f32 scores of queries q0..q1 against keys
    lo..hi, (B, KV, g, q1 − q0, hi − lo), their pre-cap tanh (or None), and
    the mask of the pairs the causal window admits."""
    s = torch.einsum("bngqd,bnkd->bngqk", qf[:, :, :, q0:q1], kf[:, :, lo:hi]) * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    rows = torch.arange(q0, q1, device=qf.device)[:, None]
    cols = torch.arange(lo, hi, device=qf.device)[None, :]
    mask = torch.ones((q1 - q0, hi - lo), dtype=torch.bool, device=qf.device)
    if causal:
        mask &= cols <= rows
    if window:
        mask &= cols > rows - window
    return s, t, mask


def _key_range(q0, q1, S, causal, window):
    return (max(0, q0 - window + 1) if window else 0), (q1 if causal else S)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale=None, softcap: float = 0.0, return_lse: bool = False):
    """Plain PyTorch version: q (B, H, S, hd), k, v (B, KV, S, hd) -> (B, H,
    S, hd) in q's type. Query blocks of ``PLAIN_Q_BLOCK`` rows against the
    keys they can see, each with a full f32 softmax (the kernel's function;
    its online softmax differs only by rounding). ``return_lse`` also
    returns each row's f32 log-sum-exp (B, H, S), the forward kernels'
    training output."""
    B, H, KV, S, hd = _check_shapes(q, k, v)
    g = H // KV
    scale = float(scale if scale is not None else 1.0 / math.sqrt(hd))
    qf = q.float().reshape(B, KV, g, S, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, PLAIN_Q_BLOCK):
        q1 = min(S, q0 + PLAIN_Q_BLOCK)
        lo, hi = _key_range(q0, q1, S, causal, window)
        s, _, mask = _scores(qf, kf, q0, q1, lo, hi, causal, window, scale, softcap)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        if return_lse:
            lse[:, :, q0:q1] = torch.logsumexp(s, dim=-1).reshape(B, H, q1 - q0)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bngqk,bnkd->bngqd", p, vf[:, :, lo:hi])
        out[:, q0:q1] = o.reshape(B, H, q1 - q0, hd).transpose(1, 2).to(q.dtype)
    out = out.transpose(1, 2)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                              scale=None, softcap: float = 0.0):
    """Plain PyTorch version of the backward kernel, step by step: from the
    forward's output ``o`` and log-sum-exp ``lse`` (B, H, S) and the output
    gradient ``do``, returns (dq, dk, dv) in the inputs' type. Per query
    block: P = exp(x − lse) on the visible pairs, dS = P ∘ (dO·Vᵀ − D) with
    D = rowsum(dO ∘ O) (times 1 − tanh² under a soft-cap), dV += Pᵀ·dO,
    dK += scale · dSᵀ·Q, dQ = scale · dS·K, all in f32; a GQA group's heads
    sum into their KV head."""
    B, H, KV, S, hd = _check_shapes(q, k, v)
    g = H // KV
    scale = float(scale if scale is not None else 1.0 / math.sqrt(hd))
    qf = q.float().reshape(B, KV, g, S, hd)
    dof = do.float().reshape(B, KV, g, S, hd)
    kf, vf = k.float(), v.float()
    D = (do.float() * o.float()).sum(-1).reshape(B, KV, g, S)
    L = lse.float().reshape(B, KV, g, S)
    dq = torch.empty((B, KV, g, S, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, KV, S, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, KV, S, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, PLAIN_Q_BLOCK):
        q1 = min(S, q0 + PLAIN_Q_BLOCK)
        lo, hi = _key_range(q0, q1, S, causal, window)
        s, t, mask = _scores(qf, kf, q0, q1, lo, hi, causal, window, scale, softcap)
        p = torch.where(mask, torch.exp(s - L[..., q0:q1, None]), torch.zeros_like(s))
        dp = torch.einsum("bngqd,bnkd->bngqk", dof[:, :, :, q0:q1], vf[:, :, lo:hi])
        ds = p * (dp - D[..., q0:q1, None])
        if t is not None:
            ds = ds * (1.0 - t * t)
        dv[:, :, lo:hi] += torch.einsum("bngqk,bngqd->bnkd", p, dof[:, :, :, q0:q1])
        dk[:, :, lo:hi] += scale * torch.einsum("bngqk,bngqd->bnkd", ds, qf[:, :, :, q0:q1])
        dq[:, :, :, q0:q1] = scale * torch.einsum("bngqk,bnkd->bngqd", ds, kf[:, :, lo:hi])
    return dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _tma_ok(t: torch.Tensor) -> bool:
    """Whether ``t`` meets ``_tma_strides``'s rule."""
    try:
        _tma_strides(t, "dO")
    except ValueError:
        return False
    return True


def _model_layout(B, heads, S, hd, like):
    """An empty (B, heads, S, hd) tensor laid out as (B, S, heads, hd)."""
    return torch.empty((B, S, heads, hd), dtype=like.dtype, device=like.device).transpose(1, 2)


def _forward(q, k, v, causal: bool, window: int, scale: float, softcap: float,
             with_lse: bool):
    """The forward kernel of q's type on (B, H, S, hd) tensors -> (o, lse);
    lse is (B, H, S) f32 when ``with_lse``, else None (no pointer passed)."""
    B, H, KV, S, hd = _check_shapes(q, k, v)
    work = lambda: flash_attention_cost(B, H, KV, S, hd, q.dtype, window, causal,   # noqa: E731
                                        with_lse)
    if q.device.type == "cpu" and cost.counting():
        out = flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                                    softcap=softcap, return_lse=with_lse)
        cost.report("flash_attention", work)
        return out if with_lse else (out, None)
    lib, entry, counter = ROUTES[q.dtype]
    out = _model_layout(B, H, S, hd, q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse
           else None)
    if out.numel() == 0:
        return out, lse
    if q.dtype == torch.bfloat16:
        strides = [s for t, n in ((q, "q"), (k, "k"), (v, "v")) for s in _tma_strides(t, n)]
    else:
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    strides += out.stride()[:3]
    cost.report("flash_attention", work)
    if q.device.type == "meta":
        return out, lse
    fn = getattr(build.load(lib, {entry: _ARGTYPES}), entry)
    err = build.on_device(q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), *strides, B, H, KV, S, hd,
        int(causal), int(window), scale, float(softcap), stream))
    if err != 0:
        raise RuntimeError(f"{entry} failed: error {err}")
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    flash_attention.launches += 1
    return out, lse


@kernel_scope("kernels.flash_attention_bwd")
@cost.quiet
def _backward(q, k, v, o, lse, do, causal: bool, window: int, scale: float, softcap: float):
    """The backward kernel's three launches -> (dq, dk, dv) in q's type; on
    the CPU (under a counter) ``flash_attention_bwd_plain``."""
    B, H, KV, S, hd = _check_shapes(q, k, v)
    work = lambda: flash_attention_bwd_cost(B, H, KV, S, hd, q.dtype, window,   # noqa: E731
                                            causal)
    if q.device.type == "cpu" and cost.counting():
        grads = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window,
                                          scale=scale, softcap=softcap)
        cost.report("flash_attention_bwd", work, launches=3)
        # in the kernel's layout, so the operators downstream see its strides
        return tuple(_model_layout(B, n, S, hd, q).copy_(g) for n, g in zip((H, KV, KV), grads))
    if do.dtype != q.dtype or do.shape != o.shape:
        raise TypeError(f"dO must be {q.dtype} {tuple(o.shape)}, got {do.dtype} "
                        f"{tuple(do.shape)}")
    bf16 = q.dtype == torch.bfloat16
    tc = bf16 and hd <= TC_BWD_MAX_HEAD_DIM
    if do.stride(-1) != 1 or (tc and not _tma_ok(do)):
        do = do.contiguous()
    route = _BWD_ROUTE_TC if tc else _BWD_ROUTE_F32
    dq, dk, dv = (_model_layout(B, n, S, hd, q) for n in (H, KV, KV))
    if dq.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if tc:   # q, k, v and dO through TMA descriptors: the forward's rule
        strides = [s for t, n in ((q, "q"), (k, "k"), (v, "v"), (do, "dO"))
                   for s in _tma_strides(t, n)]
    else:
        strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
    strides += [s for t in (dq, dk, dv) for s in t.stride()[:3]]
    Sp = -(-S // BWD_ROW_PAD) * BWD_ROW_PAD
    L, D = torch.empty((2, B, H, Sp), dtype=torch.float32, device=q.device)
    lse = lse.contiguous()
    calls = (
        (o.data_ptr(), do.data_ptr(), lse.data_ptr(), L.data_ptr(), D.data_ptr(),
         *o.stride()[:3], *do.stride()[:3], B, H, S, hd, int(bf16)),
        *[(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), L.data_ptr(),
           D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides,
           B, H, KV, S, hd, int(causal), int(window), scale, float(softcap), route)] * 2)
    counter = "launches_bwd_tc" if tc else "launches_bwd_fma"
    cost.report("flash_attention_bwd", work, launches=len(calls))
    if q.device.type == "meta":
        return dq, dk, dv
    lib = build.load("flash_attention_bwd", _BWD_ENTRIES)
    for entry, args in zip(_BWD_PASSES, calls):
        fn = getattr(lib, entry)
        err = build.on_device(q.device, lambda stream: fn(*args, stream))
        if err != 0:
            raise RuntimeError(f"{entry} failed: error {err}")
        setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
        flash_attention.launches_bwd += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its hand-written backward: the forward kernel
    writes the rows' log-sum-exp, and q, k, v, o and it are saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, softcap):
        o, lse = _forward(q, k, v, causal, window, scale, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attention = (causal, window, scale, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, *ctx.attention)
        return dq, dk, dv, None, None, None, None


def _launch(q, k, v, causal: bool, window: int, scale: float, softcap: float) -> torch.Tensor:
    """The kernels on checked (B, H, S, hd) tensors: through
    ``FlashAttentionFn`` where a gradient is wanted, else the forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale, softcap)
    return _forward(q, k, v, causal, window, scale, softcap, with_lse=False)[0]


@kernel_scope("kernels.flash_attention")
@cost.quiet
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, scale=None,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd), H a multiple of KV; f32 or
    bf16 -> (B, H, S, hd) in q's type. Query head h reads KV head h // (H//KV)."""
    B, H, KV, S, hd = _check_shapes(q, k, v)
    if cost.device_kind("flash_attention", q) == "cpu":
        if cost.counting():
            return _launch(q, k, v, causal, window,
                           float(scale if scale is not None else 1.0 / math.sqrt(hd)), softcap)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, softcap=softcap)
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


# kernel launches, for chip_smoke's path check: the forward by route and
# their sum, the backward's (three a call) by route and their sum
flash_attention.launches = flash_attention.launches_tc = flash_attention.launches_f32 = 0
flash_attention.launches_bwd = flash_attention.launches_bwd_tc = 0
flash_attention.launches_bwd_fma = 0
