"""The ONU aggregation function (AF): masked weighted reduction over a
stacked client axis, per segment — port of ``repro/kernels/agg_reduce.py``.

    out[s, n] = Σ_{c : seg[c] == s}  wm[c] · x[c, n]        wm = weight · mask

``segment_agg_reduce`` launches the hand-written CUDA kernel
(``csrc/agg_reduce.cu``) for a CUDA tensor and takes the plain PyTorch
version beside it only for a CPU tensor; any other device raises.
``agg_reduce`` is the TPU kernel's own signature, the single-segment case.

``segment_agg_reduce_quant`` is the fused aggregate + quantize of the
compressed uplink (the Pallas ``agg_reduce_quant``, per segment): pass A
is the same kernel, which also records each (segment, block) max|θ| while
θ is in registers; a tiny torch reduction turns those into one scale per
segment; pass B is the quantize kernel of ``kernels/quantize.py``.

Segment ids arrive unsorted, in selection order; the wrapper turns them
into a stable row permutation plus segment offsets (a CSR) on the host,
so each segment sums its rows in a fixed order and results repeat
bit for bit. The CSR goes to the card through pinned memory, copied on
the current stream without blocking the host. One segment (classical
FedAvg, ``agg_reduce``) needs no CSR: the kernel takes its rows in order,
so such a call builds and copies no table.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.quantize import (launch_quantize, qmax_of,
                                          quantize_rows_plain)

MAX_ROWS = 4096        # the kernel stages the CSR in shared memory
MAX_SEGMENTS = 2048
_DTYPES = {torch.float32: "segment_agg_reduce_f32",
           torch.bfloat16: "segment_agg_reduce_bf16"}
# x, wm, csr, C, n_seg, N, out, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                          ctypes.c_void_p, ctypes.c_void_p]
_ABSMAX_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_ENTRIES = {**{name: _ARGTYPES for name in _DTYPES.values()},
            **{name.replace("reduce", "reduce_absmax"): _ABSMAX_ARGTYPES
               for name in _DTYPES.values()}}
# pass A's grid, fixed up front so the (n_seg, blocks) absmax buffer is
# known: one block per 1024 columns (256 threads × 4), at most 16,384
ABSMAX_COLS_PER_BLOCK, ABSMAX_MAX_BLOCKS = 1024, 1 << 14


def _segments(seg_ids, n_rows: int, n_seg: int) -> np.ndarray:
    seg = (seg_ids.detach().cpu().numpy() if isinstance(seg_ids, torch.Tensor)
           else np.asarray(seg_ids))
    if seg.shape != (n_rows,) or (n_rows and seg.dtype.kind not in "iu"):
        raise ValueError(f"seg_ids must be ({n_rows},) integers, got "
                         f"{seg.shape} {seg.dtype}")
    # one segment: every id is 0 (one reduction where the range takes two)
    if n_rows and (seg.any() if n_seg == 1 else seg.min() < 0 or seg.max() >= n_seg):
        raise ValueError(f"seg_ids must lie in [0, {n_seg})")
    return seg.astype(np.int64, copy=False)


def segment_agg_reduce_plain(x: torch.Tensor, wm: torch.Tensor, seg_ids,
                             n_seg: int) -> torch.Tensor:
    """Plain PyTorch version: (C, N), (C,), (C,) ints -> (n_seg, N) f32."""
    seg = torch.as_tensor(_segments(seg_ids, x.shape[0], n_seg), device=x.device)
    out = torch.zeros((n_seg, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, seg, wm.float()[:, None] * x.float())


def _check(x: torch.Tensor, wm: torch.Tensor, seg_ids, n_seg: int) -> np.ndarray:
    """Validate a CUDA launch; returns the host segment ids."""
    C = x.shape[0]
    seg = _segments(seg_ids, C, n_seg)
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if wm.dtype != torch.float32 or wm.device != x.device:
        raise TypeError(f"wm must be float32 on {x.device}, got {wm.dtype} on {wm.device}")
    if not (x.is_contiguous() and wm.is_contiguous()):
        raise ValueError("x and wm must be contiguous")
    if C > MAX_ROWS or n_seg > MAX_SEGMENTS:
        raise ValueError(f"kernel takes C <= {MAX_ROWS} and n_seg <= "
                         f"{MAX_SEGMENTS}, got C={C}, n_seg={n_seg}")
    return seg


def _on_card(name: str, x: torch.Tensor, wm: torch.Tensor) -> bool:
    if x.ndim != 2 or wm.shape != (x.shape[0],):
        raise ValueError(f"want x (C, N) and wm (C,), got {tuple(x.shape)} "
                         f"and {tuple(wm.shape)}")
    kind = x.device.type
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def _upload(table: np.ndarray, device) -> torch.Tensor:
    """``table`` on ``device``, copied on the current stream from pinned
    memory without blocking the host; the caching host allocator keeps the
    pinned block until the copy has run."""
    return torch.from_numpy(table).pin_memory().to(device, non_blocking=True)


def _csr(seg: np.ndarray, n_seg: int) -> np.ndarray:
    """[rows (C,), offsets (n_seg + 1,)] int32: the stable row permutation
    grouped by segment and each segment's offsets into it."""
    offsets = np.zeros(n_seg + 1, np.int64)
    np.cumsum(np.bincount(seg, minlength=n_seg), out=offsets[1:])
    return np.concatenate([np.argsort(seg, kind="stable"), offsets]).astype(np.int32)


def _launch(x: torch.Tensor, wm: torch.Tensor, seg: np.ndarray, n_seg: int,
            amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the segmented kernel (with the absmax buffer when
    ``amax`` is given) on validated, non-empty CUDA inputs -> θ. One
    segment passes no table: the kernel's rows are then the identity."""
    C, N = x.shape
    csr = None
    if n_seg > 1:
        # read on the current stream: when ``table`` is freed, the caching
        # allocator hands its block only to work queued after the kernel
        table = _upload(_csr(seg, n_seg), x.device)
        csr = table.data_ptr()
    out = torch.empty((n_seg, N), dtype=torch.float32, device=x.device)
    entry = _DTYPES[x.dtype]
    args = [x.data_ptr(), wm.data_ptr(), csr, C, n_seg, N, out.data_ptr()]
    if amax is not None:
        entry = entry.replace("reduce", "reduce_absmax")
        args += [amax.data_ptr(), amax.shape[1]]
    fn = getattr(build.load("agg_reduce", _ENTRIES), entry)
    err = build.on_device(x.device, lambda stream: fn(*args, stream))
    if err != 0:
        raise RuntimeError(f"agg_reduce kernel launch failed: CUDA error {err}")
    return out


def segment_agg_reduce(x: torch.Tensor, wm: torch.Tensor, seg_ids,
                       n_seg: int) -> torch.Tensor:
    """x: (C, N) f32/bf16; wm: (C,) f32; seg_ids: (C,) ints in [0, n_seg)
    -> (n_seg, N) f32, the per-segment weighted sums."""
    if not _on_card("segment_agg_reduce", x, wm):
        return segment_agg_reduce_plain(x, wm, seg_ids, n_seg)
    seg = _check(x, wm, seg_ids, n_seg)
    C, N = x.shape
    if C == 0 or N == 0 or n_seg == 0:
        return torch.zeros((n_seg, N), dtype=torch.float32, device=x.device)
    out = _launch(x, wm, seg, n_seg)
    segment_agg_reduce.launches += 1
    return out


segment_agg_reduce.launches = 0   # kernel launches, for chip_smoke's path check


def agg_reduce(x: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
    """x: (C, N) f32/bf16; weights, mask: (C,) -> (N,) f32 = Σ_c w_c·m_c·x_c."""
    wm = (weights.float() * mask.float()).contiguous()
    return segment_agg_reduce(x, wm, np.zeros(x.shape[0], np.int64), 1)[0]


def segment_agg_reduce_absmax(x: torch.Tensor, wm: torch.Tensor, seg_ids,
                              n_seg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass A of the fused kernel, uncounted: CUDA x (C, N) non-empty ->
    (θ (n_seg, N) f32, bit for bit ``segment_agg_reduce``'s; amax (n_seg,
    blocks) f32, max|θ| of each segment over each block's columns). The
    block layout is the kernel's own, so there is no CPU version."""
    if not _on_card("segment_agg_reduce_absmax", x, wm):
        raise ValueError("segment_agg_reduce_absmax runs on cuda only; "
                         "segment_agg_reduce_quant has the CPU version")
    seg = _check(x, wm, seg_ids, n_seg)
    N = x.shape[1]
    blocks = min(max(1, -(-N // ABSMAX_COLS_PER_BLOCK)), ABSMAX_MAX_BLOCKS)
    amax = torch.empty((n_seg, blocks), dtype=torch.float32, device=x.device)
    return _launch(x, wm, seg, n_seg, amax), amax


def segment_agg_reduce_quant_plain(x: torch.Tensor, wm: torch.Tensor, seg_ids,
                                   n_seg: int, noise: torch.Tensor, bits: int = 8
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: segment sums, then per-row quantize."""
    qmax = qmax_of(bits)
    C, N = x.shape
    if C == 0 or N == 0:
        return (torch.zeros((n_seg, N), dtype=torch.int8, device=x.device),
                torch.ones(n_seg, device=x.device))
    theta = segment_agg_reduce_plain(x, wm, seg_ids, n_seg)
    scales = theta.abs().amax(dim=1).clamp_min(1e-12) / qmax
    return quantize_rows_plain(theta, noise, scales, qmax), scales


def segment_agg_reduce_quant(x: torch.Tensor, wm: torch.Tensor, seg_ids,
                             n_seg: int, noise: torch.Tensor, bits: int = 8
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused per-segment aggregate + stochastic-rounding quantize.

    x: (C, N) f32/bf16; wm: (C,) f32; seg_ids: (C,) ints in [0, n_seg);
    noise: (n_seg, N) f32 in [0, 1) -> (q int8 (n_seg, N), scales (n_seg,)
    f32), one scale max(max|θ_s|, 1e-12) / qmax per segment. C = 0 or
    N = 0 give zeros and scale 1.0 without a launch, as the TPU's guard.
    """
    on_card = _on_card("segment_agg_reduce_quant", x, wm)
    if noise.shape != (n_seg, x.shape[1]) or noise.dtype != torch.float32:
        raise ValueError(f"noise must be ({n_seg}, {x.shape[1]}) float32, got "
                         f"{tuple(noise.shape)} {noise.dtype}")
    if not on_card:
        return segment_agg_reduce_quant_plain(x, wm, seg_ids, n_seg, noise, bits)
    qmax = qmax_of(bits)
    C, N = x.shape
    if C == 0 or N == 0 or n_seg == 0:
        _check(x, wm, seg_ids, n_seg)
        return (torch.zeros((n_seg, N), dtype=torch.int8, device=x.device),
                torch.ones(n_seg, device=x.device))
    if noise.device != x.device or not noise.is_contiguous():
        raise ValueError(f"noise must be contiguous on {x.device}")
    theta, amax = segment_agg_reduce_absmax(x, wm, seg_ids, n_seg)
    # between the passes, as the TPU computes it in jnp between its two calls
    scales = amax.amax(dim=1).clamp_min(1e-12) / qmax
    q = launch_quantize(theta, noise, scales, qmax)
    segment_agg_reduce_quant.launches += 1
    return q, scales


segment_agg_reduce_quant.launches = 0


def agg_reduce_quant(x: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
                     noise: torch.Tensor, bits: int = 8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's signature: x (C, N), weights, mask (C,), noise (N,)
    -> (q int8 (N,), scale f32 0-d); ``noise`` replaces its ``key``."""
    wm = (weights.float() * mask.float()).contiguous()
    q, s = segment_agg_reduce_quant(x, wm, np.zeros(x.shape[0], np.int64), 1,
                                    noise.reshape(1, -1), bits)
    return q[0], s[0]
