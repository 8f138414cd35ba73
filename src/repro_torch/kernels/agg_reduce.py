"""The ONU aggregation function (AF): masked weighted reduction over a
stacked client axis, per segment — port of ``repro/kernels/agg_reduce.py``.

    out[s, n] = Σ_{c : seg[c] == s}  wm[c] · x[c, n]        wm = weight · mask

``segment_agg_reduce`` launches the hand-written CUDA kernel
(``csrc/agg_reduce.cu``) for a CUDA tensor and takes the plain PyTorch
version beside it only for a CPU tensor; any other device raises.
``agg_reduce`` is the TPU kernel's own signature, the single-segment case.

Segment ids arrive unsorted, in selection order; the wrapper turns them
into a stable row permutation plus segment offsets (a CSR) on the host,
so each segment sums its rows in a fixed order and results repeat
bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

MAX_ROWS = 4096        # the kernel stages the CSR in 48 KB of shared memory
MAX_SEGMENTS = 2048
_DTYPES = {torch.float32: "segment_agg_reduce_f32",
           torch.bfloat16: "segment_agg_reduce_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_void_p]


def _segments(seg_ids, n_rows: int, n_seg: int) -> np.ndarray:
    seg = (seg_ids.detach().cpu().numpy() if isinstance(seg_ids, torch.Tensor)
           else np.asarray(seg_ids))
    if seg.shape != (n_rows,) or (n_rows and seg.dtype.kind not in "iu"):
        raise ValueError(f"seg_ids must be ({n_rows},) integers, got "
                         f"{seg.shape} {seg.dtype}")
    if n_rows and (seg.min() < 0 or seg.max() >= n_seg):
        raise ValueError(f"seg_ids must lie in [0, {n_seg})")
    return seg.astype(np.int64)


def segment_agg_reduce_plain(x: torch.Tensor, wm: torch.Tensor, seg_ids,
                             n_seg: int) -> torch.Tensor:
    """Plain PyTorch version: (C, N), (C,), (C,) ints -> (n_seg, N) f32."""
    seg = torch.as_tensor(_segments(seg_ids, x.shape[0], n_seg), device=x.device)
    out = torch.zeros((n_seg, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, seg, wm.float()[:, None] * x.float())


def segment_agg_reduce(x: torch.Tensor, wm: torch.Tensor, seg_ids,
                       n_seg: int) -> torch.Tensor:
    """x: (C, N) f32/bf16; wm: (C,) f32; seg_ids: (C,) ints in [0, n_seg)
    -> (n_seg, N) f32, the per-segment weighted sums."""
    if x.ndim != 2 or wm.shape != (x.shape[0],):
        raise ValueError(f"want x (C, N) and wm (C,), got {tuple(x.shape)} "
                         f"and {tuple(wm.shape)}")
    if x.device.type == "cpu":
        return segment_agg_reduce_plain(x, wm, seg_ids, n_seg)
    if x.device.type != "cuda":
        raise ValueError(f"segment_agg_reduce runs on cuda or cpu, not {x.device}")
    C, N = x.shape
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
    if C == 0 or N == 0 or n_seg == 0:
        return torch.zeros((n_seg, N), dtype=torch.float32, device=x.device)
    rows = np.argsort(seg, kind="stable")
    offsets = np.zeros(n_seg + 1, np.int64)
    np.cumsum(np.bincount(seg, minlength=n_seg), out=offsets[1:])
    # copied and read on the current stream: when ``table`` is freed, the
    # caching allocator hands its block only to work queued after the kernel
    table = torch.from_numpy(np.concatenate([rows, offsets]).astype(np.int32)
                             ).to(x.device)
    out = torch.empty((n_seg, N), dtype=torch.float32, device=x.device)
    fn = getattr(build.load("agg_reduce"), _DTYPES[x.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wm.data_ptr(), table.data_ptr(),
                 table.data_ptr() + 4 * C, C, n_seg, N, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"agg_reduce kernel launch failed: CUDA error {err}")
    segment_agg_reduce.launches += 1
    return out


segment_agg_reduce.launches = 0   # kernel launches, for chip_smoke's path check


def agg_reduce(x: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
    """x: (C, N) f32/bf16; weights, mask: (C,) -> (N,) f32 = Σ_c w_c·m_c·x_c."""
    wm = (weights.float() * mask.float()).contiguous()
    return segment_agg_reduce(x, wm, np.zeros(x.shape[0], np.int64), 1)[0]
