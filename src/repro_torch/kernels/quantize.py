"""The compressed uplink's kernels, one scale or threshold per row of a
stacked (R, N) leaf — port of ``repro/kernels/quantize.py``:

    quantize_rows    q = clip(rint(x / s_r + (u − ½)), ±qmax)   int8
    dequantize_rows  x̂ = (float(q) · s_r) · m_r
    topk_mask_rows   y = (|x| ≥ t_r ? x : 0) · m_r

Each wrapper launches the hand-written CUDA kernel (``csrc/quantize.cu``)
for a CUDA tensor and takes the plain PyTorch version beside it only for a
CPU tensor; any other device raises. The uniform noise ``u``, the scales
and the thresholds come from the caller, as the TPU wrappers compute them
outside the Pallas kernel; ``m`` is an optional row mask (0 = the row
transmits nothing). Given the same noise, kernel, plain version and the
reference are bit-identical.

The TPU kernels' own signatures (one vector, one scale: ``quantize_intb``,
``dequantize_int8``, ``topk_mask``, ``topk_sparsify``) are the
single-row case. int4 values travel unpacked (int8 in [-7, 7]);
``pack_int4``/``unpack_int4`` are the wire layout, plain torch as they
are jnp in the reference.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.obs.profile import kernel_scope

MAX_ROWS = 65535      # rows ride the grid's y dimension
_INPUT_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _F, _I, _L = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong


def qmax_of(bits: int) -> float:
    """Symmetric integer range: 127 for int8, 7 for int4."""
    if bits not in (4, 8):
        raise ValueError(f"unsupported quantization width: {bits} bits")
    return float(2 ** (bits - 1) - 1)


def _quantize_intb_name(x, noise, bits: int) -> str:
    """The profiler range of a quantize call: the reference's names."""
    return f"kernels.quantize_int{bits}"


def _quantize_name(x, noise, scales, qmax: float) -> str:
    return _quantize_intb_name(x, noise, int(qmax).bit_length() + 1)


def _on_card(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def _check_rows(name: str, x: torch.Tensor, dtypes, *row_args) -> None:
    if x.ndim != 2:
        raise ValueError(f"{name}: want a (R, N) tensor, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{name}: kernel takes R <= {MAX_ROWS}, got {x.shape[0]}")
    for a in row_args:
        if a is None:
            continue
        if a.shape != (x.shape[0],) or a.dtype != torch.float32 or a.device != x.device:
            raise ValueError(f"{name}: per-row arguments must be ({x.shape[0]},) "
                             f"float32 on {x.device}, got {tuple(a.shape)} "
                             f"{a.dtype} on {a.device}")


_ROWS_ARGTYPES = [_P, _P, _P, _I, _L, _P, _P]   # x, per-row, mask, R, N, out, stream
_ENTRIES = {**{f"quantize_rows_{sfx}": [_P, _P, _P, _F, _I, _L, _P, _P]
               for sfx in _SUFFIX.values()},
            **{f"topk_mask_rows_{sfx}": _ROWS_ARGTYPES for sfx in _SUFFIX.values()},
            "dequantize_rows_i8": _ROWS_ARGTYPES}


def _call(fn_name: str, *args, device) -> None:
    fn = getattr(build.load("quantize", _ENTRIES), fn_name)
    err = build.on_device(device, lambda stream: fn(*args, stream))
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def quantize_rows_plain(x: torch.Tensor, noise: torch.Tensor,
                        scales: torch.Tensor, qmax: float) -> torch.Tensor:
    """Plain PyTorch version: (R, N), (R, N), (R,) -> (R, N) int8."""
    y = x.float() / scales[:, None] + (noise - 0.5)
    return torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)


def launch_quantize(x: torch.Tensor, noise: torch.Tensor, scales: torch.Tensor,
                    qmax: float) -> torch.Tensor:
    """The quantize kernel on checked CUDA inputs, uncounted: pass B of the
    fused ``segment_agg_reduce_quant`` launches it under its own count."""
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        R, N = x.shape
        _call(f"quantize_rows_{_SUFFIX[x.dtype]}", x.data_ptr(), noise.data_ptr(),
              scales.data_ptr(), qmax, R, N, q.data_ptr(), device=x.device)
    return q


@kernel_scope(_quantize_name)
def quantize_rows(x: torch.Tensor, noise: torch.Tensor, scales: torch.Tensor,
                  qmax: float) -> torch.Tensor:
    """x: (R, N) f32/bf16; noise: (R, N) f32 in [0, 1); scales: (R,) f32
    -> q (R, N) int8, stochastic rounding at one scale per row."""
    _check_rows("quantize_rows", x, _INPUT_DTYPES, scales)
    if noise.shape != x.shape or noise.dtype != torch.float32 or noise.device != x.device:
        raise ValueError(f"quantize_rows: noise must be {tuple(x.shape)} float32 "
                         f"on {x.device}")
    if not _on_card("quantize_rows", x):
        return quantize_rows_plain(x, noise, scales, qmax)
    if not (x.is_contiguous() and noise.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quantize_rows: inputs must be contiguous")
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=torch.int8, device=x.device)
    q = launch_quantize(x, noise, scales, qmax)
    quantize_rows.launches += 1
    return q


quantize_rows.launches = 0   # kernel launches, for chip_smoke's path check


# ---------------------------------------------------------------------------
# dequantize
# ---------------------------------------------------------------------------

def dequantize_rows_plain(q: torch.Tensor, scales: torch.Tensor,
                          row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: (R, N) int8, (R,), (R,) or None -> (R, N) f32."""
    out = q.float() * scales[:, None]
    return out if row_mask is None else out * row_mask[:, None]


@kernel_scope("kernels.dequantize_int8")
def dequantize_rows(q: torch.Tensor, scales: torch.Tensor,
                    row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (R, N) int8; scales: (R,) f32; row_mask: (R,) f32 or None
    -> (R, N) f32 = (float(q) · s_r) · m_r."""
    _check_rows("dequantize_rows", q, (torch.int8,), scales, row_mask)
    if not _on_card("dequantize_rows", q):
        return dequantize_rows_plain(q, scales, row_mask)
    if not all(t is None or t.is_contiguous() for t in (q, scales, row_mask)):
        raise ValueError("dequantize_rows: inputs must be contiguous")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    R, N = q.shape
    _call("dequantize_rows_i8", q.data_ptr(), scales.data_ptr(), _ptr(row_mask), R, N,
          out.data_ptr(), device=q.device)
    dequantize_rows.launches += 1
    return out


dequantize_rows.launches = 0


# ---------------------------------------------------------------------------
# top-k threshold mask
# ---------------------------------------------------------------------------

def topk_k(n: int, frac: float) -> int:
    """Elements kept per row: max(1, min(n, ceil(frac · n)))."""
    return max(1, min(n, math.ceil(frac * n)))


def topk_thresholds(x: torch.Tensor, k: int) -> torch.Tensor:
    """(R, N) -> (R,) f32, the k-th largest |x| of each row (PyTorch's
    top-k outside the kernel, as the TPU takes ``lax.top_k`` outside)."""
    return torch.topk(x.float().abs(), k, dim=1, sorted=False).values.amin(dim=1)


def topk_mask_rows_plain(x: torch.Tensor, thresh: torch.Tensor,
                         row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: (R, N), (R,), (R,) or None -> (R, N) f32."""
    xf = x.float()
    out = torch.where(xf.abs() >= thresh[:, None], xf, 0.0)
    return out if row_mask is None else out * row_mask[:, None]


@kernel_scope("kernels.topk_sparsify")
def topk_mask_rows(x: torch.Tensor, thresh: torch.Tensor,
                   row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (R, N) f32/bf16; thresh: (R,) f32; row_mask: (R,) f32 or None
    -> (R, N) f32 keeping |x| ≥ t_r (ties at the threshold all kept)."""
    _check_rows("topk_mask_rows", x, _INPUT_DTYPES, thresh, row_mask)
    if not _on_card("topk_mask_rows", x):
        return topk_mask_rows_plain(x, thresh, row_mask)
    if not all(t is None or t.is_contiguous() for t in (x, thresh, row_mask)):
        raise ValueError("topk_mask_rows: inputs must be contiguous")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    R, N = x.shape
    _call(f"topk_mask_rows_{_SUFFIX[x.dtype]}", x.data_ptr(), thresh.data_ptr(),
          _ptr(row_mask), R, N, out.data_ptr(), device=x.device)
    topk_mask_rows.launches += 1
    return out


topk_mask_rows.launches = 0


# ---------------------------------------------------------------------------
# the TPU kernels' signatures: one vector, one scale or threshold
# ---------------------------------------------------------------------------

@kernel_scope(_quantize_intb_name)
def quantize_intb(x: torch.Tensor, noise: torch.Tensor, bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N,) f32/bf16, noise: (N,) f32 -> (q int8 (N,), scale f32 0-d).
    ``noise`` replaces the reference's ``key``."""
    qmax = qmax_of(bits)
    if x.shape[0] == 0:
        return (torch.zeros((0,), dtype=torch.int8, device=x.device),
                torch.tensor(1.0, device=x.device))
    scale = x.float().abs().amax().clamp_min(1e-12) / qmax
    return quantize_rows(x[None], noise[None], scale.reshape(1), qmax)[0], scale


quantize_int8 = functools.partial(quantize_intb, bits=8)
quantize_int4 = functools.partial(quantize_intb, bits=4)


@kernel_scope("kernels.dequantize_int8")
def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if q.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=q.device)
    return dequantize_rows(q[None], scale.float().reshape(1))[0]


dequantize_int4 = dequantize_int8   # same on-device pair; only the wire differs


@kernel_scope("kernels.topk_sparsify")
def topk_mask(x: torch.Tensor, thresh) -> torch.Tensor:
    """x: (N,) -> (N,) f32 with |x| < thresh zeroed (dense output)."""
    if x.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    t = torch.as_tensor(thresh, dtype=torch.float32, device=x.device).reshape(1)
    return topk_mask_rows(x[None], t)[0]


def topk_threshold(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest |x| of a vector (ties at it are all kept)."""
    return topk_thresholds(x[None], max(1, min(int(k), x.shape[0])))[0]


@kernel_scope("kernels.topk_sparsify")
def topk_sparsify(x: torch.Tensor, k: int) -> torch.Tensor:
    """x: (N,) -> dense (N,) f32 keeping the k largest-magnitude entries."""
    if x.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    return topk_mask(x, topk_threshold(x, k))


# ---------------------------------------------------------------------------
# int4 nibble packing (wire layout)
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """q int8 (N,) in [-7, 7] -> uint8 (ceil(N/2),), two nibbles per byte
    (low nibble = even index). Odd N pads the final high nibble with 0."""
    if q.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.uint8, device=q.device)
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros(1)])
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    return u[0::2] | (u[1::2] << 4)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 (ceil(n/2),) -> int8 (n,) sign-extended from each nibble."""
    if n == 0:
        return torch.zeros((0,), dtype=torch.int8, device=packed.device)
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    both = torch.stack([lo, hi], dim=1).reshape(-1)[:n]
    return torch.where(both >= 8, both - 16, both).to(torch.int8)
