"""Operations and bytes of each timed kernel call, from its shapes alone.

Each function gives a :class:`Work`: the flops by type and the bytes read
and written once, reckoned from the function the kernel computes, never
from how it is implemented. ``Work.bound_s()`` is the least time the card
could take: the larger of the bytes at the HBM rate and the flops at their
type's peak.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from portbench.work.peaks import HBM_BW, PEAK_FLOPS


@dataclasses.dataclass(frozen=True)
class Work:
    flops: Mapping[str, float]
    bytes_read: float = 0.0
    bytes_written: float = 0.0

    def bound_s(self) -> float:
        t_bytes = (self.bytes_read + self.bytes_written) / HBM_BW
        t_ops = sum(n / PEAK_FLOPS[t] for t, n in self.flops.items())
        return max(t_bytes, t_ops)


def _flop_type(itemsize: int) -> str:
    """bf16 inputs run on the tensor cores, f32 on the CUDA cores."""
    return "bf16" if itemsize == 2 else "f32"


def agg_reduce(C: int, N: int, n_seg: int, itemsize: int) -> Work:
    """Per-segment Σ wm·x over C rows of N: x, wm and the CSR (C rows,
    n_seg + 1 offsets) read once, the n_seg sums written once."""
    return Work({"f32": 2 * C * N}, C * N * itemsize + C * 4 + (C + n_seg + 1) * 4,
                n_seg * N * 4)


def agg_reduce_quant(C: int, N: int, n_seg: int, itemsize: int) -> Work:
    """The fused aggregate + quantize: x, wm, both passes' tables and the
    noise read once, the int8 sums and their scales written once."""
    return Work({"f32": 2 * C * N + 6 * n_seg * N},
                C * N * itemsize + C * 4 + (2 * C + n_seg + 1) * 4 + n_seg * N * 4,
                n_seg * N + n_seg * 4)


def quantize(R: int, N: int, itemsize: int) -> Work:
    """(R, N) rows, their noise and scales read, int8 written."""
    return Work({"f32": 6 * R * N}, R * N * (itemsize + 4) + R * 4, R * N)


def dequantize(R: int, N: int, masked: bool) -> Work:
    """(R, N) int8 and the scales (and the row mask) read, f32 written."""
    return Work({"f32": 2 * R * N}, R * N + R * 4 * (1 + masked), R * N * 4)


def visible_pairs(S: int, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs a causal window admits."""
    if not causal:
        return S * S
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_attention(B: int, H: int, KV: int, S: int, hd: int, itemsize: int,
                    window: int = 0, causal: bool = True, with_lse: bool = False) -> Work:
    """q, k, v read once, o (and the rows' f32 log-sum-exp) written once;
    4·hd flops a visible pair (QKᵀ and P·V)."""
    return Work({_flop_type(itemsize): 4 * B * H * hd * visible_pairs(S, window, causal)},
                itemsize * (B * H * S * hd + 2 * B * KV * S * hd),
                itemsize * B * H * S * hd + 4 * B * H * S * with_lse)


def flash_attention_bwd(B: int, H: int, KV: int, S: int, hd: int, itemsize: int,
                        window: int = 0, causal: bool = True) -> Work:
    """q, k, v, o, dO and the log-sum-exp read once, dq, dk, dv written
    once; 10·hd flops a visible pair (QKᵀ, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q)."""
    return Work({_flop_type(itemsize): 10 * hd * B * H * visible_pairs(S, window, causal)},
                itemsize * (3 * B * H * S * hd + 2 * B * KV * S * hd) + 4 * B * H * S,
                itemsize * (B * H * S * hd + 2 * B * KV * S * hd))
