"""The FEMNIST CNN's patch gather (im2col) for its 5×5 SAME convolutions at
stride 1:

    im2col(x) == F.unfold(x, 5, padding=2)     x (B, C, H, W) -> (B, C·25, H·W)

``im2col`` launches the hand-written CUDA kernel (``csrc/im2col.cu``) for
a CUDA tensor, one launch a call whatever B is, and takes the plain
PyTorch version beside it only for a CPU tensor; any other device raises.
The kernel replaces no TPU kernel: the reference convolves with XLA. It
replaces ATen's CUDA im2col, which launches once per sample.

``Im2colFn`` is the op ``models.femnist_cnn.conv5_same`` calls: its
gradient is ``F.fold``, the col2im that autograd runs for ``F.unfold``,
and its vmap rule folds the vmapped dimension into the samples, so a
``torch.func.vmap`` over clients gathers every client's patches in one
call.

``im2col_cost`` reckons a call's work (``kernels.cost``); the wrapper
reports it to an attached counter, on ``meta`` in place of any work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, cost
from repro_torch.kernels.cost import Work
from repro_torch.obs.profile import kernel_scope

KERNEL, PAD, TAPS = 5, 2, 25
MAX_THREADS = 256
MAX_STAGED_FLOATS = 12288        # a block's staged band: 48 KB of shared memory
BLOCKS_PER_SM = 4                # the fewest blocks a call gives each SM, where it can
# x, planes, H, W, band, groups, vec, threads, cols, stream
_ENTRIES = {"im2col5_f32": [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_void_p]}


def im2col_cost(B: int, C: int, H: int, W: int) -> Work:
    """x read once, the patches written once; no arithmetic."""
    return Work({}, B * C * H * W * 4, B * C * TAPS * H * W * 4)


def im2col_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``F.unfold(x, 5, padding=2)``."""
    return F.unfold(x, KERNEL, padding=PAD)


class Tiling(NamedTuple):
    band: int          # output rows a block stages (the whole plane where it fits)
    groups: int        # the 25 kernel rows split over this many blocks (1, 5 or 25)
    vec: int           # positions a thread stores at once (4, or 1)
    threads: int       # threads a block


def tiling(B: int, C: int, H: int, W: int, sms: int) -> Tiling:
    """The kernel's launch for x (B, C, H, W) on a card of ``sms`` SMs."""
    vec = 4 if (H * W) % 4 == 0 else 1
    band = H
    if (H + 4) * (W + 4) > MAX_STAGED_FLOATS:
        # a multiple of 4 keeps every band's first position 16-byte aligned
        band = (MAX_STAGED_FLOATS // (W + 4) - 4) // 4 * 4
        if band < 4:
            raise ValueError(f"im2col takes W <= {MAX_STAGED_FLOATS // 8 - 4}, got {W}")
    blocks = B * C * -(-H // band)
    groups = next(g for g in (1, 5, TAPS) if blocks * g >= BLOCKS_PER_SM * sms or g == TAPS)
    lanes = min(-(-band * W // vec), MAX_THREADS)
    side = max(1, min(TAPS // groups, MAX_THREADS // lanes))
    return Tiling(band, groups, vec, lanes * side)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"im2col wants x (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"im2col takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("im2col wants a contiguous x")


def _report(x: torch.Tensor) -> None:
    cost.report("im2col", lambda: im2col_cost(*x.shape))


@kernel_scope("kernels.im2col")
@cost.quiet
def im2col(x: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W) f32, contiguous -> (B, C·25, H·W), the 5×5 patches at
    SAME padding, stride 1, as ``F.unfold(x, 5, padding=2)`` lays them out."""
    on_card = cost.device_kind("im2col", x) != "cpu"
    _check(x)
    if not on_card:
        out = im2col_plain(x)
        _report(x)
        return out
    B, C, H, W = x.shape
    out = torch.empty((B, C * TAPS, H * W), dtype=x.dtype, device=x.device)
    if x.device.type == "meta" or out.numel() == 0:
        _report(x)
        return out
    t = tiling(B, C, H, W, _sms(x.device.index))
    fn = build.load("im2col", _ENTRIES).im2col5_f32
    err = build.on_device(x.device, lambda stream: fn(
        x.data_ptr(), B * C, H, W, t.band, t.groups, t.vec, t.threads, out.data_ptr(), stream))
    if err != 0:
        raise RuntimeError(f"im2col kernel launch failed: CUDA error {err}")
    im2col.launches += 1
    _report(x)
    return out


im2col.launches = 0   # kernel launches, for chip_smoke's path check


class Im2colFn(torch.autograd.Function):
    """``im2col`` under autograd and ``torch.func``: the backward is
    ``F.fold`` (col2im, the backward autograd runs for ``F.unfold``), and
    under ``vmap`` the vmapped dimension joins the samples, so one call
    gathers a whole chunk of clients."""

    @staticmethod
    def forward(x):
        return im2col(x.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hw = tuple(inputs[0].shape[-2:])

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None
        return F.fold(g, ctx.hw, KERNEL, padding=PAD)

    @staticmethod
    def vmap(info, in_dims, x):
        # called only for a batched x: the vmapped dimension joins the samples
        x = x.movedim(in_dims[0], 0)
        out = Im2colFn.apply(x.reshape(-1, *x.shape[2:]))
        return out.reshape(x.shape[0], x.shape[1], *out.shape[1:]), 0
