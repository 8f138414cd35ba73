"""Device resolution and timing for the port's entry points."""
from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on; never falls back.

    ``"cuda"`` without a usable card raises: the CPU is used only when the
    caller asks for it (the tests do). Also pins f32 numerics on the card.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    # The JAX reference computes in full f32, but cuDNN convolutions default
    # to TF32 (about three decimal digits) on this card; matmuls are pinned
    # too so neither setting depends on the caller's process state. bf16
    # products accumulate in f32 throughout, as XLA's do.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def _synchronize() -> None:
    if torch.cuda.is_initialized():       # no-op for a CPU-only run
        torch.cuda.synchronize()


def timed(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """Run ``fn`` and return ``(result, wall_seconds)``.

    Synchronises the card before each clock read: PyTorch returns before
    queued kernels finish, so a bare host clock would time the enqueue.
    """
    _synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _synchronize()
    return out, time.perf_counter() - t0
