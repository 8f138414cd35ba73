"""The work of a kernel call, and the seam through which a counter hears
of it.

The port's kernels are nvcc-built libraries reached through ``ctypes``,
not registered PyTorch operators, so no dispatch mode sees them. Each
kernel module therefore reckons its own work: a cost function of the
call's shapes and types gives the flops by type and the bytes read and
written once (:class:`Work`), reckoned from the function the kernel
computes, never from how it is implemented. ``Work.bound()`` is the least
time the card could take for it (``launch.hw``'s peaks).

While a counter is attached (``launch.roofline.Counter``), every wrapper
call reports its work where it launches its kernel (:func:`report`), runs
its body :func:`quiet` (the aten operators a wrapper runs around or
instead of its kernel are part of the reckoned work, not counted again),
and accepts ``meta`` tensors: it then allocates what the card would and
launches nothing. Outside a counter a ``meta`` tensor raises, as any other
device but the card and the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, List, Mapping, Tuple

import torch

from repro_torch.launch import hw


@dataclasses.dataclass(frozen=True)
class Work:
    """flops by type ("bf16", "tf32", "f32", ...: ``hw.PEAK_FLOPS``' keys)
    and the bytes read and written once."""
    flops: Mapping[str, float]
    bytes_read: float = 0.0
    bytes_written: float = 0.0

    @property
    def nbytes(self) -> float:
        return self.bytes_read + self.bytes_written

    def seconds(self) -> Tuple[float, float]:
        """(the bytes at the HBM rate, the flops at their types' peaks)."""
        return (self.nbytes / hw.HBM_BW,
                sum(n / hw.PEAK_FLOPS[t] for t, n in self.flops.items()))

    def bound(self) -> Tuple[float, str]:
        """(least ms on the card, "bytes" or "operations": the larger)."""
        t_bytes, t_ops = self.seconds()
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def work_type(dtype: torch.dtype) -> str:
    """The flop type of a kernel that computes on the tensor cores in bf16
    inputs and on the CUDA cores in f32."""
    return "bf16" if dtype == torch.bfloat16 else "f32"


_counters: List = []              # attached counters, innermost last
_tls = threading.local()          # .quiet: this thread's open quiet calls


def counting() -> bool:
    return bool(_counters)


@contextlib.contextmanager
def attached(counter):
    """``counter`` hears every report while the block runs."""
    _counters.append(counter)
    try:
        yield counter
    finally:
        _counters.remove(counter)


def is_quiet() -> bool:
    return getattr(_tls, "quiet", 0) > 0


@contextlib.contextmanager
def quiet_block():
    _tls.quiet = getattr(_tls, "quiet", 0) + 1
    try:
        yield
    finally:
        _tls.quiet -= 1


def quiet(fn: Callable) -> Callable:
    """Decorator: a wrapper whose aten operators a counter does not count
    (its work is the kernel's, reported by :func:`report`)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _counters:
            return fn(*args, **kwargs)
        with quiet_block():
            return fn(*args, **kwargs)
    return wrapped


def report(name: str, work: Callable[[], Work], launches: int = 1) -> None:
    """Tell each attached counter that kernel ``name`` ran once, doing
    ``work()`` in ``launches`` launches (``work`` is reckoned only while a
    counter listens)."""
    if _counters:
        w = work()
        for c in _counters:
            c.kernel(name, w, launches)


def report_collective(kind: str, axes: Tuple[str, ...], nbytes: float, group_size: int
                      ) -> None:
    """Tell each attached counter that a collective of ``kind``
    ("all-reduce", "all-gather", "reduce-scatter") moved an operand of
    ``nbytes`` (the all-gather's: its output) over a group of
    ``group_size`` ranks spanning the mesh ``axes``."""
    for c in _counters:
        c.collective(kind, axes, nbytes, group_size)


def device_kind(name: str, t: torch.Tensor) -> str:
    """"cuda", "cpu" or "meta" (the last only under a counter); raises
    for anything else."""
    kind = t.device.type
    if kind in ("cuda", "cpu") or (kind == "meta" and _counters):
        return kind
    raise ValueError(f"{name} runs on cuda or cpu, not {t.device}"
                     + (" (meta only while a launch.roofline.Counter counts)"
                        if kind == "meta" else ""))
