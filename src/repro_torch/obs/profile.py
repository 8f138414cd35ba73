"""Profiler ranges + wall-time capture for the compute side — port of
``repro.obs.profile`` on ``torch.profiler``.

Two complementary mechanisms:

  * :func:`annotate` / :func:`named_scope` — a
    ``torch.profiler.record_function`` range: a named interval in a
    ``torch.profiler`` capture, with the device kernels launched inside it
    attributed to it. :func:`kernel_scope` wraps every public kernel
    wrapper in one (``kernels.agg_reduce``, ``kernels.flash_attention``,
    ...: the reference's ``named_scope`` names), so a capture shows each
    kernel call as a named region; a wrapper called inside another
    wrapper's range (a per-leaf form over its row form) opens no second
    range, so one call is one range. It opens the range only while a
    profiler is active: a range costs tens of microseconds of host time,
    which at the decode path's call rate is about 1% of a step (PERF.md
    §6), against a tenth of a microsecond for the test.
  * :func:`timed` — one callable's host wall time with the card
    synchronised before each clock read (PyTorch returns before queued
    kernels finish, so a bare host clock would time the enqueue), fed into
    a registry histogram and (optionally) a tracer wall span. The first
    call of a kernel is its build; callers that want the split time the
    first call apart.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Tuple, Union

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from repro_torch.device import synchronize


def annotate(name: str) -> record_function:
    """Host-side profiler range around a region (backend train/eval)."""
    return record_function(name)


def named_scope(name: str) -> record_function:
    """The range a kernel call opens (the reference's in-jit scope)."""
    return record_function(name)


_open = threading.local()   # .depth: this thread's open kernel ranges


def kernel_scope(name: Union[str, Callable[..., str]]) -> Callable:
    """Decorator: while a profiler is active, run the wrapper inside
    ``named_scope(name)`` unless a kernel range is already open; ``name``
    may be a function of the call's arguments (a quantize call's width)."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            if not _profiler_enabled() or getattr(_open, "depth", 0):
                return fn(*args, **kwargs)
            _open.depth = 1
            try:
                with named_scope(name if isinstance(name, str)
                                 else name(*args, **kwargs)):
                    return fn(*args, **kwargs)
            finally:
                _open.depth = 0
        return scoped
    return wrap


def timed(name: str, fn: Callable, *args,
          metrics=None, tracer=None, **kwargs) -> Tuple[Any, float]:
    """Run ``fn(*args, **kwargs)`` under a profiler range, the card
    synchronised before each clock read; returns ``(result,
    wall_seconds)`` and records the timing into ``metrics.histogram(name)``
    / a tracer wall span when given."""
    synchronize()
    t0 = time.perf_counter()
    with annotate(name):
        out = fn(*args, **kwargs)
        synchronize()
    dt = time.perf_counter() - t0
    if metrics is not None:
        metrics.histogram(name).observe(dt)
    if tracer is not None and tracer.enabled:
        # _wall_now pre-subtracts offset_s exactly because add_span re-adds
        # it — wall lanes always land at true host time
        now = tracer._wall_now()
        tracer.add_span(name, now - dt, now, lane=("wall", "compute"),
                        cat="profile")
    return out, dt
