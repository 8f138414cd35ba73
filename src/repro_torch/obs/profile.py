"""Profiler ranges + wall-time capture for the compute side — port of
``repro.obs.profile`` on ``torch.profiler``.

Two complementary mechanisms:

  * :func:`named_scope` — the one range helper: a
    ``torch.profiler.record_function`` range while a profiler is active
    (a named interval in the capture, recorded on the same clock as the
    device operations, which are attributed to the range their launch sat
    in), and a shared null context otherwise: an open range costs tens of
    microseconds of host time, which at the decode path's call rate is
    about 1% of a step (PERF.md §6), against a tenth of a microsecond for
    the test. Three kinds of range go through it:

      - :func:`kernel_scope` wraps every public kernel wrapper in one
        (``kernels.agg_reduce``, ``kernels.flash_attention``, ...: the
        reference's ``named_scope`` names); a wrapper called inside
        another wrapper's range (a per-leaf form over its row form) opens
        no second range, so one call is one range;
      - :func:`timed` opens one around the callable it times
        (``backend.train_s``, ``backend.eval_s``, ``backend.aggregate_s``,
        ``backend.train_step_s``);
      - the FL round's stages, opened where the work happens:
        ``fl.transport`` (``fl.loop.sync_round``: selection, failures, the
        PON simulator, the mask), ``fl.minibatch`` and ``fl.h2d``
        (``ClientStackedBackend.run_round``: the clients' minibatch draws,
        their copy to the card), and inside local training
        (``core.fedavg.local_sgd`` / ``local_sgd_prox``, once a local step
        of a vmap'd chunk) ``fl.grad`` (forward and backward),
        ``fl.forward`` inside it (the loss alone) and ``fl.sgd`` (the
        parameter update).

    A stage range adds no clock read, no synchronisation and no History,
    registry or tracer entry: it exists in a profiler's capture alone.
  * :func:`timed` — one callable's host wall time with the card
    synchronised before each clock read (PyTorch returns before queued
    kernels finish, so a bare host clock would time the enqueue), fed into
    a registry histogram and (optionally) a tracer wall span. The first
    call of a kernel is its build; callers that want the split time the
    first call apart.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Any, Callable, Tuple, Union

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from repro_torch.device import synchronize


_NO_RANGE = contextlib.nullcontext()


def named_scope(name: str):
    """A profiler range named ``name`` while a profiler is active (the
    reference's scope names), a shared null context otherwise."""
    return record_function(name) if _profiler_enabled() else _NO_RANGE


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
    """Run ``fn(*args, **kwargs)`` in ``named_scope(name)``, the card
    synchronised before each clock read; returns ``(result,
    wall_seconds)`` and records the timing into ``metrics.histogram(name)``
    / a tracer wall span when given."""
    synchronize()
    t0 = time.perf_counter()
    with named_scope(name):
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
