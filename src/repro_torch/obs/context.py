"""Ambient observability context — one installed ``Obs`` per process.

The drivers (RoundLoop / Orchestrator) each own a *private*
``MetricsRegistry`` (run-scoped accounting must not bleed across the many
driver instances a benchmark sweep creates), but the **tracer** is
naturally process-scoped: there is one timeline, and deep call sites
(the PON event simulator, backends, kernels) reach it without threading a
handle through every signature.

    from repro_torch import obs
    sess = obs.Obs.enabled_tracing()
    with obs.use(sess):
        fl.RoundLoop(exp, backend).run()
    sess.tracer.write("trace.json")

The default context carries :data:`NOOP_TRACER` and a process-level
registry (for call sites with no driver in scope, e.g. backend wall
timings); ``obs.get()`` never returns None.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, List, Optional, Union

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NOOP_TRACER, NoopTracer, Tracer


@dataclasses.dataclass
class Obs:
    """One observability bundle: tracer + metrics registry (+ optional
    health engine, ``repro_torch.obs.audit`` — None unless ``--health``)."""

    tracer: Union[Tracer, NoopTracer] = NOOP_TRACER
    metrics: MetricsRegistry = dataclasses.field(default_factory=MetricsRegistry)
    health: Optional[Any] = None    # audit.HealthEngine (avoids the import)
    # registries of child bundles handed to driver instances — kept so a
    # session can export ONE merged metrics artifact for a whole sweep
    _children: List[MetricsRegistry] = dataclasses.field(
        default_factory=list, repr=False)

    @classmethod
    def enabled_tracing(cls) -> "Obs":
        """A bundle with a live tracer (the --trace-out configuration)."""
        return cls(tracer=Tracer())

    @classmethod
    def disabled(cls) -> "Obs":
        return cls()

    def child(self) -> "Obs":
        """A driver-private bundle: same tracer (one timeline) and health
        engine, fresh registry (run totals must not bleed across the many
        driver instances a sweep creates). The child registry is
        remembered so :meth:`merged_metrics` can fold the whole sweep
        into one artifact."""
        c = Obs(tracer=self.tracer, health=self.health)
        self._children.append(c.metrics)
        return c

    def merged_metrics(self) -> MetricsRegistry:
        """This bundle's registry plus every child's, merged fresh."""
        out = MetricsRegistry()
        out.merge(self.metrics)
        for child in self._children:
            out.merge(child)
        return out


_DEFAULT = Obs()
_current: Obs = _DEFAULT


def get() -> Obs:
    """The installed observability context (never None)."""
    return _current


def tracer():
    return _current.tracer


def metrics() -> MetricsRegistry:
    return _current.metrics


def install(obs: Optional[Obs]) -> Obs:
    """Install ``obs`` as the ambient context (None restores the default);
    returns the previous context so callers can restore it."""
    global _current
    prev = _current
    _current = obs if obs is not None else _DEFAULT
    return prev


@contextlib.contextmanager
def use(obs: Obs) -> Iterator[Obs]:
    """Scoped install — the test-friendly form."""
    prev = install(obs)
    try:
        yield obs
    finally:
        install(prev)
