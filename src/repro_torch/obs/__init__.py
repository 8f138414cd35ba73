"""repro_torch.obs — unified tracing, metrics, and profiling for the FL/PON
stack (port of ``repro.obs``; the schemas ``repro.obs/v1`` and
``repro.obs.audit/v1`` are shared, so either package reads and diffs the
other's artifacts).

    from repro_torch import obs

    sess = obs.session(trace_out="trace.json", metrics_out="metrics.jsonl")
    loop = fl.RoundLoop(exp, backend, obs=sess.obs)
    loop.run()
    sess.finish()          # writes trace.json (open in ui.perfetto.dev)

Three pillars (DESIGN.md §13):

  * **Tracer** — span-based, on BOTH clocks: simulated seconds (SimClock /
    UpstreamSim event times: grant spans per ONU, θ/Φ/Ψ gather windows,
    client dispatch→train→wireless legs) and wall seconds (backend
    train/eval, kernel timings). Chrome-trace exporter, Perfetto-loadable.
    The default is a zero-overhead no-op; hot paths gate on
    ``tracer.enabled``.
  * **MetricsRegistry** — counters (window + monotonic total), gauges,
    bounded histograms. The drivers' source of truth for all bandwidth
    accounting: the ``*_mbits`` History values are *read from* the
    registry, bit for bit the transport's.
  * **profile / logging** — ``torch.profiler`` ranges (``named_scope``
    around every kernel wrapper, ``annotate`` host-side) and the shared
    stdlib logging setup behind ``--log-level``/``--log-json``.

CLI: ``add_obs_cli_args`` contributes ``--trace-out``/``--metrics-out``
(attached by the shared experiment flag set), ``session_from_args`` builds
and installs the session.
"""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.obs.context import Obs, get, install, metrics, tracer, use
from repro_torch.obs.metrics import (SCHEMA, Counter, Gauge, Histogram,
                               MetricsRegistry, read_jsonl)
from repro_torch.obs.tracer import NOOP_TRACER, NoopTracer, Span, Tracer
from repro_torch.obs import logging as obs_logging
from repro_torch.obs import audit


def __getattr__(name: str):
    # ``obs.profile`` wraps torch.profiler: imported on first use, so the
    # numpy simulators that record into this package never load torch
    if name == "profile":
        return importlib.import_module("repro_torch.obs.profile")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class ObsSession:
    """An Obs bundle plus its output destinations; ``finish()`` flushes."""

    def __init__(self, obs: Obs, trace_out: Optional[str] = None,
                 metrics_out: Optional[str] = None, installed: bool = False,
                 incidents_out: Optional[str] = None,
                 report_out: Optional[str] = None, driver: str = ""):
        self.obs = obs
        self.trace_out = trace_out
        self.metrics_out = metrics_out
        self.incidents_out = incidents_out
        self.report_out = report_out
        self.driver = driver
        self._installed = installed
        self._prev = None

    @property
    def tracer(self):
        return self.obs.tracer

    @property
    def metrics(self) -> MetricsRegistry:
        return self.obs.metrics

    def finish(self, quiet: bool = False, cfg=None, history=None) -> None:
        """Write the configured artifacts and restore the prior context.

        Drivers pass ``cfg``/``history`` so ``--report-out`` can bundle
        the resolved config and the History rows (repro_torch.obs.audit).
        """
        if self.obs.health is not None:
            self.obs.health.finish(tracer=self.obs.tracer)
        if self.trace_out:
            self.obs.tracer.write(self.trace_out)
            if not quiet:
                print(f"[obs] wrote {len(getattr(self.obs.tracer, 'spans', ()))} "
                      f"spans to {self.trace_out} "
                      "(open in https://ui.perfetto.dev)")
        if self.metrics_out:
            self.obs.merged_metrics().write_jsonl(self.metrics_out)
            if not quiet:
                print(f"[obs] wrote merged metrics to {self.metrics_out}")
        if self.incidents_out and self.obs.health is not None:
            self.obs.health.write_jsonl(self.incidents_out)
            if not quiet:
                print(f"[obs] wrote {len(self.obs.health.incidents)} "
                      f"incidents to {self.incidents_out}")
        if self.report_out:
            from repro_torch.obs.audit import RunReport
            rep = RunReport.from_run(
                cfg=cfg, history=history, obs=self.obs,
                incidents=(self.obs.health.records()
                           if self.obs.health is not None else None),
                driver=self.driver)
            rep.write(self.report_out)
            if not quiet:
                print(f"[obs] wrote run bundle to {self.report_out} "
                      f"(cfg={rep.config_hash or '?'}; diff two bundles "
                      "with `python -m repro_torch.obs.diff A B`)")
        if self._installed:
            install(self._prev)
            self._installed = False


def session(trace_out: Optional[str] = None,
            metrics_out: Optional[str] = None,
            do_install: bool = True,
            incidents_out: Optional[str] = None,
            report_out: Optional[str] = None,
            health: bool = False, health_engine=None,
            driver: str = "") -> ObsSession:
    """Build an ObsSession: a live tracer iff ``trace_out`` or
    ``report_out`` is set (bundles embed the trace so the diff engine can
    align span timelines), the no-op tracer otherwise; always a fresh
    registry; installed as the ambient context by default so deep call
    sites see it. ``health``/``incidents_out`` attach a
    :class:`repro_torch.obs.audit.HealthEngine` (pass ``health_engine`` for a
    pre-configured one, e.g. ``HealthEngine.from_args``)."""
    obs = (Obs.enabled_tracing() if (trace_out or report_out)
           else Obs.disabled())
    if health_engine is None and (health or incidents_out):
        from repro_torch.obs.audit import HealthEngine
        health_engine = HealthEngine()
    obs.health = health_engine
    sess = ObsSession(obs, trace_out, metrics_out, installed=do_install,
                      incidents_out=incidents_out, report_out=report_out,
                      driver=driver)
    if do_install:
        sess._prev = install(obs)
    return sess


def add_obs_cli_args(ap) -> None:
    """--trace-out/--metrics-out/--report-out + the --health/--slo-* block
    (one definition for every driver CLI)."""
    from repro_torch.obs.audit.health import add_health_cli_args
    g = ap.add_argument_group("observability (repro_torch.obs)")
    g.add_argument("--trace-out", default=None, metavar="TRACE.json",
                   help="write a Chrome/Perfetto trace of the run "
                        "(grant spans per ONU, tier aggregation windows, "
                        "wall-clock compute lanes)")
    g.add_argument("--metrics-out", default=None, metavar="METRICS.jsonl",
                   help="write the run's MetricsRegistry as JSONL")
    g.add_argument("--report-out", default=None, metavar="BUNDLE.json",
                   help="write a RunReport bundle (config+hash, metrics, "
                        "trace, incidents, env) — the input to "
                        "`python -m repro_torch.obs.diff`")
    add_health_cli_args(g)


def session_from_args(args, driver: str = "") -> ObsSession:
    """The session selected by ``add_obs_cli_args`` flags, installed."""
    health_engine = None
    if getattr(args, "health", False) or getattr(args, "incidents_out", None):
        from repro_torch.obs.audit import HealthEngine
        health_engine = HealthEngine.from_args(args)
    return session(trace_out=getattr(args, "trace_out", None),
                   metrics_out=getattr(args, "metrics_out", None),
                   incidents_out=getattr(args, "incidents_out", None),
                   report_out=getattr(args, "report_out", None),
                   health_engine=health_engine, driver=driver)


__all__ = [
    "Obs", "ObsSession", "session", "session_from_args", "add_obs_cli_args",
    "get", "install", "use", "tracer", "metrics",
    "SCHEMA", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "read_jsonl",
    "NOOP_TRACER", "NoopTracer", "Span", "Tracer",
    "obs_logging", "profile",
    "audit",
]
