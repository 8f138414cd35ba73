"""Fluid (contention-free) drop-in for ``UpstreamSim`` + the engine policy
of the incremental driver (port of ``repro.pon.fast.fluid``, plain
Python).

The batch engines pack a whole round's grant schedule at once; the
Orchestrator feeds jobs one at a time on a live clock, so there is no
batch to vectorize. Under ``sim_engine`` ``fast``/``hybrid`` the
Orchestrator instead swaps each lane's grant machine for
:class:`FluidUpstreamSim` — every job is served on a private full-rate
slice (``start = ready``, ``done = ready + size/best_rate``), which is
exact whenever grants never contend and optimistic otherwise. Because
that is an up-front modeling choice rather than a per-batch fallback,
:func:`orchestrator_engine` keeps the exact event machine wherever the
fluid assumption is known-bad before the run starts: ``ipact`` (its
grants are load-dependent), ``classical`` transport (every client's full
model contends), background load beyond ``fluid_threshold``, and
explicit ``sfl_queueing``.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Optional

from repro_torch.pon.fast.engine import SIM_ENGINES
from repro_torch.pon.timing import PonConfig


def orchestrator_engine(cfg: PonConfig, transport: str) -> str:
    """``'event'`` or ``'fluid'`` — which grant machine the incremental
    driver bridges onto the clock for this config + transport."""
    engine = getattr(cfg, "sim_engine", "event")
    if engine == "event":
        return "event"
    if engine not in SIM_ENGINES:
        raise ValueError(f"unknown sim_engine {engine!r}; "
                         f"expected one of {SIM_ENGINES}")
    if cfg.dba == "ipact":
        return "event"          # load-dependent grants: never approximated
    if transport == "classical":
        return "event"          # N full models on one slice always contend
    if cfg.background_load > cfg.fluid_threshold:
        return "event"
    if cfg.sfl_queueing:
        return "event"          # the user asked for strict queueing
    return "fluid"


class FluidUpstreamSim:
    """Interface-compatible stand-in for ``UpstreamSim`` (submit /
    next_event_s / advance_to / drain / now / on_done) that serves every
    job on a private slice. Jobs whose ONU reaches no wavelength stay at
    +inf forever, matching the event sim's starvation semantics. Emits
    the same per-job grant spans and the ``{lane}.jobs_served`` counter;
    the DBA-specific instruments (queue depth, per-wavelength busy time)
    do not exist here — there is no queue.
    """

    def __init__(self, topology, dba=None, on_done=None, tracer=None,
                 metrics=None, lane: str = "pon",
                 tid_prefix: str = "onu"):
        self.topology = topology
        self.dba = dba                      # accepted, never consulted
        self.on_done = on_done
        self.now = 0.0
        self.lane = lane
        self.tid_prefix = tid_prefix
        self._ctr = itertools.count()
        self._events: list = []
        self._rate = [topology.best_rate_mbps(o.id) for o in topology.onus]
        self._tracer = tracer if (tracer is not None
                                  and getattr(tracer, "enabled", False)) \
            else None
        self._m_served = (metrics.counter(f"{lane}.jobs_served")
                          if metrics is not None else None)

    def submit(self, job) -> None:
        rate = self._rate[job.onu]
        if rate <= 0.0:
            job.start_s, job.done_s, job.wavelength, job.grant_idx = (
                math.inf, math.inf, -1, -1)
            return
        job.start_s = job.ready_s
        job.done_s = job.ready_s + job.size_mbits / rate
        job.wavelength = -1
        job.grant_idx = next(self._ctr)
        heapq.heappush(self._events, (job.done_s, job.grant_idx, job))

    def next_event_s(self) -> Optional[float]:
        return self._events[0][0] if self._events else None

    def advance_to(self, t: float) -> None:
        while self._events and self._events[0][0] <= t:
            done, _, j = heapq.heappop(self._events)
            self.now = max(self.now, done)
            if self._m_served is not None:
                self._m_served.add(j.size_mbits)
            if self._tracer is not None:
                from repro_torch.pon.events import trace_job_span
                trace_job_span(self._tracer, j, self.lane, self.tid_prefix)
            if self.on_done is not None:
                self.on_done(j)
        self.now = max(self.now, t)

    def drain(self) -> "FluidUpstreamSim":
        while self._events:
            self.advance_to(self._events[0][0])
        return self
