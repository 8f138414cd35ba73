"""Orchestrator — the event-driven federated driver on the PON clock (port
of ``repro.runtime.orchestrator``, without ``repro.obs``).

The second driver beside ``fl.RoundLoop``, behind the same
``ExperimentConfig`` + backend interfaces:

    from repro_torch import fl, runtime
    exp = fl.ExperimentConfig(policy="fedbuff", buffer_k=8, n_rounds=20)
    hist = runtime.Orchestrator(exp, backend).run(until_s=500.0)

Where the RoundLoop runs lockstep rounds, the Orchestrator owns a
simulated wall clock (``SimClock``) and schedules every client's lifecycle
on it: dispatch (eager local training on the card at the current model
version) → downlink + local train + wireless leg → the update reaches the
PON edge → an upstream job submitted to the *incremental* PON event
simulator (``pon.events.UpstreamSim``) → grant/completion under the
configured DBA/TWDM/background-traffic contention → arrival at the OLT,
handed to the aggregation policy (``runtime.policies``). The simulator's
internal events are bridged onto the same clock, so one heap orders
everything and "simulated seconds" is the measurement axis.

Multi-PON forests (``n_pons > 1``) run one bridged ``UpstreamSim`` per PON
tree plus one for the OLT→metro segment, all on the same clock. The
hierarchical transport stacks the gather window: each ONU gathers arrivals
for ``onu_gather_s`` and emits one θ onto its PON; each OLT gathers its θ
arrivals for another ``onu_gather_s`` and emits one Φ onto the metro
segment. ``classical``/``sfl`` jobs that cross a PON are relayed over the
metro segment one by one.

The ``sync`` policy bypasses the continuous machinery and calls the exact
``fl.loop.sync_round`` pipeline per deadline window — the degenerate
configuration that equals the RoundLoop bit for bit.

The reference keeps its Mbits accounting in ``repro.obs`` counters; here a
:class:`_Counter` with the same add / take / total semantics keeps it
(every History value is the transport's float, summed in the same order).
Each row also carries host-time keys: ``wall_s`` since the last row and
``dispatch_s``, the summed host time of the dispatches since the last row
(local training included), both with the card synchronised.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.device import timed
from repro_torch.fl.backends import backend_wire_scale
from repro_torch.fl.config import ExperimentConfig
from repro_torch.fl.loop import Callback, History
from repro_torch.pon.dba import make_dba
from repro_torch.pon.events import UpstreamJob, UpstreamSim
from repro_torch.pon.fast import FluidUpstreamSim, orchestrator_engine
from repro_torch.pon.metro import MetroTopology
from repro_torch.pon.timing import WIRELESS_S_MAX, WIRELESS_S_MIN, train_times
from repro_torch.pon.topology import Topology
from repro_torch.pon.traffic import BackgroundTraffic
from repro_torch.runtime.clock import SimClock
from repro_torch.runtime.policies import (AggregationPolicy, ClientUpdate, make_policy,
                                          staleness_weights)


class _Counter:
    """Monotonic total + drainable window, fed by one ``add`` sequence."""

    __slots__ = ("total", "_window")

    def __init__(self):
        self.total = 0.0
        self._window = 0.0

    def add(self, v: float) -> None:
        v = float(v)
        self.total += v
        self._window += v

    def take(self) -> float:
        """Drain and return the since-last-take window."""
        v, self._window = self._window, 0.0
        return v


class _BridgedSim:
    """One incremental ``UpstreamSim`` bridged onto the shared SimClock.

    A single clock event is kept pinned at the sim's next internal event
    time, so the grant machine's completions interleave deterministically
    with dispatches, gather windows, and every other sim on the clock.
    """

    def __init__(self, clock: SimClock, topology: Topology, dba, on_done,
                 sim_cls=UpstreamSim):
        self.clock = clock
        self.topology = topology
        self.sim = sim_cls(topology, dba, on_done=on_done)
        self._ev = None

    def submit(self, job: UpstreamJob) -> None:
        self.sim.submit(job)
        self._resched()

    def _resched(self) -> None:
        if self._ev is not None:
            self._ev.cancel()
            self._ev = None
        t = self.sim.next_event_s()
        if t is not None:
            self._ev = self.clock.schedule(t, self._pump)

    def _pump(self) -> None:
        self._ev = None
        self.sim.advance_to(self.clock.now)   # fires on_done callbacks
        self._resched()


class Orchestrator:
    """Drives ``cfg`` against a backend on a simulated wall clock."""

    def __init__(self, cfg: ExperimentConfig, backend,
                 callbacks: Iterable[Callback] = (),
                 policy: Optional[str] = None):
        self.cfg = cfg
        self.backend = backend
        self.callbacks: List[Callback] = list(callbacks)
        self.policy: AggregationPolicy = make_policy(
            policy if policy is not None else cfg.policy)
        self.rng = np.random.default_rng(cfg.seed)
        self.failures = cfg.make_failure_model()
        self.history = History()
        self.clock = SimClock()
        self.pon_cfg = cfg.fl.pon_config()
        # wire compression scales every job's size_mbits at the source: the
        # four job-creation sites (classical dispatch, θ, Φ, metro relay)
        # read self.pon_cfg.model_mbits; the sync policy goes through
        # fl.loop.sync_round, which applies the identical scaling itself
        self._wire_spec = backend.strategy.compression_spec()
        if self._wire_spec.active:
            self.pon_cfg = dataclasses.replace(
                self.pon_cfg,
                model_mbits=(self.pon_cfg.model_mbits
                             * backend_wire_scale(backend)))
        self.window_s = (cfg.round_window_s if cfg.round_window_s is not None
                         else self.pon_cfg.sync_threshold_s)
        self.server_version = 0
        self.rounds_consumed = 0        # sync policy: rounds of rng consumed
        n = cfg.fl.n_clients
        if len(backend.sample_counts) < n or len(backend.onu_ids) < n:
            raise ValueError(
                f"backend covers {len(backend.sample_counts)} clients but "
                f"cfg.fl.n_clients={n}; size the backend to the FL population")
        if self.policy.needs_async_backend and not (
                hasattr(backend, "client_update")
                and hasattr(backend, "apply_updates")):
            raise TypeError(
                f"policy {self.policy.name!r} needs the async backend seam "
                "(client_update/apply_updates); ClientStackedBackend and "
                "TransportBackend implement it, GradientBackend is "
                "sync-only — use policy='sync' or the RoundLoop driver")
        # continuous-transport state (built by setup_transport for the
        # async policies; the sync policy never touches it)
        self._pons: List[_BridgedSim] = []
        self._metro: Optional[_BridgedSim] = None
        self._payload: Dict[int, Any] = {}
        self._gather: Dict[int, Any] = {}       # ONU θ gather (global onu id)
        self._olt_gather: Dict[int, Any] = {}   # OLT Φ gather (pon index)
        self._jobseq = itertools.count()
        self._train_s: Optional[np.ndarray] = None
        # the accounting: the window drains into each History row (take),
        # .total keeps the monotonic run total — one add sequence
        self._c_up = _Counter()
        self._c_metro = _Counter()
        self._crash_alive: Optional[np.ndarray] = None
        self._transient_alive: Optional[np.ndarray] = None
        # host time: since the last row, and the dispatches' since then
        self._t_row = time.perf_counter()
        self._dispatch_s = 0.0

    @property
    def strategy(self):
        return self.backend.strategy

    @property
    def total_upstream_mbits(self) -> float:
        """Monotonic run total — never loses the bits served after the
        last server update (unlike the per-row drained windows)."""
        return self._c_up.total

    @property
    def total_metro_mbits(self) -> float:
        return self._c_metro.total

    def emit(self, rec: Dict[str, Any]) -> None:
        self.history.append(rec)
        for cb in self.callbacks:
            cb(self, rec)

    def run(self, n_updates: Optional[int] = None,
            until_s: Optional[float] = None,
            start_round: int = 0) -> History:
        """Run until ``n_updates`` server updates (default ``cfg.n_rounds``)
        or simulated time ``until_s``, whichever first. ``start_round``
        resumes the sync policy with the same replay fast-forward as
        ``RoundLoop.run``."""
        n = n_updates if n_updates is not None else self.cfg.n_rounds
        self.policy.bind(self)
        self.policy.run(n, until_s, start_round)
        return self.history

    # --- continuous transport services (used by the async policies) ------

    def setup_transport(self) -> None:
        pon = self.pon_cfg
        self.metro_topology = MetroTopology.from_config(pon)
        # fast/hybrid engines swap the exact grant machine for the
        # contention-free fluid sim — but only where that is safe: the
        # incremental driver cannot re-run a batch on fallback, so the
        # decision is made up front from the config (see orchestrator_engine)
        sim_cls = (FluidUpstreamSim
                   if orchestrator_engine(pon, self.strategy.transport)
                   == "fluid" else UpstreamSim)
        self._pons = [_BridgedSim(self.clock, topo, make_dba(pon.dba),
                                  self._pon_job_done, sim_cls=sim_cls)
                      for topo in self.metro_topology.pons]
        # single-PON forests have no metro tier — the OLT is the server edge
        self._metro = (_BridgedSim(self.clock,
                                   self.metro_topology.metro_segment(),
                                   make_dba(pon.dba), self._metro_job_done,
                                   sim_cls=sim_cls)
                       if pon.n_pons > 1 else None)
        self.topology = self._pons[0].topology   # degenerate-case alias
        self._traffic = BackgroundTraffic(pon.background_load,
                                          pon.bg_burst_mbits)
        self._train_s = train_times(np.asarray(self.backend.sample_counts))

    def _submit(self, sim: _BridgedSim, job: UpstreamJob,
                updates=None, on_arrival=None, fn=None, ctx=None) -> None:
        """Queue ``job`` on ``sim``; at completion ``fn(job, updates,
        on_arrival, ctx)`` runs (no payload → background burst)."""
        if updates is not None:
            self._payload[job.seq] = (updates, on_arrival, fn, ctx)
        sim.submit(job)

    def _pon_job_done(self, job: UpstreamJob) -> None:
        entry = self._payload.pop(job.seq, None)
        if entry is None:
            return                  # background burst: contention only
        updates, on_arrival, fn, ctx = entry
        self._c_up.add(job.size_mbits)
        fn(job, updates, on_arrival, ctx)

    def _metro_job_done(self, job: UpstreamJob) -> None:
        entry = self._payload.pop(job.seq, None)
        if entry is None:
            return
        updates, on_arrival, fn, ctx = entry
        self._c_metro.add(job.size_mbits)
        fn(job, updates, on_arrival, ctx)

    # --- per-leg completion handlers -------------------------------------

    def _finish(self, job: UpstreamJob, updates, on_arrival, ctx) -> None:
        """Arrival at the aggregation point: hand updates to the policy."""
        for up in updates:
            up.t_arrival = job.done_s
            on_arrival(up)

    def _finish_after_latency(self, job, updates, on_arrival, ctx) -> None:
        """Metro completion: the propagation leg, then delivery."""
        lat = self.pon_cfg.metro_latency_s
        t_arr = job.done_s + lat

        def deliver():
            for up in updates:
                up.t_arrival = t_arr
                on_arrival(up)
        self.clock.after(lat, deliver)

    def _relay_metro(self, job, updates, on_arrival, ctx) -> None:
        """Flat transports over a forest: forward the served PON job across
        the metro segment as its own job (classical models and flat-sfl θs
        each cross individually — the non-scaling baseline)."""
        mj = UpstreamJob(seq=next(self._jobseq), onu=int(ctx),
                         size_mbits=self.pon_cfg.model_mbits,
                         ready_s=self.clock.now, kind=job.kind,
                         client=job.client)
        self._submit(self._metro, mj, updates, on_arrival,
                     self._finish_after_latency)

    def _olt_collect(self, job, updates, on_arrival, ctx) -> None:
        """hier: the OLT gathers θ arrivals for one more gather window,
        then emits a single Φ onto the metro segment."""
        p = int(ctx)
        slot = self._olt_gather.get(p)
        if slot is None:
            self._olt_gather[p] = (list(updates), on_arrival, self.clock.now)
            self.clock.after(self.cfg.onu_gather_s, self._close_olt_gather, p)
        else:
            slot[0].extend(updates)

    def _close_olt_gather(self, p: int) -> None:
        ups, on_arrival, _ = self._olt_gather.pop(p)
        pon = self.pon_cfg
        job = UpstreamJob(seq=next(self._jobseq), onu=p,
                          size_mbits=pon.model_mbits,
                          ready_s=self.clock.now + pon.onu_agg_s,
                          kind="theta")
        self._submit(self._metro, job, ups, on_arrival,
                     self._finish_after_latency)

    def step_window(self, w: int) -> None:
        """Window-cadence bookkeeping: failure-model step + the next chunk
        of background bursts offered to every PON tree's upstream."""
        if self.failures is not None:
            self._crash_alive, self._transient_alive = \
                self.failures.step_components(w, self.cfg.fl.n_clients)
        if self._traffic.load > 0.0:
            t0 = self.clock.now
            chunk = dataclasses.replace(self._traffic, start_s=t0)
            for sim in self._pons:
                for j in chunk.jobs(self.rng, sim.topology,
                                    t0 + self.window_s):
                    j.seq = next(self._jobseq)
                    self._submit(sim, j)

    def crashed(self, client: int) -> bool:
        return self._crash_alive is not None and not self._crash_alive[client]

    def transient(self, client: int) -> bool:
        return (self._transient_alive is not None
                and not self._transient_alive[client])

    def select_idle(self, n_wanted: int, busy=()) -> np.ndarray:
        """Selection draw over the idle population (+ overselect backups)."""
        pool = np.arange(self.cfg.fl.n_clients)
        if busy:
            pool = np.setdiff1d(pool, np.fromiter(busy, dtype=np.int64))
        n = min(len(pool), int(round(n_wanted * (1.0 + self.cfg.overselect))))
        if n == 0:
            return np.empty(0, np.int64)
        return self.rng.choice(pool, size=n, replace=False)

    def dispatch(self, client: int, on_arrival) -> ClientUpdate:
        """Send the current model to ``client``: eager local training (the
        math is clock-free), then downlink + train + wireless delay before
        the update reaches the PON edge and transport owns it."""
        (delta, weight), dt_host = timed(self.backend.client_update, client, self.rng)
        self._dispatch_s += dt_host
        up = ClientUpdate(client=int(client), delta=delta, weight=weight,
                          version=self.server_version,
                          t_dispatch=self.clock.now)
        dt = (self.pon_cfg.downlink_s + float(self._train_s[client])
              + self.rng.uniform(WIRELESS_S_MIN, WIRELESS_S_MAX))
        self.clock.after(dt, self._at_edge, up, on_arrival)
        return up

    def _at_edge(self, up: ClientUpdate, on_arrival) -> None:
        up.t_edge = self.clock.now
        pon = self.pon_cfg
        onu_g = int(self.backend.onu_ids[up.client])   # global ONU id
        p = onu_g // pon.n_onus                        # owning PON tree
        onu_local = onu_g % pon.n_onus
        if self.strategy.transport == "classical":
            job = UpstreamJob(seq=next(self._jobseq), onu=onu_local,
                              size_mbits=pon.model_mbits,
                              ready_s=self.clock.now, kind="fl",
                              client=up.client)
            fn = self._relay_metro if self._metro is not None else self._finish
            self._submit(self._pons[p], job, [up], on_arrival, fn, ctx=p)
        else:
            # SFL/hier: the ONU gathers arrivals for onu_gather_s, then
            # sends ONE θ carrying them all — the paper's constant-bandwidth
            # property, asynchronously
            slot = self._gather.get(onu_g)
            if slot is None:
                self._gather[onu_g] = ([up], on_arrival, self.clock.now)
                self.clock.after(self.cfg.onu_gather_s, self._close_gather,
                                 onu_g)
            else:
                slot[0].append(up)

    def _close_gather(self, onu_g: int) -> None:
        ups, on_arrival, _ = self._gather.pop(onu_g)
        pon = self.pon_cfg
        p = onu_g // pon.n_onus
        job = UpstreamJob(seq=next(self._jobseq), onu=onu_g % pon.n_onus,
                          size_mbits=pon.model_mbits,
                          ready_s=self.clock.now + pon.onu_agg_s,
                          kind="theta")
        if self._metro is None:
            fn = self._finish       # the OLT is the server edge
        elif self.strategy.transport == "hier":
            fn = self._olt_collect  # θ → OLT gather window → one Φ
        else:
            fn = self._relay_metro  # flat sfl: each θ crosses the metro
        self._submit(self._pons[p], job, ups, on_arrival, fn, ctx=p)

    def take_upstream_mbits(self) -> float:
        return self._c_up.take()

    def take_metro_mbits(self) -> float:
        return self._c_metro.take()

    def apply(self, rnd_label, updates: List[ClientUpdate],
              extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Staleness-discount, aggregate, server-update; emit a History row."""
        stale = np.array([self.server_version - u.version for u in updates],
                         np.float32)
        base = np.array([u.weight for u in updates], np.float32)
        w = staleness_weights(base, stale, self.cfg.staleness_exponent)
        metrics = self.backend.apply_updates(
            self.server_version, [u.client for u in updates],
            [u.delta for u in updates], w)
        if updates:
            self.server_version += 1
        rec = {"round": rnd_label, "t_s": self.clock.now,
               "policy": self.policy.name, "version": self.server_version,
               "sim_engine": getattr(self.pon_cfg, "sim_engine", "event"),
               "involved": float(len(updates)),
               "upstream_mbits": self.take_upstream_mbits(),
               "staleness_mean": float(stale.mean()) if len(stale) else 0.0,
               "staleness_max": float(stale.max()) if len(stale) else 0.0}
        if self._metro is not None:
            rec["metro_mbits"] = self.take_metro_mbits()
        if self._wire_spec.active:
            rec["wire_mbits"] = float(self.pon_cfg.model_mbits)
            rec["compress"] = self._wire_spec.scheme
        rec.update(metrics)
        rec.update(extra or {})
        now = time.perf_counter()
        rec["wall_s"], self._t_row = now - self._t_row, now
        rec["dispatch_s"], self._dispatch_s = self._dispatch_s, 0.0
        self.emit(rec)
        return rec
