"""Discrete-event PON upstream simulator + FL round orchestration — port of
``repro.pon.events`` (numpy and plain Python).

Upstream transmissions are *jobs* granted onto TWDM wavelength channels by
a pluggable DBA policy (``dba.py``), over an arbitrary ONU tree
(``topology.py``), optionally competing with background bursts
(``traffic.py``).

Event loop (``simulate_upstream``): a time-ordered heap of job-ready and
wavelength-free events; whenever a wavelength is idle and compatible jobs
are pending, the DBA picks one grant (non-preemptive, one job per grant,
an ONU transmits on at most one wavelength at a time). Under (one
wavelength, ``fifo`` policy, no background traffic) every completion-time
float is the closed-form recurrence ``t = max(t, ready) + size/rate``
(``timing.round_times_fifo``).

Round orchestration (``simulate_round``): broadcast + local train +
wireless leg bring each update to the PON edge, then the upstream legs go
to the event simulator:

  * ``mode='classical'``: every selected client's full update is an
    upstream job.
  * ``mode='sfl'``: each ONU aggregates its in-time clients into one θ job
    (the ONU stops waiting at ``deadline − nominal upload − agg``). With
    ``sfl_queueing=False`` (paper-consistent) θ grants are interleaved
    within the DBA cycle, so each θ sees a contention-free slice; with
    ``True`` θs queue through the DBA like any other job. Background
    bursts contend in every queued path; in the interleaved path they only
    show up in the served/offered stats.

The reference's observability hooks (its ``obs=`` and ``metrics=``
arguments, the tracer's grant spans and the DBA queue-depth metrics) are
left out until the port has ``repro.obs`` (ROADMAP.md Queue 1 item 5); the
returned dicts and the RNG draws are the reference's.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.pon.dba import DbaPolicy, make_dba
from repro_torch.pon.timing import WIRELESS_S_MAX, WIRELESS_S_MIN, PonConfig, train_times
from repro_torch.pon.topology import Topology
from repro_torch.pon.traffic import BackgroundTraffic

_READY, _FREE = 0, 1


@dataclasses.dataclass
class UpstreamJob:
    """One upstream transmission: an FL update, a θ aggregate, or a burst."""
    seq: int
    onu: int
    size_mbits: float
    ready_s: float
    kind: str = "fl"            # "fl" | "theta" | "bg"
    client: int = -1
    # filled by the simulator:
    start_s: float = math.inf
    done_s: float = math.inf
    wavelength: int = -1
    grant_idx: int = -1


class UpstreamSim:
    """Incremental event-driven upstream: submit jobs over time, advance.

    The grant machine behind the batch :func:`simulate_upstream`, exposed
    incrementally: grants are non-preemptive and a decision at time *t*
    only considers jobs with ``ready_s <= t``, so submitting a job at or
    before its ready time yields the batch call's schedule float for float.
    ``on_done`` (optional) fires once per job at its completion event, in
    completion order, while :meth:`advance_to` is draining.
    """

    def __init__(self, topology: Topology, dba: DbaPolicy, on_done=None):
        self.topology = topology
        self.dba = dba
        self.on_done = on_done
        dba.reset(topology)
        self._onu_wl = {o.id: frozenset(o.reachable(topology))
                        for o in topology.onus}
        self._ctr = itertools.count()
        self._events: list = []
        self._free = set(range(topology.n_wavelengths))
        self._onu_busy: set = set()
        self._pending: List[UpstreamJob] = []
        self._grant_idx = itertools.count()
        self.now = 0.0

    def submit(self, job: UpstreamJob) -> None:
        """Enqueue one upstream job (must be no later than its ready time)."""
        job.start_s, job.done_s, job.wavelength, job.grant_idx = (
            math.inf, math.inf, -1, -1)
        heapq.heappush(self._events, (job.ready_s, next(self._ctr), _READY, job))

    def next_event_s(self) -> Optional[float]:
        """Time of the next internal event, or None when idle."""
        return self._events[0][0] if self._events else None

    def _grant(self) -> None:
        while self._pending and self._free:
            granted = False
            for w in sorted(self._free):
                cands = [j for j in self._pending
                         if j.onu not in self._onu_busy
                         and w in self._onu_wl[j.onu]]
                if not cands:
                    continue
                j = self.dba.select(self.now, w, cands)
                if j is None:
                    continue
                j.start_s = self.now if self.now > j.ready_s else j.ready_s
                j.done_s = j.start_s + j.size_mbits / self.topology.rate_mbps(
                    j.onu, w)
                j.wavelength = w
                j.grant_idx = next(self._grant_idx)
                heapq.heappush(self._events,
                               (j.done_s, next(self._ctr), _FREE, (w, j)))
                self._free.remove(w)
                self._onu_busy.add(j.onu)
                self._pending.remove(j)
                granted = True
                break
            if not granted:
                break

    def advance_to(self, t: float) -> None:
        """Process every event with time <= ``t`` (granting in between)."""
        while self._events and self._events[0][0] <= t:
            self.now = max(self.now, self._events[0][0])
            completed: List[UpstreamJob] = []
            while self._events and self._events[0][0] <= self.now:
                _, _, ev, payload = heapq.heappop(self._events)
                if ev == _READY:
                    self._pending.append(payload)
                else:
                    w, j = payload
                    self._free.add(w)
                    self._onu_busy.discard(j.onu)
                    completed.append(j)
            self._grant()
            if self.on_done is not None:
                for j in completed:
                    self.on_done(j)
        self.now = max(self.now, t)

    def drain(self) -> "UpstreamSim":
        """Run to quiescence (anything still pending is unservable)."""
        while self._events:
            self.advance_to(self._events[0][0])
        return self


def simulate_upstream(jobs: Sequence[UpstreamJob], topology: Topology,
                      dba: DbaPolicy) -> List[UpstreamJob]:
    """Serve ``jobs`` on the topology's wavelengths under the DBA policy.

    Mutates and returns the jobs: ``start_s``/``done_s``/``wavelength``/
    ``grant_idx`` are filled for every job the simulator could serve; jobs
    whose ONU reaches no wavelength stay at +inf. Batch wrapper over the
    incremental :class:`UpstreamSim`.
    """
    sim = UpstreamSim(topology, dba)
    for j in jobs:
        sim.submit(j)
    sim.drain()
    return list(jobs)


def _dedicated_serve(jobs: Sequence[UpstreamJob], topology: Topology) -> None:
    """Grant-interleaved service: each job sees a private full-rate slice.

    Jobs whose ONU reaches no wavelength stay unserved (+inf), matching
    the queued path's starvation semantics.
    """
    for k, j in enumerate(jobs):
        rate = topology.best_rate_mbps(j.onu)
        if rate <= 0.0:
            j.start_s, j.done_s, j.wavelength, j.grant_idx = (
                math.inf, math.inf, -1, -1)
            continue
        j.start_s = j.ready_s
        j.done_s = j.ready_s + j.size_mbits / rate
        j.wavelength, j.grant_idx = -1, k


def simulate_round(cfg: PonConfig, rng: np.random.Generator,
                   selected: np.ndarray, onu_ids: np.ndarray,
                   sample_counts: np.ndarray, mode: str,
                   topology: Optional[Topology] = None,
                   dba: Optional[DbaPolicy] = None,
                   traffic: Optional[BackgroundTraffic] = None) -> Dict:
    """One FL round over the event-driven PON; same contract as round_times.

    ``topology``/``dba``/``traffic`` default from ``cfg`` (``n_wavelengths``,
    ``dba``, ``background_load``, …); pass explicit objects for arbitrary
    trees, custom policies, or hand-built traffic. RNG consumption: one
    wireless draw per selected client, then the background draws (none at
    zero load).

    ``cfg.sim_engine`` other than ``"event"`` routes to ``pon.fast``;
    multi-PON forests (``cfg.n_pons > 1``) to ``pon.metro``, with
    ``mode='hier'`` adding the OLT/metro aggregation tiers. With one PON the
    OLT is the server edge, so ``mode='hier'`` is exactly the flat ``sfl``
    path.
    """
    engine = getattr(cfg, "sim_engine", "event")
    if engine != "event":
        from repro_torch.pon import fast
        if engine not in fast.SIM_ENGINES:
            raise ValueError(f"unknown sim_engine {engine!r}; "
                             f"expected one of {fast.SIM_ENGINES}")
        if topology is not None or dba is not None or traffic is not None:
            raise ValueError(
                "the fast/hybrid engines build topology/DBA/traffic from "
                "cfg — explicit overrides require sim_engine='event'")
        if cfg.n_pons > 1:
            return fast.simulate_hier_round_fast(cfg, rng, selected,
                                                 onu_ids, sample_counts,
                                                 mode)
        return fast.simulate_round_fast(cfg, rng, selected, onu_ids,
                                        sample_counts, mode)
    if cfg.n_pons > 1:
        if topology is not None or dba is not None or traffic is not None:
            raise ValueError(
                "multi-PON rounds (cfg.n_pons > 1) build per-tree "
                "topology/DBA/traffic from cfg — explicit overrides would "
                "be silently wrong here; pass a MetroTopology to "
                "pon.metro.simulate_hier_round instead")
        from repro_torch.pon import metro
        return metro.simulate_hier_round(cfg, rng, selected, onu_ids,
                                         sample_counts, mode)
    if mode == "hier":
        mode = "sfl"
    if topology is None:
        topology = Topology.uniform(cfg.n_onus, cfg.clients_per_onu,
                                    cfg.n_wavelengths, cfg.slice_mbps,
                                    cfg.onu_link_mbps)
    if dba is None:
        dba = make_dba(cfg.dba)
    if traffic is None:
        traffic = BackgroundTraffic(cfg.background_load, cfg.bg_burst_mbits)

    n = len(selected)
    t_train = train_times(sample_counts)[selected]
    t_wireless = rng.uniform(WIRELESS_S_MIN, WIRELESS_S_MAX, size=n)
    ready = cfg.downlink_s + t_train + t_wireless   # update reaches the PON edge
    up = cfg.upload_s

    if mode == "classical":
        fl_jobs = [UpstreamJob(seq=i, onu=int(onu_ids[selected[i]]),
                               size_mbits=cfg.model_mbits, ready_s=ready[i],
                               kind="fl", client=int(selected[i]))
                   for i in range(n)]
        bg_jobs = traffic.jobs(rng, topology, cfg.sync_threshold_s,
                               seq_start=n)
        simulate_upstream(fl_jobs + bg_jobs, topology, dba)
        t_done = np.array([j.done_s for j in fl_jobs])
        involved = t_done <= cfg.sync_threshold_s
        upstream_mbits = float(n) * cfg.model_mbits
        fl_served = fl_jobs
    else:
        onus = onu_ids[selected]
        n_onus = topology.n_onus
        cutoff = cfg.sync_threshold_s - up - cfg.onu_agg_s
        in_time = ready <= cutoff
        # θ_i is ready when ONU i's last in-time client arrives (+ agg time)
        theta_ready = np.full(n_onus, np.inf)
        for o in np.unique(onus):
            arr = ready[(onus == o) & in_time]
            if len(arr):
                theta_ready[o] = arr.max() + cfg.onu_agg_s
        active = np.where(np.isfinite(theta_ready))[0]
        theta_jobs = [UpstreamJob(seq=i, onu=int(o),
                                  size_mbits=cfg.model_mbits,
                                  ready_s=theta_ready[o], kind="theta")
                      for i, o in enumerate(active)]
        bg_jobs = traffic.jobs(rng, topology, cfg.sync_threshold_s,
                               seq_start=len(theta_jobs))
        if cfg.sfl_queueing:
            simulate_upstream(theta_jobs + bg_jobs, topology, dba)
        else:
            # paper-consistent grant interleaving: θs are contention-free;
            # background only shows up in the served/offered stats
            _dedicated_serve(theta_jobs, topology)
            if bg_jobs:
                simulate_upstream(bg_jobs, topology, dba)
        theta_done = np.full(n_onus, np.inf)
        for j in theta_jobs:
            theta_done[j.onu] = j.done_s
        t_done = np.where(in_time, theta_done[onus], np.inf)
        involved = t_done <= cfg.sync_threshold_s
        # only ONUs that actually transmit a θ consume upstream
        upstream_mbits = float(len(active)) * cfg.model_mbits
        fl_served = theta_jobs

    starts = np.array([j.start_s - j.ready_s for j in fl_served
                       if math.isfinite(j.start_s)])
    bg_done = [j for j in bg_jobs if j.done_s <= cfg.sync_threshold_s]
    return {
        "ready": ready,
        "t_done": t_done,
        "involved": involved.astype(np.float32),
        "upstream_mbits": upstream_mbits,
        "upload_s": up,
        # event-simulator extras (absent from the closed form):
        "dba": dba.name,
        "n_wavelengths": topology.n_wavelengths,
        "grant_delay_s": float(starts.mean()) if len(starts) else 0.0,
        # FL jobs submitted to / granted by the DBA this round — crashed
        # clients are excluded before transport (fl.loop), so they never
        # appear here
        "n_fl_jobs": len(fl_served),
        "n_fl_grants": int(sum(1 for j in fl_served
                               if math.isfinite(j.start_s))),
        "bg_mbits_offered": float(sum(j.size_mbits for j in bg_jobs)),
        "bg_mbits_served": float(sum(j.size_mbits for j in bg_done)),
        "sim_engine": "event",
    }
