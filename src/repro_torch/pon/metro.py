"""Multi-PON hierarchy: a forest of PON trees feeding a metro tier — port
of ``repro.pon.metro`` (numpy and plain Python).

``n_pons`` access trees hang off one metro node, and the k-step protocol

    ONU partial-agg (θ)  →  OLT agg (Φ)  →  metro agg (Ψ)  →  server

keeps the traffic on every segment — each PON's upstream, each OLT→metro
uplink, and the metro→server trunk — constant in both the client count and
the PON count (DESIGN.md §12).

``MetroTopology`` is the forest: N per-PON ``Topology`` trees plus the
OLT→metro segment, itself one more ``Topology`` (OLTs are the "ONUs" of
the metro tier). The round transport (:func:`simulate_hier_round`) runs one
``UpstreamSim`` per PON plus a metro-segment sim:

  * ``mode='hier'``: θs cross each PON, the OLT aggregates its in-time θs
    into one Φ, the Φs cross the (shared) metro segment, the metro node
    aggregates in-time Φs into one Ψ for the server. The cutoff heuristic
    mirrors the ONU one at every tier, working backward from the deadline.
  * ``mode='sfl'``: the flat two-step baseline over the same forest — each
    θ individually crosses the metro segment, so the trunk grows with the
    total ONU count.
  * ``mode='classical'``: every client's full model crosses its PON and
    the metro segment.

``n_pons == 1`` never reaches this module: ``events.simulate_round`` keeps
the single-OLT case on the flat path. The metro→server trunk is accounted
(``trunk_mbits``) but not queued. The round records the per-PON and metro
DBA metrics into the run's ``repro_torch.obs`` registry and, under an
enabled tracer, the θ-gather, Φ-gather and Ψ-agg windows and the grant
spans on the ``pon{p}`` and ``metro`` (``olt{p}``) lanes; neither moves a
returned value or an RNG draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.pon.dba import make_dba
from repro_torch.pon.timing import WIRELESS_S_MAX, WIRELESS_S_MIN, PonConfig, train_times
from repro_torch.pon.topology import Onu, Topology, Wavelength
from repro_torch.pon.traffic import BackgroundTraffic


@dataclasses.dataclass(frozen=True)
class MetroTopology:
    """A forest of PON trees plus the OLT→metro shared segment.

    ``pons`` are the per-PON access trees (arbitrary shapes); the metro
    segment is :meth:`metro_segment`, a ``Topology`` whose "ONUs" are the
    OLTs — one upstream transmitter per PON, sharing ``metro_wavelengths``
    channels at ``metro_rate_mbps``.
    """

    pons: Tuple[Topology, ...]
    metro_rate_mbps: float = 1000.0
    metro_latency_ms: float = 0.5
    metro_wavelengths: int = 1

    @property
    def n_pons(self) -> int:
        return len(self.pons)

    @property
    def n_clients(self) -> int:
        return sum(p.n_clients for p in self.pons)

    @property
    def total_onus(self) -> int:
        return sum(p.n_onus for p in self.pons)

    @property
    def metro_latency_s(self) -> float:
        return self.metro_latency_ms / 1e3

    def onu_of_client(self) -> np.ndarray:
        """Client → GLOBAL ONU id (PON-major, then ONU-major)."""
        parts, base = [], 0
        for p in self.pons:
            parts.append(p.onu_of_client() + base)
            base += p.n_onus
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    def pon_of_onu(self, onu_global: np.ndarray) -> np.ndarray:
        """Global ONU id → PON index."""
        bounds = np.cumsum([p.n_onus for p in self.pons])
        return np.searchsorted(bounds, np.asarray(onu_global), side="right")

    def metro_segment(self) -> Topology:
        """The OLT→metro tier as a Topology (OLTs ≙ ONUs, recursive)."""
        return Topology(
            onus=tuple(Onu(i, 0) for i in range(self.n_pons)),
            wavelengths=tuple(Wavelength(w, self.metro_rate_mbps)
                              for w in range(self.metro_wavelengths)),
        )

    @classmethod
    def uniform(cls, n_pons: int, n_onus: int = 16, clients_per_onu: int = 20,
                n_wavelengths: int = 1, rate_mbps: float = 100.0,
                onu_link_mbps: Optional[float] = None,
                metro_rate_mbps: float = 1000.0,
                metro_latency_ms: float = 0.5,
                metro_wavelengths: int = 1) -> "MetroTopology":
        """N copies of the paper-style symmetric tree under one metro node."""
        return cls(
            pons=tuple(Topology.uniform(n_onus, clients_per_onu,
                                        n_wavelengths, rate_mbps,
                                        onu_link_mbps)
                       for _ in range(n_pons)),
            metro_rate_mbps=metro_rate_mbps,
            metro_latency_ms=metro_latency_ms,
            metro_wavelengths=metro_wavelengths,
        )

    @classmethod
    def from_config(cls, cfg: PonConfig) -> "MetroTopology":
        return cls.uniform(cfg.n_pons, cfg.n_onus, cfg.clients_per_onu,
                           cfg.n_wavelengths, cfg.slice_mbps,
                           cfg.onu_link_mbps, cfg.metro_rate_mbps,
                           cfg.metro_latency_ms, cfg.metro_wavelengths)


def expected_segment_mbits(mode: str, model_mbits: float, n_selected: int,
                           n_active_onus: int, n_active_pons: int) -> Dict[str, float]:
    """Closed-form per-segment budget for one round (the tests' oracle).

    ``n_selected``/``n_active_onus`` are totals across the forest. Returns
    the offered Mbits on each segment class: ``pon`` (all PON upstream
    trees together), ``metro`` (the OLT→metro segment), ``trunk``
    (metro→server).
    """
    if mode == "classical":
        pon = metro = trunk = n_selected * model_mbits
    elif mode == "sfl":
        pon = metro = trunk = n_active_onus * model_mbits
    elif mode == "hier":
        pon = n_active_onus * model_mbits
        metro = n_active_pons * model_mbits
        trunk = model_mbits if n_active_pons else 0.0
    else:
        raise ValueError(f"unknown transport mode {mode!r}")
    return {"pon": float(pon), "metro": float(metro), "trunk": float(trunk)}


def trace_hier_tiers(trc, cfg: PonConfig, mode: str, selected: np.ndarray,
                     t_train: np.ndarray, ready: np.ndarray,
                     pon_jobs, metro_jobs, cutoff_olt: float) -> None:
    """Retroactive tier spans for one hierarchical round: client legs,
    metro grant spans (one lane per OLT), Φ-gather windows per OLT, and
    the server-side Ψ aggregation window (``mode='hier'`` only — the flat
    modes have no OLT/metro aggregation tiers)."""
    from repro_torch.pon import events

    events.trace_client_legs(trc, cfg, selected, t_train, ready)
    events.trace_served_jobs(trc, metro_jobs, "metro", tid_prefix="olt")
    if mode != "hier":
        return
    agg = cfg.onu_agg_s
    lat = cfg.metro_latency_s
    for p, jobs in enumerate(pon_jobs):
        done = [j.done_s for j in jobs if j.done_s <= cutoff_olt]
        if done:
            # Φ_p gathers PON p's in-time θs: first θ done → Φ ready
            trc.add_span("Φ-gather", min(done), max(done) + agg,
                         lane=("metro", f"olt{p}"), cat="agg",
                         args={"thetas": len(done)})
    arrivals = [mj.done_s + lat for mj in metro_jobs
                if math.isfinite(mj.done_s)]
    in_time = [a for a in arrivals if a <= cfg.sync_threshold_s - agg]
    if in_time:
        trc.add_span("Ψ-agg", min(arrivals), max(in_time) + agg,
                     lane=("server", "agg"), cat="agg",
                     args={"phis": len(in_time)})


def simulate_hier_round(cfg: PonConfig, rng: np.random.Generator,
                        selected: np.ndarray, onu_ids: np.ndarray,
                        sample_counts: np.ndarray, mode: str,
                        metro: Optional[MetroTopology] = None,
                        obs=None) -> Dict:
    """One FL round over the PON forest; same contract as ``round_times``.

    ``onu_ids`` are GLOBAL ONU ids in ``[0, n_pons * n_onus)`` (PON-major,
    what ``fedavg.onu_of_client`` gives once ``FLConfig.n_pons`` multiplies
    the population). RNG consumption: one wireless draw per selected
    client in selection order, then the background draws one PON at a time
    (none at zero load). ``obs`` defaults to the ambient
    ``repro_torch.obs`` context.
    """
    from repro_torch.obs.context import get as _obs_get
    from repro_torch.pon import events

    if obs is None:
        obs = _obs_get()
    trc = obs.tracer if getattr(obs.tracer, "enabled", False) else None
    met = obs.metrics

    if metro is None and getattr(cfg, "sim_engine", "event") != "event":
        # array-native engines: only the cfg-built uniform forest
        # vectorizes; an explicit MetroTopology stays exact
        from repro_torch.pon.fast import simulate_hier_round_fast
        return simulate_hier_round_fast(cfg, rng, selected, onu_ids,
                                        sample_counts, mode, obs=obs)
    if metro is None:
        metro = MetroTopology.from_config(cfg)
    n_pons = metro.n_pons
    # per-tree ONU-id bases: global id = onu_base[pon] + local id (skewed
    # custom forests included)
    onu_base = np.concatenate([[0], np.cumsum([p.n_onus
                                               for p in metro.pons])])

    n = len(selected)
    t_train = train_times(sample_counts)[selected]
    t_wireless = rng.uniform(WIRELESS_S_MIN, WIRELESS_S_MAX, size=n)
    ready = cfg.downlink_s + t_train + t_wireless
    up = cfg.upload_s
    metro_up = cfg.metro_upload_s
    lat = cfg.metro_latency_s
    agg = cfg.onu_agg_s
    T = cfg.sync_threshold_s

    onus_g = onu_ids[selected]
    if len(onus_g) and onus_g.max() >= metro.total_onus:
        raise ValueError(
            f"global ONU id {int(onus_g.max())} out of range for a forest "
            f"of {metro.total_onus} ONUs — onu_ids must be PON-major "
            "global ids (fedavg.onu_of_client)")
    pons = metro.pon_of_onu(onus_g)

    # tier cutoffs, working backward from the server deadline: each
    # aggregation point stops waiting when a late arrival could no longer
    # reach the next tier in time — the ONU heuristic, applied recursively
    cutoff_metro = T - agg                              # metro agg ends by T
    cutoff_olt = cutoff_metro - lat - metro_up - agg    # Φ leaves the OLT
    if mode == "hier":
        cutoff_onu = cutoff_olt - up - agg
    else:
        # flat sfl over the forest: the θ itself crosses the metro segment
        cutoff_onu = T - lat - metro_up - up - agg

    # ---------------------------------------------------------- PON legs
    pon_jobs: List[List[events.UpstreamJob]] = [[] for _ in range(n_pons)]
    onu_global_of: Dict[int, int] = {}   # pon-leg job seq → global ONU id
    seq = 0
    if mode == "classical":
        for i in range(n):
            p = int(pons[i])
            pon_jobs[p].append(events.UpstreamJob(
                seq=seq, onu=int(onus_g[i] - onu_base[p]),
                size_mbits=cfg.model_mbits, ready_s=ready[i], kind="fl",
                client=int(selected[i])))
            onu_global_of[seq] = int(onus_g[i])
            seq += 1
    else:
        in_time = ready <= cutoff_onu
        theta_ready = np.full(metro.total_onus, np.inf)
        for o in np.unique(onus_g):
            arr = ready[(onus_g == o) & in_time]
            if len(arr):
                theta_ready[o] = arr.max() + agg
        for o in np.where(np.isfinite(theta_ready))[0]:
            p = int(metro.pon_of_onu(o))
            pon_jobs[p].append(events.UpstreamJob(
                seq=seq, onu=int(o - onu_base[p]),
                size_mbits=cfg.model_mbits, ready_s=theta_ready[o],
                kind="theta"))
            onu_global_of[seq] = int(o)
            seq += 1
            if trc is not None:
                arr = ready[(onus_g == o) & in_time]
                trc.add_span("θ-gather", float(arr.min()),
                             float(theta_ready[o]),
                             lane=(f"pon{p}", f"onu{int(o - onu_base[p])}"),
                             cat="agg", args={"clients": int(len(arr))})

    bg_all: List[events.UpstreamJob] = []
    grant_delays: List[float] = []
    for p in range(n_pons):
        topo = metro.pons[p]
        traffic = BackgroundTraffic(cfg.background_load, cfg.bg_burst_mbits)
        bg = traffic.jobs(rng, topo, T, seq_start=seq)
        seq += len(bg)
        if mode != "classical" and not cfg.sfl_queueing:
            # paper-consistent grant interleaving: θs see a private slice;
            # background contends only in the stats
            events._dedicated_serve(pon_jobs[p], topo)
            if bg:
                events.simulate_upstream(bg, topo, make_dba(cfg.dba),
                                         metrics=met, lane=f"pon{p}")
        else:
            events.simulate_upstream(pon_jobs[p] + bg, topo,
                                     make_dba(cfg.dba),
                                     metrics=met, lane=f"pon{p}")
        if trc is not None:
            events.trace_served_jobs(trc, pon_jobs[p], f"pon{p}")
            events.trace_served_jobs(trc, bg, f"pon{p}")
        bg_all.extend(bg)
        grant_delays.extend(j.start_s - j.ready_s for j in pon_jobs[p]
                            if math.isfinite(j.start_s))

    flat_pon_jobs = [j for jobs in pon_jobs for j in jobs]

    # --------------------------------------------------------- metro leg
    metro_topo = metro.metro_segment()
    metro_jobs: List[events.UpstreamJob] = []
    metro_src: List[Optional[events.UpstreamJob]] = []  # forwarded pon job
    if mode == "hier":
        # OLT agg: Φ_p forms from PON p's in-time θs (θ_done <= cutoff_olt)
        phi_ready = np.full(n_pons, np.inf)
        for p in range(n_pons):
            done = [j.done_s for j in pon_jobs[p] if j.done_s <= cutoff_olt]
            if done:
                phi_ready[p] = max(done) + agg
        for p in np.where(np.isfinite(phi_ready))[0]:
            metro_jobs.append(events.UpstreamJob(
                seq=seq, onu=int(p), size_mbits=cfg.model_mbits,
                ready_s=phi_ready[p], kind="theta"))
            metro_src.append(None)
            seq += 1
    else:
        # flat modes: every served pon-leg job is forwarded, one metro job
        # each, from its source OLT (the metro tier's "ONU")
        for p in range(n_pons):
            for j in pon_jobs[p]:
                if not math.isfinite(j.done_s):
                    continue
                metro_jobs.append(events.UpstreamJob(
                    seq=seq, onu=p, size_mbits=cfg.model_mbits,
                    ready_s=j.done_s, kind=j.kind, client=j.client))
                metro_src.append(j)
                seq += 1
    # service discipline mirrors the PON leg: under the interleaved mode
    # (sfl_queueing=False) aggregate uploads see a private slice at every
    # tier; sfl_queueing=True queues them through the metro DBA. Classical
    # raw models always queue.
    if mode != "classical" and not cfg.sfl_queueing:
        events._dedicated_serve(metro_jobs, metro_topo)
    else:
        events.simulate_upstream(metro_jobs, metro_topo, make_dba(cfg.dba),
                                 metrics=met, lane="metro")
    if trc is not None:
        trace_hier_tiers(trc, cfg, mode, selected, t_train, ready,
                         pon_jobs, metro_jobs, cutoff_olt)

    # ------------------------------------------------- per-client t_done
    t_done = np.full(n, np.inf)
    if mode == "classical":
        arrival = {}        # client -> server arrival time
        for mj in metro_jobs:
            if math.isfinite(mj.done_s):
                arrival[mj.client] = mj.done_s + lat
        for i in range(n):
            t_done[i] = arrival.get(int(selected[i]), np.inf)
        involved = t_done <= T
        trunk_mbits = float(len(metro_jobs)) * cfg.model_mbits
    elif mode == "sfl":
        theta_arrival = np.full(metro.total_onus, np.inf)
        for mj, src in zip(metro_jobs, metro_src):
            if math.isfinite(mj.done_s):
                theta_arrival[onu_global_of[src.seq]] = mj.done_s + lat
        in_time = ready <= cutoff_onu
        t_done = np.where(in_time, theta_arrival[onus_g], np.inf)
        involved = t_done <= T
        trunk_mbits = float(len(metro_jobs)) * cfg.model_mbits
    else:  # hier
        phi_arrival = np.full(n_pons, np.inf)
        for mj in metro_jobs:
            if math.isfinite(mj.done_s):
                phi_arrival[mj.onu] = mj.done_s + lat
        phi_in = phi_arrival <= cutoff_metro
        theta_done = np.full(metro.total_onus, np.inf)
        for jobs in pon_jobs:
            for j in jobs:
                theta_done[onu_global_of[j.seq]] = j.done_s
        in_time = ready <= cutoff_onu
        theta_in = theta_done[onus_g] <= cutoff_olt
        client_ok = in_time & theta_in & phi_in[pons]
        t_done = np.where(client_ok, phi_arrival[pons], np.inf)
        involved = t_done <= T
        trunk_mbits = cfg.model_mbits if phi_in.any() else 0.0

    # ---------------------------------------------- per-segment accounting
    pon_counts = np.array([len(jobs) for jobs in pon_jobs], np.float64)
    metro_counts = np.zeros(n_pons, np.float64)
    for mj in metro_jobs:
        metro_counts[mj.onu] += 1.0
    upstream_mbits = float(pon_counts.sum()) * cfg.model_mbits
    bg_done = [j for j in bg_all if j.done_s <= T]
    return {
        "ready": ready,
        "t_done": t_done,
        "involved": involved.astype(np.float32),
        "upstream_mbits": upstream_mbits,
        "upload_s": up,
        "dba": cfg.dba,
        "n_wavelengths": cfg.n_wavelengths,
        "grant_delay_s": (float(np.mean(grant_delays))
                          if grant_delays else 0.0),
        "n_fl_jobs": int(pon_counts.sum()),
        "n_fl_grants": int(sum(1 for j in flat_pon_jobs
                               if math.isfinite(j.start_s))),
        "bg_mbits_offered": float(sum(j.size_mbits for j in bg_all)),
        "bg_mbits_served": float(sum(j.size_mbits for j in bg_done)),
        # hierarchy extras (absent from the flat path):
        "n_pons": n_pons,
        "pon_mbits_max": float(pon_counts.max() if n_pons else 0.0)
                         * cfg.model_mbits,
        "metro_mbits": float(metro_counts.sum()) * cfg.model_mbits,
        "metro_mbits_max": float(metro_counts.max() if n_pons else 0.0)
                           * cfg.model_mbits,
        "trunk_mbits": float(trunk_mbits),
        "n_metro_jobs": len(metro_jobs),
        "sim_engine": "event",
    }
