"""Vectorized flat-PON round + the shared queued-serve dispatcher — port of
``repro.pon.fast.engine`` (numpy).

The fast engine is **exact-or-fallback**: every schedule it computes
itself is bit for bit the event heap's, and any workload it cannot
schedule exactly with arrays goes to the real ``UpstreamSim`` on a
lazily-built topology:

  * dedicated (grant-interleaved) service — ``start = ready``,
    ``done = ready + size/rate`` — vectorizes trivially and exactly;
  * FIFO-ordered queued service (``fifo``/``fixed``, or ``fl_priority``
    over a single kind class) packs exactly: one wavelength handles
    arbitrary job mixes, several wavelengths require equal service times
    and one job per transmitter (``segments.fifo_pack``);
  * ``tdma`` (stateful rotating cycle) and mixed-kind ``fl_priority``
    fall back to the event sim;
  * ``ipact`` ALWAYS falls back — its backlog-proportional grants are
    load-dependent.

The ``hybrid`` engine relaxes the fallback: a queued workload the arrays
cannot pack is served with the closed-form **fluid** model
(contention-free, ``done = ready + size/rate``) when its PON is
uncongested — offered Mbits within ``fluid_threshold`` of what the shared
medium carries before the deadline — and by the exact event sim when
congested; never for ``ipact``. The reference's ``metrics=`` recording is
left out until the port has ``repro.obs`` (ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.pon.dba import make_dba
from repro_torch.pon.fast.segments import fifo_pack, segment_max
from repro_torch.pon.timing import WIRELESS_S_MAX, WIRELESS_S_MIN, PonConfig, train_times
from repro_torch.pon.topology import Topology
from repro_torch.pon.traffic import BackgroundTraffic

SIM_ENGINES = ("event", "fast", "hybrid")

# DBA policies whose grant order is exactly FIFO (over one kind class)
_FIFO_LIKE = ("fifo", "fixed")


def uniform_onu_rate(cfg: PonConfig) -> float:
    """Effective per-ONU transmit rate in the uniform cfg-built tree —
    what ``Topology.rate_mbps``/``best_rate_mbps`` resolve to when every
    wavelength runs at ``slice_mbps`` and every drop link is equal."""
    if cfg.onu_link_mbps is None:
        return cfg.slice_mbps
    return min(cfg.slice_mbps, cfg.onu_link_mbps)


def fluid_congested(offered_mbits, capacity_mbits, threshold: float):
    """The hybrid engine's congestion flag (scalar or array): the Mbits
    offered before the deadline exceed ``threshold`` × what the shared
    medium can carry in that window (``capacity_mbits`` is rate × the
    deadline)."""
    return np.asarray(offered_mbits) > threshold * np.asarray(capacity_mbits)


class _OnuIdView:
    __slots__ = ("id",)

    def __init__(self, i: int):
        self.id = i


class _TrafficTopoView:
    """Duck-typed stand-in for ``Topology`` accepted by
    ``BackgroundTraffic.jobs`` (which only reads ``total_rate_mbps()``,
    ``n_onus`` and iterates ``onus`` for ids) — draws the exact same RNG
    stream without materializing ``n_onus`` Onu dataclasses."""

    def __init__(self, n_onus: int, wavelength_rates: List[float]):
        self.n_onus = n_onus
        self._rates = wavelength_rates

    def total_rate_mbps(self) -> float:
        return sum(self._rates)

    @property
    def onus(self):
        return (_OnuIdView(i) for i in range(self.n_onus))


def traffic_view(cfg: PonConfig) -> _TrafficTopoView:
    """The per-PON-tree view for background draws under ``cfg``."""
    return _TrafficTopoView(cfg.n_onus,
                            [cfg.slice_mbps] * cfg.n_wavelengths)


def _pack_lanes(dba_name: str, kinds, n_lanes: int, service: np.ndarray,
                onu: np.ndarray) -> Optional[int]:
    """Lane count to pack with, or None when packing wouldn't be exact."""
    if dba_name in _FIFO_LIKE:
        pass
    elif dba_name == "fl_priority" and len(set(kinds)) <= 1:
        pass                    # one kind class: priority order IS fifo order
    else:
        return None
    if n_lanes <= 1:
        return 1
    # multi-lane round-robin chains are exact only for equal service times
    # with at most one job per transmitter (see segments.fifo_pack)
    if len(service) and not (service == service[0]).all():
        return None
    if len(np.unique(onu)) != len(onu):
        return None
    return n_lanes


def serve_queued(ready: np.ndarray, size: np.ndarray, onu: np.ndarray,
                 seq: np.ndarray, kinds, *, dba_name: str, n_lanes: int,
                 rate_mbps: float, topo_factory, engine: str,
                 congested: bool = False):
    """Serve one queued job set; returns ``(start, done)`` float64 arrays
    aligned with the inputs. Exact (pack or event fallback) under
    ``engine='fast'``; under ``'hybrid'`` an unpackable, uncongested,
    non-ipact workload is served with the fluid model instead.
    """
    n = len(ready)
    if n == 0:
        e = np.empty(0, np.float64)
        return e, e.copy()
    if rate_mbps <= 0.0:
        inf = np.full(n, np.inf)
        return inf, inf.copy()
    service = np.asarray(size, np.float64) / rate_mbps
    lanes = _pack_lanes(dba_name, kinds, n_lanes, service, onu)

    if dba_name == "ipact":
        route = "event"     # load-dependent grants: never approximated
    elif lanes is not None:
        route = "pack"
    elif engine == "hybrid" and not congested:
        route = "fluid"
    else:
        route = "event"

    if route == "event":
        from repro_torch.pon.events import UpstreamJob, simulate_upstream
        jobs = [UpstreamJob(seq=int(seq[k]), onu=int(onu[k]),
                            size_mbits=float(size[k]),
                            ready_s=float(ready[k]), kind=str(kinds[k]))
                for k in range(n)]
        simulate_upstream(jobs, topo_factory(), make_dba(dba_name))
        start = np.array([j.start_s for j in jobs], np.float64)
        done = np.array([j.done_s for j in jobs], np.float64)
        return start, done

    if route == "pack":
        order = np.lexsort((seq, ready))        # the DBAs' _fifo_key
        st_s, dn_s = fifo_pack(ready[order], service[order], lanes)
        start = np.empty(n, np.float64)
        done = np.empty(n, np.float64)
        start[order] = st_s
        done[order] = dn_s
    else:                                       # fluid
        start = np.asarray(ready, np.float64).copy()
        done = ready + service
    return start, done


def _bg_arrays(bg_jobs):
    """Ready/size/onu/seq arrays off a BackgroundTraffic job list."""
    m = len(bg_jobs)
    ready = np.array([j.ready_s for j in bg_jobs], np.float64)
    size = np.array([j.size_mbits for j in bg_jobs], np.float64)
    onu = np.array([j.onu for j in bg_jobs], np.int64)
    seq = np.array([j.seq for j in bg_jobs], np.int64)
    return m, ready, size, onu, seq


def theta_ready_arr(ready: np.ndarray, onus: np.ndarray,
                    in_time: np.ndarray, n_onus: int,
                    agg_s: float) -> np.ndarray:
    """Per-ONU θ ready time (+inf for ONUs with no in-time client):
    the vectorized twin of the event path's per-group ``arr.max() + agg``.
    """
    mask = np.asarray(in_time, bool)
    mx = segment_max(np.asarray(ready, np.float64)[mask],
                     np.asarray(onus)[mask], n_onus)
    return np.where(mx > -np.inf, mx + agg_s, np.inf)


def simulate_round_fast(cfg: PonConfig, rng: np.random.Generator,
                        selected: np.ndarray, onu_ids: np.ndarray,
                        sample_counts: np.ndarray, mode: str) -> Dict:
    """Flat (single-PON) round under the fast/hybrid engine — the exact
    contract of ``events.simulate_round`` with ``sim_engine`` stamped.
    """
    engine = cfg.sim_engine
    if engine not in SIM_ENGINES:
        raise ValueError(f"unknown sim_engine {engine!r}; "
                         f"expected one of {SIM_ENGINES}")
    if mode == "hier":
        mode = "sfl"

    n = len(selected)
    t_train = train_times(sample_counts)[selected]
    t_wireless = rng.uniform(WIRELESS_S_MIN, WIRELESS_S_MAX, size=n)
    ready = cfg.downlink_s + t_train + t_wireless
    up = cfg.upload_s
    T = cfg.sync_threshold_s
    rate = uniform_onu_rate(cfg)
    traffic = BackgroundTraffic(cfg.background_load, cfg.bg_burst_mbits)
    view = traffic_view(cfg)

    def topo():
        return Topology.uniform(cfg.n_onus, cfg.clients_per_onu,
                                cfg.n_wavelengths, cfg.slice_mbps,
                                cfg.onu_link_mbps)

    capacity = cfg.n_wavelengths * cfg.slice_mbps * T

    if mode == "classical":
        bg_jobs = traffic.jobs(rng, view, T, seq_start=n)
        nb, bg_ready, bg_size, bg_onu, bg_seq = _bg_arrays(bg_jobs)
        all_ready = np.concatenate([ready, bg_ready])
        all_size = np.concatenate([np.full(n, cfg.model_mbits), bg_size])
        all_onu = np.concatenate([onu_ids[selected].astype(np.int64),
                                  bg_onu])
        all_seq = np.concatenate([np.arange(n, dtype=np.int64), bg_seq])
        all_kind = ["fl"] * n + ["bg"] * nb
        congested = bool(fluid_congested(float(all_size.sum()),
                                         capacity, cfg.fluid_threshold))
        start, done = serve_queued(
            all_ready, all_size, all_onu, all_seq, all_kind,
            dba_name=cfg.dba, n_lanes=cfg.n_wavelengths, rate_mbps=rate,
            topo_factory=topo, engine=engine, congested=congested)
        t_done = done[:n]
        involved = t_done <= T
        upstream_mbits = float(n) * cfg.model_mbits
        fl_start, fl_ready = start[:n], ready
        bg_done_mask = done[n:] <= T
        bg_offered = float(sum(bg_size.tolist()))
        bg_served = float(sum(bg_size[bg_done_mask].tolist()))
    else:
        onus = onu_ids[selected]
        cutoff = T - up - cfg.onu_agg_s
        in_time = ready <= cutoff
        th_ready_full = theta_ready_arr(ready, onus, in_time, cfg.n_onus,
                                        cfg.onu_agg_s)
        active = np.flatnonzero(np.isfinite(th_ready_full))
        th_ready = th_ready_full[active]
        na = len(active)
        bg_jobs = traffic.jobs(rng, view, T, seq_start=na)
        nb, bg_ready, bg_size, bg_onu, bg_seq = _bg_arrays(bg_jobs)
        if cfg.sfl_queueing:
            all_ready = np.concatenate([th_ready, bg_ready])
            all_size = np.concatenate([np.full(na, cfg.model_mbits),
                                       bg_size])
            all_onu = np.concatenate([active.astype(np.int64), bg_onu])
            all_seq = np.concatenate([np.arange(na, dtype=np.int64),
                                      bg_seq])
            all_kind = ["theta"] * na + ["bg"] * nb
            congested = bool(fluid_congested(float(all_size.sum()),
                                             capacity,
                                             cfg.fluid_threshold))
            start, done = serve_queued(
                all_ready, all_size, all_onu, all_seq, all_kind,
                dba_name=cfg.dba, n_lanes=cfg.n_wavelengths,
                rate_mbps=rate, topo_factory=topo, engine=engine,
                congested=congested)
            th_start, th_done = start[:na], done[:na]
            bg_done_mask = done[na:] <= T
        else:
            # paper-consistent grant interleaving: each θ sees a private
            # slice — the dedicated serve IS the fluid model, so fast,
            # hybrid and event agree exactly here
            if rate > 0.0:
                th_start = th_ready.copy()
                th_done = th_ready + cfg.model_mbits / rate
            else:           # starved tree: matches _dedicated_serve's +inf
                th_start = np.full(na, np.inf)
                th_done = np.full(na, np.inf)
            if bg_jobs:
                from repro_torch.pon.events import simulate_upstream
                simulate_upstream(bg_jobs, topo(), make_dba(cfg.dba))
            bg_done_mask = np.array([j.done_s <= T for j in bg_jobs],
                                    bool)
        th_done_full = np.full(cfg.n_onus, np.inf)
        th_done_full[active] = th_done
        t_done = np.where(in_time, th_done_full[onus], np.inf)
        involved = t_done <= T
        upstream_mbits = float(na) * cfg.model_mbits
        fl_start, fl_ready = th_start, th_ready
        bg_offered = float(sum(bg_size.tolist()))
        bg_served = float(sum(bg_size[bg_done_mask].tolist()))

    fin = np.isfinite(fl_start)
    starts = (fl_start - fl_ready)[fin]
    return {
        "ready": ready,
        "t_done": t_done,
        "involved": involved.astype(np.float32),
        "upstream_mbits": upstream_mbits,
        "upload_s": up,
        "dba": make_dba(cfg.dba).name,
        "n_wavelengths": cfg.n_wavelengths,
        "grant_delay_s": float(starts.mean()) if len(starts) else 0.0,
        "n_fl_jobs": len(fl_start),
        "n_fl_grants": int(fin.sum()),
        "bg_mbits_offered": bg_offered,
        "bg_mbits_served": bg_served,
        "sim_engine": engine,
    }
