"""Vectorized multi-PON hierarchical round — port of
``repro.pon.fast.hier`` (numpy).

The exact contract of ``metro.simulate_hier_round`` computed with arrays
over the uniform cfg-built forest: global ONU → PON routing is integer
division (PON-major ids), θ readiness is a segment max over the whole
forest, and the default paper path (``sfl``/``hier`` transport,
``sfl_queueing=False``, zero background load) never builds a topology
object or a per-job dataclass.

Queued workloads (``classical``, or ``sfl_queueing=True``) are served per
PON through :func:`repro_torch.pon.fast.engine.serve_queued` — exact FIFO
packing where that is bit-stable, the real event sim otherwise, and (under
``hybrid``) the fluid model on uncongested PONs. Background bursts are
drawn PON by PON through the real ``BackgroundTraffic``, so seeded runs
consume the RNG stream as the event engine does.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.obs.context import get as _obs_get
from repro_torch.pon.dba import make_dba
from repro_torch.pon.fast.engine import (
    SIM_ENGINES,
    _TrafficTopoView,
    fluid_congested,
    serve_queued,
    theta_ready_arr,
    uniform_onu_rate,
)
from repro_torch.pon.fast.segments import segment_max
from repro_torch.pon.timing import WIRELESS_S_MAX, WIRELESS_S_MIN, PonConfig, train_times
from repro_torch.pon.topology import Onu, Topology, Wavelength
from repro_torch.pon.traffic import BackgroundTraffic


def _pon_topo_factory(cfg: PonConfig):
    def build() -> Topology:
        return Topology.uniform(cfg.n_onus, cfg.clients_per_onu,
                                cfg.n_wavelengths, cfg.slice_mbps,
                                cfg.onu_link_mbps)
    return build


def _metro_topo_factory(cfg: PonConfig):
    def build() -> Topology:
        return Topology(
            onus=tuple(Onu(i, 0) for i in range(cfg.n_pons)),
            wavelengths=tuple(Wavelength(w, cfg.metro_rate_mbps)
                              for w in range(cfg.metro_wavelengths)))
    return build


def simulate_hier_round_fast(cfg: PonConfig, rng: np.random.Generator,
                             selected: np.ndarray, onu_ids: np.ndarray,
                             sample_counts: np.ndarray, mode: str,
                             obs=None) -> Dict:
    engine = cfg.sim_engine
    if engine not in SIM_ENGINES:
        raise ValueError(f"unknown sim_engine {engine!r}; "
                         f"expected one of {SIM_ENGINES}")
    if obs is None:
        obs = _obs_get()
    met = obs.metrics

    n_pons = cfg.n_pons
    total_onus = cfg.total_onus
    n = len(selected)
    t_train = train_times(sample_counts)[selected]
    t_wireless = rng.uniform(WIRELESS_S_MIN, WIRELESS_S_MAX, size=n)
    ready = cfg.downlink_s + t_train + t_wireless
    up = cfg.upload_s
    metro_up = cfg.metro_upload_s
    lat = cfg.metro_latency_s
    agg = cfg.onu_agg_s
    T = cfg.sync_threshold_s
    rate = uniform_onu_rate(cfg)

    onus_g = onu_ids[selected]
    if len(onus_g) and onus_g.max() >= total_onus:
        raise ValueError(
            f"global ONU id {int(onus_g.max())} out of range for a forest "
            f"of {total_onus} ONUs — onu_ids must be PON-major "
            "global ids (fedavg.onu_of_client)")
    pons = (onus_g // cfg.n_onus).astype(np.int64)

    cutoff_metro = T - agg
    cutoff_olt = cutoff_metro - lat - metro_up - agg
    if mode == "hier":
        cutoff_onu = cutoff_olt - up - agg
    else:
        cutoff_onu = T - lat - metro_up - up - agg

    # ---------------------------------------------------------- PON legs
    if mode == "classical":
        fl_ready = ready
        fl_pon = pons
        fl_onu_local = (onus_g % cfg.n_onus).astype(np.int64)
        fl_seq = np.arange(n, dtype=np.int64)
        fl_kind = "fl"
    else:
        in_time = ready <= cutoff_onu
        th_ready_full = theta_ready_arr(ready, onus_g, in_time,
                                        total_onus, agg)
        active_g = np.flatnonzero(np.isfinite(th_ready_full))
        fl_ready = th_ready_full[active_g]
        fl_pon = (active_g // cfg.n_onus).astype(np.int64)
        fl_onu_local = (active_g % cfg.n_onus).astype(np.int64)
        fl_seq = np.arange(len(active_g), dtype=np.int64)
        fl_kind = "theta"
    n_fl = len(fl_seq)
    seq_ctr = n_fl

    traffic = BackgroundTraffic(cfg.background_load, cfg.bg_burst_mbits)
    view = _TrafficTopoView(cfg.n_onus,
                            [cfg.slice_mbps] * cfg.n_wavelengths)
    bg_per_pon: List[list] = []
    for p in range(n_pons):
        bg = traffic.jobs(rng, view, T, seq_start=seq_ctr)
        seq_ctr += len(bg)
        bg_per_pon.append(bg)

    fl_start = np.full(n_fl, np.inf)
    fl_done = np.full(n_fl, np.inf)
    # (size, done) per bg job in the event engine's p-major draw order
    bg_sizes: List[float] = []
    bg_dones: List[float] = []
    pon_topo = _pon_topo_factory(cfg)

    if mode != "classical" and not cfg.sfl_queueing:
        # dedicated θ service across the whole forest in one shot — this
        # IS the fluid model, so event/fast/hybrid agree bit for bit
        if rate > 0.0:
            fl_start = fl_ready.copy()
            fl_done = fl_ready + cfg.model_mbits / rate
        for p in range(n_pons):
            bg = bg_per_pon[p]
            if bg:
                from repro_torch.pon.events import simulate_upstream
                simulate_upstream(bg, pon_topo(), make_dba(cfg.dba),
                                  metrics=met, lane=f"pon{p}")
            bg_sizes.extend(j.size_mbits for j in bg)
            bg_dones.extend(j.done_s for j in bg)
    else:
        order = np.argsort(fl_pon, kind="stable")
        sorted_pon = fl_pon[order]
        capacity = cfg.n_wavelengths * cfg.slice_mbps * T
        bg_tot = np.array([sum(j.size_mbits for j in bg)
                           for bg in bg_per_pon], np.float64)
        fl_tot = np.bincount(fl_pon, minlength=n_pons) * cfg.model_mbits
        congested = fluid_congested(fl_tot + bg_tot, capacity,
                                    cfg.fluid_threshold)
        lo = np.searchsorted(sorted_pon, np.arange(n_pons), side="left")
        hi = np.searchsorted(sorted_pon, np.arange(n_pons), side="right")
        for p in range(n_pons):
            idx = order[lo[p]:hi[p]]           # insertion order within p
            bg = bg_per_pon[p]
            nf, nb = len(idx), len(bg)
            if nf + nb == 0:
                continue
            r = np.concatenate([fl_ready[idx],
                                [j.ready_s for j in bg]])
            z = np.concatenate([np.full(nf, cfg.model_mbits),
                                [j.size_mbits for j in bg]])
            o = np.concatenate([fl_onu_local[idx],
                                [j.onu for j in bg]]).astype(np.int64)
            q = np.concatenate([fl_seq[idx],
                                [j.seq for j in bg]]).astype(np.int64)
            kinds = [fl_kind] * nf + ["bg"] * nb
            st, dn = serve_queued(
                r, z, o, q, kinds, dba_name=cfg.dba,
                n_lanes=cfg.n_wavelengths, rate_mbps=rate,
                topo_factory=pon_topo, engine=engine,
                congested=bool(congested[p]), metrics=met,
                lane=f"pon{p}")
            fl_start[idx] = st[:nf]
            fl_done[idx] = dn[:nf]
            bg_sizes.extend(z[nf:].tolist())
            bg_dones.extend(dn[nf:].tolist())

    # --------------------------------------------------------- metro leg
    p_order = np.argsort(fl_pon, kind="stable")
    if mode == "hier":
        ok = fl_done <= cutoff_olt
        phi_mx = segment_max(fl_done[ok], fl_pon[ok], n_pons)
        phi_ready_full = np.where(phi_mx > -np.inf, phi_mx + agg, np.inf)
        m_act = np.flatnonzero(np.isfinite(phi_ready_full))
        m_ready = phi_ready_full[m_act]
        m_onu = m_act.astype(np.int64)
        m_kind = "theta"
        m_src = None
    else:
        served = np.isfinite(fl_done[p_order])
        m_src = p_order[served]                # fl index per metro job
        m_ready = fl_done[m_src]
        m_onu = fl_pon[m_src]
        m_kind = fl_kind
    n_m = len(m_ready)
    m_seq = seq_ctr + np.arange(n_m, dtype=np.int64)
    seq_ctr += n_m

    if mode != "classical" and not cfg.sfl_queueing:
        if cfg.metro_rate_mbps > 0.0:
            m_done = m_ready + cfg.model_mbits / cfg.metro_rate_mbps
        else:
            m_done = np.full(n_m, np.inf)
    else:
        m_capacity = cfg.metro_wavelengths * cfg.metro_rate_mbps * T
        m_congested = bool(fluid_congested(n_m * cfg.model_mbits,
                                           m_capacity,
                                           cfg.fluid_threshold))
        _, m_done = serve_queued(
            m_ready, np.full(n_m, cfg.model_mbits), m_onu, m_seq,
            [m_kind] * n_m, dba_name=cfg.dba,
            n_lanes=cfg.metro_wavelengths, rate_mbps=cfg.metro_rate_mbps,
            topo_factory=_metro_topo_factory(cfg), engine=engine,
            congested=m_congested, metrics=met, lane="metro")

    # ------------------------------------------------- per-client t_done
    t_done = np.full(n, np.inf)
    m_fin = np.isfinite(m_done)
    if mode == "classical":
        t_done[m_src[m_fin]] = m_done[m_fin] + lat
        involved = t_done <= T
        trunk_mbits = float(n_m) * cfg.model_mbits
    elif mode == "sfl":
        theta_arrival = np.full(total_onus, np.inf)
        theta_arrival[active_g[m_src[m_fin]]] = m_done[m_fin] + lat
        t_done = np.where(in_time, theta_arrival[onus_g], np.inf)
        involved = t_done <= T
        trunk_mbits = float(n_m) * cfg.model_mbits
    else:  # hier
        phi_arrival = np.full(n_pons, np.inf)
        phi_arrival[m_onu[m_fin]] = m_done[m_fin] + lat
        phi_in = phi_arrival <= cutoff_metro
        theta_done_full = np.full(total_onus, np.inf)
        theta_done_full[active_g] = fl_done
        theta_in = theta_done_full[onus_g] <= cutoff_olt
        client_ok = in_time & theta_in & phi_in[pons]
        t_done = np.where(client_ok, phi_arrival[pons], np.inf)
        involved = t_done <= T
        trunk_mbits = cfg.model_mbits if phi_in.any() else 0.0

    # ---------------------------------------------- per-segment accounting
    pon_counts = np.bincount(fl_pon, minlength=n_pons).astype(np.float64)
    metro_counts = np.bincount(m_onu, minlength=n_pons).astype(np.float64)
    fin = np.isfinite(fl_start)
    delays = (fl_start - fl_ready)[p_order]
    delays = delays[fin[p_order]]
    bg_done_sizes = [z for z, d in zip(bg_sizes, bg_dones) if d <= T]
    return {
        "ready": ready,
        "t_done": t_done,
        "involved": involved.astype(np.float32),
        "upstream_mbits": float(pon_counts.sum()) * cfg.model_mbits,
        "upload_s": up,
        "dba": cfg.dba,
        "n_wavelengths": cfg.n_wavelengths,
        "grant_delay_s": float(np.mean(delays)) if len(delays) else 0.0,
        "n_fl_jobs": int(pon_counts.sum()),
        "n_fl_grants": int(fin.sum()),
        "bg_mbits_offered": float(sum(bg_sizes)),
        "bg_mbits_served": float(sum(bg_done_sizes)),
        "n_pons": n_pons,
        "pon_mbits_max": float(pon_counts.max() if n_pons else 0.0)
                         * cfg.model_mbits,
        "metro_mbits": float(metro_counts.sum()) * cfg.model_mbits,
        "metro_mbits_max": float(metro_counts.max() if n_pons else 0.0)
                           * cfg.model_mbits,
        "trunk_mbits": float(trunk_mbits),
        "n_metro_jobs": n_m,
        "sim_engine": engine,
    }
