"""PON round-timing model — port of ``repro.pon.timing``.

One-round synchronization time for client (i,j):
    T_ij = T^d + T^r_ij + T^w_ij + T^u_ij
with the paper's constants: T^d = 2 s broadcast, T^r ∈ [3, 20] s
proportional to |D_ij|, T^w ~ U[1, 5] s wireless, and the model crossing
the PON upstream; a client done after the 25 s deadline is a straggler,
excluded from aggregation.

The model update is 26.416 MBytes (211.3 Mbit, 2.113 s per model on the
reserved 100 Mb/s slice; DESIGN.md §8's unit correction). With
``sfl_queueing=False`` (the paper-consistent default) each ONU's θ sees a
contention-free slice; ``True`` queues the θs through the DBA.

:func:`round_times` is the event simulator (``pon.events``), whose
``PonConfig`` knobs pick the DBA policy, the TWDM wavelengths, the
background load, the metro forest and the engine; :func:`round_times_fifo`
is the closed form it equals bit for bit under the defaults (one
wavelength, FIFO grants, no background load, one PON). A numpy module,
like the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

MODEL_UPDATE_MBITS = 26.416 * 8.0   # 26.416 MBytes (DESIGN.md §8 unit correction)
DOWNLINK_S = 2.0
TRAIN_S_MIN, TRAIN_S_MAX = 3.0, 20.0
WIRELESS_S_MIN, WIRELESS_S_MAX = 1.0, 5.0
SLICE_MBPS = 100.0
SYNC_THRESHOLD_S = 25.0
ONU_AGG_S = 0.05                    # θ weighted-add at the ONU (layer-2 op)


@dataclasses.dataclass(frozen=True)
class PonConfig:
    n_onus: int = 16                # ONUs per PON tree
    clients_per_onu: int = 20
    slice_mbps: float = SLICE_MBPS
    model_mbits: float = MODEL_UPDATE_MBITS
    sync_threshold_s: float = SYNC_THRESHOLD_S
    downlink_s: float = DOWNLINK_S  # repro: noqa(REPRO501) paper constant T^d
    onu_agg_s: float = ONU_AGG_S    # repro: noqa(REPRO501) paper constant
    sfl_queueing: bool = False      # True = θ uploads queue through the DBA
    # --- event-simulator knobs (events.py); the defaults reproduce the
    # paper's fixed-slice FIFO model bit for bit ---
    n_wavelengths: int = 1          # TWDM upstream wavelengths
    dba: str = "fifo"               # grant policy (see pon/dba.py)
    background_load: float = 0.0    # offered bg load ÷ total capacity
    bg_burst_mbits: float = 5.0     # mean background burst size
    onu_link_mbps: Optional[float] = None   # per-ONU drop-link cap
    # --- multi-PON hierarchy (pon/metro.py). n_pons == 1 is the single-OLT
    # paper setting: the metro tier exists only for n_pons >= 2 ---
    n_pons: int = 1                 # PON trees feeding the metro node
    metro_rate_mbps: float = 1000.0  # OLT→metro shared-segment channel rate
    metro_latency_ms: float = 0.5   # per-hop metro propagation latency
    metro_wavelengths: int = 1      # channels on the OLT→metro segment
    # --- simulator engine (pon/fast/). "event" is the exact heap
    # simulator; "fast" vectorizes the schedules it can compute exactly and
    # falls back to the event sim otherwise; "hybrid" also serves
    # unpackable uncongested PONs with the closed-form fluid model (ipact
    # always stays exact) ---
    sim_engine: str = "event"       # event | fast | hybrid
    fluid_threshold: float = 0.8    # hybrid: offered ÷ capacity·deadline
                                    # above this flags a PON congested

    @property
    def n_clients(self) -> int:
        """Total client population (across all PON trees)."""
        return self.n_pons * self.n_onus * self.clients_per_onu

    @property
    def total_onus(self) -> int:
        return self.n_pons * self.n_onus

    @property
    def upload_s(self) -> float:
        return self.model_mbits / self.slice_mbps

    @property
    def metro_upload_s(self) -> float:
        """One model crossing an OLT→metro channel."""
        return self.model_mbits / self.metro_rate_mbps

    @property
    def metro_latency_s(self) -> float:
        return self.metro_latency_ms / 1e3


def add_pon_cli_args(ap) -> None:
    """Attach the event-simulator transport flags to an argparse parser
    (the reference's flag set and defaults, read off PonConfig)."""
    d = PonConfig()
    ap.add_argument("--dba", default=d.dba,
                    help="grant scheduler: fifo|tdma|ipact|fl_priority")
    ap.add_argument("--wavelengths", type=int, default=d.n_wavelengths,
                    help="TWDM upstream wavelength count")
    ap.add_argument("--bg-load", type=float, default=d.background_load,
                    help="background upstream load ÷ total PON capacity")
    ap.add_argument("--onus", type=int, default=d.n_onus)
    ap.add_argument("--clients-per-onu", type=int, default=d.clients_per_onu)
    ap.add_argument("--sfl-queueing", action="store_true",
                    help="θ uploads queue through the DBA (strict)")
    ap.add_argument("--slice-mbps", type=float, default=d.slice_mbps,
                    help="reserved FL upstream slice rate (paper: 100)")
    ap.add_argument("--model-mbits", type=float, default=d.model_mbits,
                    help="model-update size on the wire in Mbits (paper "
                         "CNN: 26.416 MBytes = 211.3 Mbit, DESIGN.md §8)")
    ap.add_argument("--deadline-s", type=float, default=d.sync_threshold_s,
                    help="round sync deadline; later arrivals straggle "
                         "(paper: 25 s)")
    ap.add_argument("--bg-burst-mbits", type=float, default=d.bg_burst_mbits,
                    help="mean background-traffic burst size")
    ap.add_argument("--onu-link-mbps", type=float, default=d.onu_link_mbps,
                    help="per-ONU drop-link cap (default: uncapped)")
    ap.add_argument("--metro-wavelengths", type=int,
                    default=d.metro_wavelengths,
                    help="channels on the OLT→metro segment")
    ap.add_argument("--n-pons", type=int, default=d.n_pons,
                    help="PON trees feeding the metro node (1: single-OLT "
                         "paper setting, no metro tier)")
    ap.add_argument("--metro-rate-mbps", type=float, default=d.metro_rate_mbps,
                    help="OLT→metro shared-segment channel rate")
    ap.add_argument("--metro-latency-ms", type=float,
                    default=d.metro_latency_ms,
                    help="per-hop metro propagation latency")
    ap.add_argument("--sim-engine", default=d.sim_engine,
                    choices=("event", "fast", "hybrid"),
                    help="upstream simulator: event (exact heap), fast "
                         "(vectorized, exact-or-event-fallback), hybrid "
                         "(fluid model on uncongested PONs)")
    ap.add_argument("--fluid-threshold", type=float,
                    default=d.fluid_threshold,
                    help="hybrid engine: offered/capacity ratio above which "
                         "a PON is flagged congested and routed to the "
                         "exact event sim")


def pon_config_from_args(args) -> PonConfig:
    """Build the PonConfig selected by ``add_pon_cli_args`` flags."""
    d = PonConfig()
    return PonConfig(n_onus=args.onus, clients_per_onu=args.clients_per_onu,
                     dba=args.dba, n_wavelengths=args.wavelengths,
                     background_load=args.bg_load,
                     sfl_queueing=args.sfl_queueing,
                     n_pons=args.n_pons,
                     metro_rate_mbps=args.metro_rate_mbps,
                     metro_latency_ms=args.metro_latency_ms,
                     sim_engine=args.sim_engine,
                     fluid_threshold=args.fluid_threshold,
                     # physical-layer axes (getattr: parsers built without
                     # these flags keep working)
                     slice_mbps=getattr(args, "slice_mbps", d.slice_mbps),
                     model_mbits=getattr(args, "model_mbits", d.model_mbits),
                     sync_threshold_s=getattr(args, "deadline_s",
                                              d.sync_threshold_s),
                     bg_burst_mbits=getattr(args, "bg_burst_mbits",
                                            d.bg_burst_mbits),
                     onu_link_mbps=getattr(args, "onu_link_mbps",
                                           d.onu_link_mbps),
                     metro_wavelengths=getattr(args, "metro_wavelengths",
                                               d.metro_wavelengths))


def train_times(sample_counts: np.ndarray) -> np.ndarray:
    """T^r ∝ |D_ij|, scaled into the paper's [3, 20] s band."""
    k = sample_counts.astype(np.float64)
    lo, hi = float(k.min()), float(k.max())
    frac = (k - lo) / max(hi - lo, 1e-9)
    return TRAIN_S_MIN + frac * (TRAIN_S_MAX - TRAIN_S_MIN)


def round_times(cfg: PonConfig, rng: np.random.Generator,
                selected: np.ndarray, onu_ids: np.ndarray,
                sample_counts: np.ndarray, mode: str) -> Dict[str, np.ndarray]:
    """Simulate one round; returns per-selected-client completion/involvement.

    The event-driven simulator (``pon.events.simulate_round``): ``cfg``
    picks the DBA policy, wavelengths, background load, the forest and the
    engine. Under the defaults it is bit for bit :func:`round_times_fifo`.
    """
    from repro_torch.pon import events
    return events.simulate_round(cfg, rng, selected, onu_ids, sample_counts,
                                 mode)


def round_times_fifo(cfg: PonConfig, rng: np.random.Generator,
                     selected: np.ndarray, onu_ids: np.ndarray,
                     sample_counts: np.ndarray, mode: str,
                     ) -> Dict[str, np.ndarray]:
    """Closed-form FIFO oracle (the paper's fixed 100 Mb/s slice model).

    mode='classical': every selected client's full model crosses the shared
    upstream slice, serialized FIFO in arrival (DBA grant) order.
    mode='sfl': clients cross only the wireless leg; each active ONU sends
    one θ upstream.
    """
    n = len(selected)
    t_train = train_times(sample_counts)[selected]
    t_wireless = rng.uniform(WIRELESS_S_MIN, WIRELESS_S_MAX, size=n)
    ready = cfg.downlink_s + t_train + t_wireless   # update reaches the PON edge
    up = cfg.upload_s

    t_done = np.zeros(n)
    if mode == "classical":
        order = np.argsort(ready, kind="stable")
        t = 0.0
        for idx in order:
            t = max(t, ready[idx]) + up
            t_done[idx] = t
        involved = t_done <= cfg.sync_threshold_s
        upstream_mbits = float(n) * cfg.model_mbits
    else:
        onus = onu_ids[selected]
        cutoff = cfg.sync_threshold_s - up - cfg.onu_agg_s
        in_time = ready <= cutoff
        # θ_i is ready when ONU i's last in-time client arrives (+ agg time)
        theta_ready = np.full(cfg.n_onus, np.inf)
        for o in np.unique(onus):
            arr = ready[(onus == o) & in_time]
            if len(arr):
                theta_ready[o] = arr.max() + cfg.onu_agg_s
        active = np.where(np.isfinite(theta_ready))[0]
        theta_done = np.full(cfg.n_onus, np.inf)
        if cfg.sfl_queueing:
            t = 0.0
            for o in active[np.argsort(theta_ready[active], kind="stable")]:
                t = max(t, theta_ready[o]) + up
                theta_done[o] = t
        else:
            theta_done[active] = theta_ready[active] + up
        t_done = np.where(in_time, theta_done[onus], np.inf)
        involved = t_done <= cfg.sync_threshold_s
        # only ONUs that actually transmit a θ consume upstream
        upstream_mbits = float(len(active)) * cfg.model_mbits

    return {
        "ready": ready,
        "t_done": t_done,
        "involved": involved.astype(np.float32),
        "upstream_mbits": upstream_mbits,
        "upload_s": up,
    }
