"""Client selection and the PON round timing, in closed form, for the
settings the cells run: one PON or a forest of PONs, one upstream
wavelength, FIFO grants, no background load, each aggregate upload on a
contention-free slice (the paper's model, Sec. III).

One synchronous round draws, in this order, from one
``np.random.default_rng(seed)`` stream: the N selected clients, then one
wireless time a selected client; the FL side then draws each padded
client's minibatch indices. Client (i, j) is done at
T_ij = T^d + T^r_ij + T^w_ij, and its ONU's aggregate θ crosses the PON
when its last in-time client arrives; under the forest each OLT's Φ then
crosses the metro segment, each tier cutting off arrivals that could no
longer reach the next one by the deadline.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# the transport settings this closed form covers (the event simulator's
# defaults); a traffic mix asking for others needs another reference
COVERED = {"dba": "fifo", "n_wavelengths": 1, "background_load": 0.0,
           "sim_engine": "event", "sfl_queueing": False}

MODEL_MBITS = 26.416 * 8.0      # the CNN's 26.416 MB update, in Mbit
DOWNLINK_S = 2.0                # T^d: broadcast of the global model
TRAIN_S = (3.0, 20.0)           # T^r: proportional to the client's samples
WIRELESS_S = (1.0, 5.0)         # T^w: uniform
SLICE_MBPS = 100.0              # the reserved FL upstream slice
ONU_AGG_S = 0.05                # an aggregation point's weighted add


def check_covered(pon_traffic) -> None:
    for key, want in COVERED.items():
        if pon_traffic[key] != want:
            raise ValueError(f"traffic {key}={pon_traffic[key]!r}: the reference's transport "
                             f"covers {want!r}")


def select(rng: np.random.Generator, n_clients: int, n_selected: int) -> np.ndarray:
    return rng.choice(n_clients, size=min(n_clients, n_selected), replace=False)


def train_times(counts: np.ndarray) -> np.ndarray:
    k = counts.astype(np.float64)
    lo, hi = float(k.min()), float(k.max())
    frac = (k - lo) / max(hi - lo, 1e-9)
    return TRAIN_S[0] + frac * (TRAIN_S[1] - TRAIN_S[0])


def _ready(rng, selected, counts):
    t_w = rng.uniform(WIRELESS_S[0], WIRELESS_S[1], size=len(selected))
    return DOWNLINK_S + train_times(counts)[selected] + t_w


def one_pon_sfl(rng: np.random.Generator, selected: np.ndarray, onu_ids: np.ndarray,
                counts: np.ndarray, n_onus: int, deadline_s: float,
                model_mbits: float) -> Tuple[np.ndarray, float]:
    """One PON, the two-step transport: (involvement mask f32, upstream
    Mbits: one θ an active ONU)."""
    ready = _ready(rng, selected, counts)
    up = model_mbits / SLICE_MBPS
    onus = onu_ids[selected]
    in_time = ready <= deadline_s - up - ONU_AGG_S
    theta_ready = np.full(n_onus, np.inf)
    for o in np.unique(onus):
        arr = ready[(onus == o) & in_time]
        if len(arr):
            theta_ready[o] = arr.max() + ONU_AGG_S
    active = np.isfinite(theta_ready)
    theta_done = np.where(active, theta_ready + up, np.inf)
    t_done = np.where(in_time, theta_done[onus], np.inf)
    return (t_done <= deadline_s).astype(np.float32), float(active.sum()) * model_mbits


def forest_hier(rng: np.random.Generator, selected: np.ndarray, onu_ids: np.ndarray,
                counts: np.ndarray, n_pons: int, onus_per_pon: int, deadline_s: float,
                model_mbits: float, metro_rate_mbps: float, metro_latency_ms: float
                ) -> Tuple[np.ndarray, float]:
    """A forest of PONs, the k-step transport (θ per ONU over its PON, Φ
    per OLT over the metro segment): (involvement mask f32, PON upstream
    Mbits: one θ an active ONU)."""
    ready = _ready(rng, selected, counts)
    up = model_mbits / SLICE_MBPS
    metro_up = model_mbits / metro_rate_mbps
    lat = metro_latency_ms / 1e3
    agg = ONU_AGG_S
    cutoff_metro = deadline_s - agg
    cutoff_olt = cutoff_metro - lat - metro_up - agg
    cutoff_onu = cutoff_olt - up - agg
    onus = onu_ids[selected]
    pons = onus // onus_per_pon
    in_time = ready <= cutoff_onu
    n_onus = n_pons * onus_per_pon
    theta_ready = np.full(n_onus, np.inf)
    for o in np.unique(onus):
        arr = ready[(onus == o) & in_time]
        if len(arr):
            theta_ready[o] = arr.max() + agg
    active = np.isfinite(theta_ready)
    theta_done = np.where(active, theta_ready + up, np.inf)
    phi_arrival = np.full(n_pons, np.inf)
    for p in range(n_pons):
        done = theta_done[p * onus_per_pon:(p + 1) * onus_per_pon]
        done = done[done <= cutoff_olt]
        if len(done):
            phi_arrival[p] = (done.max() + agg) + metro_up + lat
    phi_in = phi_arrival <= cutoff_metro
    ok = in_time & (theta_done[onus] <= cutoff_olt) & phi_in[pons]
    t_done = np.where(ok, phi_arrival[pons], np.inf)
    return (t_done <= deadline_s).astype(np.float32), float(active.sum()) * model_mbits
