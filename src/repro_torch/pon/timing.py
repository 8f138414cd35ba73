"""PON round-timing model — the paper's fixed-slice FIFO upstream.

Port of the closed form in ``repro.pon.timing`` (``round_times_fifo``).
One-round synchronization time for client (i,j):
    T_ij = T^d + T^r_ij + T^w_ij + T^u_ij
with the paper's constants: T^d = 2 s broadcast, T^r ∈ [3, 20] s
proportional to |D_ij|, T^w ~ U[1, 5] s wireless, and the model crossing a
reserved 100 Mb/s upstream slice; a client done after the 25 s deadline is
a straggler, excluded from aggregation.

Under the paper defaults (one wavelength, FIFO grants, no background load,
one PON) the reference's event simulator is bit for bit this closed form
and consumes the same RNG draws; ``tests/test_torch_transport.py`` pins
the port against it. The event simulator's DBA policies, wavelengths,
background traffic and metro tier come with a later slice, so this
``PonConfig`` holds only the fields the closed form reads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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
    sfl_queueing: bool = False      # True = θ uploads queue FIFO on the slice

    @property
    def n_clients(self) -> int:
        return self.n_onus * self.clients_per_onu

    @property
    def upload_s(self) -> float:
        return self.model_mbits / self.slice_mbps


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

    mode='classical': every selected client's full model crosses the shared
    upstream slice, serialized FIFO in arrival order.
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
    elif mode == "sfl":
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
    else:
        raise ValueError(f"unknown transport {mode!r}; expected 'sfl' or 'classical'")

    return {
        "ready": ready,
        "t_done": t_done,
        "involved": involved.astype(np.float32),
        "upstream_mbits": upstream_mbits,
        "upload_s": up,
    }
