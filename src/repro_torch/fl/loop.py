"""RoundLoop — the per-round pipeline driver (port of ``repro.fl.loop``).

Every synchronous round is the same five stages:

    selection (N + overselect backups) → crash injection (FailureModel)
    → PON transport (involvement mask) → transient mask
    → backend training + strategy aggregation → eval / History row

The RNG stream is one ``np.random.default_rng(seed)`` consumed in a fixed
order — selection draw, transport draws for the live clients (the
wireless legs, then the background bursts), then one minibatch draw per
padded row — exactly the reference's, so the transport columns of the
History (``involved``, ``upstream_mbits``, ``uplink_models`` and a
forest's per-segment Mbits) equal the reference's round for round. A crashed
client is removed before transport (never billed upstream); a transient
failure is billed but masked out of the aggregate.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core import selection
from repro_torch.core.fedavg import round_transport
from repro_torch.device import timed
from repro_torch.fl.backends import backend_wire_scale
from repro_torch.fl.config import ExperimentConfig


class History:
    """Per-round record sink: a list of flat dicts + column extraction."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def append(self, rec: Dict[str, Any]) -> None:
        self.records.append(rec)

    def column(self, key: str, default=None) -> List[Any]:
        return [r.get(key, default) for r in self.records]

    def last(self) -> Dict[str, Any]:
        return self.records[-1] if self.records else {}

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)


def _expand_rt(rt: Dict[str, Any], live: np.ndarray) -> Dict[str, Any]:
    """Re-align per-client transport arrays from the live (non-crashed)
    subset back to the full selection: crashed clients never completed."""
    out = dict(rt)
    n = len(live)
    inv = np.zeros(n, np.float32)
    inv[live] = np.asarray(rt["involved"], np.float32)
    out["involved"] = inv
    for key in ("t_done", "ready"):
        arr = np.full(n, np.inf)
        arr[live] = np.asarray(rt[key], np.float64)
        out[key] = arr
    return out


def _transport_stage(cfg: ExperimentConfig, backend, failures,
                     rng: np.random.Generator, rnd: int
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """selection → crash injection → PON transport → transient mask.

    Returns ``(selected, mask, rt)`` shaped to the full selection.
    """
    fl = cfg.fl
    sel = selection.select_clients(rng, fl.n_clients, fl.n_selected,
                                   cfg.overselect)
    crash_alive = transient_alive = None
    if failures is not None:
        crash_alive, transient_alive = failures.step_components(rnd, fl.n_clients)
    live = (crash_alive[sel] if crash_alive is not None
            else np.ones(len(sel), bool))
    spec = backend.strategy.compression_spec()
    rt = round_transport(fl, rng, sel[live], backend.sample_counts,
                         backend.onu_ids, mode=backend.strategy.transport,
                         wire_scale=backend_wire_scale(backend) if spec.active else None)
    if spec.active:
        rt["compress"] = spec.scheme
    if not live.all():
        rt = _expand_rt(rt, live)
    mask = np.asarray(rt["involved"], np.float32)
    if transient_alive is not None:
        mask = mask * transient_alive[sel].astype(np.float32)
    return sel, mask, rt


# the per-segment accounting a forest's transport returns (pon.metro), in
# the reference's row order; each is recorded whenever the transport has it
_SEGMENT_KEYS = ("upstream_mbits", "metro_mbits", "trunk_mbits",
                 "pon_mbits_max", "metro_mbits_max", "n_pons")


def sync_round(cfg: ExperimentConfig, backend, failures,
               rng: np.random.Generator, rnd: int) -> Dict[str, Any]:
    """One synchronous deadline round; returns the History record, whose
    transport values are the transport's floats, as the reference's."""
    sel, mask, rt = _transport_stage(cfg, backend, failures, rng, rnd)
    metrics = backend.run_round(rnd, sel, mask, rt, rng)
    rec = {"round": rnd, "n_selected": len(sel),
           "sim_engine": rt.get("sim_engine", "event"),
           "involved": float(mask.sum())}
    rec.update({k: float(rt[k]) for k in _SEGMENT_KEYS if k in rt})
    if "wire_mbits" in rt:
        # the compressed per-model wire size; absent in an uncompressed run
        rec["wire_mbits"] = float(rt["wire_mbits"])
        rec["compress"] = rt["compress"]
    rec.update(metrics)
    return rec


def replay_sync_round(cfg: ExperimentConfig, backend, failures,
                      rng: np.random.Generator, rnd: int) -> None:
    """Consume exactly :func:`sync_round`'s RNG draws without training (the
    backend's part through its optional ``replay_round``)."""
    sel, mask, rt = _transport_stage(cfg, backend, failures, rng, rnd)
    replay = getattr(backend, "replay_round", None)
    if replay is not None:
        replay(rnd, sel, mask, rt, rng)


Callback = Callable[["RoundLoop", Dict[str, Any]], None]


class RoundLoop:
    """Drives rounds of ``cfg`` against a backend; collects a History.

    Each row also carries ``wall_s``, the round's host time with the card
    synchronised at both ends. Each callback is called with ``(loop, rec)``
    after each round, in order.
    """

    def __init__(self, cfg: ExperimentConfig, backend, callbacks: Iterable[Callback] = ()):
        self.cfg = cfg
        self.backend = backend
        self.callbacks: List[Callback] = list(callbacks)
        self.rng = np.random.default_rng(cfg.seed)
        self.failures = cfg.make_failure_model()
        self.history = History()
        self.rounds_consumed = 0    # rounds whose RNG draws have been used
        n = cfg.fl.n_clients
        if len(backend.sample_counts) < n or len(backend.onu_ids) < n:
            raise ValueError(
                f"backend covers {len(backend.sample_counts)} clients but "
                f"cfg.fl.n_clients={n}; size the backend's sample_counts/"
                "onu_ids to the FL population")

    def run_round(self, rnd: int) -> Dict[str, Any]:
        rec, wall_s = timed(sync_round, self.cfg, self.backend, self.failures,
                            self.rng, rnd)
        rec["wall_s"] = wall_s
        self.rounds_consumed += 1
        self.history.append(rec)
        for cb in self.callbacks:
            cb(self, rec)
        return rec

    def run(self, n_rounds: Optional[int] = None, start_round: int = 0
            ) -> History:
        """Run ``n_rounds`` rounds (a count) from ``start_round``; rounds
        before ``start_round`` not yet consumed are replayed first, so a
        resumed trajectory is the uninterrupted one."""
        n = n_rounds if n_rounds is not None else self.cfg.n_rounds
        for rnd in range(self.rounds_consumed, start_round):
            replay_sync_round(self.cfg, self.backend, self.failures, self.rng, rnd)
        self.rounds_consumed = max(self.rounds_consumed, start_round)
        for rnd in range(start_round, start_round + n):
            self.run_round(rnd)
        return self.history
