"""Aggregation policies — WHEN the server folds client updates in (port of
``repro.runtime.policies``).

The strategy axis (``fl.strategy``) fixes the aggregation *math*;
the policy axis fixes its *timing* against the simulated PON clock, which
is where the async-FL literature over access networks lives (Ciceri et
al., FL over next-generation EPONs; Nguyen et al., FedBuff):

  * ``sync``      — lockstep deadline rounds. The degenerate policy: it
    calls the exact ``fl.loop.sync_round`` pipeline the RoundLoop driver
    uses, and its replay path (``fl.loop.fast_forward``), so its trajectory
    is bit-for-bit RoundLoop's. One window per round; stragglers drop.
  * ``semi_sync`` — deadline windows over a *continuous* transport: the
    server aggregates whatever arrived by each window's end, and
    stragglers' uploads stay in flight and land in a later window with
    staleness ≥ 1 instead of being discarded.
  * ``fedbuff``   — buffered fully-async (alias ``async``): ``concurrency``
    clients are kept in flight; every ``buffer_k`` arrivals the server
    applies one staleness-weighted update and refills the pipeline. With
    ``--strategy fedopt`` the server step reuses the ``optim``
    AdamW/Yogi optimizers on the staleness-discounted pseudo-gradient.

Staleness rule: an update dispatched at server version v
and applied at version V has staleness τ = V − v; its aggregation weight
is k·(1+τ)^−α with α = ``ExperimentConfig.staleness_exponent`` (α = 0.5 is
FedBuff's 1/√(1+τ); α = 0 disables the discount).

Failure semantics match the synchronous bugfixed ordering: the crash
component of the FailureModel is applied *before* transport (a crashed
client is never dispatched — no upstream bits, no wavelength grant), and
the transient component at *arrival* (the update crossed the PON and is
billed, but is discarded from the buffer).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Set, Type

import numpy as np

from repro_torch.device import timed
from repro_torch.fl.loop import fast_forward, sync_round


@dataclasses.dataclass
class ClientUpdate:
    """One client's in-flight local update (dispatch → PON edge → OLT)."""
    client: int
    delta: Any              # pytree (None for transport-only backends)
    weight: float           # k_c, the client's sample count
    version: int            # server version at dispatch time
    t_dispatch: float
    t_edge: float = math.inf     # reached the PON edge (ONU)
    t_arrival: float = math.inf  # upstream transmission completed (OLT)


def staleness_weights(weights: np.ndarray, staleness: np.ndarray,
                      alpha: float) -> np.ndarray:
    """FedBuff-style discount: w_i = k_i · (1 + τ_i)^−α."""
    w = np.asarray(weights, np.float32)
    tau = np.asarray(staleness, np.float32)
    return w * (1.0 + tau) ** (-float(alpha))


class AggregationPolicy:
    """Interface: bound to one Orchestrator, owns the run schedule."""

    name = "base"
    needs_async_backend = True   # requires backend.client_update/apply_updates

    def bind(self, orch) -> None:
        self.orch = orch

    def run(self, n_updates: int, until_s: Optional[float],
            start_round: int) -> None:
        raise NotImplementedError


class SyncRounds(AggregationPolicy):
    """Deadline rounds over the batch transport seam (≡ RoundLoop)."""

    name = "sync"
    needs_async_backend = False

    def run(self, n_updates, until_s, start_round):
        o = self.orch
        if until_s is not None:
            n_updates = min(n_updates,
                            max(0, int(until_s // o.window_s) - start_round))
        o.rounds_consumed = fast_forward(o.cfg, o.backend, o.failures, o.rng,
                                         o.rounds_consumed, start_round)
        for rnd in range(start_round, start_round + n_updates):
            # o.obs routes the round's accounting into the orchestrator's
            # registry: the counter's add/take feeds rec AND accumulates
            # o.total_upstream_mbits (a property over counter.total)
            rec, wall_s = timed(sync_round, o.cfg, o.backend, o.failures, o.rng, rnd,
                                obs=o.obs)
            rec["wall_s"] = wall_s
            o.rounds_consumed += 1
            if rec["involved"] > 0:     # the server model actually moved
                o.server_version += 1
            o.clock.run_until((rnd + 1) * o.window_s)
            rec["t_s"] = o.clock.now
            rec["policy"] = self.name
            rec["version"] = o.server_version
            o.emit(rec)


class SemiSync(AggregationPolicy):
    """Deadline windows, but stragglers carry over instead of dropping.

    Each window dispatches a fresh cohort from the *idle* population; at
    the window's end the server aggregates every arrival of that window
    (whatever its dispatch version) with staleness-discounted weights.
    In-flight clients keep training/queueing across the boundary.
    """

    name = "semi_sync"

    def run(self, n_updates, until_s, start_round):
        if start_round:
            raise ValueError("semi_sync does not support start_round resume")
        o = self.orch
        o.setup_transport()
        if until_s is not None:
            n_updates = min(n_updates, int(until_s // o.window_s))
        self.n_windows = n_updates
        self.buffer: List[ClientUpdate] = []
        self.in_flight: Set[int] = set()
        self._dispatched = 0
        self._window(0)
        o.clock.run_until(self.n_windows * o.window_s)

    def _window(self, r: int) -> None:
        o = self.orch
        if r > 0:
            self._aggregate(r - 1)
        if r >= self.n_windows:
            return
        o.step_window(r)
        sel = o.select_idle(o.cfg.fl.n_selected, busy=self.in_flight)
        self._dispatched = 0
        for c in sel:
            if o.crashed(c):
                continue            # crash-before-transport: never dispatched
            self.in_flight.add(int(c))
            o.dispatch(int(c), self.on_arrival)
            self._dispatched += 1
        o.clock.schedule((r + 1) * o.window_s, self._window, r + 1)

    def on_arrival(self, up: ClientUpdate) -> None:
        self.in_flight.discard(up.client)
        if self.orch.transient(up.client):
            return                  # transmitted (billed) but discarded
        self.buffer.append(up)

    def _aggregate(self, r: int) -> None:
        ups, self.buffer = self.buffer, []
        self.orch.apply(r, ups, extra={"n_selected": self._dispatched,
                                       "in_flight": len(self.in_flight)})


class FedBuff(AggregationPolicy):
    """Buffered fully-asynchronous aggregation (Nguyen et al. 2022).

    ``concurrency`` clients are always in flight; each arrival lands in a
    buffer, and every ``buffer_k`` buffered (non-transient) arrivals the
    server applies one staleness-weighted update, then refills the
    pipeline from the idle, non-crashed population. The failure model and
    background traffic tick on the window cadence.
    """

    name = "fedbuff"

    def run(self, n_updates, until_s, start_round):
        if start_round:
            raise ValueError("fedbuff does not support start_round resume")
        o = self.orch
        o.setup_transport()
        self.target = n_updates
        self.until_s = math.inf if until_s is None else until_s
        self.buffer: List[ClientUpdate] = []
        self.in_flight: Set[int] = set()
        self.done = False
        self.m = o.cfg.concurrency if o.cfg.concurrency > 0 else o.cfg.fl.n_selected
        self._idle_ticks = 0
        self._tick(0)
        self._refill()
        steps = 0
        while not self.done and steps < 5_000_000:
            nxt = o.clock.peek()
            if nxt is None or nxt > self.until_s:
                break
            if not self.in_flight and len(self.buffer) < o.cfg.buffer_k:
                # no arrival can fire; without failures nothing will ever
                # change, and with them only a future tick's crash-recovery
                # refill can — give that 100 windows before calling it dead
                if o.failures is None or self._idle_ticks >= 100:
                    break
            o.clock.step()
            steps += 1
        if not self.done and self.until_s != math.inf:
            o.clock.now = max(o.clock.now, self.until_s)

    def _tick(self, w: int) -> None:
        o = self.orch
        o.step_window(w)
        self._refill()              # crash recoveries free up the pool
        self._idle_ticks = self._idle_ticks + 1 if not self.in_flight else 0
        o.clock.schedule((w + 1) * o.window_s, self._tick, w + 1)

    def _refill(self) -> None:
        o = self.orch
        n_clients = o.cfg.fl.n_clients
        while len(self.in_flight) < self.m:
            pool = np.array([c for c in range(n_clients)
                             if c not in self.in_flight and not o.crashed(c)])
            if len(pool) == 0:
                break
            c = int(o.rng.choice(pool))
            self.in_flight.add(c)
            o.dispatch(c, self.on_arrival)

    def on_arrival(self, up: ClientUpdate) -> None:
        o = self.orch
        self.in_flight.discard(up.client)
        if not o.transient(up.client):
            self.buffer.append(up)
        if len(self.buffer) >= o.cfg.buffer_k:
            ups, self.buffer = self.buffer, []
            o.apply(o.server_version, ups,
                    extra={"in_flight": len(self.in_flight)})
            if o.server_version >= self.target:
                self.done = True
                return
        self._refill()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

POLICIES: Dict[str, Type[AggregationPolicy]] = {
    "sync": SyncRounds,
    "semi_sync": SemiSync,
    "fedbuff": FedBuff,
}
_ALIASES: Dict[str, str] = {"async": "fedbuff", "semi-sync": "semi_sync"}


def canonical_policy(name: str) -> str:
    if name in POLICIES:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(f"unknown aggregation policy {name!r}; "
                   f"registered: {sorted(POLICIES)} "
                   f"(aliases: {sorted(_ALIASES)})")


def policy_names():
    return sorted(POLICIES)


def make_policy(name: str) -> AggregationPolicy:
    return POLICIES[canonical_policy(name)]()
