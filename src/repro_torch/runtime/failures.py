"""Synthetic client failures and liveness for the drivers' mask path.

Copy of ``repro.runtime.failures`` (numpy). The paper's own straggler
policy (drop clients past the deadline and renormalize by the surviving
weight K) is the mask every aggregation takes, so crashes, transient
failures and elastic membership ride the same path. ``FailureModel``
keeps its own RNG so enabling it does not perturb the selection/minibatch
stream; ``MembershipTable`` tracks liveness from heartbeat timestamps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class FailureModel:
    """Synthetic per-round failures: crash (persists) vs transient slow."""
    p_crash: float = 0.0005
    p_transient: float = 0.01
    mean_recovery_rounds: float = 3.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._down_until: Dict[int, int] = {}

    def step_components(self, round_idx: int, n_nodes: int
                        ) -> "tuple[np.ndarray, np.ndarray]":
        """Advance one round; returns ``(crash_alive, transient_alive)``.

        A *crashed* node never reaches the PON edge — it is removed before
        transport, so it is neither billed upstream nor granted a slot —
        while a *transient* failure is transport-side: the client transmits
        (and is billed) but its update is discarded by the aggregation mask.
        """
        crash_alive = np.ones(n_nodes, bool)
        for node, until in list(self._down_until.items()):
            if round_idx >= until:
                del self._down_until[node]
            else:
                crash_alive[node] = False
        crash = self._rng.random(n_nodes) < self.p_crash
        for node in np.where(crash)[0]:
            rec = 1 + self._rng.geometric(1.0 / self.mean_recovery_rounds)
            self._down_until[node] = round_idx + rec
            crash_alive[node] = False
        transient = self._rng.random(n_nodes) < self.p_transient
        return crash_alive, ~transient

    def step(self, round_idx: int, n_nodes: int) -> np.ndarray:
        """The combined alive-mask (n_nodes,) for this round."""
        crash_alive, transient_alive = self.step_components(round_idx, n_nodes)
        return crash_alive & transient_alive


@dataclasses.dataclass
class MembershipTable:
    """Heartbeat-based liveness for elastic membership."""
    timeout_s: float = 30.0

    def __post_init__(self):
        self._last: Dict[int, float] = {}

    def heartbeat(self, node: int, now: float):
        self._last[node] = now

    def alive(self, now: float) -> np.ndarray:
        nodes = sorted(self._last)
        return np.array([now - self._last[n] <= self.timeout_s for n in nodes])

    def mask(self, n_nodes: int, now: float) -> np.ndarray:
        m = np.zeros(n_nodes, np.float32)
        for n, t in self._last.items():
            if n < n_nodes and now - t <= self.timeout_s:
                m[n] = 1.0
        return m


def renormalized_weights(weights: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Aggregation weights under failures — unbiased FedAvg renormalization."""
    w = weights * alive
    s = w.sum()
    return w / s if s > 0 else w
