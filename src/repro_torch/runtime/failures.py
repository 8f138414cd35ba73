"""Synthetic client failures for the round loop's mask path.

Copy of ``repro.runtime.failures.FailureModel`` (numpy). The paper's own
straggler policy (drop clients past the deadline and renormalize by the
surviving weight K) is the mask every aggregation takes, so crashes and
transient failures ride the same path. The model keeps its own RNG so
enabling it does not perturb the selection/minibatch stream.
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
