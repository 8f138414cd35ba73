"""Per-round client selection + over-selection backups (fault tolerance).

Copy of ``repro.core.selection.select_clients`` (numpy): the CPS randomly
selects N of the n_onus × clients_per_onu population each round (the
paper's protocol). ``overselect`` > 0 picks extra backup clients so that
deadline stragglers / failed nodes do not starve the round — the
aggregation mask simply renormalizes.
"""
from __future__ import annotations

import numpy as np


def select_clients(rng: np.random.Generator, n_clients: int, n_selected: int,
                   overselect: float = 0.0) -> np.ndarray:
    n = min(n_clients, int(round(n_selected * (1.0 + overselect))))
    return rng.choice(n_clients, size=n, replace=False)
