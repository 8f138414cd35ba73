"""repro_torch.hier — multi-PON hierarchical aggregation (k-step SFL), the
map of ``repro.hier``.

The paper's two-step aggregation keeps one PON's upstream constant in the
client count; stacking the step — many PONs per metro node — keeps every
segment's upstream constant (DESIGN.md §12):

    from repro_torch import fl, hier

    # a 4-PON forest, 16 ONUs × 20 clients each = 1280 clients
    exp = fl.ExperimentConfig(strategy="hier_sfl",
                              strategy_kwargs=(("n_pons", 4),),
                              ).with_fl(n_pons=4, n_selected=128)
    metro = hier.MetroTopology.uniform(n_pons=4)

Pieces (each lives with its own layer; this module is the map):

  * :class:`~repro_torch.pon.metro.MetroTopology` — the forest: N per-PON
    trees plus the OLT→metro segment (itself a ``Topology``).
  * :func:`~repro_torch.pon.metro.simulate_hier_round` — the k-step
    transport, reached through ``round_times`` whenever
    ``PonConfig.n_pons > 1``.
  * :class:`~repro_torch.fl.strategy.HierSfl` — the ``hier_sfl`` strategy
    (ONU θ → OLT Φ → metro Ψ → server), every tier on the segmented
    ``agg_reduce`` kernel (``core.aggregation.hier_aggregate``).
  * :func:`~repro_torch.pon.metro.expected_segment_mbits` — the closed-form
    per-segment budget (the tests' oracle).

CLI: ``python -m repro_torch.launch.femnist --strategy hier_sfl --n-pons 4``
(and ``launch.train``).
"""
from repro_torch.fl.strategy import HierSfl
from repro_torch.pon.metro import (
    MetroTopology,
    expected_segment_mbits,
    simulate_hier_round,
)

__all__ = [
    "HierSfl",
    "MetroTopology",
    "expected_segment_mbits",
    "simulate_hier_round",
]
