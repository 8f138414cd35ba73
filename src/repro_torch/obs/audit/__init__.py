"""repro_torch.obs.audit — the layer that watches the watchers (DESIGN.md §14).

The tracer and the registry make every run emit rich telemetry (spans,
counters, History rows); this package makes that telemetry *actionable*:

  * :mod:`health`  — streaming run-health monitors subscribed to the
    History/metric/span streams, emitting structured :class:`Incident`
    records online (convergence stall, straggler ONUs, per-segment
    bandwidth-budget violations vs the ``expected_segment_mbits`` oracle,
    deadline-miss SLO, trunk flatness). CLI: ``--health`` / ``--slo-*``.
  * :mod:`bundle`  — :class:`RunReport`, the one-file run artifact
    (config + hash, metrics, History, incidents, trace, env) written by
    every driver via ``--report-out``.
  * :mod:`diff`    — the cross-run diff engine behind
    ``python -m repro_torch.obs.diff A B``: metric deltas under tolerance
    policies, History alignment with first-divergence localization,
    span-timeline alignment, config-delta attribution.
  * :mod:`html`    — self-contained HTML report renderer (timeline lanes
    + metric tables, zero external deps).

The port of ``repro.obs.audit``: bundles and incidents carry the
reference's schemas, so either package's diff reads either's bundles, and
the HTML report is the reference's byte for byte.
"""
from repro_torch.obs.audit.bundle import (BUNDLE_SCHEMA, RunReport, config_dict,
                                    config_hash)
from repro_torch.obs.audit.diff import BundleDiff, DiffEntry, diff_bundles
from repro_torch.obs.audit.health import (BandwidthBudgetMonitor,
                                    ConvergenceStallMonitor,
                                    DeadlineMissMonitor, HealthEngine,
                                    Incident, StragglerOnuMonitor,
                                    TrunkFlatnessMonitor)
from repro_torch.obs.audit.html import render_diff_html, render_timeline_svg

__all__ = [
    "BUNDLE_SCHEMA", "RunReport", "config_dict", "config_hash",
    "BundleDiff", "DiffEntry", "diff_bundles",
    "HealthEngine", "Incident",
    "ConvergenceStallMonitor", "StragglerOnuMonitor",
    "BandwidthBudgetMonitor", "DeadlineMissMonitor", "TrunkFlatnessMonitor",
    "render_diff_html", "render_timeline_svg",
]
