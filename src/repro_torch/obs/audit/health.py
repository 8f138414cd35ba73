"""Run-health monitors — online incident detection on the telemetry streams.

A :class:`HealthEngine` rides inside the driver's ``Obs`` bundle
(``obs.health``); the drivers call :meth:`HealthEngine.observe_round`
once per emitted History record, *while the run is live* — this is
detection, not post-hoc analysis. Each monitor subscribes to one or more
of the three streams the run already produces:

  * History records (per-round flat dicts) — convergence stall, deadline
    SLO, per-segment bandwidth budgets, trunk flatness;
  * the tracer's span stream — straggler/outlier ONU detection from
    per-ONU grant-queue latencies (``queue_s`` on ``cat='grant'`` spans);
  * the experiment config — the ``expected_segment_mbits`` closed-form
    oracle parameterizes the bandwidth-budget monitors.

Monitors emit structured :class:`Incident` records; the engine collects
them, surfaces the per-round count in the History row (``incidents``
key, only when nonzero — a healthy run's rows are byte-identical to a
health-disabled run's), and exports JSONL via ``--incidents-out``.
FL-over-PON systems are exactly where silent degradation hides
(straggler ONUs under background load, deadline misses, convergence
stalls — cf. arXiv 2109.14593, arXiv 1911.07615); the monitors make it
loud.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional

INCIDENT_SCHEMA = "repro.obs.incident/v1"


@dataclasses.dataclass
class Incident:
    """One structured health finding."""

    kind: str                  # convergence_stall | straggler_onu | ...
    severity: str              # "warn" | "error"
    message: str
    round: Optional[int] = None
    t_s: Optional[float] = None
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["schema"] = INCIDENT_SCHEMA
        return d


class Monitor:
    """Interface: per-round records, span batches, and an end-of-run pass."""

    def bind(self, cfg) -> None:
        """Late-bound experiment config (drivers pass it on round 0)."""

    def on_round(self, rec: Dict[str, Any]) -> List[Incident]:
        return []

    def on_spans(self, spans) -> List[Incident]:
        return []

    def finish(self) -> List[Incident]:
        return []


class ConvergenceStallMonitor(Monitor):
    """No eval-metric improvement beyond ``min_delta`` for ``window``
    consecutive rounds → one incident per stall streak (re-arms on the
    next improvement, so a 100-round plateau is one incident, not 90)."""

    def __init__(self, window: int = 10, min_delta: float = 1e-3,
                 key: str = "acc"):
        self.window = window
        self.min_delta = min_delta
        self.key = key
        self._best: Optional[float] = None
        self._since_improvement = 0
        self._armed = True

    def on_round(self, rec):
        v = rec.get(self.key)
        if v is None or not math.isfinite(float(v)):
            return []
        v = float(v)
        if self._best is None or v > self._best + self.min_delta:
            self._best = v
            self._since_improvement = 0
            self._armed = True
            return []
        self._since_improvement += 1
        if self._armed and self._since_improvement >= self.window:
            self._armed = False
            return [Incident(
                kind="convergence_stall", severity="warn",
                round=rec.get("round"), t_s=rec.get("t_s"),
                message=(f"{self.key} stalled: no improvement "
                         f"> {self.min_delta} for {self._since_improvement} "
                         f"rounds (best {self._best:.4f})"),
                data={"key": self.key, "best": self._best,
                      "rounds_since_improvement": self._since_improvement,
                      "window": self.window})]
        return []


class DeadlineMissMonitor(Monitor):
    """Per-round deadline-miss-rate SLO: 1 − involved/selected above the
    threshold means the PON is dropping more stragglers than budgeted."""

    def __init__(self, max_miss_rate: float = 0.5):
        self.max_miss_rate = max_miss_rate

    def on_round(self, rec):
        n_sel = rec.get("n_selected")
        involved = rec.get("involved")
        if not n_sel or involved is None:
            return []
        miss = 1.0 - float(involved) / float(n_sel)
        if miss > self.max_miss_rate:
            return [Incident(
                kind="deadline_slo", severity="error",
                round=rec.get("round"), t_s=rec.get("t_s"),
                message=(f"deadline miss rate {miss:.2f} > SLO "
                         f"{self.max_miss_rate:.2f} "
                         f"({involved:.0f}/{n_sel} involved)"),
                data={"miss_rate": miss, "slo": self.max_miss_rate,
                      "involved": float(involved),
                      "n_selected": int(n_sel)})]
        return []


class BandwidthBudgetMonitor(Monitor):
    """Per-segment Mbits vs the ``expected_segment_mbits`` closed-form
    oracle (pon/metro.py): the paper's core property is that SFL holds
    these budgets flat, so exceeding the oracle's upper bound (all ONUs /
    PONs active) by more than ``tol_rel`` is a correctness-grade incident,
    not noise."""

    _SEGMENTS = {"upstream_mbits": "pon", "metro_mbits": "metro",
                 "trunk_mbits": "trunk"}

    def __init__(self, tol_rel: float = 0.01):
        self.tol_rel = tol_rel
        self._budget: Optional[Dict[str, float]] = None

    def bind(self, cfg) -> None:
        from repro_torch.pon.metro import expected_segment_mbits
        pon = cfg.fl.pon_config()
        transport = cfg.make_strategy().transport
        mode = transport if transport in ("classical", "sfl", "hier") else "sfl"
        n_sel = int(round(cfg.fl.n_selected * (1.0 + cfg.overselect)))
        # the oracle's upper bound: every ONU/PON active this round
        self._budget = expected_segment_mbits(
            mode, pon.model_mbits, n_sel,
            n_active_onus=min(n_sel, pon.total_onus),
            n_active_pons=pon.n_pons)
        self._mode = mode
        self._model_mbits = pon.model_mbits

    def on_round(self, rec):
        if self._budget is None:
            return []
        # compressed runs stamp the effective per-model wire size into the
        # record; the oracle is linear in model_mbits, so the budget scales
        # exactly (DESIGN.md §17)
        wire = rec.get("wire_mbits")
        scale = float(wire) / self._model_mbits if wire else 1.0
        out = []
        for key, seg in self._SEGMENTS.items():
            actual = rec.get(key)
            if actual is None:
                continue
            budget = self._budget[seg] * scale
            if float(actual) > budget * (1.0 + self.tol_rel):
                out.append(Incident(
                    kind="bandwidth_budget", severity="error",
                    round=rec.get("round"), t_s=rec.get("t_s"),
                    message=(f"{key} {float(actual):.1f} exceeds the "
                             f"closed-form {self._mode!r} budget "
                             f"{budget:.1f} Mbit (+{self.tol_rel:.0%})"),
                    data={"segment": seg, "actual_mbits": float(actual),
                          "budget_mbits": budget, "mode": self._mode}))
        return out


class TrunkFlatnessMonitor(Monitor):
    """Hier runs only: the metro→server trunk must carry at most ONE model
    per round regardless of n_pons — the property bench_hierarchy asserts
    offline, watched online here."""

    def __init__(self, tol_rel: float = 0.01):
        self.tol_rel = tol_rel
        self._model_mbits: Optional[float] = None

    def bind(self, cfg) -> None:
        if cfg.make_strategy().transport == "hier":
            self._model_mbits = cfg.fl.pon_config().model_mbits

    def on_round(self, rec):
        trunk = rec.get("trunk_mbits")
        if self._model_mbits is None or trunk is None:
            return []
        # one (possibly compressed) model per round is still the bound
        model = float(rec.get("wire_mbits") or self._model_mbits)
        if float(trunk) > model * (1.0 + self.tol_rel):
            return [Incident(
                kind="trunk_flatness", severity="error",
                round=rec.get("round"), t_s=rec.get("t_s"),
                message=(f"trunk carried {float(trunk):.1f} Mbit > one "
                         f"model ({model:.1f}) — hier "
                         "aggregation is not collapsing Φs into one Ψ"),
                data={"trunk_mbits": float(trunk),
                      "model_mbits": model})]
        return []


class StragglerOnuMonitor(Monitor):
    """Outlier-ONU detection from the grant-span stream: an ONU whose mean
    grant-queue delay (``queue_s``: DBA grant start − job ready) sits more
    than ``k_sigma`` standard deviations above the fleet mean — and above
    an absolute floor — is flagged once, at end of run (the statistic
    needs the fleet distribution; the *stream* is consumed incrementally
    round by round)."""

    def __init__(self, k_sigma: float = 3.0, min_delay_s: float = 0.5,
                 min_grants: int = 3):
        self.k_sigma = k_sigma
        self.min_delay_s = min_delay_s
        self.min_grants = min_grants
        self._delay: Dict[tuple, List[float]] = {}

    def on_spans(self, spans):
        for s in spans:
            if s.cat != "grant" or not s.args:
                continue
            q = s.args.get("queue_s")
            if q is None or not math.isfinite(q):
                continue
            self._delay.setdefault(s.lane, []).append(float(q))
        return []

    def finish(self):
        lanes = {lane: d for lane, d in self._delay.items()
                 if len(d) >= self.min_grants}
        if len(lanes) < 2:
            return []
        means = {lane: sum(d) / len(d) for lane, d in lanes.items()}
        vals = list(means.values())
        mu = sum(vals) / len(vals)
        sd = (sum((v - mu) ** 2 for v in vals) / len(vals)) ** 0.5
        out = []
        for lane, m in sorted(means.items()):
            if m > self.min_delay_s and m > mu + self.k_sigma * sd:
                out.append(Incident(
                    kind="straggler_onu", severity="warn",
                    message=(f"ONU lane {lane[0]}/{lane[1]} mean grant "
                             f"delay {m:.2f}s is {self.k_sigma:.0f}σ above "
                             f"the fleet mean {mu:.2f}s"),
                    data={"lane": list(lane), "mean_delay_s": m,
                          "fleet_mean_s": mu, "fleet_std_s": sd,
                          "n_grants": len(lanes[lane])}))
        return out


class HealthEngine:
    """Owns the monitors; consumes the round/span streams incrementally.

    Drivers call :meth:`observe_round` per History record (passing the
    cfg on first call so config-parameterized monitors bind lazily — the
    engine can be built from CLI flags before any ExperimentConfig
    exists) and :meth:`finish` at end of run.
    """

    def __init__(self, monitors: Optional[List[Monitor]] = None):
        self.monitors: List[Monitor] = (list(monitors) if monitors is not None
                                        else default_monitors())
        self.incidents: List[Incident] = []
        self._span_idx = 0
        self._bound = False
        self._finished = False

    @classmethod
    def from_args(cls, args) -> "HealthEngine":
        """The ``--health``/``--slo-*`` CLI configuration."""
        return cls(default_monitors(
            stall_window=getattr(args, "slo_stall_window", 10),
            stall_min_delta=getattr(args, "slo_stall_min_delta", 1e-3),
            max_miss_rate=getattr(args, "slo_deadline_miss_rate", 0.5),
            bandwidth_tol=getattr(args, "slo_bandwidth_tol", 0.01),
            straggler_sigma=getattr(args, "slo_straggler_sigma", 3.0)))

    def observe_round(self, rec: Dict[str, Any], cfg=None,
                      tracer=None) -> List[Incident]:
        """Feed one History record (and any new spans); returns the new
        incidents, which are also accumulated on the engine."""
        if cfg is not None and not self._bound:
            self._bound = True
            for m in self.monitors:
                m.bind(cfg)
        new: List[Incident] = []
        if tracer is not None and getattr(tracer, "enabled", False):
            spans = tracer.spans[self._span_idx:]
            self._span_idx = len(tracer.spans)
            for m in self.monitors:
                new.extend(m.on_spans(spans))
        for m in self.monitors:
            new.extend(m.on_round(rec))
        self.incidents.extend(new)
        return new

    def finish(self, tracer=None) -> List[Incident]:
        """End-of-run pass (fleet-statistic monitors fire here); idempotent."""
        if self._finished:
            return []
        self._finished = True
        new: List[Incident] = []
        if tracer is not None and getattr(tracer, "enabled", False):
            spans = tracer.spans[self._span_idx:]
            self._span_idx = len(tracer.spans)
            for m in self.monitors:
                new.extend(m.on_spans(spans))
        for m in self.monitors:
            new.extend(m.finish())
        self.incidents.extend(new)
        return new

    def records(self) -> List[Dict[str, Any]]:
        return [i.to_dict() for i in self.incidents]

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec, default=float) + "\n")
        return path


def default_monitors(stall_window: int = 10, stall_min_delta: float = 1e-3,
                     max_miss_rate: float = 0.5,
                     bandwidth_tol: float = 0.01,
                     straggler_sigma: float = 3.0) -> List[Monitor]:
    return [
        ConvergenceStallMonitor(window=stall_window,
                                min_delta=stall_min_delta),
        DeadlineMissMonitor(max_miss_rate=max_miss_rate),
        BandwidthBudgetMonitor(tol_rel=bandwidth_tol),
        TrunkFlatnessMonitor(tol_rel=bandwidth_tol),
        StragglerOnuMonitor(k_sigma=straggler_sigma),
    ]


def add_health_cli_args(g) -> None:
    """The ``--health``/``--slo-*`` flag block (called from
    ``repro_torch.obs.add_obs_cli_args`` so every driver CLI carries it)."""
    g.add_argument("--health", action="store_true",
                   help="enable online run-health monitors (incidents "
                        "surface in History rows and --incidents-out)")
    g.add_argument("--incidents-out", default=None, metavar="INC.jsonl",
                   help="write health incidents as JSONL (implies --health)")
    g.add_argument("--slo-deadline-miss-rate", type=float, default=0.5,
                   help="max per-round deadline miss rate before an "
                        "incident (1 - involved/selected)")
    g.add_argument("--slo-stall-window", type=int, default=10,
                   help="rounds without eval improvement before a "
                        "convergence-stall incident")
    g.add_argument("--slo-stall-min-delta", type=float, default=1e-3,
                   help="minimum eval-metric improvement that resets the "
                        "stall window")
    g.add_argument("--slo-bandwidth-tol", type=float, default=0.01,
                   help="relative slack over the closed-form per-segment "
                        "bandwidth budget")
    g.add_argument("--slo-straggler-sigma", type=float, default=3.0,
                   help="σ threshold for straggler-ONU grant-delay outliers")
