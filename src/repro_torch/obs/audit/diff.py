"""Cross-run diff engine — ``python -m repro_torch.obs.diff A B``.

Aligns two :class:`~repro_torch.obs.audit.bundle.RunReport` bundles and reports
where they disagree (DESIGN.md §14):

  * **config delta** — attribution, not a regression: differing config
    fields are listed first so metric diffs can be read in context.
  * **metrics** — record-by-record deltas under abs/rel tolerances; wall
    timing metrics are warn-only (host noise is not a regression).
  * **history** — rows aligned by round; the *first diverging round* is
    localized (the repo's bit-for-bit pins make this a sharp debugging
    primitive: two same-config+seed runs must produce zero diffs).
  * **span timeline** — sim-clock spans aligned in (t0, t1, lane, name)
    order with first-divergence localization; wall lanes are excluded
    (two runs never share a host schedule).

Exit code: 0 when no hard diffs, 1 otherwise — scriptable in CI.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.audit.bundle import RunReport

# metric/row keys matching these fragments measure host time — two healthy
# runs will not agree, so differences are warnings rather than diffs
# (dt / backend.train_step_s are the drivers' wall-clock step timings)
_WARN_FRAGMENTS = ("wall", "us_per_call", "host_s", "step_s", "compile")
_WARN_EXACT = ("dt",)


def _is_warn_key(key: str) -> bool:
    k = key.lower()
    return k in _WARN_EXACT or any(f in k for f in _WARN_FRAGMENTS)


def _close(a: Any, b: Any, rtol: float, atol: float) -> bool:
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and not isinstance(a, bool) and not isinstance(b, bool):
        fa, fb = float(a), float(b)
        if math.isnan(fa) and math.isnan(fb):
            return True
        if math.isinf(fa) or math.isinf(fb):
            return fa == fb
        return abs(fa - fb) <= atol + rtol * max(abs(fa), abs(fb))
    return a == b


def _delta(a: Any, b: Any) -> Tuple[Optional[float], Optional[float]]:
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and not isinstance(a, bool) and not isinstance(b, bool):
        d = float(b) - float(a)
        denom = max(abs(float(a)), abs(float(b)))
        return d, (d / denom if denom else 0.0)
    return None, None


@dataclasses.dataclass
class DiffEntry:
    """One disagreement between the two bundles."""

    section: str          # config | metrics | history | spans | structure
    key: str
    a: Any
    b: Any
    delta: Optional[float] = None
    rel: Optional[float] = None
    # diff: hard difference · warn: informational (wall timings)
    # missing_a/missing_b: present in only one bundle · config: attribution
    status: str = "diff"
    note: str = ""

    def line(self) -> str:
        tag = {"diff": "DIFF", "warn": "warn", "config": "cfg ",
               "missing_a": "only-B", "missing_b": "only-A"}[self.status]
        s = f"[{tag}] {self.section}/{self.key}: {self.a!r} -> {self.b!r}"
        if self.rel is not None and self.delta is not None:
            s += f"  (Δ={self.delta:+.6g}, {100 * self.rel:+.3f}%)"
        if self.note:
            s += f"  — {self.note}"
        return s


@dataclasses.dataclass
class BundleDiff:
    """The comparison result: entries + localization of first divergence."""

    entries: List[DiffEntry] = dataclasses.field(default_factory=list)
    config_delta: List[DiffEntry] = dataclasses.field(default_factory=list)
    first_divergence: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_diffs(self) -> int:
        return sum(1 for e in self.entries
                   if e.status in ("diff", "missing_a", "missing_b"))

    @property
    def n_warns(self) -> int:
        return sum(1 for e in self.entries if e.status == "warn")

    @property
    def exit_code(self) -> int:
        return 1 if self.n_diffs else 0

    def summary_lines(self, max_lines: int = 60) -> List[str]:
        lines: List[str] = []
        if self.config_delta:
            lines.append(f"config delta ({len(self.config_delta)} fields):")
            lines += ["  " + e.line() for e in self.config_delta]
        else:
            lines.append("config: identical (same config hash)")
        if self.first_divergence.get("round") is not None:
            fd = self.first_divergence
            lines.append(f"first diverging round: {fd['round']} "
                         f"(key {fd.get('round_key')!r})")
        if self.first_divergence.get("span") is not None:
            lines.append("first diverging span: "
                         f"{self.first_divergence['span']}")
        shown = self.entries[:max_lines]
        lines += [e.line() for e in shown]
        if len(self.entries) > max_lines:
            lines.append(f"... {len(self.entries) - max_lines} more entries")
        lines.append(f"TOTAL: {self.n_diffs} diffs, {self.n_warns} warnings")
        return lines


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _diff_config(a: RunReport, b: RunReport) -> List[DiffEntry]:
    fa, fb = _flatten(a.config), _flatten(b.config)
    entries = []
    for k in sorted(set(fa) | set(fb)):
        va, vb = fa.get(k), fb.get(k)
        if va != vb:
            entries.append(DiffEntry("config", k, va, vb, status="config"))
    return entries


def _diff_metrics(a: RunReport, b: RunReport, rtol: float,
                  atol: float) -> List[DiffEntry]:
    def index(rows):
        return {(r.get("kind"), r.get("name")): r for r in rows}
    ia, ib = index(a.metrics), index(b.metrics)
    entries: List[DiffEntry] = []
    for key in sorted(set(ia) | set(ib), key=str):
        kind, name = key
        label = f"{kind}:{name}"
        if key not in ia:
            entries.append(DiffEntry("metrics", label, None, "present",
                                     status="missing_a"))
            continue
        if key not in ib:
            entries.append(DiffEntry("metrics", label, "present", None,
                                     status="missing_b"))
            continue
        ra, rb = ia[key], ib[key]
        for field in sorted(set(ra) | set(rb)):
            if field in ("kind", "name", "obs_schema"):
                continue
            va, vb = ra.get(field), rb.get(field)
            if not _close(va, vb, rtol, atol):
                d, rel = _delta(va, vb)
                status = "warn" if _is_warn_key(name) else "diff"
                entries.append(DiffEntry("metrics", f"{label}.{field}",
                                         va, vb, d, rel, status))
    return entries


def _diff_history(a: RunReport, b: RunReport, rtol: float, atol: float
                  ) -> Tuple[List[DiffEntry], Optional[int], Optional[str]]:
    ra, rb = a.history, b.history
    entries: List[DiffEntry] = []
    first_round: Optional[int] = None
    first_key: Optional[str] = None
    if len(ra) != len(rb):
        entries.append(DiffEntry("history", "n_rounds", len(ra), len(rb),
                                 note="row counts differ"))
    for i in range(min(len(ra), len(rb))):
        xa, xb = ra[i], rb[i]
        rnd = xa.get("round", i)
        for k in sorted(set(xa) | set(xb)):
            va, vb = xa.get(k), xb.get(k)
            if _close(va, vb, rtol, atol):
                continue
            d, rel = _delta(va, vb)
            status = "warn" if _is_warn_key(k) else "diff"
            entries.append(DiffEntry("history", f"round[{rnd}].{k}",
                                     va, vb, d, rel, status))
            if status == "diff" and first_round is None:
                first_round, first_key = rnd, k
    return entries, first_round, first_key


def _sim_spans(trace: Dict[str, Any]) -> List[Tuple]:
    """Sim-clock complete spans from a Chrome trace dict, normalized to
    (t0_us, dur_us, process, thread, name) and sorted — wall lanes
    excluded (host schedules never align across runs)."""
    events = trace.get("traceEvents", []) if trace else []
    procs: Dict[int, str] = {}
    threads: Dict[Tuple[int, int], str] = {}
    for ev in events:
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                procs[ev["pid"]] = ev["args"]["name"]
            elif ev.get("name") == "thread_name":
                threads[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    spans = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        proc = procs.get(ev.get("pid"), str(ev.get("pid")))
        if proc == "wall":
            continue
        thread = threads.get((ev.get("pid"), ev.get("tid")),
                             str(ev.get("tid")))
        spans.append((round(ev["ts"], 3), round(ev.get("dur", 0.0), 3),
                      proc, thread, ev["name"]))
    return sorted(spans)


def _diff_spans(a: RunReport, b: RunReport
                ) -> Tuple[List[DiffEntry], Optional[str]]:
    sa, sb = _sim_spans(a.trace), _sim_spans(b.trace)
    entries: List[DiffEntry] = []
    first: Optional[str] = None
    if not sa and not sb:
        return entries, first
    if len(sa) != len(sb):
        entries.append(DiffEntry("spans", "n_spans", len(sa), len(sb),
                                 note="sim-span counts differ"))
    for i, (xa, xb) in enumerate(zip(sa, sb)):
        if xa != xb:
            fmt = lambda s: (f"{s[4]}@{s[2]}/{s[3]} "
                             f"[{s[0] / 1e6:.3f}s +{s[1] / 1e6:.3f}s]")
            entries.append(DiffEntry("spans", f"span[{i}]",
                                     fmt(xa), fmt(xb)))
            first = f"index {i}: {fmt(xa)} vs {fmt(xb)}"
            break          # everything after the first divergence shifts
    if first is None and len(sa) != len(sb):
        i = min(len(sa), len(sb))
        extra = sa[i] if len(sa) > len(sb) else sb[i]
        side = "A" if len(sa) > len(sb) else "B"
        first = f"index {i}: only in {side}: {extra[4]}@{extra[2]}"
    return entries, first


def diff_bundles(a: RunReport, b: RunReport, rtol: float = 1e-9,
                 atol: float = 1e-12) -> BundleDiff:
    """Compare two bundles; see the module docstring for the sections."""
    out = BundleDiff()
    out.config_delta = _diff_config(a, b)
    out.entries += _diff_metrics(a, b, rtol, atol)
    hist, first_round, first_key = _diff_history(a, b, rtol, atol)
    out.entries += hist
    spans, first_span = _diff_spans(a, b)
    out.entries += spans
    out.first_divergence = {"round": first_round, "round_key": first_key,
                            "span": first_span}
    # incident-count disagreement is itself a finding
    if len(a.incidents) != len(b.incidents):
        out.entries.append(DiffEntry(
            "structure", "n_incidents", len(a.incidents), len(b.incidents)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.diff",
        description="Diff two RunReport bundles (--report-out artifacts); "
                    "exit 1 when hard diffs are found.")
    ap.add_argument("bundle_a")
    ap.add_argument("bundle_b")
    ap.add_argument("--rtol", type=float, default=1e-9)
    ap.add_argument("--atol", type=float, default=1e-12)
    ap.add_argument("--html", default=None, metavar="REPORT.html",
                    help="write a self-contained HTML diff report")
    ap.add_argument("--max-lines", type=int, default=60)
    args = ap.parse_args(argv)

    a = RunReport.load(args.bundle_a)
    b = RunReport.load(args.bundle_b)
    diff = diff_bundles(a, b, rtol=args.rtol, atol=args.atol)
    print(f"A: {args.bundle_a}  (driver={a.driver or '?'}, "
          f"cfg={a.config_hash or '?'}, seed={a.seed})")
    print(f"B: {args.bundle_b}  (driver={b.driver or '?'}, "
          f"cfg={b.config_hash or '?'}, seed={b.seed})")
    for line in diff.summary_lines(max_lines=args.max_lines):
        print(line)
    if args.html:
        from repro_torch.obs.audit.html import render_diff_html
        with open(args.html, "w") as f:
            f.write(render_diff_html(diff, a, b))
        print(f"wrote {args.html}")
    return diff.exit_code
