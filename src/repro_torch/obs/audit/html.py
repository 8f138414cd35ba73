"""Self-contained HTML diff report — zero external dependencies.

``render_diff_html(diff, a, b)`` produces one standalone HTML string:
run header, config-delta table, first-divergence callout, the diff-entry
table color-coded by status, and (when the bundles carry traces) an
inline SVG span timeline per run with lanes stacked vertically —
everything inlined, so the artifact opens anywhere (CI artifact
download, file:// in a browser) without a network.
"""
from __future__ import annotations

import html as _html
from typing import Any, Dict, List, Optional

from repro_torch.obs.audit.bundle import RunReport
from repro_torch.obs.audit.diff import BundleDiff, _sim_spans

_CSS = """
body { font-family: ui-monospace, Menlo, Consolas, monospace;
       margin: 1.5rem; color: #1a1a2e; background: #fafafa; }
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.6rem; }
table { border-collapse: collapse; font-size: 0.82rem; }
th, td { border: 1px solid #ccc; padding: 3px 8px; text-align: left; }
th { background: #eee; }
tr.diff td { background: #ffe3e3; } tr.warn td { background: #fff6d6; }
tr.config td { background: #e4eefc; }
tr.missing_a td, tr.missing_b td { background: #f3e3ff; }
.ok { color: #0a7d32; font-weight: bold; }
.bad { color: #b00020; font-weight: bold; }
.callout { border-left: 4px solid #b00020; background: #fff0f0;
           padding: 6px 12px; margin: 8px 0; }
svg { background: #fff; border: 1px solid #ccc; margin: 4px 0; }
"""

# stable-ish color per span name: hash into a small palette
_PALETTE = ("#4c78a8", "#f58518", "#54a24b", "#e45756", "#72b7b2",
            "#b279a2", "#ff9da6", "#9d755d", "#eeca3b", "#bab0ac")


def _esc(v: Any) -> str:
    return _html.escape(str(v))


def _color(name: str) -> str:
    return _PALETTE[hash(name) % len(_PALETTE)]


def render_timeline_svg(trace: Dict[str, Any], width: int = 900,
                        row_h: int = 16, max_spans: int = 2000) -> str:
    """One SVG: sim-clock spans as horizontal bars, one row per lane.

    Accepts a Chrome trace dict (``RunReport.trace``). Wall lanes are
    skipped — the timeline shows the simulated transport schedule.
    """
    spans = _sim_spans(trace)[:max_spans]
    if not spans:
        return "<p>(no sim-clock spans in trace)</p>"
    lanes: List[str] = []
    lane_idx: Dict[str, int] = {}
    for t0, dur, proc, thread, name in spans:
        key = f"{proc}/{thread}"
        if key not in lane_idx:
            lane_idx[key] = len(lanes)
            lanes.append(key)
    t_min = min(s[0] for s in spans)
    t_max = max(s[0] + s[1] for s in spans) or (t_min + 1.0)
    span_w = max(t_max - t_min, 1e-9)
    label_w = 180
    h = row_h * len(lanes) + 24
    px = lambda t: label_w + (t - t_min) / span_w * (width - label_w - 10)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{h}" font-size="10">']
    for key, i in lane_idx.items():
        y = 18 + i * row_h
        parts.append(f'<text x="2" y="{y + row_h - 5}">{_esc(key)}</text>')
        parts.append(f'<line x1="{label_w}" y1="{y + row_h - 1}" '
                     f'x2="{width - 10}" y2="{y + row_h - 1}" '
                     'stroke="#eee"/>')
    for t0, dur, proc, thread, name in spans:
        i = lane_idx[f"{proc}/{thread}"]
        x = px(t0)
        w = max(px(t0 + dur) - x, 1.0)
        y = 18 + i * row_h + 2
        tip = f"{name} [{t0 / 1e6:.3f}s +{dur / 1e6:.4f}s]"
        parts.append(f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" '
                     f'height="{row_h - 5}" fill="{_color(name)}" '
                     f'opacity="0.85"><title>{_esc(tip)}</title></rect>')
    parts.append(f'<text x="{label_w}" y="12">{t_min / 1e6:.3f}s</text>')
    parts.append(f'<text x="{width - 70}" y="12">{t_max / 1e6:.3f}s</text>')
    parts.append("</svg>")
    return "".join(parts)


def _entry_table(entries: List) -> str:
    if not entries:
        return '<p class="ok">none</p>'
    rows = ["<table><tr><th>status</th><th>section</th><th>key</th>"
            "<th>A</th><th>B</th><th>Δ</th><th>rel</th></tr>"]
    for e in entries:
        d = "" if e.delta is None else f"{e.delta:+.6g}"
        r = "" if e.rel is None else f"{100 * e.rel:+.3f}%"
        rows.append(
            f'<tr class="{e.status}"><td>{_esc(e.status)}</td>'
            f"<td>{_esc(e.section)}</td><td>{_esc(e.key)}</td>"
            f"<td>{_esc(e.a)}</td><td>{_esc(e.b)}</td>"
            f"<td>{d}</td><td>{r}</td></tr>")
    rows.append("</table>")
    return "".join(rows)


def render_diff_html(diff: BundleDiff, a: Optional[RunReport] = None,
                     b: Optional[RunReport] = None) -> str:
    """The full standalone report for one bundle comparison."""
    head = ""
    if a is not None and b is not None:
        head = ("<table><tr><th></th><th>A</th><th>B</th></tr>"
                f"<tr><td>driver</td><td>{_esc(a.driver)}</td>"
                f"<td>{_esc(b.driver)}</td></tr>"
                f"<tr><td>config hash</td><td>{_esc(a.config_hash)}</td>"
                f"<td>{_esc(b.config_hash)}</td></tr>"
                f"<tr><td>seed</td><td>{_esc(a.seed)}</td>"
                f"<td>{_esc(b.seed)}</td></tr>"
                f"<tr><td>rounds</td><td>{len(a.history)}</td>"
                f"<td>{len(b.history)}</td></tr>"
                f"<tr><td>incidents</td><td>{len(a.incidents)}</td>"
                f"<td>{len(b.incidents)}</td></tr>"
                f"<tr><td>env</td><td>{_esc(a.env)}</td>"
                f"<td>{_esc(b.env)}</td></tr></table>")
    verdict = (f'<p class="bad">{diff.n_diffs} hard diffs, '
               f"{diff.n_warns} warnings</p>" if diff.n_diffs else
               f'<p class="ok">no hard diffs ({diff.n_warns} warnings)</p>')
    fd = ""
    if diff.first_divergence.get("round") is not None:
        fd += (f'<div class="callout">first diverging round: '
               f'<b>{diff.first_divergence["round"]}</b> '
               f'(key <code>{_esc(diff.first_divergence.get("round_key"))}'
               "</code>)</div>")
    if diff.first_divergence.get("span"):
        fd += (f'<div class="callout">first diverging span: '
               f'{_esc(diff.first_divergence["span"])}</div>')
    timelines = ""
    if a is not None and a.trace.get("traceEvents"):
        timelines += "<h2>Timeline A</h2>" + render_timeline_svg(a.trace)
    if b is not None and b.trace.get("traceEvents"):
        timelines += "<h2>Timeline B</h2>" + render_timeline_svg(b.trace)
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        "<title>repro.obs.diff report</title>"
        f"<style>{_CSS}</style></head><body>"
        "<h1>repro.obs.diff — run comparison</h1>"
        + head + verdict + fd
        + "<h2>Config delta</h2>" + _entry_table(diff.config_delta)
        + "<h2>Diff entries</h2>" + _entry_table(diff.entries)
        + timelines
        + "</body></html>")
