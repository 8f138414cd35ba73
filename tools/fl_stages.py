"""The FL round's stages on the profiler's clock, from one traced run of a
benchmark cell:

    python3 tools/fl_stages.py --workload fl_sfl_n128 --seed 5 [--seconds 20] [--root DIR]

Runs ``portbench/run.py`` of the checkout at ``--root`` (this one by
default) with ``--trace 1`` in this process, keeps the Chrome trace that
its traced window exported, and after the run's own result line prints
one ``STAGES`` JSON line. For each ``backend.*`` and ``fl.*`` range the
program opened (``repro_torch.obs.profile.named_scope``), over the traced
window's rounds: its calls, its host ms (the range's own duration), the
card's idle ms inside it (an idle gap counts toward every range that
contains it), the device operations launched inside it and their device
ms; the window's idle ms by the innermost such range (else the round
loop's host work); and the traced rounds' mean History ``wall_s``,
``train_host_s`` and ``aggregate_host_s``; and for each kernel wrapper's
``kernels.*`` range, its calls and the device operations launched inside
it, with their device ms (``kernels``). Ranges nest (``fl.forward``
inside ``fl.grad`` inside ``backend.train_s``): each is indexed by name,
so every range that contains a point counts it. The card's name and
power limit come first. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np

PREFIXES = ("backend.", "fl.")
KERNELS = "kernels."
LOOP = "host (round loop, transport)"
TOP = 4          # device operations named a range


def _merged(starts: np.ndarray, ends: np.ndarray):
    """Sorted disjoint intervals covering the union of [start, end)."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    first = np.r_[True, s[1:] > e[:-1]]
    last = np.r_[np.flatnonzero(first)[1:] - 1, len(s) - 1]
    return s[first], e[last]


def _inside(starts: np.ndarray, ends: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Which points ``t`` lie in one of the disjoint sorted intervals."""
    i = np.searchsorted(starts, t, side="right") - 1
    ok = i >= 0
    ok[ok] = t[ok] <= ends[i[ok]]
    return ok


def _overlap(a, b) -> float:
    """Length of the intersection of two sets of disjoint sorted intervals."""
    s, e = _merged(np.r_[a[0], b[0]], np.r_[a[1], b[1]])
    return float((a[1] - a[0]).sum() + (b[1] - b[0]).sum() - (e - s).sum())


def stages(events: List[dict], window: str) -> Dict:
    """Reduce a Chrome trace (``torch.profiler``'s export, times in µs)
    to the ``backend.*`` / ``fl.*`` ranges opened inside the range named
    ``window``: seconds by range name (``host_s``, ``idle_s``,
    ``device_s``), counts (``calls``, ``ops``), the ``TOP`` device
    operations by device time launched in each range (``top_ops``), and
    the idle seconds by the innermost range (``idle_by_innermost``); and
    each ``kernels.*`` range's ``calls``, ``ops`` and ``device_s`` apart
    (``kernels``), which take no part in the rest.

    A device operation counts to every range open when it was launched,
    whichever thread launched it: the autograd engine launches a backward's
    kernels on its own thread while the thread that opened ``fl.grad``
    waits inside it."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next(e for e in spans if e.get("name") == window)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    ranges = defaultdict(list)                 # name -> [(start, end)]
    kernel_ranges = defaultdict(list)
    launches = {}                              # correlation -> launch time
    device = []                                # (start, end, name, correlation)
    for e in spans:
        cat, ts = e.get("cat", ""), float(e["ts"])
        end = ts + float(e["dur"])
        if cat == "user_annotation":
            name = e.get("name", "")
            if name.startswith((*PREFIXES, KERNELS)) and w0 <= ts <= w1:
                (kernel_ranges if name.startswith(KERNELS) else ranges)[name].append(
                    (ts, min(end, w1)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset") and end > w0 and ts < w1:
            device.append((max(ts, w0), min(end, w1), e.get("name", "?")[:80],
                           e.get("args", {}).get("correlation")))
    names = sorted(ranges)
    by_name = {n: _merged(*np.array(ranges[n], float).T) for n in names}
    busy = _merged(np.array([d[0] for d in device], float), np.array([d[1] for d in device], float))
    gaps = (np.r_[w0, busy[1]], np.r_[busy[0], w1])
    keep = gaps[1] > gaps[0]
    gaps = (gaps[0][keep], gaps[1][keep])
    launched = [(launches[c], b - a, op) for a, b, op, c in device if c in launches]
    t = np.array([x[0] for x in launched], float)
    dur = np.array([x[1] for x in launched], float)
    out = {"window_s": (w1 - w0) / 1e6, "busy_s": float((busy[1] - busy[0]).sum()) / 1e6,
           "device_ops": len(device), "calls": {n: len(ranges[n]) for n in names},
           "host_s": {n: sum(b - a for a, b in ranges[n]) / 1e6 for n in names},
           "idle_s": {n: _overlap(by_name[n], gaps) / 1e6 for n in names},
           "ops": {}, "device_s": {}, "top_ops": {}}
    for n in names:
        hit = _inside(*by_name[n], t)
        out["ops"][n] = int(hit.sum())
        out["device_s"][n] = float(dur[hit].sum()) / 1e6
        by_op = defaultdict(float)
        for i in np.flatnonzero(hit):
            by_op[launched[i][2]] += launched[i][1] / 1e6
        out["top_ops"][n] = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    # the idle time by the innermost range: the gaps cut at every range's
    # edges, each piece given to the latest-starting range that holds it
    edges = np.unique(np.concatenate([*gaps, *(x for n in names for x in by_name[n])]))
    a, b = edges[:-1], edges[1:]
    mid = 0.5 * (a + b)
    idle = _inside(*gaps, mid) & (b > a)
    a, b, mid = a[idle], b[idle], mid[idle]
    best, start = np.full(len(mid), -1), np.full(len(mid), -np.inf)
    for k, n in enumerate(names):
        s, e = by_name[n]
        i = np.searchsorted(s, mid, side="right") - 1
        ok = i >= 0
        ok[ok] = mid[ok] <= e[i[ok]]
        later = ok & (s[np.maximum(i, 0)] > start)
        best[later], start[later] = k, s[i[later]]
    inner = defaultdict(float)
    for k, d in zip(best, (b - a) / 1e6):
        inner[names[k] if k >= 0 else LOOP] += float(d)
    out["idle_by_innermost"] = dict(sorted(inner.items(), key=lambda kv: -kv[1]))
    out["kernels"] = {}
    for n, spans in sorted(kernel_ranges.items()):
        hit = _inside(*_merged(*np.array(spans, float).T), t)
        out["kernels"][n] = {"calls": len(spans), "ops": int(hit.sum()),
                             "device_s": float(dur[hit].sum()) / 1e6}
    return out


def per_round(st: Dict, rows: List[Dict]) -> Dict:
    """``stages``' sums as ms a round over the traced rounds, with the rows'
    mean host columns."""
    n = len(rows)
    ms = lambda d: {k: 1e3 * v / n for k, v in d.items()}   # noqa: E731
    out = {"rounds": n, "window_s": st["window_s"], "busy_s": st["busy_s"],
           "calls": {k: v / n for k, v in st["calls"].items()},
           "host_ms": ms(st["host_s"]), "idle_ms": ms(st["idle_s"]),
           "device_ops": st["device_ops"] / n,
           "ops": {k: v / n for k, v in st["ops"].items()}, "device_ms": ms(st["device_s"]),
           "idle_by_innermost_ms": ms(st["idle_by_innermost"]),
           "kernels": {k: {"calls": v["calls"] / n, "ops": v["ops"] / n,
                           "device_ms": 1e3 * v["device_s"] / n}
                       for k, v in st["kernels"].items()},
           "top_ops_ms": {k: [(op, 1e3 * v / n) for op, v in ops]
                          for k, ops in st["top_ops"].items()}}
    for key in ("wall_s", "train_host_s", "aggregate_host_s"):
        out[f"rows_{key}"] = sum(r.get(key, 0.0) for r in rows) / n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    print("card:", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(), flush=True)
    sys.path[:0] = [str(root / "src"), str(root)]
    import importlib.util

    from portbench.harness import trace as trace_mod

    kept = {}
    parse = trace_mod.parse

    def keeping(events):
        kept["events"], kept["trace"] = events, parse(events)
        return kept["trace"]

    trace_mod.parse = keeping
    spec = importlib.util.spec_from_file_location("portbench_run", root / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "trace" not in kept:
        return rc or 1
    st = per_round(stages(kept["events"], trace_mod.WINDOW), kept["trace"].steps)
    print("STAGES " + json.dumps(dict(st, workload=args.workload, seed=args.seed,
                                      root=str(root))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
