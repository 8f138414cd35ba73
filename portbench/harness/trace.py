"""The card's time as torch.profiler sees it: the measured window's busy
seconds, and the traced window, the cell's own step run under the profiler
for a few seconds after the measured window, its trace read back.

Each device operation (kernel, copy, set) is attributed to the profiler
ranges its launch sat in on the host: the launch is found by its
correlation id, and the ranges by the launching thread and time. The
program opens a ``kernels.<name>`` range around each kernel wrapper call
and a ``backend.<name>`` range around each timed backend call, so a
kernel's device time inside ``kernels.flash_attention`` is that
wrapper's, whatever launched it.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

WINDOW = "portbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_IDLE = "host (round loop, transport)"
MIN_STEPS = 2


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    range_calls: Dict[str, int]            # kernels.* / backend.* ranges opened in the window
    range_device_s: Dict[str, float]       # device seconds launched inside each range
    device_ops: List[Tuple[str, float]]    # device seconds by operation name, largest first
    idle_gaps: List[Tuple[str, float]]     # idle device seconds by the host's range, largest first
    steps: List = dataclasses.field(default_factory=list)   # what each traced step returned


def capture(step: Callable[[], object], min_seconds: float) -> Trace:
    """Run ``step`` under the profiler until ``min_seconds`` have passed and
    at least ``MIN_STEPS`` steps ran; the card is synchronised at both
    ends of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    steps = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False, profile_memory=False) as prof:
        sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)
        sync()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            while len(steps) < MIN_STEPS or time.perf_counter() - t0 < min_seconds:
                steps.append(step())
            sync()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    trace = parse(events)
    trace.steps = steps
    return trace


def union_seconds(starts: np.ndarray, ends: np.ndarray) -> float:
    """The length of the union of the intervals [start, end), in the
    intervals' own unit."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    first = np.empty(len(s), bool)
    first[0], first[1:] = True, s[1:] > e[:-1]
    last = np.append(np.flatnonzero(first)[1:] - 1, len(s) - 1)
    return float((e[last] - s[first]).sum())


def device_intervals(events) -> Tuple[np.ndarray, np.ndarray, int]:
    """The start and end, ns, of each operation on the card (kernel, copy,
    set) among a profiler session's events, and how many there were."""
    from torch._C._autograd import DeviceType

    starts, ends = [], []
    for ev in events:
        if ev.device_type() != DeviceType.CUDA:
            continue
        kind = getattr(ev, "activity_type", None)
        if kind is not None and kind() not in DEVICE_CATS:
            continue
        a = ev.start_ns()
        starts.append(a)
        ends.append(a + ev.duration_ns())
    return np.array(starts, np.int64), np.array(ends, np.int64), len(starts)


def busy_during(run: Callable[[], None]) -> float:
    """Call ``run()`` with the profiler recording the card's activity alone
    (no host operations, no ranges), and return the seconds in which an
    operation ran on the card meanwhile: the union of the operations'
    intervals. The card is synchronised at both ends, so every operation
    counted is ``run``'s."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    t = time.perf_counter()
    starts, ends, n = device_intervals(prof.profiler.kineto_results.events())
    busy = union_seconds(starts, ends) / 1e9
    print(f"portbench: {n} device operations, busy {busy:.6f} s, read in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    return busy


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Ranges:
    """Non-overlapping ranges of one kind on one thread, searchable by time."""

    def __init__(self, items: List[Tuple[float, float, str]]):
        items.sort()
        self.starts = [a for a, _, _ in items]
        self.items = items

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i][2]
        return None


def parse(events: List[dict]) -> Trace:
    """Reduce a Chrome trace (``torch.profiler``'s export, times in µs) to
    the window's busy time, its kernel and backend ranges' device time, and
    the breakdown."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no traced window")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    launches = {}
    ranges: Dict[Tuple[str, object], List[Tuple[float, float, str]]] = defaultdict(list)
    device = []
    for e in spans:
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            if ts + dur > w0 and ts < w1:
                device.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
        elif cat == "user_annotation":
            name = e.get("name", "")
            for kind in ("kernels.", "backend."):
                if name.startswith(kind) and w0 <= ts <= w1:
                    ranges[(kind, e.get("tid"))].append((ts, ts + dur, name))
    index = {key: _Ranges(items) for key, items in ranges.items()}
    calls: Dict[str, int] = defaultdict(int)
    for (_, _), items in ranges.items():
        for _, _, name in items:
            calls[name] += 1
    range_s: Dict[str, float] = defaultdict(float)
    by_op: Dict[str, float] = defaultdict(float)
    intervals = []
    for e in device:
        ts, dur = float(e["ts"]), float(e["dur"])
        a, b = max(ts, w0), min(ts + dur, w1)
        intervals.append((a, b))
        by_op[e.get("name", "?")[:200]] += (b - a) / 1e6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        for kind in ("kernels.", "backend."):
            r = index.get((kind, launch[1]))
            name = r.at(launch[0]) if r is not None else None
            if name is not None:
                range_s[name] += dur / 1e6
    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) / 1e6
    host = [_Ranges(items) for (kind, _), items in ranges.items() if kind == "backend."]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            name = next((n for n in (r.at(mid) for r in host) if n is not None), HOST_IDLE)
            gaps[name] += (b - a) / 1e6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]   # noqa: E731
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_s, range_calls=dict(calls),
                 range_device_s=dict(range_s), device_ops=top(by_op), idle_gaps=top(gaps))
