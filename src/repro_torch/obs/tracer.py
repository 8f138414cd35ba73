"""Span-based tracing on the simulated AND the wall clock.

Every interesting interval in a federated run — a client's
dispatch→train→wireless leg, a DBA grant occupying a wavelength, an ONU's
θ gather window, an OLT's Φ gather, the server aggregation — becomes a
:class:`Span` on a (process-lane, thread-lane) track, timestamped in
*simulated seconds* (the ``SimClock`` / ``UpstreamSim`` event axis).
Wall-clock work (backend training, eval, kernel compiles) goes on its own
``wall:*`` lanes so compute cost and simulated transport can be read off
one timeline.

The exporter writes the Chrome trace-event JSON format
(``{"traceEvents": [...]}``), which Perfetto (https://ui.perfetto.dev)
and ``chrome://tracing`` load directly: lanes become named
processes/threads, ``X`` complete events render as nested bars, ``C``
counter events as area charts (DBA queue depth), ``i`` instants as ticks.

The default tracer everywhere is :data:`NOOP_TRACER`: ``enabled`` is
False, every method is a no-op, and hot paths gate on ``tracer.enabled``
so a disabled run never pays for string formatting or dict building —
the zero-overhead contract pinned by tests/test_torch_obs.py.
"""
from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, List, Optional, Tuple

# event phases in the Chrome trace-event format
_COMPLETE, _INSTANT, _COUNTER, _META = "X", "i", "C", "M"


class Span:
    """One closed interval on a (pid, tid) lane; times in seconds."""

    __slots__ = ("name", "t0_s", "t1_s", "lane", "cat", "args")

    def __init__(self, name: str, t0_s: float, t1_s: float,
                 lane: Tuple[str, str], cat: str = "",
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0_s = float(t0_s)
        self.t1_s = float(t1_s)
        self.lane = lane
        self.cat = cat
        self.args = args

    @property
    def dur_s(self) -> float:
        return self.t1_s - self.t0_s

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, [{self.t0_s:.3f}, {self.t1_s:.3f}]s, "
                f"lane={self.lane})")


class _SpanCtx:
    """Context manager recording one span from a live clock callable."""

    __slots__ = ("_tracer", "_name", "_lane", "_cat", "_args", "_clock", "_t0")

    def __init__(self, tracer: "Tracer", name: str, lane: Tuple[str, str],
                 cat: str, args, clock):
        self._tracer = tracer
        self._name = name
        self._lane = lane
        self._cat = cat
        self._args = args
        self._clock = clock

    def __enter__(self):
        self._t0 = self._clock()
        self._tracer._depth += 1
        return self

    def __exit__(self, *exc):
        self._tracer._depth -= 1
        self._tracer.add_span(self._name, self._t0, self._clock(),
                              lane=self._lane, cat=self._cat, args=self._args)
        return False


class Tracer:
    """Collects spans/instants/counter samples; exports Chrome trace JSON.

    Two time bases coexist:

      * **simulated seconds** — pass explicit ``t0_s``/``t1_s`` (from
        ``UpstreamJob.start_s/done_s`` or ``SimClock.now``) to
        :meth:`add_span`, or a live sim-clock callable to :meth:`span`.
        ``offset_s`` shifts retroactive per-round emissions onto one
        global timeline (round *r* of a lockstep driver starts at
        ``r × window``).
      * **wall seconds** — :meth:`wall_span` measures host time
        (``time.perf_counter`` relative to tracer creation) onto
        ``wall:*`` lanes, kept separate so simulated and real time are
        never conflated on one track.
    """

    enabled = True

    def __init__(self):
        self.spans: List[Span] = []
        self.instants: List[Tuple[str, float, Tuple[str, str], Dict]] = []
        self.counters: List[Tuple[str, float, Tuple[str, str], Dict]] = []
        self.offset_s = 0.0         # added to sim-time span emissions
        self._wall0 = time.perf_counter()
        self._depth = 0             # live open-span depth (nesting check)

    # --- recording -------------------------------------------------------

    def add_span(self, name: str, t0_s: float, t1_s: float,
                 lane: Tuple[str, str] = ("main", "main"), cat: str = "",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record one closed sim-time span (``offset_s`` applied)."""
        if not (math.isfinite(t0_s) and math.isfinite(t1_s)):
            return
        off = self.offset_s
        self.spans.append(Span(name, t0_s + off, t1_s + off, lane, cat, args))

    def span(self, name: str, lane: Tuple[str, str] = ("main", "main"),
             cat: str = "", args: Optional[Dict[str, Any]] = None,
             clock=None) -> _SpanCtx:
        """Context manager span on a live clock callable (sim by default
        only if ``clock`` is given; pass ``SimClock``'s ``lambda: clock.now``)."""
        if clock is None:
            raise ValueError("span() needs a clock callable; use wall_span() "
                             "for host time or add_span() for known intervals")
        return _SpanCtx(self, name, lane, cat, args, clock)

    def wall_span(self, name: str, lane_tid: str = "host", cat: str = "wall",
                  args: Optional[Dict[str, Any]] = None) -> _SpanCtx:
        """Context manager measuring wall time onto the ``wall:*`` lanes."""
        return _SpanCtx(self, name, ("wall", lane_tid), cat, args,
                        self._wall_now)

    def _wall_now(self) -> float:
        # wall spans bypass offset_s: subtract it back out at record time
        return time.perf_counter() - self._wall0 - self.offset_s

    def instant(self, name: str, t_s: float,
                lane: Tuple[str, str] = ("main", "main"),
                args: Optional[Dict[str, Any]] = None) -> None:
        if math.isfinite(t_s):
            self.instants.append((name, t_s + self.offset_s, lane, args or {}))

    def counter(self, name: str, t_s: float, values: Dict[str, float],
                lane: Tuple[str, str] = ("main", "counters")) -> None:
        """One sample of a counter track (rendered as an area chart)."""
        if math.isfinite(t_s):
            self.counters.append((name, t_s + self.offset_s, lane, values))

    # --- export ----------------------------------------------------------

    def _lane_ids(self):
        """Intern lane labels to stable integer pid/tid + metadata events."""
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}
        meta = []
        lanes = ([s.lane for s in self.spans]
                 + [l for _, _, l, _ in self.instants]
                 + [l for _, _, l, _ in self.counters])
        for lane in lanes:
            proc, thread = lane
            if proc not in pids:
                pids[proc] = len(pids) + 1
                meta.append({"ph": _META, "name": "process_name",
                             "pid": pids[proc], "tid": 0,
                             "args": {"name": proc}})
            if lane not in tids:
                tids[lane] = len(tids) + 1
                meta.append({"ph": _META, "name": "thread_name",
                             "pid": pids[proc], "tid": tids[lane],
                             "args": {"name": thread}})
        return pids, tids, meta

    def to_chrome(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event dict (ts/dur in microseconds)."""
        pids, tids, events = self._lane_ids()
        for s in self.spans:
            ev = {"ph": _COMPLETE, "name": s.name,
                  "ts": s.t0_s * 1e6, "dur": max(s.dur_s, 0.0) * 1e6,
                  "pid": pids[s.lane[0]], "tid": tids[s.lane]}
            if s.cat:
                ev["cat"] = s.cat
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        for name, t, lane, args in self.instants:
            events.append({"ph": _INSTANT, "name": name, "ts": t * 1e6,
                           "s": "t", "pid": pids[lane[0]], "tid": tids[lane],
                           "args": args})
        for name, t, lane, values in self.counters:
            events.append({"ph": _COUNTER, "name": name, "ts": t * 1e6,
                           "pid": pids[lane[0]], "tid": tids[lane],
                           "args": values})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        """Write the Chrome trace JSON (Perfetto-loadable); returns path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class NoopTracer:
    """Zero-overhead default: ``enabled`` is False, every method no-ops.

    Shares the Tracer surface so call sites never branch on type — only
    (optionally) on ``enabled`` to skip building span arguments.
    """

    enabled = False
    offset_s = 0.0
    spans: tuple = ()
    instants: tuple = ()
    counters: tuple = ()

    def add_span(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def span(self, *a, **k) -> "_NullCtx":
        return _NULL_CTX

    def wall_span(self, *a, **k) -> "_NullCtx":
        return _NULL_CTX

    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()
NOOP_TRACER = NoopTracer()
