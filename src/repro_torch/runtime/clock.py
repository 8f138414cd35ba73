"""SimClock — the simulated wall clock behind the event-driven runtime
(port of ``repro.runtime.clock``, plain Python).

A single time-ordered heap of scheduled callbacks. Everything the
Orchestrator does — client dispatches, updates reaching the PON edge, ONU
θ gather windows, aggregation deadlines, PON grant/completion events
(bridged from ``pon.events.UpstreamSim``) — is a callback on this clock,
so one ``run_until`` drives the whole machine and "simulated seconds" is
a first-class measurement axis.

Determinism: events fire in (time, schedule order); scheduling an event in
the past is clamped to *now* (a zero-delay follow-up), never time travel.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Any, Callable, List, Optional


class ScheduledEvent:
    """Handle for one scheduled callback; ``cancel()`` makes it a no-op."""

    __slots__ = ("t", "seq", "fn", "args", "cancelled")

    def __init__(self, t: float, seq: int, fn: Callable, args: tuple):
        self.t = t
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "ScheduledEvent") -> bool:
        return (self.t, self.seq) < (other.t, other.seq)


class SimClock:
    def __init__(self, start_s: float = 0.0):
        self.now = float(start_s)
        self._heap: List[ScheduledEvent] = []
        self._seq = itertools.count()
        self.events_fired = 0       # lifetime count of callbacks run

    def schedule(self, t: float, fn: Callable, *args: Any) -> ScheduledEvent:
        """Schedule ``fn(*args)`` at simulated time ``t`` (>= now)."""
        ev = ScheduledEvent(max(float(t), self.now), next(self._seq), fn, args)
        heapq.heappush(self._heap, ev)
        return ev

    def after(self, dt: float, fn: Callable, *args: Any) -> ScheduledEvent:
        return self.schedule(self.now + dt, fn, *args)

    def peek(self) -> Optional[float]:
        """Time of the next live event, or None when the heap is empty."""
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0].t if self._heap else None

    def step(self) -> bool:
        """Fire the next live event (advancing ``now``); False when idle."""
        if self.peek() is None:
            return False
        ev = heapq.heappop(self._heap)
        self.now = ev.t
        self.events_fired += 1
        ev.fn(*ev.args)
        return True

    def run_until(self, t: float) -> None:
        """Fire every event with time <= ``t``; leaves ``now`` at ``t``."""
        while True:
            nxt = self.peek()
            if nxt is None or nxt > t:
                break
            self.step()
        self.now = max(self.now, t)

    def run(self, until_s: float = math.inf, max_events: int = 10_000_000
            ) -> float:
        """Drain the heap (bounded); returns the final ``now``."""
        for _ in range(max_events):
            nxt = self.peek()
            if nxt is None or nxt > until_s:
                break
            self.step()
        return self.now

    def empty(self) -> bool:
        return self.peek() is None
