"""MetricsRegistry — counters, gauges, histograms with one ownership rule
(port of ``repro.obs.metrics``).

Each driver (``RoundLoop``, ``Orchestrator``) owns ONE registry and it is
the *source of truth* for its accounting: transport code adds into
counters, and the History rows / run totals are *read back out* of the
registry.

:class:`Counter` therefore keeps two accumulators fed by the identical
``+=`` sequence:

  * ``total``  — monotonic over the run (``total_upstream_mbits``)
  * ``take()`` — drains the since-last-take window (a row's value)

so one add per take gives a row the added float bit for bit, and the
total is the rows' sum in their order (pinned by tests/test_torch_obs.py
against the History's ``*_mbits`` values).

Histograms keep exact count/sum/min/max plus a bounded sample reservoir —
distribution summaries (straggler/staleness spread, DBA queue depth,
kernel step times) without unbounded memory on long runs. The reservoir
is a *seeded* Algorithm-R sample: every observation — early or late — has
the same retention probability, and the seed derives from the metric name
so two identical runs export identical quantiles, and the reference
package's too (tests/test_torch_obs.py).

Exporters: ``summary()`` (flat dict, attached to benchmark rows) and
``write_jsonl()`` (one JSON object per metric, machine-diffable across
runs and across the two packages: the schema tag is shared). Registries
from separate driver instances merge via :meth:`MetricsRegistry.merge`
(one ``--metrics-out`` artifact for a sweep).
"""
from __future__ import annotations

import json
import random
import zlib
from typing import Any, Dict, List

# every metrics artifact carries this schema tag, the reference package's,
# so downstream tooling of either package can key on it
SCHEMA = "repro.obs/v1"


class Counter:
    """Monotonic total + drainable window, fed by one ``add`` sequence."""

    __slots__ = ("name", "total", "_window", "n")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self._window = 0.0
        self.n = 0

    def add(self, v: float = 1.0) -> None:
        v = float(v)
        self.total += v
        self._window += v
        self.n += 1

    def take(self) -> float:
        """Drain and return the since-last-take window."""
        v, self._window = self._window, 0.0
        return v

    def peek(self) -> float:
        return self._window

    def merge_from(self, other: "Counter") -> None:
        self.total += other.total
        self._window += other._window
        self.n += other.n

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "counter", "name": self.name, "total": self.total,
                "n": self.n}


class Gauge:
    """Last-set value with running min/max."""

    __slots__ = ("name", "value", "min", "max", "n")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.n = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max
        self.n += 1

    def merge_from(self, other: "Gauge") -> None:
        if other.n:
            self.value = other.value       # later-merged registry wins
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        self.n += other.n

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "gauge", "name": self.name, "value": self.value,
                "min": self.min if self.n else None,
                "max": self.max if self.n else None, "n": self.n}


class Histogram:
    """Exact moments + a bounded seeded-reservoir sample (Algorithm R).

    ``count``/``sum``/``min``/``max`` are exact over every observation.
    The quantile reservoir holds a uniform sample of at most
    ``max_samples`` observations: once full, the i-th observation replaces
    a random slot with probability ``max_samples / i`` — so late
    observations are just as likely to be retained as early ones. The RNG
    is seeded from the metric name, so identical runs export identical
    summaries bit for bit.
    """

    __slots__ = ("name", "count", "sum", "min", "max", "samples",
                 "_max", "_rng")

    def __init__(self, name: str, max_samples: int = 4096, seed: int = 0):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: List[float] = []
        self._max = max_samples
        self._rng = random.Random(zlib.crc32(name.encode()) ^ seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max
        if len(self.samples) < self._max:
            self.samples.append(v)
        else:
            # Algorithm R: uniform over all `count` observations so far
            j = self._rng.randrange(self.count)
            if j < self._max:
                self.samples[j] = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[idx]

    def merge_from(self, other: "Histogram") -> None:
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        merged = self.samples + other.samples
        if len(merged) > self._max:
            # deterministic even-stride thinning of the combined reservoir
            step = -(-len(merged) // self._max)       # ceil division
            merged = merged[::step][:self._max]
        self.samples = merged

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "histogram", "name": self.name, "count": self.count,
                "mean": self.mean,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "p50": self.quantile(0.5), "p90": self.quantile(0.9),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Get-or-create named metric instruments + exporters."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._tags: Dict[str, Any] = {}

    # --- run-level tags --------------------------------------------------

    def tag(self, key: str, value: Any) -> None:
        """Attach a run-level label (e.g. ``sim_engine``) stamped onto every
        exported record. Tags annotate ``records()``/``write_jsonl`` rows
        only — ``summary()`` stays a pure {metric: value} dict so benchmark
        row schemas are unchanged by tagging."""
        self._tags[str(key)] = value

    @property
    def tags(self) -> Dict[str, Any]:
        return dict(self._tags)

    # --- instruments -----------------------------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name)
        return h

    def names(self) -> List[str]:
        return sorted([*self._counters, *self._gauges, *self._hists])

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other``'s instruments into this registry (same-name
        counters/histograms accumulate; gauges take the merged value).
        A sweep's artifact: one registry per driver instance, merged into
        the session registry at export time."""
        for name, c in other._counters.items():
            self.counter(name).merge_from(c)
        for name, g in other._gauges.items():
            self.gauge(name).merge_from(g)
        for name, h in other._hists.items():
            self.histogram(name).merge_from(h)
        self._tags.update(other._tags)     # union; later-merged wins
        return self

    # --- exporters -------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Flat {metric: value} dict: counter totals, gauge values, and
        histogram count/mean/p50/p90/p99/max columns."""
        out: Dict[str, Any] = {"obs_schema": SCHEMA}
        for name, c in sorted(self._counters.items()):
            out[name] = c.total
        for name, g in sorted(self._gauges.items()):
            out[name] = g.value
        for name, h in sorted(self._hists.items()):
            d = h.to_dict()
            for k in ("count", "mean", "p50", "p90", "p99", "max"):
                out[f"{name}.{k}"] = d[k]
        return out

    def records(self) -> List[Dict[str, Any]]:
        """One dict per instrument (the JSONL rows)."""
        rows = [i.to_dict() for _, i in sorted(self._counters.items())]
        rows += [i.to_dict() for _, i in sorted(self._gauges.items())]
        rows += [i.to_dict() for _, i in sorted(self._hists.items())]
        for r in rows:
            r["obs_schema"] = SCHEMA
            r.update(self._tags)
        return rows

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec, default=float) + "\n")
        return path


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a ``write_jsonl`` artifact back (for tests / report tooling)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
