"""One run of one cell: its driver's set-up, window, traced window and
comparison, then the result line.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, each read by its own reader from
the run's context (the window's History rows, the program's span
totals, the traced window). A reader that finds nothing returns None and
the metric is left out of the line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Any, Dict, List, Optional

from portbench.harness import cells
from portbench.harness.checks import Check, passed
from portbench.harness.trace import Trace

# top-level module names that must not be loaded in a run's process
FOREIGN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]              # every end-to-end metric the driver measured
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    context: Dict[str, Any]            # what the per-layer readers read
    trace: Optional[Trace] = None


def foreign_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


def result(cell: cells.Cell, out: Outcome, trace: bool, device: Dict) -> Dict:
    metrics = {}
    if trace:
        ctx = dict(out.context, trace=out.trace, config=cell.config, traffic=cell.traffic)
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    line = {"correct": passed(out.checks), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dict(device, memory_peak_bytes=out.memory_peak_bytes)}
    if trace and out.trace is not None:
        line["device"].update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        line["breakdown"] = {"device_ops": [list(x) for x in out.trace.device_ops],
                             "idle_gaps": [list(x) for x in out.trace.idle_gaps]}
    line["checks"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim}
                      for name, v, lim in out.checks}
    return line


def emit(line: Dict, checks: List[Check]) -> None:
    """The numbers compared, beside their limits, as the last lines on
    standard error; the result as the last line on standard output."""
    sys.stdout.flush()
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
