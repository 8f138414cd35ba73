"""The phases every round-driven cell shares: the compared first rounds,
the measured window (the card's activity recorded throughout) and the
traced window, each through the program's own ``RoundLoop.run_round``
(which synchronises the card at both ends of a round)."""
from __future__ import annotations

import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import trace as trace_mod


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def note(phase: str, t0: float) -> None:
    """One set-up phase's end, seconds since the process started, on stderr."""
    print(f"portbench: {phase} at {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)


def first_rounds(loop, n: int, after_round: Callable[[int], None], t0: float
                 ) -> Dict[str, List]:
    """Rounds 0 .. n−1, the transport stage's selection and involvement
    mask recorded as the backend receives them; ``after_round(r)`` reads
    the program's state after round r. They warm up every shape the window
    uses."""
    backend = loop.backend
    seen: Dict[str, List] = {"selected": [], "mask": [], "upstream_mbits": [], "rows": []}

    def recording(rnd, selected, mask, rt, rng):
        seen["selected"].append(np.array(selected))
        seen["mask"].append(np.array(mask, np.float32))
        return type(backend).run_round(backend, rnd, selected, mask, rt, rng)

    backend.run_round = recording
    try:
        for r in range(n):
            row = loop.run_round(r)
            seen["rows"].append(row)
            seen["upstream_mbits"].append(row["upstream_mbits"])
            after_round(r)
            note(f"round {r}", t0)
    finally:
        del backend.run_round           # the window runs the class's own method
    return seen


def measure(loop, first: int, seconds: float, dev: torch.device) -> Dict:
    """Rounds from ``first`` until ``seconds`` have passed: the rows, the
    window's length, its peak device memory and, on a card, the seconds in
    which the card ran an operation (torch.profiler, the card's activity
    alone)."""
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    clock = {}

    def rounds():
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        while True:
            rows.append(loop.run_round(first + len(rows)))
            if time.perf_counter() - t0 >= seconds:
                break
        clock.update(window_s=time.perf_counter() - t0, cpu_s=time.process_time() - cpu0)

    busy_s = None
    if dev.type == "cuda":
        busy_s = trace_mod.busy_during(rounds)
    else:
        rounds()
    window_s = clock["window_s"]
    print(f"portbench: window {window_s:.3f} s, process cpu {clock['cpu_s']:.3f} s, "
          "walls " + " ".join(f"{r['wall_s']:.4f}" for r in rows), file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"rows": rows, "window_s": window_s, "device_busy_s": busy_s,
            "memory_peak_bytes": int(peak), "next_round": first + len(rows)}


def traced(loop, first: int, seconds: float) -> Optional[trace_mod.Trace]:
    """Rounds from ``first`` under the profiler for ``seconds`` (two at
    least)."""
    nxt = [first]

    def step():
        row = loop.run_round(nxt[0])
        nxt[0] += 1
        return row

    return trace_mod.capture(step, seconds)


def release(dev: torch.device) -> None:
    """Give the program's freed state back before the reference runs."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
