"""Array primitives behind the vectorized PON fast path — port of
``repro.pon.fast.segments`` (numpy).

Everything here is float64 numpy on purpose: the fast engine's contract is
*bit-for-bit* agreement with the event heap wherever it claims exactness,
and the heap computes in IEEE doubles. The wins at population scale come
from vectorizing the O(N) work (segment maxima, dedicated service,
sorting) and from never materializing per-job Python objects; the FIFO
chain itself is an O(n) scan that reproduces the heap's exact op sequence
``start = max(prev_done, ready); done = start + service`` (the prefix-sum /
cummax form reassociates the additions and is not bit-stable).
"""
from __future__ import annotations

import numpy as np


def segment_max(values: np.ndarray, segment_ids: np.ndarray,
                num_segments: int) -> np.ndarray:
    """Per-segment maximum; segments with no members come back ``-inf``.

    Exact: ``np.maximum`` never rounds, so this equals the event path's
    per-group ``arr.max()`` float for float.
    """
    out = np.full(num_segments, -np.inf, np.float64)
    if len(values):
        np.maximum.at(out, segment_ids, values)
    return out


def segment_sum(values: np.ndarray, segment_ids: np.ndarray,
                num_segments: int) -> np.ndarray:
    return np.bincount(segment_ids, weights=values,
                       minlength=num_segments).astype(np.float64)


def _chain(ready, service, start: np.ndarray, done: np.ndarray,
           lo: int, stride: int) -> None:
    """One FIFO server chain over ``ready[lo::stride]``:
    ``start = max(t, ready); t = start + service`` with ``t`` starting at
    0.0 — the exact float recurrence the event heap produces for a FIFO
    grant sequence (``UpstreamSim`` sets ``start = now if now > ready else
    ready`` and ``now`` at grant time is the previous completion).
    """
    t = 0.0
    r = ready.tolist()
    s = service.tolist()
    for k in range(lo, len(r), stride):
        st = t if t > r[k] else r[k]
        t = st + s[k]
        start[k] = st
        done[k] = t


def fifo_pack(ready: np.ndarray, service: np.ndarray,
              n_lanes: int = 1) -> tuple:
    """Grant-pack jobs already sorted in FIFO order ``(ready, seq)``.

    ``n_lanes == 1`` is exact for arbitrary per-job service times.
    ``n_lanes > 1`` is exact ONLY for equal service times with at most
    one job per transmitter (the caller enforces both): completions then
    happen in FIFO order, so job ``k`` starts when job ``k - n_lanes``
    completes — the jobs split round-robin into ``n_lanes`` independent
    chains. Returns ``(start, done)`` in the given (sorted) order.
    """
    n = len(ready)
    start = np.empty(n, np.float64)
    done = np.empty(n, np.float64)
    lanes = max(1, min(int(n_lanes), n)) if n else 1
    for lane in range(lanes):
        _chain(ready, service, start, done, lane, lanes)
    return start, done
