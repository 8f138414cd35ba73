"""Pluggable DBA (dynamic bandwidth allocation) grant schedulers — port of
``repro.pon.dba`` (plain Python).

The OLT runs one policy instance per simulation. Whenever a wavelength goes
idle the event loop hands the policy the set of *eligible* pending jobs
(ONU transmitter free, wavelength in the ONU's TWDM set) and the policy
picks which one to grant — one job per grant, non-preemptive.

Policies (register more via ``DBA_POLICIES``):

  * ``fifo``  (alias ``fixed``): first-come-first-served in arrival order —
    the paper's implicit discipline; under one wavelength it reproduces the
    closed-form FIFO model in ``timing.round_times_fifo`` bit for bit.
  * ``tdma``: fixed TDMA cycle — grants rotate through ONU ids in a fixed
    order, one head-of-line job per ONU per turn; empty slots are elided
    (gated round-robin polling).
  * ``ipact``: status-reporting dynamic allocation (IPACT family) — the
    OLT grants the ONU with the largest reported backlog first (ties →
    lower ONU id).
  * ``fl_priority``: FL-aware strict priority — θ partial aggregates first,
    then raw FL client updates, then background traffic; FIFO within a
    class. Copied as the reference has it, which is not monotone in the
    background load (ROADMAP.md Queue 3).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Type

# priority classes for upstream jobs (lower = more urgent under fl_priority)
KIND_PRIORITY: Dict[str, int] = {"theta": 0, "fl": 1, "bg": 2}


class DbaPolicy:
    """Interface: stateful grant scheduler, reset once per simulation."""

    name = "base"

    def reset(self, topology) -> None:  # noqa: ARG002 - stateless by default
        pass

    def select(self, now: float, wavelength: int, candidates: Sequence):
        """Pick one job among eligible pending jobs (or None to stay idle).

        ``candidates`` is never empty when called by the event loop.
        """
        raise NotImplementedError


def _fifo_key(job):
    return (job.ready_s, job.seq)


class FifoDba(DbaPolicy):
    """First-come-first-served: earliest-ready job wins (tie → lowest seq)."""

    name = "fifo"

    def select(self, now, wavelength, candidates):
        return min(candidates, key=_fifo_key)


class TdmaDba(DbaPolicy):
    """Fixed TDMA cycle over ONU ids, one head-of-line grant per turn."""

    name = "tdma"

    def reset(self, topology):
        self._n_onus = topology.n_onus
        self._next = 0

    def select(self, now, wavelength, candidates):
        by_onu: Dict[int, List] = {}
        for j in candidates:
            by_onu.setdefault(j.onu, []).append(j)
        for off in range(self._n_onus):
            onu = (self._next + off) % self._n_onus
            if onu in by_onu:
                self._next = (onu + 1) % self._n_onus
                return min(by_onu[onu], key=_fifo_key)
        return None


class IpactDba(DbaPolicy):
    """Status-reporting: largest reported ONU backlog first (IPACT-style)."""

    name = "ipact"

    def select(self, now, wavelength, candidates):
        backlog: Dict[int, float] = {}
        for j in candidates:
            backlog[j.onu] = backlog.get(j.onu, 0.0) + j.size_mbits
        onu = max(backlog, key=lambda o: (backlog[o], -o))
        return min((j for j in candidates if j.onu == onu), key=_fifo_key)


class FlPriorityDba(DbaPolicy):
    """FL-aware strict priority: θ > client updates > background; FIFO within."""

    name = "fl_priority"

    def select(self, now, wavelength, candidates):
        return min(candidates,
                   key=lambda j: (KIND_PRIORITY.get(j.kind, 3), *_fifo_key(j)))


DBA_POLICIES: Dict[str, Type[DbaPolicy]] = {
    "fifo": FifoDba,
    "fixed": FifoDba,
    "tdma": TdmaDba,
    "ipact": IpactDba,
    "fl_priority": FlPriorityDba,
}


def make_dba(name: str) -> DbaPolicy:
    try:
        return DBA_POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown DBA policy {name!r}; "
                         f"have {sorted(DBA_POLICIES)}") from None
