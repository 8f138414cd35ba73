"""Background upstream traffic competing with FL for PON grants — port of
``repro.pon.traffic`` (numpy).

The paper reserves a private 100 Mb/s slice, so FL never contends; here
residential/enterprise upstream bursts queue at the same ONUs and the DBA
decides who goes first. ``BackgroundTraffic`` offers Poisson burst arrivals
per ONU with exponential burst sizes, calibrated so the total offered load
is ``load`` × the topology's aggregate upstream capacity (``load`` > 1 is
an overload).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class BackgroundTraffic:
    load: float = 0.0           # offered load as a fraction of total capacity
    burst_mbits: float = 5.0    # mean burst size (exponential)
    start_s: float = 0.0        # bursts arrive in [start_s, horizon_s)

    def jobs(self, rng: np.random.Generator, topology, horizon_s: float,
             seq_start: int = 0) -> List:
        """Draw this round's background bursts as upstream jobs, ONU by ONU
        (arrival gap, then size, per burst).

        Deterministic given ``rng``; draws nothing when ``load <= 0`` so a
        zero-load config leaves the caller's RNG stream untouched.
        """
        from repro_torch.pon.events import UpstreamJob

        if self.load <= 0.0:
            return []
        span = horizon_s - self.start_s
        if span <= 0.0:
            return []
        rate_per_onu = (self.load * topology.total_rate_mbps()
                        / (self.burst_mbits * topology.n_onus))  # bursts/s
        out: List[UpstreamJob] = []
        seq = seq_start
        for onu in topology.onus:
            t = self.start_s
            while True:
                t += rng.exponential(1.0 / rate_per_onu)
                if t >= horizon_s:
                    break
                size = rng.exponential(self.burst_mbits)
                out.append(UpstreamJob(seq=seq, onu=onu.id, size_mbits=size,
                                       ready_s=t, kind="bg"))
                seq += 1
        return out
