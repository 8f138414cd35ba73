"""PON physical topology: ONU trees, per-link rates, TWDM wavelength sets —
port of ``repro.pon.topology`` (numpy).

The paper's setting is the degenerate case — 16 identical ONUs, 20 clients
each, one upstream wavelength at 100 Mb/s. ``Topology`` generalizes it:

  * arbitrary per-ONU client counts (skewed trees, empty ONUs)
  * per-ONU drop-link caps (``link_mbps``) — the effective transmit rate on
    a wavelength is min(wavelength rate, ONU drop link)
  * TWDM: several upstream wavelengths; each ONU carries the subset its
    (tunable) transmitter can reach, and transmits on at most one at a time

``Topology.uniform`` builds the paper-style symmetric tree; the event
simulator (``pon.events``) consumes whatever shape it is handed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Wavelength:
    """One upstream TWDM wavelength channel."""
    id: int
    rate_mbps: float = 100.0


@dataclasses.dataclass(frozen=True)
class Onu:
    """One ONU subtree: its clients, drop-link cap, reachable wavelengths."""
    id: int
    n_clients: int
    link_mbps: Optional[float] = None        # None: no cap beyond wavelength
    wavelengths: Optional[Tuple[int, ...]] = None   # None: all wavelengths

    def reachable(self, topo: "Topology") -> Tuple[int, ...]:
        if self.wavelengths is None:
            return tuple(w.id for w in topo.wavelengths)
        return self.wavelengths


@dataclasses.dataclass(frozen=True)
class Topology:
    onus: Tuple[Onu, ...]
    wavelengths: Tuple[Wavelength, ...]

    def __post_init__(self):
        # ids double as positional indices throughout the simulator
        # (grant bookkeeping, theta arrays) — enforced here rather than
        # silently starving jobs on a mismatched hand-built tree
        for i, o in enumerate(self.onus):
            if o.id != i:
                raise ValueError(f"Onu at position {i} has id {o.id}; "
                                 "ids must equal positions")
        for i, w in enumerate(self.wavelengths):
            if w.id != i:
                raise ValueError(f"Wavelength at position {i} has id {w.id}; "
                                 "ids must equal positions")

    @property
    def n_onus(self) -> int:
        return len(self.onus)

    @property
    def n_clients(self) -> int:
        return sum(o.n_clients for o in self.onus)

    @property
    def n_wavelengths(self) -> int:
        return len(self.wavelengths)

    def onu_of_client(self) -> np.ndarray:
        """Client → ONU id map (clients numbered ONU-major, like the paper)."""
        return np.repeat(np.arange(self.n_onus),
                         [o.n_clients for o in self.onus])

    def rate_mbps(self, onu_id: int, wavelength_id: int) -> float:
        """Effective upstream rate for one ONU on one wavelength."""
        rate = self.wavelengths[wavelength_id].rate_mbps
        link = self.onus[onu_id].link_mbps
        return rate if link is None else min(rate, link)

    def best_rate_mbps(self, onu_id: int) -> float:
        """Fastest rate the ONU can reach on any of its wavelengths
        (0.0 when its transmitter reaches none)."""
        return max((self.rate_mbps(onu_id, w)
                    for w in self.onus[onu_id].reachable(self)),
                   default=0.0)

    def total_rate_mbps(self) -> float:
        return sum(w.rate_mbps for w in self.wavelengths)

    @classmethod
    def uniform(cls, n_onus: int = 16, clients_per_onu: int = 20,
                n_wavelengths: int = 1, rate_mbps: float = 100.0,
                onu_link_mbps: Optional[float] = None) -> "Topology":
        """The paper's symmetric tree, generalized to W wavelengths."""
        return cls(
            onus=tuple(Onu(i, clients_per_onu, link_mbps=onu_link_mbps)
                       for i in range(n_onus)),
            wavelengths=tuple(Wavelength(w, rate_mbps)
                              for w in range(n_wavelengths)),
        )

    @classmethod
    def skewed(cls, client_counts, n_wavelengths: int = 1,
               rate_mbps: float = 100.0,
               onu_link_mbps: Optional[float] = None) -> "Topology":
        """Arbitrary per-ONU client counts (e.g. from a Zipf draw)."""
        return cls(
            onus=tuple(Onu(i, int(c), link_mbps=onu_link_mbps)
                       for i, c in enumerate(client_counts)),
            wavelengths=tuple(Wavelength(w, rate_mbps)
                              for w in range(n_wavelengths)),
        )
