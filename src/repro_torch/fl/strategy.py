"""Aggregation strategies — port of the ``repro.fl.strategy`` registry.

A Strategy owns the learning-side hooks of a round:

    local_update(global_params, batches, loss_fn, fl) -> (delta, loss)
    aggregate(deltas, weights, mask, onu_ids, n_onus)  -> (agg, stats)
    server_update(params, agg, state)                  -> (params, state)

plus ``transport`` ("sfl" | "classical") — what crosses the PON upstream,
which the RoundLoop feeds to the transport model. This slice ports the
paper's pair: ``sfl_two_step`` (alias ``sfl``) and the ``classical``
benchmark; ``fedprox``, ``fedopt``, ``hier_sfl`` and wire compression
follow in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Tuple

from repro_torch.core import fedavg

Stats = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Base strategy: FedAvg local SGD, aggregation by ``transport``, and
    the plain server step (global model + mean delta)."""

    name: ClassVar[str] = "base"
    transport: ClassVar[str] = "sfl"   # what crosses the PON upstream

    def init_state(self, params) -> Any:
        """Server-side optimizer state (None for plain FedAvg)."""
        return None

    def local_update(self, global_params, batches, loss_fn: Callable, fl):
        """One client's local training -> (delta leaves, mean loss)."""
        return fedavg.default_local_update(global_params, batches, loss_fn, fl)

    def aggregate(self, deltas, weights, mask, onu_ids, n_onus: int
                  ) -> Tuple[Any, Stats]:
        return fedavg.aggregate(deltas, weights, mask, onu_ids, n_onus,
                                self.transport)

    def server_update(self, params, agg, state) -> Tuple[Any, Any]:
        return fedavg.server_apply(params, agg), state


@dataclasses.dataclass(frozen=True)
class SflTwoStep(Strategy):
    """The paper's protocol: in-ONU weighted sum (θ), cross-PON reduce;
    one θ per active ONU crosses the PON."""

    name: ClassVar[str] = "sfl_two_step"
    transport: ClassVar[str] = "sfl"


@dataclasses.dataclass(frozen=True)
class Classical(Strategy):
    """Flat FedAvg benchmark: every involved client uploads its full model."""

    name: ClassVar[str] = "classical"
    transport: ClassVar[str] = "classical"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}
_ALIASES: Dict[str, str] = {}


def register_strategy(name: str, *aliases: str):
    """Class decorator: adds a Strategy subclass to the registry."""
    def deco(cls):
        _REGISTRY[name] = cls
        for a in aliases:
            _ALIASES[a] = name
        return cls
    return deco


def canonical_name(name: str) -> str:
    if name in _REGISTRY:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(
        f"unknown strategy {name!r}; registered: {strategy_names()} "
        f"(aliases: {sorted(_ALIASES)})")


def strategy_names():
    return sorted(_REGISTRY)


def make_strategy(name: str) -> Strategy:
    """Instantiate a registered strategy by name or alias."""
    return _REGISTRY[canonical_name(name)]()


register_strategy("sfl_two_step", "sfl")(SflTwoStep)
register_strategy("classical")(Classical)
