"""Aggregation strategies — port of the ``repro.fl.strategy`` registry.

A Strategy owns the learning-side hooks of a round:

    local_update(global_params, batches, loss_fn, fl) -> (delta, loss)
    aggregate(deltas, weights, mask, onu_ids, n_onus,
              *, comp=None, client_ids=None)           -> (agg, stats)
    server_update(params, agg, state)                  -> (params, state)

plus ``transport`` ("sfl" | "classical") — what crosses the PON upstream,
which the RoundLoop feeds to the transport model. Ported so far: the
paper's pair, ``sfl_two_step`` (alias ``sfl``) and the ``classical``
benchmark, each with the wire-compression axis; ``fedprox``, ``fedopt``
and ``hier_sfl`` follow in later slices.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, ClassVar, Dict, Tuple

from repro_torch.core import fedavg
from repro_torch.core.compression import CompressionSpec

Stats = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Base strategy: FedAvg local SGD, aggregation by ``transport``, and
    the server step at ``server_lr`` (global model + server_lr · mean
    delta, in f32, cast back to each leaf's type).

    Every strategy also carries the wire-compression axis (``compress`` /
    ``topk_frac`` / ``error_feedback``): what crosses the upstream is
    compressed inside ``aggregate`` when the backend hands in an active
    ``CompressionState`` (``comp``), which owns the EF residuals and the
    rounding noise. ``compress="none"`` (the default) leaves every code
    path untouched.
    """

    name: ClassVar[str] = "base"
    transport: ClassVar[str] = "sfl"   # what crosses the PON upstream

    server_lr: float = 1.0
    compress: str = "none"             # none | int8 | int4 | topk
    topk_frac: float = 0.01
    error_feedback: bool = False

    def compression_spec(self) -> CompressionSpec:
        return CompressionSpec(scheme=self.compress, topk_frac=self.topk_frac,
                               error_feedback=self.error_feedback)

    def init_state(self, params) -> Any:
        """Server-side optimizer state (None for plain FedAvg)."""
        return None

    def local_update(self, global_params, batches, loss_fn: Callable, fl):
        """One client's local training -> (delta leaves, mean loss)."""
        return fedavg.default_local_update(global_params, batches, loss_fn, fl)

    def aggregate(self, deltas, weights, mask, onu_ids, n_onus: int, *,
                  comp=None, client_ids=None) -> Tuple[Any, Stats]:
        return fedavg.aggregate(deltas, weights, mask, onu_ids, n_onus,
                                self.transport, comp=comp, client_ids=client_ids)

    def server_update(self, params, agg, state) -> Tuple[Any, Any]:
        return fedavg.server_apply(params, agg, self.server_lr), state


@dataclasses.dataclass(frozen=True)
class SflTwoStep(Strategy):
    """The paper's protocol: in-ONU weighted sum (θ), cross-PON reduce;
    one θ per active ONU crosses the PON (compressed by that ONU when the
    spec is active)."""

    name: ClassVar[str] = "sfl_two_step"
    transport: ClassVar[str] = "sfl"


@dataclasses.dataclass(frozen=True)
class Classical(Strategy):
    """Flat FedAvg benchmark: every involved client uploads its full model
    (its own δ compressed when the spec is active)."""

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


_WARNED_DROPPED: set = set()


def make_strategy(name: str, **kwargs) -> Strategy:
    """Instantiate a registered strategy by name or alias with its
    dataclass fields from ``kwargs``. Unknown keys are dropped, so one CLI
    can pass its full knob set to any strategy, but never silently: the
    first drop per strategy name warns, listing the keys."""
    name = canonical_name(name)
    cls = _REGISTRY[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    dropped = sorted(k for k in kwargs if k not in fields)
    if dropped and name not in _WARNED_DROPPED:
        _WARNED_DROPPED.add(name)
        warnings.warn(
            f"make_strategy({name!r}) dropped unknown kwargs {dropped} "
            f"(accepted: {sorted(fields)}); this warning fires once per "
            "strategy name", stacklevel=2)
    return cls(**{k: v for k, v in kwargs.items() if k in fields})


register_strategy("sfl_two_step", "sfl")(SflTwoStep)
register_strategy("classical")(Classical)
