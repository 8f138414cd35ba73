"""Aggregation strategies — port of the ``repro.fl.strategy`` registry.

A Strategy owns the learning-side hooks of a round:

    local_update(global_params, batches, loss_fn, fl) -> (delta, loss)
    aggregate(deltas, weights, mask, onu_ids, n_onus,
              *, comp=None, client_ids=None)           -> (agg, stats)
    server_update(params, agg, state)                  -> (params, state)

plus ``transport`` ("sfl" | "classical" | "hier") — what crosses the PON
upstream, which the RoundLoop feeds to the transport model. Registered,
each with the wire-compression axis:

  * ``sfl_two_step`` (alias ``sfl``) — the paper's two-step aggregation;
  * ``classical``    — the flat FedAvg benchmark;
  * ``fedprox``      — proximal local objective (Li et al. 2020) over the
    SFL transport; ``mu=0`` reduces exactly to ``sfl_two_step``;
  * ``fedopt``       — a server optimizer (adamw, yogi, sgd, sgdm; Reddi
    et al. 2021) on the pseudo-gradient −Δ in place of the plain apply;
  * ``hier_sfl`` (alias ``hier``) — k-step aggregation over a multi-PON
    forest (ONU → OLT → metro → server, DESIGN.md §12), composing the
    fedprox local term (``mu``) and the fedopt server step
    (``server_opt``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import aggregation, fedavg
from repro_torch.core.compression import CompressionSpec
from repro_torch.optim import make_optimizer

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


@dataclasses.dataclass(frozen=True)
class FedProx(SflTwoStep):
    """Proximal local term μ/2·‖w − w_g‖² (client-drift control)."""

    name: ClassVar[str] = "fedprox"

    mu: float = 0.01

    def local_update(self, global_params, batches, loss_fn: Callable, fl):
        p, loss = fedavg.local_sgd_prox(global_params, batches, loss_fn, fl.local_lr,
                                        fl.local_steps, self.mu, global_params)
        return {k: p[k] - global_params[k] for k in p}, loss


@dataclasses.dataclass(frozen=True)
class FedOpt(SflTwoStep):
    """Adaptive server optimizer on the pseudo-gradient −Δ (FedAdam/FedYogi):
    the aggregated client delta is the negative server gradient, and the
    port's optimizer (``optim.make_optimizer``) replaces the plain apply."""

    name: ClassVar[str] = "fedopt"

    server_opt: str = "adamw"
    server_lr: float = 0.03

    def init_state(self, params):
        return make_optimizer(self.server_opt).init(params)

    def server_update(self, params, agg, state):
        pseudo_grad = {k: -d for k, d in agg.items()}
        return make_optimizer(self.server_opt).update(params, pseudo_grad, state,
                                                      self.server_lr)


@dataclasses.dataclass(frozen=True)
class HierSfl(SflTwoStep):
    """k-step hierarchical aggregation over a forest of PONs (DESIGN.md §12):

        ONU partial-agg (θ_o = Σ_{j∈o} k·Δ)  →  OLT agg (Φ_p = Σ_{o∈p} θ_o)
        →  metro agg (Ψ = Σ_p Φ_p)           →  server:  w += Ψ / K

    The weighted sum is associative, so the result is the same weighted
    mean; what changes is the transport (``transport='hier'``): one Φ per
    PON crosses the metro segment and one Ψ the trunk. With ``n_pons=1``
    the aggregate and the transport are exactly ``sfl_two_step``'s.

    Composes with the other strategies by delegating to them: ``mu > 0``
    takes :class:`FedProx`'s local update, ``server_opt`` :class:`FedOpt`'s
    server step; both off is plain FedAvg. ``server_lr=None`` means the
    composed strategy's own default: 1.0 for the plain apply, FedOpt's 0.03
    when ``server_opt`` is set.
    """

    name: ClassVar[str] = "hier_sfl"
    transport: ClassVar[str] = "hier"

    server_lr: Optional[float] = None    # None → composed default
    n_pons: int = 1
    mu: float = 0.0                      # > 0: FedProx proximal local term
    server_opt: Optional[str] = None     # e.g. "adamw"/"yogi": FedOpt server

    def _fedopt(self) -> FedOpt:
        kw = {} if self.server_lr is None else {"server_lr": self.server_lr}
        return FedOpt(server_opt=self.server_opt, **kw)

    def local_update(self, global_params, batches, loss_fn: Callable, fl):
        if self.mu <= 0.0:
            return super().local_update(global_params, batches, loss_fn, fl)
        return FedProx(mu=self.mu).local_update(global_params, batches, loss_fn, fl)

    def init_state(self, params):
        if self.server_opt is None:
            return None
        return self._fedopt().init_state(params)

    def server_update(self, params, agg, state):
        if self.server_opt is not None:
            return self._fedopt().server_update(params, agg, state)
        lr = 1.0 if self.server_lr is None else self.server_lr
        return fedavg.server_apply(params, agg, lr), state

    def aggregate(self, deltas, weights, mask, onu_ids, n_onus: int, *,
                  comp=None, client_ids=None):
        if self.n_pons <= 1:
            # degenerate forest: exactly the two-step aggregation
            return fedavg.aggregate(deltas, weights, mask, onu_ids, n_onus, "sfl",
                                    comp=comp, client_ids=client_ids)
        if n_onus % self.n_pons:
            raise ValueError(
                f"hier_sfl: total ONU count {n_onus} is not divisible by "
                f"n_pons={self.n_pons} — pass the forest's total_onus")
        agg, K, onu_act, pon_act = aggregation.hier_aggregate(
            deltas, weights, mask, onu_ids, n_onus, self.n_pons, comp=comp)
        return agg, {"K": K, "uplink_models": float(onu_act.sum()),
                     "metro_models": float(pon_act.sum()),
                     "involved": float(np.asarray(mask, np.float32).sum())}


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
register_strategy("fedprox")(FedProx)
register_strategy("fedopt")(FedOpt)
register_strategy("hier_sfl", "hier")(HierSfl)
