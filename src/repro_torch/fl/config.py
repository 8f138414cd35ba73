"""ExperimentConfig — one object that specifies a federated run (port of
``repro.fl.config``): the FL topology and learning knobs (``FLConfig``,
which carries the PON transport), the strategy with its kwargs, the
over-selection backups and the synthetic failures. The runtime's fields
and flags come with the runtime (ROADMAP.md Queue 1 item 4)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.core.fedavg import FLConfig
from repro_torch.fl.strategy import Strategy, canonical_name, make_strategy
from repro_torch.runtime.failures import FailureModel


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    fl: FLConfig = FLConfig()
    strategy: str = "sfl_two_step"
    # kwargs for the strategy constructor, as a tuple of (key, value) pairs
    # so the config stays hashable; ``with_strategy`` sets them from a dict
    strategy_kwargs: Tuple[Tuple[str, Any], ...] = ()
    # fault tolerance: extra backup clients per round (fraction of N) and
    # the synthetic crash/transient failure injector
    overselect: float = 0.0
    p_crash: float = 0.0
    p_transient: float = 0.0
    mean_recovery_rounds: float = 3.0
    failure_seed: Optional[int] = None    # default: seed + 1
    n_rounds: int = 30                    # repro: noqa(REPRO501) driver-owned
    seed: int = 0

    def make_strategy(self) -> Strategy:
        return make_strategy(self.strategy, **dict(self.strategy_kwargs))

    def with_fl(self, **kw) -> "ExperimentConfig":
        """Replace fields of the nested FLConfig."""
        return dataclasses.replace(self, fl=dataclasses.replace(self.fl, **kw))

    def with_strategy(self, name: str, **kwargs) -> "ExperimentConfig":
        return dataclasses.replace(self, strategy=name,
                                   strategy_kwargs=tuple(sorted(kwargs.items())))

    def make_failure_model(self) -> Optional[FailureModel]:
        if self.p_crash <= 0.0 and self.p_transient <= 0.0:
            return None
        seed = self.failure_seed if self.failure_seed is not None else self.seed + 1
        return FailureModel(p_crash=self.p_crash, p_transient=self.p_transient,
                            mean_recovery_rounds=self.mean_recovery_rounds,
                            seed=seed)


def add_strategy_cli_args(ap) -> None:
    """The strategy knobs of the reference's shared flag set
    (``--fedprox-mu``, ``--server-opt``, ``--server-lr``). Their defaults
    are None on purpose: the strategy's own dataclass defaults rule, so a
    concrete CLI default cannot turn on hier_sfl's proximal or adaptive
    composition."""
    ap.add_argument("--fedprox-mu", type=float, default=None,
                    help="fedprox proximal coefficient mu (default: the "
                         "strategy's own; >0 on hier_sfl turns the proximal "
                         "term on)")
    ap.add_argument("--server-opt", default=None,
                    help="fedopt server optimizer: adamw|yogi|sgd|sgdm "
                         "(default: the strategy's own; set on hier_sfl to "
                         "turn the adaptive server step on)")
    ap.add_argument("--server-lr", type=float, default=None,
                    help="fedopt server learning rate (default: strategy's)")


def strategy_kwargs_from_args(args) -> dict:
    """The raw strategy-knob dict carried by the shared flag set. Pair with
    :func:`filter_strategy_kwargs` before instantiating a strategy."""
    return {"mu": args.fedprox_mu, "server_opt": args.server_opt,
            "server_lr": args.server_lr,
            "n_pons": getattr(args, "n_pons", 1),
            "compress": getattr(args, "compress", "none"),
            "topk_frac": getattr(args, "topk_frac", 0.01),
            "error_feedback": getattr(args, "error_feedback", False)}


def comparison_modes(strategy: str) -> list:
    """The strategies a comparison run trains: the classical baseline plus
    the requested strategy (deduplicated)."""
    name = canonical_name(strategy)
    return ["classical"] + ([name] if name != "classical" else [])


def filter_strategy_kwargs(name: str, kwargs) -> dict:
    """Restrict a shared CLI kwargs dict to the knobs ``name`` consumes, so
    a baseline in the same run does not absorb another strategy's (e.g.
    classical inheriting fedopt's --server-lr). The compression axis lives
    on the base Strategy and passes to every strategy."""
    name = canonical_name(name)
    kwargs = dict(kwargs or {})
    out = {}
    if name == "fedprox" and kwargs.get("mu") is not None:
        out["mu"] = kwargs["mu"]
    if name in ("fedopt", "hier_sfl"):
        if kwargs.get("server_opt") is not None:
            out["server_opt"] = kwargs["server_opt"]
        if kwargs.get("server_lr") is not None:
            out["server_lr"] = kwargs["server_lr"]
    if name == "hier_sfl":
        if kwargs.get("n_pons") is not None:
            out["n_pons"] = kwargs["n_pons"]
        if kwargs.get("mu") is not None:
            out["mu"] = kwargs["mu"]
    if kwargs.get("compress", "none") != "none":
        out["compress"] = kwargs["compress"]
        if kwargs.get("topk_frac") is not None:
            out["topk_frac"] = kwargs["topk_frac"]
        if kwargs.get("error_feedback"):
            out["error_feedback"] = True
    return out
