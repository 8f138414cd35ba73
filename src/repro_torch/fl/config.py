"""ExperimentConfig — one object that specifies a federated run (port of
``repro.fl.config``): the FL topology and learning knobs (``FLConfig``,
which carries the PON transport), the strategy with its kwargs, the
over-selection backups, the synthetic failures and the event-driven
runtime's policy knobs. Buildable from one shared argparse helper
(``add_experiment_cli_args`` / ``experiment_config_from_args``), so the
entry points expose the reference's flag set."""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.core.fedavg import FLConfig
from repro_torch.fl.strategy import Strategy, canonical_name, make_strategy, strategy_names
from repro_torch.pon import add_pon_cli_args, pon_config_from_args
from repro_torch.runtime.failures import FailureModel

# reference flags whose machinery the port does not have yet, with the
# ROADMAP.md item that ports it; parsed so that they are refused by name
REFUSED_FLAGS = {"trace_out": "Queue 1 item 5 (repro.obs)",
                 "metrics_out": "Queue 1 item 5 (repro.obs)"}


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
    # event-driven runtime (runtime.Orchestrator); the RoundLoop ignores them
    policy: str = "sync"              # sync | semi_sync | fedbuff
    round_window_s: Optional[float] = None  # aggregation window (default:
                                            # the PON deadline)
    buffer_k: int = 8                 # fedbuff: server update every K arrivals
    concurrency: int = 0              # fedbuff in-flight clients (0: n_selected)
    staleness_exponent: float = 0.5   # weight ∝ (1+τ)^-α (FedBuff's 1/√(1+τ))
    onu_gather_s: float = 1.0         # async SFL: ONU θ gather window (s)

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


def add_experiment_cli_args(ap, strategy_default: str = "sfl_two_step") -> None:
    """Attach the reference's federated-experiment flag set to a parser:
    the PON transport flags (``pon.add_pon_cli_args``), the strategy,
    selection, failure and compression knobs and the runtime's policy
    knobs. ``--trace-out`` and ``--metrics-out`` are parsed and refused by
    :func:`refuse_unported_flags`."""
    add_pon_cli_args(ap)
    for name in REFUSED_FLAGS:
        ap.add_argument("--" + name.replace("_", "-"), default=None, help=argparse.SUPPRESS)
    g = ap.add_argument_group("federated experiment (repro_torch.fl)")
    g.add_argument("--strategy", default=strategy_default,
                   help=f"aggregation strategy: {'|'.join(strategy_names())} "
                        "(aliases: sfl, hier)")
    g.add_argument("--overselect", type=float, default=0.0,
                   help="extra backup clients per round, fraction of N")
    g.add_argument("--p-crash", type=float, default=0.0,
                   help="per-round client crash probability (FailureModel)")
    g.add_argument("--p-transient", type=float, default=0.0,
                   help="per-round transient-failure probability (FailureModel)")
    g.add_argument("--mean-recovery-rounds", type=float, default=3.0,
                   help="mean rounds a crashed client stays down (FailureModel)")
    g.add_argument("--failure-seed", type=int, default=None,
                   help="FailureModel RNG seed (default: seed + 1)")
    add_strategy_cli_args(g)
    g.add_argument("--compress", default="none",
                   choices=["none", "int8", "int4", "topk"],
                   help="wire compression for every transport tier "
                        "(θ/Φ/Ψ or client uploads): stochastic-rounding "
                        "int8/int4 or magnitude top-k")
    g.add_argument("--topk-frac", type=float, default=0.01,
                   help="top-k: fraction of elements kept per leaf "
                        "(wire bills value+index per kept element)")
    g.add_argument("--error-feedback", action="store_true",
                   help="carry the compression residual into the next round "
                        "(EF-SGD; per-tier for sfl/hier, per-client for classical)")
    r = ap.add_argument_group("event-driven runtime (repro_torch.runtime)")
    r.add_argument("--policy", default="sync",
                   help="aggregation policy for the Orchestrator driver: "
                        "sync|semi_sync|fedbuff (alias: async)")
    r.add_argument("--window-s", type=float, default=None,
                   help="aggregation window seconds (default: PON deadline)")
    r.add_argument("--buffer-k", type=int, default=8,
                   help="fedbuff: apply a server update every K arrivals")
    r.add_argument("--concurrency", type=int, default=0,
                   help="fedbuff: clients kept in flight (0: n_selected)")
    r.add_argument("--staleness-exp", type=float, default=0.5,
                   help="staleness discount α: weight ∝ (1+τ)^-α")
    r.add_argument("--onu-gather-s", type=float, default=1.0,
                   help="async SFL: seconds an ONU gathers arrivals "
                        "before emitting one θ")


def refuse_unported_flags(ap, args) -> None:
    """``ap.error`` naming the ROADMAP.md item of the first refused flag set."""
    for name, item in REFUSED_FLAGS.items():
        if getattr(args, name, None) is not None:
            ap.error(f"--{name.replace('_', '-')} is not ported yet: ROADMAP.md {item}")


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


def experiment_config_from_args(args, **overrides) -> ExperimentConfig:
    """Build the ExperimentConfig selected by ``add_experiment_cli_args``.

    ``overrides`` replace top-level ExperimentConfig fields (n_rounds, seed,
    …); tune the nested FLConfig afterwards via ``cfg.with_fl(...)``.
    """
    pon = pon_config_from_args(args)
    fl = FLConfig(n_onus=pon.n_onus, clients_per_onu=pon.clients_per_onu,
                  n_pons=pon.n_pons, pon=pon)
    name = canonical_name(args.strategy)
    skw = filter_strategy_kwargs(name, strategy_kwargs_from_args(args))
    return ExperimentConfig(
        fl=fl, strategy=name, strategy_kwargs=tuple(sorted(skw.items())),
        overselect=args.overselect, p_crash=args.p_crash,
        p_transient=args.p_transient,
        mean_recovery_rounds=getattr(args, "mean_recovery_rounds", 3.0),
        failure_seed=getattr(args, "failure_seed", None),
        seed=getattr(args, "seed", 0),
        policy=getattr(args, "policy", "sync"),
        round_window_s=getattr(args, "window_s", None),
        buffer_k=getattr(args, "buffer_k", 8),
        concurrency=getattr(args, "concurrency", 0),
        staleness_exponent=getattr(args, "staleness_exp", 0.5),
        onu_gather_s=getattr(args, "onu_gather_s", 1.0),
        **overrides)
