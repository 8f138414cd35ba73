"""repro_torch.fl: strategy registry, RoundLoop driver, client-stacked,
gradient and transport-only backends."""
from repro_torch.fl.strategy import (
    Classical,
    FedOpt,
    FedProx,
    HierSfl,
    SflTwoStep,
    Strategy,
    canonical_name,
    make_strategy,
    register_strategy,
    strategy_names,
)
from repro_torch.fl.config import (
    ExperimentConfig,
    add_strategy_cli_args,
    comparison_modes,
    filter_strategy_kwargs,
    strategy_kwargs_from_args,
)
from repro_torch.fl.backends import ClientStackedBackend, GradientBackend, TransportBackend
from repro_torch.fl.loop import History, RoundLoop, sync_round

__all__ = [
    "Classical", "FedOpt", "FedProx", "HierSfl", "SflTwoStep", "Strategy",
    "canonical_name", "make_strategy", "register_strategy", "strategy_names",
    "ExperimentConfig", "add_strategy_cli_args", "comparison_modes",
    "filter_strategy_kwargs", "strategy_kwargs_from_args", "ClientStackedBackend",
    "GradientBackend", "TransportBackend", "History", "RoundLoop", "sync_round",
]
