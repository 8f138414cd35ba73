"""repro_torch.fl: strategy registry, RoundLoop driver, client-stacked and
gradient backends."""
from repro_torch.fl.strategy import (
    Classical,
    SflTwoStep,
    Strategy,
    canonical_name,
    make_strategy,
    register_strategy,
    strategy_names,
)
from repro_torch.fl.config import ExperimentConfig, comparison_modes
from repro_torch.fl.backends import ClientStackedBackend, GradientBackend
from repro_torch.fl.loop import History, RoundLoop, sync_round

__all__ = [
    "Classical", "SflTwoStep", "Strategy", "canonical_name", "make_strategy",
    "register_strategy", "strategy_names", "ExperimentConfig",
    "comparison_modes", "ClientStackedBackend", "GradientBackend", "History", "RoundLoop",
    "sync_round",
]
