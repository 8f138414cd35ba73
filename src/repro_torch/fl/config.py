"""ExperimentConfig — one object that specifies a federated run (port of
``repro.fl.config``, with the fields this slice's drivers use)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.fedavg import FLConfig
from repro_torch.fl.strategy import canonical_name
from repro_torch.runtime.failures import FailureModel


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    fl: FLConfig = FLConfig()
    # fault tolerance: extra backup clients per round (fraction of N) and
    # the synthetic crash/transient failure injector
    overselect: float = 0.0
    p_crash: float = 0.0
    p_transient: float = 0.0
    mean_recovery_rounds: float = 3.0
    failure_seed: Optional[int] = None    # default: seed + 1
    n_rounds: int = 30                    # repro: noqa(REPRO501) driver-owned
    seed: int = 0

    def with_fl(self, **kw) -> "ExperimentConfig":
        """Replace fields of the nested FLConfig."""
        return dataclasses.replace(self, fl=dataclasses.replace(self.fl, **kw))

    def make_failure_model(self) -> Optional[FailureModel]:
        if self.p_crash <= 0.0 and self.p_transient <= 0.0:
            return None
        seed = self.failure_seed if self.failure_seed is not None else self.seed + 1
        return FailureModel(p_crash=self.p_crash, p_transient=self.p_transient,
                            mean_recovery_rounds=self.mean_recovery_rounds,
                            seed=seed)


def comparison_modes(strategy: str) -> list:
    """The strategies a comparison run trains: the classical baseline plus
    the requested strategy (deduplicated)."""
    name = canonical_name(strategy)
    return ["classical"] + ([name] if name != "classical" else [])
