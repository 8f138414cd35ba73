from repro_torch.pon.timing import (
    MODEL_UPDATE_MBITS,
    PonConfig,
    round_times,
    train_times,
)

__all__ = ["MODEL_UPDATE_MBITS", "PonConfig", "round_times", "train_times"]
