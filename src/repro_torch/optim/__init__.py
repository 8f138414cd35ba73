"""repro_torch.optim: the reference's optimizers on PyTorch tensors."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw_init,
    adamw_update,
    cosine_lr,
    make_optimizer,
    sgd_init,
    sgd_update,
    tree_map,
    yogi_init,
    yogi_update,
)

__all__ = ["Optimizer", "adamw_init", "adamw_update", "cosine_lr", "make_optimizer",
           "sgd_init", "sgd_update", "tree_map", "yogi_init", "yogi_update"]
