"""The port's models — the counterpart of ``repro.models``' package API.

``init_params(cfg, generator=None, device=...)`` and ``loss_fn(params,
batch, cfg)`` dispatch on ``cfg.family`` to ``femnist_cnn`` (the paper's
CNN, family "cnn") or ``transformer`` (every language model), as the
reference's do. Where the reference returns ``(params, logical axes)``,
``init_params`` returns the parameters alone, as the port's model modules
do (``transformer.abstract_params`` gives the axes); its
``abstract=True`` is ``device="meta"`` (shapes and dtypes; a language
model's allocate nothing). The port's loss takes no sharding ``rules``:
the parameters' layout over a mesh (FSDP's shards or full replicas) and
the gradients' reduce schedule live in ``launch.specs.make_train_step``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import femnist_cnn, transformer
from repro_torch.models.config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                                       TRAIN_4K, ModelConfig, ShapeConfig, shape_by_name)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: str | torch.device = "cuda", tp: int = 16) -> Dict[str, Any]:
    """Random parameters of ``cfg`` from ``generator`` (seed 0 by default)
    on ``device``; ``"meta"`` gives their shapes alone. ``tp`` is the
    transformer's tensor-parallel padding, as the reference's."""
    meta = torch.device(device).type == "meta"
    if cfg.family == "cnn":
        if meta:
            return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in femnist_cnn.init_params(cfg, generator, "cpu").items()}
        return femnist_cnn.init_params(cfg, generator, device)
    if meta:
        return transformer.abstract_params(cfg, tp)[0]
    return transformer.init_params(cfg, generator, device, tp)


def loss_fn(params, batch, cfg: ModelConfig):
    """(scalar loss, metrics): the CNN's masked cross-entropy and accuracy,
    or the language model's chunked cross-entropy (plus the router's
    load-balance term with experts)."""
    if cfg.family == "cnn":
        return femnist_cnn.loss_fn(params, batch)
    return transformer.loss_fn(params, batch, cfg)


__all__ = [
    "ModelConfig", "ShapeConfig", "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "shape_by_name", "init_params", "loss_fn",
    "transformer", "femnist_cnn",
]
