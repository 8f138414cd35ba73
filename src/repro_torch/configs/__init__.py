"""Architecture registry of the port: ``get(name)`` returns a ModelConfig.

Only the paper's FEMNIST CNN is ported so far; the language-model configs
of ``repro.configs`` join when their models do.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.femnist_cnn import femnist_config

_REGISTRY = {"femnist_cnn": femnist_config}


def get(name: str) -> ModelConfig:
    key = name.replace("-", "_")
    if key not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[key]()
