"""Initial weights, drawn from the seed on the device in a few large calls
(one a leaf), in the type they are trained in, and laid out as the program
takes them: nested dicts of tensors with the port's leaf names and shapes.

The same call on the same device gives the same tensors, so the plain
reference draws its copy again after the program has run instead of the
harness holding one.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.inputs.seeds import derive
from portbench.work.models import cnn_leaf_shapes


def _normal(gen, shape, std: float, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(std)
    return x.to(dtype)


def cnn(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The CNN's leaves (conv weights OIHW) in f32; the conv and dense
    weights normal at the configuration's ``init_std``, the biases zero."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "cnn_weights"))
    std = cfg["init_std"]
    out = {}
    for name, shape in cnn_leaf_shapes(cfg).items():
        if name.endswith("_b"):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            out[name] = _normal(gen, shape, std[name], torch.float32, device)
    return out
