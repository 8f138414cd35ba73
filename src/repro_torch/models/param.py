"""Parameter builder — the counterpart of ``repro.models.param.ParamBuilder``.

Parameters are plain nested dicts of tensors with the reference's names
and shapes. Every leaf is drawn from one explicit ``torch.Generator`` on
the target device and made there, leaf by leaf, so a full-width model
never passes through host memory. The init kinds are the reference's:
``normal`` with std ``scale/√shape[0]``, ``zeros``, ``ones``, ``uniform``
in [-scale, scale) and ``linspace`` over [-scale, scale].

A builder made with ``stack=n`` (the scanned layer unit) gives every leaf
a leading ``(n,)`` axis, drawn as the reference re-draws its stacked unit
leaves: a leaf of two or more dimensions whose type numpy counts as
floating is normal with std ``1/√shape[0]`` whatever its own kind (its
``scale`` is not used); any other leaf is its own init repeated ``n``
times. numpy does not count bfloat16 as floating, so in a bf16 model
every unit repeats the first one's weights — the reference's behaviour,
copied as it is (ROADMAP.md Queue 3). The draws differ from JAX's
(another generator), so the tests carry parameters across with
``repro_torch.bridge`` instead.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# the types the reference's stacked re-draw reaches (np.issubdtype(dtype,
# np.floating)); bfloat16 is not among them
_REDRAWN = (torch.float16, torch.float32, torch.float64)


class ParamBuilder:
    def __init__(self, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device | str, stack: Optional[int] = None):
        self.gen = gen
        self.dtype = dtype
        self.device = torch.device(device)
        self.stack = stack
        self.params: dict = {}

    def _draw(self, shape: Tuple[int, ...], init: str, scale: float) -> torch.Tensor:
        f32 = dict(dtype=torch.float32, device=self.device)
        if init == "normal":
            std = scale / math.sqrt(max(1, shape[0] if len(shape) else 1))
            return torch.randn(shape, generator=self.gen, **f32).mul_(std)
        if init == "zeros":
            return torch.zeros(shape, **f32)
        if init == "ones":
            return torch.ones(shape, **f32)
        if init == "uniform":
            return torch.rand(shape, generator=self.gen, **f32).mul_(2 * scale).sub_(scale)
        if init == "linspace":   # per-channel decay spread (rwkv / rglru)
            return torch.linspace(-scale, scale, math.prod(shape), **f32).reshape(shape)
        raise ValueError(init)

    def param(self, name: str, shape: Tuple[int, ...], init: str = "normal",
              scale: float = 1.0, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or self.dtype
        shape = tuple(shape)
        if self.stack is None:
            arr = self._draw(shape, init, scale)
        elif dtype in _REDRAWN and len(shape) >= 2:
            arr = torch.randn((self.stack,) + shape, generator=self.gen,
                              dtype=torch.float32, device=self.device)
            arr.mul_(1.0 / math.sqrt(max(1, shape[0])))
        else:
            arr = self._draw(shape, init, scale).expand((self.stack,) + shape)
        self.params[name] = arr.to(dtype).contiguous()
        return self.params[name]

    def sub(self, name: str) -> "ParamBuilder":
        child = ParamBuilder(self.gen, self.dtype, self.device, self.stack)
        self.params[name] = child.params
        return child

    def build(self) -> dict:
        return self.params
