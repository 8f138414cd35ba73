"""The U[0, 1) noise of the compressed uplink's stochastic rounding.

The harness hands the program this noise (a ``CompressionState``'s
``uniform_noise``, the method it documents for feeding other noise) and
the reference the same: call number ``call`` of a run draws one tensor a
leaf shape, in the order given, from its own generator on the device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from portbench.inputs.seeds import derive


def uniform(seed: int, call: int, shapes: Sequence[Tuple[int, ...]], device
            ) -> List[torch.Tensor]:
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(derive(seed, f"noise.{call}"))
    return [torch.rand(tuple(s), generator=gen, dtype=torch.float32, device=device)
            for s in shapes]
