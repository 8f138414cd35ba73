"""Parameter bridge between the JAX reference's layout and the port's.

The reference holds conv weights HWIO (it convolves NHWC activations);
the port holds them OIHW for ``torch.nn.functional.conv2d``. Every other
leaf has the same layout in both, ``fc1_w`` included: the port flattens
in the reference's (H, W, C) order (see ``models/femnist_cnn.py``).
Arrays cross as numpy, so this module needs neither framework's runtime
state; a 4-D leaf is a conv weight.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def params_from_jax(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Reference-layout arrays -> port-layout CPU tensors (copies)."""
    out = {}
    for name, arr in params.items():
        a = np.asarray(arr)
        if a.ndim == 4:
            a = np.transpose(a, _HWIO_TO_OIHW)
        out[name] = torch.from_numpy(np.ascontiguousarray(a).copy())
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port-layout tensors (any device) -> reference-layout numpy arrays."""
    out = {}
    for name, t in params.items():
        a = t.detach().cpu().numpy()
        if a.ndim == 4:
            a = np.transpose(a, _OIHW_TO_HWIO)
        out[name] = np.ascontiguousarray(a)
    return out
