"""Parameter bridge between the JAX reference's layout and the port's.

The reference holds conv weights HWIO (it convolves NHWC activations);
the port holds them OIHW for ``torch.nn.functional.conv2d``. Every other
leaf has the same layout in both, ``fc1_w`` included: the port flattens
in the reference's (H, W, C) order (see ``models/femnist_cnn.py``).
Arrays cross as numpy, so this module needs neither framework's runtime
state; a 4-D leaf is a conv weight.

The language models' trees (parameters, caches and optimizer states,
nested dicts) have the same layout in both packages, so
``lm_params_from_jax`` and ``lm_params_to_jax`` copy leaf by leaf, 0-d
leaves such as AdamW's int32 step included. bfloat16 crosses as its bits:
numpy holds it as ``ml_dtypes.bfloat16`` (JAX's own numpy type), which
``lm_params_to_jax`` imports only when it meets a bfloat16 tensor.
"""
from __future__ import annotations

from typing import Any, Dict

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


def _leaf_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a).copy(order="C")   # keeps a 0-d leaf (an optimizer's step) 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def lm_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A nested dict of reference-layout numpy arrays (parameters or a
    cache) -> the same tree of CPU tensors (copies, dtypes kept)."""
    return {k: lm_params_from_jax(v) if isinstance(v, dict) else _leaf_from_numpy(v)
            for k, v in tree.items()}


def lm_params_to_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's nested dict of tensors (any device) -> numpy arrays in
    the reference's layout (bfloat16 as ``ml_dtypes.bfloat16``)."""
    return {k: lm_params_to_jax(v) if isinstance(v, dict) else _leaf_to_numpy(v)
            for k, v in tree.items()}
