"""SFL two-step aggregation over client-stacked tensors — port of the
client-stacked half of ``repro.core.aggregation``.

The paper's protocol (PON):
    step 1 (ONU):  θ_i = Σ_{j ∈ ONU_i} k_ij · w_ij      (in-ONU weighted sum)
    step 2 (CPS):  w_g = Σ_i θ_i / K,  K = Σ k_ij·mask   (cross-PON reduce)

Step 1 is the segmented ``agg_reduce`` kernel, one launch per leaf; the
classical FedAvg benchmark is the same kernel with a single segment. Step 2
is a plain ``torch.sum`` over the ONU axis, as the reference leaves it to
``jnp.sum`` outside any kernel. With wire compression
(:func:`compressed_segment_aggregate`) each ONU compresses its θ before the
PON upstream and step 2 reduces the decompressed θ̂. The collective forms
(shard_map all-reduces) belong to the language-model slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.agg_reduce import agg_reduce, segment_agg_reduce

Tree = Dict[str, torch.Tensor]


def _on_device(client_tree: Tree, weights, mask):
    dev = next(iter(client_tree.values())).device
    return (torch.as_tensor(weights, dtype=torch.float32, device=dev),
            torch.as_tensor(mask, dtype=torch.float32, device=dev))


def _folded(client_tree: Tree, weights, mask):
    """(wm = weight · mask on the leaves' device, K = Σ wm)."""
    weights, mask = _on_device(client_tree, weights, mask)
    w = (weights * mask).contiguous()
    return w, w.sum()


def segment_aggregate(client_tree: Tree, weights, mask, onu_ids, n_onus: int):
    """Exactly the paper's two-step aggregation over client-stacked leaves.

    client_tree: leaves with leading client axis C (local model deltas)
    weights:     (C,) sample counts k_ij
    mask:        (C,) 1.0 = involved (selected & met the deadline)
    onu_ids:     (C,) ints, host side — which ONU each client hangs off
    Returns (aggregated leaves, per-ONU θ leaves (n_onus leading), K).
    """
    w, K = _folded(client_tree, weights, mask)
    thetas = {}
    for name, x in client_tree.items():
        C = x.shape[0]
        theta = segment_agg_reduce(x.reshape(C, -1), w, onu_ids, n_onus)  # step 1
        thetas[name] = theta.reshape((n_onus,) + tuple(x.shape[1:]))
    agg = {k: th.sum(0) / K.clamp_min(1e-9) for k, th in thetas.items()}  # step 2
    return agg, thetas, K


def onu_active(onu_ids, mask, n_onus: int) -> np.ndarray:
    """(n_onus,) bool: ONUs with an involved client, each of which sends
    one θ up the PON."""
    return np.bincount(np.asarray(onu_ids), weights=np.asarray(mask, np.float64),
                       minlength=n_onus) > 0


def compressed_segment_aggregate(client_tree: Tree, weights, mask, onu_ids,
                                 n_onus: int, comp):
    """The two-step aggregation with a compressed PON upstream: each ONU
    compresses its θ (``comp``, a ``CompressionState``, which also owns the
    EF residuals); the CPS reduces the decompressed θ̂, and silent ONUs
    transmit nothing. Returns (aggregated leaves, θ̂ leaves, K)."""
    w, K = _folded(client_tree, weights, mask)
    thetas = comp.roundtrip_segments("theta", client_tree, w, onu_ids, n_onus,
                                     row_mask=onu_active(onu_ids, mask, n_onus))
    agg = {k: th.sum(0) / K.clamp_min(1e-9) for k, th in thetas.items()}
    return agg, thetas, K


def classical_aggregate(client_tree: Tree, weights, mask):
    """FedAvg without the ONU step (benchmark): w_g = Σ k·mask·w / K."""
    weights, mask = _on_device(client_tree, weights, mask)
    K = (weights * mask).sum()
    agg = {k: (agg_reduce(x.reshape(x.shape[0], -1), weights, mask)
               .reshape(x.shape[1:]) / K.clamp_min(1e-9))
           for k, x in client_tree.items()}
    return agg, K


def numpy_weighted_mean(stack: np.ndarray, weights: np.ndarray, mask: np.ndarray):
    """float64 oracle: (Σ_c w_c·m_c·x_c / K, K)."""
    w = (weights * mask).astype(np.float64)
    K = w.sum()
    return np.tensordot(w, stack.astype(np.float64), axes=(0, 0)) / max(K, 1e-9), K
