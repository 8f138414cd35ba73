"""SFL two-step aggregation — port of ``repro.core.aggregation``: the
client-stacked forms and the collective forms on ``torch.distributed``.

The paper's protocol (PON):
    step 1 (ONU):  θ_i = Σ_{j ∈ ONU_i} k_ij · w_ij      (in-ONU weighted sum)
    step 2 (CPS):  w_g = Σ_i θ_i / K,  K = Σ k_ij·mask   (cross-PON reduce)

Step 1 is the segmented ``agg_reduce`` kernel, one launch per leaf; the
classical FedAvg benchmark is the same kernel with a single segment. Step 2
is a plain ``torch.sum`` over the ONU axis, as the reference leaves it to
``jnp.sum`` outside any kernel. With wire compression
(:func:`compressed_segment_aggregate`) each ONU compresses its θ before the
PON upstream and step 2 reduces the decompressed θ̂.

The collective forms reduce per-rank values over a mesh (the gradient
regime; ``launch.mesh``): the ONUs are the pod-local "data" axis, the PON
upstream the cross-pod "pod" axis. Two-step is reduce-scatter over "data",
all-reduce over "pod" on the scattered shard, all-gather over "data", so
1/|data| of the model crosses the scarce hop; classical is the flat
all-reduce over ("pod", "data"). The cross-pod hop may travel as int8
(stochastic rounding through the quantize kernel's wrapper, one scale per
shard). ``mesh=None`` is one process: every collective is the identity.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.tree import flatten, unflatten
from repro_torch.core.compression import Noise, dequantize_rows, quantize_leaf, uniform_noise
from repro_torch.kernels.agg_reduce import agg_reduce, segment_agg_reduce
from repro_torch.launch.mesh import axes_group, mesh_shape

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


def hier_aggregate(client_tree: Tree, weights, mask, onu_ids, n_onus: int,
                   n_pons: int, comp=None):
    """The k-step hierarchical aggregation over a forest of ``n_pons`` PONs
    (global ONU ids PON-major, ``n_onus`` in all):

        θ_o = Σ_{j∈o} k·δ  →  Φ_p = Σ_{o∈p} θ_o  →  Ψ = Σ_p Φ_p  →  Ψ / K

    Every tier is the segmented ``agg_reduce``: θ over the clients (or,
    with an active ``comp``, its fused aggregate + quantize route), Φ over
    the θ rows with unit weights, Ψ over the Φ rows in one segment. With an
    active ``comp`` each tier compresses what it sends: θ by its ONU, Φ by
    its OLT, Ψ by the metro node, one noise call a tier in that order, as
    the reference's. Returns (aggregated leaves, K, (n_onus,) bool active
    ONUs, (n_pons,) bool active PONs)."""
    w, K = _folded(client_tree, weights, mask)
    onu_act = onu_active(onu_ids, mask, n_onus)
    pon_of_onu = np.arange(n_onus) // (n_onus // n_pons)
    pon_act = np.bincount(pon_of_onu, weights=onu_act, minlength=n_pons) > 0
    compressing = comp is not None and comp.active
    if compressing:
        thetas = comp.roundtrip_segments("theta", client_tree, w, onu_ids, n_onus,
                                         row_mask=onu_act)
    else:
        thetas = {k: segment_agg_reduce(x.reshape(x.shape[0], -1), w, onu_ids, n_onus)
                  .reshape((n_onus,) + tuple(x.shape[1:])) for k, x in client_tree.items()}

    def tier(rows: Tree, seg_ids, n_seg: int) -> Tree:
        ones = torch.ones(len(seg_ids), dtype=torch.float32, device=w.device)
        return {k: segment_agg_reduce(x.reshape(x.shape[0], -1), ones, seg_ids, n_seg)
                .reshape((n_seg,) + tuple(x.shape[1:])) for k, x in rows.items()}

    phis = tier(thetas, pon_of_onu, n_pons)
    if compressing:
        phis = comp.roundtrip("phi", phis, row_mask=pon_act)
    psi = tier(phis, np.zeros(n_pons, np.int64), 1)
    if compressing:
        psi = comp.roundtrip("psi", psi)
    agg = {k: x[0] / K.clamp_min(1e-9) for k, x in psi.items()}
    return agg, K, onu_act, pon_act


def classical_aggregate(client_tree: Tree, weights, mask):
    """FedAvg without the ONU step (benchmark): w_g = Σ k·mask·w / K."""
    weights, mask = _on_device(client_tree, weights, mask)
    K = (weights * mask).sum()
    agg = {k: (agg_reduce(x.reshape(x.shape[0], -1), weights, mask)
               .reshape(x.shape[1:]) / K.clamp_min(1e-9))
           for k, x in client_tree.items()}
    return agg, K


# ---------------------------------------------------------------------------
# collective forms (the scalable gradient regime): per-rank values over a mesh
# ---------------------------------------------------------------------------

# the tensor forms of all-gather and reduce-scatter (renamed in newer torch)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n,) -> (|group|, n): every peer's ``x``, in group-rank order."""
    if group is None:
        return x[None]
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.numel(),))
    _all_gather(out, x.contiguous().reshape(-1), group=group)
    return out.reshape((n,) + tuple(x.shape))


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """(|group|·n,) -> (n,): this rank's shard of the peers' sum."""
    if group is None:
        return x
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),))
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The peers' sum of ``x`` (a new contiguous tensor; ``x`` is left as it
    was: a gradient may come out of autograd with other strides)."""
    x = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _flatten_pad(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def _axis_group(mesh, axis: Optional[str]):
    """``axis``'s group; an axis the mesh lacks raises (an unbound axis
    name, as in the reference's shard_map). ``mesh=None``: no group."""
    if mesh is None or axis is None:
        return None
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"axis {axis!r} is not in the mesh {mesh.mesh_dim_names}")
    return axes_group(mesh, (axis,))


def int8_pod_sum(x: torch.Tensor, noise: torch.Tensor, pod_group) -> torch.Tensor:
    """Σ over pods of each pod's ``x`` sent as int8: stochastic rounding at
    one scale for the whole of ``x`` (the quantize kernel's one-row call),
    q and the scale all-gathered over "pod", then Σ_p float(q_p) · s_p.
    Every pod draws the same ``noise``, as the reference's replicated key."""
    q, s = quantize_leaf(x, noise, 8)
    q_all = all_gather(q.reshape(-1), pod_group)
    s_all = all_gather(s.reshape(1), pod_group).reshape(-1)
    return dequantize_rows(q_all, s_all).sum(0).reshape(x.shape)


def two_step_allreduce(tree, mesh, data_axis: str = "data", pod_axis: Optional[str] = "pod",
                       compress: Optional[str] = None, noise: Optional[Noise] = None):
    """Hierarchical sum of every rank's tree, in f32, leaves in the
    reference's order (sorted keys).

    reduce-scatter over ``data_axis`` (the ONU step), sum over
    ``pod_axis`` of the scattered shard (the CPS hop; None skips it),
    all-gather over ``data_axis``; each leaf flattened and zero-padded to a
    multiple of |data|. ``compress="int8"`` sends the cross-pod shard as
    int8 (:func:`int8_pod_sum`, one scale per shard) and then REQUIRES
    explicit ``noise`` (a ``torch.Generator`` seeded alike on every rank
    and fresh every call, or a ``uniform_noise(shapes)`` callable): the
    shard shapes are drawn in leaf order, as the reference splits its key.
    """
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', not {compress!r}")
    if compress == "int8" and noise is None:
        raise ValueError(
            "two_step_allreduce(compress='int8') requires explicit noise — pass a "
            "torch.Generator seeded per call (alike on every rank) or a uniform_noise "
            "callable, so the stochastic-rounding noise is fresh every call")
    data_g = _axis_group(mesh, data_axis)
    pod_g = _axis_group(mesh, pod_axis)
    n_data = mesh_shape(mesh).get(data_axis, 1)
    leaves = flatten(tree)
    noises = None
    if compress == "int8" and pod_axis is not None and leaves:
        noises = uniform_noise(noise, [(-(-x.numel() // n_data),) for x in leaves],
                               leaves[0].device)
    out = []
    for x in leaves:
        f, pad = _flatten_pad(x.float(), n_data)
        shard = reduce_scatter(f, data_g)
        if pod_axis is not None:
            shard = (int8_pod_sum(shard, next(noises), pod_g) if noises is not None
                     else all_reduce(shard, pod_g))
        full = all_gather(shard, data_g).reshape(-1)
        out.append((full[:-pad] if pad else full).reshape(x.shape))
    return unflatten(tree, out)


def classical_allreduce(tree, mesh, axes: Tuple[str, ...] = ("pod", "data")):
    """Flat all-reduce of every rank's tree over ``axes`` (those in the
    mesh), in f32: the paper's benchmark."""
    group = axes_group(mesh, axes)
    return unflatten(tree, [all_reduce(x.float(), group) for x in flatten(tree)])


def make_weighted_gradient_aggregator(mesh, mode: str = "two_step",
                                      compress: Optional[str] = None):
    """fn(local_grads, local_weight, noise=None) -> (mean_grads, K).

    local_grads: this rank's Σ_clients k·g (already weighted locally);
    local_weight: its Σ_local k·mask. K is the weights' sum over the client
    axes ("pod", "data" in the mesh) and the mean Σ / max(K, 1e-9).
    ``mode`` picks the schedule: two_step (the SFL schedule; without a
    "pod" axis its ONU step alone) or classical (the flat all-reduce).
    ``compress="int8"`` compresses two_step's cross-pod hop and needs
    ``noise`` each call.
    """
    if mode not in ("two_step", "classical"):
        raise ValueError(f"mode must be 'two_step' or 'classical', not {mode!r}")
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    has_pod = "pod" in names
    client_axes = tuple(a for a in ("pod", "data") if a in names)
    client_group = axes_group(mesh, client_axes)

    def agg(grads, weight, noise: Optional[Noise] = None):
        dev = flatten(grads)[0].device
        K = all_reduce(torch.as_tensor(weight, dtype=torch.float32, device=dev), client_group)
        if mode == "two_step" and has_pod:
            summed = two_step_allreduce(grads, mesh, "data", "pod", compress, noise)
        elif mode == "two_step":
            # single pod: the ONU step only (reduce-scatter + all-gather = all-reduce)
            summed = two_step_allreduce(grads, mesh, "data", None)
        else:
            summed = classical_allreduce(grads, mesh, client_axes)
        denom = K.clamp_min(1e-9)
        return unflatten(summed, [x / denom for x in flatten(summed)]), K

    return agg


def numpy_weighted_mean(stack: np.ndarray, weights: np.ndarray, mask: np.ndarray):
    """float64 oracle: (Σ_c w_c·m_c·x_c / K, K)."""
    w = (weights * mask).astype(np.float64)
    K = w.sum()
    return np.tensordot(w, stack.astype(np.float64), axes=(0, 0)) / max(K, 1e-9), K
