"""Faithful FedAvg / SFL round engine (client-stacked, H local steps) —
port of ``repro.core.fedavg``.

Every selected client holds its own model copy, runs H local SGD steps on
its own (non-IID) data, and the round ends with the two-step aggregation
(``segment_aggregate``) under the PON simulator's participation mask.
The reference's chunked ``jax.vmap`` over clients becomes
``torch.func.vmap`` of a per-client update built on ``torch.func``'s
``grad_and_value``, ``client_chunk`` clients at a time.

These are the primitives; experiments run through ``repro_torch.fl``
(strategy registry + RoundLoop), whose ``sfl_two_step``/``classical``
strategies call :func:`aggregate` and :func:`server_apply` with their
transport, as :func:`apply_round` does with ``mode``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import aggregation
from repro_torch.obs import profile
from repro_torch.pon import PonConfig, round_times

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_onus: int = 16                # ONUs per PON tree
    clients_per_onu: int = 20
    n_pons: int = 1                 # PON trees (the metro forest, pon.metro)
    n_selected: int = 48            # N in the paper (48 / 128 in Fig. 2)
    local_steps: int = 5            # H: minibatch SGD steps per round
    local_batch: int = 10           # LEAF defaults
    local_lr: float = 0.06
    mode: str = "sfl"               # unread (a Strategy's transport rules);
                                    # the reference's field, so configs hash alike
    sync_threshold_s: float = 25.0  # the paper's deadline
    seed: int = 0                   # unread (ExperimentConfig.seed rules), as mode
    client_chunk: int = 16          # vmap chunking (device-memory bound)
    # transport: None = the paper's fixed-slice defaults. FLConfig stays the
    # single source of truth for the FL topology and deadline — those
    # fields of an explicit ``pon`` are overridden (see pon_config)
    pon: Optional[PonConfig] = None

    @property
    def n_clients(self) -> int:
        """Total population across the PON forest."""
        return self.n_pons * self.n_onus * self.clients_per_onu

    @property
    def total_onus(self) -> int:
        """ONUs across all PON trees — the segment count for aggregation."""
        return self.n_pons * self.n_onus

    def pon_config(self) -> PonConfig:
        """The PON transport config: transport knobs (dba, wavelengths,
        traffic, rates, engine) from ``self.pon``; the topology (n_pons,
        n_onus, clients_per_onu) and the deadline always from this
        FLConfig, so the client→ONU map the simulator is handed cannot
        disagree with the simulated tree."""
        base = self.pon if self.pon is not None else PonConfig()
        return dataclasses.replace(base, n_onus=self.n_onus,
                                   clients_per_onu=self.clients_per_onu,
                                   n_pons=self.n_pons,
                                   sync_threshold_s=self.sync_threshold_s)


def onu_of_client(fl: FLConfig) -> np.ndarray:
    """Static topology: client c hangs off GLOBAL ONU c // clients_per_onu
    (PON-major numbering — ids run across the whole forest)."""
    return np.arange(fl.n_clients) // fl.clients_per_onu


def round_transport(fl: FLConfig, rng: np.random.Generator,
                    selected: np.ndarray, sample_counts: np.ndarray,
                    onu_ids: Optional[np.ndarray] = None, *,
                    mode: str, wire_scale: Optional[float] = None,
                    obs=None) -> Dict[str, Any]:
    """One round of the PON transport under ``fl``'s config; ``mode`` is
    what crosses the upstream ("sfl" | "classical" | "hier", a Strategy's
    ``transport``). The mask ``apply_round`` expects is ``["involved"]``.

    ``wire_scale`` (compressed ÷ raw payload) scales ``model_mbits``: the
    compressed payload is what rides the wire, so the deadline physics and
    the Mbits billed both see it, and ``["wire_mbits"]`` records the
    per-model wire size. None (no compression) leaves the round untouched.
    ``obs`` (a ``repro_torch.obs.Obs``; default the ambient one) takes the
    transport's metrics and spans.
    """
    if onu_ids is None:
        onu_ids = onu_of_client(fl)
    pon = fl.pon_config()
    if wire_scale is not None:
        pon = dataclasses.replace(pon, model_mbits=pon.model_mbits * wire_scale)
    rt = round_times(pon, rng, selected, onu_ids, sample_counts, mode, obs=obs)
    if wire_scale is not None:
        rt["wire_mbits"] = pon.model_mbits
    return rt


def _ranged_grad(loss_fn: Callable) -> Callable:
    """``grad_and_value`` of ``loss_fn`` with the loss's forward in an
    ``fl.forward`` profiler range (under a vmap, one range a chunk)."""
    def forward(p, batch):
        with profile.named_scope("fl.forward"):
            return loss_fn(p, batch)
    return grad_and_value(forward, has_aux=True)


def local_sgd(params: Params, batches: Dict[str, torch.Tensor],
              loss_fn: Callable, lr: float, steps: int):
    """H steps of SGD on one client's minibatches (leading (steps, batch)
    axes) -> (params, mean loss)."""
    step_fn = _ranged_grad(loss_fn)
    p, losses = params, []
    for t in range(steps):
        with profile.named_scope("fl.grad"):
            g, (loss, _) = step_fn(p, {k: v[t] for k, v in batches.items()})
        with profile.named_scope("fl.sgd"):
            p = {k: p[k] - lr * g[k] for k in p}
        losses.append(loss)
    return p, torch.stack(losses).mean()


def local_sgd_prox(params: Params, batches: Dict[str, torch.Tensor],
                   loss_fn: Callable, lr: float, steps: int, mu: float,
                   ref_params: Params):
    """H steps of proximal SGD (FedProx): grad += mu · (w − w_global).

    ``ref_params`` is the round's global model; the proximal term pulls each
    local trajectory back toward it (client-drift control):
    w ← w − lr · (g + mu · (w − w_ref)), as the reference's.
    """
    step_fn = _ranged_grad(loss_fn)
    p, losses = params, []
    for t in range(steps):
        with profile.named_scope("fl.grad"):
            g, (loss, _) = step_fn(p, {k: v[t] for k, v in batches.items()})
        with profile.named_scope("fl.sgd"):
            p = {k: p[k] - lr * (g[k] + mu * (p[k] - ref_params[k])) for k in p}
        losses.append(loss)
    return p, torch.stack(losses).mean()


def default_local_update(global_params: Params, batches, loss_fn: Callable,
                         fl: FLConfig):
    """One client's FedAvg local update: H SGD steps -> weight delta."""
    p, loss = local_sgd(global_params, batches, loss_fn, fl.local_lr,
                        fl.local_steps)
    return {k: p[k] - global_params[k] for k in p}, loss


def train_selected_clients(global_params: Params, client_batches,
                           loss_fn: Callable, fl: FLConfig,
                           local_update: Optional[Callable] = None):
    """Local training for all selected clients -> stacked deltas, losses.

    client_batches: tensors with leading (n_sel, steps, batch, ...) axes.
    ``local_update(global_params, batches, loss_fn, fl) -> (delta, loss)``
    is the per-client rule (a Strategy hook); default FedAvg.
    """
    if local_update is None:
        local_update = default_local_update
    fn = vmap(lambda b: local_update(global_params, b, loss_fn, fl))
    n_sel = next(iter(client_batches.values())).shape[0]
    chunk = max(1, min(fl.client_chunk, n_sel))
    deltas, losses = [], []
    for lo in range(0, n_sel, chunk):
        d, loss = fn({k: v[lo:lo + chunk] for k, v in client_batches.items()})
        deltas.append(d)
        losses.append(loss)
    stacked = {k: torch.cat([d[k] for d in deltas]) for k in deltas[0]}
    return stacked, torch.cat(losses)


def active_onus(onu_ids: np.ndarray, mask: np.ndarray, n_onus: int) -> int:
    """ONUs with an involved client: each sends one θ up the PON."""
    return int(np.sum(aggregation.onu_active(onu_ids, mask, n_onus)))


def aggregate(deltas: Params, weights, mask, onu_ids: np.ndarray,
              n_onus: int, mode: str, *, comp=None, client_ids=None):
    """Aggregate client deltas -> (mean delta, stats).

    Both modes compute the same update; they differ in the transport (what
    crosses the PON upstream), which ``uplink_models`` accounts. With an
    active ``comp`` (a ``CompressionState``) what crosses is compressed:
    each ONU's θ under "sfl"; under "classical" each involved client's δ,
    its EF residual keyed by its global id (``client_ids``, one per row).
    """
    mask_np = np.asarray(mask, np.float32)
    compressed = comp is not None and comp.active
    if mode == "sfl":
        if compressed:
            agg, _, K = aggregation.compressed_segment_aggregate(
                deltas, weights, mask_np, onu_ids, n_onus, comp)
        else:
            agg, _, K = aggregation.segment_aggregate(deltas, weights, mask_np,
                                                      onu_ids, n_onus)
        uplink_models = active_onus(onu_ids, mask_np, n_onus)
    else:
        if compressed:
            ids = (list(client_ids) if client_ids is not None
                   else list(range(len(mask_np))))
            deltas = comp.roundtrip_clients(ids, deltas, row_mask=mask_np)
        agg, K = aggregation.classical_aggregate(deltas, weights, mask_np)
        uplink_models = float(mask_np.sum())           # every involved client
    return agg, {"K": K, "uplink_models": uplink_models,
                 "involved": float(mask_np.sum())}


def server_apply(global_params: Params, agg: Params, server_lr: float = 1.0) -> Params:
    """FedAvg's server step: the global model plus ``server_lr`` times the
    mean delta, in f32, cast back to each leaf's type."""
    return {k: (w.float() + server_lr * agg[k]).to(w.dtype)
            for k, w in global_params.items()}


def apply_round(global_params: Params, deltas: Params, weights, mask,
                onu_ids: np.ndarray, n_onus: int, mode: str, server_lr: float = 1.0):
    """Aggregate client deltas and update the global model -> (params, stats)."""
    agg, stats = aggregate(deltas, weights, mask, onu_ids, n_onus, mode)
    return server_apply(global_params, agg, server_lr), stats


def evaluate(params: Params, eval_batch, loss_fn: Callable) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        loss, metrics = loss_fn(params, eval_batch)
    return {"eval_loss": loss, **{f"eval_{k}": v for k, v in metrics.items()}}
