"""RoundLoop backends — port of ``repro.fl.backends``'s
``ClientStackedBackend`` (the paper regime), ``GradientBackend`` (the
LM gradient regime, on one card or data parallel over a mesh) and
``TransportBackend`` (no model: transport-only sweeps).

A backend owns model state and the learning side of a round; the RoundLoop
owns selection, failures and PON transport. Contract:

    backend.strategy        — the Strategy instance (transport + hooks)
    backend.sample_counts   — (n_clients,) k_ij
    backend.onu_ids         — (n_clients,) int
    backend.run_round(rnd, selected, mask, rt, rng) -> metrics dict
    backend.replay_round(rnd, selected, mask, rt, rng)   (optional)
        — consume exactly run_round's RNG draws without training (resume);
          a backend whose rounds draw nothing from ``rng`` has none

Host timings go into the ambient ``repro_torch.obs`` registry under the
reference's names (``backend.train_s``, ``backend.eval_s``,
``backend.train_step_s``) through ``obs.profile.timed``, which synchronises
the card before each clock read; the aggregate is timed the same way as
``backend.aggregate_s`` into the History's ``aggregate_host_s`` alone (a
profiler range, no registry record: the reference has none). Under a
profiler the round's minibatch draws and their copy to the card open
``fl.minibatch`` and ``fl.h2d`` ranges.

The asynchronous seam of the runtime's semi_sync / fedbuff policies
(``ClientStackedBackend`` and ``TransportBackend``; ``GradientBackend`` is
sync-only):

    backend.client_update(client, rng) -> (delta, weight)
        — one client trains eagerly against the CURRENT params at dispatch
          time (download → H local steps; the math is clock-free, only the
          transport is simulated)
    backend.apply_updates(rnd, clients, deltas, weights) -> metrics
        — a buffer of possibly-stale deltas folded into the server with the
          policy's staleness-discounted weights
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import fedavg
from repro_torch.core.compression import CompressionState
from repro_torch.core.fedavg import FLConfig
from repro_torch.data import femnist
from repro_torch.fl.strategy import Strategy
from repro_torch.obs import profile
from repro_torch.obs.context import get as _obs_get


def backend_wire_scale(backend) -> float:
    """Compressed ÷ raw wire size of what this backend puts on the wire:
    exact from ``backend.params`` (per-leaf top-k counts included), the
    scheme's nominal ratio when the backend holds none."""
    spec = backend.strategy.compression_spec()
    if not spec.active:
        return 1.0
    tree = getattr(backend, "wire_tree", None) or getattr(backend, "params", None)
    return spec.wire_scale(tree)


class ClientStackedBackend:
    """Per-client model copies + H local steps (the paper's Fig. 2 regime).

    Parameters, eval batch, every round's minibatches and the runtime's
    in-flight deltas live on the device of ``params``. The eval runs after
    every ``eval_every``-th update; the rows in between carry the last one.
    """

    def __init__(self, fl: FLConfig, strategy: Strategy, params,
                 clients, eval_batch, loss_fn: Callable,
                 sample_counts: Optional[np.ndarray] = None,
                 onu_ids: Optional[np.ndarray] = None,
                 minibatch_fn: Callable = femnist.client_minibatches,
                 eval_every: int = 1):
        self.fl = fl
        self.eval_every = max(1, eval_every)
        self.strategy = strategy
        self.params = params
        self.device = next(iter(params.values())).device
        self.server_state = strategy.init_state(params)
        self.clients = clients
        self.eval_batch = eval_batch
        self.loss_fn = loss_fn
        self.sample_counts = (sample_counts if sample_counts is not None
                              else femnist.sample_counts(clients))
        self.onu_ids = onu_ids if onu_ids is not None else fedavg.onu_of_client(fl)
        self.minibatch_fn = minibatch_fn
        self._last_eval: Dict[str, float] = {}
        # wire compression: the backend owns the stateful side (EF residuals
        # and the rounding noise) so the frozen Strategy stays pure and
        # ``compress="none"`` allocates nothing
        spec = strategy.compression_spec()
        self._comp = (CompressionState(spec, device=self.device)
                      if spec.active else None)

    def _eval(self) -> Dict[str, float]:
        obs = _obs_get()
        with torch.no_grad():
            (loss, metrics), _ = profile.timed(
                "backend.eval_s", self.loss_fn, self.params, self.eval_batch,
                metrics=obs.metrics, tracer=obs.tracer)
        out = {"eval_loss": float(loss)}
        out.update({k: float(v) for k, v in metrics.items()})
        self._last_eval = out
        return out

    def _idle_metrics(self) -> Dict[str, float]:
        """No update this round — carry the last eval forward."""
        return dict(self._last_eval) if self._last_eval else {"acc": 0.0}

    def _padded(self, selected: np.ndarray, mask: np.ndarray):
        """Involved clients padded to a chunk multiple with weight-0 copies
        of the first (constant vmap shapes across rounds)."""
        active = selected[mask > 0]
        pad = (-len(active)) % self.fl.client_chunk
        return active, np.concatenate([active, np.full(pad, active[0])]), pad

    def run_round(self, rnd: int, selected: np.ndarray, mask: np.ndarray,
                  rt: Dict[str, Any], rng: np.random.Generator
                  ) -> Dict[str, float]:
        fl = self.fl
        if not np.any(mask > 0):
            return self._idle_metrics()     # nothing beat the deadline
        active, padded, pad = self._padded(selected, mask)
        w = np.concatenate([self.sample_counts[active], np.zeros(pad, np.float32)])
        row_mask = np.concatenate([np.ones(len(active), np.float32),
                                   np.zeros(pad, np.float32)])
        with profile.named_scope("fl.minibatch"):
            mbs = [self.minibatch_fn(rng, self.clients[c], fl.local_steps,
                                     fl.local_batch) for c in padded]
            stacked = {k: np.stack([b[k] for b in mbs]) for k in mbs[0]}
        with profile.named_scope("fl.h2d"):
            cb = {k: torch.from_numpy(v).to(self.device) for k, v in stacked.items()}
        obs = _obs_get()
        (deltas, _), train_s = profile.timed(
            "backend.train_s", fedavg.train_selected_clients,
            self.params, cb, self.loss_fn, fl,
            metrics=obs.metrics, tracer=obs.tracer,
            local_update=self.strategy.local_update)
        out = {"train_host_s": train_s}
        out.update(self._apply_and_eval(rnd, deltas, w, row_mask, self.onu_ids[padded],
                                        client_ids=padded))
        return out

    def _apply_and_eval(self, rnd: int, stacked, weights, mask, onu_ids,
                        client_ids) -> Dict[str, float]:
        """Shared tail of the sync round and the async apply: strategy
        aggregate → server update → uplink stats, ``aggregate_host_s`` and
        the eval cadence."""
        (agg, stats), aggregate_s = profile.timed(
            "backend.aggregate_s", self.strategy.aggregate, stacked, weights,
            mask, onu_ids, self.fl.total_onus, metrics=None, tracer=None,
            comp=self._comp, client_ids=client_ids)
        self.params, self.server_state = self.strategy.server_update(
            self.params, agg, self.server_state)
        out = {"uplink_models": float(stats["uplink_models"]),
               "aggregate_host_s": aggregate_s}
        if (rnd + 1) % self.eval_every == 0:
            out.update(self._eval())
        elif self._last_eval:
            out.update(self._last_eval)
        return out

    def replay_round(self, rnd: int, selected: np.ndarray, mask: np.ndarray,
                     rt: Dict[str, Any], rng: np.random.Generator) -> None:
        """Consume run_round's minibatch draws without training (resume
        fast-forward — must mirror run_round's rng consumption exactly)."""
        if not np.any(mask > 0):
            return
        _, padded, _ = self._padded(selected, mask)
        for c in padded:
            self.minibatch_fn(rng, self.clients[c], self.fl.local_steps,
                              self.fl.local_batch)

    # --- asynchronous seam (runtime semi_sync / fedbuff) ------------------

    def client_update(self, client: int, rng: np.random.Generator):
        """One client's eager local update against the CURRENT params, on
        the device of the params: (delta, its sample count k_c). By arrival
        time the server may have moved on (staleness), the regime the
        async policies weight for."""
        fl = self.fl
        mb = self.minibatch_fn(rng, self.clients[client], fl.local_steps, fl.local_batch)
        batches = {k: torch.from_numpy(v).to(self.device) for k, v in mb.items()}
        delta, _ = self.strategy.local_update(self.params, batches, self.loss_fn, fl)
        return delta, float(self.sample_counts[client])

    def apply_updates(self, rnd: int, clients, deltas, weights) -> Dict[str, float]:
        """Fold a buffer of (possibly stale) client deltas into the server:
        ``len(deltas)`` rows, unpadded, each of mask 1, with the policy's
        staleness-discounted ``weights``."""
        if len(deltas) == 0:
            return self._idle_metrics()
        clients = np.asarray(clients)
        stacked = {k: torch.stack([d[k] for d in deltas]) for k in deltas[0]}
        return self._apply_and_eval(rnd, stacked, np.asarray(weights, np.float32),
                                    np.ones(len(deltas), np.float32),
                                    self.onu_ids[clients], client_ids=clients)


class GradientBackend:
    """One global model; the round's (k_ij · mask) folds into the batch's
    ``client_weight``, so one gradient step is the K-normalised aggregate.

    Port of ``repro.fl.backends.GradientBackend``: on a ``mesh``, the
    ``rules`` (``launch.train.build_rules`` of the strategy's transport)
    pick how the ranks' gradients are reduced — FSDP's two-step schedule or
    the flat all-reduce — so the collective form of the paper's
    aggregation is induced by the same Strategy the client-stacked regime
    uses. ``mesh=None`` is one process. Owns the parameters (random, from
    ``seed``, or ``params``) and the optimizer's state, both on ``device``:
    under FSDP (``train_step.layout``) each rank's shards of them, else full
    replicas on every rank; ``wire_tree`` keeps the full leaves' shapes on
    ``meta`` for the wire's bill. Its rounds draw nothing from the loop's
    RNG: every rank builds each round's tokens, ``lm_batches(seed * 1000 +
    rnd, ...)``, and the train step keeps the rank's rows.
    """

    def __init__(self, model_cfg, strategy: Strategy, opt_name: str = "adamw",
                 lr: float = 3e-4, batch: int = 8, seq: int = 128, microbatches: int = 1,
                 seed: int = 0, sample_counts: Optional[np.ndarray] = None,
                 onu_ids: Optional[np.ndarray] = None, n_clients: Optional[int] = None,
                 device: str | torch.device = "cuda", params=None, mesh=None, rules=None):
        # lazy: `import repro_torch.fl` stays light for the client-stacked path
        from repro_torch import device as device_mod
        from repro_torch.launch import specs
        from repro_torch.models import transformer
        from repro_torch.optim import make_optimizer, tree_map

        self.device = device_mod.resolve(device)
        self.cfg = model_cfg
        self.strategy = strategy
        self.batch = batch
        self.seq = seq
        self.seed = seed
        n = n_clients if n_clients is not None else batch
        rng = np.random.default_rng(seed)
        self.sample_counts = (sample_counts if sample_counts is not None
                              else rng.integers(50, 400, n).astype(np.float32))
        self.onu_ids = (onu_ids if onu_ids is not None
                        else np.zeros(len(self.sample_counts), np.int64))
        params = (transformer.init_params(
            model_cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
            if params is None else params)
        self.wire_tree = tree_map(lambda p: p.to("meta"), params)
        self.mesh = mesh
        self.train_step = specs.make_train_step(model_cfg, opt_name, lr, microbatches,
                                                mesh=mesh, rules=rules, seed=seed)
        self.layout = self.train_step.layout
        self.params = params if self.layout is None else self.layout.shard(params)
        del params
        self.opt = make_optimizer(opt_name)
        self.opt_state = self.opt.init(self.params)

    def round_weights(self, selected: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """The batch rows' client weights, k_ij · mask, ``batch`` of them."""
        weights = (self.sample_counts[selected] * mask).astype(np.float32)
        if len(weights) > self.batch:
            # over-selection: more clients than batch rows — involved
            # clients (selection order) fill the rows first, so backups
            # replace deadline stragglers instead of starving the round
            order = np.concatenate([np.where(mask > 0)[0], np.where(mask <= 0)[0]])
            weights = weights[order[:self.batch]]
        elif len(weights) < self.batch:
            weights = np.concatenate([weights, np.zeros(self.batch - len(weights), np.float32)])
        return weights

    def run_round(self, rnd: int, selected: np.ndarray, mask: np.ndarray,
                  rt: Dict[str, Any], rng: np.random.Generator) -> Dict[str, float]:
        from repro_torch.data import lm as lm_data
        tokens = next(lm_data.lm_batches(self.seed * 1000 + rnd, 1, self.batch, self.seq,
                                         self.cfg.vocab_size))["tokens"]
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "client_weight": torch.from_numpy(self.round_weights(selected, mask)
                                                   ).to(self.device)}
        obs = _obs_get()
        (self.params, self.opt_state, loss), dt = profile.timed(
            "backend.train_step_s", self.train_step,
            self.params, self.opt_state, batch,
            metrics=obs.metrics, tracer=obs.tracer)
        return {"loss": float(loss), "dt": dt,
                "grad_norm": float(self.train_step.grad_norm)}


class TransportBackend:
    """Transport only: the driver records involvement and the upstream, no
    model is trained (DBA, wavelength and background-load sweeps). Its
    asynchronous seam is trivial (no deltas), so the runtime's semi_sync
    and fedbuff policies run pure scheduling sweeps too."""

    def __init__(self, strategy: Strategy, sample_counts: np.ndarray,
                 onu_ids: np.ndarray):
        self.strategy = strategy
        self.sample_counts = sample_counts
        self.onu_ids = onu_ids

    def run_round(self, rnd, selected, mask, rt, rng) -> Dict[str, float]:
        return {}

    def client_update(self, client: int, rng):
        return None, float(self.sample_counts[client])

    def apply_updates(self, rnd, clients, deltas, weights) -> Dict[str, float]:
        return {}
