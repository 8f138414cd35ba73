"""The LM train step — port of ``repro/launch/specs.py``'s
``weighted_loss_fn``, ``unnormalized_loss_fn`` and ``make_train_step``
(the MoE load-balance term included), on one card or data parallel over a
``torch.distributed`` mesh (``launch.mesh``).

Every rank holds full replicas of the parameters and the optimizer state
and takes the round's global batch, keeping the rows of its ("pod",
"data") coordinate. The gradients are summed by the schedule that the
sharding rules choose (``common.sharding.reduce_schedule``: FSDP's
two-step, or the flat all-reduce), so a step gives the numbers of the
reference's GSPMD step over the whole batch. ``transport="two_step_int8"``
is the paper's protocol made explicit: the data step inside each pod, then
the cross-pod hop as int8.

And the abstract inputs of every (arch × shape) cell, the dry run's
(``launch.dryrun``): ``batch_struct``, ``param_shardings``,
``opt_state_struct``, ``cache_struct_sharded`` and ``input_specs``, which
returns the cell's step function and its arguments as ``meta`` tensors
(nothing allocated):

  train    -> train_step(params, opt_state, batch)
  prefill  -> prefill_step(params, batch)
  decode   -> serve_step(params, batch, cache)   (one new token)

Shapes are global: a data-parallel rank takes the global batch and keeps
its rows, as the train step does on a real mesh. The reference attaches a
``NamedSharding`` to each struct; the port's sharding is a spec tuple per
leaf (``param_shardings``), and only the gradients' reduce schedule
depends on it (``common.sharding.reduce_schedule``).
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.sharding import (ShardingRules, filter_valid_spec,
                                         logical_to_physical, reduce_schedule)
from repro_torch.common.tree import flatten, unflatten
from repro_torch.core.aggregation import (all_reduce, classical_allreduce,
                                          int8_two_step_leaf, two_step_allreduce)
from repro_torch.core.compression import Noise, uniform_noise
from repro_torch.launch.mesh import AbstractMesh, axes_group, client_index, mesh_shape, size
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import make_optimizer, tree_map


def _weighted_pieces(params, batch, cfg: ModelConfig):
    """(Σ weighted nll, Σ weight, aux): the loss mask with each row scaled
    by its ``client_weight`` (k_ij · mask, the FL weight folded into the
    batch), and the MoE router's load-balance loss."""
    x, labels, aux = transformer.forward(params, batch, cfg)
    B, S, _ = x.shape
    mask = transformer.loss_mask(cfg, B, S, x.device)
    w = batch.get("client_weight")
    if w is not None:
        mask = mask * w[:, None]
    return (*transformer.chunked_xent(params, x, labels, mask, cfg), aux)


def weighted_loss_fn(params, batch, cfg: ModelConfig):
    """FL-weighted loss: per-row ``client_weight``, normalised by its sum K,
    plus the MoE load-balance term.

    With one local step its gradient is the SFL aggregate Σ k·mask·g / K.
    The denominator floor is 1e-6 here and 1.0 in ``loss_fn``, as in the
    reference; its "xent" metric holds the whole loss, as the reference's."""
    tot, cnt, aux = _weighted_pieces(params, batch, cfg)
    loss = tot / torch.clamp(cnt, min=1e-6) + transformer.aux_loss(cfg, aux)
    return loss, {"xent": loss, "aux": aux}


def unnormalized_loss_fn(params, batch, cfg: ModelConfig):
    """(Σ weighted nll, Σ weight): the SFL objective before normalisation,
    for transports that normalise after the cross-pod reduce; the MoE term
    enters the sum scaled by max(Σ weight, 1)."""
    tot, cnt, aux = _weighted_pieces(params, batch, cfg)
    if cfg.n_experts:
        tot = tot + transformer.aux_loss(cfg, aux) * torch.clamp(cnt, min=1.0)
    return tot, cnt


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def grad_norm(grads) -> torch.Tensor:
    """The global L2 norm of a gradient tree, f32 (no host sync)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in _leaves(grads)]))


def _grads(params, objective):
    """(∂ objective()[0] / ∂ every leaf of ``params``, objective()[1]):
    the leaves require grad only for the call. A leaf the objective does
    not use (the token table under the frame frontend) gets zeros, as
    ``jax.grad`` gives it."""
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    try:
        out, extra = objective()
        grads = iter(torch.autograd.grad(out, leaves, allow_unused=True,
                                         materialize_grads=True))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return tree_map(lambda _: next(grads), params), extra


def _rows(batch, lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def _micro_batches(batch, microbatches: int) -> List[Dict[str, torch.Tensor]]:
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
    n = B // microbatches
    return [_rows(batch, i * n, (i + 1) * n) for i in range(microbatches)]


def _accumulate(grads, g):
    """f32 sum of micro-batch gradients."""
    return (tree_map(lambda x: x.float(), g) if grads is None
            else tree_map(lambda a, x: a + x.float(), grads, g))


_CLIENT_AXES = ("pod", "data")
_MOE_RANKS = ("MoE on more than one rank: the router's load-balance loss and capacity drops "
              "are functions of the whole batch, which data-parallel ranks do not see; "
              "ROADMAP.md Queue 1 item 1e")


def _rank_micro_batches(batch, mesh, microbatches: int, per_micro: bool):
    """This rank's rows of the global batch, as its micro-batches.

    ``per_micro``: micro-batch i is the rank's share of the global
    micro-batch i (rows i·B/m .. (i+1)·B/m, split over the ranks in
    ("pod", "data") order), so each global micro-batch is normalised by
    its own weight, as the reference's scan over the sharded batch.
    Otherwise the rank's block is rows r·B/R .. (r+1)·B/R (the pod's block,
    split over "data"), cut into m micro-batches."""
    r, R = client_index(mesh, [a for a in _CLIENT_AXES if a in mesh.mesh_dim_names])
    B = next(iter(batch.values())).shape[0]
    if B % (R * microbatches):
        raise ValueError(f"batch {B} does not split over {R} ranks x {microbatches} "
                         "microbatches")
    if not per_micro:
        return _micro_batches(_rows(batch, r * B // R, (r + 1) * B // R), microbatches)
    n, k = B // microbatches, B // (microbatches * R)
    return [_rows(batch, i * n + r * k, i * n + (r + 1) * k) for i in range(microbatches)]


def _step_noise(seed: int, opt_state, device) -> torch.Generator:
    """A generator for the int8 hop's noise from the run seed and the
    optimizer's step counter (the reference's fold_in(PRNGKey(seed), t)):
    fresh every step, alike on every rank."""
    t = opt_state.get("t") if isinstance(opt_state, dict) else None
    if t is None:
        raise ValueError(
            "two_step_int8 with a stateless optimizer needs an explicit noise= per step "
            "(no step counter to derive fresh stochastic-rounding noise from)")
    mixed = np.random.SeedSequence([seed, int(t)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def make_train_step(cfg: ModelConfig, opt_name: str = "adamw", lr: float = 1e-4,
                    microbatches: int = 1, transport: str = "gspmd", mesh=None,
                    rules: Optional[ShardingRules] = None, seed: int = 0):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    loss)`` (``two_step_int8``'s also takes ``noise=``).

    ``microbatches > 1`` splits the batch rows into that many slices and
    accumulates their gradients in f32, then divides by ``microbatches``;
    the loss is the slices' mean and the optimizer runs once. The step
    keeps the last gradient's global norm in ``train_step.grad_norm`` (a
    0-d f32 tensor on the card).

    ``mesh=None`` or a world of one runs the one-card step. On a mesh of
    more ranks each takes the global batch, keeps its rows, and:

    * ``transport="gspmd"``: all-reduces each micro-batch's Σ weight K
      first, differentiates its rows' Σ weighted nll / max(K, 1e-6), and
      sums the gradients in f32 by ``rules``' schedule (default
      ``ShardingRules()``: FSDP's two-step), cast back to the parameters'
      type at one micro-batch; summing the accumulated micro-batches once
      gives the same sum with 1/m of the collectives.
    * ``transport="two_step_int8"`` (needs "pod" in the mesh): the
      gradients of ``unnormalized_loss_fn``, reduce-scattered over "data"
      (the ONU step, in f32); each data rank's shard of a pod-summed leaf
      crosses "pod" as int8 at that leaf's one scale
      (``core.aggregation.int8_two_step_leaf``), with noise drawn at each
      leaf's shape (sorted keys) from ``noise`` or, by default, from
      (``seed``, ``opt_state["t"]``), alike on every rank; then
      K = Σ_pod weight, gradients / max(K, 1e-6), loss = Σ_pod nll / K.

    MoE configs on more than one rank raise: the router's load-balance loss
    and its capacity drops are functions of the whole batch (ROADMAP.md
    Queue 1 item 1e).
    """
    if transport not in ("gspmd", "two_step_int8"):
        raise ValueError(f"unknown transport {transport!r}")
    if transport == "two_step_int8" and (mesh is None or "pod" not in mesh.mesh_dim_names):
        raise ValueError("transport='two_step_int8' needs a mesh with a 'pod' axis")
    if cfg.n_experts and size(mesh) > 1:
        raise NotImplementedError(_MOE_RANKS)
    opt = make_optimizer(opt_name)
    if transport == "two_step_int8":
        return _two_step_int8_step(cfg, opt, lr, microbatches, mesh, seed)
    if size(mesh) == 1:
        return _one_rank_step(cfg, opt, lr, microbatches)
    return _data_parallel_step(cfg, opt, lr, microbatches, mesh, rules or ShardingRules())


def _one_rank_step(cfg, opt, lr, microbatches):
    def grads_and_loss(params, batch):
        def objective():
            loss, _ = weighted_loss_fn(params, batch, cfg)
            return loss, loss.detach()
        return _grads(params, objective)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            grads, loss = grads_and_loss(params, batch)
        else:
            grads, losses = None, []
            for mb in _micro_batches(batch, microbatches):
                g, loss = grads_and_loss(params, mb)
                grads = _accumulate(grads, g)
                losses.append(loss)
                del g
            grads = tree_map(lambda a: a / microbatches, grads)
            loss = torch.stack(losses).mean()
        train_step.grad_norm = grad_norm(grads)
        new_params, new_state = opt.update(params, grads, opt_state, lr)
        return new_params, new_state, loss

    train_step.grad_norm = None
    return train_step


def _data_parallel_step(cfg, opt, lr, microbatches, mesh, rules):
    schedule = reduce_schedule(rules, mesh_shape(mesh))
    names = mesh.mesh_dim_names
    client_axes = tuple(a for a in _CLIENT_AXES if a in names)
    client_group = axes_group(mesh, client_axes)

    def reduce(grads):
        if schedule == "two_step":
            return two_step_allreduce(grads, mesh, "data", "pod" if "pod" in names else None)
        return classical_allreduce(grads, mesh, client_axes)

    def micro_grads(params, mb):
        def objective():
            tot, cnt, _ = _weighted_pieces(params, mb, cfg)
            K = all_reduce(cnt.detach(), client_group).clamp_min(1e-6)
            return tot / K, (tot / K).detach()
        return _grads(params, objective)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        grads, losses = None, []
        for mb in _rank_micro_batches(batch, mesh, microbatches, per_micro=True):
            g, loss = micro_grads(params, mb)
            grads = g if microbatches == 1 else _accumulate(grads, g)
            losses.append(loss)
            del g
        summed = reduce(grads)
        if microbatches == 1:
            grads = tree_map(lambda s, p: s.to(p.dtype), summed, params)
        else:
            grads = tree_map(lambda s: s / microbatches, summed)
        loss = all_reduce(torch.stack(losses), client_group).mean()
        train_step.grad_norm = grad_norm(grads)
        new_params, new_state = opt.update(params, grads, opt_state, lr)
        return new_params, new_state, loss

    train_step.grad_norm = None
    return train_step


def _two_step_int8_step(cfg, opt, lr, microbatches, mesh, seed):
    data_group = axes_group(mesh, ("data",))
    pod_group = axes_group(mesh, ("pod",))

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor],
                   noise: Optional[Noise] = None):
        grads, tot, cnt = None, 0.0, 0.0
        for mb in _rank_micro_batches(batch, mesh, microbatches, per_micro=False):
            def objective():
                t, c = unnormalized_loss_fn(params, mb, cfg)
                return t, (t.detach(), c.detach())
            g, (t, c) = _grads(params, objective)
            grads = g if microbatches == 1 else _accumulate(grads, g)
            tot, cnt = tot + t, cnt + c
            del g
        leaves = flatten(grads)
        del grads
        tot_cnt = all_reduce(torch.stack([tot, cnt]), data_group)
        dev = leaves[0].device
        noises = uniform_noise(noise if noise is not None else _step_noise(seed, opt_state, dev),
                               [tuple(x.shape) for x in leaves], dev)
        summed = []
        for i, x in enumerate(leaves):
            leaves[i] = None
            # the ONU step (each data rank's shard of the pod's sum, f32),
            # then the CPS hop: the shard crosses "pod" as int8 at the pod
            # leaf's scale
            summed.append(int8_two_step_leaf(x, next(noises), data_group, pod_group))
        tot, K = all_reduce(tot_cnt, pod_group).unbind()
        K = K.clamp_min(1e-6)
        grads = unflatten(params, [g / K for g in summed])
        train_step.grad_norm = grad_norm(grads)
        new_params, new_state = opt.update(params, grads, opt_state, lr)
        return new_params, new_state, tot / K

    train_step.grad_norm = None
    return train_step


# ---------------------------------------------------------------------------
# abstract inputs of a cell (the dry run's)
# ---------------------------------------------------------------------------

_META = torch.device("meta")
INIT_TP = inspect.signature(transformer.init_params).parameters["tp"].default


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=_META)


def batch_struct(cfg: ModelConfig, shp: ShapeConfig, decode: bool = False,
                 rows: int = 0):
    """The cell's batch on ``meta``: tokens (or frames and labels),
    patches (media when decoding), decode positions or the FL
    ``client_weight``; ``rows`` (default the global batch) rows."""
    B = rows or shp.global_batch
    S = 1 if decode else shp.seq_len
    d = cfg.d_model
    batch = {}
    if cfg.frontend == "frames":
        batch["frames"] = _meta((B, S, d), torch.bfloat16)
        batch["labels"] = _meta((B, S), torch.int32)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if cfg.frontend == "patches":
        batch["media" if decode else "patches"] = _meta((B, cfg.n_frontend_tokens, d),
                                                        torch.bfloat16)
    if decode:
        batch["pos"] = _meta((B, 1), torch.int32)
    else:
        batch["client_weight"] = _meta((B,), torch.float32)
    return batch


def _spec_tree(params, logical, mesh_shape, rules):
    if isinstance(params, dict):
        return {k: _spec_tree(params[k], logical[k], mesh_shape, rules) for k in params}
    # an axis the mesh lacks (every axis, on one card) shards nothing
    spec = tuple(None if ax is None or any(a not in mesh_shape for a in
                                           ((ax,) if isinstance(ax, str) else ax)) else ax
                 for ax in logical_to_physical(rules, logical))
    return filter_valid_spec(mesh_shape, spec, tuple(params.shape))


def param_shardings(cfg: ModelConfig, mesh_shape: Optional[Dict[str, int]] = None,
                    rules: Optional[ShardingRules] = None):
    """(parameters on ``meta``, the spec tree: per leaf, its logical axes
    through ``rules`` onto ``mesh_shape``'s axes, an axis dropped where it
    does not divide the dimension). Query heads pad to the "model" axis's
    size, as the reference's; on a mesh without one, as the port's own init
    pads them (``transformer.init_params``' tp = 16), so the tree is the one
    the card trains and serves."""
    mesh_shape = dict(mesh_shape or {})
    params, logical = transformer.abstract_params(cfg, tp=mesh_shape.get("model", INIT_TP))
    return params, _spec_tree(params, logical, mesh_shape, rules or ShardingRules())


def opt_state_struct(opt_name: str, params_abs):
    """The optimizer state of ``params_abs`` on ``meta`` (f32 moments;
    AdamW's and Yogi's step counter int32)."""
    make_optimizer(opt_name)    # validates the name before shaping state
    if opt_name == "sgd":
        return {}
    f32 = lambda x: _meta(x.shape, torch.float32)   # noqa: E731
    if opt_name == "sgdm":
        return {"mu": tree_map(f32, params_abs)}
    if opt_name in ("adamw", "yogi"):
        return {"m": tree_map(f32, params_abs), "v": tree_map(f32, params_abs),
                "t": _meta((), torch.int32)}
    raise ValueError(opt_name)


def cache_struct_sharded(cfg: ModelConfig, shp: ShapeConfig, rows: int = 0):
    """The decode cache of the cell on ``meta`` (``transformer.init_cache``:
    the unit's stacked, the tail's; each attention layer's position a host
    int32), ``rows`` (default the global batch) rows."""
    return transformer.init_cache(cfg, rows or shp.global_batch, shp.seq_len, device=_META)


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return transformer.prefill(params, batch, cfg, cache_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, batch, cache):
        return transformer.decode_step(params, batch, cache, cfg)
    return serve_step


def _meta_noise(shapes):
    return [_meta(s, torch.float32) for s in shapes]


def input_specs(cfg: ModelConfig, shp: ShapeConfig, mesh_shape: Optional[Dict[str, int]] = None,
                rules: Optional[ShardingRules] = None, opt_name: str = "adamw",
                microbatches: int = 1, transport: str = "gspmd"):
    """Everything the dry run needs for one cell: (fn, args), the args on
    ``meta``. ``mesh_shape`` ({axis: size}; None or one rank: one card)
    becomes an ``AbstractMesh`` the train step reduces over, its
    collectives reckoned. A serving cell on a data-parallel mesh serves
    each rank's share of the batch with nothing to reduce."""
    mesh_shape = dict(mesh_shape or {})
    n_ranks = math.prod(mesh_shape.values()) if mesh_shape else 1
    params, _ = param_shardings(cfg, mesh_shape, rules)
    if shp.kind == "train":
        mesh = AbstractMesh(mesh_shape) if n_ranks > 1 else None
        step = make_train_step(cfg, opt_name, microbatches=microbatches, transport=transport,
                               mesh=mesh, rules=rules)
        fn = step
        if transport == "two_step_int8":
            def fn(params, opt_state, batch):
                return step(params, opt_state, batch, noise=_meta_noise)
        return fn, (params, opt_state_struct(opt_name, params), batch_struct(cfg, shp))
    clients = math.prod(mesh_shape.get(a, 1) for a in _CLIENT_AXES)
    if shp.global_batch % clients:
        raise ValueError(f"batch {shp.global_batch} does not split over {clients} ranks")
    rows = shp.global_batch // clients
    if cfg.n_experts and clients > 1:
        raise NotImplementedError(_MOE_RANKS)
    if shp.kind == "prefill":
        batch = batch_struct(cfg, shp, rows=rows)
        batch.pop("client_weight")
        return make_prefill_step(cfg, cache_len=shp.seq_len), (params, batch)
    if shp.kind == "decode":
        return make_serve_step(cfg), (params, batch_struct(cfg, shp, decode=True, rows=rows),
                                      cache_struct_sharded(cfg, shp, rows))
    raise ValueError(shp.kind)
