"""The LM train step — port of ``repro/launch/specs.py``'s
``weighted_loss_fn``, ``unnormalized_loss_fn`` and ``make_train_step``
(the MoE load-balance term included), on one card or data parallel over a
``torch.distributed`` mesh (``launch.mesh``).

Every rank takes the round's global batch and keeps the rows of its
("pod", "data") coordinate. Under the reference's default rules
(``fsdp="data"``) the step is FSDP: each rank holds its shards of the
parameters and the optimizer's state (:class:`ParamLayout`), gathers them
where the forward uses them, and the gathers' backward reduce-scatters
each gradient onto its shard; the replicated rules hold full replicas and
sum the gradients by the flat all-reduce. On a mesh with a "model" axis
(``tensor="model"``, ``expert="model"``) each rank also holds its block
of the heads, channels, experts and vocabulary, and the forward runs in
``core.tensor_parallel``'s region. Either way a step gives the numbers of
the reference's GSPMD step over the whole batch, MoE's router statistics
included. ``transport="two_step_int8"`` is the paper's
protocol made explicit on the same layout: the data step inside each pod,
then the cross-pod hop as int8.

And the abstract inputs of every (arch × shape) cell, the dry run's
(``launch.dryrun``): ``batch_struct``, ``param_shardings``,
``opt_state_struct``, ``cache_struct_sharded`` and ``input_specs``, which
returns the cell's step function and its arguments as ``meta`` tensors
(nothing allocated):

  train    -> train_step(params, opt_state, batch)
  prefill  -> prefill_step(params, batch)
  decode   -> serve_step(params, batch, cache)   (one new token)

Shapes are global but for FSDP's shards: a data-parallel rank takes the
global batch and keeps its rows, as the train step does on a real mesh.
The reference attaches a ``NamedSharding`` to each struct; the port's
sharding is a spec tuple per leaf (``param_shardings``), from which the
layout takes each leaf's dimensions cut over "data" and "model", for the
serve steps as for the train step; the decode cache is rank 0's blocks.
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.sharding import (MODEL_AXIS, ShardingRules, _axes, filter_valid_spec,
                                         join_places, logical_to_physical, model_parallel,
                                         places_of, reduce_schedule, shard_or_replicate,
                                         sharding_tree)
from repro_torch.common.tree import flatten, unflatten
from repro_torch.core.aggregation import (GatherShard, all_reduce, gather_dim,
                                          int8_two_step_leaf)
from repro_torch.core.compression import Noise, uniform_noise
from repro_torch.core.tensor_parallel import TensorParallel
from repro_torch.launch.mesh import AbstractMesh, axes_group, client_index, mesh_shape
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import make_optimizer, tree_map


def _weighted_pieces(params, batch, cfg: ModelConfig, router_group=None, layout=None):
    """(Σ weighted nll, Σ weight, aux): the loss mask with each row scaled
    by its ``client_weight`` (k_ij · mask, the FL weight folded into the
    batch), and the MoE router's load-balance loss (with ``router_group``
    this rank's part of the group's: ``moe._route``). With a ``layout`` the
    parameters are shards: FSDP's gathered where they are used, the blocks
    over "model" run in its tensor-parallel region."""
    gather = tp = None
    if layout is not None:
        tp = layout.tp
        if layout.group is not None:
            params, gather = layout.gather_outer(params), layout.gather_unit
    x, labels, aux = transformer.forward(params, batch, cfg, gather, router_group, tp)
    B, S, _ = x.shape
    mask = transformer.loss_mask(cfg, B, S, x.device)
    w = batch.get("client_weight")
    if w is not None:
        mask = mask * w[:, None]
    return (*transformer.chunked_xent(params, x, labels, mask, cfg, tp), aux)


def weighted_loss_fn(params, batch, cfg: ModelConfig):
    """FL-weighted loss: per-row ``client_weight``, normalised by its sum K,
    plus the MoE load-balance term.

    With one local step its gradient is the SFL aggregate Σ k·mask·g / K.
    The denominator floor is 1e-6 here and 1.0 in ``loss_fn``, as in the
    reference; its "xent" metric holds the whole loss, as the reference's."""
    tot, cnt, aux = _weighted_pieces(params, batch, cfg)
    loss = tot / torch.clamp(cnt, min=1e-6) + transformer.aux_loss(cfg, aux)
    return loss, {"xent": loss, "aux": aux}


def unnormalized_loss_fn(params, batch, cfg: ModelConfig, router_group=None, layout=None):
    """(Σ weighted nll, Σ weight): the SFL objective before normalisation,
    for transports that normalise after the cross-pod reduce; the MoE term
    enters the sum scaled by max(Σ weight, 1). With ``router_group`` (the
    data ranks of a pod) the router's statistics and that Σ weight are the
    group's, and the rank's sum its part of the group's; ``layout`` as in
    :func:`_weighted_pieces`."""
    tot, cnt, aux = _weighted_pieces(params, batch, cfg, router_group, layout)
    if cfg.n_experts:
        K = cnt if router_group is None else all_reduce(cnt.detach(), router_group)
        tot = tot + transformer.aux_loss(cfg, aux) * torch.clamp(K, min=1.0)
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


def _rank_micro_batches(batch, mesh, microbatches: int, outer=()):
    """This rank's rows of the global batch, as its micro-batches.

    The batch splits into blocks over the ``outer`` axes (the pods, for
    ``two_step_int8``: each pod its block), each block into m micro-batches,
    and micro-batch i of a block over the remaining client axes in ("pod",
    "data") order: the rank's rows of micro-batch i. Each micro-batch of a
    block is then normalised (and routed, under MoE) as one, as the
    reference's scan over the sharded batch."""
    names = [a for a in _CLIENT_AXES if a in mesh.mesh_dim_names]
    o, O = client_index(mesh, [a for a in names if a in outer])
    r, R = client_index(mesh, [a for a in names if a not in outer])
    B = next(iter(batch.values())).shape[0]
    if B % (O * R * microbatches):
        raise ValueError(f"batch {B} does not split over {O * R} ranks x {microbatches} "
                         "microbatches")
    block = B // O
    n = block // microbatches
    k = n // R
    return [_rows(batch, o * block + i * n + r * k, o * block + i * n + (r + 1) * k)
            for i in range(microbatches)]


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


class ParamLayout:
    """How a rank of a mesh holds the parameters and the optimizer's state:
    cut over the rules' ``fsdp`` axes (the reference's ``fsdp="data"``:
    FSDP) and over "model" (tensor and expert parallelism), each leaf on
    the dimensions ``param_shardings`` maps onto them (a dimension the axes
    do not divide stays whole, as ``filter_valid_spec`` leaves it).

    ``places``: per leaf the ``Place`` of this rank's FSDP shard, or None
    (gathered over ``group`` where the forward uses it); ``tp_places``: per
    leaf the ``Place`` of its block over "model", or None; ``shards``:
    both joined (what ``shard``, ``gather`` and a checkpoint take, their
    groups in ``axis_groups``). ``tp`` is the region the forward runs the
    model blocks in (``core.tensor_parallel``), None without a "model"
    axis. The optimizer's state mirrors the parameters."""

    def __init__(self, cfg: ModelConfig, mesh, rules: ShardingRules, fsdp: bool):
        shape = mesh_shape(mesh)
        params, specs = param_shardings(cfg, shape, rules)
        self.full_shapes = tree_map(lambda t: tuple(t.shape), params)
        self.tp = TensorParallel.of(mesh, rules)
        axes = tuple(a for a in _axes(rules.fsdp) if a in shape) if fsdp else ()
        self.group = axes_group(mesh, axes) if axes else None
        none = tree_map(lambda _: None, specs)
        self.places = (sharding_tree(specs, axes, shape, client_index(mesh, axes)[0])
                       if axes else none)
        self.tp_places = (none if self.tp is None else
                          sharding_tree(specs, (MODEL_AXIS,), shape, self.tp.index))
        self.shards = tree_map(join_places, self.places, self.tp_places)
        self.axis_groups = {axes: self.group}
        if self.tp is not None:
            self.axis_groups[(MODEL_AXIS,)] = self.tp.group
        # a unit's leaves as the forward takes them: the stacked axis unbound
        self.unit_places = tree_map(lambda pl: pl and pl._replace(dim=pl.dim - 1),
                                    self.places.get("unit", {}))

    def state_places(self, opt_state):
        """The places of an optimizer state: a moment tree each (the
        parameters' ``shards``), its step counter replicated."""
        return {k: self.shards if isinstance(v, dict) else None
                for k, v in opt_state.items()}

    def shard(self, tree, places=None):
        """This rank's shards of a full tree (the parameters by default:
        built for the mesh, ``init_params(..., tp=<"model" size>)``, where
        "model" is larger than 1)."""
        if places is None and self.tp is not None and self.tp.size > 1:
            got = tree_map(lambda t: tuple(t.shape), tree)
            if got != self.full_shapes:
                raise ValueError(
                    "the parameters' shapes are not those of the mesh's: build them with "
                    f"init_params(..., tp={self.tp.size}), the size of its 'model' axis")
        return tree_map(shard_or_replicate, tree, places or self.shards)

    def gather(self, tree, places=None):
        """The full tree of a sharded one (collective: every rank calls)."""
        def leaf(x, place):
            for pl in places_of(place):
                if pl.count > 1:
                    x = gather_dim(x, pl.dim, self.axis_groups[pl.axes])
            return x
        with torch.no_grad():
            return tree_map(leaf, tree, places or self.shards)

    def _gathered(self, tree, places):
        return tree_map(lambda x, pl: x if pl is None
                        else GatherShard.apply(x, pl.dim, self.group), tree, places)

    def gather_outer(self, params):
        """Every leaf but the unit's FSDP shards gathered, differentiably:
        the embedding, the tail and the head, once a forward."""
        if self.group is None:
            return params
        return {k: v if k == "unit" else self._gathered(v, self.places[k])
                for k, v in params.items()}

    def gather_unit(self, unit_p):
        """One unit's leaves gathered, differentiably (inside the unit's
        remat boundary: ``transformer._unit_step``)."""
        return self._gathered(unit_p, self.unit_places)

    def groups(self, pod_group, client_group):
        """Per leaf, the group its gradient is all-reduced over: a shard's,
        summed over "data" by the gathers' backward, over "pod" (the CPS
        step); a replicated leaf's over every client rank. Either group
        holds the ranks of this rank's "model" coordinate: a block over
        "model" has its whole gradient on its rank already."""
        return tree_map(lambda pl: client_group if pl is None else pod_group, self.places)

    def grad_norm(self, grads) -> torch.Tensor:
        """The global L2 norm: each leaf's square summed over the ranks
        that hold its blocks (all-reduced over the FSDP group where it is
        sharded there, over "model" where it is cut there), each shard
        counted once."""
        sums = {}
        tree_map(lambda g, f, t: sums.setdefault((f is not None, t is not None), []).append(
            torch.linalg.vector_norm(g.float()) ** 2), grads, self.places, self.tp_places)
        total = 0.0
        for (fsdp, tensor), sq in sums.items():
            s = torch.stack(sq).sum()
            if fsdp:
                s = all_reduce(s, self.group)
            if tensor:
                s = all_reduce(s, self.tp.group)
            total = total + s
        return torch.sqrt(total)


def param_layout(cfg: ModelConfig, mesh, rules: Optional[ShardingRules] = None
                 ) -> Optional[ParamLayout]:
    """The :class:`ParamLayout` a train or serve step of these arguments
    holds its parameters in, or None for full replicas. FSDP is on under
    the rules' ``fsdp`` on a mesh axis, with either transport (the
    replicated rules hold whole leaves over "data"); tensor and expert
    parallelism whenever the mesh has a "model" axis the rules put them on,
    of any size. ``mesh=None``: None."""
    rules = rules or ShardingRules()
    if mesh is None:
        return None
    shape = mesh_shape(mesh)
    fsdp = (reduce_schedule(rules, shape) == "two_step"
            and any(a in shape for a in _axes(rules.fsdp)))
    if not fsdp and not any(model_parallel(rules, shape)):
        return None
    return ParamLayout(cfg, mesh, rules, fsdp)


def make_train_step(cfg: ModelConfig, opt_name: str = "adamw", lr: float = 1e-4,
                    microbatches: int = 1, transport: str = "gspmd", mesh=None,
                    rules: Optional[ShardingRules] = None, seed: int = 0):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    loss)`` (``two_step_int8``'s also takes ``noise=``).

    ``microbatches > 1`` splits the batch rows into that many slices and
    accumulates their gradients in f32, then divides by ``microbatches``;
    the loss is the slices' mean and the optimizer runs once. The step
    keeps the last gradient's global norm in ``train_step.grad_norm`` (a
    0-d f32 tensor on the card) and its parameters' layout in
    ``train_step.layout`` (:func:`param_layout`; ``layout.shard`` cuts a
    rank's leaves from full trees, ``layout.gather`` joins them).

    ``mesh=None`` runs the one-card step. On a mesh each rank takes the
    global batch and keeps the rows of its ("pod", "data") coordinate
    (every "model" rank the same rows), and:

    * ``transport="gspmd"`` under rules whose ``fsdp`` names a mesh axis
      (default ``ShardingRules()``: "data"): FSDP. Each rank holds its
      shards of the parameters and of the optimizer's state
      (``train_step.layout.shard`` cuts them from full trees). A forward
      gathers each unit's leaves inside its remat boundary and the other
      leaves once (``core.aggregation.GatherShard``: all-gather over
      "data"); the backward reduce-scatters each gradient onto its shard
      (the ONU step). Each micro-batch's Σ weight K is all-reduced first and
      its rows' Σ weighted nll / max(K, 1e-6) differentiated; after the
      micro-batches the shard gradients are all-reduced over "pod" (the CPS
      step) and each replicated leaf's over every client rank, in f32, cast
      back to the parameters' type at one micro-batch. The optimizer, being
      elementwise, updates the shards.
    * ``transport="gspmd"`` under the replicated rules (``classical``):
      full replicas, the same objective, the gradients summed by the flat
      all-reduce over ("pod", "data").
    * ``transport="two_step_int8"`` (needs "pod" in the mesh): the
      layout of the gspmd step (FSDP shards under ``fsdp="data"``, full
      replicas under the replicated rules); the gradients of
      ``unnormalized_loss_fn`` over the pod's micro-batches, summed over
      "data" (the ONU step, in f32: a shard's by the gathers' backward, a
      whole leaf's reduce-scattered); each rank's part of a pod-summed leaf
      crosses "pod" as int8 at that leaf's one scale
      (``core.aggregation.int8_two_step_leaf``), with noise drawn at each
      leaf's whole shape (sorted keys), a leaf at a time, from ``noise``
      or, by default, from (``seed``, ``opt_state["t"]``), alike on every
      rank, each rank quantizing with its block's slice; then K = Σ_pod
      weight, gradients / max(K, 1e-6), loss = Σ_pod nll / K. The rank
      keeps its block of each sum and the optimizer updates its shards.

    Tensor and expert parallelism: on a mesh with a "model" axis, of any
    size, under rules that put ``tensor`` and ``expert`` on it (the
    default), each rank holds its block of every leaf ``param_shardings``
    cuts over "model" (the padded query heads, the MLP, RG-LRU and RWKV6
    channels, the MoE experts, the vocabulary, the embedding's columns;
    parameters built for the mesh: ``init_params(..., tp=<its size>)``) and
    runs the forward in ``core.tensor_parallel``'s region; the loss is
    alike on every model rank and each differentiates it once. Its blocks'
    gradients are whole on their rank, so the reductions above run among
    the ranks of one "model" coordinate; the gradient norm sums each
    block's square once. It combines with FSDP (a leaf then cut on two
    dimensions), with the classical rules and with ``two_step_int8``,
    whose hop then sends 1 / (|data|·|model|) of each leaf a rank.

    MoE: the router's load-balance statistics are those of the global
    micro-batch, all-reduced over the client ranks (over "data" alone, the
    pod's rows, under ``two_step_int8``); each rank's loss carries its part
    (``moe._route``). Capacity is per row. Under expert parallelism each
    model rank runs its experts' slots and the combine is one all-reduce
    over "model" (``moe.moe_block_scatter``).
    """
    if transport not in ("gspmd", "two_step_int8"):
        raise ValueError(f"unknown transport {transport!r}")
    if transport == "two_step_int8" and (mesh is None or "pod" not in mesh.mesh_dim_names):
        raise ValueError("transport='two_step_int8' needs a mesh with a 'pod' axis")
    opt = make_optimizer(opt_name)
    layout = param_layout(cfg, mesh, rules)
    if transport == "two_step_int8":
        step = _two_step_int8_step(cfg, opt, lr, microbatches, mesh, seed, layout)
    elif mesh is None:
        step = _one_rank_step(cfg, opt, lr, microbatches)
    else:
        step = _data_parallel_step(cfg, opt, lr, microbatches, mesh, layout)
    step.grad_norm, step.layout = None, layout
    return step


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

    return train_step


def _data_parallel_step(cfg, opt, lr, microbatches, mesh, layout):
    """The gspmd step on a mesh: FSDP with ``layout``, else full replicas
    and the flat all-reduce."""
    names = mesh.mesh_dim_names
    client_group = axes_group(mesh, tuple(a for a in _CLIENT_AXES if a in names))
    pod_group = axes_group(mesh, ("pod",))

    def reduce(g, group, p):
        """One leaf's sum in f32, in the parameter's type at one
        micro-batch, else / microbatches: a leaf at a time, so the step
        never holds a second tree of f32 gradients."""
        s = all_reduce(g.float(), group)
        return s.to(p.dtype) if microbatches == 1 else s.div_(microbatches)

    def micro_grads(params, mb):
        def objective():
            tot, cnt, aux = _weighted_pieces(params, mb, cfg, client_group, layout)
            K = all_reduce(cnt.detach(), client_group).clamp_min(1e-6)
            loss = tot / K + transformer.aux_loss(cfg, aux)
            return loss, loss.detach()
        return _grads(params, objective)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        grads, losses = None, []
        for mb in _rank_micro_batches(batch, mesh, microbatches):
            g, loss = micro_grads(params, mb)
            grads = g if microbatches == 1 else _accumulate(grads, g)
            losses.append(loss)
            del g
        groups = (tree_map(lambda _: client_group, params) if layout is None
                  else layout.groups(pod_group, client_group))
        grads = tree_map(reduce, grads, groups, params)
        loss = all_reduce(torch.stack(losses), client_group).mean()
        train_step.grad_norm = grad_norm(grads) if layout is None else layout.grad_norm(grads)
        new_params, new_state = opt.update(params, grads, opt_state, lr)
        return new_params, new_state, loss

    return train_step


def _two_step_int8_step(cfg, opt, lr, microbatches, mesh, seed, layout):
    data_group = axes_group(mesh, ("data",))
    pod_group = axes_group(mesh, ("pod",))
    model_group = None if layout is None or layout.tp is None else layout.tp.group
    shards = fsdp_cut = tp_cut = None
    if layout is not None:
        fsdp_cut = flatten(tree_map(lambda pl: pl is not None, layout.places))
        tp_cut = flatten(tree_map(lambda pl: pl is not None, layout.tp_places))
        shards = flatten(layout.shards)

    def whole(x, place):
        """The shape of the leaf whose block (at ``place``) ``x`` is."""
        shape = list(x.shape)
        for pl in places_of(place):
            shape[pl.dim] *= pl.count
        return tuple(shape)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor],
                   noise: Optional[Noise] = None):
        grads, tot, cnt = None, 0.0, 0.0
        for mb in _rank_micro_batches(batch, mesh, microbatches, outer=("pod",)):
            def objective():
                t, c = unnormalized_loss_fn(params, mb, cfg, data_group, layout)
                return t, (t.detach(), c.detach())
            g, (t, c) = _grads(params, objective)
            grads = g if microbatches == 1 else _accumulate(grads, g)
            tot, cnt = tot + t, cnt + c
            del g
        leaves = flatten(grads)
        del grads
        tot, K = all_reduce(all_reduce(torch.stack([tot, cnt]), data_group), pod_group).unbind()
        K = K.clamp_min(1e-6)
        dev = leaves[0].device
        shapes = [whole(x, None if shards is None else shards[i]) for i, x in enumerate(leaves)]
        noises = uniform_noise(noise if noise is not None else _step_noise(seed, opt_state, dev),
                               shapes, dev)
        summed = []
        for i, x in enumerate(leaves):
            leaves[i] = None
            # the noise at the leaf's whole shape, a leaf at a time; the
            # rank's block of it goes with the rank's block of the gradient
            u = next(noises)
            if shards is not None:
                u = shard_or_replicate(u, shards[i])
            # the ONU step (a gradient FSDP holds whole over "data" is
            # reduce-scattered here, a shard's already was), then the CPS
            # hop: the rank's part crosses "pod" as int8 at the pod-summed
            # leaf's scale; normalised in place
            summed.append(int8_two_step_leaf(
                x, u, data_group, pod_group, model_group,
                data_summed=bool(fsdp_cut and fsdp_cut[i]),
                model_cut=bool(tp_cut and tp_cut[i])).div_(K))
            del u
        grads = unflatten(params, summed)
        train_step.grad_norm = grad_norm(grads) if layout is None else layout.grad_norm(grads)
        new_params, new_state = opt.update(params, grads, opt_state, lr)
        return new_params, new_state, tot / K

    return train_step


# ---------------------------------------------------------------------------
# abstract inputs of a cell (the dry run's)
# ---------------------------------------------------------------------------

_META = torch.device("meta")
INIT_TP = inspect.signature(transformer.init_params).parameters["tp"].default


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=_META)


def batch_struct(cfg: ModelConfig, shp: ShapeConfig, decode: bool = False):
    """The cell's global batch on ``meta``: tokens (or frames and labels),
    patches (media when decoding), decode positions or the FL
    ``client_weight``."""
    B = shp.global_batch
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


def serve_rows(mesh, B: int):
    """(first, last + 1) of the rows of a global batch of ``B`` this rank
    serves: its block over the client axes ("pod", "data"), every model
    rank of one coordinate the same; every row where B does not split over
    them (the reference's ``filter_valid_spec`` replicates the batch:
    ``long_500k``'s one row)."""
    r, R = client_index(mesh, [a for a in _CLIENT_AXES if a in mesh_shape(mesh)])
    return (0, B) if B % R else (r * B // R, (r + 1) * B // R)


def cache_struct_sharded(cfg: ModelConfig, shp: ShapeConfig,
                         mesh_shape: Optional[Dict[str, int]] = None,
                         rules: Optional[ShardingRules] = None):
    """The decode cache of the cell on ``meta`` (``transformer.init_cache``:
    the unit's stacked, the tail's; each attention layer's position a host
    int32), as rank 0 of ``mesh_shape`` holds it under ``rules``: its rows
    of the batch (:func:`serve_rows`), each attention layer's block by KV
    heads or by sequence (``layers.kv_block``, the reference's layout) and
    the recurrent states' channels or heads its compute reads. No mesh: the
    whole cache."""
    mesh_shape = dict(mesh_shape or {})
    mesh = AbstractMesh(mesh_shape) if math.prod(mesh_shape.values()) > 1 else None
    lo, hi = (0, shp.global_batch) if mesh is None else serve_rows(mesh, shp.global_batch)
    tp = TensorParallel.of(mesh, rules or ShardingRules())
    return transformer.init_cache(cfg, hi - lo, shp.seq_len, device=_META, tp=tp)


def _serving(cfg: ModelConfig, mesh, rules: Optional[ShardingRules]):
    """(the serve steps' parameter layout, a function taking (params,
    batch) to (the parameters as the model reads them, this rank's rows,
    the unit gather, the tensor-parallel region)). The layout is the
    train step's (:func:`param_layout`): FSDP shards under rules whose
    ``fsdp`` names a mesh axis, gathered a unit at a time inside the unit
    loop (the forward of ``core.aggregation.GatherShard``), the other
    leaves once a step; blocks over "model"."""
    layout = param_layout(cfg, mesh, rules)

    def inputs(params, batch):
        gather = tp = None
        if mesh is not None:
            lo, hi = serve_rows(mesh, next(iter(batch.values())).shape[0])
            batch = _rows(batch, lo, hi)
        if layout is not None:
            tp = layout.tp
            if layout.group is not None:
                params, gather = layout.gather_outer(params), layout.gather_unit
        return params, batch, gather, tp
    return layout, inputs


def make_prefill_step(cfg: ModelConfig, cache_len: int, mesh=None,
                      rules: Optional[ShardingRules] = None):
    """``prefill_step(params, batch) -> (logits, cache)``. On a mesh each
    rank takes the global batch and serves its rows (:func:`serve_rows`)
    from its shards of the parameters (``prefill_step.layout.shard`` cuts
    them from a full tree built with ``init_params(..., tp=<"model"
    size>)``); it returns its rows' logits, whole over the vocabulary,
    and its blocks of the cache (:func:`cache_struct_sharded`'s layout).
    Attention runs head-parallel on the flash kernel; under the sequence
    layout each rank keeps its slots of the K and V it computed."""
    layout, inputs = _serving(cfg, mesh, rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        params, batch, gather, tp = inputs(params, batch)
        return transformer.prefill(params, batch, cfg, cache_len, gather, tp)
    prefill_step.layout = layout
    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, rules: Optional[ShardingRules] = None):
    """``serve_step(params, batch, cache) -> (logits, cache)``: one decode
    position, the cache (this rank's blocks, as prefill left them) updated
    in place. On a mesh as :func:`make_prefill_step`; under the sequence
    layout the attention is the split-softmax decode
    (``layers.partial_decode_attention`` and its combine over "model")."""
    layout, inputs = _serving(cfg, mesh, rules)

    @torch.no_grad()
    def serve_step(params, batch, cache):
        params, batch, gather, tp = inputs(params, batch)
        return transformer.decode_step(params, batch, cache, cfg, gather, tp)
    serve_step.layout = layout
    return serve_step


def _meta_noise(shapes):
    return [_meta(s, torch.float32) for s in shapes]


def input_specs(cfg: ModelConfig, shp: ShapeConfig, mesh_shape: Optional[Dict[str, int]] = None,
                rules: Optional[ShardingRules] = None, opt_name: str = "adamw",
                microbatches: int = 1, transport: str = "gspmd"):
    """Everything the dry run needs for one cell: (fn, args), the args on
    ``meta``. ``mesh_shape`` ({axis: size}; None or one rank: one card)
    becomes an ``AbstractMesh`` the step runs over as its rank 0, its
    collectives reckoned. A serving cell's rank takes the global batch and
    serves its rows from its shards, with its blocks of the cache."""
    mesh_shape = dict(mesh_shape or {})
    n_ranks = math.prod(mesh_shape.values()) if mesh_shape else 1
    mesh = AbstractMesh(mesh_shape) if n_ranks > 1 else None
    params, _ = param_shardings(cfg, mesh_shape, rules)
    if shp.kind == "train":
        step = make_train_step(cfg, opt_name, microbatches=microbatches, transport=transport,
                               mesh=mesh, rules=rules)
        if step.layout is not None:
            params = step.layout.shard(params)
        fn = step
        if transport == "two_step_int8":
            def fn(params, opt_state, batch):
                return step(params, opt_state, batch, noise=_meta_noise)
        return fn, (params, opt_state_struct(opt_name, params), batch_struct(cfg, shp))
    if shp.kind == "prefill":
        step = make_prefill_step(cfg, shp.seq_len, mesh, rules)
        batch = batch_struct(cfg, shp)
        batch.pop("client_weight")
        args = (batch,)
    elif shp.kind == "decode":
        step = make_serve_step(cfg, mesh, rules)
        args = (batch_struct(cfg, shp, decode=True),
                cache_struct_sharded(cfg, shp, mesh_shape, rules))
    else:
        raise ValueError(shp.kind)
    if step.layout is not None:
        params = step.layout.shard(params)
    return step, (params, *args)
