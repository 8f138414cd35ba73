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
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.sharding import ShardingRules, reduce_schedule
from repro_torch.common.tree import flatten, unflatten
from repro_torch.core.aggregation import (all_reduce, classical_allreduce, int8_pod_sum,
                                          two_step_allreduce)
from repro_torch.core.compression import Noise, uniform_noise
from repro_torch.launch.mesh import axes_group, client_index, mesh_shape, size
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
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
    the leaves require grad only for the call."""
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    try:
        out, extra = objective()
        grads = iter(torch.autograd.grad(out, leaves))
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
      gradients of ``unnormalized_loss_fn``, summed over "data" (the ONU
      step, in f32); each pod-summed leaf crosses "pod" as int8 at one
      scale per leaf (``core.aggregation.int8_pod_sum``), with noise drawn
      leaf by leaf (sorted keys) from ``noise`` or, by default, from
      (``seed``, ``opt_state["t"]``), alike on every pod; then
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
        raise NotImplementedError(
            "MoE on more than one rank: the router's load-balance loss and capacity drops "
            "are functions of the whole batch, which data-parallel ranks do not see; "
            "ROADMAP.md Queue 1 item 1e")
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
            # the ONU step (the pod's sum over "data", f32), then the CPS hop:
            # the pod's sum crosses "pod" as int8, one scale a leaf
            summed.append(int8_pod_sum(all_reduce(x.float(), data_group), next(noises),
                                       pod_group))
        tot, K = all_reduce(tot_cnt, pod_group).unbind()
        K = K.clamp_min(1e-6)
        grads = unflatten(params, [g / K for g in summed])
        train_step.grad_norm = grad_norm(grads)
        new_params, new_state = opt.update(params, grads, opt_state, lr)
        return new_params, new_state, tot / K

    train_step.grad_norm = None
    return train_step
