"""The LM train step on one card — port of ``repro/launch/specs.py``'s
``weighted_loss_fn``, ``unnormalized_loss_fn`` and ``make_train_step``
(the MoE load-balance term included), without the mesh: the reference's
sharding rules and its collective schedules have no single-card
counterpart (ROADMAP.md Queue 1, item 1b).
"""
from __future__ import annotations

from typing import Dict

import torch

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


def make_train_step(cfg: ModelConfig, opt_name: str = "adamw", lr: float = 1e-4,
                    microbatches: int = 1, transport: str = "gspmd"):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    loss)``.

    ``microbatches > 1`` splits the batch rows into that many slices and
    accumulates their gradients in f32, then divides by ``microbatches``;
    the loss is the slices' mean and the optimizer runs once. The step
    keeps the last gradient's global norm in ``train_step.grad_norm`` (a
    0-d f32 tensor on the card). ``transport="two_step_int8"`` (the int8
    cross-pod hop) needs a mesh: ROADMAP.md Queue 1, item 1b.
    """
    if transport == "two_step_int8":
        raise NotImplementedError(
            "transport='two_step_int8' (the int8 cross-pod reduce) needs torch.distributed: "
            "ROADMAP.md Queue 1, item 1b")
    if transport != "gspmd":
        raise ValueError(f"unknown transport {transport!r}")
    opt = make_optimizer(opt_name)

    def grads_and_loss(params, batch):
        leaves = list(_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, _ = weighted_loss_fn(params, batch, cfg)
            grads = iter(torch.autograd.grad(loss, leaves))
        finally:
            for t in leaves:
                t.requires_grad_(False)
        return tree_map(lambda _: next(grads), params), loss.detach()

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            grads, loss = grads_and_loss(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
            n = B // microbatches
            grads, losses = None, []
            for i in range(microbatches):
                g, loss = grads_and_loss(params, {k: v[i * n:(i + 1) * n]
                                                  for k, v in batch.items()})
                grads = (tree_map(lambda x: x.float(), g) if grads is None
                         else tree_map(lambda a, x: a + x.float(), grads, g))
                losses.append(loss)
                del g
            grads = tree_map(lambda a: a / microbatches, grads)
            loss = torch.stack(losses).mean()
        train_step.grad_norm = grad_norm(grads)
        new_params, new_state = opt.update(params, grads, opt_state, lr)
        return new_params, new_state, loss

    train_step.grad_norm = None
    return train_step

