"""Optimizers of the port, written by hand — a copy of
``repro/optim/optimizers.py`` on PyTorch tensors (``torch.optim`` is not
used): SGD (with momentum), AdamW, Yogi and the cosine schedule.

Parameters, gradients and states are nested dicts of tensors. A state
keeps the reference's layout: ``{}`` (SGD) or ``{"mu": tree}`` (SGD with
momentum), ``{"m": tree, "v": tree, "t": 0-d int32}`` (AdamW, Yogi), the
moments in f32 on the parameters' device. Each update computes in f32 and
casts back to the parameter's type, and returns new trees (nothing is
updated in place). The defaults are the reference's, not
``torch.optim``'s: AdamW b2 = 0.95, eps = 1e-8, no weight decay; Yogi
b2 = 0.99, eps = 1e-3.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def tree_map(fn, *trees):
    """``fn`` leaf by leaf over nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _split(out, n: int):
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda o, i=i: o[i], out) if isinstance(out, dict) else out[i]
                 for i in range(n))


def cosine_lr(base: float, warmup: int, total: int):
    """Linear warm-up to ``base`` over ``warmup`` steps, then a cosine to 0
    at ``total``; computed in f32 as the reference does."""
    def lr(step) -> float:
        f32 = torch.float32
        step = torch.as_tensor(step, dtype=f32)
        warm = base * step / max(1.0, warmup)
        prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = base * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return float(torch.where(step < warmup, warm, cos))
    return lr


def _zeros_f32(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)


# --- SGD ----------------------------------------------------------------

def sgd_init(params, momentum: float = 0.0):
    return {"mu": _zeros_f32(params)} if momentum else {}


def sgd_update(params, grads, state, lr, momentum: float = 0.0, weight_decay: float = 0.0):
    def upd(p, g, m=None):
        gf = g.float()
        if weight_decay:
            gf = gf + weight_decay * p.float()
        if momentum:
            m = momentum * m + gf
            gf = m
        return (p.float() - lr * gf).to(p.dtype), m
    if momentum:
        new_p, new_m = _split(tree_map(upd, params, grads, state["mu"]), 2)
        return new_p, {"mu": new_m}
    return tree_map(lambda p, g: upd(p, g)[0], params, grads), state


# --- AdamW and Yogi -----------------------------------------------------

def adamw_init(params):
    t = torch.zeros((), dtype=torch.int32, device=_first_leaf(params).device)
    return {"m": _zeros_f32(params), "v": _zeros_f32(params), "t": t}


def _adaptive_update(params, grads, state, lr, b1, b2, eps, weight_decay, second_moment):
    t = state["t"] + 1
    bc1 = 1.0 - b1 ** t.float()
    bc2 = 1.0 - b2 ** t.float()

    def upd(p, g, m, v):
        gf = g.float()
        m = b1 * m + (1 - b1) * gf
        v = second_moment(v, gf)
        step = (m / bc1) / (torch.sqrt(v.clamp_min(0.0) / bc2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m, v

    new_p, new_m, new_v = _split(tree_map(upd, params, grads, state["m"], state["v"]), 3)
    return new_p, {"m": new_m, "v": new_v, "t": t}


def adamw_update(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay: float = 0.0):
    # v is never negative here, so the clamp in _adaptive_update changes nothing
    return _adaptive_update(params, grads, state, lr, b1, b2, eps, weight_decay,
                            lambda v, gf: b2 * v + (1 - b2) * torch.square(gf))


def yogi_init(params):
    return adamw_init(params)


def yogi_update(params, grads, state, lr, b1=0.9, b2=0.99, eps=1e-3,
                weight_decay: float = 0.0):
    """Yogi (Zaheer et al. 2018): Adam with the additive second moment
    v ← v − (1−b2)·sign(v − g²)·g², which may shrink."""
    def second(v, gf):
        g2 = torch.square(gf)
        return v - (1 - b2) * torch.sign(v - g2) * g2
    return _adaptive_update(params, grads, state, lr, b1, b2, eps, weight_decay, second)


# --- dispatcher ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable    # (params, grads, state, lr) -> (params, state)


def make_optimizer(name: str, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return Optimizer("sgd", lambda p: sgd_init(p, 0.0),
                         lambda p, g, s, lr: sgd_update(p, g, s, lr, 0.0, weight_decay))
    if name == "sgdm":
        return Optimizer("sgdm", lambda p: sgd_init(p, momentum),
                         lambda p, g, s, lr: sgd_update(p, g, s, lr, momentum, weight_decay))
    if name == "adamw":
        return Optimizer("adamw", adamw_init,
                         lambda p, g, s, lr: adamw_update(p, g, s, lr,
                                                          weight_decay=weight_decay))
    if name == "yogi":
        return Optimizer("yogi", yogi_init,
                         lambda p, g, s, lr: yogi_update(p, g, s, lr, weight_decay=weight_decay))
    raise ValueError(name)
