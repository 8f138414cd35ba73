"""Tensor and expert parallelism over the mesh's "model" axis — the port's
explicit form of what GSPMD derives for the reference's rules
``tensor="model"`` and ``expert="model"`` (``repro/common/sharding.py``).

Every model rank takes the same rows (the batch is split over "pod" and
"data" only), so activations outside the region are alike on every model
rank, and so is the loss: each rank differentiates its own copy once. A
block whose weights are split over "model" (attention heads, MLP and
RG-LRU channels, RWKV6 heads, MoE experts, the vocabulary) is a region:

* it enters through :meth:`TensorParallel.copy` (identity forward, the
  gradient all-reduced over "model" backward): column-parallel products
  of the rank's block give a partial gradient of their input;
* it leaves through :meth:`TensorParallel.reduce` (all-reduce forward,
  identity backward): the row-parallel product's partial sums;
* :meth:`TensorParallel.gather` joins blocks along a dimension (all-gather
  forward, the rank's slice backward: the embedding's columns, a frame
  or patch projection's), where every rank's gradient is already whole;
* :meth:`TensorParallel.rows_of_columns` reads a table held by columns
  as this rank's block of rows (the tied head: all-gather forward, a
  reduce-scatter of the disjoint row blocks' gradients backward);
* :meth:`TensorParallel.vocab_xent` is the cross entropy of vocab-split
  logits: the max all-reduced outside the gradient, Σ exp and the gold
  logit all-reduced, labels outside the rank's block contributing 0; its
  gradient on a rank is softmax_local − onehot_local.

A tensor computed from replicated parameters (the K and V of replicated KV
heads, the router's combine weights, RWKV6's data-dependent mixes) is
computed before the region and enters through ``copy``, so autograd sums
its parameters' partial gradients once and every parameter's gradient is
whole on every rank: the train step reduces gradients over "pod" and
"data" only, among the ranks of one "model" coordinate.

A rank whose block holds no real head (the padding of ``pad_to_multiple``)
launches no kernel; :meth:`TensorParallel.anchor` keeps the region's
inputs in its graph with zero gradients, so every rank runs the same
collectives in the backward. Collectives report their bytes under the
axis "model" to a cost counter, as the "data" and "pod" ones do
(``core.aggregation``); on a mesh whose "model" axis has size 1 each acts
on a group of one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.common.sharding import MODEL_AXIS, model_parallel, pad_to_multiple
from repro_torch.core.aggregation import all_reduce, gather_dim, scatter_dim
from repro_torch.launch.mesh import axes_group, client_index, mesh_shape


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None


class _RowsOfColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, group, index, size):
        ctx.group, ctx.index, ctx.size = group, index, size
        full = gather_dim(table, 1, group)
        ctx.rows = full.shape[0] // size
        return full.narrow(0, index * ctx.rows, ctx.rows).contiguous()

    @staticmethod
    def backward(ctx, grad):
        full = grad.new_zeros((ctx.rows * ctx.size,) + tuple(grad.shape[1:]))
        full.narrow(0, ctx.index * ctx.rows, ctx.rows).copy_(grad)
        return scatter_dim(full, 1, ctx.group), None, None, None


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *inputs):
        ctx.like = [(t.shape, t.dtype, t.device) for t in inputs]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.like))


class TensorParallel:
    """This rank's place on the "model" axis: its ``group``, the axis's
    ``size`` and the rank's ``index`` on it, and whether the heads / MLP /
    vocabulary (``tensor``) and the MoE experts (``expert``) are split over
    it. A dimension is split where ``size`` divides it, as
    ``filter_valid_spec`` decides; a block whose dimension does not split
    runs whole on every rank, outside any region."""

    def __init__(self, group, size: int, index: int, tensor: bool = True,
                 expert: bool = True):
        self.group, self.size, self.index = group, size, index
        self.tensor, self.expert = tensor, expert

    @classmethod
    def of(cls, mesh, rules) -> Optional["TensorParallel"]:
        """The mesh's "model" region under ``rules``, or None where the
        mesh has no "model" axis or the rules put nothing on it."""
        if mesh is None:
            return None
        shape = mesh_shape(mesh)
        tensor, expert = model_parallel(rules, shape)
        if not (tensor or expert):
            return None
        return cls(axes_group(mesh, (MODEL_AXIS,)), shape[MODEL_AXIS],
                   client_index(mesh, (MODEL_AXIS,))[0], tensor, expert)

    # -- which blocks split --------------------------------------------------
    def splits(self, n: int) -> bool:
        """Whether a tensor-parallel dimension of extent ``n`` splits."""
        return self.tensor and n % self.size == 0

    def splits_experts(self, n_experts: int) -> bool:
        return self.expert and n_experts % self.size == 0

    def splits_heads(self, cfg) -> bool:
        """Whether attention's query heads split: the heads padded to the
        axis's size (``attn_params`` built with tp = size) divide it."""
        H = cfg.n_heads
        return self.splits(pad_to_multiple(H, self.size) if cfg.tp_pad_heads else H)

    def splits_kv(self, cfg) -> bool:
        """Whether K and V split with the query heads (logical "heads":
        MHA whose heads divide the axis), else they are replicated
        ("kv_heads")."""
        H, KV = cfg.n_heads, cfg.n_kv_heads
        Hp = pad_to_multiple(H, self.size) if cfg.tp_pad_heads else H
        return self.tensor and cfg.shard_kv_mha and KV == H == Hp and H % self.size == 0

    def vocab_parallel(self, cfg) -> bool:
        """Whether the head's logits split over the vocabulary: the untied
        head's V columns split, or the tied table's d columns and V rows."""
        V = cfg.vocab_size
        if cfg.tie_embeddings:
            return self.splits(cfg.d_model) and self.splits(V)
        return self.splits(V)

    # -- the region's collectives --------------------------------------------
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Enter the region: identity forward, all-reduce backward."""
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Leave the region: all-reduce forward, identity backward."""
        return _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks joined along ``dim``: all-gather forward, this
        rank's slice backward."""
        return _Gather.apply(x, dim % x.dim(), self.group, self.index)

    def rows_of_columns(self, table: torch.Tensor) -> torch.Tensor:
        """A (V, d / size) table held by columns read as this rank's
        (V / size, d) block of rows: all-gather forward; backward, the
        ranks' row-block gradients summed onto each one's columns
        (reduce-scatter)."""
        return _RowsOfColumns.apply(table, self.group, self.index, self.size)

    def anchor(self, out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
        """``out`` (a rank's zeros, where its block holds only padding)
        with ``inputs`` kept in the graph at zero gradient, so the region's
        backward collectives run on this rank too."""
        return _Anchor.apply(out, *inputs)

    def vocab_xent(self, logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
        """``transformer._xent`` of logits split over the vocabulary (this
        rank's block of ``logits.shape[-1]`` columns): (Σ nll·mask, Σ mask)
        in f32, alike on every model rank."""
        logits = logits.float()
        Vl = logits.shape[-1]
        m = all_reduce(logits.amax(-1, keepdim=True).detach(), self.group,
                       op=dist.ReduceOp.MAX)
        lse = torch.log(self.reduce(torch.exp(logits - m).sum(-1))) + m[..., 0]
        local = labels.long() - self.index * Vl
        inside = (local >= 0) & (local < Vl)
        gold = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
        gold = self.reduce(torch.where(inside, gold, torch.zeros_like(gold)))
        return ((lse - gold) * mask).sum(), mask.sum()
