"""Update compression for the constrained uplink — port of
``repro.core.compression`` (the per-row forms the FL round runs).

The paper keeps upstream traffic constant through topology (one θ per
ONU); compression multiplies that saving: int8/int4 stochastic rounding
(unbiased) and magnitude top-k shrink every uploaded θ or client δ, with
optional error feedback (EF) carrying what was not sent into the next
round. Three layers, as in the reference:

  * wire accounting — :func:`compressed_bytes` is the wire-size oracle and
    :meth:`CompressionSpec.wire_scale` scales the ``model_mbits`` the PON
    transport bills, so involvement under the deadline and the Mbits
    billed both see the compressed payload;
  * the per-row math — :func:`quantize_rows`, :func:`dequantize_rows` and
    :func:`topk_rows` over a stacked leaf (one row per ONU θ or client δ);
    each goes through its kernel wrapper in ``repro_torch.kernels``, so a
    CUDA tensor launches the hand-written kernel and a CPU tensor runs
    the plain version, bit-identical to the reference given the same noise;
  * :class:`CompressionState` — the backend-owned EF residuals and the
    stochastic-rounding noise stream.

Noise: ``jax.random`` becomes a ``torch.Generator`` that the state owns,
seeded explicitly, on the state's device. The reference's call counter is
kept exactly (it advances once per ``roundtrip``/``roundtrip_clients``
call for int8/int4, never for top-k), and every uniform number of one
call is drawn by :meth:`CompressionState.uniform_noise`, which takes the
leaf shapes in the reference's leaf order (sorted keys, as
``jax.tree.flatten`` orders a dict) — the one method to override to feed
other noise. The per-leaf API (:func:`quantize_tree`,
:func:`dequantize_tree`, :func:`compress_with_error_feedback`), one scale
per leaf of a nested tree, is the one-row case of the same kernel
wrappers; its noise (:func:`uniform_noise`) comes from an explicit
``torch.Generator`` or an injected ``uniform_noise(shapes)``, leaf by leaf
in the reference's order, and the collective forms of
``core.aggregation`` and ``launch.specs`` draw theirs the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common.tree import flatten, unflatten
from repro_torch.kernels.agg_reduce import segment_agg_reduce, segment_agg_reduce_quant
from repro_torch.kernels.quantize import (dequantize_rows as _dequantize_kernel,
                                          qmax_of, quantize_rows as _quantize_kernel,
                                          topk_k, topk_mask_rows, topk_thresholds)

Tree = Dict[str, torch.Tensor]
# U[0, 1) noise for a stochastic rounding: a generator to draw from, or a
# callable shapes -> one f32 tensor per shape (the reference's noise fed in)
Noise = Union[torch.Generator, Callable[[Sequence[Tuple[int, ...]]], Sequence[torch.Tensor]]]

SCHEMES = ("none", "int8", "int4", "topk")

# top-k wire format: each kept element ships a f32 value + an int32 index
_VALUE_BYTES = 4
_INDEX_BYTES = 4
# per-leaf header for the quantized formats: one f32 scale
_SCALE_BYTES = 4

_qmax = qmax_of


def scheme_bits(scheme: str) -> int:
    """Quantized-payload width per element (quantizing schemes only)."""
    return {"int8": 8, "int4": 4}[scheme]


def _numel(x) -> int:
    return int(math.prod(x.shape))


# ---------------------------------------------------------------------------
# wire-format accounting — the single wire-size oracle
# ---------------------------------------------------------------------------

def raw_bytes(tree: Tree) -> int:
    """Uncompressed f32 wire size (the ``--compress none`` baseline)."""
    return 4 * sum(_numel(x) for x in flatten(tree))


def compressed_bytes(tree: Tree, scheme: str = "int8", *,
                     topk_frac: float = 0.01) -> int:
    """Wire size of ``tree`` under ``scheme``, per leaf: ``none`` 4 bytes an
    element; ``int8`` 1 byte an element + one f32 scale; ``int4`` two
    elements a byte (odd counts round up) + one f32 scale; ``topk``
    ``ceil(topk_frac · n)`` kept elements, each a f32 value + an int32
    index."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown compression scheme {scheme!r}; "
                         f"expected one of {SCHEMES}")
    total = 0
    for x in flatten(tree):
        n = _numel(x)
        if scheme == "none":
            total += 4 * n
        elif scheme == "int8":
            total += n + _SCALE_BYTES
        elif scheme == "int4":
            total += (n + 1) // 2 + _SCALE_BYTES
        else:                                   # topk
            k = min(n, math.ceil(topk_frac * n)) if n else 0
            total += k * (_VALUE_BYTES + _INDEX_BYTES)
    return int(total)


def init_residual(tree: Tree, dtype: torch.dtype = torch.float32) -> Tree:
    """Zero EF residual matching ``tree``'s structure, shapes and device
    (f32 by default: the residual accumulates sub-step corrections that
    bf16 would lose)."""
    return unflatten(tree, [torch.zeros(x.shape, dtype=dtype, device=x.device)
                            for x in flatten(tree)])


# ---------------------------------------------------------------------------
# per-row forms over a stacked leaf (R, ...): one row per ONU θ / client δ
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def row_scales(x: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, ...) -> (R,) f32 scales max(max|x_r|, 1e-12) / qmax."""
    return _rows(x.float()).abs().amax(dim=1).clamp_min(1e-12) / _qmax(bits)


def quantize_rows(x: torch.Tensor, noise: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row stochastic-rounding quantization of a stacked leaf.

    x: (R, ...), noise: U[0, 1) of x's shape -> (q int8 of x's shape,
    scales (R,) f32). Each row gets its own scale — one ONU's θ must not
    inherit another's dynamic range. ``noise`` replaces the reference's
    ``key``.
    """
    scales = row_scales(x, bits)
    q = _quantize_kernel(_rows(x), _rows(noise), scales, _qmax(bits))
    return q.reshape(x.shape), scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor,
                    row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(float(q) · s_r), times the row mask m_r when one is given (the
    reference applies the mask after dequantizing; same order here)."""
    return _dequantize_kernel(_rows(q), scales, row_mask).reshape(q.shape)


def topk_rows(x: torch.Tensor, frac: float,
              row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row magnitude top-k of a stacked leaf (dense output: kept values
    in place, the rest zero), times the row mask when one is given.

    Keeps ``k = ceil(frac · n)`` elements per row through the k-th largest
    |value| threshold; ties at the threshold are all kept (the wire bills
    exactly k).
    """
    flat = _rows(x)
    thresh = topk_thresholds(flat, topk_k(flat.shape[1], frac))
    return topk_mask_rows(flat, thresh, row_mask).reshape(x.shape)


# ---------------------------------------------------------------------------
# per-leaf forms over a nested tree: one scale per leaf, each the one-row
# call of the row kernels
# ---------------------------------------------------------------------------

def uniform_noise(noise: Optional[Noise], shapes: Sequence[Tuple[int, ...]],
                  device) -> Iterator[torch.Tensor]:
    """U[0, 1) f32 noise on ``device``, one tensor per shape in the order
    given: drawn from ``noise`` when it is a ``torch.Generator`` (lazily, a
    leaf at a time), else ``noise(shapes)`` (the reference's own noise, fed
    in). Ranks that must draw the same noise hold generators seeded alike.
    None raises: a fixed default would repeat the same rounding every
    call and bias the sum."""
    if noise is None:
        raise ValueError("stochastic rounding needs explicit noise: a torch.Generator "
                         "seeded per call, or a uniform_noise(shapes) callable")
    if isinstance(noise, torch.Generator):
        for s in shapes:
            yield torch.rand(tuple(s), generator=noise, dtype=torch.float32,
                             device=noise.device).to(device)
        return
    for s, u in zip(shapes, noise(shapes), strict=True):
        u = torch.as_tensor(u, dtype=torch.float32, device=device)
        if tuple(u.shape) != tuple(s):
            raise ValueError(f"noise of shape {tuple(u.shape)} for a leaf of {tuple(s)}")
        yield u


def quantize_leaf(x: torch.Tensor, noise: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf at one scale, max(max|x|, 1e-12) / qmax: (q int8 of x's
    shape, 0-d f32 scale), through the quantize kernel's wrapper."""
    q, s = quantize_rows(x.reshape(1, -1), noise.reshape(1, -1), bits)
    return q.reshape(x.shape), s[0]


def quantize_tree(tree, noise: Optional[Noise], bits: int = 8):
    """Unbiased per-leaf stochastic-rounding quantization (int8 or int4):
    (a tree of int8 — int4 values unpacked in [-7, 7] — and a tree of 0-d
    f32 scales). Noise is drawn leaf by leaf in the reference's order
    (sorted keys). An empty tree short-circuits, needing no noise."""
    leaves = flatten(tree)
    if not leaves:
        return unflatten(tree, []), unflatten(tree, [])
    dev = leaves[0].device
    out = [quantize_leaf(x, u, bits) for x, u in
           zip(leaves, uniform_noise(noise, [tuple(x.shape) for x in leaves], dev))]
    return unflatten(tree, [q for q, _ in out]), unflatten(tree, [s for _, s in out])


def dequantize_tree(qtree, scales):
    """float(q) · s leaf by leaf, through the dequantize kernel's wrapper."""
    return unflatten(qtree, [dequantize_rows(q.reshape(1, -1), s.reshape(1)).reshape(q.shape)
                             for q, s in zip(flatten(qtree), flatten(scales), strict=True)])


def compress_with_error_feedback(tree, err, noise: Optional[Noise], bits: int = 8):
    """EF-SGD style: quantize (tree + err); the residual becomes the new
    err. ``err=None`` starts from :func:`init_residual`. Returns (qtree,
    scales, new_err); an empty tree short-circuits."""
    if not flatten(tree):
        empty = unflatten(tree, [])
        return empty, empty, (err if err is not None else empty)
    if err is None:
        err = init_residual(tree)
    corrected = unflatten(tree, [x.float() + e for x, e in
                                 zip(flatten(tree), flatten(err), strict=True)])
    q, s = quantize_tree(corrected, noise, bits)
    deq = dequantize_tree(q, s)
    new_err = unflatten(tree, [c - d for c, d in
                               zip(flatten(corrected), flatten(deq), strict=True)])
    return q, s, new_err


# ---------------------------------------------------------------------------
# the composable spec + backend-owned state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """What crosses the wire: scheme + knobs (hashable, strategy-carried)."""

    scheme: str = "none"            # none | int8 | int4 | topk
    topk_frac: float = 0.01
    error_feedback: bool = False

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown compression scheme {self.scheme!r}; "
                             f"expected one of {SCHEMES}")
        if self.scheme == "topk" and not (0.0 < self.topk_frac <= 1.0):
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac}")

    @property
    def active(self) -> bool:
        return self.scheme != "none"

    def wire_scale(self, tree: Optional[Tree] = None) -> float:
        """Compressed ÷ raw-f32 bulk-payload size — what scales the
        ``model_mbits`` the transport bills. Quantized schemes bill exactly
        ``bits/32`` (the per-leaf scales ride the control plane); top-k is
        exact from the tree when one is given, nominal ``2·frac``
        otherwise."""
        if not self.active:
            return 1.0
        if self.scheme == "topk":
            if tree:
                return (compressed_bytes(tree, "topk", topk_frac=self.topk_frac)
                        / raw_bytes(tree))
            return self.topk_frac * (_VALUE_BYTES + _INDEX_BYTES) / 4.0
        return scheme_bits(self.scheme) / 32.0

    def roundtrip_rows_leaf(self, x: torch.Tensor, noise: Optional[torch.Tensor],
                            err: Optional[torch.Tensor] = None,
                            row_mask: Optional[torch.Tensor] = None):
        """One stacked leaf through compress → decompress (+EF).

        ``noise`` (U[0, 1) of x's shape) is read by int8/int4 only. Rows
        where ``row_mask`` (R,) f32 is 0 transmit nothing: the output row is
        zero and the residual row is carried unchanged. Returns
        ``(x_hat, new_err)`` (``new_err`` is None when EF is off).
        """
        xf = x.float()
        corrected = xf + err if err is not None else xf
        if self.scheme == "topk":
            sent = topk_rows(corrected, self.topk_frac, row_mask)
        else:
            q, s = quantize_rows(corrected, noise, scheme_bits(self.scheme))
            sent = dequantize_rows(q, s, row_mask)
        new_err = None
        if err is not None:
            new_err = corrected - sent
            if row_mask is not None:
                # silent rows keep their residual untouched
                m = row_mask.reshape((-1,) + (1,) * (x.ndim - 1))
                new_err = torch.where(m > 0, new_err, err)
        return sent, new_err


def _mask_tensor(row_mask, device) -> Optional[torch.Tensor]:
    if row_mask is None:
        return None
    return torch.as_tensor(np.asarray(row_mask, np.float32), device=device)


class CompressionState:
    """Backend-owned compression context: EF residuals + the noise stream.

    One instance lives for the whole run (created by the backend when its
    strategy's spec is active). It owns

      * the stochastic-rounding noise: a ``torch.Generator`` seeded with
        ``seed`` on ``device``, plus the reference's call counter
        (:meth:`next_key`), so ``--compress none`` leaves the driver's
        numpy stream untouched;
      * per-tier EF residuals ("theta": one stacked tree whose rows are the
        global ONU ids), created at the first call with f32 dtype;
      * per-client EF residuals (classical transport: the stacked row order
        changes every round, so rows are keyed by global client id).
    """

    def __init__(self, spec: CompressionSpec, seed: int = 0,
                 device: str | torch.device = "cpu"):
        self.spec = spec
        self.seed = seed
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._calls = 0
        self._tier_err: Dict[str, Tree] = {}
        self._client_err: Dict[int, Tree] = {}

    @property
    def active(self) -> bool:
        return self.spec.active

    def next_key(self) -> int:
        """Advance the call counter (the reference folds it into its key)."""
        self._calls += 1
        return self._calls

    def uniform_noise(self, call: int, shapes: Sequence[Tuple[int, ...]]
                      ) -> List[torch.Tensor]:
        """U[0, 1) f32 noise for roundtrip call number ``call``: one tensor
        per leaf shape, in the order given (the reference's leaf order), on
        the state's device. Override to feed other noise."""
        return [torch.rand(tuple(s), generator=self._gen, dtype=torch.float32,
                           device=self.device) for s in shapes]

    def _noise(self, shapes) -> List[Optional[torch.Tensor]]:
        if self.spec.scheme == "topk":
            return [None] * len(shapes)
        return self.uniform_noise(self.next_key(), shapes)

    def _roundtrip_leaves(self, tree: Tree, err: Optional[Tree], row_mask
                          ) -> Tuple[Tree, Tree]:
        names = sorted(tree)          # the reference's leaf order
        mask = _mask_tensor(row_mask, next(iter(tree.values())).device)
        noises = self._noise([tuple(tree[k].shape) for k in names])
        outs, errs = {}, {}
        for k, u in zip(names, noises):
            outs[k], errs[k] = self.spec.roundtrip_rows_leaf(
                tree[k], u, err=None if err is None else err[k], row_mask=mask)
        return {k: outs[k] for k in tree}, errs

    def roundtrip(self, tier: str, tree: Tree, row_mask=None) -> Tree:
        """A stacked tier tree (leading axis = stable row identity) through
        compress → decompress, updating the tier's EF residual."""
        if not self.active or not tree:
            return tree
        err = self._tier_err.get(tier)
        if err is None and self.spec.error_feedback:
            err = init_residual(tree)
        out, errs = self._roundtrip_leaves(tree, err, row_mask)
        if self.spec.error_feedback:
            self._tier_err[tier] = errs
        return out

    def roundtrip_segments(self, tier: str, client_tree: Tree, wm: torch.Tensor,
                           seg_ids, n_seg: int, row_mask=None) -> Tree:
        """θ_s = Σ_{c ∈ s} wm_c · x_c for every leaf, through
        :meth:`roundtrip` — the same result and the same noise call.

        Without EF, int8/int4 go through the fused aggregate + quantize
        kernel, so θ is quantized as it is aggregated; with EF (θ + the
        residual is what gets quantized) or top-k, θ is aggregated by
        ``segment_agg_reduce`` first.
        """
        spec = self.spec
        if not (self.active and spec.scheme in ("int8", "int4")
                and not spec.error_feedback and client_tree):
            thetas = {k: segment_agg_reduce(_rows(x), wm, seg_ids, n_seg)
                      .reshape((n_seg,) + tuple(x.shape[1:]))
                      for k, x in client_tree.items()}
            return self.roundtrip(tier, thetas, row_mask)
        names = sorted(client_tree)
        mask = _mask_tensor(row_mask, wm.device)
        noises = self._noise([(n_seg,) + tuple(client_tree[k].shape[1:])
                              for k in names])
        out = {}
        for k, u in zip(names, noises):
            x = client_tree[k]
            q, s = segment_agg_reduce_quant(_rows(x), wm, seg_ids, n_seg, _rows(u),
                                            scheme_bits(spec.scheme))
            out[k] = _dequantize_kernel(q, s, mask).reshape(u.shape)
        return {k: out[k] for k in client_tree}

    def roundtrip_clients(self, client_ids, tree: Tree, row_mask=None) -> Tree:
        """Classical transport: per-client rows keyed by global client id
        (residuals gathered before, scattered after, for involved rows)."""
        if not self.active or not tree or len(client_ids) == 0:
            return tree
        err = None
        if self.spec.error_feedback:
            rows = [self._client_err.get(int(c)) for c in client_ids]
            err = {k: torch.stack([r[k] if r is not None else
                                   torch.zeros(x.shape[1:], dtype=torch.float32,
                                               device=x.device) for r in rows])
                   for k, x in tree.items()}
        out, errs = self._roundtrip_leaves(tree, err, row_mask)
        if self.spec.error_feedback:
            m = (np.asarray(row_mask) > 0 if row_mask is not None
                 else np.ones(len(client_ids), bool))
            for i, cid in enumerate(client_ids):
                if m[i]:
                    # a copy, so the stacked round tensor can be freed
                    self._client_err[int(cid)] = {k: e[i].clone()
                                                  for k, e in errs.items()}
        return out
