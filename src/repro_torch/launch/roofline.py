"""The port's cost count and roofline terms — the counterpart of
``repro/launch/roofline.py``.

Per cell (seconds, per device):

    compute    = Σ_type flops[type] / hw.PEAK_FLOPS[type]
    memory     = bytes / hw.HBM_BW
    collective = Σ_axis axis_bytes / the axis's link (InfiniBand for the
                 cross-pod "pod" hop, NVLink for the others)

The reference asks XLA: ``cost_analysis`` of the compiled step for flops
and "bytes accessed", its HLO text for the collectives. The port has no
compiler to ask, so it counts what eager PyTorch runs. :class:`Counter` is
a ``TorchDispatchMode`` that adds up, for every aten operator:

* its flops by type, from ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention), typed by the inputs' dtype (an f32
  product is "tf32" only where ``torch.backends.cuda.matmul.allow_tf32``);
* its bytes in and out: each tensor operand read once, each output
  written once. A view, or an output that shares its input's storage,
  moves nothing; nor does an ``empty``, nor a copy between devices (a host
  constant to the card crosses PCIe). This is the unfused count, the
  analogue of XLA's "bytes accessed"; ``by_op`` keeps it per operator;
* the peak of the storages it creates that are alive at once (keyed by
  ``untyped_storage()._cdata``, which a view shares);

and, from the kernel wrappers and the collectives (``kernels.cost``), what
they report: the port's kernels are ctypes libraries that no dispatch mode
sees, so each reports its reckoned work, and a wrapper's own aten operators
are not counted again. Eager PyTorch counts every operator it runs, so
there is no scan-once undercount to correct (``launch.segments``).

Collectives are reckoned as ``parse_collectives`` reckons them: an
operand's bytes times the ring factor (g − 1)/g (twice for an all-reduce;
an all-gather's on its output), the traffic split equally over the mesh
axes that vary within the group.

No counterpart: the HLO parser (``_COLL_RE``, ``_symbol_shapes``,
``_replica_groups``, ``parse_collectives``' text walk) and
``compile_with_spmd_dump`` read XLA's text, which eager PyTorch does not
produce; a collective reports itself where it runs
(``core.aggregation``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.launch import hw

_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "empty_permuted"}
# a copy between devices (a host constant to the card) crosses PCIe, not HBM
_COPIES = {"_to_copy", "copy_", "_copy_from", "_copy_from_and_resize"}
_SKIP_NAMESPACES = ("c10d", "_c10d_functional", "profiler", "record_function")


def flop_type(dtype: torch.dtype) -> str:
    """The type an aten product of ``dtype`` inputs runs in on the card."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float16:
        return "f16"
    if dtype == torch.float32:
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32"
    if dtype == torch.float64:
        return "f64"
    return "int8"


def tensors(tree) -> list:
    """The tensors in a nest of lists, tuples and dicts (an operator's
    arguments, a step's inputs or outputs)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages a tree of tensors holds."""
    seen: Dict[int, int] = {}
    for t in tensors(tree):
        seen.setdefault(storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


def collective_traffic(kind: str, nbytes: float, group_size: int) -> float:
    """A device's traffic for one collective (``parse_collectives``' ring
    factors): ``nbytes`` is the operand's (an all-gather's output's)."""
    factor = (group_size - 1) / group_size
    if kind == "all-reduce":
        return 2.0 * nbytes * factor
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * factor
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(kind)


@dataclasses.dataclass
class CollectiveStats:
    per_axis_bytes: Dict[str, float]      # per-device traffic by mesh axis
    n_ops: int

    def total(self) -> float:
        return sum(self.per_axis_bytes.values())


@dataclasses.dataclass
class SegmentCost:
    flops: float            # per device
    bytes_hbm: float        # per device (unfused aten bytes + the kernels' I/O)
    coll: Dict[str, float]  # per device, by axis
    peak_mem: float         # the peak of live intermediate bytes per device
    flops_by_type: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __add__(self, o):
        coll = dict(self.coll)
        for k, v in o.coll.items():
            coll[k] = coll.get(k, 0.0) + v
        by = dict(self.flops_by_type)
        for k, v in o.flops_by_type.items():
            by[k] = by.get(k, 0.0) + v
        return SegmentCost(self.flops + o.flops, self.bytes_hbm + o.bytes_hbm,
                           coll, max(self.peak_mem, o.peak_mem), by)

    def scaled(self, n: float):
        return SegmentCost(self.flops * n, self.bytes_hbm * n,
                           {k: v * n for k, v in self.coll.items()}, self.peak_mem,
                           {k: v * n for k, v in self.flops_by_type.items()})

    def minus(self, o):
        coll = {k: max(0.0, v - o.coll.get(k, 0.0)) for k, v in self.coll.items()}
        by = {k: max(0.0, v - o.flops_by_type.get(k, 0.0))
              for k, v in self.flops_by_type.items()}
        return SegmentCost(max(0.0, self.flops - o.flops),
                           max(0.0, self.bytes_hbm - o.bytes_hbm),
                           coll, self.peak_mem, by)


class Counter(TorchDispatchMode):
    """Counts the work of everything run inside ``with Counter() as c:``
    (see the module docstring): ``c.flops`` by type, ``c.bytes``,
    ``c.kernels`` (name -> calls, launches, flops by type, bytes),
    ``c.coll`` (mesh axis -> bytes), ``c.n_coll``, ``c.peak`` (the most
    bytes of storages made inside the block alive at once). Work done
    before the block (the arguments) is not counted."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = {}
        self.bytes = 0.0
        self.by_op: Dict[str, float] = {}
        self.kernels: Dict[str, Dict[str, Any]] = {}
        self.coll: Dict[str, float] = {}
        self.n_coll = 0
        self.live = 0
        self.peak = 0
        self._owned: Dict[int, int] = {}
        self._attach = None

    def __enter__(self):
        self._attach = kcost.attached(self)
        self._attach.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._attach.__exit__(*exc)

    # --- storages -------------------------------------------------------
    def _freed(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def _track(self, outs, known) -> None:
        for t in outs:
            key = storage_key(t)
            if key in known or key in self._owned:
                continue
            n = t.untyped_storage().nbytes()
            self._owned[key] = n
            self.live += n
            weakref.finalize(t.untyped_storage(), self._freed, key)
        self.peak = max(self.peak, self.live)

    # --- aten operators -------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _SKIP_NAMESPACES:
            return out
        ins, outs = tensors((args, kwargs)), tensors(out)
        known = {storage_key(t) for t in ins}
        self._track(outs, known)
        if kcost.is_quiet():
            return out
        packet = func._overloadpacket
        if packet in flop_registry and ins:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            if n:
                kind = flop_type(ins[0].dtype)
                self.flops[kind] = self.flops.get(kind, 0) + n
        name = packet.__name__
        aliased = outs and all(storage_key(t) in known for t in outs) and not func._schema.is_mutable
        moved = name in _COPIES and len({t.device for t in ins + outs}) > 1
        if not (func.is_view or aliased or moved or name in _NO_WRITE):
            n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.bytes += n
            self.by_op[name] = self.by_op.get(name, 0) + n
        return out

    # --- what kernels and collectives report ----------------------------
    def kernel(self, name: str, work: kcost.Work, launches: int) -> None:
        for kind, n in work.flops.items():
            self.flops[kind] = self.flops.get(kind, 0) + n
        self.bytes += work.nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "launches": 0, "flops": {},
                                           "bytes": 0.0})
        k["calls"] += 1
        k["launches"] += launches
        for kind, n in work.flops.items():
            k["flops"][kind] = k["flops"].get(kind, 0) + n
        k["bytes"] += work.nbytes

    def collective(self, kind: str, axes: Tuple[str, ...], nbytes: float,
                   group_size: int) -> None:
        if group_size <= 1:
            return
        share = collective_traffic(kind, nbytes, group_size) / max(1, len(axes))
        for ax in (axes or ("unknown",)):
            self.coll[ax] = self.coll.get(ax, 0.0) + share
        self.n_coll += 1

    # --- results ----------------------------------------------------------
    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.coll), self.n_coll)

    def cost(self) -> SegmentCost:
        return SegmentCost(self.total_flops, float(self.bytes), dict(self.coll),
                           float(self.peak), {k: float(v) for k, v in self.flops.items()})


def compute_seconds(flops_by_type: Mapping[str, float]) -> float:
    return sum(n / hw.PEAK_FLOPS[t] for t, n in flops_by_type.items())


def link_bw(axis: str) -> float:
    """The link a mesh axis rides: InfiniBand across nodes for "pod" (the
    reference's DCI), NVLink within a node for the others."""
    return hw.IB_BW if axis == "pod" else hw.NVLINK_BW


def roofline_terms(cost: SegmentCost, mesh_shape: Optional[Mapping[str, int]] = None
                   ) -> Dict[str, float]:
    """The three terms in seconds (+ diagnostics), the reference's keys.
    ``mesh_shape`` ({axis: size}, or None for one card) is accepted for the
    reference's signature; the axes are read from ``cost.coll``."""
    compute_s = compute_seconds(cost.flops_by_type)
    memory_s = cost.bytes_hbm / hw.HBM_BW
    coll_s = sum(b / link_bw(ax) for ax, b in cost.coll.items())
    dominant = max(
        [("compute", compute_s), ("memory", memory_s), ("collective", coll_s)],
        key=lambda kv: kv[1])[0]
    bound = max(compute_s, memory_s, coll_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "roofline_frac": compute_s / bound if bound > 0 else 0.0,
        "coll_pod_bytes": cost.coll.get("pod", 0.0),
        "coll_ici_bytes": sum(v for k, v in cost.coll.items() if k != "pod"),
        "peak_mem_gb": cost.peak_mem / 1e9,
    }
