"""Logical-axis → mesh-axis rules — port of ``repro/common/sharding.py``.

Model code in the reference names every parameter's axes logically
(``("embed", "mlp")``); a ``ShardingRules`` table maps them onto mesh
axes. That is how one model lowers onto the ``("data", "model")`` and
``("pod", "data", "model")`` meshes, and how the SFL regime (FSDP: the
two-step reduce-scatter in the pod, all-reduce across pods, all-gather)
and the classical benchmark (``replicated()``: a flat all-reduce) are
data rather than different model code.

The port runs data parallel with full replicas on every rank, so here the
rules choose how the gradients are reduced (:func:`reduce_schedule`); the
memory that FSDP saves and tensor parallelism wait on more than one card
(ROADMAP.md Queue 1 item 1e). :func:`logical_to_physical` returns a plain
tuple, the port's stand-in for ``PartitionSpec``, and ``constrain`` is the
identity, as the reference's is outside a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


def _axes(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical parameter/activation axes to mesh axes.

    The defaults express the production sharding:
      * ``batch``   — data-parallel clients over ("pod", "data")
      * ``embed``   — FSDP (ZeRO-3-style) sharding of d_model over "data"
      * ``heads`` / ``mlp`` / ``vocab`` — tensor parallel over "model"
      * ``experts`` — expert parallel over "model"
    Classical-FL benchmark: ``replicated()`` turns FSDP off so gradient
    sync becomes a flat all-reduce (the paper's benchmark topology).
    """

    batch: Axis = ("pod", "data")
    fsdp: Axis = "data"            # weight d_model / stacked dims
    tensor: Axis = "model"         # heads / mlp / vocab columns
    expert: Axis = "model"         # MoE expert dim
    sequence: Axis = None          # sequence parallelism (prefill)
    table: Mapping[str, Axis] = dataclasses.field(default_factory=dict)

    def axis_for(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        if logical in self.table:
            return self.table[logical]
        builtin = {
            "batch": self.batch,
            "embed": self.fsdp,
            "heads": self.tensor,
            "mlp": self.tensor,
            "vocab": self.tensor,
            "vocab_rows": self.fsdp,     # embedding-table rows (FSDP'd)
            "tensor_cols": self.tensor,  # embedding-table columns (TP'd)
            "experts": self.expert,
            "sequence": self.sequence,
        }
        # every other name ("layers", "head_dim", "kv_heads", "seq", ...) is never sharded
        return builtin.get(logical)

    def replicated(self) -> "ShardingRules":
        """Classical-FL benchmark: no FSDP; params replicated over data."""
        return dataclasses.replace(self, fsdp=None)

    def with_(self, **kw) -> "ShardingRules":
        return dataclasses.replace(self, **kw)


def logical_to_physical(rules: ShardingRules, logical: Sequence[Optional[str]]) -> Spec:
    """A tuple of logical axis names -> a tuple of mesh axes per dimension
    (a name, a tuple of names, or None).

    A mesh axis may appear at most once; later duplicate uses degrade to
    None (replicated on that dim) — e.g. (embed, mlp) weights when fsdp and
    tensor point at the same axis in degenerate test meshes.
    """
    used: set = set()
    spec = []
    for name in logical:
        ax_tuple = tuple(a for a in _axes(rules.axis_for(name)) if a not in used)
        if not ax_tuple:
            spec.append(None)
            continue
        used.update(ax_tuple)
        spec.append(ax_tuple if len(ax_tuple) > 1 else ax_tuple[0])
    return tuple(spec)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def spec_tree(rules: ShardingRules, logical_tree) -> Any:
    """Map a nested dict of logical-axis tuples to one of mesh-axis tuples."""
    if _is_logical(logical_tree):
        return logical_to_physical(rules, logical_tree)
    return {k: spec_tree(rules, v) for k, v in logical_tree.items()}


def constrain(x, rules: ShardingRules, logical: Sequence[Optional[str]]):
    """The identity: the reference's sharding constraint is a no-op
    outside a mesh, and the port holds full replicas."""
    return x


def filter_valid_spec(mesh_shape: Mapping[str, int], spec: Spec,
                      shape: Tuple[int, ...]) -> Spec:
    """Drop mesh axes that do not evenly divide the corresponding dim
    (``mesh_shape``: axis name -> size); that dimension is replicated."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        extent = 1
        for a in _axes(ax):
            extent *= mesh_shape[a]
        out.append(ax if ax is None or dim % extent == 0 else None)
    return tuple(out)


def reduce_schedule(rules: ShardingRules, mesh_shape: Mapping[str, int]) -> str:
    """How the rules reduce the gradients of a data-parallel step:
    "two_step" when FSDP is on (reduce-scatter over "data", all-reduce over
    "pod", all-gather over "data"), "classical" when it is off (a flat
    all-reduce over the client axes). Tensor or expert parallelism over a
    mesh axis larger than 1 raises: the port holds full replicas."""
    for role, ax in (("tensor", rules.tensor), ("expert", rules.expert)):
        wide = [a for a in _axes(ax) if mesh_shape.get(a, 1) > 1]
        if wide:
            raise NotImplementedError(
                f"{role} parallelism over mesh axis {wide[0]!r} (size "
                f"{mesh_shape[wide[0]]}) is not ported: the port runs data parallel with "
                "full replicas; ROADMAP.md Queue 1 item 1e")
    return "two_step" if _axes(rules.fsdp) else "classical"
