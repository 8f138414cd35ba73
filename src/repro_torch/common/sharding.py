"""Logical-axis → mesh-axis rules — port of ``repro/common/sharding.py``.

Model code in the reference names every parameter's axes logically
(``("embed", "mlp")``); a ``ShardingRules`` table maps them onto mesh
axes. That is how one model lowers onto the ``("data", "model")`` and
``("pod", "data", "model")`` meshes, and how the SFL regime (FSDP: the
two-step reduce-scatter in the pod, all-reduce across pods, all-gather)
and the classical benchmark (``replicated()``: a flat all-reduce) are
data rather than different model code.

The rules choose how the gradients are reduced (:func:`reduce_schedule`)
and which dimensions of each parameter a rank holds a block of
(:func:`sharding_tree`: per leaf a :class:`Place` along the dimension
mapped onto the FSDP axes, or onto "model" for tensor and expert
parallelism, or None where the leaf stays replicated; a leaf cut on both,
such as the attention query weight (d → "data", heads → "model"), has a
tuple of the two); :func:`shard_or_replicate` cuts a rank's block of a
full tensor. :func:`logical_to_physical` returns a plain tuple, the port's
stand-in for ``PartitionSpec``, and ``constrain`` is the identity, as the
reference's is outside a mesh: the port's tensor-parallel region is
explicit (``core.tensor_parallel``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

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
    outside a mesh, and the port's activations are never sharded by a
    constraint (FSDP gathers the parameters; the tensor-parallel region's
    collectives are explicit, ``core.tensor_parallel``)."""
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


class Place(NamedTuple):
    """Where a rank's shard of a leaf lies: block ``index`` of ``count``
    equal blocks along dimension ``dim``, split over the mesh ``axes``."""
    dim: int
    index: int
    count: int
    axes: Tuple[str, ...] = ()


def places_of(place) -> Tuple[Place, ...]:
    """A leaf's places as a tuple: () for None, one for a :class:`Place`,
    the tuple itself for a leaf cut on several dimensions."""
    if place is None:
        return ()
    return (place,) if isinstance(place, Place) else tuple(place)


def join_places(*places):
    """One leaf's places on several axis sets joined: None, a single
    :class:`Place`, or a tuple of them (each on its own dimension)."""
    out = tuple(p for pl in places for p in places_of(pl))
    return None if not out else out[0] if len(out) == 1 else out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, Place) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def sharding_tree(specs, axes: Axis, mesh_shape: Mapping[str, int], index: int):
    """The reference's ``sharding_tree`` over one set of mesh axes: per
    leaf of a spec tree (``filter_valid_spec``'s, so every sharded
    dimension divides), the :class:`Place` of this rank's block along the
    dimension mapped onto ``axes`` (the rules' ``fsdp``, or "model"),
    block ``index`` of the axes' size; None where no dimension is (the
    leaf stays replicated over them, as GSPMD leaves it). A leaf cut on
    two axis sets takes one tree per set, joined by :func:`join_places`."""
    wanted = tuple(a for a in _axes(axes) if a in mesh_shape)
    count = 1
    for a in wanted:
        count *= mesh_shape[a]
    if _is_spec(specs):
        for dim, ax in enumerate(specs):
            if set(wanted) & set(_axes(ax)):
                return Place(dim, index, count, wanted)
        return None
    return {k: sharding_tree(v, axes, mesh_shape, index) for k, v in specs.items()}


def shard_or_replicate(x, place):
    """This rank's block of the full tensor ``x`` (a contiguous copy) at
    ``place`` (a :class:`Place`, a tuple of them, or None: ``x`` itself).
    A dimension its count does not divide raises."""
    for pl in places_of(place):
        if x.shape[pl.dim] % pl.count:
            raise ValueError(f"dimension {pl.dim} of a {tuple(x.shape)} leaf does not split "
                             f"into {pl.count} blocks over {pl.axes}")
        n = x.shape[pl.dim] // pl.count
        x = x.narrow(pl.dim, pl.index * n, n)
    return x.contiguous() if place is not None else x


MODEL_AXIS = "model"


def model_parallel(rules: ShardingRules, mesh_shape: Mapping[str, int]) -> Tuple[bool, bool]:
    """(tensor, expert): whether the rules put the heads / MLP / vocab, and
    the MoE experts, on the mesh's "model" axis: the explicit region of
    ``core.tensor_parallel``, taken whenever the mesh has that axis, of any
    size (a group of one on one card)."""
    return tuple(MODEL_AXIS in mesh_shape and _axes(ax) == (MODEL_AXIS,)
                 for ax in (rules.tensor, rules.expert))


def reduce_schedule(rules: ShardingRules, mesh_shape: Mapping[str, int]) -> str:
    """How the rules reduce the gradients of a data-parallel step:
    "two_step" when FSDP is on (reduce-scatter over "data", all-reduce over
    "pod"; the parameters gathered over "data"), "classical" when it is off
    (a flat all-reduce over the client axes). Either combines with tensor
    and expert parallelism over "model" (:func:`model_parallel`), whose
    gradients need no reduction of their own: each model rank's are whole
    for the blocks it holds. Tensor or expert parallelism over another
    mesh axis larger than 1 raises."""
    for role, ax in (("tensor", rules.tensor), ("expert", rules.expert)):
        axes = _axes(ax)
        if axes != (MODEL_AXIS,) and any(mesh_shape.get(a, 1) > 1 for a in axes):
            raise NotImplementedError(
                f"{role} parallelism over mesh axes {axes} of {dict(mesh_shape)} is not "
                "ported: the port runs tensor and expert parallelism over 'model' alone")
    return "two_step" if _axes(rules.fsdp) else "classical"
