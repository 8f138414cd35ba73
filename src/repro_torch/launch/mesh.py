"""Meshes over a ``torch.distributed`` world — port of ``repro/launch/mesh.py``.

One rank is one card (or one CPU process under gloo). A mesh names the
world's axes: ``("pod", "data")`` for the paper's two tiers (the ONU step
inside a pod over "data", the scarce cross-pod hop over "pod"),
``("data", "model")`` for the train driver, ``("pod", "data", "model")``
for the reference's multi-pod mesh. A rank's group over some axes holds
the ranks that share its coordinate on every other axis
(:func:`axes_group`): its "model" group the tensor-parallel peers of its
("pod", "data") coordinate, its ("pod", "data") group the data-parallel
peers of its "model" coordinate. The production meshes are functions,
never built at import. Without an initialized process group the port
takes ``mesh=None``: one process, nothing to reduce.

An :class:`AbstractMesh` is a mesh shape ``{axis: size}`` without a
process group: a dry run (``launch.dryrun``) drives the train step's
schedule code over it on ``meta`` tensors, as rank 0, and its groups
(:class:`AbstractGroup`) carry only their axes and size, so the
collectives report what they would move (``core.aggregation``).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class AbstractMesh:
    """A mesh of ``shape`` ({axis: size}, in order) with no process group;
    ``mesh`` holds the ranks as a ``DeviceMesh``'s does."""

    def __init__(self, shape: Mapping[str, int]):
        self.mesh_dim_names = tuple(shape)
        self.mesh = torch.arange(math.prod(shape.values())).reshape(tuple(shape.values()))


class AbstractGroup:
    """An abstract mesh's group over ``axes`` (those of size > 1): its
    size, and no members to talk to."""

    def __init__(self, axes: Tuple[str, ...], size: int):
        self.axes, self.size = axes, size


# id(process group) -> (the group, the mesh axes of size > 1 it spans)
_GROUP_AXES: Dict[int, Tuple[object, Tuple[str, ...]]] = {}


def group_axes(group) -> Tuple[str, ...]:
    """The mesh axes of size > 1 a group from :func:`axes_group` spans
    (() for a group made elsewhere)."""
    if isinstance(group, AbstractGroup):
        return group.axes
    return _GROUP_AXES.get(id(group), (None, ()))[1]


def group_size(group) -> int:
    return group.size if isinstance(group, AbstractGroup) else dist.get_world_size(group)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _init(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16 x 16 ("data", "model") mesh, or 2 x 16 x 16 ("pod", "data",
    "model") with ``multi_pod``: a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world() != n:
        raise RuntimeError(
            f"need {n} devices, have {_world()} — launch {n} ranks (one per card) "
            "under an initialized torch.distributed process group")
    return _init(shape, axes, device_type)


def make_test_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str = "cuda"):
    """A mesh of ``shape`` over the initialized world, whose size it must
    equal; ``device_type`` is "cuda" (NCCL) or "cpu" (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh needs an initialized torch.distributed process "
                           "group; without one pass mesh=None (one process, nothing reduced)")
    if math.prod(shape) != _world():
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks, the world "
                         f"has {_world()}")
    return _init(tuple(shape), tuple(axes), device_type)


def device_coords(mesh) -> Dict[int, Tuple[int, ...]]:
    """rank -> its coordinate in the mesh."""
    ranks = mesh.mesh.numpy()
    return {int(ranks[idx]): idx for idx in np.ndindex(ranks.shape)}


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size ({} for ``mesh=None``)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, map(int, mesh.mesh.shape)))


def size(mesh) -> int:
    """Ranks in the mesh (1 for ``mesh=None``)."""
    return 1 if mesh is None else mesh.mesh.numel()


def client_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, count) over ``axes``, row-major in the order
    given: the shard of a dimension split over those axes that this rank
    holds (0, 1 for ``mesh=None``). The other axes do not enter: every
    "model" rank of one ("pod", "data") coordinate has the same client
    index, and ``("model",)`` gives its block of the heads."""
    if mesh is None:
        return 0, 1
    shape = mesh_shape(mesh)
    rank = 0 if isinstance(mesh, AbstractMesh) else dist.get_rank()
    coord = dict(zip(mesh.mesh_dim_names, device_coords(mesh)[rank]))
    index, count = 0, 1
    for a in axes:
        index, count = index * shape[a] + coord[a], count * shape[a]
    return index, count


def axes_group(mesh, axes: Sequence[str]) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's peers over ``axes`` (those of them
    in the mesh: the ranks that share its coordinate on every other axis),
    or None when ``mesh`` is None or holds none of them.

    One axis is the mesh's own group; several are a group built once per
    mesh (every rank builds every such group, in the same order, the first
    time it asks: ranks call this in step, as collectives are). An
    :class:`AbstractMesh`'s is an :class:`AbstractGroup`."""
    if mesh is None:
        return None
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not axes:
        return None
    shape = mesh_shape(mesh)
    wide = tuple(a for a in axes if shape[a] > 1)
    if isinstance(mesh, AbstractMesh):
        return AbstractGroup(wide, math.prod(shape[a] for a in axes))
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
        _GROUP_AXES.setdefault(id(group), (group, wide))
        return group
    groups = mesh.__dict__.setdefault("_repro_axes_groups", {})
    if axes not in groups:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        blocks = mesh.mesh.permute(rest + dims).reshape(-1, math.prod(
            mesh.mesh.shape[d] for d in dims))
        for ranks in blocks.tolist():
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                groups[axes] = group
                _GROUP_AXES[id(group)] = (group, wide)
    return groups[axes]
