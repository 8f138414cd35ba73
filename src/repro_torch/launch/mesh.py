"""Meshes over a ``torch.distributed`` world — port of ``repro/launch/mesh.py``.

One rank is one card (or one CPU process under gloo). A mesh names the
world's axes: ``("pod", "data")`` for the paper's two tiers (the ONU step
inside a pod over "data", the scarce cross-pod hop over "pod"),
``("data", "model")`` for the train driver. The production meshes are
functions, never built at import. Without an initialized process group
the port takes ``mesh=None``: one process, nothing to reduce.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


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
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def size(mesh) -> int:
    """Ranks in the mesh (1 for ``mesh=None``)."""
    return 1 if mesh is None else mesh.mesh.numel()


def client_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, count) over ``axes``, row-major in the order
    given: the shard of a dimension split over those axes that this rank
    holds (0, 1 for ``mesh=None``)."""
    if mesh is None:
        return 0, 1
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, device_coords(mesh)[dist.get_rank()]))
    index, count = 0, 1
    for a in axes:
        index, count = index * shape[a] + coord[a], count * shape[a]
    return index, count


def axes_group(mesh, axes: Sequence[str]) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's peers over ``axes`` (those of them
    in the mesh), or None when ``mesh`` is None or holds none of them.

    One axis is the mesh's own group; several are a group built once per
    mesh (every rank builds every such group, in the same order, the first
    time it asks: ranks call this in step, as collectives are)."""
    if mesh is None:
        return None
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
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
    return groups[axes]
