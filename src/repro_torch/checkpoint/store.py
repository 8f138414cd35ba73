"""Checkpointing: npz shards + a JSON manifest, written atomically — the
port of ``repro/checkpoint/store.py`` in the same format, so a checkpoint
written by either package restores in the other.

  * leaves in ``shard_<i>.npz`` files of up to ``shard_size`` bytes, keyed by
    their path with ``/`` as ``__``;
  * ``manifest.json``: the step, ``extra``, and per leaf its path, key,
    shard, shape and logical dtype;
  * written to ``<dir>/tmp_<step>``, then renamed to ``<dir>/step_<step>`` in
    one ``os.rename``: a crash mid-write never corrupts the latest step.

Paths are the ones JAX's ``tree_flatten_with_path`` gives the same tree:
dict keys in sorted order, tuple and list items by index
(``0/unit/0_attn/attn/wq``, ``1/m/embed``, ``1/t`` for ``(params,
opt_state)``). bfloat16, which numpy lacks, is stored as its uint16 bits
under the logical dtype ``"bfloat16"``, as the reference stores it.

A tree of shards (``launch.specs.ParamLayout``: FSDP over "data",
blocks over "model", or a leaf cut on both) goes with its
``sharding_tree`` of ``common.sharding.Place``s (a tuple of them for a
leaf cut on two dimensions): ``save_checkpoint`` gathers every shard over
its axes' group (``group``: one group, or ``{axes: group}``) and rank 0
writes the full leaves, and ``restore_checkpoint`` gives each rank its
block. A checkpoint so written restores on one process, and a one-process
checkpoint onto shards.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.sharding import places_of, shard_or_replicate


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [e for i, v in enumerate(tree) for e in _flatten_with_paths(v, prefix + (str(i),))]
    if tree is None:        # an empty subtree, as in JAX
        return []
    return [("/".join(prefix), tree)]


def _places(tree, places) -> list:
    """The place of every leaf of ``tree`` in flattening order, from a tree
    of its structure whose leaves (or whole subtrees) may be None."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _places(tree[k], places and places[k])]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in _places(v, places and places[i])]
    return [] if tree is None else [places]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in flattening order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to store, its logical dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = arr.copy(order="C")           # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.astype(dtype, copy=False)).to(device)


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
                    shard_size: int = 2 ** 30, sharding_tree=None, group=None
                    ) -> Optional[str]:
    """Atomically persist a tree of tensors. Returns the final directory.

    With ``sharding_tree`` (a ``Place``, a tuple of them, or None per leaf)
    the leaves are shards: every rank of the world calls, each sharded leaf
    is gathered over ``group`` (one group, or ``{Place.axes: group}``),
    rank 0 alone writes (the others return None), and no
    rank returns before the step is on disk."""
    if sharding_tree is not None:
        from repro_torch.core.aggregation import gather_dim

        def whole(x, place):
            for pl in places_of(place):
                if pl.count > 1:
                    x = gather_dim(x, pl.dim, group[pl.axes] if isinstance(group, dict)
                                   else group)
            return x
        places = iter(_places(tree, sharding_tree))
        with torch.no_grad():
            tree = _unflatten(tree, iter([whole(x, pl) for (_, x), pl in
                                          zip(_flatten_with_paths(tree), places)]))
        if dist.is_initialized() and dist.get_rank() != 0:
            dist.barrier()
            return None
    final = _write(ckpt_dir, step, tree, extra, shard_size)
    if sharding_tree is not None and dist.is_initialized():
        dist.barrier()          # a rank may look for the latest step next
    return final


def _write(ckpt_dir: str, step: int, tree, extra: Optional[dict], shard_size: int) -> str:
    tmp = os.path.join(ckpt_dir, f"tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "extra": extra or {}, "entries": []}
    shard_idx, shard_bytes, shard_payload = 0, 0, {}

    def flush():
        nonlocal shard_idx, shard_bytes, shard_payload
        if shard_payload:
            np.savez(os.path.join(tmp, f"shard_{shard_idx}.npz"), **shard_payload)
            shard_idx += 1
            shard_bytes, shard_payload = 0, {}

    for name, leaf in _flatten_with_paths(tree):
        arr, logical_dtype = _to_numpy(leaf)
        key = name.replace("/", "__")
        manifest["entries"].append(
            {"path": name, "key": key, "shard": shard_idx,
             "shape": list(arr.shape), "dtype": logical_dtype})
        shard_payload[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= shard_size:
            flush()
    flush()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # prune stale tmp dirs from crashed writers
    for d in os.listdir(ckpt_dir):
        if d.startswith("tmp_"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, tree_like, sharding_tree=None):
    """Restore into the structure of ``tree_like`` -> (tree, extra, step).
    Each leaf takes the checkpoint's dtype and the device of the leaf of
    ``tree_like`` it replaces (the CPU for a non-tensor); a missing leaf
    raises KeyError, a shape that differs ValueError. With
    ``sharding_tree`` (a ``Place``, a tuple of them, or None per leaf) each
    rank keeps its block of a stored leaf, the reference's elastic
    restore."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["entries"]}
    shards: dict = {}
    out = []
    places = iter(_places(tree_like, sharding_tree))
    for name, leaf in _flatten_with_paths(tree_like):
        place = next(places)
        if name not in by_path:
            raise KeyError(f"checkpoint missing leaf {name}")
        entry = by_path[name]
        sid = entry["shard"]
        if sid not in shards:
            shards[sid] = np.load(os.path.join(final, f"shard_{sid}.npz"))
        x = shard_or_replicate(_from_numpy(shards[sid][entry["key"]], entry["dtype"], "cpu"),
                               place)
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else None
        if want is not None and tuple(x.shape) != want:
            raise ValueError(f"{name}: checkpoint shape {tuple(x.shape)} != {want}")
        out.append(x.to(leaf.device if isinstance(leaf, torch.Tensor) else "cpu"))
    return _unflatten(tree_like, iter(out)), manifest["extra"], manifest["step"]
