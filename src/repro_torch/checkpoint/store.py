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
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [e for i, v in enumerate(tree) for e in _flatten_with_paths(v, prefix + (str(i),))]
    if tree is None:        # an empty subtree, as in JAX
        return []
    return [("/".join(prefix), tree)]


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
                    shard_size: int = 2 ** 30) -> str:
    """Atomically persist a tree of tensors. Returns the final directory."""
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


def restore_checkpoint(ckpt_dir: str, step: int, tree_like):
    """Restore into the structure of ``tree_like`` -> (tree, extra, step).
    Each leaf takes the checkpoint's dtype and the device of the leaf of
    ``tree_like`` it replaces (the CPU for a non-tensor); a missing leaf
    raises KeyError, a shape that differs ValueError."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["entries"]}
    shards: dict = {}
    out = []
    for name, leaf in _flatten_with_paths(tree_like):
        if name not in by_path:
            raise KeyError(f"checkpoint missing leaf {name}")
        entry = by_path[name]
        sid = entry["shard"]
        if sid not in shards:
            shards[sid] = np.load(os.path.join(final, f"shard_{sid}.npz"))
        arr = shards[sid][entry["key"]]
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else None
        if want is not None and tuple(arr.shape) != want:
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != {want}")
        device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out.append(_from_numpy(arr, entry["dtype"], device))
    return _unflatten(tree_like, iter(out)), manifest["extra"], manifest["step"]
