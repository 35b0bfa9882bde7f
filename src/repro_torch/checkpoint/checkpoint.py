"""Fault-tolerant checkpointing.

Layout:   <dir>/step_<N>/manifest.json + arrays/<leaf-id>.npy
Writes are atomic (tmp dir + rename), rotated (keep_n), and include the
*data-pipeline state*: per-shard seek offsets into the gzip corpus, which
the paper's seek index makes O(1) to restore.

The counterpart of ``repro.checkpoint.checkpoint`` with the same on-disk
layout: the same keys (tree paths joined by ``/``), numbering, manifest
and bf16 stored as fp32 with ``"dtype": "bfloat16"``, so a checkpoint
written by either package restores in the other. A stacked leaf held per
layer (a list of tensors, ``Model.param_tree``) is written stacked, as the
JAX package holds it, and restored into its layers. Restoring writes into
the template's tensors in place.

On a mesh the state holds each rank's blocks: ``save_checkpoint(...,
shardings=)`` gathers each leaf by its ``NamedSharding`` (every rank takes
part) and rank 0 alone writes the JAX package's layout;
``restore_checkpoint(..., shardings=)`` places each restored leaf by its
matching sharding, this rank's block (the elastic re-shard: a checkpoint
taken on one mesh restarts on another). As in the JAX package, shardings
whose structure does not match the template's restore unsharded.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.layers import map_members, stack_depth, stack_members, stacked


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _gathered(leaf, sh):
    """A leaf of blocks as the whole leaf (a collective); a leaf that is no
    tensor stays as it is."""
    if not isinstance(leaf, (list, torch.Tensor)):
        return leaf
    if isinstance(leaf, list):
        depth = stack_depth(leaf)
        return stacked(map_members(lambda t: sh.layer(depth).gather(t), leaf))
    return sh.gather(leaf)


def _sharding_leaves(shardings) -> List[Tuple[str, Any]]:
    """(key, NamedSharding) pairs of a tree of shardings, in tree order."""
    return [(k, v) for k, v in _flatten_with_paths(shardings) if v is not None]


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's order: dict keys sorted, a
    list a leaf (one stacked leaf)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, list):
        leaf = stacked(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(leaf)


def save_checkpoint(
    directory: str,
    step: int,
    state: Dict[str, Any],
    *,
    keep_n: int = 3,
    shardings: Optional[Any] = None,
) -> str:
    """state: a tree of dicts, e.g. {params, opt, data, meta}; leaves are
    tensors, per-layer lists of tensors, numbers or numpy arrays.
    ``shardings``: a tree of ``NamedSharding`` under some of the state's
    keys, whose leaves are this rank's blocks; every rank calls this, and
    rank 0 writes."""
    by_key = dict(_sharding_leaves(shardings)) if shardings is not None else {}
    leaves = [(key, _gathered(leaf, by_key[key]) if key in by_key and leaf is not None
               else leaf) for key, leaf in _flatten_with_paths(state)]
    final = os.path.join(directory, f"step_{step:08d}")
    if _rank() != 0:
        _barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    arrays_dir = os.path.join(tmp, "arrays")
    os.makedirs(arrays_dir)

    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(leaves):
        if leaf is None:
            manifest["leaves"].append({"key": key, "kind": "none"})
            continue
        bf16 = isinstance(leaf, (list, torch.Tensor)) and _dtype(leaf) == torch.bfloat16
        arr = _to_numpy(leaf)
        # numpy cannot persist bfloat16 natively; round-trip losslessly
        # through float32.
        logical_dtype = "bfloat16" if bf16 else str(arr.dtype)
        fname = f"{i:06d}.npy"
        np.save(os.path.join(arrays_dir, fname), arr)
        manifest["leaves"].append(
            {"key": key, "kind": "array", "file": fname, "dtype": logical_dtype,
             "shape": list(arr.shape)}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # Atomic publish; tolerate a crashed previous attempt.
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _rotate(directory, keep_n)
    _barrier()
    return final


def _dtype(leaf):
    while isinstance(leaf, list):
        leaf = leaf[0]
    return leaf.dtype


def _rotate(directory: str, keep_n: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for old in steps[:-keep_n]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(path: str, template: Dict[str, Any], *,
                       shardings: Optional[Any] = None) -> Tuple[int, Dict[str, Any]]:
    """Restore into the structure of ``template``. A tensor leaf (or a
    per-layer list) is written in place, on its device, and must have the
    saved dtype and shape; any other leaf comes back as the saved numpy
    array; a leaf the checkpoint lacks stays the template's. With
    ``shardings`` (one per leaf of ``template``, in its order), a tensor
    leaf takes this rank's block of the saved array: written in place into
    a template of the block's shape, else returned as a new tensor."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    placed = {}
    if shardings is not None:
        keys = [k for k, _ in _flatten_with_paths(template)]
        shard_leaves = [v for _, v in _sharding_leaves(shardings)]
        if len(shard_leaves) == len(keys):  # else structure mismatch: restore unsharded
            placed = dict(zip(keys, shard_leaves))

    def restore(key, leaf):
        entry = by_key.get(key)
        if entry is None or entry["kind"] == "none":
            return leaf
        arr = np.load(os.path.join(path, "arrays", entry["file"]))
        if not isinstance(leaf, (list, torch.Tensor)):
            return arr
        t = torch.from_numpy(arr)
        if entry.get("dtype") == "bfloat16":
            t = t.to(torch.bfloat16)
        sh = placed.get(key)
        if sh is not None:
            t = sh.shard(t)
            if tuple(t.shape) != _stacked_shape(leaf):
                if isinstance(leaf, list) or tuple(leaf.shape) != tuple(arr.shape):
                    raise ValueError("%s: block %s, template %s" % (
                        key, tuple(t.shape), _stacked_shape(leaf)))
                return t.to(leaf.device).clone()
        if t.dtype != _dtype(leaf) or tuple(t.shape) != _stacked_shape(leaf):
            raise ValueError("%s: saved %s %s, template %s %s" % (
                key, t.dtype, tuple(t.shape), _dtype(leaf), _stacked_shape(leaf)))
        with torch.no_grad():
            map_members(lambda dst, src: dst.copy_(src), leaf, stack_members(t, leaf))
        return leaf

    def walk(tree, prefix: str):
        if isinstance(tree, dict):
            return {k: walk(tree[k], f"{prefix}/{k}" if prefix else str(k)) for k in tree}
        return restore(prefix, tree)

    return manifest["step"], walk(template, "")


def _stacked_shape(leaf) -> Tuple[int, ...]:
    """The shape ``stacked(leaf)`` would have, without the copy."""
    if isinstance(leaf, list):
        return (len(leaf),) + _stacked_shape(leaf[0])
    return tuple(leaf.shape)
