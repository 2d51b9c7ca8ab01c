"""Fault-tolerant checkpointing of the port (the counterpart of
``repro.checkpoint.manager``): atomic writes, keep-k, restore onto a device.

Save: tree -> flat {path: ndarray} -> .npz written to a temp name then
os.replace'd (atomic on POSIX) + a JSON metadata sidecar (step, keys, wall
time).  A crash mid-save can never corrupt the latest checkpoint.

The format is JAX's, key for key: a leaf's key is its tree path joined by
'/' (dict keys, a named tuple's field names, sequence indices), so
``{"params": ..., "opt": AdamWState}`` gives ``opt/m/blocks/attn/wq``.  A
checkpoint written by either package restores in the other.

Sharded trees (DTensor leaves, ``parallel.sharding``): ``save`` gathers
every leaf (every rank calls it) and the world's rank 0 writes the full
tensors, in the same format; ``restore(..., shardings=, mesh=)`` puts each
leaf back as a DTensor with its placements (JAX's reshard-on-restore), so
a checkpoint saved unsharded or on another mesh restores onto any mesh.
Without shardings ``restore`` takes the device to put the tree on.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.base import resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in JAX's flattening order: dict keys sorted, a named
    tuple's fields and a sequence's items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _paths(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, (list, tuple)) and not _is_placements(tree):
        for i, x in enumerate(tree):
            yield from _paths(x, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _is_placements(x) -> bool:
    """A DTensor placements tuple: a leaf of a shardings tree."""
    if not (x and torch.distributed.is_available()):
        return False
    from torch.distributed.tensor import Placement
    return all(isinstance(p, Placement) for p in x)


def _rebuild(tree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf looked up by its key."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves, prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves, prefix + (str(i),)) for i, x in enumerate(tree))
    return leaves["/".join(prefix)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:        # numpy has no bfloat16
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        sharded = any(_is_dtensor(leaf) for _, leaf in _paths(tree))
        flat = _flatten(tree)            # a sharded tree: every rank gathers
        final = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        if sharded:
            import torch.distributed as dist
            if dist.get_rank() == 0:
                self._write(step, flat, final)
            dist.barrier()               # the file is whole before any reads
            return final
        self._write(step, flat, final)
        return final

    def _write(self, step: int, flat: Dict[str, np.ndarray], final: str) -> None:
        tmp = final + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)                      # atomic
        meta = {"step": step, "time": time.time(), "keys": sorted(flat)}
        mtmp = final + ".json.tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        os.replace(mtmp, final + ".json")
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            for suffix in (".npz", ".npz.json"):
                p = os.path.join(self.dir, f"ckpt_{s:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_") and name.endswith(".npz"):
                out.append(int(name[5:13]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, step: int, like_tree, device=None, shardings=None, mesh=None):
        """Load into the structure of ``like_tree`` (tensors, meta tensors
        will do, giving each leaf's shape and dtype), every leaf on
        ``device`` (default the card).

        ``shardings``: a placements tree matching ``like_tree`` (a leaf's
        placements, or None to keep it a plain tensor) and the ``mesh``
        they are on: each leaf is put back as a DTensor of its placements
        (reshard onto the current mesh, the elastic restart path), on the
        mesh's device type."""
        if shardings is not None:
            if mesh is None:
                raise ValueError("restore: shardings need the mesh they are on")
            device = mesh.device_type
        device = resolve_device(device)
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        leaves = {}
        for key, like in _paths(like_tree):
            if key not in flat:
                raise KeyError(f"checkpoint missing {key}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != expected {tuple(like.shape)}"
                )
            leaves[key] = torch.from_numpy(np.array(arr)).to(device, like.dtype)
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            for key, placements in _paths(shardings):
                if placements is not None:
                    leaves[key] = distribute_tensor(leaves[key], mesh, list(placements))
        return _rebuild(like_tree, leaves)

    def restore_latest(self, like_tree, device=None, shardings=None, mesh=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like_tree, device, shardings, mesh)
