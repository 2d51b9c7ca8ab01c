"""Logical-axis -> mesh-axis rules of the port (the counterpart of
``repro.parallel.sharding``, t5x-style): DP/TP/SP/EP/FSDP on DTensor.

Mesh axes:
  * ``pod``   -- inter-pod axis (multi-pod mesh only); folds into data
                 parallelism by default, or hosts pipeline stages.
  * ``data``  -- data parallelism (+ FSDP parameter sharding when enabled).
  * ``model`` -- tensor parallelism (heads / mlp / vocab / experts) and
                 sequence parallelism for the residual stream & KV caches.

Logical axes used by the models:
  batch, seq(residual seq), kv_seq, heads, head_dim, embed, mlp, vocab,
  experts, expert_mlp, layers, state, conv

Specs keep JAX's ``PartitionSpec`` form as plain tuples: per tensor dim
``None``, a mesh-axis name or a tuple of names.  ``placements`` turns a
spec into DTensor placements on a ``DeviceMesh`` (``Shard(i)`` on each mesh
dim the spec names for tensor dim ``i``, ``Replicate()`` elsewhere), and
``distribute`` puts a tree of tensors on the mesh by a placements tree (the
counterpart of ``jax.device_put(x, NamedSharding)``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``; the rules read only its axis names and sizes, so any
object with ``shape`` (a name -> size mapping) and ``axis_names`` -- JAX's
``Mesh`` or a stub -- gives the same specs.

Inside ``use_mesh`` the plain tensors the models make (RoPE tables,
positions, ``arange`` masks, zero accumulators, the MoE's slot bookkeeping)
meet DTensors as replicated ones: ``use_mesh`` enters DTensor's
``implicit_replication``, which is what JAX's SPMD does with a constant.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import base

#: One tensor dim's entry of a spec: replicated, one mesh axis or several.
Spec = Tuple


def _axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, of a ``DeviceMesh`` or a JAX-like mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


#: The folded (pod, data) axis of a multi-pod mesh's 2D view (``launch.dryrun``).
POD_DATA = "pod_data"


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that implement data parallelism (pod folds into data; a
    mesh with the folded ``pod_data`` axis uses it as one)."""
    names = _axis_names(mesh)
    if POD_DATA in names:
        return (POD_DATA,)
    return ("pod", "data") if "pod" in names else ("data",)


def make_rules(mesh, fsdp: bool = False, pure_dp: bool = False):
    """logical axis -> mesh axes (None = replicated).

    ``pure_dp``: fold the `model` axis into data parallelism -- for
    attention-free/low-width archs where tensor parallelism only buys
    collectives.  Weights shard over everything (ZeRO), activations shard
    batch over all axes."""
    dp = data_axes(mesh)
    if pure_dp:
        alldp = dp + ("model",)
        return {
            "batch": alldp, "seq": None, "kv_seq": None, "embed": None,
            "w_embed": alldp if fsdp else None,
            "heads": None, "head_dim": None, "mlp": None, "vocab": None,
            "experts": None, "expert_mlp": None, "layers": None,
            "state": None, "conv": None, None: None,
        }
    return {
        # --- activations ---
        "batch": dp,
        "seq": "model",        # Megatron-style sequence sharding of residuals
        "kv_seq": "model",     # decode KV caches sharded along sequence
        "embed": None,         # residual d_model dim: replicated
        # --- weights ---
        "w_embed": dp if fsdp else None,  # ZeRO-3: weight d_model dim over data
        "heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "layers": None,
        "state": None,
        "conv": None,
        None: None,
    }


def resolve_axes(axes: Tuple[Optional[str], ...], rules, shape=None, mesh=None) -> Spec:
    """Logical axes tuple -> spec, dropping non-divisible shardings.

    Tuple mesh-axis assignments degrade gracefully: if the dim doesn't
    divide the full product, progressively drop trailing mesh axes (e.g.
    batch 256 on (pod,data,model)=512 chips falls back to (pod,data)=32)
    instead of replicating outright."""
    out = []
    for i, a in enumerate(axes):
        m = rules.get(a, None)
        if m is not None and shape is not None and mesh is not None:
            if isinstance(m, str):
                if shape[i] % _mesh_size(mesh, m) != 0:
                    m = None  # e.g. kv_heads=2 on model=16 -> replicate
            else:
                m = tuple(m)
                while m and shape[i] % _mesh_size(mesh, m) != 0:
                    m = m[:-1]
                m = m or None
        # ('data',) and 'data' name the same sharding: normalize so rule
        # authors may write either without changing specs.
        if isinstance(m, (tuple, list)):
            m = m[0] if len(m) == 1 else tuple(m)
        out.append(m)
    return tuple(out)


def _mesh_size(mesh, axes) -> int:
    sizes = _axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def param_pspecs(defs, mesh, fsdp: bool = False, pure_dp: bool = False):
    """Tree of specs for a ParamDef tree (divisibility-checked)."""
    rules = make_rules(mesh, fsdp, pure_dp)
    return base.tree_map(lambda d: resolve_axes(d.axes, rules, d.shape, mesh), defs)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.

    A tuple entry such as ``("pod", "data")`` shards one tensor dim over
    several mesh dims; they must come in mesh order (DTensor splits a dim
    over its mesh dims in that order).  A mesh dim of size 1 replicates:
    a shard over one rank is the whole tensor, and DTensor's view rules
    refuse some flattens of a dim marked sharded even there.  Raises
    ``ValueError`` when the axes are out of mesh order, or when a mesh axis
    is named twice or not at all in the mesh."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    sizes = _axis_sizes(mesh)
    out = [Replicate()] * len(names)
    named = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: mesh has no axis {a!r} ({names})")
            if a in named:
                raise ValueError(f"spec {spec}: mesh axis {a!r} named twice")
            named.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: axes {axes} of tensor dim {dim} are not in mesh "
                f"order {names}; DTensor cannot shard one dim that way")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def param_shardings(defs, mesh, fsdp: bool = False, pure_dp: bool = False):
    """Tree of placements for a ParamDef tree (JAX: ``NamedSharding``s)."""
    return base.tree_map(lambda s: placements(s, mesh),
                         param_pspecs(defs, mesh, fsdp, pure_dp))


def distribute(tree, mesh, placements_tree):
    """Every tensor of ``tree`` as a DTensor on ``mesh`` with its placements
    (``torch.distributed.tensor.distribute_tensor``: each rank keeps its
    shard of the full tensor it holds, which every rank must hold alike).
    ``placements_tree`` matches ``tree`` leaf for leaf."""
    from torch.distributed.tensor import distribute_tensor

    return base.tree_map(lambda x, p: distribute_tensor(x, mesh, list(p)),
                         tree, placements_tree)


class _Ctx:
    mesh = None
    rules = None


_CTX = _Ctx()


class use_mesh:
    """Context manager binding the mesh+rules used by ``logical()`` below.

    Model code stays mesh-agnostic: ``logical(h, "batch", "seq", "embed")``
    is a no-op outside the context (single-device runs) and a redistribution
    of a DTensor inside it.  Inside it, plain tensors mixed with DTensors
    count as replicated (``implicit_replication``)."""

    def __init__(self, mesh, fsdp: bool = False, pure_dp: bool = False):
        self.mesh = mesh
        self.rules = (make_rules(mesh, fsdp, pure_dp)
                      if mesh is not None else None)
        self._stack = None

    def __enter__(self):
        self._prev = (_CTX.mesh, _CTX.rules)
        self._stack = contextlib.ExitStack()
        if self.mesh is not None:
            from torch.distributed.tensor.experimental import implicit_replication
            self._stack.enter_context(implicit_replication())
        _CTX.mesh, _CTX.rules = self.mesh, self.rules
        return self

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._prev
        self._stack.close()
        return False


def locally(fn):
    """``fn`` for ``local_map``: run on this rank's shards, where the
    models' ``logical`` constraints are no-ops."""
    def run(*args):
        with use_mesh(None):
            return fn(*args)
    return run


def on_mesh() -> bool:
    """Whether a ``use_mesh`` context with a mesh is active."""
    return _CTX.mesh is not None


def multi_rank(x) -> bool:
    """Whether ``x`` is a DTensor on a mesh of more than one rank."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor) and x.device_mesh.size() > 1


def logical(x: torch.Tensor, *axes):
    """Redistribute ``x`` by logical axis names (``x`` itself off-mesh).

    On a mesh a plain tensor is taken as replicated on every rank."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    spec = resolve_axes(tuple(axes), _CTX.rules, x.shape, mesh)
    want = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """``w`` with its data-parallel (FSDP) shards all-gathered, as FSDP does
    just before a weight is used; ``w`` itself off a mesh.

    The attention projections need it: DTensor picks the output sharding of
    the flattened (heads * head_dim) projection freely, and with the
    contracting dim still sharded it may shard those columns over `model`,
    which cannot be split back into heads that do not divide `model` (8 KV
    heads on 16 ranks).  With the weight gathered it keeps the input's."""
    mesh = _CTX.mesh
    from torch.distributed.tensor import DTensor, Replicate

    if mesh is None or not isinstance(w, DTensor):
        return w
    fsdp = _CTX.rules["w_embed"] or ()
    fsdp = (fsdp,) if isinstance(fsdp, str) else fsdp
    names = _axis_names(mesh)
    want = tuple(Replicate() if names[i] in fsdp else p
                 for i, p in enumerate(w.placements))
    return w if want == tuple(w.placements) else w.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# Decode-state (KV cache / SSM state) shardings, keyed by leaf name
# ---------------------------------------------------------------------------
_CACHE_AXES = {
    # leaf-name -> logical axes (leading stacked "layers"/"sites" dim first)
    "k": ("layers", "batch", "kv_seq", None, None),
    "v": ("layers", "batch", "kv_seq", None, None),
    "cross_k": ("layers", "batch", "kv_seq", None, None),
    "cross_v": ("layers", "batch", "kv_seq", None, None),
    "ssm": ("layers", "batch", "heads", None, None),
    "conv": ("layers", "batch", None, "mlp"),
    "tm_last": ("layers", "batch", None, None),
    "cm_last": ("layers", "batch", None, None),
    "wkv": ("layers", "batch", "heads", None, None),
    "pos": (),
}


def cache_pspecs(caches_aval, mesh):
    """Spec tree for a decode-state tree (by leaf name: the last key)."""
    rules = make_rules(mesh)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        axes = _CACHE_AXES.get(name)
        if axes is None or len(axes) != len(tree.shape):
            axes = (None,) * len(tree.shape)
        return resolve_axes(axes, rules, tree.shape, mesh)

    return walk(caches_aval, None)


def logical_state(tree):
    """A decode-state tree that every rank made alike (zeros), constrained
    leaf by leaf by its name's logical axes under the active rules (JAX's
    XLA propagates a sharding to it from its uses); ``tree`` itself off a
    mesh."""
    if _CTX.mesh is None:
        return tree

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        axes = _CACHE_AXES.get(name)
        if axes is None or len(axes) != t.ndim:
            axes = (None,) * t.ndim
        return logical(t, *axes)

    return walk(tree, None)


def batch_pspecs(batch_aval, mesh):
    """Shard every batch input on dim 0 over the DP axes."""
    rules = make_rules(mesh)

    def one(x):
        axes = ("batch",) + (None,) * (len(x.shape) - 1)
        return resolve_axes(axes, rules, x.shape, mesh)

    return base.tree_map(one, batch_aval)
