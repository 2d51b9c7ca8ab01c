"""Parameter definitions and parameter trees of the port's models (the
counterpart of ``repro.models.base``).

Parameters are nested dicts of tensors whose keys are the JAX pytree's:
``params["blocks"]["attn"]["wq"]`` here is JAX's, and its name is the path
joined by ``.`` (``blocks.attn.wq``).  Stacked layers keep their leading
``L`` axis, so a JAX parameter tree copies across leaf for leaf
(``params_from_numpy``).  Each model builds a nested dict of ``ParamDef``;
from it derive the initialised tree (``init_tree``), the shapes as meta
tensors (``shape_tree``) and the count (``param_count``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: Leaves the JAX models read in float32 (``.astype(jnp.float32)``) or mix
#: into float32 arithmetic: ``serving_params`` leaves them as they are.
KEEP_F32 = frozenset({"mix", "w_bias", "u", "A_log", "dt_bias", "Dskip"})


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "normal"                     # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def compute_dtype(cfg) -> torch.dtype:
    """The activation dtype named by ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the models run on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run them on the CPU")
    return dev


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) in JAX's leaf order (sorted keys), names joined by '.'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def layer(tree, i: int):
    """Layer ``i`` of a stacked (L-leading) tree: views, no copies."""
    return tree_map(lambda t: t[i], tree)


def layers_of(tree) -> list:
    """Every layer of a stacked (L-leading) tree as views, from one
    ``torch.unbind`` per leaf.  Under autograd the backward of an unbind
    stacks the layers' gradients once, where ``layer(tree, i)`` per layer
    would build a zero tensor of the whole stacked leaf for each select."""
    parts = {name: torch.unbind(leaf, 0) for name, leaf in named_leaves(tree)}
    n = len(next(iter(parts.values())))
    return [_unflatten(tree, {k: v[i] for k, v in parts.items()}) for i in range(n)]


def remat(fn: Callable, enabled: bool, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (``jax.checkpoint``) when ``enabled`` and autograd records: the serving
    path under ``torch.no_grad()`` calls ``fn`` as it is."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _init_one(d: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "normal":
        # fan-in scaled normal init (last dim = fan-out conv.), as in JAX
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(1, fan_in))
        return std * torch.randn(d.shape, generator=generator, dtype=d.dtype,
                                 device=device)
    if d.init == "embed":
        return d.scale * torch.randn(d.shape, generator=generator, dtype=d.dtype,
                                     device=device)
    raise ValueError(f"unknown init {d.init}")


def init_tree(defs, generator: torch.Generator, device=None):
    """Initialise a tree of ParamDef with JAX's distributions and stds, drawn
    leaf by leaf in JAX's leaf order from ``generator`` (on ``device``,
    default the generator's)."""
    device = generator.device if device is None else torch.device(device)
    made = {name: _init_one(d, generator, device) for name, d in named_leaves(defs)}
    return _unflatten(defs, made)


def _unflatten(tree, leaves, prefix: str = ""):
    """``tree``'s structure with its leaves looked up by name in ``leaves``
    (a module-level recursion: a nested one would be a reference cycle that
    keeps every leaf alive until the garbage collector runs)."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}.") for k, v in tree.items()}
    return leaves[prefix[:-1]]


def shape_tree(defs):
    """The tree's shapes and dtypes as meta tensors (JAX: ShapeDtypeStruct)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def axes_tree(defs):
    """Tree of logical-axes tuples, matching init_tree's structure."""
    return tree_map(lambda d: d.axes, defs)


def param_count(defs) -> int:
    return int(sum(math.prod(d.shape) for _, d in named_leaves(defs)))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: via f32, exact
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)   # own, writable


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (a JAX parameter or cache pytree passed
    through ``np.asarray``) as tensors on ``device`` (default the card),
    key for key and leaf for leaf."""
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, device), tree)


def serving_params(params, cfg):
    """The tree with every leaf the models cast to ``cfg.dtype`` at each use
    stored in ``cfg.dtype`` once (the same bits, without a cast per step);
    the ``KEEP_F32`` leaves stay float32.  A no-op for a float32 config."""
    return _cast(params, compute_dtype(cfg))


def _cast(tree, dtype):
    return {k: (_cast(v, dtype) if isinstance(v, dict)
                else v if k in KEEP_F32 else v.to(dtype))
            for k, v in tree.items()}
