"""Cost accounting over the aten ops that a torch program dispatches: the
port's counterpart of ``repro.core.hlo_cost``, which parses compiled HLO.

Nothing here reads HLO.  :func:`analyze_program` runs the program once,
eagerly, under a ``TorchDispatchMode`` and counts every aten op it
dispatches.  Eager torch unrolls its loops (a Python ``for`` dispatches its
body once per trip), so no trip count is needed and ``unknown_loops`` is
always 0.  The counts follow the JAX module's rules:

  * flops       -- a dot-like op (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                   ``addbmm``, ``dot``, ``mv``, ``addmv``; ``matmul`` and
                   ``einsum`` decompose into them) counts
                   2 * prod(result) * prod(contracting), and the add fused
                   into ``addmm`` and its kin 1 per element; every other
                   aten arithmetic op 1 FLOP per result element; views,
                   copies, fills and factories none.  A convolution counts
                   2 * prod(result) * prod(window) * C_in / groups (the rule
                   of ``torch.utils.flop_counter``) plus 1 per element for
                   a bias, where JAX counts 2 per result element;
  * bytes       -- JAX's materialized-buffer proxy on aten ops: the result
                   bytes of every op that is not a view, plus the operand
                   bytes of the dot-like ops;
  * bytes_major -- eager torch's own traffic: eager torch fuses nothing, so
                   every op that is not a view reads its operands and
                   writes its result (JAX's TPU fusion view has no
                   counterpart here);
  * collectives -- the c10d ops the dispatcher shows, under JAX's kind
                   names: ``allreduce_`` -> all-reduce, ``allgather*`` ->
                   all-gather, ``reduce_scatter*`` -> reduce-scatter,
                   ``alltoall*`` -> all-to-all, ``send`` ->
                   collective-permute (JAX's ``ppermute``), and the
                   ``_c10d_functional`` forms alike.  A collective counts
                   its payload (the bytes it leaves in its output, a
                   ``send`` the bytes it sends) in ``coll``, ``bytes`` and
                   ``bytes_major``; a ``recv_`` counts nothing.

The port's own kernels launch through ``ctypes`` and never reach the
dispatcher: their FLOPs and bytes are not in these counts.  So that a
count over a kernel plan does not report 0 in silence, ``opaque_launches``
is the number of those launches the program made (the growth of
``repro_torch.kernels._build.launch_counts()`` across the call).  The
executed FLOPs of a kernel launch are ``repro_torch.audit.flops``'s count.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import conv_flop_count
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op names -> JAX's collective kinds.
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}
_C10D = ("c10d", "_c10d_functional")

#: Dot-like aten ops: their contracting extent from their arguments, and
#: whether an add is fused in (1 FLOP per result element).
_DOTS = {
    "mm": (lambda a: a[0].shape[-1], False),
    "bmm": (lambda a: a[0].shape[-1], False),
    "addmm": (lambda a: a[1].shape[-1], True),
    "baddbmm": (lambda a: a[1].shape[-1], True),
    "addbmm": (lambda a: a[1].shape[0] * a[1].shape[-1], True),
    "dot": (lambda a: a[0].shape[-1], False),
    "vdot": (lambda a: a[0].shape[-1], False),
    "mv": (lambda a: a[0].shape[-1], False),
    "addmv": (lambda a: a[1].shape[-1], True),
}

#: Aten ops that are views without saying so in their schema.
_VIEWS = {"_unsafe_view", "lift_fresh", "detach", "alias"}

#: Aten ops that copy, fill or make tensors: no FLOPs (JAX's copy,
#: broadcast, slice, concatenate, pad, parameter and constant).
_MOVES = {
    "_to_copy", "copy", "copy_", "clone", "lift_fresh_copy",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange",
    "fill", "fill_", "zero_", "randn", "rand", "randn_like", "rand_like",
    "normal_", "uniform_", "cat", "stack", "constant_pad_nd", "pad",
    "reflection_pad1d", "reflection_pad2d", "reflection_pad3d",
    "replication_pad1d", "replication_pad2d", "replication_pad3d",
    "roll", "flip", "repeat", "index", "index_select", "gather",
    "slice_scatter", "select_scatter", "_local_scalar_dense",
    "split_with_sizes_copy", "unbind_copy",
}


@dataclasses.dataclass
class ProgramCost:
    """The counts of one program run (fields as ``repro.core.hlo_cost``'s,
    plus ``opaque_launches``)."""
    flops: float = 0.0
    bytes: float = 0.0
    bytes_major: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    unknown_loops: int = 0
    #: Launches of the port's own kernels (``ctypes``, outside these counts).
    opaque_launches: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll.values())


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


def _numel(tree) -> int:
    return sum(x.numel() for x in _tensors(tree))


class _CostMode(TorchDispatchMode):
    """Counts every op dispatched while it is active into ``cost``."""

    def __init__(self, cost: ProgramCost):
        super().__init__()
        self.cost = cost
        self._coll = defaultdict(float)
        self._coll_counts = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._opname
        if ns in _C10D:
            self._collective(ns, name, args, out)
        elif ns == "aten" and not (func.is_view or name in _VIEWS):
            self._aten(name, args, kwargs, out)
        return out

    def _collective(self, ns, name, args, out) -> None:
        kind = _COLLECTIVE_KIND.get(name)
        if kind is None:                    # recv_, broadcast_, wait_tensor, ...
            return
        # The in-place c10d forms take their output tensors first (a send:
        # its payload); the functional forms return theirs.
        payload = _nbytes(out if ns == "_c10d_functional" else args[0])
        self._coll[kind] += payload
        self._coll_counts[kind] += 1
        self.cost.bytes += payload
        self.cost.bytes_major += payload

    def _aten(self, name, args, kwargs, out) -> None:
        c = self.cost
        result = _nbytes(out)
        elems = _numel(out)
        c.bytes += result
        c.bytes_major += _nbytes((args, kwargs)) + result
        if name in _DOTS:
            contract, fused_add = _DOTS[name]
            operands = _tensors(args)
            c.flops += 2.0 * elems * contract(operands) + (elems if fused_add else 0)
            c.bytes += _nbytes(operands)
        elif name == "convolution":
            x, w, bias, transposed = args[0], args[1], args[2], bool(args[6])
            c.flops += conv_flop_count(list(x.shape), list(w.shape),
                                       list(out.shape), transposed)
            c.flops += elems if bias is not None else 0
        elif name not in _MOVES:
            c.flops += elems


def analyze_program(fn, *args, **kwargs) -> ProgramCost:
    """Run ``fn(*args, **kwargs)`` once and count the aten ops it
    dispatches (module docstring).  The program runs for real, on its
    inputs' device; its result is dropped."""
    from repro_torch.kernels import _build

    before = sum(_build.launch_counts().values())
    cost = ProgramCost()
    mode = _CostMode(cost)
    with mode:
        fn(*args, **kwargs)
    cost.coll = dict(mode._coll)
    cost.coll_counts = dict(mode._coll_counts)
    cost.opaque_launches = sum(_build.launch_counts().values()) - before
    return cost
