"""Distributed stencil runtime: spatial decomposition + halo exchange (the
counterpart of ``repro.stencil.distributed``, on ``torch.distributed``).

Each rank holds one spatial shard of the grid, a plain tensor of the
shard's shape.  A ``torch.distributed.device_mesh.DeviceMesh`` names the
mesh dims; ``dim_axis_names`` gives, per grid dim, the mesh dim it is
sharded over (``None`` = unsharded), as JAX's ``shard_spec`` does.  Each
step (or fused group of ``t`` steps) exchanges halos with the neighbour
shards over ``batch_isend_irecv`` rings (periodic global boundary == ring
wrap), then applies the stencil locally.

Three execution modes, as in JAX:

  * ``stepwise``: halo depth ``r``, one exchange round per time step.
  * ``fused``:    halo depth ``t*r``, ONE exchange round per ``t`` steps;
    the halo overlap is recomputed locally (the distributed alpha).
  * ``overlap``:  stepwise's exchange schedule, with the interior update
    issued while the halo slabs are in flight: each step POSTS the sends
    and receives of the one sharded dim, launches the interior update
    (shard-local data only) on the current stream, only then waits on the
    exchange and runs the two ``r``-deep edge strips.  Every output cell
    sees the same taps in the same order as in ``stepwise``.  Requires
    exactly one sharded dim.

The ring of one mesh dim, per rank: its right edge goes to the next shard
(that shard's left halo, tag 0) and its left edge to the previous shard
(its right halo, tag 1), posted in that fixed order, sends before
receives, so a ring of 2 -- whose previous and next peer are one rank --
cannot cross its two slabs.  A mesh dim of size 1 is JAX's identity
permutation: a local wrap with no P2P op (``gloo`` refuses a send to
self).  Under ``gloo``, which moves host memory only, a shard on the card
stages each slab through a pinned host buffer, in the exchange's own code.

Boundaries: ``boundary`` names the per-axis global edge mode.
``periodic`` is the ring wrap; non-periodic unsharded dims pad with the
mode, non-periodic sharded dims exchange as usual and the FIRST / LAST
shard along the mesh dim (its mesh coordinate) overwrites its
out-of-domain slab with the mode's fill.  ``fused`` rejects non-periodic
specs, as in JAX.

``local_apply`` is pluggable; :func:`kernel_local_apply` runs the local
update through a plan of the port's kernels (``stencil_plan``).

Counters: every stepper counts its calls, exchange rounds, ring shifts,
P2P ops and halo bytes (``stepper.stats``); :func:`overlap_stats` counts
the overlap steps' interleave; :func:`overlap_independence_report` checks
a recorded overlap step's schedule.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.testing import faults as _faults
from .boundary import is_periodic, resolve_boundary
from .reference import _offsets, _pad_index

#: The P2P tags of the ring's two directions: forward (a shard's last
#: rows, the next shard's left halo) and backward (its first rows, the
#: previous shard's right halo).
_FWD, _BWD = 0, 1


def apply_stencil_valid(xp: torch.Tensor, weights,
                        support=None) -> torch.Tensor:
    """Stencil on a halo-extended block: output shape = input - 2r per dim.

    ``support``: optional host-side bool mask of the kernel's nonzero
    structure; structurally-zero taps are skipped.  Taps accumulate in
    the oracle's row-major order."""
    w = torch.as_tensor(np.asarray(weights)).to(device=xp.device,
                                                dtype=xp.dtype)
    dim = w.ndim
    radius = (w.shape[0] - 1) // 2
    out_shape = tuple(n - 2 * radius for n in xp.shape)
    y = torch.zeros(out_shape, dtype=xp.dtype, device=xp.device)
    for off in _offsets(radius, dim):
        widx = tuple(o + radius for o in off)
        if support is not None and not bool(np.asarray(support)[widx]):
            continue
        sl = tuple(slice(radius + o, radius + o + n)
                   for o, n in zip(off, out_shape))
        y = y + w[widx] * xp[sl]
    return y


# ---------------------------------------------------------------------------
# Rings and the exchange
# ---------------------------------------------------------------------------
class _Ring(NamedTuple):
    """One mesh dim as seen by this rank: its size, this rank's coordinate,
    the dim's process group and the global ranks of the two neighbours."""
    n: int
    idx: int
    group: Optional[object]
    prev: Optional[int]
    next: Optional[int]
    backend: Optional[str]


class _Pending:
    """Posted ring shifts of one dim: ``wait()`` returns ``(lo, hi)``, the
    left halo (the previous shard's last rows) and the right halo (the
    next shard's first rows), on the shard's device."""

    def __init__(self, lo, hi, works=(), keep=(), device=None):
        self._lo, self._hi, self._works = lo, hi, works
        self._keep = keep           # send buffers, alive until the wait
        self._device = device       # staged: copy the slabs back to it

    def wait(self):
        for w in self._works:
            w.wait()
        lo, hi = self._lo, self._hi
        if self._device is not None:
            # Host -> card on the current stream.  The pinned buffers are
            # reused next round only after that round's card -> host copy
            # of its send slabs, which synchronises the stream first.
            lo = lo.to(self._device, non_blocking=True)
            hi = hi.to(self._device, non_blocking=True)
        return lo, hi


class _Comm:
    """The mesh side of one stepper: rings, pinned staging buffers, the
    counters and the optional schedule record."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._rings = {}
        self._host = {}
        self.stats = {"calls": 0, "rounds": 0, "ring_shifts": 0,
                      "p2p_ops": 0, "halo_bytes": 0}
        #: ``None``, or a list the step appends its schedule to (the
        #: overlap independence report).
        self.schedule = None

    def ring(self, axis_name: str) -> _Ring:
        ring = self._rings.get(axis_name)
        if ring is None:
            names = tuple(self.mesh.mesh_dim_names or ())
            if axis_name not in names:
                raise ValueError(f"mesh has no dim named {axis_name!r} "
                                 f"(its dims: {names})")
            i = names.index(axis_name)
            n, idx = self.mesh.size(i), self.mesh.get_local_rank(i)
            if n == 1:
                ring = _Ring(1, 0, None, None, None, None)
            else:
                group = self.mesh.get_group(i)
                ranks = dist.get_process_group_ranks(group)
                ring = _Ring(n, idx, group, ranks[(idx - 1) % n],
                             ranks[(idx + 1) % n], dist.get_backend(group))
            self._rings[axis_name] = ring
        return ring

    def record(self, what: str, reads=()) -> None:
        if self.schedule is not None:
            self.schedule.append((what, tuple(reads)))

    def _pinned(self, key, like: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def post(self, x: torch.Tensor, dim: int, h: int,
             axis_name: str) -> _Pending:
        """Post the ring shifts of ``dim`` over ``axis_name``: the last
        ``h`` rows go forward, the first ``h`` backward."""
        ring = self.ring(axis_name)
        m = x.shape[dim]
        to_next = x.narrow(dim, m - h, h)        # the next shard's left halo
        to_prev = x.narrow(dim, 0, h)            # the previous one's right halo
        self.stats["ring_shifts"] += 2
        self.stats["halo_bytes"] += 2 * to_next.numel() * x.element_size()
        self.record("post", (f"dim{dim}",))
        if ring.n == 1:
            # The identity permutation: a local wrap, no P2P op.
            return _Pending(to_next, to_prev)
        staged = x.device.type != "cpu" and ring.backend == "gloo"
        if staged:
            # gloo moves host memory only: stage through pinned buffers
            # (the copies synchronise the stream, so the slabs are final).
            s_fwd = self._pinned((dim, "send", _FWD), to_next)
            s_fwd.copy_(to_next)
            s_bwd = self._pinned((dim, "send", _BWD), to_prev)
            s_bwd.copy_(to_prev)
            r_lo = self._pinned((dim, "recv", _FWD), to_next)
            r_hi = self._pinned((dim, "recv", _BWD), to_prev)
        else:
            s_fwd, s_bwd = to_next.contiguous(), to_prev.contiguous()
            r_lo, r_hi = torch.empty_like(s_fwd), torch.empty_like(s_bwd)
        ops = [dist.P2POp(dist.isend, s_fwd, ring.next, ring.group, _FWD),
               dist.P2POp(dist.isend, s_bwd, ring.prev, ring.group, _BWD),
               dist.P2POp(dist.irecv, r_lo, ring.prev, ring.group, _FWD),
               dist.P2POp(dist.irecv, r_hi, ring.next, ring.group, _BWD)]
        works = dist.batch_isend_irecv(ops)
        self.stats["p2p_ops"] += len(ops)
        return _Pending(r_lo, r_hi, works, (s_fwd, s_bwd),
                        x.device if staged else None)


def _halo_exchange_dim(x: torch.Tensor, dim: int, radius: int,
                       axis_name: str, comm: _Comm) -> torch.Tensor:
    """Extend ``x`` by ``radius`` on both sides of ``dim`` with neighbour
    data (periodic ring: shard i receives its left halo from shard i-1's
    right edge and its right halo from shard i+1's left edge)."""
    lo, hi = comm.post(x, dim, radius, axis_name).wait()
    comm.record("wait")
    return torch.cat([lo, x, hi], dim=dim)


def _pad_dim(x: torch.Tensor, dim: int, h: int, mode: str) -> torch.Tensor:
    """Pad ``h`` cells on both sides of ``dim`` in the boundary ``mode``
    (``np.pad``'s wrap / constant / reflect / edge)."""
    if mode == "zero":
        pad = [0, 0] * x.ndim
        k = 2 * (x.ndim - 1 - dim)          # F.pad lists the last dim first
        pad[k] = pad[k + 1] = h
        return F.pad(x, pad)
    return x.index_select(dim, _pad_index(x.shape[dim], h, mode, x.device))


def _dim_fill(x: torch.Tensor, dim: int, h: int, mode: str,
              lo: bool) -> torch.Tensor:
    """The ``h``-deep boundary fill of one side of ``dim``, synthesized
    from the (unextended) shard-local rows of ``x`` -- what an edge shard
    writes where an interior shard keeps its received halo slab."""
    m = x.shape[dim]
    if mode == "zero":
        return torch.zeros_like(x.narrow(dim, 0, h))
    if mode == "replicate":
        reps = [1] * x.ndim
        reps[dim] = h
        return x.narrow(dim, 0 if lo else m - 1, 1).repeat(reps)
    if mode == "reflect":
        src = x.narrow(dim, 1, h) if lo else x.narrow(dim, m - h - 1, h)
        return torch.flip(src, dims=(dim,))
    raise ValueError(f"unknown boundary mode {mode!r}")


def _mask_edge_shards(xe: torch.Tensor, dim: int, radius: int, mode: str,
                      axis_name: str, comm: _Comm) -> torch.Tensor:
    """Overwrite the FIRST/LAST shards' out-of-domain halo slabs of the
    exchanged dim with the mode's fill; interior shards keep their true
    received slabs.  The edge shards are told by their mesh coordinate."""
    ring = comm.ring(axis_name)
    m = xe.shape[dim]
    core = xe.narrow(dim, radius, m - 2 * radius)
    lo = (_dim_fill(core, dim, radius, mode, True) if ring.idx == 0
          else xe.narrow(dim, 0, radius))
    hi = (_dim_fill(core, dim, radius, mode, False) if ring.idx == ring.n - 1
          else xe.narrow(dim, m - radius, radius))
    return torch.cat([lo, core, hi], dim=dim)


def _extend(x: torch.Tensor, radius: int,
            dim_axis_names: Sequence[Optional[str]],
            modes: Optional[Sequence[str]], comm: _Comm) -> torch.Tensor:
    """Halo-extend every dim, in order: a ring exchange when sharded, a
    mode pad when local.  One exchange round.  ``modes`` ``None`` = all
    periodic.  Non-periodic sharded dims still run the full ring exchange
    (every shard takes part), then the edge shards mask their
    out-of-domain slab with the mode's locally-synthesized fill."""
    # Fault-injection hook (repro_torch.testing.faults): a failed
    # exchange, raised before any P2P op is posted.  No-op unless armed.
    _faults.maybe_fail("halo")
    comm.stats["rounds"] += 1
    if modes is None:
        modes = ("periodic",) * len(dim_axis_names)
    for dim, axis_name in enumerate(dim_axis_names):
        if axis_name is None:
            x = _pad_dim(x, dim, radius, modes[dim])
        else:
            x = _halo_exchange_dim(x, dim, radius, axis_name, comm)
            if modes[dim] != "periodic":
                x = _mask_edge_shards(x, dim, radius, modes[dim], axis_name,
                                      comm)
    return x


#: Interleave counters of the ``overlap`` stepper (JAX counts them as its
#: step traces; here as the step runs): ``interior_before_recv_consumed``
#: counts steps whose interior update was launched before the exchange
#: was waited on.  Reset with :func:`reset_overlap_stats`; snapshot with
#: :func:`overlap_stats`.
_OVERLAP_STATS = {"overlap_steps": 0, "exchanges_issued": 0,
                  "interior_launches": 0, "edge_launches": 0,
                  "interior_before_recv_consumed": 0}


def overlap_stats() -> dict:
    """Snapshot of the overlap stepper's interleave counters."""
    return dict(_OVERLAP_STATS)


def reset_overlap_stats() -> None:
    for k in _OVERLAP_STATS:
        _OVERLAP_STATS[k] = 0


def _overlap_step(x: torch.Tensor, w, radius: int,
                  dim_axis_names: Sequence[Optional[str]],
                  modes: Sequence[str], sd: int, local_apply,
                  comm: _Comm) -> torch.Tensor:
    """One exchange/compute step on one shard.  Post the sharded dim's
    sends and receives FIRST, pad the unsharded dims, launch the interior
    update (no receive buffer read) while the slabs are in flight, only
    then wait on the exchange and run the two ``r``-deep edge strips from
    the received slabs, and reassemble.  Every output cell sees the same
    tap values in the same order as in ``stepwise``."""
    _faults.maybe_fail("halo")
    axis_name = dim_axis_names[sd]

    # 1. Post the exchange: the edge slabs of the UNEXTENDED shard (the
    #    unsharded dims' pads commute with the slabs; padding the received
    #    slabs below reproduces stepwise's layout).
    pending = comm.post(x, sd, radius, axis_name)
    comm.stats["rounds"] += 1
    _OVERLAP_STATS["exchanges_issued"] += 1

    def pad_unsharded(arr):
        for dim, ax in enumerate(dim_axis_names):
            if ax is None:
                arr = _pad_dim(arr, dim, radius, modes[dim])
        return arr

    # 2. Interior: shard-local data only.  ``local_apply`` trims radius
    #    from EVERY dim, which along the unextended sharded dim is exactly
    #    the rows whose support would need the halo.
    x1 = pad_unsharded(x)
    interior = local_apply(x1, w, 1)
    comm.record("interior", ("shard",))
    _OVERLAP_STATS["interior_launches"] += 1
    _OVERLAP_STATS["interior_before_recv_consumed"] += 1
    _OVERLAP_STATS["overlap_steps"] += 1

    # 3. Edge strips: first touch of the received slabs.  Edge shards of
    #    a non-periodic dim overwrite the out-of-domain slab with the
    #    mode's locally-synthesized fill.
    recv_lo, recv_hi = pending.wait()
    comm.record("wait")
    lo_halo, hi_halo = pad_unsharded(recv_lo), pad_unsharded(recv_hi)
    if modes[sd] != "periodic":
        ring = comm.ring(axis_name)
        if ring.idx == 0:
            lo_halo = _dim_fill(x1, sd, radius, modes[sd], True)
        if ring.idx == ring.n - 1:
            hi_halo = _dim_fill(x1, sd, radius, modes[sd], False)
    m1 = x1.shape[sd]
    lo_in = torch.cat([lo_halo, x1.narrow(sd, 0, 2 * radius)], dim=sd)
    hi_in = torch.cat([x1.narrow(sd, m1 - 2 * radius, 2 * radius), hi_halo],
                      dim=sd)
    lo_out = local_apply(lo_in, w, 1)
    comm.record("edge", ("recv_lo", "shard"))
    hi_out = local_apply(hi_in, w, 1)
    comm.record("edge", ("shard", "recv_hi"))
    _OVERLAP_STATS["edge_launches"] += 2
    comm.record("reassemble", ("edge", "interior", "edge"))
    return torch.cat([lo_out, interior, hi_out], dim=sd)


def overlap_independence_report(mesh, dim_axis_names, weights, x,
                                boundary=None,
                                local_apply: Optional[Callable] = None
                                ) -> dict:
    """Check, on the record of one overlap step, that its interior update
    is independent of the in-flight exchange.  JAX proves this on the
    traced jaxpr; PyTorch runs eagerly, so this runs ONE overlap step on
    the local shard ``x`` (a collective: every rank of the mesh calls it)
    and reads its schedule: which launch read which buffer, and when the
    exchange was waited on.

    Keys as in JAX: ``ppermute_eqns`` counts the ring shifts posted (each
    one send and one receive: the P2P ops are in ``p2p_ops``, 0 for a
    one-shard ring's local wrap); ``reassembly_concats`` counts
    reassemblies of the pattern edge / interior / edge;
    ``mixed_concats`` the same (the port concatenates once per step).
    ``interior_independent`` holds when at least two ring shifts were
    posted, no interior launch read a receive buffer, and the interior was
    launched before the first wait."""
    step = make_distributed_stepper(
        mesh, dim_axis_names, weights, t=1, mode="overlap",
        local_apply=local_apply, boundary=boundary)
    step.comm.schedule = []
    step(x)
    sched = step.comm.schedule
    kinds = [k for k, _ in sched]
    first_wait = kinds.index("wait") if "wait" in kinds else len(kinds)
    interiors = [i for i, (k, _) in enumerate(sched) if k == "interior"]
    reads_recv = any(r.startswith("recv") for k, reads in sched
                     if k == "interior" for r in reads)
    reassembly = sum(1 for k, reads in sched if k == "reassemble"
                     and reads == ("edge", "interior", "edge"))
    shifts = step.stats["ring_shifts"]
    return {
        "ppermute_eqns": shifts,
        "p2p_ops": step.stats["p2p_ops"],
        "mixed_concats": reassembly,
        "reassembly_concats": reassembly,
        "interior_before_wait": bool(interiors)
        and max(interiors) < first_wait,
        "interior_reads_recv": reads_recv,
        "interior_independent": shifts >= 2 and bool(interiors)
        and not reads_recv and max(interiors) < first_wait
        and reassembly >= 1,
    }


class DistributedStepper:
    """A ``t``-step distributed stencil update of this rank's shard:
    ``step(x_local) -> x_local'``.  ``stats`` counts calls, exchange
    rounds (halo extensions), ring shifts, P2P ops and halo bytes (both
    directions, every sharded dim, local wraps included -- what
    :func:`halo_bytes_per_step` prices); ``reset_stats()`` zeroes them."""

    def __init__(self, comm: _Comm, shard_fn: Callable):
        self.comm = comm
        self._fn = shard_fn

    @property
    def stats(self) -> dict:
        return dict(self.comm.stats)

    def reset_stats(self) -> None:
        for k in self.comm.stats:
            self.comm.stats[k] = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.comm.stats["calls"] += 1
        return self._fn(x)


def make_distributed_stepper(
    mesh,
    dim_axis_names: Sequence[Optional[str]],
    weights,
    t: int = 1,
    mode: str = "stepwise",
    local_apply: Optional[Callable] = None,
    boundary=None,
) -> DistributedStepper:
    """Build a ``t``-step distributed stencil update of one rank's shard.

    Args:
      mesh: a ``DeviceMesh`` with ``mesh_dim_names``.
      dim_axis_names: per grid-dim mesh dim name (None = unsharded dim).
      weights: dense ``(2r+1)^d`` base kernel.
      t: number of time steps per invocation.
      mode: "stepwise" (t exchanges, halo r), "fused" (1 exchange, halo
        t*r) or "overlap" (stepwise's schedule with the interior update
        issued before the exchange is waited on; requires exactly one
        sharded dim).
      local_apply: optional ``f(x_extended, weights, t) -> block`` running
        the local update (e.g. :func:`kernel_local_apply`).  It receives a
        block extended by ``t*r`` (fused) or ``r`` (stepwise/overlap,
        called t times with t=1) and must return the valid interior.
      boundary: per-axis global boundary modes; ``None`` = all periodic.
        ``fused`` rejects non-periodic specs.

    Returns a :class:`DistributedStepper` operating on this rank's local
    shard (JAX's operates on the globally sharded array); every rank of
    the mesh calls it together.
    """
    w = np.asarray(weights)
    radius = (w.shape[0] - 1) // 2
    support = w != 0                             # static structure
    modes = resolve_boundary(boundary, len(dim_axis_names))
    comm = _Comm(mesh)

    if local_apply is None:
        def local_apply(xp, w_, steps):
            for _ in range(steps):
                xp = apply_stencil_valid(xp, w_, support=support)
            return xp

    if mode == "stepwise":
        def shard_fn(x):
            for _ in range(t):
                xe = _extend(x, radius, dim_axis_names, modes, comm)
                x = local_apply(xe, w, 1)
            return x
    elif mode == "fused":
        if not is_periodic(modes):
            raise ValueError(
                "fused halo exchange cannot honor non-periodic boundaries "
                f"(boundary={modes!r}): one depth-t*r exchange supplies "
                "step-1 boundary values to all t steps, but every mode "
                "re-applies per step (DESIGN.md §15); use mode='stepwise' "
                "or 'overlap'")

        def shard_fn(x):
            xe = _extend(x, radius * t, dim_axis_names, None, comm)
            return local_apply(xe, w, t)
    elif mode == "overlap":
        sharded = [d for d, ax in enumerate(dim_axis_names)
                   if ax is not None]
        if len(sharded) != 1:
            raise ValueError(
                "overlap mode interleaves ONE exchange with the interior "
                f"update and needs exactly one sharded dim, got "
                f"shard_spec {tuple(dim_axis_names)!r}; shard a single "
                "dim or use mode='stepwise'")
        sd = sharded[0]

        def shard_fn(x):
            for _ in range(t):
                x = _overlap_step(x, w, radius, dim_axis_names, modes, sd,
                                  local_apply, comm)
            return x
    else:
        raise ValueError(f"unknown mode {mode!r}")

    return DistributedStepper(comm, shard_fn)


def kernel_local_apply(
    backend: str = "fused_matmul_reuse",
    tile_m: Optional[int] = None,
    w_tile: Optional[int] = None,
    z_slab: Optional[int] = None,
) -> Callable:
    """Build a ``local_apply`` plug-in running the port's kernels (the
    counterpart of JAX's ``pallas_local_apply``).

    The returned callable matches ``make_distributed_stepper``'s contract:
    it receives each shard's halo-extended block (depth ``steps * r``, any
    grid rank the kernels support) and returns the valid interior.  It
    runs a periodic ``stencil_plan`` of ``backend`` on the block's own
    device (the card's kernels on a CUDA shard, their plain versions on a
    CPU one); the kernel's own modulo wrap is harmless because the halo
    ring it wraps into is discarded.  Plans come from the plan cache: one
    per (block shape, depth) signature, reused across steps and calls.

    The tile is the port's tile rule's unless pinned (``tile_m``,
    ``w_tile``, ``z_slab``): JAX pins the whole extended block as one
    strip, which does not fit 227 KB of shared memory.  The guard wraps
    the whole distributed plan instead (``guarded_stencil_plan(mesh=)``),
    whose ladder every rank walks alike.
    """

    def local_apply(xe, w, steps):
        from repro_torch.kernels.plan import stencil_plan  # avoid a cycle

        wn = np.asarray(w)
        h = steps * ((wn.shape[0] - 1) // 2)
        kw = dict(backend=backend, device=xe.device, w_tile=w_tile)
        if xe.ndim >= 2:
            kw["tile_m"] = tile_m
        if xe.ndim == 3:
            kw["z_slab"] = z_slab
        full = stencil_plan(wn, xe.shape, xe.dtype, steps, **kw)(xe)
        if not h:
            return full
        return full[tuple(slice(h, -h) for _ in range(xe.ndim))]

    return local_apply


def halo_bytes_per_step(
    local_shape: Sequence[int],
    dim_axis_names: Sequence[Optional[str]],
    radius: int,
    t: int,
    mode: str,
    dtype_bytes: int,
) -> int:
    """Analytic per-t-steps halo traffic (both directions, all sharded
    dims), a copy of JAX's.  ``overlap`` moves the same depth-r slabs on
    the same t-exchange schedule as ``stepwise``, except the slabs are
    sliced from the UNEXTENDED shard, so their faces skip the earlier-dim
    halo growth stepwise pays."""
    h = radius if mode in ("stepwise", "overlap") else radius * t
    exchanges = t if mode in ("stepwise", "overlap") else 1
    total = 0
    shape = list(local_shape)
    for dim, ax in enumerate(dim_axis_names):
        if ax is None:
            continue
        face = 1
        for d2, n in enumerate(shape):
            if d2 != dim:
                # ``_extend`` processes dims in order, so by the time dim
                # is exchanged EVERY earlier dim is already halo-extended,
                # by exchange or pad, and the face spans n + 2h along it.
                face *= n + (2 * h if d2 < dim and mode != "overlap" else 0)
        total += 2 * h * face * dtype_bytes
    return total * exchanges


# ---------------------------------------------------------------------------
# Shards of a global grid (JAX: device_put with a NamedSharding, and
# np.asarray of the sharded result)
# ---------------------------------------------------------------------------
def _coords(mesh, rank: int) -> tuple:
    """Mesh coordinates of global ``rank``."""
    pos = (mesh.mesh == rank).nonzero()
    if pos.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return tuple(int(c) for c in pos[0])


def _shard_slices(shape, mesh, dim_axis_names, rank: int) -> tuple:
    names = tuple(mesh.mesh_dim_names)
    coords = _coords(mesh, rank)
    out = []
    for n, ax in zip(shape, dim_axis_names):
        if ax is None:
            out.append(slice(0, n))
            continue
        i = names.index(ax)
        parts = mesh.size(i)
        m = n // parts
        out.append(slice(coords[i] * m, (coords[i] + 1) * m))
    return tuple(out)


def shard_of(x: torch.Tensor, mesh, dim_axis_names) -> torch.Tensor:
    """This rank's shard of the global grid ``x`` (a contiguous copy)."""
    sl = _shard_slices(x.shape, mesh, dim_axis_names, dist.get_rank())
    return x[sl].contiguous()


def gather_shards(x_local: torch.Tensor, mesh, dim_axis_names,
                  grid_shape: Sequence[int], dst: int = 0):
    """Assemble the global grid on rank ``dst`` from every rank's shard
    (a collective over the default group, through host memory); other
    ranks get ``None``.  The result lies on the CPU."""
    host = x_local.detach().to("cpu").contiguous()
    world = dist.get_world_size()
    rank = dist.get_rank()
    parts = [torch.empty_like(host) for _ in range(world)] \
        if rank == dst else None
    dist.gather(host, parts, dst=dst)
    if rank != dst:
        return None
    out = torch.empty(tuple(grid_shape), dtype=host.dtype)
    for r, part in enumerate(parts):
        out[_shard_slices(grid_shape, mesh, dim_axis_names, r)] = part
    return out
