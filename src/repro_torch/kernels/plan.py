"""StencilPlan: build-once execution plans (the counterpart of
``repro.kernels.plan``).

``stencil_plan(weights, grid_shape, dtype, t)`` runs the paper's decision
procedure once -- spec inference, backend selection under the H100 model,
tile sizing and weight preprocessing inside the chosen backend's ``build``
-- and returns a :class:`StencilPlan` whose ``plan(x)`` / ``plan.step(x)`` /
``plan.run(x, n)`` execute with zero re-analysis.  PyTorch runs eagerly,
so the executable is the builder's runner itself (no ``jit``).  With
``batch=B`` a plan consumes ``(B,) + grid_shape`` and advances B
independent grids per call, equal bit for bit to a loop of unbatched
plans: ``batch_mode="vmap"`` launches each kernel call once for the whole
batch (K11), ``"map"`` loops the unbatched runner.

Plans run on the card unless the caller asks for the CPU: ``device=None``
means ``"cuda"`` and raises when no GPU is present.  On ``device="cpu"``
the kernel wrappers run their plain versions.  Plans are cached
process-wide in a bounded LRU keyed on the full execution signature,
device and the tile rule's budget included, with hit/miss counters and
the guard layer's counters (:func:`plan_cache_stats`) and a
negative-result registry of failed signatures (:func:`note_plan_failure`,
:func:`failed_plan`), which ``repro_torch.kernels.guard`` keeps.  With
``audit=True`` (or ``REPRO_AUDIT=1``) a built plan carries the static
auditor's report on its launches (``plan.audit_report``,
``repro_torch.audit``), counted in ``audits_run`` / ``audit_violations``.
With ``mesh=`` / ``shard_spec=`` a plan drives the distributed
halo-exchange stepper (``repro_torch.stencil.distributed``): it consumes
and returns this rank's local shard, its local update runs through the
port's kernels, and ``plan.halo_plan`` describes the exchange schedule.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import perfmodel as pm
from repro_torch.core.envutil import env_flag, env_int
from repro_torch.core.selector import Decision, select_backend
from repro_torch.stencil.boundary import (BoundaryLike, boundary_label,
                                          is_periodic, resolve_boundary)
from repro_torch.stencil.spec import StencilSpec
from repro_torch.stencil.weights import jacobi_weights
from repro_torch.testing import faults as _faults
from . import registry
from .common import BAND_N, fold_batch, priced_tile_geom, smem_budget_bytes

#: Grid dtypes the port accepts, by numpy/torch name.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or scalar type
    (``np.float32``, ``jnp.bfloat16``) or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported grid dtype {dtype!r}; the port runs "
                        f"{tuple(_DTYPES)}") from None


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stencil_plan runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the kernels' plain "
            "versions on the CPU")
    return dev


def spec_from_weights(weights) -> StencilSpec:
    """Infer (shape, d, r) from a dense kernel's support."""
    w = np.asarray(weights)
    radius = (w.shape[0] - 1) // 2
    dim = w.ndim
    box_points = np.count_nonzero(w)
    star_points = 2 * dim * radius + 1
    shape = "star" if box_points <= star_points else "box"
    return StencilSpec(shape, dim, radius)


def decide(
    spec: StencilSpec, t: int, dtype_bytes: int,
    hw: pm.HardwareSpec = pm.H100_SXM_DATASHEET,
    tile_n: int = 128, strip_m: int = 128,
    h_block: Optional[int] = None,
    z_slab: Optional[int] = None,
    z_block: Optional[int] = None,
    w_tile: Optional[int] = None,
    w_block: Optional[int] = None,
    use_sparse_unit: bool = False,
    boundary: BoundaryLike = None,
) -> Decision:
    """THE decision path: plan building and ``ops.explain`` both consult
    this one function, so they never disagree about the priced
    ``Decision``.  Same arguments as the JAX ``decide``; the default
    ``hw`` is the H100 data-sheet spec."""
    return select_backend(spec, t, dtype_bytes=dtype_bytes, hw=hw,
                          tile_n=tile_n, strip_m=strip_m, h_block=h_block,
                          z_slab=z_slab, z_block=z_block,
                          w_tile=w_tile, w_block=w_block,
                          use_sparse_unit=use_sparse_unit,
                          boundary=boundary)


def geom_pricing(geom) -> dict:
    """The geometry arguments of :func:`decide` that price ``geom``, the
    CTA tile ``resolve_tile_geom`` resolved (1D: the lift's pricing
    geometry, which ``decide`` resolves itself)."""
    if geom.dim == 1:
        return {}
    out = dict(strip_m=geom.strip_m, h_block=geom.h_block,
               w_tile=geom.w_tile, w_block=geom.w_block)
    if geom.dim == 3:
        out.update(z_slab=geom.z_slab, z_block=geom.z_block)
    return out


class StencilPlan:
    """A built, reusable stencil execution plan; calling it advances the
    grid ``t`` time steps.  ``decision`` is the priced :class:`Decision`
    (always populated, even under a backend override), ``backend`` the
    backend that executes, ``device`` where it runs, ``geom`` the CTA tile
    the decision priced, ``fn`` the runner."""

    def __init__(self, *, spec, weights, grid_shape, dtype, t, hw, backend,
                 decision, fn, device, geom, key=None, build_time_s=0.0,
                 ctx=None, boundary=None, batch=None, batch_mode=None,
                 mesh=None, shard_spec=None, dist_mode=None, halo_plan=None):
        self.spec = spec
        self.weights = weights
        self.grid_shape = grid_shape
        #: Grids per call (``None``: unbatched) and the resolved fold.
        self.batch = batch
        self.batch_mode = batch_mode
        self.dtype = dtype
        self.t = t
        self.hw = hw
        self.backend = backend
        self.decision = decision
        self.fn = fn
        self.device = device
        self.geom = geom
        self.key = key
        self.build_time_s = build_time_s
        self.ctx = ctx
        self.boundary = boundary
        #: The distributed plan's mesh, shard spec, mode and exchange
        #: schedule (``None`` for a local plan).
        self.mesh = mesh
        self.shard_spec = shard_spec
        self.dist_mode = dist_mode
        self.halo_plan = halo_plan
        #: Whether a call has run to its end (the first call is where a
        #: plan first reaches its kernels: repro_torch.testing.faults).
        self._reached = False
        #: The static auditor's report (``repro_torch.audit.AuditReport``),
        #: attached when the plan was built with auditing on.
        self.audit_report = None

    @property
    def input_shape(self) -> Tuple[int, ...]:
        """The tensor shape one call consumes: ``grid_shape``, or
        ``(batch,) + grid_shape`` for a batched plan, or this rank's
        local shard for a distributed one."""
        if self.halo_plan is not None:
            return self.halo_plan["local_shape"]
        if self.batch is None:
            return self.grid_shape
        return (self.batch,) + self.grid_shape

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.input_shape:
            if self.halo_plan is not None:
                built = (f"local shard {self.input_shape} (grid "
                         f"{self.grid_shape}, shard_spec {self.shard_spec})")
            elif self.batch is None:
                built = f"grid {self.grid_shape}"
            else:
                built = (f"input {self.input_shape} (grid {self.grid_shape}, "
                         f"batch {self.batch})")
            raise ValueError(
                f"plan was built for {built}, got {tuple(x.shape)}; build a "
                "new plan for a new geometry")
        if x.device.type != self.device.type or x.dtype != self.dtype:
            raise ValueError(
                f"plan was built for {self.dtype} on {self.device}, got "
                f"{x.dtype} on {x.device}")
        if self._reached:
            return self.fn(x)
        with _faults.first_call():
            y = self.fn(x)
        self._reached = True
        return y

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """Alias for ``plan(x)``: one invocation = ``t`` time steps."""
        return self(x)

    def run(self, x: torch.Tensor, n_steps: int) -> torch.Tensor:
        """``n_steps`` plan invocations (``n_steps * t`` time steps)."""
        if n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        for _ in range(n_steps):
            x = self(x)
        return x

    def explain(self) -> str:
        """Human-readable account of what the plan does and why."""
        d = self.decision
        lines = [
            f"StencilPlan {self.spec.name} t={self.t} grid={self.grid_shape} "
            + ("" if self.batch is None
               else f"batch={self.batch} ({self.batch_mode}) ")
            + f"dtype={self.dtype} on {self.device} priced as {self.hw.name}",
            f"  executes : {self.backend}"
            + ("" if self.backend == d.backend
               else f" (override; auto would pick {d.backend})"),
            f"  scenario : {d.scenario}",
            f"  speedup  : {d.predicted_speedup:.2f}x (best matrix vs vector)",
            f"  reason   : {d.reason}",
            "  candidates (effective FLOP/s): "
            + ", ".join(f"{k}={v:.3g}" for k, v in d.candidates.items()),
        ]
        if self.boundary is not None and not is_periodic(self.boundary):
            lines.insert(2, f"  boundary : {boundary_label(self.boundary)}")
        staging = getattr(self.fn, "staging", None)
        if staging is not None:
            lines.insert(2, f"  staging  : {staging}")
        ws = getattr(self.fn, "workspace", None)
        if ws is not None:
            lines.insert(2, f"  workspace: {ws.total_bytes} bytes of device "
                            f"memory at each launch, {ws.ctas} persistent "
                            f"CTAs x {ws.slice_bytes}-byte slices (the "
                            "layout fits no CTA and no cluster: the tile "
                            "rule's fourth rung)")
        if self.halo_plan is not None:
            hp = self.halo_plan
            line = (f"  halo plan: mode={hp['mode']} depth={hp['halo_depth']} "
                    f"exchanges/call={hp['exchanges_per_call']} "
                    f"bytes/shard/call={hp['halo_bytes_per_call']}")
            if "interior_fraction" in hp:
                line += (" overlap: interior_fraction="
                         f"{hp['interior_fraction']:.3f}")
            lines.append(line)
            lines.append(f"  transport: {hp['transport']}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"StencilPlan({self.spec.name}, t={self.t}, "
                f"grid={self.grid_shape}, backend={self.backend!r}, "
                + ("" if self.batch is None else f"batch={self.batch}, ")
                + f"device={self.device}, "
                + f"distributed={self.mesh is not None})")


# ---------------------------------------------------------------------------
# Plan cache: bounded LRU, one lock around every cache/counter mutation
# (the guard ladder mutates the negative registry from whichever thread hit
# the failure).  Building stays outside the lock; two threads racing on one
# signature both build and the second insert wins.
# ---------------------------------------------------------------------------
_LOCK = threading.RLock()

#: Default maximum cached plans; REPRO_PLAN_CACHE_SIZE overrides it.
PLAN_CACHE_MAX = 512

_CACHE: "OrderedDict" = OrderedDict()
_STATS = {"hits": 0, "misses": 0,
          # guard-layer counters (repro_torch.kernels.guard): plan builds
          # that raised, plan executions that raised, degradation-ladder
          # moves, and negative-cache short-circuits.  All zero unless
          # something actually failed.
          "build_failures": 0, "exec_failures": 0,
          "fallbacks": 0, "negative_hits": 0,
          # static-auditor counters (repro_torch.audit): audited plan builds
          # and the violations their reports hold.
          "audits_run": 0, "audit_violations": 0}

#: Negative-result registry: signature key -> {"cause", "backend", "stamp"}.
#: A signature lands here when its build or execution failed, so the guard
#: ladder skips a known-bad rung without re-attempting it.  Entries expire
#: after ``plan_cache_max()`` cache churn: a transient failure must not
#: blacklist a signature forever.
_NEGATIVE: "OrderedDict" = OrderedDict()
_churn = 0  # total successful + negative insertions, the expiry clock


def plan_cache_max() -> int:
    """The effective LRU bound: ``REPRO_PLAN_CACHE_SIZE`` if set (must be a
    positive integer), else :data:`PLAN_CACHE_MAX`."""
    return env_int("REPRO_PLAN_CACHE_SIZE", PLAN_CACHE_MAX, minimum=1)


def plan_cache_stats() -> dict:
    """Cache, guard and auditor counters: hits/misses/size plus
    ``build_failures``, ``exec_failures``, ``fallbacks``, ``negative_hits``,
    ``negative_size``, ``audits_run`` and ``audit_violations``,
    snapshotted under the lock."""
    with _LOCK:
        out = dict(_STATS)
        out["size"] = len(_CACHE)
        out["negative_size"] = len(_NEGATIVE)
    return out


def clear_plan_cache() -> None:
    global _churn
    with _LOCK:
        _CACHE.clear()
        _NEGATIVE.clear()
        _churn = 0
        for k in _STATS:
            _STATS[k] = 0


def _tick_churn() -> None:
    """Advance the expiry clock and drop negative entries older than one
    full cache turnover (``plan_cache_max()`` insertions).  Callers hold
    ``_LOCK``."""
    global _churn
    _churn += 1
    bound = plan_cache_max()
    while _NEGATIVE:
        stamp = next(iter(_NEGATIVE.values()))["stamp"]
        if _churn - stamp <= bound:
            break
        _NEGATIVE.popitem(last=False)


def note_plan_failure(key, cause: str, backend: str,
                      stage: str = "build") -> None:
    """Record a failed signature in the negative registry (guard layer);
    the failed plan leaves the LRU, so it is never served again."""
    with _LOCK:
        _CACHE.pop(key, None)
        _STATS["build_failures" if stage == "build" else "exec_failures"] += 1
        _NEGATIVE[key] = {"cause": cause, "backend": backend, "stamp": _churn}
        _NEGATIVE.move_to_end(key)
        _tick_churn()


def failed_plan(key):
    """The negative entry for ``key`` if present and unexpired, else None;
    a hit counts toward ``negative_hits`` (the guard skipped a known-bad
    rung)."""
    with _LOCK:
        entry = _NEGATIVE.get(key)
        if entry is None:
            return None
        if _churn - entry["stamp"] > plan_cache_max():
            del _NEGATIVE[key]
            return None
        _STATS["negative_hits"] += 1
        return dict(entry)


def record_fallback() -> None:
    """One degradation-ladder move (guard layer bookkeeping)."""
    with _LOCK:
        _STATS["fallbacks"] += 1


def _weights_key(w: np.ndarray) -> Tuple:
    digest = hashlib.sha1(np.ascontiguousarray(w).tobytes()).hexdigest()
    return (w.shape, w.dtype.name, digest)


#: How a batched plan folds its leading batch axis (``common.fold_batch``):
#:   "vmap" -- each kernel call of the runner is one launch over the whole
#:            batch, grid b on blockIdx.z (K11);
#:   "map"  -- the unbatched runner looped over the grids (B launches per
#:            kernel call, each grid's work that of the unbatched plan);
#:   "auto" -- "vmap" on the card, "map" on the CPU, as JAX resolves it by
#:            ``interpret`` (the CPU runs the plain versions, which loop
#:            either way).
#: Both equal a loop of unbatched plans bit for bit.
BATCH_MODES = ("auto", "vmap", "map")


def _resolve_batch_mode(batch_mode: str, on_card: bool) -> str:
    if batch_mode not in BATCH_MODES:
        raise ValueError(f"batch_mode must be one of {BATCH_MODES}, "
                         f"got {batch_mode!r}")
    if batch_mode == "auto":
        return "vmap" if on_card else "map"
    return batch_mode


def auto_decision(spec: StencilSpec, grid_shape: Sequence[int], dtype, t: int,
                  *, hw: pm.HardwareSpec = pm.H100_SXM_DATASHEET,
                  tile_m: Optional[int] = None, w_tile: Optional[int] = None,
                  z_slab: Optional[int] = None,
                  use_sparse_unit: bool = False,
                  boundary: BoundaryLike = None):
    """``(geom, decision)``: the CTA tile a plan of this signature resolves
    and the selector's :class:`Decision` on it -- the ``auto`` choice, for
    ``stencil_plan`` and the guard's ladder alike.  Selection prices the
    tile the fused regimes launch with (halo t*r): its read amplification
    (1+2h/TM)(1+2h/TN), times (1+2h/TZ) in 3D, is the region the kernels
    really load, and the banded chunk width prices S.  Past the halos
    the tile rule's reserves admit, it is the first tile on which the
    tap-sum's or the reuse fold's own layout fits, and past those the
    rule's first candidate (``common.priced_tile_geom``): every signature
    the JAX package prices is priced, and a regime that cannot launch
    raises when it is built."""
    grid_shape = tuple(int(n) for n in grid_shape)
    geom = priced_tile_geom(
        grid_shape, t * spec.radius, tile_m, w_tile, z_slab,
        registry.fused_needs(spec, grid_shape, t, as_torch_dtype(dtype)))
    decision = decide(spec, t, dtype_bytes=as_torch_dtype(dtype).itemsize,
                      hw=hw, tile_n=BAND_N, use_sparse_unit=use_sparse_unit,
                      boundary=resolve_boundary(boundary, len(grid_shape)),
                      **geom_pricing(geom))
    return geom, decision


def plan_signature(
    spec_or_weights: Union[StencilSpec, np.ndarray],
    grid_shape: Sequence[int],
    dtype,
    t: int = 1,
    *,
    hw: pm.HardwareSpec = pm.H100_SXM_DATASHEET,
    backend: Optional[str] = None,
    tile_m: Optional[int] = None,
    w_tile: Optional[int] = None,
    z_slab: Optional[int] = None,
    compute_dtype=None,
    boundary: BoundaryLike = None,
    device=None,
    mesh=None,
    shard_spec: Optional[Sequence[Optional[str]]] = None,
    dist_mode: str = "fused",
    batch: Optional[int] = None,
    batch_mode: str = "auto",
    audit: Optional[bool] = None,
    use_sparse_unit: bool = False,
) -> Tuple:
    """Validate plan arguments and return ``(key, weights, grid_shape,
    dtype, device)`` -- the deterministic cache signature WITHOUT
    building.  The key depends only on the arguments and the process env,
    never on device state, so every rank of a mesh computes the same one
    and lands on the same guard rung without communicating."""
    if batch is not None:
        if int(batch) < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        batch = int(batch)
        if mesh is not None:
            raise ValueError(      # the JAX message (plan.py:443-447)
                "batched plans do not compose with distributed meshes yet; "
                "shard the request stream across hosts instead "
                "(repro.serve coalesces per host)")
    if mesh is not None and shard_spec is None:
        raise ValueError("a mesh-parameterized plan needs shard_spec "
                         "(one mesh-axis name per grid dim, None=unsharded)")
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    if backend is not None:
        registry.get_backend(backend)          # fail fast on unknown names
    if isinstance(spec_or_weights, StencilSpec):
        weights = jacobi_weights(spec_or_weights)
    else:
        weights = np.asarray(spec_or_weights)
    grid_shape = tuple(int(n) for n in grid_shape)
    if len(grid_shape) != weights.ndim:
        raise ValueError(
            f"grid rank {len(grid_shape)} != kernel rank {weights.ndim}; "
            "the plan's grid_shape must match the stencil dimensionality")
    if len(grid_shape) not in (1, 2, 3):
        raise ValueError(f"the port runs 1D, 2D and 3D grids, got rank "
                         f"{len(grid_shape)}")
    if z_slab is not None:
        if len(grid_shape) != 3:
            raise ValueError(f"z_slab pins the depth of a 3D tile; the grid "
                             f"{grid_shape} is {len(grid_shape)}D")
        if int(z_slab) < 1:
            raise ValueError(f"z_slab must be >= 1, got {z_slab}")
    boundary_key = resolve_boundary(boundary, len(grid_shape))
    dtype = as_torch_dtype(dtype)
    cdt = None if compute_dtype is None else as_torch_dtype(compute_dtype)
    dev = resolve_device(device)
    # The RESOLVED fold lands in the key, so "auto" shares one plan with
    # its resolution while "vmap" and "map" plans never alias.
    batch_key = None if batch is None else (
        batch, _resolve_batch_mode(batch_mode, dev.type == "cuda"))
    shard_key = None if mesh is None else (id(mesh), tuple(shard_spec),
                                           dist_mode)
    # The tile rule's budget is part of the key: it decides the tile, and
    # the guard's degraded rung halves it, so those plans never alias.
    key = (_weights_key(weights), grid_shape, str(dtype), t, hw, backend,
           tile_m, w_tile, z_slab, str(cdt), bool(use_sparse_unit),
           boundary_key, batch_key, shard_key, str(dev), smem_budget_bytes(),
           registry.generation())
    return key, weights, grid_shape, dtype, dev


def stencil_plan(
    spec_or_weights: Union[StencilSpec, np.ndarray],
    grid_shape: Sequence[int],
    dtype,
    t: int = 1,
    *,
    hw: pm.HardwareSpec = pm.H100_SXM_DATASHEET,
    backend: Optional[str] = None,
    tile_m: Optional[int] = None,
    w_tile: Optional[int] = None,
    z_slab: Optional[int] = None,
    compute_dtype=None,
    boundary: BoundaryLike = None,
    device=None,
    use_cache: bool = True,
    mesh=None,
    shard_spec: Optional[Sequence[Optional[str]]] = None,
    dist_mode: str = "fused",
    batch: Optional[int] = None,
    batch_mode: str = "auto",
    audit: Optional[bool] = None,
    use_sparse_unit: bool = False,
) -> StencilPlan:
    """Build (or fetch from cache) a stencil execution plan.

    Args:
      spec_or_weights: a dense ``(2r+1)^d`` kernel (numpy), or a
        ``StencilSpec`` (then its deterministic Jacobi weights are used).
      grid_shape: the 1D, 2D or 3D grid shape the plan is specialised to
        (its rank is the kernel's).
      dtype: grid dtype (``torch.float32`` / ``torch.bfloat16``, or the
        numpy equivalents).
      t: fusion depth -- time steps advanced per plan invocation.
      hw: hardware model consulted by the selector (default: the H100
        data sheet).
      backend: override the selector's choice with a registered backend.
      tile_m / w_tile: pin the CTA output tile (multiples of 16; ``None``
        = ``resolve_tile_geom``; a 1D plan takes only ``w_tile``, for its
        lifted tile).  The banded regimes contract
        BAND_N-column chunks (one wmma N), on the card and the CPU alike.
      z_slab: 3D grids only -- pin the tile's depth TZ (clamped to the
        grid's depth; ``None`` = the tile rule's).  A depth whose tile
        fits no shared-memory budget raises, as does one shallower than
        the halo under the whole-slab foils.  Part of the cache key.
      compute_dtype: MMA operand dtype of the banded regimes (default the
        grid dtype).
      boundary: per-axis boundary modes -- one of ``periodic`` (the
        default), ``zero``, ``reflect`` and ``replicate`` for every axis,
        or a per-axis tuple (``None`` entries periodic), e.g.
        ``boundary=("reflect", "periodic")``.  The kernels fill each
        non-periodic axis before every step; ``fused_matmul`` refuses
        them at t > 1 and ``auto`` never picks it there.  Part of the
        cache key.
      device: where the plan runs; ``None`` = ``"cuda"``, which raises
        when there is no GPU.  ``"cpu"`` runs the plain versions.
      use_cache: bypass the process-wide plan cache when ``False``.
      use_sparse_unit: admit the sparse-compacted backends
        (``sparse_matmul`` / ``fused_sparse_matmul``) as priced
        candidates.  Part of the cache key.
      batch: when given, the plan consumes ``(batch,) + grid_shape`` and
        advances ``batch`` independent grids per call, bit for bit a loop
        of unbatched plans.  Tile sizing and selection stay per grid.
        Part of the cache key.
      batch_mode: how the batch axis folds -- see :data:`BATCH_MODES`
        ("auto" = "vmap" on the card, "map" on the CPU).  The resolved
        mode is part of the cache key.
      audit: run the static auditor (``repro_torch.audit``) over the
        built plan's launches and attach its report as
        ``plan.audit_report`` (``None`` defers to the ``REPRO_AUDIT`` env
        flag).  Violations never fail the build: they bump the
        ``audit_violations`` counter in :func:`plan_cache_stats` and
        surface in the report.  Not part of the cache key -- a cached
        plan keeps the report of the build that audited it.  A batched
        plan gets an exempt report.
      mesh / shard_spec: when given, the plan drives the distributed
        halo-exchange stepper (``repro_torch.stencil.distributed``) on a
        ``torch.distributed`` ``DeviceMesh``: ``shard_spec`` names one
        mesh dim per grid dim (``None`` entries = unsharded dims), the
        plan consumes and returns this rank's local shard (``grid_shape``
        stays the global shape), every rank calls it together, and the
        local update runs the chosen backend's kernels on the shard's
        device through a periodic local plan (``reference``: the
        stepper's plain update).  ``dist_mode`` is ``"fused"`` (one
        depth-t*r exchange per call, the default), ``"stepwise"`` (t
        depth-r exchanges) or ``"overlap"`` (stepwise's exchanges with
        the interior update launched before the exchange is waited on;
        one sharded dim).  ``plan.halo_plan`` holds the schedule.  Part
        of the cache key (the mesh by identity).  ``batch`` with ``mesh``
        raises the JAX ``ValueError``.
    """
    key, weights, grid_shape, dtype, dev = plan_signature(
        spec_or_weights, grid_shape, dtype, t, hw=hw, backend=backend,
        tile_m=tile_m, w_tile=w_tile, z_slab=z_slab,
        compute_dtype=compute_dtype, boundary=boundary, device=device,
        mesh=mesh, shard_spec=shard_spec, dist_mode=dist_mode, batch=batch,
        batch_mode=batch_mode, audit=audit, use_sparse_unit=use_sparse_unit)
    modes = resolve_boundary(boundary, len(grid_shape))
    with _LOCK:
        if use_cache and key in _CACHE:
            _STATS["hits"] += 1
            _CACHE.move_to_end(key)
            return _CACHE[key]
        _STATS["misses"] += 1

    t0 = time.perf_counter()
    spec = spec_from_weights(weights)
    geom, decision = auto_decision(spec, grid_shape, dtype, t, hw=hw,
                                   tile_m=tile_m, w_tile=w_tile,
                                   z_slab=z_slab,
                                   use_sparse_unit=use_sparse_unit,
                                   boundary=modes)
    ctx = registry.PlanContext(
        spec=spec, weights=weights, grid_shape=grid_shape, dtype=dtype,
        t=t, tile_m=tile_m, w_tile=w_tile, z_slab=z_slab,
        compute_dtype=None if compute_dtype is None
        else as_torch_dtype(compute_dtype),
        boundary=modes, device=dev)
    exec_backend = backend if backend is not None else decision.backend
    mode, halo_plan = None, None
    if mesh is None:
        fn = registry.get_backend(exec_backend).build(ctx)
        if batch is not None:
            mode = _resolve_batch_mode(batch_mode, dev.type == "cuda")
            fn = fold_batch(fn, mode)
    else:
        fn, halo_plan = _build_distributed(mesh, tuple(shard_spec), dist_mode,
                                           ctx, exec_backend, dev)
    plan = StencilPlan(
        spec=spec, weights=weights, grid_shape=grid_shape, dtype=dtype,
        t=t, hw=hw, backend=exec_backend, decision=decision, fn=fn,
        device=dev, geom=geom, key=key,
        build_time_s=time.perf_counter() - t0, ctx=ctx, boundary=modes,
        batch=None if batch is None else int(batch), batch_mode=mode,
        mesh=mesh, shard_spec=None if mesh is None else tuple(shard_spec),
        dist_mode=None if mesh is None else dist_mode, halo_plan=halo_plan)
    if audit if audit is not None else env_flag("REPRO_AUDIT"):
        _attach_audit(plan, ctx, exec_backend, decision, geom)
    if use_cache:
        with _LOCK:
            bound = plan_cache_max()
            _CACHE[key] = plan
            while len(_CACHE) > bound:
                _CACHE.popitem(last=False)
            _tick_churn()
    return plan


def _attach_audit(plan, ctx, exec_backend, decision, geom_px) -> None:
    """Run the static auditor over the freshly built plan and attach the
    report (the JAX ``_attach_audit``).  Never raises: violations count
    into the plan stats and live in ``plan.audit_report``; an auditor
    crash records itself as ``audit/crashed`` rather than failing the
    build.  A distributed plan's stepper and a batched plan's fold wrap
    the launch, so they attach an exempt report instead of false
    violations."""
    from repro_torch import audit as _audit

    dtype = str(ctx.dtype).replace("torch.", "")
    try:
        if plan.mesh is not None or plan.batch is not None:
            report = _audit.AuditReport(
                backend=exec_backend, grid_shape=tuple(ctx.grid_shape),
                t=ctx.t, dtype=dtype,
                exempt=("distributed stepper wraps the launch in halo "
                        "collectives" if plan.mesh is not None
                        else "batch fold wraps the launch"))
        else:
            report = _audit.audit_context(ctx, exec_backend)
            pvl = report.check("blocks/priced-vs-launched")
            report.checks.append(_audit.audit_reason_read_amp(
                decision.reason, tuple(ctx.grid_shape), geom_px,
                ctx.dtype.itemsize,
                launched=None if pvl is None else pvl.actual["launched_amp"]))
    except Exception as e:  # the auditor must not break a build
        report = _audit.AuditReport(
            backend=exec_backend, grid_shape=tuple(ctx.grid_shape),
            t=ctx.t, dtype=dtype,
            checks=[_audit.AuditCheck("audit/crashed", False,
                                      actual=repr(e))])
    plan.audit_report = report
    with _LOCK:
        _STATS["audits_run"] += 1
        _STATS["audit_violations"] += len(report.violations)


def _build_distributed(mesh, axis_names, dist_mode, ctx, exec_backend, dev):
    """Wire the halo-exchange stepper around the chosen local backend (the
    JAX ``_build_distributed``); returns ``(stepper, halo_plan)``."""
    import torch.distributed as dist
    from repro_torch.stencil.distributed import (halo_bytes_per_step,
                                                 kernel_local_apply,
                                                 make_distributed_stepper)

    if len(axis_names) != len(ctx.grid_shape):
        raise ValueError(f"shard_spec {axis_names} must name one mesh axis "
                         f"per grid dim of {ctx.grid_shape}")
    names = tuple(mesh.mesh_dim_names or ())
    local_shape = []
    for n, ax in zip(ctx.grid_shape, axis_names):
        if ax is not None and ax not in names:
            raise ValueError(f"shard_spec {axis_names} names mesh axis "
                             f"{ax!r}, which the mesh {names} does not have")
        parts = mesh.size(names.index(ax)) if ax is not None else 1
        if n % parts:
            raise ValueError(f"grid dim {n} not divisible by mesh axis "
                             f"{ax!r} ({parts} shards)")
        local_shape.append(n // parts)
    local_shape = tuple(local_shape)

    # reference executes through the stepper's plain local update; every
    # other registered backend plugs in as a kernel local apply.  The
    # LOCAL plan stays periodic whatever ctx.boundary says: the global
    # boundary is realized in the halo extension (mode pads + edge-shard
    # fills), and the kernel's modulo wrap only pollutes the discarded
    # halo ring.
    local = None if exec_backend == "reference" else kernel_local_apply(
        exec_backend, tile_m=ctx.tile_m, w_tile=ctx.w_tile,
        z_slab=ctx.z_slab)
    stepper = make_distributed_stepper(
        mesh, axis_names, ctx.weights, t=ctx.t, mode=dist_mode,
        local_apply=local, boundary=ctx.boundary)

    r = ctx.spec.radius
    transport = dist.get_backend()
    if transport == "gloo" and dev.type == "cuda":
        transport += ", each halo slab staged through pinned host memory"
    halo_plan = {
        "mode": dist_mode,
        "halo_depth": r * ctx.t if dist_mode == "fused" else r,
        "exchanges_per_call": 1 if dist_mode == "fused" else ctx.t,
        "halo_bytes_per_call": halo_bytes_per_step(
            local_shape, axis_names, r, ctx.t, dist_mode,
            ctx.dtype.itemsize),
        "local_shape": local_shape,
        "transport": transport,
    }
    if dist_mode == "overlap":
        # Fraction of the local block whose update is computed while the
        # exchange is in flight -- the latency-hiding headroom explain()
        # surfaces.
        frac = 1.0
        for m, ax in zip(local_shape, axis_names):
            if ax is not None:
                frac *= max(m - 2 * r, 0) / m
        halo_plan["interior_fraction"] = frac
    return stepper, halo_plan
