"""Backend registry: every execution regime registers through one interface
(the counterpart of ``repro.kernels.registry``).

A *backend* is one way to advance the grid ``t`` time steps.  The port
registers every name the JAX registry has: the five priced regimes --
tap-sum unfused/fused, banded sequential / monolithic /
intermediate-reuse --, the sparse-compacted pair (``sparse_matmul`` /
``fused_sparse_matmul``, priced only under ``use_sparse_unit``), the plain
``reference`` oracle, and the unpriced traffic foils: the seed 9-tile
scheme (``legacy_direct`` / ``legacy_matmul``, 2D periodic) and the five
regimes on the whole-strip staging (``<regime>_wholestrip``), which read
whole neighbour tiles and compute what their regime computes.  Each
:class:`BackendDef` carries ``build(ctx) -> run(x, batched=False)``, which
does all host-side work (tile sizing, weight composition, validation)
once per plan, and an optional ``price(pctx)`` that makes it an
auto-selection candidate.  ``run(xb, batched=True)`` advances a batch
``(B,) + grid_shape`` with one launch per kernel call (K11): a batched
plan's "vmap" fold (``common.fold_batch``).  ``fallback_rank`` orders the guard layer's degradation ladder
(``repro_torch.kernels.guard``), the JAX ranks.  ``audit(ctx)`` declares
the backend's launches for the static auditor (``repro_torch.audit``):
each :class:`LaunchAudit` names the tile the plan's decision priced and
the tile the kernel launches, resolved through the same
:class:`PlanContext` methods each ``build`` uses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import perfmodel as pm
from repro_torch.stencil.boundary import is_periodic, resolve_boundary
from repro_torch.stencil.spec import StencilSpec
from repro_torch.stencil.weights import fuse_weights
from . import legacy as _legacy
from . import ref as _ref
from . import stencil_direct as _direct
from . import stencil_matmul as _matmul
from . import stencil_sparse as _sparse
from .common import (BAND_N, SubstrateGeom, TileNeed, WorkspaceLayout,
                     check_grid, check_staging, fold_need, launch_geom,
                     mma_k_step, plain_loop, priced_tile_geom, pricing_geom,
                     smem_budget_bytes, staging_clause)
from .stencil_direct import stencil_direct_at
from .stencil_matmul import build_bands_nd, stencil_matmul_at
from .stencil_sparse import (band_meta, compact_bands, sparse_tile_layout,
                             stencil_sparse_matmul_at)


def fused_needs(spec: StencilSpec, grid_shape, t: int,
                dtype: torch.dtype) -> Tuple[TileNeed, ...]:
    """The own layouts of the regimes that launch at the fused halo t*r on
    the decision's tile, for pricing where no reserve fits: the tap-sum
    and the dense reuse fold, at t steps of the spec's radius (the fold
    with the spec's bands: a box's (2r+1)^(d-1), a star's 4r+1 in 3D and
    2r+1 in 2D)."""
    dim, r = len(grid_shape), spec.radius
    rows = (1 if dim == 1 else (2 * r + 1) ** (dim - 1) if spec.shape == "box"
            else (4 * r + 1 if dim == 3 else 2 * r + 1))
    return (_direct.tile_need(grid_shape, r, t, dtype, "fused_direct"),
            fold_need(dim, r, t, dtype.itemsize, dtype.itemsize, rows,
                      "fused_matmul_reuse"))


@dataclasses.dataclass
class PlanContext:
    """Everything a backend builder may consume, resolved once per plan."""

    spec: StencilSpec
    weights: np.ndarray          # dense (2r+1)^d base kernel, host-side
    grid_shape: Tuple[int, ...]
    dtype: torch.dtype
    t: int
    tile_m: Optional[int]        # CTA output tile rows; None = auto
    w_tile: Optional[int]        # CTA output tile columns; None = auto
    compute_dtype: Optional[torch.dtype] = None
    #: 3D tile depth pin (``stencil_plan(z_slab=)``); None = the rule's.
    z_slab: Optional[int] = None
    #: Per-axis boundary modes, resolved by the plan layer.
    boundary: Optional[Tuple[str, ...]] = None
    #: What each CTA reads (``common.STAGE_CODES``): "region", or
    #: "wholestrip" for the whole-strip foils (the JAX ``h_block=0``).
    staging: str = "region"
    #: The device the plan runs on: a workspace form's persistent CTAs
    #: and bytes are its (None, or the CPU: sized as on an H100).
    device: Optional[torch.device] = None

    def fused_weights(self) -> np.ndarray:
        """Radius-``t*r`` composed kernel (monolithic fusion operand)."""
        return fuse_weights(self.weights, self.t)

    def tile_need(self, weights: np.ndarray, t_inner: int, engine: str,
                  regime: str) -> Optional[TileNeed]:
        """The own layout of ``regime``'s launch of ``weights`` at
        ``t_inner`` steps on the ``engine``'s kernel ("direct", "matmul",
        "sparse_matmul"), or None for the traffic foils, which keep
        the reserves' tiles."""
        if self.staging != "region":
            return None
        if engine == "direct":
            r = (np.asarray(weights).shape[-1] - 1) // 2
            return _direct.tile_need(self.grid_shape, r, t_inner, self.dtype,
                                     regime)
        mod = _matmul if engine == "matmul" else _sparse
        return mod.tile_need(self.grid_shape, weights, t_inner, self.dtype,
                             self.compute_dtype or self.dtype, regime)

    def launch_geom(self, weights: np.ndarray, t_inner: int,
                    engine: str = "direct",
                    regime: str = "the launch") -> SubstrateGeom:
        """The CTA tile the kernels launch ``weights`` with at ``t_inner``
        fused steps, halo t_inner * R (1D: the lift's (1, N) tile), after
        the kernels' argument rule under the plan's boundary: the tile
        rule's, held to ``regime``'s own layout on the ``engine``'s kernel
        where no reserve fits (:meth:`tile_need`).  Builders resolve it
        here, once, so the tile rule's and the argument rule's errors are
        raised when the plan is built (the JAX builders' ``validate``)."""
        r, _ = check_grid(self.grid_shape, np.asarray(weights), t_inner,
                          self.boundary, "the plan")
        geom = launch_geom(self.grid_shape, t_inner * r, self.tile_m,
                           self.w_tile, self.z_slab,
                           self.tile_need(weights, t_inner, engine, regime))
        check_staging(self.grid_shape, geom, t_inner * r, self.staging)
        return geom

    def priced_geom(self) -> SubstrateGeom:
        """The geometry the plan's decision prices (``plan.auto_decision``):
        ``pricing_geom`` at the fused halo t*r on the tile
        ``priced_tile_geom`` resolves there (1D: the lift's, read
        amplification 1)."""
        halo = self.t * self.spec.radius
        tile = priced_tile_geom(
            self.grid_shape, halo, self.tile_m, self.w_tile, self.z_slab,
            fused_needs(self.spec, self.grid_shape, self.t, self.dtype))
        if tile.dim == 1:
            return pricing_geom(1, halo)
        return pricing_geom(tile.dim, halo, tile.strip_m, tile.h_block,
                            tile.z_slab if tile.dim == 3 else None,
                            tile.z_block if tile.dim == 3 else None,
                            tile.w_tile, tile.w_block)


# ---------------------------------------------------------------------------
# Audit hooks: what a backend declares it will launch (repro_torch.audit)
# ---------------------------------------------------------------------------
#: The kernel family a launch runs, by engine and grid rank: the tap-sums
#: (csrc/stencil_direct{,3d,1d}.cu) and the folds (csrc/tile_fold.cuh,
#: slab_fold.cuh, line_fold.cuh).
FAMILIES = {("direct", 2): "tapsum2d", ("direct", 3): "tapsum3d",
            ("direct", 1): "tapsum1d", ("matmul", 2): "tile_fold",
            ("matmul", 3): "slab_fold", ("matmul", 1): "line_fold"}


@dataclasses.dataclass(frozen=True)
class LaunchAudit:
    """One declared kernel launch of a backend, in auditable terms (the
    JAX ``LaunchAudit``'s fields, meaning what they mean there, and the
    port's own).

    ``geom`` is the tile the kernel launches (``PlanContext.launch_geom``,
    halo ``t_inner * radius``; 1D the lifted tile, whose width sets the
    folded kernels' segments and rows); ``priced`` the geometry the plan's
    decision priced (``PlanContext.priced_geom``, halo t*r).  ``family``
    names the kernel (:data:`FAMILIES`), ``staging`` what a CTA reads.
    ``weights`` is the kernel-rank operand (a 1D kernel lifted to
    (1, 2r+1), as in JAX), so ``halo`` (the leading halo) is 0 on a 1D
    grid; ``x_halo`` is the launched tile's x halo.  The banded launches
    declare their bands at the port's chunk width (``tile_n`` = BAND_N):
    ``bands_shape`` the built operand's shape (the compacted one's packed
    shape), ``band_rows`` every band's (dz, dy, lo, nk) as the kernels
    read it, nk MMA k-steps of ``mma_k_step(compute_bytes)``.
    ``device`` is the plan's, which sizes a workspace form.
    """

    geom: SubstrateGeom
    priced: SubstrateGeom
    grid_shape: Tuple[int, ...]
    halo: int
    x_halo: int
    t_inner: int
    weights: np.ndarray
    radius: int
    engine: str                   # "direct" | "matmul" | "sparse_matmul"
    family: str
    staging: str = "region"
    dtype_bytes: int = 4
    compute_bytes: int = 4
    tile_n: int = 0
    bands_shape: Optional[Tuple[int, ...]] = None
    n_offsets: int = 0
    band_lo: Optional[Tuple[int, ...]] = None
    band_spans: Optional[Tuple[int, ...]] = None
    band_rows: Optional[Tuple[Tuple[int, ...], ...]] = None
    boundary: Optional[Tuple[str, ...]] = None
    device: Optional[torch.device] = None

    @property
    def total_halo(self) -> int:
        """The halo the launch stages along x (and every staged axis)."""
        return self.t_inner * self.radius


@dataclasses.dataclass(frozen=True)
class AuditSpec:
    """A backend's full audit declaration: its launches, in run order."""

    launches: Tuple[LaunchAudit, ...] = ()
    #: Non-None opts the backend out with a recorded reason.
    exempt: Optional[str] = None


def _launch_audit(ctx: PlanContext, w_op, t_inner: int, engine: str,
                  regime: str) -> LaunchAudit:
    """Describe one launch exactly as the backend ``regime``'s ``build``
    resolves it."""
    w_op = np.asarray(w_op, dtype=np.float32)
    geom = ctx.launch_geom(w_op, t_inner, engine, regime)
    dim = len(ctx.grid_shape)
    lifted = w_op[None, :] if dim == 1 else w_op
    radius = (lifted.shape[-1] - 1) // 2
    family = FAMILIES[("direct" if engine == "direct" else "matmul", dim)]
    cdt = ctx.compute_dtype or ctx.dtype
    extra = {}
    if engine != "direct":
        k_step = mma_k_step(cdt.itemsize)
        offsets, bands = build_bands_nd(lifted, BAND_N)
        extra = dict(tile_n=BAND_N, n_offsets=len(offsets))
        if engine == "matmul":
            nk = -(-bands.shape[1] // k_step)
            extra.update(
                bands_shape=tuple(bands.shape),
                band_rows=tuple((0,) * (2 - len(o)) + tuple(o) + (0, nk)
                                for o in offsets))
        else:
            row_index, packed = compact_bands(offsets, bands)
            meta = band_meta(w_op, cdt)
            extra.update(
                bands_shape=tuple(packed.shape),
                band_lo=tuple(int(ix[0]) for ix in row_index),
                band_spans=tuple(int(ix.size) - BAND_N for ix in row_index),
                band_rows=tuple((0,) * (4 - len(r)) + tuple(r)
                                for r in meta.rows))
    return LaunchAudit(
        geom=geom, priced=ctx.priced_geom(),
        grid_shape=tuple(ctx.grid_shape),
        halo=t_inner * ((lifted.shape[0] - 1) // 2),
        x_halo=t_inner * radius, t_inner=t_inner, weights=lifted,
        radius=radius, engine=engine, family=family,
        staging=ctx.staging if dim > 1 else "region",
        dtype_bytes=ctx.dtype.itemsize, compute_bytes=cdt.itemsize,
        boundary=resolve_boundary(ctx.boundary, dim), device=ctx.device,
        **extra)


def _audit_direct(ctx: PlanContext) -> AuditSpec:
    return AuditSpec(launches=(_launch_audit(ctx, ctx.weights, 1, "direct",
                                             "direct"),) * ctx.t)


def _audit_fused_direct(ctx: PlanContext) -> AuditSpec:
    return AuditSpec(launches=(_launch_audit(ctx, ctx.weights, ctx.t,
                                             "direct", "fused_direct"),))


def _audit_matmul(ctx: PlanContext) -> AuditSpec:
    return AuditSpec(launches=(_launch_audit(ctx, ctx.weights, 1, "matmul",
                                             "matmul"),) * ctx.t)


def _audit_fused_matmul(ctx: PlanContext) -> AuditSpec:
    return AuditSpec(launches=(_launch_audit(ctx, ctx.fused_weights(), 1,
                                             "matmul", "fused_matmul"),))


def _audit_fused_matmul_reuse(ctx: PlanContext) -> AuditSpec:
    return AuditSpec(launches=(_launch_audit(ctx, ctx.weights, ctx.t,
                                             "matmul",
                                             "fused_matmul_reuse"),))


def _audit_sparse_matmul(ctx: PlanContext) -> AuditSpec:
    return AuditSpec(launches=(_launch_audit(ctx, ctx.weights, 1,
                                             "sparse_matmul",
                                             "sparse_matmul"),) * ctx.t)


def _audit_fused_sparse_matmul(ctx: PlanContext) -> AuditSpec:
    return AuditSpec(launches=(_launch_audit(ctx, ctx.weights, ctx.t,
                                             "sparse_matmul",
                                             "fused_sparse_matmul"),))


def _wholestrip_audit(audit: Callable) -> Callable:
    """Audit the same regime on the whole-strip staging, mirroring
    :func:`_wholestrip` exactly."""
    def audit_ws(ctx: PlanContext) -> AuditSpec:
        return audit(dataclasses.replace(ctx, staging="wholestrip"))
    return audit_ws


def _audit_exempt(reason: str) -> Callable:
    def audit(ctx: PlanContext) -> AuditSpec:
        return AuditSpec(exempt=reason)
    return audit


@dataclasses.dataclass(frozen=True)
class BackendDef:
    name: str
    build: Callable[[PlanContext], Callable]
    price: Optional[Callable] = None   # price(PricingContext) -> float | None
    description: str = ""
    unit: Optional[str] = None         # "vector" | "matrix" | None (other)
    #: Position on the degradation ladder (lower = more aggressive); the
    #: reference oracle carries the largest rank.
    fallback_rank: Optional[int] = None
    #: ``audit(ctx) -> AuditSpec`` declares the backend's launches for the
    #: static auditor; ``None`` means "not yet auditable" (plug-ins),
    #: reported as exempt rather than violating.
    audit: Optional[Callable] = None


_REGISTRY: Dict[str, BackendDef] = {}
#: Bumped on every (un)registration; folded into plan-cache keys.
_generation = 0


def generation() -> int:
    return _generation


def register_backend(name: str, build: Callable, price: Callable = None,
                     description: str = "", unit: str = None,
                     overwrite: bool = False,
                     fallback_rank: Optional[int] = None,
                     audit: Callable = None) -> BackendDef:
    """Register an execution backend under ``name`` (see the JAX registry);
    ``audit(ctx) -> AuditSpec`` (optional) declares its launches for the
    static auditor.  Re-registering an existing name raises unless
    ``overwrite``."""
    global _generation
    if name == "auto":
        raise ValueError("'auto' is the selection policy, not a backend")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         "(pass overwrite=True to replace)")
    bd = BackendDef(name=name, build=build, price=price,
                    description=description, unit=unit,
                    fallback_rank=fallback_rank, audit=audit)
    _REGISTRY[name] = bd
    _generation += 1
    return bd


def unregister_backend(name: str) -> None:
    """Remove a registered backend (primarily for tests/plug-in teardown)."""
    global _generation
    if _REGISTRY.pop(name, None) is not None:
        _generation += 1


def get_backend(name: str) -> BackendDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: "
            f"{tuple(_REGISTRY)} (or 'auto')") from None


def registered_backends() -> Tuple[str, ...]:
    """Names of all registered backends, in registration order."""
    return tuple(_REGISTRY)


def priced_candidates(pctx) -> Dict[str, float]:
    """Evaluate every priced backend under ``pctx``; skip non-candidates."""
    out: Dict[str, float] = {}
    for bd in _REGISTRY.values():
        if bd.price is None:
            continue
        v = bd.price(pctx)
        if v is not None:
            out[bd.name] = v
    return out


def candidate_units() -> Dict[str, Optional[str]]:
    """Registered name -> unit classification ("vector"/"matrix"/None)."""
    return {name: bd.unit for name, bd in _REGISTRY.items()}


def fallback_ladder(after: Optional[str] = None) -> Tuple[str, ...]:
    """Ranked backends in degradation order (most aggressive first);
    ``after=name`` keeps only the rungs more conservative than ``name``."""
    ranked = sorted((bd for bd in _REGISTRY.values()
                     if bd.fallback_rank is not None),
                    key=lambda bd: bd.fallback_rank)
    names = tuple(bd.name for bd in ranked)
    if after is None:
        return names
    cut = _REGISTRY.get(after)
    if cut is None or cut.fallback_rank is None:
        return names
    return tuple(bd.name for bd in ranked
                 if bd.fallback_rank > cut.fallback_rank)


# ---------------------------------------------------------------------------
# Builders: the five priced regimes + the reference oracle.  Each resolves
# its tiling/operands at build time and closes over them.
# ---------------------------------------------------------------------------
def _build_reference(ctx: PlanContext) -> Callable:
    w, t, b = ctx.weights, ctx.t, ctx.boundary

    def run(x, batched=False):
        return plain_loop(_ref.stencil_direct_ref, x, batched, w, t, b)
    return run


def _staged(run: Callable, ctx: PlanContext, geom: SubstrateGeom):
    """Mark a foil's runner with what its launches read (``explain``).  A
    1D foil launches the folded 1D kernels' one staging, the default's,
    and reads what the model prices for the lift: read amplification 1,
    as JAX's halo-0 ``flat`` kind."""
    if ctx.staging != "region":
        if len(ctx.grid_shape) == 1:        # the folded kernels' staging
            geom = SubstrateGeom(dim=1, strip_m=1, h_block=1)
        run.staging = staging_clause(geom, ctx.staging)
    return run


def _marked(run: Callable, ctx: PlanContext, engine: str, w: np.ndarray,
            t_inner: int, geom: SubstrateGeom, budget: int) -> Callable:
    """``run`` marked with the workspace form its 2D or 3D launches take on
    the plan's device, or None where they run on one CTA or a cluster
    (``run.workspace``, which ``explain`` and the auditor report): the
    layout the wrapper's own ``launch_layout`` resolves, the function
    every launch resolves it with."""
    lay = None
    if ctx.staging == "region" and len(ctx.grid_shape) > 1:
        radius = (np.asarray(w).shape[-1] - 1) // 2
        cdt = ctx.compute_dtype or ctx.dtype
        if engine == "direct":
            lay = _direct.launch_layout(ctx.grid_shape, radius, t_inner, geom,
                                        budget, ctx.device)
        elif engine == "matmul":
            lay = _matmul.launch_layout(ctx.grid_shape, np.asarray(w),
                                        t_inner, radius, cdt, geom,
                                        budget=budget, device=ctx.device)
        else:
            lay = sparse_tile_layout(ctx.grid_shape, w, t_inner, geom, cdt,
                                     budget=budget, device=ctx.device)
    run.workspace = lay if isinstance(lay, WorkspaceLayout) else None
    return run


def _build_direct(ctx: PlanContext) -> Callable:
    """t launches of the tap-sum kernel at t=1, halo r each; the grid
    rounds to its dtype between steps, as in the JAX regime."""
    w, t, b, st = ctx.weights, ctx.t, ctx.boundary, ctx.staging
    geom = ctx.launch_geom(ctx.weights, 1, "direct", "direct")
    budget = smem_budget_bytes()

    def run(x, batched=False):
        for _ in range(t):
            x = stencil_direct_at(x, w, 1, geom, b, st, batched, budget)
        return x
    return _staged(_marked(run, ctx, "direct", w, 1, geom, budget), ctx, geom)


def _build_fused_direct(ctx: PlanContext) -> Callable:
    """One tap-sum launch, t steps on chip (halo t*r): in shared memory,
    over a cluster, or in a device workspace (the tile rule's rungs)."""
    w, t, b, st = ctx.weights, ctx.t, ctx.boundary, ctx.staging
    geom, budget = ctx.launch_geom(ctx.weights, t, "direct",
                                   "fused_direct"), smem_budget_bytes()

    def run(x, batched=False):
        return stencil_direct_at(x, w, t, geom, b, st, batched, budget)
    return _staged(_marked(run, ctx, "direct", w, t, geom, budget), ctx, geom)


def _build_matmul(ctx: PlanContext) -> Callable:
    """t launches of the banded kernel at t=1, halo r each."""
    w, t, b, st = ctx.weights, ctx.t, ctx.boundary, ctx.staging
    geom, cdt = ctx.launch_geom(w, 1, "matmul", "matmul"), ctx.compute_dtype
    budget = smem_budget_bytes()

    def run(x, batched=False):
        for _ in range(t):
            x = stencil_matmul_at(x, w, 1, geom, cdt, b, st, batched, budget)
        return x
    return _staged(_marked(run, ctx, "matmul", w, 1, geom, budget), ctx, geom)


def _build_fused_matmul(ctx: PlanContext) -> Callable:
    """Monolithic fusion: ONE contraction of the composed radius-t*r kernel."""
    if ctx.t > 1 and not is_periodic(ctx.boundary):
        # One application of the composed kernel sees ONE boundary
        # extension at depth t*r, but every non-periodic mode re-applies
        # per step -- the regime cannot represent that (the JAX message).
        raise ValueError(
            "fused_matmul (monolithic fusion) cannot honor non-periodic "
            f"boundaries at t={ctx.t}: the composed radius-t*r kernel "
            "bakes a single boundary extension into all t steps; use "
            "fused_matmul_reuse (per-step fills) or t=1")
    wf, b, st = ctx.fused_weights(), ctx.boundary, ctx.staging
    geom = ctx.launch_geom(wf, 1, "matmul", "fused_matmul")
    cdt, budget = ctx.compute_dtype, smem_budget_bytes()

    def run(x, batched=False):
        return stencil_matmul_at(x, wf, 1, geom, cdt, b, st, batched, budget)
    return _staged(_marked(run, ctx, "matmul", wf, 1, geom, budget), ctx, geom)


def _build_fused_matmul_reuse(ctx: PlanContext) -> Callable:
    """Intermediate reuse: t radius-r contractions in one launch, f32
    intermediates in shared memory, the boundary filled before each."""
    w, t, b, st = ctx.weights, ctx.t, ctx.boundary, ctx.staging
    geom = ctx.launch_geom(w, t, "matmul", "fused_matmul_reuse")
    cdt, budget = ctx.compute_dtype, smem_budget_bytes()

    def run(x, batched=False):
        return stencil_matmul_at(x, w, t, geom, cdt, b, st, batched, budget)
    return _staged(_marked(run, ctx, "matmul", w, t, geom, budget), ctx, geom)


def _sparse_geom(ctx: PlanContext, t_inner: int,
                 regime: str) -> SubstrateGeom:
    """:meth:`PlanContext.launch_geom` of the base kernel, with the
    compacted kernel's shared memory on that tile checked."""
    geom = ctx.launch_geom(ctx.weights, t_inner, "sparse_matmul", regime)
    sparse_tile_layout(ctx.grid_shape, ctx.weights, t_inner, geom,
                       ctx.compute_dtype or ctx.dtype)
    return geom


def _build_sparse_matmul(ctx: PlanContext) -> Callable:
    """t launches of the compacted banded kernel at t=1, halo r each."""
    w, t, b = ctx.weights, ctx.t, ctx.boundary
    geom, cdt = _sparse_geom(ctx, 1, "sparse_matmul"), ctx.compute_dtype
    budget = smem_budget_bytes()

    def run(x, batched=False):
        for _ in range(t):
            x = stencil_sparse_matmul_at(x, w, 1, geom, cdt, b, batched,
                                         budget)
        return x
    return _marked(run, ctx, "sparse_matmul", w, 1, geom, budget)


def _build_fused_sparse_matmul(ctx: PlanContext) -> Callable:
    """Intermediate reuse on the compacted operand: t radius-r compacted
    contractions in one launch, f32 intermediates in shared memory, the
    boundary filled before each."""
    w, t, b = ctx.weights, ctx.t, ctx.boundary
    geom = _sparse_geom(ctx, t, "fused_sparse_matmul")
    cdt, budget = ctx.compute_dtype, smem_budget_bytes()

    def run(x, batched=False):
        return stencil_sparse_matmul_at(x, w, t, geom, cdt, b, batched,
                                        budget)
    return _marked(run, ctx, "sparse_matmul", w, t, geom, budget)


def _wholestrip(build: Callable) -> Callable:
    """The same regime on the whole-strip staging (the JAX ``h_block=0``):
    each launch reads the whole tiles above, at and below its own (3D: the
    3 x 3 whole-slab tiles) on the regime's own tile."""
    def build_ws(ctx: PlanContext) -> Callable:
        return build(dataclasses.replace(ctx, staging="wholestrip"))
    return build_ws


def _require_2d(ctx: PlanContext, name: str) -> None:
    if len(ctx.grid_shape) != 2:
        raise ValueError(
            f"backend {name!r} is the seed 2D 9-tile foil and supports only "
            f"2D grids, got rank {len(ctx.grid_shape)}; use the halo-plane "
            "substrate regimes (direct/matmul families) for 1D/3D")
    if not is_periodic(ctx.boundary):
        raise ValueError(
            f"backend {name!r} is the seed periodic-only foil and does not "
            f"support boundary={ctx.boundary!r}; use the halo-plane "
            "substrate regimes (direct/matmul families) for non-periodic "
            "boundaries (DESIGN.md §15)")


def _legacy_tiles(ctx: PlanContext) -> Tuple[int, int]:
    """The 9-tile foils' tile: 128 x 128 as in JAX, or the plan's pins."""
    return (128 if ctx.tile_m is None else ctx.tile_m,
            128 if ctx.w_tile is None else ctx.w_tile)


def _build_legacy_direct(ctx: PlanContext) -> Callable:
    """Seed 9-tile tap-sum scheme (traffic foil): t fused steps."""
    _require_2d(ctx, "legacy_direct")
    w, t = ctx.weights, ctx.t
    tm, tn = _legacy_tiles(ctx)
    geom = _legacy.tile_geom(ctx.grid_shape, tm, tn, t * ctx.spec.radius)

    def run(x, batched=False):
        return _legacy.stencil_direct_9pt(x, w, t, tm, tn, batched)
    return _staged(run, dataclasses.replace(ctx, staging="9tile"), geom)


def _build_legacy_matmul(ctx: PlanContext) -> Callable:
    """Seed 9-tile monolithic banded scheme on the composed kernel."""
    _require_2d(ctx, "legacy_matmul")
    wf, cdt = ctx.fused_weights(), ctx.compute_dtype
    tm, tn = _legacy_tiles(ctx)
    geom = _legacy.tile_geom(ctx.grid_shape, tm, tn, (wf.shape[0] - 1) // 2)

    def run(x, batched=False):
        return _legacy.stencil_matmul_9pt(x, wf, tm, tn, cdt, batched)
    return _staged(run, dataclasses.replace(ctx, staging="9tile"), geom)


# ---------------------------------------------------------------------------
# Pricers (the JAX package's, verbatim): unfused/fused pairs share a
# throughput model and partition on fusion depth.
# ---------------------------------------------------------------------------
def _price_direct(p):
    return p.comparison.vector.actual_flops if p.workload.t == 1 else None


def _price_fused_direct(p):
    return p.comparison.vector.actual_flops if p.workload.t > 1 else None


def _price_matmul(p):
    return p.comparison.matrix.actual_flops if p.workload.t == 1 else None


def _price_fused_matmul(p):
    return p.comparison.matrix.actual_flops if p.workload.t > 1 else None


def _price_fused_matmul_reuse(p):
    # t=1 reuse degenerates to "matmul"; only offered at depth.
    if p.workload.t == 1:
        return None
    return pm.perf_matrix_reuse(p.workload, p.hw, p.s_reuse,
                                p.strip_m, p.z_slab,
                                p.w_tile or None).actual_flops


def _price_sparse_matmul(p):
    # Candidates only when the caller opts into the sparse unit; priced
    # from the compacted operand: kept-row fraction * (1 + gather
    # overhead) scales the dense matrix FLOPs.
    if not p.use_sparse_unit or p.workload.t != 1:
        return None
    return pm.perf_sparse_banded(
        p.workload, p.hw, p.s_mono, p.kept_mono,
        pm.compaction_overhead(p.tile_n)).actual_flops


def _price_fused_sparse_matmul(p):
    if not p.use_sparse_unit or p.workload.t == 1:
        return None
    return pm.perf_sparse_banded_reuse(
        p.workload, p.hw, p.s_reuse, p.kept_reuse,
        pm.compaction_overhead(p.tile_n), p.strip_m, p.z_slab,
        p.w_tile or None).actual_flops


# Fallback ranks as in the JAX registry (registry.py:620-650).
register_backend("direct", _build_direct, _price_direct,
                 "t sequential tap-sum kernel launches (halo r per step)",
                 unit="vector", fallback_rank=50, audit=_audit_direct)
register_backend("fused_direct", _build_fused_direct, _price_fused_direct,
                 "one tap-sum launch, t steps in shared memory",
                 unit="vector", fallback_rank=40, audit=_audit_fused_direct)
register_backend("matmul", _build_matmul, _price_matmul,
                 "t sequential banded tensor-core contractions",
                 unit="matrix", fallback_rank=30, audit=_audit_matmul)
register_backend("fused_matmul", _build_fused_matmul, _price_fused_matmul,
                 "monolithic fusion: one radius-t*r banded contraction",
                 unit="matrix", fallback_rank=20, audit=_audit_fused_matmul)
register_backend("fused_matmul_reuse", _build_fused_matmul_reuse,
                 _price_fused_matmul_reuse,
                 "one banded launch, t radius-r contractions, shared-memory "
                 "intermediates", unit="matrix", fallback_rank=10,
                 audit=_audit_fused_matmul_reuse)
# The sparse-compacted pair, registered in the JAX order (ties in the
# selector break by registration order): ladder rungs between the reuse
# regime and monolithic fusion.
register_backend("fused_sparse_matmul", _build_fused_sparse_matmul,
                 _price_fused_sparse_matmul,
                 "one compacted banded launch, t radius-r contractions, "
                 "shared-memory intermediates", unit="matrix",
                 fallback_rank=12, audit=_audit_fused_sparse_matmul)
register_backend("sparse_matmul", _build_sparse_matmul, _price_sparse_matmul,
                 "t sequential compacted banded tensor-core contractions",
                 unit="matrix", fallback_rank=16, audit=_audit_sparse_matmul)
register_backend("reference", _build_reference,
                 description="plain PyTorch oracle (debug)",
                 fallback_rank=1000,
                 audit=_audit_exempt("plain PyTorch oracle: no launch "
                                     "structure to audit"))
register_backend("legacy_direct", _build_legacy_direct,
                 description="seed 9-tile tap-sum scheme (traffic foil)",
                 unit="vector",
                 audit=_audit_exempt("seed 9-tile foil predates the "
                                     "substrate traffic model"))
register_backend("legacy_matmul", _build_legacy_matmul,
                 description="seed 9-tile monolithic banded scheme (foil)",
                 unit="matrix",
                 audit=_audit_exempt("seed 9-tile foil predates the "
                                     "substrate traffic model"))

# The whole-strip traffic foils: the five regimes on the whole-strip
# staging, unpriced so they never win selection.  The tap-sum pair are
# the ladder's last kernel rungs (ranks 60 and 55, as in JAX): after every
# regime on its region has failed, the foil's different staging, then the
# reference oracle.
for _name, _build, _audit, _unit, _rank in (
        ("direct", _build_direct, _audit_direct, "vector", 60),
        ("fused_direct", _build_fused_direct, _audit_fused_direct,
         "vector", 55),
        ("matmul", _build_matmul, _audit_matmul, "matrix", None),
        ("fused_matmul", _build_fused_matmul, _audit_fused_matmul,
         "matrix", None),
        ("fused_matmul_reuse", _build_fused_matmul_reuse,
         _audit_fused_matmul_reuse, "matrix", None)):
    register_backend(f"{_name}_wholestrip", _wholestrip(_build),
                     description=f"{_name} on the whole-strip staging "
                                 "(traffic foil)",
                     unit=_unit, fallback_rank=_rank,
                     audit=_wholestrip_audit(_audit))
