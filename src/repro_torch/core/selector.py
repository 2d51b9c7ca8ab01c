"""Analytic execution-unit selector -- the paper's criteria as a scheduler.

Given a stencil workload and a hardware description, decide which execution
path the runtime should take among the five regimes the kernel substrate
implements (vector unit fused/unfused, matrix unit sequential / monolithic
fusion / intermediate reuse), and predict the speedup.
``repro_torch.kernels.ops.stencil_apply(backend="auto")`` consults this
module, making the paper's analytical criteria (§4.1) -- extended with the
intermediate-reuse regime of DESIGN.md §4 -- a first-class deployable
feature rather than a post-hoc analysis.

A copy of ``repro.core.selector``; ``use_sparse_unit=True`` admits the
sparse-compacted candidates (``sparse_matmul`` / ``fused_sparse_matmul``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import perfmodel as pm
from repro_torch.stencil.boundary import boundary_label, is_periodic
from repro_torch.stencil.spec import StencilSpec


@dataclasses.dataclass(frozen=True)
class Decision:
    backend: str                  # "direct" | "fused_direct" | "matmul" |
                                  # "fused_matmul" | "fused_matmul_reuse"
    scenario: Optional[pm.Scenario]
    predicted_speedup: float      # best matrix regime vs vector unit, effective
    comparison: pm.Comparison     # vector vs MONOLITHIC matrix (paper Fig. 8)
    reason: str
    candidates: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: effective stencil throughput (useful FLOP/s) per candidate backend


@dataclasses.dataclass(frozen=True)
class PricingContext:
    """Workload + hardware context handed to each registered backend's
    ``price`` hook (repro.kernels.registry): everything shared across
    candidates is computed once here, so adding a candidate costs only its
    own throughput formula."""

    workload: pm.StencilWorkload
    hw: pm.HardwareSpec
    comparison: pm.Comparison     # vector vs monolithic matrix (shared)
    s_mono: float                 # structural S at the fused radius t*r
    s_reuse: float                # structural S at the base radius r
    strip_m: int
    #: Resolved halo sub-block height (0 = whole-strip) -- INFORMATIONAL
    #: for plug-in pricers: its read amplification is already folded into
    #: ``workload.read_amp``, which is the canonical channel.
    h_block: Optional[int] = None
    use_sparse_unit: bool = False
    #: Kept-row fractions of the sparse-compacted operands at the fused
    #: radius t*r (monolithic) and the base radius r (reuse); 1.0 unless
    #: ``use_sparse_unit`` (the sparse pricers gate on the flag first).
    kept_mono: float = 1.0
    kept_reuse: float = 1.0
    tile_n: int = 128
    #: 3D workloads: resolved slab depth / halo-plane block (None for 2D).
    #: ``z_slab`` also feeds the reuse regime's dim-aware beta.
    z_slab: Optional[int] = None
    z_block: Optional[int] = None
    #: Column-tiled W substrate (DESIGN.md §10; 0 = full width).  Like
    #: h_block, the read amplification is already in ``workload.read_amp``;
    #: ``w_tile`` additionally feeds the reuse regime's beta (the carried
    #: x-halo is recomputed per step exactly like the leading axes).
    w_tile: int = 0
    w_block: int = 0


#: Total ``select_backend`` invocations this process -- lets tests assert a
#: cached plan never re-runs selection.
_invocations = 0


def invocation_count() -> int:
    return _invocations


def select_backend(
    spec: StencilSpec,
    t: int,
    dtype_bytes: int,
    hw: pm.HardwareSpec = pm.H100_SXM_DATASHEET,
    sparsity: Optional[float] = None,
    tile_n: int = 128,
    use_sparse_unit: bool = False,
    strip_m: int = 128,
    h_block: Optional[int] = None,
    z_slab: Optional[int] = None,
    z_block: Optional[int] = None,
    w_tile: Optional[int] = None,
    w_block: Optional[int] = None,
    boundary=None,
) -> Decision:
    """Pick the predicted-fastest backend for ``t`` fused steps of ``spec``.

    Candidates are enumerated from the backend registry
    (``repro.kernels.registry``): every registered backend with a ``price``
    hook that returns a throughput for this workload competes; the rest
    (reference oracle, legacy/whole-strip foils) are never selected.

    ``sparsity`` overrides the scheme's structural S for BOTH matrix
    regimes (useful to model published schemes); by default the monolithic
    regime uses the banded S at the fused radius t*r while the reuse regime
    uses S at the base radius r -- the structural reason reuse keeps its
    MXU efficiency at depth.

    ``h_block`` is the substrate's halo sub-block height (``None`` = the
    kernels' own auto choice, ``0`` = whole-strip): the workload's memory
    term M uses the resulting read amplification 1 + 2h/strip_m, so
    intensities -- and the VPU-vs-MXU crossover -- price the substrate
    that actually runs rather than the paper's ideal M = 2D.  3D
    workloads additionally take ``z_slab``/``z_block`` (pricing defaults:
    z_slab = strip_m, auto z_block) and price the product amplification
    (1 + 2h/strip_m)(1 + 2z_block/z_slab); 1D workloads always price the
    lifted substrate (strip_m = 1, read amplification exactly 1).
    ``w_tile``/``w_block`` (2D/3D) price the column-tiled W substrate
    (DESIGN.md §10): the read-amp product gains the (1 + 2w_block/w_tile)
    factor and the reuse beta the carried-x-halo recompute.  The resolved
    geometry and its read factor (including the resolved ``w_tile``) are
    appended to every reason string, so ``ops.explain`` surfaces what the
    substrate costs.

    ``boundary`` (DESIGN.md §15) does not move the crossover -- the
    boundary fills are FLOP-free select/concat lanes and the fetch count
    matches periodic's -- but a non-periodic spec is surfaced in the
    reason string so explain() shows what the plan will honor.
    """
    global _invocations
    _invocations += 1
    # Deferred: the registry imports this module.
    from repro_torch.kernels.common import pricing_geom
    from repro_torch.kernels.registry import candidate_units, priced_candidates

    # Auto blocks resolve at the FUSED-regime halo t*r (see the JAX
    # selector): the fused regimes build with exactly this halo, and the
    # sequential regimes only price at t=1, where t*r == r.
    geom = pricing_geom(spec.dim, t * spec.radius, strip_m, h_block,
                        z_slab, z_block, w_tile, w_block)
    read_amp = geom.read_amp
    w = pm.StencilWorkload(spec, t, dtype_bytes, read_amp=read_amp)
    s_mono = sparsity if sparsity is not None else \
        pm.sparsity_banded(spec.radius * t, tile_n)
    s_reuse = sparsity if sparsity is not None else \
        pm.sparsity_banded(spec.radius, tile_n)
    # The scenario comparison prices the card's sparse unit only when it
    # has one; the compacted kernels compete through their own pricers.
    cmp_ = pm.compare(w, hw, s_mono,
                      use_sparse_unit=use_sparse_unit
                      and hw.p_sparse is not None)

    kept_mono = kept_reuse = 1.0
    if use_sparse_unit:
        # Structural kept-row fractions of the compacted operands: the
        # zero pattern is the spec's, so its Jacobi kernel prices every
        # weight set on that support.
        from repro_torch.kernels.stencil_sparse import kept_row_fraction
        from repro_torch.stencil.weights import fuse_weights, jacobi_weights
        wj = jacobi_weights(spec)
        kept_reuse = kept_row_fraction(wj, tile_n)
        kept_mono = kept_row_fraction(fuse_weights(wj, t), tile_n) \
            if t > 1 else kept_reuse

    candidates = priced_candidates(PricingContext(
        workload=w, hw=hw, comparison=cmp_, s_mono=s_mono, s_reuse=s_reuse,
        strip_m=geom.strip_m, h_block=geom.h_block,
        use_sparse_unit=use_sparse_unit,
        kept_mono=kept_mono, kept_reuse=kept_reuse, tile_n=tile_n,
        z_slab=geom.z_slab if spec.dim == 3 else None,
        z_block=geom.z_block if spec.dim == 3 else None,
        w_tile=geom.w_tile if spec.dim >= 2 else 0,
        w_block=geom.w_block if spec.dim >= 2 else 0))
    if not candidates:
        raise RuntimeError("no registered backend priced this workload")
    if t > 1 and boundary is not None and not is_periodic(boundary):
        # Monolithic fusion bakes one boundary extension into t steps, so
        # its build rejects non-periodic specs (DESIGN.md §15) -- never
        # select it into a failing build.
        candidates.pop("fused_matmul", None)
        if not candidates:
            raise RuntimeError(
                "no registered backend can honor non-periodic boundaries "
                "for this workload")

    vec = cmp_.vector.actual_flops
    units = candidate_units()
    backend = max(candidates, key=lambda k: candidates[k])
    matrix_perfs = [v for k, v in candidates.items()
                    if units.get(k) == "matrix"]
    best_matrix = max(matrix_perfs) if matrix_perfs else vec

    if backend == "fused_matmul_reuse":
        beta = pm.reuse_beta(spec, t, geom.strip_m,
                             geom.z_slab if spec.dim == 3 else None,
                             geom.w_tile or None)
        reason = (
            f"intermediate-reuse regime wins: alpha=1 (vs monolithic "
            f"alpha={w.alpha:.3f}), S_r={s_reuse:.3f} at base radius (vs "
            f"S_rt={s_mono:.3f} fused), halo-recompute beta={beta:.3f} "
            f"(DESIGN.md §4)"
        )
    elif backend in ("sparse_matmul", "fused_sparse_matmul"):
        kept = kept_reuse if backend == "fused_sparse_matmul" else kept_mono
        ov = pm.compaction_overhead(tile_n)
        cost = kept * (1.0 + ov)
        side = "inside" if cost < 1.0 else "outside"
        reason = (
            f"sparse-compacted regime wins: kept-row fraction S={kept:.4f} "
            f"* (1 + gather overhead {ov:.4f}) = {cost:.4f} vs 1 dense -- "
            f"{spec.shape} kernel {side} the sparse sweet spot (star "
            f"stencils keep only their tap rows, box compacts to S=1; "
            f"DESIGN.md §14)"
        )
    elif backend in ("direct", "fused_direct", "matmul", "fused_matmul"):
        reason = _explain(cmp_)
    else:
        # a registered plug-in won: the Fig. 8 scenario prose below only
        # describes the built-in vector/monolithic-matrix comparison
        reason = (
            f"registered backend {backend!r} priced highest "
            f"({candidates[backend]:.3g} effective FLOP/s) among "
            f"{sorted(candidates)}"
        )
    # Every reason carries the resolved substrate geometry + read factor
    # (DESIGN.md §9): decide()/explain()/plan.decision all format it from
    # the same resolved numbers, so they agree verbatim.
    reason = f"{reason} | {geom.describe()}"
    # Boundary handling is throughput-neutral (fills are FLOP-free
    # select/concat; fetch counts match periodic's -- DESIGN.md §15), so
    # it never changes the ranking among eligible regimes; surface it in
    # the reason only when non-periodic to keep historical reason strings
    # byte-identical.
    if boundary is not None and not is_periodic(boundary):
        reason = f"{reason} | boundary={boundary_label(boundary)}"
    return Decision(
        backend=backend,
        scenario=cmp_.scenario,
        predicted_speedup=best_matrix / vec,
        comparison=cmp_,
        reason=reason,
        candidates=candidates,
    )


def _explain(c: pm.Comparison) -> str:
    s = c.scenario
    if s is pm.Scenario.MB_MB:
        return (
            "both units memory-bound: effective performance identical (Eq. 14); "
            "prefer vector unit (no transformation overhead)"
        )
    if s is pm.Scenario.MB_CB:
        return (
            "vector unit memory-bound but transformation pushed matrix unit "
            "compute-bound: matrix unit strictly worse (Eq. 16)"
        )
    if s is pm.Scenario.CB_MB:
        return (
            "vector unit compute-bound, matrix unit memory-bound: matrix unit "
            "breaks the vector-unit ceiling (Eq. 17)"
        )
    ok = "inside" if c.workload.alpha < c.sweet_spot_alpha_limit else "outside"
    return (
        f"both compute-bound: conditional sweet spot (Eq. 19) -- alpha="
        f"{c.workload.alpha:.3f} vs limit S*P_mat/P_vec="
        f"{c.sweet_spot_alpha_limit:.3f} ({ok} sweet spot)"
    )


def classify_problem(
    spec: StencilSpec,
    t: int,
    dtype_bytes: int,
    hw: pm.HardwareSpec,
) -> pm.Bound:
    """Paper §4.2 (Fig. 10): is the temporally-fused problem compute-bound
    on the *vector* unit?  (The precondition for matrix units to pay off.)"""
    w = pm.StencilWorkload(spec, t, dtype_bytes)
    return pm.bound_state(hw.p_vector, hw.bandwidth, w.intensity_vector())


def transition_depth(
    spec: StencilSpec,
    dtype_bytes: int,
    hw: pm.HardwareSpec,
    t_max: int = 64,
) -> Optional[int]:
    """Smallest fusion depth at which the problem becomes compute-bound on
    the vector unit (paper §4.2: box transitions at t=3, star at t=5 for the
    A100/float setting)."""
    for t in range(1, t_max + 1):
        if classify_problem(spec, t, dtype_bytes, hw) is pm.Bound.COMPUTE:
            return t
    return None
