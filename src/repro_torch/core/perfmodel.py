"""Enhanced roofline performance model for stencils on matrix units.

This module is the paper's primary contribution (§3--§4) in executable form:

  * workload terms  C, M, I  for the original problem (Eq. 6),
  * temporally-fused vector-unit execution  I_CU^(t) = t*K/D  (Eq. 8),
  * matrix-unit execution with sparsity factor S and fusion redundancy
    alpha:  I_TC^(t) = t*(alpha/S)*K/D,
    P_TC,actual = (S/alpha) * min(P_TC, B*I_TC)  (Eq. 11/12),
  * the four-scenario classification and the sweet-spot criterion
    ``alpha < S * P_TC / P_CU``  (Eq. 13--19),
  * the intermediate-reuse matrix-unit regime (DESIGN.md §4): t radius-r
    banded contractions with VMEM-resident intermediates -- alpha = 1, paid
    for by the halo-recompute factor  beta = 1 + r*(t-1)/strip_m,  giving
    I_TC,reuse^(t) = beta * t * K / (S * D)  with S evaluated at the BASE
    radius r (not t*r as in monolithic fusion),
  * the Sparse-Tensor-Core extension (Eq. 20) -- the raised-ceiling model
    (``perf_sparse_matrix``) plus the EXECUTED band-compaction regime
    (``perf_sparse_banded{,_reuse}``, DESIGN.md §14): the banded operand
    keeps only its structurally-nonzero contraction rows (kept-row
    fraction ``kept`` = kernels.stencil_sparse.kept_row_fraction),
    shrinking executed MXU FLOPs and the streamed K-dimension by ``kept``
    at a small in-kernel gather overhead ``compaction_overhead(tile_n)``.

Naming note: the paper says "CUDA Core" / "Tensor Core"; we use the neutral
``vector`` / ``matrix`` unit names so the same model covers TPU VPU / MXU.

A copy of ``repro.core.perfmodel`` plus :data:`H100_SXM_DATASHEET`, the
port's default hardware.  The A100 and TPU specs stay for parity tests
against the JAX package.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.stencil.spec import StencilSpec
from repro_torch.stencil.weights import alpha as fusion_alpha


# ---------------------------------------------------------------------------
# Hardware description
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Peak throughputs (FLOP/s) and memory bandwidth (B/s) of one chip.

    ``p_vector``  -- general-purpose ALUs (CUDA cores / TPU VPU)
    ``p_matrix``  -- matrix unit (Tensor Core / TPU MXU)
    ``p_sparse``  -- sparse matrix unit ceiling (SpTC); None if absent
    ``bandwidth`` -- main-memory (HBM) bandwidth
    """

    name: str
    p_vector: float
    p_matrix: float
    bandwidth: float
    p_sparse: Optional[float] = None

    @property
    def ridge_vector(self) -> float:
        """Ridge point I* of the vector-unit roofline (FLOP/Byte)."""
        return self.p_vector / self.bandwidth

    @property
    def ridge_matrix(self) -> float:
        return self.p_matrix / self.bandwidth

    @property
    def ridge_sparse(self) -> float:
        if self.p_sparse is None:
            raise ValueError(f"{self.name} has no sparse matrix unit")
        return self.p_sparse / self.bandwidth


# NVIDIA A100-80GB PCIe, the paper's evaluation platform (§5.1).  The ridge
# points in paper Table 3 (5 / 10 / 81 / 161) pin B ~= 1.94e12 B/s:
#   9.7e12/1.94e12 = 5.0,  19.5e12/1.94e12 = 10.05,
#   156e12/1.94e12 = 80.4, 312e12/1.94e12 = 160.8.
A100_DOUBLE = HardwareSpec(
    "A100-80GB (fp64)", p_vector=9.7e12, p_matrix=19.5e12, bandwidth=1.94e12,
    p_sparse=None,  # no fp64 SpTC
)
A100_FLOAT = HardwareSpec(
    # float path: CUDA-core fp32 19.5 TF; TC tf32->fp32 156 TF; SpTC 312 TF
    "A100-80GB (fp32)", p_vector=19.5e12, p_matrix=156e12, bandwidth=1.94e12,
    p_sparse=312e12,
)
# TPU v5e (per chip).  MXU bf16 = 197 TFLOP/s; HBM = 819 GB/s.  The VPU
# throughput is not separately published; 197/16 ~= 12.3 TFLOP/s is the
# vector-lane estimate we expose as a *parameter* (it plays the paper's
# P_CU role, and every criterion below takes it from the HardwareSpec).
TPU_V5E_BF16 = HardwareSpec(
    "TPU v5e (bf16)", p_vector=197e12 / 16, p_matrix=197e12, bandwidth=819e9,
    # No sparse MXU.  The int8 MXU ceiling (394 TOP/s) answers the same
    # "raised ceiling" design question for quantized stencils (DESIGN.md §8).
    p_sparse=None,
)
TPU_V5E_INT8_CEILING = dataclasses.replace(
    TPU_V5E_BF16, name="TPU v5e (bf16 + int8 ceiling)", p_sparse=394e12
)
# NVIDIA H100 SXM (80 GB), figures from NVIDIA's data sheet, not measured:
# fp32 on the CUDA cores 67 TFLOP/s; TF32 on the tensor cores 495 TFLOP/s
# dense and 989 TFLOP/s with 2:4 sparsity; HBM3 3.35 TB/s.  The rates
# assume the card's full 700 W power limit.  The port's f32 grids run the
# banded contraction in TF32, so the TF32 rate is the matrix-unit peak.
H100_SXM_DATASHEET = HardwareSpec(
    "H100 SXM (fp32/TF32, data sheet)", p_vector=67e12, p_matrix=495e12,
    bandwidth=3.35e12, p_sparse=989e12,
)


# ---------------------------------------------------------------------------
# Workload formulation (paper §3.2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StencilWorkload:
    """A stencil problem instance bound to a fusion depth and dtype.

    ``read_amp`` is the substrate's grid-read amplification: 1.0 models the
    paper's ideal (each point read once), 1 + 2h/strip_m the halo-row
    sub-blocked strip substrate, 3.0 whole neighbor strips, 9.0 the seed
    scheme (see ``repro_torch.kernels.common.substrate_read_amp``).  It scales
    M and therefore every intensity below -- the substrate's traffic model
    IS the experiment (Eq. 6), so the selector prices the substrate it
    actually runs on.
    """

    spec: StencilSpec
    t: int = 1                   # fusion depth
    dtype_bytes: int = 4         # D
    read_amp: float = 1.0        # substrate read amplification (>= 1)

    @property
    def K(self) -> int:
        return self.spec.num_points

    @property
    def alpha(self) -> float:
        """Fusion redundancy factor (Eq. 9/10); exact for any shape."""
        return fusion_alpha(self.spec, self.t)

    # ---- vector-unit (CUDA-core-like) execution, temporal fusion (Eq. 8)
    def flops_vector(self) -> float:
        """C_CU^(t) per output point (t steps amortized into one)."""
        return self.t * 2 * self.K

    def bytes_per_output(self) -> float:
        """M = (read_amp + 1)·D: amplified read + one write; fusion keeps
        this constant (= the paper's 2D at the ideal read_amp of 1)."""
        return (self.read_amp + 1.0) * self.dtype_bytes

    def intensity_vector(self) -> float:
        return self.flops_vector() / self.bytes_per_output()

    # ---- matrix-unit execution with kernel fusion (Eq. 11)
    def flops_matrix(self, sparsity: float) -> float:
        """C_TC^(t) = (alpha/S) * C^(t) per output point (Eq. 3)."""
        _check_sparsity(sparsity)
        return (self.alpha / sparsity) * self.flops_vector()

    def intensity_matrix(self, sparsity: float) -> float:
        return self.flops_matrix(sparsity) / self.bytes_per_output()

    # ---- matrix-unit execution with intermediate reuse (DESIGN.md §4)
    def flops_matrix_reuse(self, sparsity: float, strip_m: int = 128,
                           z_slab: Optional[int] = None,
                           w_tile: Optional[int] = None) -> float:
        """C_TC,reuse^(t) = (beta/S) * C^(t) per output point.

        t radius-r banded contractions with intermediates resident in VMEM:
        the fused kernel never materializes so alpha drops to 1; instead the
        shrinking leading-axis halos are recomputed, inflating executed work
        by ``beta = reuse_beta(spec, t, strip_m, z_slab, w_tile)`` (the 2D
        ``halo_recompute_factor`` for d=2; the (z, y) product mean for d=3;
        exactly 1 for lifted 1D, which has no leading halo; the column-tiled
        substrate (``w_tile``, DESIGN.md §10) adds the carried x-halo as one
        more recomputed axis).  ``sparsity`` is the scheme's S at the BASE
        radius r.
        """
        _check_sparsity(sparsity)
        beta = reuse_beta(self.spec, self.t, strip_m, z_slab, w_tile)
        return (beta / sparsity) * self.flops_vector()

    def intensity_matrix_reuse(self, sparsity: float, strip_m: int = 128,
                               z_slab: Optional[int] = None,
                               w_tile: Optional[int] = None) -> float:
        return (self.flops_matrix_reuse(sparsity, strip_m, z_slab, w_tile)
                / self.bytes_per_output())

    # ---- sparse-compacted matrix-unit execution (DESIGN.md §14)
    def flops_sparse_matrix(self, sparsity: float, kept: float,
                            overhead: float = 0.0) -> float:
        """C_SpTC^(t) = kept*(1+overhead) * C_TC^(t) per output point.

        ``kept`` is the compacted operand's kept-row fraction S (row
        compaction drops exactly the all-zero contraction rows, so the
        executed MXU FLOPs shrink by precisely this factor -- proven
        integer-exact by repro.audit's flops/sparse-compaction check);
        ``overhead`` the relative cost of the in-kernel input-row gather
        (``compaction_overhead``).
        """
        _check_kept(kept)
        return kept * (1.0 + overhead) * self.flops_matrix(sparsity)

    def intensity_sparse_matrix(self, sparsity: float, kept: float,
                                overhead: float = 0.0) -> float:
        return (self.flops_sparse_matrix(sparsity, kept, overhead)
                / self.bytes_per_output())

    def flops_sparse_matrix_reuse(self, sparsity: float, kept: float,
                                  overhead: float = 0.0, strip_m: int = 128,
                                  z_slab: Optional[int] = None,
                                  w_tile: Optional[int] = None) -> float:
        """Reuse regime on the compacted operand: kept*(1+overhead) times
        the dense reuse FLOPs (beta at the BASE radius, like the dense
        reuse regime; ``kept`` likewise at the base radius)."""
        _check_kept(kept)
        return kept * (1.0 + overhead) * self.flops_matrix_reuse(
            sparsity, strip_m, z_slab, w_tile)

    def intensity_sparse_matrix_reuse(self, sparsity: float, kept: float,
                                      overhead: float = 0.0,
                                      strip_m: int = 128,
                                      z_slab: Optional[int] = None,
                                      w_tile: Optional[int] = None) -> float:
        return (self.flops_sparse_matrix_reuse(sparsity, kept, overhead,
                                               strip_m, z_slab, w_tile)
                / self.bytes_per_output())


def halo_recompute_factor(radius: int, t: int, strip_m: int = 128) -> float:
    """beta: executed rows / useful rows for the in-VMEM reuse pipeline.

    A strip of ``strip_m`` useful rows enters step s of t with a vertical
    halo of (t-s)*r rows per side; step s therefore computes
    strip_m + 2*r*(t-1-s) rows.  Summing over s and dividing by t*strip_m:

        beta = 1 + r*(t-1)/strip_m

    beta -> 1 as strips grow; it plays the role alpha plays for monolithic
    fusion but scales as r*t/strip_m instead of (r*t)^d/K -- the reason the
    reuse regime stays in the sweet spot at depths where monolithic fusion
    has long left it.
    """
    if t <= 1:
        return 1.0
    if strip_m <= 0:
        raise ValueError(f"strip height must be positive, got {strip_m}")
    return 1.0 + radius * (t - 1) / strip_m


def halo_recompute_factor_nd(radius: int, t: int, sizes) -> float:
    """beta for the N-D reuse pipeline: executed points / useful points.

    ``sizes`` lists the tile extent of every leading (non-wrap) axis of
    the substrate cell -- ``()`` for lifted 1D, ``(strip_m,)`` for 2D,
    ``(z_slab, strip_m)`` for 3D.  Step s of t computes
    ``prod_m (m + 2*r*(t-1-s))`` points per ``prod_m m`` useful ones, so

        beta = (1/t) * sum_j  prod_m (1 + 2*r*j/m),   j = 0..t-1

    which reduces to the closed-form 2D ``halo_recompute_factor`` for a
    single size and to 1 for an empty ``sizes`` (no leading halo at all).
    """
    sizes = tuple(sizes)
    if t <= 1 or not sizes:
        return 1.0
    if any(m <= 0 for m in sizes):
        raise ValueError(f"tile extents must be positive, got {sizes}")
    total = 0.0
    for j in range(t):
        f = 1.0
        for m in sizes:
            f *= 1.0 + 2.0 * radius * j / m
        total += f
    return total / t


def reuse_beta(spec: StencilSpec, t: int, strip_m: int = 128,
               z_slab: Optional[int] = None,
               w_tile: Optional[int] = None) -> float:
    """Dim-aware beta for the reuse regime: the single channel the
    workload, ``perf_matrix_reuse`` and the selector's reason string all
    consult, so priced and displayed betas can never disagree.

    d=2 keeps the closed-form ``halo_recompute_factor`` (bit-identical to
    the historical pricing); d=3 is the (z_slab, strip_m) product mean;
    d=1 is exactly 1 (the lifted substrate has no leading halo).  On the
    column-tiled substrate (``w_tile`` set, DESIGN.md §10) the carried
    x-halo shrinks per step exactly like the leading halos, so the tile
    width joins the product mean as one more recomputed axis; full-width
    substrates (``w_tile=None``) re-wrap in-VMEM at zero recompute.
    """
    if spec.dim == 1:
        return 1.0
    if spec.dim == 3:
        sizes = (z_slab if z_slab is not None else strip_m, strip_m)
    elif w_tile is None:
        return halo_recompute_factor(spec.radius, t, strip_m)
    else:
        sizes = (strip_m,)
    if w_tile is not None:
        sizes = sizes + (w_tile,)
    return halo_recompute_factor_nd(spec.radius, t, sizes)


def _check_sparsity(s: float) -> None:
    if not (0.0 < s <= 1.0):
        raise ValueError(f"sparsity factor must be in (0, 1], got {s}")


def _check_kept(kept: float) -> None:
    if not (0.0 < kept <= 1.0):
        raise ValueError(f"kept-row fraction must be in (0, 1], got {kept}")


def compaction_overhead(tile_n: int) -> float:
    """Relative in-kernel gather cost of the compacted contraction.

    Each kept contraction row is one gathered input element per output
    row (the shifted-slab slice at ``lo``), amortized over the 2*tile_n
    MACs that row feeds in the banded matmul:

        overhead = 1 / (2 * tile_n)

    -> 0 as chunks widen; ~0.4% at the default 128-wide tile.  Charged
    multiplicatively on the executed sparse FLOPs, it is the term that
    keeps near-dense compactions (box kernels, kept = 1) from ever
    out-pricing the dense path.
    """
    if tile_n <= 0:
        raise ValueError(f"tile_n must be positive, got {tile_n}")
    return 1.0 / (2.0 * tile_n)


# ---------------------------------------------------------------------------
# Roofline (paper §3.1, Eq. 5)
# ---------------------------------------------------------------------------
def attainable(peak: float, bandwidth: float, intensity: float) -> float:
    """P = min(P_peak, B * I)."""
    return min(peak, bandwidth * intensity)


class Bound(enum.Enum):
    MEMORY = "memory"
    COMPUTE = "compute"


def bound_state(peak: float, bandwidth: float, intensity: float) -> Bound:
    return Bound.MEMORY if bandwidth * intensity < peak else Bound.COMPUTE


# ---------------------------------------------------------------------------
# Per-unit performance (paper Eq. 8, 12, 20)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class UnitPerf:
    """Roofline evaluation of one workload on one execution unit."""

    unit: str                    # "vector" | "matrix" | "sparse_matrix"
    intensity: float             # I (FLOP/Byte), *as executed* (incl. redundancy)
    raw_flops: float             # min(P, B*I) -- counts redundant ops
    actual_flops: float          # deflated by S/alpha -- useful ops only
    bound: Bound
    ridge: float

    def stencil_throughput(self, workload: StencilWorkload) -> float:
        """Updates/sec per point-update (GStencils/s * 1e9 when scaled).

        The de-facto metric of the paper's §5.3: actual useful FLOPs divided
        by the useful FLOPs per (point, t-step-batch) = t*2K.
        """
        return self.actual_flops / workload.flops_vector()


def perf_vector(w: StencilWorkload, hw: HardwareSpec) -> UnitPerf:
    i = w.intensity_vector()
    p = attainable(hw.p_vector, hw.bandwidth, i)
    return UnitPerf("vector", i, p, p, bound_state(hw.p_vector, hw.bandwidth, i),
                    hw.ridge_vector)


def perf_matrix(w: StencilWorkload, hw: HardwareSpec, sparsity: float) -> UnitPerf:
    i = w.intensity_matrix(sparsity)
    raw = attainable(hw.p_matrix, hw.bandwidth, i)
    actual = (sparsity / w.alpha) * raw
    return UnitPerf("matrix", i, raw, actual,
                    bound_state(hw.p_matrix, hw.bandwidth, i), hw.ridge_matrix)


def perf_matrix_reuse(w: StencilWorkload, hw: HardwareSpec, sparsity: float,
                      strip_m: int = 128,
                      z_slab: Optional[int] = None,
                      w_tile: Optional[int] = None) -> UnitPerf:
    """Intermediate-reuse regime (DESIGN.md §4): alpha=1, halo-recompute beta
    (dim-aware: ``reuse_beta``; ``z_slab`` matters only for 3D workloads,
    ``w_tile`` only on the column-tiled substrate -- DESIGN.md §10).

    ``sparsity`` is the scheme's S at the base radius r (the per-step banded
    operand), NOT the monolithic S at radius t*r.
    """
    i = w.intensity_matrix_reuse(sparsity, strip_m, z_slab, w_tile)
    raw = attainable(hw.p_matrix, hw.bandwidth, i)
    beta = reuse_beta(w.spec, w.t, strip_m, z_slab, w_tile)
    actual = (sparsity / beta) * raw
    return UnitPerf("matrix_reuse", i, raw, actual,
                    bound_state(hw.p_matrix, hw.bandwidth, i), hw.ridge_matrix)


def perf_sparse_matrix(w: StencilWorkload, hw: HardwareSpec, sparsity: float) -> UnitPerf:
    """SpTC model (Eq. 20): same intensity, raised ceiling."""
    if hw.p_sparse is None:
        raise ValueError(f"{hw.name} has no sparse matrix unit")
    i = w.intensity_matrix(sparsity)
    raw = attainable(hw.p_sparse, hw.bandwidth, i)
    actual = (sparsity / w.alpha) * raw
    return UnitPerf("sparse_matrix", i, raw, actual,
                    bound_state(hw.p_sparse, hw.bandwidth, i), hw.ridge_sparse)


def _sparse_peak(hw: HardwareSpec) -> float:
    """Ceiling of the band-compacted contraction: the sparse unit where
    one exists (A100 SpTC), else the plain MXU -- compaction's
    effective-FLOP reduction is real on any matrix unit (it shrinks the
    executed K-dimension; no special hardware required)."""
    return hw.p_matrix if hw.p_sparse is None else hw.p_sparse


def perf_sparse_banded(w: StencilWorkload, hw: HardwareSpec, sparsity: float,
                       kept: float, overhead: float = 0.0) -> UnitPerf:
    """Executed band-compaction regime, monolithic fusion (DESIGN.md §14).

    Executed FLOPs shrink to kept*(1+overhead) of the dense matrix path
    (same useful work), so the useful-work deflator becomes
    S / (alpha * kept * (1+overhead)).  Compute-bound workloads gain the
    full 1/(kept*(1+overhead)) factor; memory-bound ones tie with the
    dense path to first order (B*I shrinks by exactly what the deflator
    regains), minus the overhead term -- the sparse sweet spot is the
    compute-bound region with  kept*(1+overhead) < 1  (star stencils;
    box kernels compact to kept = 1 and never profit).
    """
    _check_kept(kept)
    peak = _sparse_peak(hw)
    i = w.intensity_sparse_matrix(sparsity, kept, overhead)
    raw = attainable(peak, hw.bandwidth, i)
    actual = (sparsity / (w.alpha * kept * (1.0 + overhead))) * raw
    return UnitPerf("sparse_banded", i, raw, actual,
                    bound_state(peak, hw.bandwidth, i), peak / hw.bandwidth)


def perf_sparse_banded_reuse(w: StencilWorkload, hw: HardwareSpec,
                             sparsity: float, kept: float,
                             overhead: float = 0.0, strip_m: int = 128,
                             z_slab: Optional[int] = None,
                             w_tile: Optional[int] = None) -> UnitPerf:
    """Executed band-compaction regime with intermediate reuse: the dense
    reuse pipeline (alpha=1, dim-aware beta) on the compacted operand.
    ``sparsity`` and ``kept`` are both at the BASE radius r."""
    _check_kept(kept)
    peak = _sparse_peak(hw)
    i = w.intensity_sparse_matrix_reuse(sparsity, kept, overhead,
                                        strip_m, z_slab, w_tile)
    raw = attainable(peak, hw.bandwidth, i)
    beta = reuse_beta(w.spec, w.t, strip_m, z_slab, w_tile)
    actual = (sparsity / (beta * kept * (1.0 + overhead))) * raw
    return UnitPerf("sparse_banded_reuse", i, raw, actual,
                    bound_state(peak, hw.bandwidth, i), peak / hw.bandwidth)


# ---------------------------------------------------------------------------
# Scenario classification + criteria (paper §4.1, Eq. 13--19)
# ---------------------------------------------------------------------------
class Scenario(enum.Enum):
    """(vector-unit bound) -> (matrix-unit bound), paper Figure 8."""

    MB_MB = 1   # equal effective performance
    MB_CB = 2   # matrix unit strictly worse
    CB_MB = 3   # matrix unit strictly better ("breaks the ceiling")
    CB_CB = 4   # conditional: sweet spot iff alpha < S * P_TC / P_CU


@dataclasses.dataclass(frozen=True)
class Comparison:
    workload: StencilWorkload
    hardware: HardwareSpec
    sparsity: float
    vector: UnitPerf
    matrix: UnitPerf
    scenario: Scenario
    speedup: float               # P_TC,actual / P_CU,actual
    profitable: bool             # speedup > 1 (strictly)
    sweet_spot_alpha_limit: float  # S * P_TC / P_CU (Eq. 19 threshold)


def compare(
    w: StencilWorkload,
    hw: HardwareSpec,
    sparsity: float,
    use_sparse_unit: bool = False,
) -> Comparison:
    """Evaluate the paper's criteria for one workload on one chip."""
    v = perf_vector(w, hw)
    m = (perf_sparse_matrix if use_sparse_unit else perf_matrix)(w, hw, sparsity)
    scenario = {
        (Bound.MEMORY, Bound.MEMORY): Scenario.MB_MB,
        (Bound.MEMORY, Bound.COMPUTE): Scenario.MB_CB,
        (Bound.COMPUTE, Bound.MEMORY): Scenario.CB_MB,
        (Bound.COMPUTE, Bound.COMPUTE): Scenario.CB_CB,
    }[(v.bound, m.bound)]
    speedup = m.actual_flops / v.actual_flops
    p_mat = hw.p_sparse if use_sparse_unit else hw.p_matrix
    limit = sparsity * p_mat / hw.p_vector
    return Comparison(
        workload=w, hardware=hw, sparsity=sparsity, vector=v, matrix=m,
        scenario=scenario, speedup=speedup, profitable=speedup > 1.0 + 1e-9,
        sweet_spot_alpha_limit=limit,
    )


def sweet_spot_max_t(
    spec: StencilSpec,
    hw: HardwareSpec,
    sparsity: float,
    dtype_bytes: int = 4,
    t_max: int = 64,
    use_sparse_unit: bool = False,
) -> list[int]:
    """All fusion depths t in [1, t_max] where the matrix unit is profitable.

    This sweeps the paper's Figure 9/14 boundary for a concrete stencil.
    """
    out = []
    for t in range(1, t_max + 1):
        c = compare(StencilWorkload(spec, t, dtype_bytes), hw, sparsity,
                    use_sparse_unit=use_sparse_unit)
        if c.profitable:
            out.append(t)
    return out


# ---------------------------------------------------------------------------
# Transformation-scheme sparsity factors (paper §2.2.2; S is scheme-specific)
# ---------------------------------------------------------------------------
def sparsity_convstencil() -> float:
    """ConvStencil's stencil2row + dual tessellation: S = 0.5 (paper Table 2)."""
    return 0.5


def sparsity_spider() -> float:
    """SPIDER's strided swapping on SpTC: S = 0.47 (paper Table 2)."""
    return 0.47


def sparsity_banded(effective_radius: int, tile_n: int = 128) -> float:
    """Our TPU decompose-to-banded-matmul scheme (DESIGN.md §2).

    Each 1-D sub-convolution multiplies an (M, N+2R) input tile against an
    (N+2R, N) banded weight matrix whose columns carry the 2R+1 kernel taps:
    nonzeros = N*(2R+1) of (N+2R)*N entries ->  S = (2R+1) / (N + 2R).
    """
    r = effective_radius
    return (2 * r + 1) / (tile_n + 2 * r)
