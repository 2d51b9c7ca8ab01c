"""Tile geometry of the port's Hopper kernels, and the sizing subset of
``repro.kernels.common`` the selector prices with.

The JAX package stages halos through a BlockSpec ring because TPU blocks
cannot overlap (``repro/kernels/common.py:3-8``).  Hopper blocks can, so
the port's launch geometry is its own:

  * one CTA computes a (TM x TN) output tile and reads its
    (TM + 2h) x (TN + 2h) region straight from global memory, with
    modulo indices on both axes (h = t*r for the fused regimes);
  * before every step the kernel rebuilds each non-periodic axis's
    out-of-domain cells in shared memory (the in-kernel fill, K6), by
    global index, from the mode codes :func:`kernel_mode_codes` hands it;
  * intermediate steps stay in shared memory and CARRY the x-halo,
    shrinking both axes by r per step -- the ``wrap_x=False`` form of the
    JAX kernels, which computes the same function as the full-width
    re-wrap;
  * ragged edge tiles are masked on store, so any H and W run.

The plan prices this tile as ``SubstrateGeom(strip_m=TM, h_block=h,
w_tile=TN, w_block=h)``, so the priced read amplification
(1 + 2h/TM)(1 + 2h/TN) is that of the region the kernel really loads.
Tiles are sized under a shared-memory budget (227 KB per block) in place
of the JAX package's 8 MB VMEM budget.

The traffic foils (the JAX ``wholestrip`` / ``wholeslab`` launch kinds
and the seed 9-tile scheme of ``repro.kernels.legacy``) keep this tile and
change only what a CTA reads (:data:`STAGE_CODES`, :func:`foil_windows`):
whole neighbour tiles, of which the kernels keep the region's cells.

3D grids (the counterpart of the JAX slab substrate, ``slab_launch_geometry``
and ``choose_slab_blocks``) take the same design one rank up: a CTA
computes a (TZ x TM x TN) tile from its (TZ+2h)(TM+2h)(TN+2h) region and
is priced as ``SubstrateGeom(3, z_slab=TZ, z_block=h, strip_m=TM,
h_block=h, w_tile=TN, w_block=h)``.  1D grids are priced as the JAX lift
is, with read amplification 1 (``SubstrateGeom(1, strip_m=1,
h_block=1)``), and launch on the lifted (1, N) tile's width: the tap-sum
gives each CTA one contiguous segment of LINE_ROWS such tiles
(:func:`line_segments`, :func:`direct1d_layout`), the banded kernels fold
the line into MMA rows (:func:`line_windows`, :func:`line_layout`).

A 3D layout that fits no one CTA's 227 KB on any candidate tile (the
deep halos of the JAX package's own 3D stencils: Box/Star-3D2R past t =
5) launches over a thread-block cluster of 2, 4 or 8 CTAs that share one
tile through distributed shared memory (:class:`ClusterLayout`,
:func:`direct3d_cluster`, :func:`slab_cluster`; the tile rule's third
rung), where the JAX slab substrate stages the region in 8 MB of VMEM.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import itertools
import math
from typing import Callable, Iterator, Optional

from repro_torch.core.envutil import env_int
from repro_torch.stencil.boundary import resolve_boundary

#: Vertical neighbour offsets of the whole-strip foil (up, centre, down).
NEIGHBOR_OFFSETS_STRIP = (-1, 0, 1)

#: Whole-strip foil loads (``substrate_read_amp``'s h_block=0 case).
STRIP_NEIGHBOR_LOADS = len(NEIGHBOR_OFFSETS_STRIP)

#: Shared memory one H100 block may use (232,448 bytes = 227 KB).
SMEM_BUDGET_BYTES = 232448


def smem_budget_bytes() -> int:
    """The tile rule's shared-memory budget: ``REPRO_VMEM_BUDGET`` (the
    JAX package's sizing knob, read through envutil at every resolution)
    capped at :data:`SMEM_BUDGET_BYTES`, which is also the default.  The
    guard's degraded rung halves it, so the rule picks a smaller tile as
    the JAX rule picks a shorter strip; the kernels' own checks stay at
    the card's 227 KB."""
    return min(env_int("REPRO_VMEM_BUDGET", SMEM_BUDGET_BYTES, minimum=1),
               SMEM_BUDGET_BYTES)

#: Output tile edge the sizing prefers: at h = 4 the region read is
#: (1 + 8/64)^2 = 1.27x the tile, and two 64x64 CTAs fit on one SM.
PREFERRED_TILE = 64

#: wmma fragment edge (M = N = 16); tile edges are multiples of it.
MMA_TILE = 16

#: Output columns of one banded chunk: the band operand is
#: (BAND_N + 2R, BAND_N), one wmma N wide.
BAND_N = 16


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


# ---------------------------------------------------------------------------
# Sizing subset of repro.kernels.common, copied so the selector prices the
# same way (pricing_geom, SubstrateGeom, substrate_read_amp, ...).
# ---------------------------------------------------------------------------
def choose_hblock(strip_m: int, halo: int) -> int:
    """Halo-block height: smallest divisor of strip_m >= max(halo, strip/16)
    (the JAX rule; the selector's grid-free pricing resolves with it)."""
    if strip_m <= 0:
        raise ValueError(f"strip height must be positive, got {strip_m}")
    floor = max(halo, -(-strip_m // 16))      # integer ceil division
    cands = [d for d in range(1, strip_m + 1)
             if strip_m % d == 0 and d >= floor]
    return min(cands) if cands else strip_m


def substrate_read_amp(strip_m: int, h_block: int) -> float:
    """Analytic grid-read amplification along one axis: 1 + 2*h_block/strip_m
    for a tile of ``strip_m`` reading ``h_block`` halo cells per side;
    3.0 for the JAX whole-strip foil (``h_block=0``)."""
    if h_block is None:
        raise ValueError("h_block=None is 'auto' in the kernel API; resolve "
                         "it via choose_hblock first, or pass 0 for the "
                         "whole-strip substrate")
    if h_block == 0:
        return float(STRIP_NEIGHBOR_LOADS)
    return 1.0 + 2.0 * h_block / strip_m


@dataclasses.dataclass(frozen=True)
class SubstrateGeom:
    """Resolved tile geometry of one launch (the JAX dataclass, so reason
    strings and read amplifications match it verbatim).  The port's 2D
    tiles are ``SubstrateGeom(2, strip_m=TM, h_block=h, w_tile=TN,
    w_block=h)``."""

    dim: int
    strip_m: int
    h_block: int                 # 0 = whole-strip/whole-slab foil
    z_slab: int = 1              # 3D only; 1 otherwise
    z_block: int = 0             # 3D only
    w_tile: int = 0              # 0 = full width
    w_block: int = 0             # column halo block; 0 iff w_tile == 0

    @property
    def read_amp(self) -> float:
        if self.dim == 1:
            return 1.0
        amp = substrate_read_amp(self.strip_m, self.h_block)
        if self.dim == 3:
            amp *= substrate_read_amp(self.z_slab, self.z_block)
        if self.w_tile:
            amp *= substrate_read_amp(self.w_tile, self.w_block)
        return amp

    def describe(self) -> str:
        """The substrate clause of decision reason strings."""
        if self.dim == 3:
            geo = (f"z_slab={self.z_slab}, z_block={self.z_block}, "
                   f"strip_m={self.strip_m}, h_block={self.h_block}")
        elif self.dim == 1:
            geo = f"1D lifted, strip_m={self.strip_m}"
        else:
            geo = f"strip_m={self.strip_m}, h_block={self.h_block}"
        if self.dim >= 2:
            if self.w_tile:
                geo += f", w_tile={self.w_tile}, w_block={self.w_block}"
            else:
                geo += ", w_tile=full"
        return f"substrate read_amp={self.read_amp:.3f}x ({geo})"


def _resolve_z_block(h_block: int, z_block: int, z_slab: int,
                     halo: int) -> int:
    if h_block == 0:
        return 0
    if z_block == 0:
        raise ValueError(
            "z_block=0 (whole-slab) is only valid together with "
            "h_block=0 (the whole-slab foil substrate)")
    return z_block if z_block is not None else choose_hblock(z_slab, halo)


def _resolve_w_block(w_tile: int, w_block: int, h_block: int,
                     x_halo: int) -> tuple:
    if not w_tile:
        if w_block:
            raise ValueError(
                f"w_block={w_block} without a w_tile names no substrate; "
                "pin w_tile too (or drop both for full width)")
        return 0, 0
    if h_block == 0:
        raise ValueError(
            "the whole-strip/whole-slab foil substrate (h_block=0) spans "
            "the full width; column tiling (w_tile > 0) requires the "
            "sub-blocked substrate")
    if w_block is None or w_block == 0:
        return w_tile, choose_hblock(w_tile, max(x_halo, 1))
    return w_tile, w_block


def pricing_geom(dim: int, halo: int, strip_m: int = 128,
                 h_block: int = None, z_slab: int = None,
                 z_block: int = None, w_tile: int = None,
                 w_block: int = None) -> SubstrateGeom:
    """Grid-free geometry resolution for pricing (the JAX rule verbatim)."""
    if dim == 1:
        return SubstrateGeom(dim=1, strip_m=1, h_block=1)
    hb = choose_hblock(strip_m, halo) if h_block is None else h_block
    wt, wb = _resolve_w_block(w_tile, w_block, hb, halo)
    if dim == 2:
        return SubstrateGeom(dim=2, strip_m=strip_m, h_block=hb,
                             w_tile=wt, w_block=wb)
    if dim != 3:
        raise ValueError(f"substrate supports 1D/2D/3D grids, got dim {dim}")
    zs = strip_m if z_slab is None else z_slab
    zb = _resolve_z_block(hb, z_block, zs, halo)
    return SubstrateGeom(dim=3, strip_m=strip_m, h_block=hb,
                         z_slab=zs, z_block=zb, w_tile=wt, w_block=wb)


def _check_wrap_radius(w: int, r: int, mode: str = "periodic") -> None:
    """The per-axis radius guard of the JAX package, kept so both packages
    reject the same grids."""
    if mode == "periodic":
        if w < r:
            raise ValueError(
                f"wrap radius {r} exceeds grid width {w}; lower the radius")
        return
    if r >= w:
        raise ValueError(
            f"stencil radius {r} spans the whole {mode!r} axis "
            f"(extent {w}); a non-periodic axis needs extent > radius "
            "-- enlarge the grid or use a narrower stencil")


def _check_reflect_extent(extent: int, halo: int, axis: str,
                          mode: str) -> None:
    """Reflect needs ``halo`` in-domain mirror cells beyond the edge cell
    (the JAX guard, message unchanged): cell ``-k`` reads cell ``+k``, so
    the axis extent must exceed the total (fused) halo depth."""
    if mode == "reflect" and extent < halo + 1:
        raise ValueError(
            f"reflect boundary on the {axis} axis needs extent >= "
            f"halo+1 = {halo + 1}, got {extent}; mirror cells would "
            "fall outside the domain")


def check_grid(shape, w, t: int, boundary, kernel: str) -> tuple:
    """The kernels' argument rule: a 1D, 2D or 3D grid, a (2r+1)^d kernel
    of the same rank, and the boundary guards of the JAX
    ``validate_tiling`` on every axis for a launch of ``t`` fused steps
    (halo t*r), so both packages reject the same grids: the radius guard
    (a periodic axis shorter than r, a non-periodic one no longer than r:
    "whole 'zero' axis") and reflect's mirror depth ("mirror cells").
    The x axis is checked first, as in the JAX rule; the 1D lift's row
    axis is not an axis of the grid.  Returns ``(r, modes)``, the modes
    resolved per axis."""
    if len(shape) not in (1, 2, 3) or w.ndim != len(shape):
        raise ValueError(
            f"{kernel} runs 1D, 2D and 3D grids with a kernel of the same "
            f"rank, got grid rank {len(shape)} and kernel rank {w.ndim}")
    if len(set(w.shape)) != 1 or w.shape[0] % 2 == 0:
        raise ValueError(f"weights must be a (2r+1)^d kernel, got {w.shape}")
    modes = resolve_boundary(boundary, len(shape))
    r = (w.shape[0] - 1) // 2
    names = ("z", "y", "x")[-len(shape):]
    for ax in (len(shape) - 1,) + tuple(range(len(shape) - 1)):
        _check_wrap_radius(shape[ax], r, modes[ax])
        _check_reflect_extent(shape[ax], t * r, names[ax], modes[ax])
    return r, modes


#: Boundary mode codes of the kernels' launch interface; must match the
#: MODE_* codes in csrc/common.cuh.
BOUNDARY_CODES = {"periodic": 0, "zero": 1, "reflect": 2, "replicate": 3}


def lift_boundary_1d(boundary) -> tuple:
    """The (rows, cols) boundary of a 1D grid lifted to the (1, N) view:
    the lift's row axis is periodic (every wrapped row is row 0), the real
    axis keeps its mode (the JAX ``lift_boundary_1d``)."""
    (bx,) = resolve_boundary(boundary, 1)
    return ("periodic", bx)


def kernel_mode_codes(modes) -> tuple:
    """The mode code of every axis of the kernel a grid launches, from the
    grid's resolved modes: one per axis in 2D and 3D, and in 1D those of
    the lifted (1, N) view."""
    if len(modes) == 1:
        modes = lift_boundary_1d(modes)
    return tuple(BOUNDARY_CODES[m] for m in modes)


def lift_weights(w):
    """The (2r+1)^2 kernel of the 1D lift: the 1D kernel ``w`` as its
    middle row, so the 2D kernels on the (1, N) view compute the 1D
    stencil (the tap-sum skips the zero rows; ``build_bands_nd`` drops
    them, leaving one band)."""
    import numpy as np

    r = (w.shape[0] - 1) // 2
    out = np.zeros((w.shape[0],) * 2, dtype=w.dtype)
    out[r] = w
    return out


def hbm_read_bytes_per_step(shape, strip_m: int, dtype_bytes: int,
                            bands_shape=None, h_block: int = 0,
                            w_tile: int = 0, w_block: int = 0) -> int:
    """Analytic HBM read traffic of one JAX strip-substrate launch (the
    JAX model, copied for the traffic comparison; the port's own tiles
    read ``read_amp`` times the grid, see :func:`tile_read_bytes`)."""
    import numpy as np

    h, w = shape
    gm = h // strip_m
    rows_per_strip = round(strip_m * substrate_read_amp(strip_m, h_block))
    if w_tile:
        gw = -(-w // w_tile)
        cols_per_tile = round(w_tile * substrate_read_amp(w_tile, w_block))
        cells = gm * gw
        total = cells * rows_per_strip * cols_per_tile * dtype_bytes
    else:
        cells = gm
        total = gm * rows_per_strip * w * dtype_bytes
    if bands_shape is not None:
        total += cells * int(np.prod(bands_shape)) * dtype_bytes
    return total


def hbm_read_bytes_per_step_3d(shape, geom: SubstrateGeom, dtype_bytes: int,
                               bands_shape=None) -> int:
    """Analytic HBM read traffic of one JAX slab-substrate launch (the JAX
    model, copied for the traffic comparison)."""
    import numpy as np

    z, h, w = shape
    if geom.dim != 3:
        raise ValueError(f"3D traffic model needs a 3D geometry, got {geom}")
    cells = (z // geom.z_slab) * (h // geom.strip_m)
    planes = round(geom.z_slab
                   * substrate_read_amp(geom.z_slab, geom.z_block))
    rows = round(geom.strip_m
                 * substrate_read_amp(geom.strip_m, geom.h_block))
    if geom.w_tile:
        gw = -(-w // geom.w_tile)
        cols = round(geom.w_tile
                     * substrate_read_amp(geom.w_tile, geom.w_block))
        cells *= gw
        total = cells * planes * rows * cols * dtype_bytes
    else:
        total = cells * planes * rows * w * dtype_bytes
    if bands_shape is not None:
        total += cells * int(np.prod(bands_shape)) * dtype_bytes
    return total


# ---------------------------------------------------------------------------
# The port's own tiles
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SmemLayout:
    """Shared-memory layout of one kernel launch (element counts, bytes).

    ``planes`` x ``rows`` x ``ld`` f32 elements per region buffer
    (``planes`` is 1 in 2D); ``kpad`` the banded contraction depth
    BAND_N + 2R rounded up to the MMA K step; ``chunks`` x ``a_rows`` x
    ``kpad`` a chunked operand array (all three 0 for the 3D tap-sum;
    :func:`banded3d_layout`, the 3D tile rule's reserve, holds one chunk
    of ``planes`` x ``a_rows`` x ``kpad``); ``smem_bytes`` the dynamic
    shared memory the launch asks for.  The 2D and 3D banded kernels
    launch with a :class:`SlabLayout`.
    """

    rows: int
    ld: int
    smem_bytes: int
    kpad: int = 0
    a_rows: int = 0
    chunks: int = 0
    planes: int = 1


def mma_k_step(compute_bytes: int) -> int:
    """MMA K step: 8 for TF32 (two m16n8k4), 16 for bf16 (m16n8k16)."""
    return 8 if compute_bytes == 4 else 16


#: Floats the 2D tap-sum keeps before its first buffer, between its two
#: and after the second: a patch reads up to 3 cells past a buffer's rows.
#: Must match csrc/stencil_direct.cu.
DIRECT_MARGIN = 4


@dataclasses.dataclass(frozen=True)
class DirectLayout:
    """Shared-memory layout of the 2D tap-sum (``csrc/stencil_direct.cu``).

    Two f32 buffers of ``rows`` x ``ld``; region cell (i, j) is buffer
    cell (i, ``lead`` + j) of both, ``lead`` = (-h) mod 4 so that a row
    starts at the 16-byte granule holding the region's first cell and the
    tile's first column sits on a granule; ``ld`` is the region's
    ``lead`` + TN + 2h cells rounded up to whole granules.  Each buffer
    has ``DIRECT_MARGIN`` floats before it and the second one after it;
    ``smem_bytes`` is the dynamic shared memory the launch asks for.
    """

    rows: int
    ld: int
    lead: int
    smem_bytes: int


def direct_layout(tm: int, tn: int, halo: int) -> DirectLayout:
    """The 2D tap-sum's layout on a TM x TN tile at halo h."""
    lead = -halo % 4
    rows = tm + 2 * halo
    ld = _round_up(lead + tn + 2 * halo, 4)
    return DirectLayout(rows, ld, lead,
                        (2 * rows * ld + 3 * DIRECT_MARGIN) * 4)


#: Planes the 3D tap-sum's staging runs ahead of the plane it lands, and
#: the floats before each ring slot and after the last (a patch reads up
#: to 3 cells past a slot's rows); must match csrc/stencil_direct3d.cu.
DIRECT3D_AHEAD = 2
DIRECT3D_MARGIN = 4


@dataclasses.dataclass(frozen=True)
class Direct3dLayout:
    """Shared-memory layout of the 3D tap-sum (``csrc/stencil_direct3d.cu``):
    rings of planes, each plane one step's input window in the 2D
    tap-sum's fixed cell coordinates (:class:`DirectLayout`: ``rows`` x
    ``ld``, region cell (i, j) at (i, ``lead`` + j)).  Step 0's ring holds
    ``ring0`` = 2r + 1 + ``DIRECT3D_AHEAD`` slots (the planes a step reads,
    the plane landing and the one staged ahead), each later step's but
    the last ``ring`` = 2r + 2 (the planes read and the one the step before
    writes); the last step stores to global memory.  Every slot has
    ``DIRECT3D_MARGIN`` floats before it, ``plane_ld`` floats from one to
    the next, and the last one the margin after it; ``smem_bytes`` is what
    the launch asks for."""

    rows: int
    ld: int
    lead: int
    ring0: int
    ring: int
    slots: int
    plane_ld: int
    smem_bytes: int


def direct3d_layout(tm: int, tn: int, radius: int, t: int) -> Direct3dLayout:
    """The 3D tap-sum's rings on a (TZ x) TM x TN tile at ``t`` fused steps
    of radius ``radius`` (the depth TZ sets how many planes stream
    through, not the rings)."""
    d = direct_layout(tm, tn, t * radius)
    ring0, ring = 2 * radius + 1 + DIRECT3D_AHEAD, 2 * radius + 2
    slots = ring0 + (t - 1) * ring
    plane_ld = d.rows * d.ld + DIRECT3D_MARGIN
    return Direct3dLayout(d.rows, d.ld, d.lead, ring0, ring, slots, plane_ld,
                          (DIRECT3D_MARGIN + slots * plane_ld) * 4)


def direct3d_reserve(tz: int, tm: int, tn: int, halo: int) -> int:
    """Bytes the 3D tap-sum took before its plane stream: 344 dense taps
    and two f32 buffers of the whole (TZ+2h)(TM+2h)(TN+2h) region.  No
    kernel launches with it: it is the 3D tile rule's reserve
    (:func:`tile_smem_bound`), kept so that every 3D call keeps its tile
    while the rule is not re-derived for :func:`direct3d_layout`, which
    needs less at every tile but the shallowest."""
    planes, rows, ld = tz + 2 * halo, tm + 2 * halo, tn + 2 * halo
    return 344 * 4 + 2 * planes * rows * ld * 4


def _align(nbytes: int) -> int:
    return _round_up(nbytes, 128)


def banded3d_layout(tz: int, tm: int, tn: int, radius: int, t: int,
                    compute_bytes: int) -> SmemLayout:
    """The 3D banded kernel's layout before the slab fold: one f32 region
    buffer of (TZ + 2h) planes, each laid out as the 2D wmma kernel's
    region before the tile fold (rows and columns rounded up to whole
    16 x 16 tiles of the steps' outputs), and the operand array of ONE
    16-column chunk over every plane, A[plane][row][k].  No kernel
    launches with it: it is the 3D tile rule's reserve
    (:func:`tile_smem_bound`), kept so that every 3D call keeps its tile
    while the rule is not re-derived for :func:`slab_fold_layout`, which
    needs less at every tile."""
    halo = t * radius
    kpad = _round_up(BAND_N + 2 * radius, mma_k_step(compute_bytes))
    lead_out = 2 * (t - 1) * radius
    rows = max(tm + 2 * halo, _round_up(tm + lead_out, MMA_TILE))
    ld = _round_up(max(tn + 2 * halo, _round_up(tn + lead_out, MMA_TILE)), 8)
    if ld % 32 == 0:
        ld += 8
    a_rows = _round_up(tm + lead_out, MMA_TILE) + 2 * radius
    chunks = -(-(tn + lead_out) // BAND_N)
    planes = tz + 2 * halo
    smem = (_align(planes * rows * ld * 4)
            + planes * a_rows * kpad * compute_bytes)
    return SmemLayout(rows, ld, smem, kpad, a_rows, chunks, planes)


#: The slab and tile folds' passes (csrc/slab_fold.cuh, csrc/tile_fold.cuh):
#: each warp holds the sums of at most SLAB_TILES_PER_WARP 16-row MMA
#: tiles, so a pass of the CTA's 8 warps takes SLAB_PASS_TILES tiles.
SLAB_TILES_PER_WARP = 4
SLAB_PASS_TILES = 8 * SLAB_TILES_PER_WARP
#: Bytes of one band's header in shared memory (an int4).
SLAB_HEADER_BYTES = 16


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """Shared-memory layout of a 2D or 3D banded launch
    (``csrc/tile_fold.cuh``, ``csrc/slab_fold.cuh``, dense and compacted):
    the f32 region of ``planes`` planes (1 in 2D) of ``rows`` rows, ``ld``
    floats apart, the planes ``plane_ld`` floats apart; then
    ``n_rows`` Toeplitz rows of ``toe_ld`` compute-dtype elements, one per
    band; then one header per band.  ``kpad`` is the dense band's depth,
    ``a_cols`` the widest chunk column a band reads (``kpad`` on the
    dense operand), ``smem_bytes`` what the launch asks for."""

    planes: int
    rows: int
    ld: int
    plane_ld: int
    kpad: int
    toe_ld: int
    n_rows: int
    a_cols: int
    smem_bytes: int


def slab_fold_layout(tz: int, tm: int, tn: int, radius: int, t: int,
                     compute_bytes: int, n_rows: int,
                     k_rows: Optional[int] = None,
                     a_cols: Optional[int] = None) -> SlabLayout:
    """The 3D banded kernels' layout at ``t`` fused steps of radius
    ``radius`` on a (tz, tm, tn) tile with ``n_rows`` bands whose deepest
    runs ``k_rows`` padded rows (default: the dense ``kpad``).  The region
    holds the step-0 region, (tz+2h)(tm+2h)(tn+2h) with h = t*radius,
    and no more: the fold needs no 16-row rounding, and the chunks' stores
    are masked at the step's width.  Its row stride is 4 mod 8 words, and
    its plane stride is congruent mod 32 words to step 0's ho output rows
    of a plane, so the (plane, row) pairs m of step 0 lie m * ld words
    apart mod 32: the 8 rows of an A fragment hit 8 bank quads across a
    plane boundary too.  A band's Toeplitz row holds f(d) at d + 15 for
    d in [-15, k_rows) (``stencil_matmul.toeplitz_rows``): toe_ld =
    k_rows + 16 elements, a multiple of 8."""
    h = t * radius
    planes, rows, w0 = tz + 2 * h, tm + 2 * h, tn + 2 * h
    kpad = _round_up(BAND_N + 2 * radius, mma_k_step(compute_bytes))
    k_rows = kpad if k_rows is None else k_rows
    ld = w0 + (4 - w0) % 8
    ho = tm + 2 * (t - 1) * radius
    plane_ld = rows * ld + (ho - rows) * ld % 32
    toe_ld = k_rows + BAND_N
    smem = (_align(planes * plane_ld * 4)
            + _align(n_rows * toe_ld * compute_bytes)
            + n_rows * SLAB_HEADER_BYTES)
    return SlabLayout(planes, rows, ld, plane_ld, kpad, toe_ld, n_rows,
                      kpad if a_cols is None else a_cols, smem)


def tile_fold_layout(tm: int, tn: int, radius: int, t: int,
                     compute_bytes: int, n_rows: int,
                     k_rows: Optional[int] = None,
                     a_cols: Optional[int] = None) -> SlabLayout:
    """The 2D banded kernels' layout (``csrc/tile_fold.cuh``), the one-plane
    form of :func:`slab_fold_layout`: the step-0 region, (tm+2h) rows of
    ld >= tn+2h floats, ld 4 mod 8 words, so 8 consecutive rows (the rows
    of an A fragment) hit 8 bank quads; then the bands' Toeplitz rows and
    headers.  ``plane_ld`` is the region's size in floats."""
    h = t * radius
    rows, w0 = tm + 2 * h, tn + 2 * h
    kpad = _round_up(BAND_N + 2 * radius, mma_k_step(compute_bytes))
    k_rows = kpad if k_rows is None else k_rows
    ld = w0 + (4 - w0) % 8
    toe_ld = k_rows + BAND_N
    smem = (_align(rows * ld * 4)
            + _align(n_rows * toe_ld * compute_bytes)
            + n_rows * SLAB_HEADER_BYTES)
    return SlabLayout(1, rows, ld, rows * ld, kpad, toe_ld, n_rows,
                      kpad if a_cols is None else a_cols, smem)


@dataclasses.dataclass(frozen=True)
class FoldTile:
    """One 16-row MMA tile of one pass of the slab fold or the tile fold:
    step ``step``, 16-column chunk ``chunk``, pass ``pass_`` (of the chunk
    in 3D, of the step in 2D), the step's tile ``tile`` on warp ``warp``.
    ``pairs`` are the (plane, row) cells its 16 MMA rows compute (a row
    past the step's last pair computes the last pair again), ``stored``
    which of them it stores, ``cols`` the output columns [c0, c1) it
    stores, ``extent`` the step's input region (planes, rows, columns)
    and ``kv`` the chunk columns it loads (the rest read as zero)."""

    step: int
    chunk: int
    pass_: int
    tile: int
    warp: int
    pairs: tuple
    stored: tuple
    cols: tuple
    extent: tuple
    kv: int

    def reads(self, rows, k_step: int) -> Iterator[tuple]:
        """The region cells this tile's MMA rows read for the bands
        ``rows``, each ``(dz, dy, lo, nk)``: per row and band ``(plane,
        row, c_lo, c_kv, c_end)``, the columns [c_lo, c_kv) loaded and
        [c_kv, c_end) read as zero."""
        c0 = self.cols[0]
        for z, y in self.pairs:
            for dz, dy, lo, nk in rows:
                a, e = c0 + lo, c0 + lo + nk * k_step
                yield z + dz, y + dy, a, max(a, min(e, c0 + self.kv)), e


def slab_fold_tiles(tz: int, tm: int, tn: int, radius: int,
                    t: int) -> Iterator[FoldTile]:
    """The slab fold's map on a (tz, tm, tn) tile, exactly as
    ``csrc/slab_fold.cuh`` walks it: per step (each axis shrinking by
    ``radius``), per 16-column chunk of the step's output in order, per
    pass of at most SLAB_PASS_TILES tiles in pair order, every tile.  A
    tile is 16 consecutive (plane, row) output pairs, plane-major, of the
    step's po x ho; pass tile j runs on warp j mod 8.  Every CTA of a
    launch, and every grid of a batch, runs this map on its own region."""
    h = t * radius
    pin, hin, win = tz + 2 * h, tm + 2 * h, tn + 2 * h
    for s in range(t):
        po, ho, wo = pin - 2 * radius, hin - 2 * radius, win - 2 * radius
        pairs = po * ho
        ntiles = -(-pairs // MMA_TILE)
        for c, c0 in enumerate(range(0, wo, BAND_N)):
            kv = min(BAND_N + 2 * radius, win - c0)
            for pss, base in enumerate(range(0, ntiles, SLAB_PASS_TILES)):
                for j in range(min(SLAB_PASS_TILES, ntiles - base)):
                    ms = range((base + j) * MMA_TILE,
                               (base + j + 1) * MMA_TILE)
                    yield FoldTile(
                        s, c, pss, base + j, j % 8,
                        tuple(divmod(min(m, pairs - 1), ho) for m in ms),
                        tuple(m < pairs for m in ms),
                        (c0, min(c0 + BAND_N, wo)), (pin, hin, win), kv)
        pin, hin, win = po, ho, wo


def tile_fold_tiles(tm: int, tn: int, radius: int,
                    t: int) -> Iterator[FoldTile]:
    """The tile fold's map on a (tm, tn) tile, exactly as
    ``csrc/tile_fold.cuh`` walks it: per step (both axes shrinking by
    ``radius``), the step's 16-row tiles of its 16-column chunks,
    chunk-major, then by row tile, in passes of at most SLAB_PASS_TILES
    that cross chunks; step tile j runs on warp j mod 8.  A tile's rows
    are (0, y) pairs, a row past the step's last computing the last row
    again.  Every CTA of a launch, and every grid of a batch, runs this map
    on its own region."""
    h = t * radius
    hin, win = tm + 2 * h, tn + 2 * h
    for s in range(t):
        ho, wo = hin - 2 * radius, win - 2 * radius
        nrt = -(-ho // MMA_TILE)
        for j in range(nrt * -(-wo // BAND_N)):
            c, rt = divmod(j, nrt)
            c0 = c * BAND_N
            ms = range(rt * MMA_TILE, (rt + 1) * MMA_TILE)
            yield FoldTile(s, c, j // SLAB_PASS_TILES, j, j % 8,
                           tuple((0, min(m, ho - 1)) for m in ms),
                           tuple(m < ho for m in ms),
                           (c0, min(c0 + BAND_N, wo)), (1, hin, win),
                           min(BAND_N + 2 * radius, win - c0))
        hin, win = ho, wo


#: The folded 1D kernels' CTA tile (csrc/line_fold.cuh): LINE_WARPS warps
#: of LINE_TILE_ROWS rows, each row one w_tile-long segment of the line.
LINE_WARPS = 4
LINE_TILE_ROWS = MMA_TILE
LINE_ROWS = LINE_WARPS * LINE_TILE_ROWS

#: Shared memory past the last row window, so that a predicated-off A load
#: of the last row never addresses past the allocation.
LINE_SLACK_BYTES = 512


@dataclasses.dataclass(frozen=True)
class LineLayout:
    """Shared-memory layout of a folded 1D launch: per warp two staging
    buffers of LINE_TILE_ROWS row windows (``lds`` input-dtype elements
    apart, ``stage_bytes`` each) and, for a bfloat16 line, one f32 row
    region (``ld`` apart; a float32 line runs its steps in place in the
    staging buffer, whose rows are then at least ``ld`` wide), in
    ``warp_bytes``; ``rows`` the CTA tile's rows (TM), ``kpad`` the dense
    band's contraction depth, ``smem_bytes`` what the launch asks for."""

    rows: int
    lds: int
    ld: int
    kpad: int
    stage_bytes: int
    warp_bytes: int
    smem_bytes: int


def line_layout(w_tile: int, radius: int, t: int, in_bytes: int,
                compute_bytes: int) -> LineLayout:
    """The folded 1D kernels' layout at ``t`` fused steps of radius
    ``radius`` on rows of ``w_tile`` outputs.  A row window holds the
    row's L + 2h input cells from the 16-byte granule that holds its
    first cell (up to 16 / in_bytes - 1 cells before it); the region
    holds step 0's outputs in whole 16-column chunks.  Both strides are
    4 mod 8 words, so the 8 rows of an A fragment fall in 8 distinct bank
    quads, and keep every row on a 16-byte boundary.  A float32 line's
    steps run in place in its staging buffer (chunk c writes columns
    [16c, 16c + 16), which no later chunk reads), so it has no region and
    its staged rows are at least ``ld`` wide."""
    gran = 16 // in_bytes
    h = t * radius
    ld = _round_up(w_tile + 2 * (t - 1) * radius, BAND_N) + 4
    lds = _round_up(w_tile + 2 * h + gran - 1, gran)
    if in_bytes == 4:
        lds = max(lds, ld)
    while (lds * in_bytes // 4) % 8 != 4:
        lds += gran
    stage = _align(LINE_TILE_ROWS * lds * in_bytes)
    warp = 2 * stage + (0 if in_bytes == 4
                        else _align(LINE_TILE_ROWS * ld * 4))
    kpad = _round_up(BAND_N + 2 * radius, mma_k_step(compute_bytes))
    return LineLayout(LINE_ROWS, lds, ld, kpad, stage, warp,
                      LINE_WARPS * warp + LINE_SLACK_BYTES)


def line_tiles(n: int, geom: SubstrateGeom) -> int:
    """CTA tiles of a line of ``n`` points: ceil(n / (TM * w_tile))."""
    return -(-n // (LINE_ROWS * geom.w_tile))


def line_windows(n: int, geom: SubstrateGeom,
                 batch: int = 1) -> Iterator[tuple]:
    """Every row of every CTA tile of the folded 1D kernels on ``batch``
    lines of ``n`` points, exactly as ``csrc/line_fold.cuh`` indexes
    them: yields ``(b, tile, row, (out0, out1), (read0, read1))``, line b
    of the batch, its CTA tile and the row's index in it, the outputs
    [out0, out1) (clipped to the line) and the unwrapped cells it reads
    [out0 - h, out0 + L + h), h = ``geom.w_block``, L = ``geom.w_tile``.
    Rows that start past the line are not launched and not yielded."""
    L, h = geom.w_tile, geom.w_block
    for b in range(batch):
        for tile in range(line_tiles(n, geom)):
            for row in range(LINE_ROWS):
                q = (tile * LINE_ROWS + row) * L
                if q >= n:
                    break
                yield b, tile, row, (q, min(q + L, n)), (q - h, q + L + h)


#: Cells each buffer of the folded 1D tap-sum (csrc/stencil_direct1d.cu)
#: holds past the window: the 16-byte granule's shift and the read past
#: the last group of 4 outputs.  A CTA's segment is LINE_ROWS lifted tiles.
DIRECT1D_SLACK = 16


@dataclasses.dataclass(frozen=True)
class Direct1dLayout:
    """Shared-memory layout of a folded 1D tap-sum launch: two staging
    buffers of ``lds`` input-dtype elements (``stage_bytes`` each) and the
    f32 step buffers of ``ld`` elements (``work_bytes`` each): one for a
    float32 line, whose staging buffer serves as the second once step 0
    has read it, two for a bfloat16 line.  Every buffer keeps 16 bytes
    before its cell 0.  ``seg`` is the outputs of a CTA's segment,
    ``smem_bytes`` what the launch asks for."""

    seg: int
    lds: int
    ld: int
    stage_bytes: int
    work_bytes: int
    smem_bytes: int


def direct1d_layout(w_tile: int, halo: int, in_bytes: int) -> Direct1dLayout:
    """The folded 1D tap-sum's layout on segments of LINE_ROWS tiles of
    ``w_tile`` outputs at total halo ``halo``: each buffer holds the
    segment's window of seg + 2h cells and DIRECT1D_SLACK more, rounded
    up to 16 cells."""
    seg = LINE_ROWS * w_tile
    span = _round_up(seg + 2 * halo + DIRECT1D_SLACK, 16)
    lds, ld = 16 // in_bytes + span, 4 + span
    stage, work = _align(lds * in_bytes), _align(ld * 4)
    return Direct1dLayout(seg, lds, ld, stage, work,
                          2 * stage + (1 if in_bytes == 4 else 2) * work)


def line_segments(n: int, geom: SubstrateGeom,
                  batch: int = 1) -> Iterator[tuple]:
    """Every CTA segment of the folded 1D tap-sum on ``batch`` lines of
    ``n`` points, exactly as ``csrc/stencil_direct1d.cu`` indexes them:
    yields ``(b, seg, (out0, out1), (read0, read1))``, line b of the
    batch, the segment's index in it, its outputs [out0, out1) (LINE_ROWS
    tiles of ``geom.w_tile``, clipped to the line) and the unwrapped cells
    it reads [out0 - h, out1 + h), h = ``geom.w_block``."""
    s, h = LINE_ROWS * geom.w_tile, geom.w_block
    for b in range(batch):
        for seg in range(-(-n // s)):
            p0 = seg * s
            p1 = min(p0 + s, n)
            yield b, seg, (p0, p1), (p0 - h, p1 + h)


def _divisors(n: int) -> list:
    return [d for d in range(1, n + 1) if n % d == 0]


def tile_smem_bound(tm: int, tn: int, halo: int, tz: int) -> int:
    """The 3D tile rule's reserve at total halo ``halo`` on a (tz, tm, tn)
    candidate: the first half of the 3D rule (:func:`resolve_tile_geom`)
    keeps every 3D tile it has always picked by holding the candidates to
    it.  It is the most of the reserves of both 3D kernels
    (:func:`direct3d_reserve`, and the banded kernel before the slab fold
    at every (R, t) with t*R = halo and either operand dtype) and the
    tap-sum's rings at every such (R, t).  The rings exceed the tap-sum's
    reserve only on tiles one or two planes deep at h >= 5, and move one
    tile's fit to the budget: 1 x 48 x 32 at h = 5 (t = 5, r = 1).  The 2D
    rule has no reserve: it holds each candidate to the layout the 2D
    kernel of the launch really takes (:class:`TileNeed`)."""
    return max([direct3d_reserve(tz, tm, tn, halo)]
               + [direct3d_layout(tm, tn, halo // t, t).smem_bytes
                  for t in _divisors(halo)]
               + [banded3d_layout(tz, tm, tn, halo // t, t, cb).smem_bytes
                  for t in _divisors(halo) for cb in (4, 2)])


#: CTAs of a thread-block cluster the tile rule's third rung tries, least
#: first; 8 is the portable most (csrc/cluster.cuh).
CLUSTER_SIZES = (2, 4, 8)

#: Radii the 3D tap-sum's cluster form is built for (MAX_CLUSTER_RADIUS3D
#: in csrc/stencil_direct3d.cu); past them its rings stay one CTA's.
CLUSTER_RADIUS3D = 2


@dataclasses.dataclass(frozen=True)
class ClusterLayout:
    """A 3D launch's layout spread over a thread-block cluster of ``ctas``
    CTAs, whose shared memory the CTAs read and write through distributed
    shared memory (the tile rule's third rung, :func:`resolve_tile_geom`).
    Every CTA keeps the strides of ``base``, the one-CTA layout
    (:class:`Direct3dLayout` or :class:`SlabLayout`), and holds a share of
    it; rank k owns the items [split[k], split[k + 1]) of ``kind``:

      * ``"steps"``, the 3D tap-sum (``csrc/stencil_direct3d.cu``): the
        fused steps; rank k runs them and holds their rings (rank 0 step
        0's, which it stages), and its last step writes into the next
        rank's first ring;
      * ``"dz"``, a one-step slab fold (the composed contraction,
        ``csrc/slab_fold.cuh``): the kernel's planes dz; rank k holds the
        region planes [split[k], split[k + 1] - 1 + TZ) and the bands
        [rows[k], rows[k + 1]) of those dz (bands are in dz order), folds
        every output pair over them, and the partial sums are added
        through distributed shared memory before the one store;
      * ``"planes"``, a slab fold of t > 1 steps (the reuse folds): the
        region's planes; rank k holds its planes and the 2R after them,
        which it copies from their owners before each step.

    ``held`` is per rank the items its share holds (its steps' rings;
    region planes), ``shares`` each CTA's bytes, ``smem_bytes`` the most
    of them, what the launch asks each CTA for."""

    ctas: int
    kind: str
    split: tuple
    held: tuple
    shares: tuple
    smem_bytes: int
    base: object
    rows: tuple = ()


def _cluster_split(n: int, cost: Callable[[int, int], int],
                   budget: int) -> Optional[tuple]:
    """``(C, bounds)``: the least C of :data:`CLUSTER_SIZES` (at most
    ``n``) for which ``n`` items split into C contiguous non-empty groups
    whose ``cost(lo, hi)`` each fits ``budget``, and the bounds of that
    split whose largest cost is least (ties to the earlier bound); None
    where no C fits.  ``cost`` grows with the group, so the greedy count
    of groups decides whether a C fits."""
    groups, lo = 0, 0
    while lo < n:
        hi = lo + 1
        if cost(lo, hi) > budget:
            return None
        while hi < n and cost(lo, hi + 1) <= budget:
            hi += 1
        groups, lo = groups + 1, hi
    c = next((c for c in CLUSTER_SIZES if groups <= c <= n), None)
    if c is None:
        return None
    # the least largest cost of splitting [0, i) into k groups, and the
    # last group's start
    best = {(0, 0): (0, 0)}
    for k in range(1, c + 1):
        for i in range(k, n - (c - k) + 1):
            best[k, i] = min((max(best[k - 1, j][0], cost(j, i)), j)
                             for j in range(k - 1, i)
                             if (k - 1, j) in best)
    bounds, i = [n], n
    for k in range(c, 0, -1):
        i = best[k, i][1]
        bounds.append(i)
    return c, tuple(reversed(bounds))


@functools.lru_cache(maxsize=256)
def direct3d_cluster(tm: int, tn: int, radius: int, t: int,
                     budget: int) -> Optional[ClusterLayout]:
    """The 3D tap-sum's rings (:func:`direct3d_layout`) spread over the
    least cluster whose CTAs' shares of whole steps each fit ``budget``
    bytes (kind ``"steps"``), or None: rank k holds DIRECT3D_MARGIN floats
    and the rings of its steps, ``ring0`` slots for step 0, ``ring`` for
    every other."""
    base = direct3d_layout(tm, tn, radius, t)

    def share(lo: int, hi: int) -> int:
        slots = sum(base.ring0 if s == 0 else base.ring for s in range(lo, hi))
        return (DIRECT3D_MARGIN + slots * base.plane_ld) * 4

    found = _cluster_split(t, share, budget)
    if found is None:
        return None
    c, split = found
    own = tuple(zip(split, split[1:]))
    shares = tuple(share(a, b) for a, b in own)
    return ClusterLayout(c, "steps", split, own, shares, max(shares), base)


#: The k-steps the reuse folds' cluster form unrolls, by compute bytes
#: (``FoldKs<TC>::SMALL``, csrc/slab_fold.cuh ``slab_cluster_ks``): its
#: bands take at most these (radius <= 4 in TF32, any radius in bf16).
CLUSTER_REUSE_KS = {4: 3, 2: 2}

#: The deepest band the composed split takes (``SpMma<TC>::MAX_KS``
#: k-steps, MAX_KPAD rows: radius <= 24); a deeper composed contraction has
#: no cluster form, only the workspace form.
CLUSTER_MAX_KPAD = 64


@functools.lru_cache(maxsize=256)
def slab_cluster(tz: int, tm: int, tn: int, radius: int, t: int,
                 compute_bytes: int, dzs: tuple, k_rows: Optional[int],
                 a_cols: Optional[int], budget: int
                 ) -> Optional[ClusterLayout]:
    """The slab fold's layout (:func:`slab_fold_layout`, bands ``dzs``:
    each band's dz, in the launch's band order) spread over the least
    cluster whose CTAs' shares each fit ``budget`` bytes, or None: a
    one-step launch by the kernel's planes dz (kind ``"dz"``), a launch
    of t > 1 steps by the region's planes (kind ``"planes"``).  A share
    holds its planes at ``plane_ld``, then its bands' Toeplitz rows and
    headers, each part 128-byte aligned as in the one-CTA layout.  The
    reuse split takes bands of at most :data:`CLUSTER_REUSE_KS` k-steps,
    the composed split bands of at most :data:`CLUSTER_MAX_KPAD` rows."""
    base = slab_fold_layout(tz, tm, tn, radius, t, compute_bytes, len(dzs),
                            k_rows, a_cols)
    if t > 1 and (base.toe_ld - BAND_N) // mma_k_step(compute_bytes) > \
            CLUSTER_REUSE_KS[compute_bytes]:
        return None
    if base.toe_ld - BAND_N > CLUSTER_MAX_KPAD:
        return None

    def size(planes: int, bands: int) -> int:
        return (_align(planes * base.plane_ld * 4)
                + _align(bands * base.toe_ld * compute_bytes)
                + bands * SLAB_HEADER_BYTES)

    if t == 1:
        # the bands come in dz order: the first band of each dz
        first = [bisect.bisect_left(dzs, k) for k in range(2 * radius + 2)]

        def held(lo: int, hi: int) -> tuple:
            return lo, hi - 1 + tz

        def share(lo: int, hi: int) -> int:
            return size(tz + hi - lo - 1, first[hi] - first[lo])
        found = _cluster_split(2 * radius + 1, share, budget)
    else:
        def held(lo: int, hi: int) -> tuple:
            return lo, min(hi + 2 * radius, base.planes)

        def share(lo: int, hi: int) -> int:
            return size(min(hi + 2 * radius, base.planes) - lo, len(dzs))
        found = _cluster_split(base.planes, share, budget)
    if found is None:
        return None
    c, split = found
    pairs = tuple(zip(split, split[1:]))
    shares = tuple(share(a, b) for a, b in pairs)
    rows = tuple(first[k] for k in split) if t == 1 else ()
    return ClusterLayout(c, "dz" if t == 1 else "planes", split,
                         tuple(held(a, b) for a, b in pairs), shares,
                         max(shares), base, rows)


#: Streaming multiprocessors of an H100 SXM, the card the port targets: a
#: workspace form resolved off the card (a plan on the CPU, which runs the
#: plain versions, or the tile rule's TileNeed) is sized for it.
H100_SMS = 132

#: CTAs of a workspace form resident on one SM (WORKSPACE_MIN_BLOCKS in
#: csrc/common.cuh): every kernel's __launch_bounds__ minimum is at least
#: this, so its registers let that many share an SM with no dynamic shared
#: memory.
WORKSPACE_CTAS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class WorkspaceLayout:
    """A launch's layout placed in a device workspace instead of dynamic
    shared memory (the tile rule's fourth rung, :func:`resolve_tile_geom`):
    the same kernel body runs on ``base``, the one-CTA layout
    (:class:`DirectLayout`, :class:`Direct3dLayout` or :class:`SlabLayout`)
    with its strides and offsets unchanged, its storage a slice of a
    device array.  ``ctas`` persistent CTAs (the device's SMs x
    WORKSPACE_CTAS_PER_SM, the resident ones) each own one slice of
    ``slice_bytes`` and walk the tiles; ``total_bytes`` = ctas x
    slice_bytes is the workspace each launch allocates.  A fold's slice
    holds its region and band headers only: the bands' Toeplitz rows, the
    same for every CTA, stay in the one device array the wrapper uploads.
    ``smem_bytes`` is the dynamic shared memory the launch asks for:
    none."""

    base: object
    slice_bytes: int
    ctas: int
    total_bytes: int
    smem_bytes: int = 0


def as_workspace(lay, device) -> WorkspaceLayout:
    """The one-CTA layout ``lay`` of any 2D or 3D tap-sum or fold in a
    workspace on ``device``: one slice, rounded up to 128 bytes, for each
    of the device's SMs x WORKSPACE_CTAS_PER_SM (a CUDA device's own SM
    count; H100_SMS for any other device, or None, whose launches run the
    plain versions).  A tap-sum's slice is its whole layout, a fold's its
    region and then its band headers, at the offset the one-CTA layout
    gives its Toeplitz rows, which stay in device memory."""
    size = (_align(lay.planes * lay.plane_ld * 4)
            + lay.n_rows * SLAB_HEADER_BYTES if isinstance(lay, SlabLayout)
            else lay.smem_bytes)
    sms = H100_SMS
    if device is not None:
        import torch
        device = torch.device(device)
        if device.type == "cuda":
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
    ctas = sms * WORKSPACE_CTAS_PER_SM
    return WorkspaceLayout(lay, _align(size), ctas, ctas * _align(size))


def workspace_args(x, layout: WorkspaceLayout) -> tuple:
    """``(workspace, tail)`` of a fourth-rung launch on ``x``'s device: the
    workspace, allocated for this launch (:func:`allocate_workspace`;
    PyTorch's caching allocator hands the block to the next launch on the
    stream at no cost, and gives it back to other work between), and the
    launch's last arguments, its address, slice bytes and persistent
    CTAs.  The caller holds the workspace until the launch is queued."""
    ws = allocate_workspace(x.device, layout.total_bytes)
    return ws, (ws.data_ptr(), layout.slice_bytes, layout.ctas)


def allocate_workspace(device, nbytes: int):
    """``torch.empty`` of ``nbytes`` bytes on ``device``, or a ValueError
    where that passes the device's free memory (what CUDA reports
    free, and what PyTorch's allocator holds unused)."""
    import torch
    if torch.device(device).type != "cuda":
        raise ValueError(f"the workspace form runs on a CUDA device, got "
                         f"{device}")
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    if nbytes > free:
        raise ValueError(
            f"the launch's workspace needs {nbytes} bytes of device memory, "
            f"over the {free} bytes free on {device} (out of memory); lower "
            "the fusion depth")
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


@dataclasses.dataclass(frozen=True)
class TileNeed:
    """One launch's own shared memory on a candidate tile: ``smem(tz, tm,
    tn)`` bytes (tz = 1 in 2D; in 1D, tn is the lifted tile's width), the
    layout its kernel really launches with.  ``regime`` names it when no
    candidate fits.  The 2D tile rule holds the candidates to it, the 3D
    rule where the reserves fit none; ``cluster(tz, tm, tn,
    budget)`` (3D only) is the same layout spread over a thread-block
    cluster (:class:`ClusterLayout`, or None where no cluster of at most 8
    CTAs holds it), the rule's third rung; ``workspace(tz, tm, tn)`` (2D
    and 3D) the same layout in a device workspace
    (:class:`WorkspaceLayout`, sized off the card), the fourth."""

    regime: str
    smem: Callable[[int, int, int], int]
    cluster: Optional[Callable[[int, int, int, int],
                               Optional[ClusterLayout]]] = None
    workspace: Optional[Callable[[int, int, int], WorkspaceLayout]] = None


def tapsum_need(dim: int, radius: int, t: int, in_bytes: int,
                regime: str) -> TileNeed:
    """The tap-sums' layouts at ``t`` fused steps of radius ``radius``:
    :func:`direct_layout` (2D), :func:`direct3d_layout` (3D, and its
    cluster form :func:`direct3d_cluster`), :func:`direct1d_layout` (1D,
    a grid of ``in_bytes`` cells)."""
    h = t * radius
    if dim == 3:
        return TileNeed(regime, lambda tz, tm, tn: direct3d_layout(
            tm, tn, radius, t).smem_bytes,
            None if radius > CLUSTER_RADIUS3D else
            lambda tz, tm, tn, budget: direct3d_cluster(
                tm, tn, radius, t, budget),
            lambda tz, tm, tn: as_workspace(
                direct3d_layout(tm, tn, radius, t), None))
    if dim == 1:
        return TileNeed(regime, lambda tz, tm, tn: direct1d_layout(
            tn, h, in_bytes).smem_bytes)
    return TileNeed(regime, lambda tz, tm, tn: direct_layout(
        tm, tn, h).smem_bytes,
        workspace=lambda tz, tm, tn: as_workspace(direct_layout(tm, tn, h),
                                                  None))


def fold_need(dim: int, radius: int, t: int, in_bytes: int,
              compute_bytes: int, n_rows: int, regime: str,
              k_rows: Optional[int] = None,
              a_cols: Optional[int] = None,
              dzs: Optional[tuple] = None) -> TileNeed:
    """The banded folds' layouts at ``t`` steps of radius ``radius`` with
    ``n_rows`` bands (``k_rows`` / ``a_cols``: the compacted operand's):
    :func:`tile_fold_layout` (2D), :func:`slab_fold_layout` (3D, and its
    cluster form :func:`slab_cluster` where ``dzs``, each band's dz in
    band order, is given), :func:`line_layout` (1D)."""
    cb = compute_bytes
    if dim == 3:
        return TileNeed(regime, lambda tz, tm, tn: slab_fold_layout(
            tz, tm, tn, radius, t, cb, n_rows, k_rows, a_cols).smem_bytes,
            None if dzs is None else
            lambda tz, tm, tn, budget: slab_cluster(
                tz, tm, tn, radius, t, cb, tuple(dzs), k_rows, a_cols,
                budget),
            lambda tz, tm, tn: as_workspace(slab_fold_layout(
                tz, tm, tn, radius, t, cb, n_rows, k_rows, a_cols), None))
    if dim == 1:
        return TileNeed(regime, lambda tz, tm, tn: line_layout(
            tn, radius, t, in_bytes, cb).smem_bytes)
    return TileNeed(regime, lambda tz, tm, tn: tile_fold_layout(
        tm, tn, radius, t, cb, n_rows, k_rows, a_cols).smem_bytes,
        workspace=lambda tz, tm, tn: as_workspace(tile_fold_layout(
            tm, tn, radius, t, cb, n_rows, k_rows, a_cols), None))


def _tile_candidates(extent: int, pin: Optional[int], axis: str) -> list:
    cap = _round_up(extent, MMA_TILE)
    if pin is not None:
        if pin <= 0 or pin % MMA_TILE:
            raise ValueError(
                f"{axis}={pin} must be a positive multiple of {MMA_TILE} "
                "(the wmma tile edge)")
        return [min(pin, cap)]
    return [min(c, cap) for c in (PREFERRED_TILE, 32, MMA_TILE)]


#: Tile depths the 3D rule tries (TZ is free of the wmma edge).
Z_SLAB_CANDIDATES = (16, 8, 4, 2, 1)


def _z_candidates(extent: int) -> list:
    return sorted({min(c, extent) for c in Z_SLAB_CANDIDATES}, reverse=True)


def _z_pin(z_slab: int, extent: int) -> int:
    """A pinned tile depth, clamped to the grid's depth."""
    if int(z_slab) != z_slab or z_slab < 1:
        raise ValueError(f"z_slab must be a positive integer, got {z_slab!r}")
    return min(int(z_slab), extent)


def _too_deep(halo: int, budget: int, need: Optional[TileNeed] = None,
              least: int = 0) -> ValueError:
    what = ("" if need is None else
            f": {need.regime}'s own layout needs at least {least} bytes"
            + ("" if need.cluster is None else
               f", and no cluster of up to {CLUSTER_SIZES[-1]} CTAs holds "
               "it"))
    return ValueError(
        f"halo {halo} is too deep for a {MMA_TILE}-row tile in "
        f"{budget} bytes of shared memory{what}; lower the fusion depth")


def _candidates(grid_shape, halo: int, tile_m, w_tile, z_slab) -> list:
    """The tile rule's candidates ``(tz, tm, tn)`` in its order of
    preference (tz = 1 in 2D).  2D: (64, 64), (32, 32), (16, 16), pins
    kept.  3D: every (TZ, TM, TN) with TZ in ``Z_SLAB_CANDIDATES`` (or the
    pin) and TM, TN in {64, 32, 16}, by least read amplification
    (1 + 2h/TZ)(1 + 2h/TM)(1 + 2h/TN), ties to the larger tile -- the JAX
    ``choose_slab_blocks`` criterion."""
    tms = _tile_candidates(grid_shape[-2], tile_m, "tile_m")
    tns = _tile_candidates(grid_shape[-1], w_tile, "w_tile")
    if len(grid_shape) == 2:
        return [(1, tms[min(k, len(tms) - 1)], tns[min(k, len(tns) - 1)])
                for k in range(max(len(tms), len(tns)))]
    tzs = (_z_candidates(grid_shape[0]) if z_slab is None
           else [_z_pin(z_slab, grid_shape[0])])
    cands = [(tz, tm, tn) for tz in tzs
             for tm in dict.fromkeys(tms) for tn in dict.fromkeys(tns)]
    return sorted(cands, key=lambda c: (
        (1 + 2 * halo / c[0]) * (1 + 2 * halo / c[1]) * (1 + 2 * halo / c[2]),
        -c[0] * c[1] * c[2]))


def _reserve(halo: int) -> Callable:
    """The 3D reserve of a candidate ``(tz, tm, tn)``
    (:func:`tile_smem_bound`)."""
    return lambda c: tile_smem_bound(c[1], c[2], halo, c[0])


def _tapsum2d_need(halo: int) -> TileNeed:
    """The 2D tap-sum's layout at total halo ``halo`` (:func:`direct_layout`,
    which depends on the halo alone), with no workspace form: the layout
    the 2D rule holds a call without a layout of its own to."""
    return TileNeed("the 2D tap-sum", lambda tz, tm, tn: direct_layout(
        tm, tn, halo).smem_bytes)


def _tile_geom(dim: int, c: tuple, halo: int) -> SubstrateGeom:
    tz, tm, tn = c
    if dim == 2:
        return SubstrateGeom(dim=2, strip_m=tm, h_block=halo, w_tile=tn,
                             w_block=halo)
    return SubstrateGeom(dim=3, strip_m=tm, h_block=halo, z_slab=tz,
                         z_block=halo, w_tile=tn, w_block=halo)


def _check_halo(grid_shape, halo: int) -> int:
    dim = len(grid_shape)
    if dim not in (2, 3):
        raise ValueError(f"the port tiles 1D/2D/3D grids, got rank {dim}")
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo}")
    return dim


def resolve_tile_geom(grid_shape, halo: int, tile_m: Optional[int] = None,
                      w_tile: Optional[int] = None,
                      z_slab: Optional[int] = None,
                      need: Optional[TileNeed] = None) -> SubstrateGeom:
    """THE port's tile rule, by grid rank.

    2D (and the 1D lift, whose (1, N) view is a 2D grid): the first
    candidate (:func:`_candidates`: 64 x 64, 32 x 32, 16 x 16, at most
    PREFERRED_TILE on each axis and a multiple of 16, pins kept) on which
    the launch's own layout ``need`` (:class:`TileNeed`: the layout its
    kernel really launches with) fits the budget
    (:func:`smem_budget_bytes`, 227 KB by default).  A 2D call without a
    layout of its own (``need=None``) is held to the 2D tap-sum's
    (:func:`direct_layout`, with no workspace form), so it gets a tile on
    which a 2D kernel launches, or the "too deep" error: never a tile that
    no 2D kernel fits.  3D: the first candidate
    (the least read amplification) whose reserve (:func:`tile_smem_bound`)
    fits the budget, and ``need`` too -- the tile every 3D plan has
    launched on; where no reserve fits, the first candidate, in the same
    order, on which ``need`` fits.  Where that fits none either and
    ``need`` has a cluster form (3D, :class:`TileNeed`), the third rung:
    the first candidate, in the same order, on which the layout spread
    over a thread-block cluster of 2, 4 or 8 CTAs (the least that fits)
    fits each CTA's share in the budget; the launch carries the cluster in
    its layout (:class:`ClusterLayout`), so the tile stays a
    :class:`SubstrateGeom` and every tile the first two rungs pick stays.
    Where no cluster holds it either and ``need`` has a workspace form
    (the 2D and 3D tap-sums and folds, :class:`TileNeed`), the fourth
    rung: the rule's first candidate, the least read amplification, since
    no shared-memory budget binds a layout that lives in a device
    workspace (:class:`WorkspaceLayout`).  Where no rung fits (a 3D call
    without ``need``, a 1D launch, a foil, a 2D call without a layout of
    its own), the "too deep" ``ValueError``, naming the layout's regime
    and its least bytes on one CTA.  1D: the pricing geometry of the lift
    (the kernels launch :func:`lifted_tile_geom`).  ``tile_m`` /
    ``w_tile`` pin TM / TN (multiples of 16; clamped to the grid rounded
    up to 16), ``z_slab`` pins TZ (3D only; clamped to the grid's depth,
    the JAX pin's rule); a pinned depth none of whose tiles fits a launch
    with no workspace form raises with its shared memory.
    """
    grid_shape = tuple(int(n) for n in grid_shape)
    if len(grid_shape) == 1:
        return SubstrateGeom(dim=1, strip_m=1, h_block=1)
    dim = _check_halo(grid_shape, halo)
    cands = _candidates(grid_shape, halo, tile_m, w_tile, z_slab)
    budget = smem_budget_bytes()
    if dim == 2 and need is None:
        need = _tapsum2d_need(halo)
    fits = (lambda c: True) if need is None else (
        lambda c: need.smem(*c) <= budget)
    fit = None
    if dim == 3:
        reserve = _reserve(halo)
        fit = next((c for c in cands if reserve(c) <= budget and fits(c)),
                   None)
    if fit is None and need is not None:
        fit = next((c for c in cands if fits(c)), None)
    if fit is None and need is not None and need.cluster is not None:
        fit = next((c for c in cands if need.cluster(*c, budget)), None)
    if fit is None and need is not None and need.workspace is not None:
        fit = cands[0]
    if fit is not None:
        return _tile_geom(dim, fit, halo)
    size = _reserve(halo) if need is None else (lambda c: need.smem(*c))
    least = min(size(c) for c in cands)
    if dim == 3 and z_slab is not None:
        whose = "" if need is None else f"{need.regime}'s layout on "
        raise ValueError(
            f"z_slab={z_slab}: {whose}a {cands[0][0]}-deep tile at halo "
            f"{halo} needs at least {least} bytes of shared memory, over "
            f"the {budget}-byte budget; pin a shallower z_slab or lower the "
            "fusion depth")
    raise _too_deep(halo, budget, need, least)


def priced_tile_geom(grid_shape, halo: int, tile_m: Optional[int] = None,
                     w_tile: Optional[int] = None,
                     z_slab: Optional[int] = None,
                     needs=()) -> SubstrateGeom:
    """The tile a plan's decision prices at the fused halo ``halo``: the
    first candidate on which one of ``needs`` (the fused regimes' own
    layouts: the tap-sum's and the reuse fold's, ``registry.fused_needs``)
    fits, so the priced read amplification is the one the tap-sum or the
    reuse fold launches with (2D without ``needs``: the 2D tap-sum's
    layout, as :func:`resolve_tile_geom`); in 3D :func:`resolve_tile_geom`'s
    first rung where a reserve fits, and past the reserves the same first
    fit; else the rule's first candidate, unbudgeted.  It never raises for
    depth: every halo the JAX package prices is priced, and a regime that
    cannot launch raises when it is built.  1D: the lift's pricing
    geometry."""
    grid_shape = tuple(int(n) for n in grid_shape)
    if len(grid_shape) == 1:
        return SubstrateGeom(dim=1, strip_m=1, h_block=1)
    dim = _check_halo(grid_shape, halo)
    cands = _candidates(grid_shape, halo, tile_m, w_tile, z_slab)
    budget = smem_budget_bytes()
    if dim == 2 and not needs:
        needs = (_tapsum2d_need(halo),)
    fit = None
    if dim == 3:
        reserve = _reserve(halo)
        fit = next((c for c in cands if reserve(c) <= budget), None)
    if fit is None:
        fit = next((c for c in cands
                    if any(n.smem(*c) <= budget for n in needs)), cands[0])
    return _tile_geom(dim, fit, halo)


def lifted_tile_geom(n: int, halo: int, w_tile: Optional[int] = None,
                     need: Optional[TileNeed] = None) -> SubstrateGeom:
    """The 2D tile the 1D lift launches on the (1, N) view: 16-row tiles of
    which one row is the grid (every wrapped row is row 0).  The folded 1D
    kernels take its width as their row length (``line_windows``), so the
    banded kernels' chunks start where the lift's do, and the tap-sum's
    segments are LINE_ROWS of its tiles (``line_segments``); ``need`` is
    the folded kernel's own layout (:func:`tapsum_need`,
    :func:`fold_need` in 1D)."""
    return resolve_tile_geom((1, n), halo, None, w_tile, need=need)


def launch_geom(grid_shape, halo: int, tile_m: Optional[int] = None,
                w_tile: Optional[int] = None,
                z_slab: Optional[int] = None,
                need: Optional[TileNeed] = None) -> SubstrateGeom:
    """The tile the kernels launch on a grid of this shape at total halo
    ``halo``: :func:`resolve_tile_geom` in 2D and 3D, the lift's
    :func:`lifted_tile_geom` in 1D (where only ``w_tile`` applies), held
    to the launch's own layout ``need`` (in 3D where no reserve fits).
    Plans resolve it once when built; the wrappers take it as given."""
    if len(grid_shape) == 1:
        return lifted_tile_geom(int(grid_shape[0]), halo, w_tile, need)
    return resolve_tile_geom(grid_shape, halo, tile_m, w_tile, z_slab, need)


def check_tile_halo(geom: SubstrateGeom, halo: int) -> None:
    """Raise unless ``geom`` carries the halo ``halo`` a launch needs."""
    if geom.w_block != halo:
        raise ValueError(f"the tile carries a halo of {geom.w_block}, the "
                         f"launch needs {halo}")


def launch_grid(grid_shape, geom: SubstrateGeom) -> tuple:
    """CUDA grid: (tiles along x = columns, tiles along y = rows), and in
    3D tiles along z third.  The 3D kernels launch the product as a
    one-dimensional grid, x fastest."""
    gx = math.ceil(grid_shape[-1] / geom.w_tile)
    gy = math.ceil(grid_shape[-2] / geom.strip_m)
    if len(grid_shape) == 3:
        return gx, gy, math.ceil(grid_shape[0] / geom.z_slab)
    return gx, gy


def tile_windows(grid_shape, geom: SubstrateGeom) -> Iterator[tuple]:
    """Every CTA's output range and the unwrapped range it reads, per axis
    and exactly as the kernels index them: 2D yields ``((out_r0, out_r1),
    (out_c0, out_c1), (rd_r0, rd_r1), (rd_c0, rd_c1))``; 3D yields the
    z, row and column output ranges, then the z, row and column read
    ranges.  Outputs are clipped to the grid; reads are taken modulo the
    grid."""
    g = launch_grid(grid_shape, geom)
    tiles = [geom.w_tile, geom.strip_m] + ([geom.z_slab] if len(g) == 3
                                           else [])
    halos = [geom.w_block, geom.h_block] + ([geom.z_block] if len(g) == 3
                                            else [])
    extents = list(grid_shape)[::-1]
    for idx in itertools.product(*(range(n) for n in g[::-1])):
        idx = idx[::-1]                              # x, y[, z]
        outs, reads = [], []
        for i, tsz, hh, n in zip(idx, tiles, halos, extents):
            a = i * tsz
            outs.append((a, min(a + tsz, n)))
            reads.append((a - hh, a + tsz + hh))
        yield tuple(outs[::-1]) + tuple(reads[::-1])


# ---------------------------------------------------------------------------
# Staging: what a CTA reads to build its region.  The traffic foils read
# whole neighbour tiles and keep the region's cells of them, so they
# compute what the default kernel computes, bit for bit, from more bytes.
# ---------------------------------------------------------------------------
#: Staging codes of the kernels' launch interface (STAGE_* in
#: csrc/common.cuh): the region alone; the whole-strip foil (2D: the whole
#: tiles above, at and below the CTA's own, with the x-halo; 3D: the 3 x 3
#: whole (z, y) tiles, the whole-slab foil), K8; the seed 9-tile foil, K9
#: and K10 (2D, periodic).
STAGE_CODES = {"region": 0, "wholestrip": 1, "9tile": 2}


def check_staging(grid_shape, geom: SubstrateGeom, halo: int,
                  staging: str) -> None:
    """Raise unless a launch on ``geom`` at total halo ``halo`` can stage
    ``staging``: the foils' whole neighbour tiles must cover the halo, so
    every staged leading axis's tile is at least ``halo`` deep (the JAX
    ``validate_tiling`` messages), and the 9-tile foil is 2D only.  A 1D
    grid has one staging, the lift's: the 1D foil is the default lift,
    read amplification 1, as JAX's halo-0 ``flat`` kind."""
    if staging not in STAGE_CODES:
        raise ValueError(f"unknown staging {staging!r}; expected one of "
                         f"{tuple(STAGE_CODES)}")
    if staging == "region" or len(grid_shape) == 1:
        return
    if staging == "9tile" and len(grid_shape) != 2:
        raise ValueError(f"the 9-tile foil stages 2D grids only, got rank "
                         f"{len(grid_shape)}")
    if len(grid_shape) == 3 and geom.z_slab < halo:
        raise ValueError(f"halo {halo} exceeds z_slab {geom.z_slab}; "
                         "lower fusion depth or enlarge slabs")
    if geom.strip_m < halo:
        raise ValueError(f"halo {halo} exceeds strip height {geom.strip_m}; "
                         "lower fusion depth or enlarge strips")
    if staging == "9tile" and geom.w_tile < halo:
        raise ValueError(f"halo {halo} exceeds tile ({geom.strip_m},"
                         f"{geom.w_tile}); lower fusion depth or enlarge "
                         "tiles")


def foil_windows(grid_shape, geom: SubstrateGeom,
                 staging: str = "region") -> Iterator[tuple]:
    """Every CTA's output ranges and the windows its staging reads, exactly
    as ``csrc/common.cuh::load_region`` / ``load_region3d`` walk them:
    yields ``(outs, windows)``, ``outs`` the output ranges of
    :func:`tile_windows` and ``windows`` a tuple of windows, each one
    unwrapped ``(lo, hi)`` range per axis (read modulo the grid).  The
    region's cells of a window are kept and the others read and dropped.

      * ``"region"``: the one region of :func:`tile_windows`;
      * ``"wholestrip"``: 2D, the whole TM-row tiles above, at and below
        the CTA's own, each with the x-halo (rows ``i0 + d*TM`` to
        ``i0 + (d+1)*TM`` for d in :data:`NEIGHBOR_OFFSETS_STRIP`);
        3D, the 3 x 3 whole (z, y) tiles, the whole-slab foil;
      * ``"9tile"``: the 9 whole TM x TN tiles around and at the CTA's
        own, in the JAX ``NEIGHBOR_OFFSETS_2D`` order.

    2D and 3D grids (a 1D grid stages its lifted (1, N) view's region)."""
    dim = len(grid_shape)
    if dim not in (2, 3):
        raise ValueError(f"foil_windows takes 2D and 3D grids, got rank {dim}")
    check_staging(grid_shape, geom, geom.h_block, staging)
    h = geom.h_block
    sizes = ((geom.z_slab,) if dim == 3 else ()) + (geom.strip_m,
                                                    geom.w_tile)
    offs = NEIGHBOR_OFFSETS_STRIP
    for win in tile_windows(grid_shape, geom):
        outs, reads = win[:dim], win[dim:]
        if staging == "region":
            yield outs, (reads,)
            continue
        starts = [lo + h for lo, _ in reads]      # the CTA's own tile
        lead = range(dim - 1)
        if staging == "wholestrip":
            shifts = itertools.product(offs, repeat=dim - 1)
            windows = tuple(
                tuple((starts[a] + d[a] * sizes[a],
                       starts[a] + (d[a] + 1) * sizes[a]) for a in lead)
                + (reads[-1],) for d in shifts)
        else:
            windows = tuple(
                tuple((starts[a] + d[a] * sizes[a],
                       starts[a] + (d[a] + 1) * sizes[a]) for a in range(2))
                for d in itertools.product(offs, repeat=2))
        yield outs, windows


def staged_read_amp(geom: SubstrateGeom, staging: str) -> float:
    """Cells a launch reads per cell of the grid (aligned tiles): the
    tile's ``read_amp`` for the region; the foils' whole tiles count
    :data:`STRIP_NEIGHBOR_LOADS` per staged leading axis
    (``substrate_read_amp(tile, 0)``): 3(1 + 2h/TN) whole-strip, 9(1 +
    2h/TN) whole-slab, 9 for the 9-tile foil, whose x axis is staged
    too.  1D: the lift's 1."""
    if staging == "region" or geom.dim == 1:
        return geom.read_amp
    amp = substrate_read_amp(geom.strip_m, 0)
    if geom.dim == 3:
        amp *= substrate_read_amp(geom.z_slab, 0)
    if staging == "9tile":
        return amp * substrate_read_amp(geom.w_tile, 0)
    return amp * substrate_read_amp(geom.w_tile, geom.w_block)


def staged_read_bytes(grid_shape, geom: SubstrateGeom, staging: str,
                      dtype_bytes: int) -> int:
    """Bytes one launch requests from global memory: every CTA reads each
    cell of its staging's windows once (:func:`foil_windows`), ragged
    tiles whole, whatever the L2 cache then serves.  2D and 3D grids."""
    h = geom.h_block
    tiles = ((geom.z_slab,) if geom.dim == 3 else ()) + (geom.strip_m,
                                                         geom.w_tile)
    if staging == "region":
        cells = math.prod(n + 2 * h for n in tiles)
    elif staging == "wholestrip":
        cells = (STRIP_NEIGHBOR_LOADS ** (len(tiles) - 1)
                 * math.prod(tiles[:-1]) * (tiles[-1] + 2 * h))
    else:
        cells = 9 * math.prod(tiles)
    return math.prod(launch_grid(grid_shape, geom)) * cells * dtype_bytes


def staging_clause(geom: SubstrateGeom, staging: str) -> str:
    """What a foil's launches read, for ``explain``."""
    if geom.dim == 1:
        return ("the 1D lift (no vertical halo to stage), read_amp="
                f"{geom.read_amp:.3f}x")
    tile = "x".join(str(n) for n in (((geom.z_slab,) if geom.dim == 3
                                      else ()) + (geom.strip_m, geom.w_tile)))
    what = {"wholestrip": ("whole-strip foil: 3 whole tiles per CTA, with "
                           "the x-halo" if geom.dim == 2 else
                           "whole-slab foil: 3x3 whole (z, y) tiles per "
                           "CTA, with the x-halo"),
            "9tile": "9-tile foil: 9 whole tiles per CTA"}[staging]
    return (f"{what}, tile {tile}, halo {geom.h_block}, read_amp="
            f"{staged_read_amp(geom, staging):.3f}x (the region alone "
            f"{geom.read_amp:.3f}x)")


def assemble_strip(top, mid, bot, halo: int):
    """The whole-strip foil's region from its three whole tiles (the JAX
    ``assemble_strip``): the bottom ``halo`` rows of the tile above, the
    CTA's own tile, the top ``halo`` rows of the tile below."""
    import torch

    return torch.cat([top[-halo:], mid, bot[:halo]], dim=0)


def assemble_foil(tiles, halo: int):
    """The whole-slab foil's region from its 3 x 3 whole (z, y) tiles in
    (dz, dy) row-major order (the 3D branch of the JAX ``_assemble_foil``):
    each z row of tiles joined along y as :func:`assemble_strip` does,
    then the halo planes of the outer two along z."""
    import torch

    rows = [torch.cat([up[:, -halo:], mid, dn[:, :halo]], dim=1)
            for up, mid, dn in (tiles[3 * i:3 * i + 3] for i in range(3))]
    return torch.cat([rows[0][-halo:], rows[1], rows[2][:halo]], dim=0)


# ---------------------------------------------------------------------------
# The batch (K11): the counterpart of ``repro.kernels.common.fold_batch``.
# A batched launch advances B grids of one shape, stored one after another,
# grid b on blockIdx.z; the tile, the fill and the tile rule stay per grid
# (csrc/common.cuh, ``grid_at``).
# ---------------------------------------------------------------------------
#: The most grids one launch takes (CUDA's gridDim.z limit; MAX_GRID_Z in
#: csrc/common.cuh).
MAX_GRID_Z = 65535


def batch_chunks(batch: int) -> list:
    """``(first grid, grids)`` of each launch a batch of ``batch`` grids
    takes: chunks of at most :data:`MAX_GRID_Z`, as the C entries split it
    (``csrc/common.cuh::for_each_chunk``); the wrappers count one launch
    per chunk."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    return [(b0, min(MAX_GRID_Z, batch - b0))
            for b0 in range(0, batch, MAX_GRID_Z)]


def batch_grid(x, batched: bool) -> tuple:
    """The grid shape of a wrapper's input: ``x.shape``, or without its
    leading batch axis when ``batched`` -- never read from ``x.ndim``
    alone, which cannot tell a batch of 2D grids from a 3D grid."""
    if not batched:
        return tuple(x.shape)
    if x.ndim < 2 or x.shape[0] < 1:
        raise ValueError(f"a batched call takes (B,) + grid_shape with "
                         f"B >= 1, got {tuple(x.shape)}")
    return tuple(x.shape[1:])


def plain_loop(plain, x, batched: bool, *args):
    """``plain(x, *args)``; for a batched ``x``, the loop of it over the
    grids -- the plain version of a batched launch."""
    if not batched:
        return plain(x, *args)
    import torch

    return torch.stack([plain(xi, *args) for xi in x])


def fold_batch(run, mode: str):
    """Fold a leading batch axis through a plan's runner (the JAX
    ``fold_batch``): the returned callable consumes ``(B,) + grid_shape``
    and equals stacking ``B`` calls of ``run`` bit for bit.

    ``mode="vmap"`` batches the kernels themselves: each of the runner's
    kernel calls is one launch over the whole batch (K11).  ``mode="map"``
    loops the runner over the grids (``B`` launches per kernel call, the
    per-grid work of the unbatched plan).  As JAX traces a mapped runner
    once, the fault hooks fire for the first grid's launches only
    (``repro_torch.testing.faults.traced``), so one ``REPRO_FAULTS`` spec
    lands both packages on the same rung."""
    if mode == "map":
        from repro_torch.testing import faults
        import torch

        def folded(xb):
            ys = [run(xb[0])]
            with faults.traced():
                ys += [run(x) for x in xb[1:]]
            return torch.stack(ys)
    elif mode == "vmap":
        def folded(xb):
            return run(xb, batched=True)
    else:
        raise ValueError(f"fold_batch mode must be 'vmap' or 'map', "
                         f"got {mode!r}")
    if hasattr(run, "staging"):                 # a foil's (``explain``)
        folded.staging = run.staging
    return folded
