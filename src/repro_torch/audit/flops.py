"""FLOP mirror: what the port's kernels issue, counted per launch, and the
model's arithmetic terms proved against it.

The JAX auditor counts FLOPs in the traced jaxpr.  The port's kernels are
CUDA, with no graph to walk, so this module mirrors each kernel's compute
loops in plain Python (:func:`mirror_launch`), per CTA class, exactly as
the ``.cu`` runs them:

  * the tap-sums (``stencil_direct{,3d,1d}.cu``): every patch of the work
    map (2D: V x 4 cells; 3D: the live planes of each interval; 1D: groups
    of 4), one FMA per nonzero tap and cell -- patches round a step's
    window up to whole patches, so cells outside it are computed too;
  * the folds (``tile_fold.cuh``, ``slab_fold.cuh``, ``line_fold.cuh``):
    every ``S::mma`` the warps issue -- per band, k-step and n8 half --
    of m16 x n8 x K (TF32: K = 8 as two m16n8k4 ``mma.sync``; bf16: one
    m16n8k16), the real tiles' and the idle slots' of a pass that does
    not fill every warp, and the m16n8k4 halves that read only zero band
    rows (the K padding past BAND_N + 2R).

Checks emitted per backend audit:

  * ``flops/structural``  -- the mirror's loop walk against an
    independent count: the tap-sums' closed form per step, the folds'
    tile MMAs from the maps (``common.tile_fold_tiles`` /
    ``slab_fold_tiles``, the line fold's rows); exact integers.  (The
    tests hold the mirror to the kernels' emulations.)
  * ``flops/alpha``       -- nnz(fused) / (t nnz(base)) == ``fusion_alpha``
    (monolithic fusion, canonical weights), as JAX ``flops.py:283``.
  * ``flops/beta``        -- executed points per output point of a fused
    launch == ``reuse_beta`` at the launched tile (1D: the row or segment
    as the one recomputed axis), taken at the kernel's rounding (patches,
    16-row MMA tiles, n8 halves); the excess of that rounding is recorded.
  * ``flops/sparse-compaction`` -- the compacted launch's MMAs == the
    packed rows' k-steps, integer-exact, and no more than the dense ones.
  * ``flops/matrix-reuse-model`` -- the reuse launches' tile MMA FLOPs per
    output point vs ``(beta / S) * t * 2P`` (S measured from the built,
    K-padded bands; times the kept fraction when compacted), rtol 5e-2.

Every report carries the executed and useful FLOPs (2 nnz points t) of its
launches per unit (:func:`flop_totals`): the paper's redundancy, on this
card's kernels.  All model lookups go through the ``perfmodel`` module
attribute at check time, so a monkeypatched (wrong) model is caught.
"""
from __future__ import annotations

import collections
import functools
import math
import pathlib
import re
from typing import List

import numpy as np

from repro_torch.kernels import common
from .report import AuditCheck

_CSRC = pathlib.Path(common.__file__).resolve().parent / "csrc"


@functools.lru_cache(maxsize=None)
def kernel_define(source: str, name: str) -> int:
    """An integer ``#define`` of a kernel source (the patch sizes)."""
    text = (_CSRC / source).read_text()
    m = re.search(rf"^#define {name} (\d+)", text, re.M)
    if m is None:
        raise ValueError(f"{source} defines no {name}")
    return int(m.group(1))


def direct_rows() -> int:
    """V, the rows of a 2D tap-sum thread's patch (``DIRECT_ROWS``)."""
    return kernel_define("stencil_direct.cu", "DIRECT_ROWS")


def direct3d_rows() -> int:
    return kernel_define("stencil_direct3d.cu", "DIRECT3D_ROWS")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# The mirror
# ---------------------------------------------------------------------------
class Count(collections.Counter):
    """One launch's (or CTA's) counts: ``fma`` (tap-sums), ``mma_tiles`` /
    ``mma_issued`` (``S::mma`` calls of real tiles / of every slot),
    ``zero_k4`` (issued m16n8k4 halves over zero band rows),
    ``points`` (cells computed), ``exact`` (cells of the step windows)."""

    def scaled(self, n: int) -> "Count":
        return Count({k: v * n for k, v in self.items()})


def _nnz_planes(w) -> list:
    """Nonzero taps per leading-axis plane (3D: per dz)."""
    return [int(np.count_nonzero(w[dz])) for dz in range(w.shape[0])]


def tapsum2d_cta(launch) -> Count:
    """One CTA of ``stencil_direct.cu``: the work map's patches per step
    (radii 4..7 run the wide patch, the same V x 4 outputs and taps)."""
    g, r, t = launch.geom, launch.radius, launch.t_inner
    h, V = launch.total_halo, direct_rows()
    nnz = int(np.count_nonzero(launch.weights))
    lead, rows0, cols0 = -h % 4, g.strip_m + 2 * h, g.w_tile + 2 * h
    g_lo = (lead + r) >> 2
    G = ((lead + cols0 - r + 3) >> 2) - g_lo
    c = Count()
    for s in range(t):
        r_lo, r_end = (s + 1) * r, rows0 - (s + 1) * r
        c_lo, c_end = lead + r_lo, lead + cols0 - (s + 1) * r
        nb = _ceil(r_end - r_lo, V)
        live = sum(1 for gg in range(G)
                   if (g_lo + gg) * 4 + 4 > c_lo and (g_lo + gg) * 4 < c_end)
        c["fma"] += live * nb * V * 4 * nnz
        c["points"] += live * nb * V * 4
        c["exact"] += (r_end - r_lo) * (c_end - c_lo)
    return c


def tapsum2d_closed(launch) -> int:
    """FMAs of one 2D tap-sum CTA in closed form (``flops/structural``)."""
    g, r, t = launch.geom, launch.radius, launch.t_inner
    h, V = launch.total_halo, direct_rows()
    nnz = int(np.count_nonzero(launch.weights))
    lead, rows0, cols0 = -h % 4, g.strip_m + 2 * h, g.w_tile + 2 * h
    g_lo = (lead + r) >> 2
    G = ((lead + cols0 - r + 3) >> 2) - g_lo
    total = 0
    for s in range(t):
        d = (s + 1) * r
        c_lo, c_end = lead + d, lead + cols0 - d
        live = min(G, _ceil(c_end, 4) - g_lo) - max(0, c_lo // 4 - g_lo)
        total += live * _ceil(rows0 - 2 * d, V) * V * 4 * nnz
    return total


def _axis_source(g: int, n: int, o: int, mode: str):
    """``stencil_direct3d.cu::axis_source``: the in-domain plane a step at
    depth o reads for global plane g (None under ``zero``)."""
    if mode == "periodic" or 0 <= g < n:
        return g
    if mode == "zero":
        return None
    if mode == "replicate":
        return 0 if g < 0 else n - 1
    return -g if g < 0 else 2 * (n - 1) - g


def tapsum3d_cta(launch, k0: int) -> Count:
    """One CTA of ``stencil_direct3d.cu`` whose tile starts at plane k0:
    interval by interval, every step's live output plane (inside the z
    domain of a non-periodic z axis only), its patches over the step's
    window, the planes a zero z axis skips left out of each patch."""
    g, r, t = launch.geom, launch.radius, launch.t_inner
    h, V = launch.total_halo, direct3d_rows()
    Z = launch.grid_shape[0]
    mz = (launch.boundary or ("periodic",) * 3)[0]
    zmap = mz != "periodic"
    per_plane = _nnz_planes(launch.weights)
    lead = -h % 4
    planes0, rows0, cols0 = g.z_slab + 2 * h, g.strip_m + 2 * h, \
        g.w_tile + 2 * h
    z0 = k0 - h
    c = Count()
    for k in range(planes0 + t - 1):
        for s in range(t):
            q = k - (s + 1) * r - s
            d = (t - 1 - s) * r
            glo, ghi = k0 - d, min(k0 + g.z_slab, Z) + d
            if zmap:
                glo, ghi = max(glo, 0), min(ghi, Z)
            if not glo - z0 <= q < ghi - z0:
                continue
            r_lo = (s + 1) * r
            c_lo, c_end = lead + r_lo, lead + cols0 - r_lo
            G = ((c_end + 3) >> 2) - (c_lo >> 2)
            n = G * _ceil(rows0 - 2 * r_lo, V)
            taps = sum(nz for dz, nz in enumerate(per_plane)
                       if _axis_source(z0 + q - r + dz, Z, (t - s) * r,
                                       mz) is not None)
            c["fma"] += n * V * 4 * taps
            c["points"] += n * V * 4
            c["exact"] += (rows0 - 2 * r_lo) * (cols0 - 2 * r_lo)
    return c


def tapsum3d_closed(launch, k0: int) -> int:
    """FMAs of one 3D tap-sum CTA in closed form: per step, its planes
    times its patches (periodic or replicate / reflect z; a zero z axis
    skips taps and is counted by the walk)."""
    g, r, t = launch.geom, launch.radius, launch.t_inner
    h, V = launch.total_halo, direct3d_rows()
    Z = launch.grid_shape[0]
    zmap = (launch.boundary or ("periodic",) * 3)[0] != "periodic"
    nnz = int(np.count_nonzero(launch.weights))
    lead = -h % 4
    rows0, cols0 = g.strip_m + 2 * h, g.w_tile + 2 * h
    total = 0
    for s in range(t):
        d, r_lo = (t - 1 - s) * r, (s + 1) * r
        lo, hi = k0 - d, min(k0 + g.z_slab, Z) + d
        if zmap:
            lo, hi = max(lo, 0), min(hi, Z)
        G = ((lead + cols0 - r_lo + 3) >> 2) - ((lead + r_lo) >> 2)
        total += (hi - lo) * G * _ceil(rows0 - 2 * r_lo, V) * V * 4 * nnz
    return total


def tapsum1d_item(launch, nv: int, sh: int) -> Count:
    """One segment of ``stencil_direct1d.cu`` (nv outputs, granule shift
    sh): each step's groups of 4 from its window's first cell rounded
    down to a multiple of 4."""
    r, t, h = launch.radius, launch.t_inner, launch.total_halo
    nnz = int(np.count_nonzero(launch.weights))
    c = Count()
    for s in range(t):
        if s == 0:
            lo, hi = sh + r, sh + 2 * h + nv - r
        else:
            lo, hi = sh + (s + 1) * r, sh + h + nv + (t - s) * r - r
        groups = max(0, _ceil(hi - (lo & ~3), 4))
        c["fma"] += groups * 4 * nnz
        c["points"] += groups * 4
        c["exact"] += hi - lo
    return c


def _k_step(launch) -> int:
    return common.mma_k_step(launch.compute_bytes)


def _band_ks(launch) -> list:
    """k-steps of every band (its ``nk``), as the kernels read them."""
    return [row[-1] for row in launch.band_rows]


def _zero_halves(launch) -> int:
    """Bands whose last k-step's upper m16n8k4 half reads only zero band
    rows (TF32 only: K = 8 is two k4 halves; rows past BAND_N + span)."""
    if launch.compute_bytes != 4:
        return 0
    k = _k_step(launch)
    spans = (launch.band_spans if launch.engine == "sparse_matmul"
             else [2 * launch.radius] * len(launch.band_rows))
    return sum(1 for nk, sp in zip(_band_ks(launch), spans)
               if nk * k - 4 >= common.BAND_N + sp)


def _mma_per_slot(launch) -> tuple:
    """(S::mma calls per n8 half over every band, of them over a zero
    k4 half) for one tile slot.  A band past MAX_KS k-steps (a composed
    kernel past radius 24) runs them in pieces of MAX_KS (``FoldKs::
    DEEP``), the same k-steps in the same order: the count is nk."""
    return sum(_band_ks(launch)), _zero_halves(launch)


def tile_fold_cta(launch) -> Count:
    """One CTA of ``tile_fold.cuh``: per step, its chunk-major tiles in
    passes of at most SLAB_PASS_TILES, every warp's TPW slots (an idle
    slot repeats the warp's last tile with its loads masked, or runs tile
    base + warp past the step's tiles), each over every band's k-steps,
    the second n8 half where its chunk holds outputs."""
    g, r, t, h = launch.geom, launch.radius, launch.t_inner, \
        launch.total_halo
    per, zero = _mma_per_slot(launch)
    hin, win = g.strip_m + 2 * h, g.w_tile + 2 * h
    c = Count()
    for s in range(t):
        ho, wo = hin - 2 * r, win - 2 * r
        nrt = _ceil(ho, common.MMA_TILE)
        ntiles = nrt * _ceil(wo, common.BAND_N)
        for base in range(0, ntiles, common.SLAB_PASS_TILES):
            n = min(common.SLAB_PASS_TILES, ntiles - base)
            tpw = _ceil(n, 8)
            for warp in range(8):
                mine = _ceil(n - warp, 8) if warp < n else 0
                for u in range(tpw):
                    tile = base + warp + min(u, max(mine - 1, 0)) * 8
                    halves = 1 + ((tile // nrt) * common.BAND_N + 8 < wo)
                    c["mma_issued"] += per * halves
                    c["zero_k4"] += zero * halves
                    if u < mine:
                        c["mma_tiles"] += per * halves
                        c["points"] += common.MMA_TILE * 8 * halves
        c["exact"] += ho * wo
        hin, win = ho, wo
    return c


def _planes_split(launch):
    """The owned region planes ``[(lo, hi), ...]`` of each CTA of a slab
    fold spread over a cluster by planes (kind ``"planes"``: the reuse
    folds past one CTA), or None on one CTA."""
    from .blocks import _cluster_of
    lay = _cluster_of(launch) if launch.staging == "region" else None
    if lay is None or lay.kind != "planes":
        return None
    return list(zip(lay.split, lay.split[1:]))


def slab_fold_cta(launch) -> Count:
    """One CTA of ``slab_fold.cuh`` (of a cluster, all its CTAs): per step
    and 16-column chunk, its (plane, row) tiles in passes of at most
    SLAB_PASS_TILES, every warp TPW slots, each over every band's
    k-steps, the second n8 half where the chunk holds outputs.  A cluster
    split by planes runs each CTA's own output pairs in its own passes; one
    split by dz runs every pair in every CTA over its bands (the sums per
    slot add up to every band's, the one-CTA count)."""
    g, r, t, h = launch.geom, launch.radius, launch.t_inner, \
        launch.total_halo
    per, zero = _mma_per_slot(launch)
    pin, hin, win = g.z_slab + 2 * h, g.strip_m + 2 * h, g.w_tile + 2 * h
    c = Count()
    for s in range(t):
        po, ho, wo = pin - 2 * r, hin - 2 * r, win - 2 * r
        for lo, hi in _planes_split(launch) or [(0, po)]:
            ntiles = _ceil(max(0, min(hi, po) - lo) * ho, common.MMA_TILE)
            for c0 in range(0, wo, common.BAND_N):
                halves = 1 + (c0 + 8 < wo)
                for base in range(0, ntiles, common.SLAB_PASS_TILES):
                    n = min(common.SLAB_PASS_TILES, ntiles - base)
                    c["mma_issued"] += 8 * _ceil(n, 8) * per * halves
                    c["zero_k4"] += 8 * _ceil(n, 8) * zero * halves
                    c["mma_tiles"] += n * per * halves
                    c["points"] += n * common.MMA_TILE * 8 * halves
        c["exact"] += po * ho * wo
        pin, hin, win = po, ho, wo
    return c


def cluster_adds(launch) -> int:
    """The f32 adds of a slab fold split by dz over C CTAs: each output
    cell of the grid takes the C partial sums, C - 1 adds."""
    from .blocks import _cluster_of
    lay = (_cluster_of(launch) if launch.family == "slab_fold"
           and launch.staging == "region" else None)
    if lay is None or lay.kind != "dz":
        return 0
    return (lay.ctas - 1) * math.prod(launch.grid_shape)


def line_fold_warp(launch) -> Count:
    """One warp's 16 rows of ``line_fold.cuh``: per step, the row window's
    16-column chunks, both n8 halves, every k-step of the band."""
    g, r, t, h = launch.geom, launch.radius, launch.t_inner, \
        launch.total_halo
    per, zero = _mma_per_slot(launch)
    win = g.w_tile + 2 * h
    c = Count()
    for _ in range(t):
        nch = _ceil(win - 2 * r, common.BAND_N)
        c["mma_issued"] += nch * 2 * per
        c["mma_tiles"] += nch * 2 * per
        c["zero_k4"] += nch * 2 * zero
        c["points"] += common.LINE_TILE_ROWS * nch * common.BAND_N
        c["exact"] += common.LINE_TILE_ROWS * (win - 2 * r)
        win -= 2 * r
    return c


def mirror_launch(launch) -> Count:
    """Every count of one launch over all its CTAs (one grid)."""
    shape, g = launch.grid_shape, launch.geom
    fam = launch.family
    if fam == "tapsum1d":
        from .blocks import granule_shift
        seg = common.LINE_ROWS * g.w_tile
        sh = granule_shift(0, launch.total_halo, launch.dtype_bytes)
        full, last = divmod(shape[0], seg)
        c = tapsum1d_item(launch, seg, sh).scaled(full)
        if last:
            c += tapsum1d_item(launch, last, sh)
        return c
    if fam == "line_fold":
        rows = _ceil(shape[0], g.w_tile)
        warps = _ceil(rows, common.LINE_TILE_ROWS)   # warps with rows
        return line_fold_warp(launch).scaled(warps)
    ctas = math.prod(common.launch_grid(shape, g))
    if fam == "tapsum3d":
        per_z = ctas // _ceil(shape[0], g.z_slab)
        c = Count()
        for k0 in range(0, shape[0], g.z_slab):
            c += tapsum3d_cta(launch, k0).scaled(per_z)
        return c
    one = {"tapsum2d": tapsum2d_cta, "tile_fold": tile_fold_cta,
           "slab_fold": slab_fold_cta}[fam](launch).scaled(ctas)
    one["add"] += cluster_adds(launch)
    return one


def independent_count(launch) -> dict:
    """The structural witness: the tap-sums' FMAs in closed form, the
    folds' tile MMAs from the kernels' maps (``common.tile_fold_tiles`` /
    ``slab_fold_tiles``; the line fold's rows from ``line_windows``)."""
    shape, g = launch.grid_shape, launch.geom
    fam = launch.family
    if fam == "tapsum2d":
        return {"fma": tapsum2d_closed(launch)
                * math.prod(common.launch_grid(shape, g))}
    if fam == "tapsum3d":
        per_z = math.prod(common.launch_grid(shape, g)) // _ceil(
            shape[0], g.z_slab)
        zero_z = (launch.boundary or ("periodic",))[0] == "zero"
        if zero_z:
            return {}
        return {"fma": sum(tapsum3d_closed(launch, k0) * per_z
                           for k0 in range(0, shape[0], g.z_slab))}
    if fam == "tapsum1d":
        # each step's window (nv + 2(t-1-s)R cells from the granule shift
        # plus (s+1)R) in groups of 4 from its first cell rounded down
        from .blocks import granule_shift
        r, t, n = launch.radius, launch.t_inner, shape[0]
        seg = common.LINE_ROWS * g.w_tile
        sh = granule_shift(0, launch.total_halo, launch.dtype_bytes)
        nnz = int(np.count_nonzero(launch.weights))
        total = 0
        for p0 in range(0, n, seg):
            nv = min(seg, n - p0)
            for s in range(t):
                first = sh + (s + 1) * r
                total += _ceil(first % 4 + nv + 2 * (t - 1 - s) * r, 4)
        return {"fma": total * 4 * nnz}
    per = sum(_band_ks(launch))
    if fam == "line_fold":
        rows = _ceil(shape[0], g.w_tile)
        warps = _ceil(rows, common.LINE_TILE_ROWS)
        chunks = sum(_ceil(g.w_tile + 2 * (launch.t_inner - s - 1)
                           * launch.radius, common.BAND_N)
                     for s in range(launch.t_inner))
        return {"mma_tiles": warps * chunks * 2 * per}
    if fam == "tile_fold":
        tiles = common.tile_fold_tiles(g.strip_m, g.w_tile, launch.radius,
                                       launch.t_inner)
    elif _planes_split(launch) is not None:
        # a cluster split by planes: each CTA's output pairs in 16-row
        # tiles of their own, per step and chunk
        r, t, h = launch.radius, launch.t_inner, launch.total_halo
        mma = 0
        for s in range(t):
            po = g.z_slab + 2 * (h - (s + 1) * r)
            ho = g.strip_m + 2 * (h - (s + 1) * r)
            wo = g.w_tile + 2 * (h - (s + 1) * r)
            halves = sum(1 + (wo - c0 > 8) for c0 in range(0, wo,
                                                           common.BAND_N))
            mma += per * halves * sum(
                _ceil(max(0, min(hi, po) - lo) * ho, common.MMA_TILE)
                for lo, hi in _planes_split(launch))
        return {"mma_tiles": mma * math.prod(common.launch_grid(shape, g))}
    else:
        tiles = common.slab_fold_tiles(g.z_slab, g.strip_m, g.w_tile,
                                       launch.radius, launch.t_inner)
    mma = sum(per * (1 + (f.cols[1] - f.cols[0] > 8)) for f in tiles)
    return {"mma_tiles": mma * math.prod(common.launch_grid(shape, g))}


def mma_shape(launch) -> tuple:
    """(m, n, k) of one ``S::mma`` call, and the ``mma.sync`` instructions
    it is: TF32 m16n8k8 as two m16n8k4; bf16 one m16n8k16."""
    k = _k_step(launch)
    return (common.MMA_TILE, 8, k), (2 if k == 8 else 1)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------
def launch_flops(launch) -> dict:
    """Executed FLOPs of one launch: ``vector`` (2 per FMA), ``matrix``
    (2 m n k per ``S::mma``, every slot) and ``matrix_tiles`` (the real
    tiles'), with the counts and the mma.sync instructions."""
    c = mirror_launch(launch)
    out = {"vector": 2 * c["fma"] + c["add"], "counts": dict(c)}
    if launch.engine != "direct":
        (m, n, k), instr = mma_shape(launch)
        out.update(matrix=2 * m * n * k * c["mma_issued"],
                   matrix_tiles=2 * m * n * k * c["mma_tiles"],
                   mma_sync=instr * c["mma_issued"],
                   zero_k4=c["zero_k4"])
    return out


def flop_totals(ctx, launches, per_launch) -> dict:
    """Executed and useful FLOPs of a backend's launches per unit (the
    paper's redundancy): useful = 2 nnz(base) x grid points x t."""
    nnz = int(np.count_nonzero(np.asarray(ctx.weights)))
    useful = 2 * nnz * math.prod(ctx.grid_shape) * ctx.t
    unit = "vector" if launches[0].engine == "direct" else "matrix"
    executed = sum(f["vector" if unit == "vector" else "matrix"]
                   for f in per_launch)
    out = {"unit": unit, "executed": executed, "useful": useful,
           "redundancy": executed / useful if useful else None}
    if unit == "matrix":
        tiles = sum(f["matrix_tiles"] for f in per_launch)
        out.update(executed_tiles=tiles,
                   mma_sync=sum(f["mma_sync"] for f in per_launch),
                   zero_k4=sum(f["zero_k4"] for f in per_launch),
                   redundancy_tiles=tiles / useful if useful else None)
    return out


def _model_beta(launch, spec):
    """``reuse_beta`` at the launched tile (module attribute, looked up
    now); 1D: the row (line fold) or segment (tap-sum) as the one
    recomputed axis -- the lift's priced beta is 1."""
    from repro_torch.core import perfmodel as pm
    g, t = launch.geom, launch.t_inner
    if len(launch.grid_shape) == 1:
        item = (common.LINE_ROWS * g.w_tile if launch.family == "tapsum1d"
                else g.w_tile)
        return pm.halo_recompute_factor_nd(launch.radius, t, (item,))
    return pm.reuse_beta(spec, t, strip_m=g.strip_m,
                         z_slab=g.z_slab if g.dim == 3 else None,
                         w_tile=g.w_tile)


def _beta_unit(launch):
    """``(counts, output cells)`` of one whole tile of the launch whose
    step windows are the tile's (a CTA inside the grid; 1D a full segment
    or a warp's rows), or the reason there is none."""
    shape, g = launch.grid_shape, launch.geom
    if launch.family == "tapsum1d":
        seg = common.LINE_ROWS * g.w_tile
        if shape[0] < seg:
            return "the line is shorter than one segment"
        from .blocks import granule_shift
        sh = granule_shift(0, launch.total_halo, launch.dtype_bytes)
        return tapsum1d_item(launch, seg, sh), seg
    if launch.family == "line_fold":
        return line_fold_warp(launch), common.LINE_TILE_ROWS * g.w_tile
    tile = ((g.z_slab,) if g.dim == 3 else ()) + (g.strip_m, g.w_tile)
    if launch.family == "tapsum3d":
        Z, h = shape[0], launch.total_halo
        zmap = (launch.boundary or ("periodic",))[0] != "periodic"
        for k0 in range(0, Z, g.z_slab):
            if k0 + g.z_slab <= Z and (not zmap or (
                    k0 >= h and k0 + g.z_slab + h <= Z)):
                return tapsum3d_cta(launch, k0), math.prod(tile)
        return ("no z tile whose step windows stay whole (a ragged or "
                "edge tile clips them)")
    one = {"tapsum2d": tapsum2d_cta, "tile_fold": tile_fold_cta,
           "slab_fold": slab_fold_cta}[launch.family](launch)
    return one, math.prod(tile)


def audit_flops(ctx, audit_spec) -> tuple:
    """``(checks, totals)``: the FLOP checks of one backend's launches and
    their :func:`flop_totals`."""
    from repro_torch.core import perfmodel as pm
    checks: List[AuditCheck] = []
    launches = audit_spec.launches
    spec, t = ctx.spec, ctx.t
    distinct = list({id(l): l for l in launches}.values())
    flops = {id(l): launch_flops(l) for l in distinct}
    per_launch = [flops[id(l)] for l in launches]

    # ---- structural: the mirror's walk vs the independent count --------
    expected, actual = {}, {}
    for l in distinct:
        ind = independent_count(l)
        counts = flops[id(l)]["counts"]
        for key, v in ind.items():
            expected[key] = expected.get(key, 0) + v
            actual[key] = actual.get(key, 0) + counts.get(key, 0)
    issued_ok = all(f["counts"].get("mma_issued", 0)
                    >= f["counts"].get("mma_tiles", 0) for f in per_launch)
    checks.append(AuditCheck(
        "flops/structural", expected == actual and issued_ok,
        expected=dict(expected, launches=len(launches)),
        actual=dict(actual, launches=len(launches)),
        detail="the kernel-loop mirror vs the closed form (tap-sums) or "
               "the tile maps (folds), exact integers"))

    # ---- sparse compaction: integer-exact k-steps of the packed rows ----
    sparse = [l for l in distinct if l.engine == "sparse_matmul"]
    for l in sparse:
        k = _k_step(l)
        kept_steps = sum(_ceil(l.tile_n + s, k) for s in l.band_spans)
        dense_steps = len(l.band_spans) * _ceil(l.tile_n + 2 * l.radius, k)
        c = flops[id(l)]["counts"]
        per = sum(_band_ks(l))
        slots = c["mma_tiles"] // per if per else 0
        ok = (per == kept_steps and c["mma_tiles"] == slots * kept_steps
              and kept_steps <= dense_steps
              and sum(l.tile_n + s for s in l.band_spans)
              == l.bands_shape[0])
        checks.append(AuditCheck(
            "flops/sparse-compaction", ok,
            expected={"k_steps_per_tile": kept_steps,
                      "dense_k_steps": dense_steps},
            actual={"k_steps_per_tile": per, "mma_tiles": c["mma_tiles"],
                    "kept": kept_steps / dense_steps},
            detail="the compacted contraction's MMAs must equal the packed "
                   "rows' k-steps, integer-exact, and never exceed the "
                   "dense count"))

    base_nnz = int(np.count_nonzero(np.asarray(ctx.weights)))
    canonical = base_nnz == spec.num_points

    # ---- alpha: fused tap count vs the paper's fusion model -------------
    fused = [l for l in launches
             if l.t_inner == 1 and l.radius == t * spec.radius and t > 1]
    if fused and launches[0].engine == "matmul":
        if canonical:
            wf_nnz = int(np.count_nonzero(np.asarray(fused[0].weights)))
            audited_alpha = wf_nnz / (t * base_nnz)
            model_alpha = pm.fusion_alpha(spec, t)
            checks.append(AuditCheck(
                "flops/alpha",
                math.isclose(audited_alpha, model_alpha, rel_tol=1e-9),
                expected=model_alpha, actual=audited_alpha,
                detail="nnz(fused) / (t * nnz(base)) vs fusion_alpha"))
        else:
            checks.append(AuditCheck(
                "flops/alpha", True, skipped=True,
                detail="base weights do not realize the spec tap set; "
                       "alpha is a spec-level model term"))

    # ---- beta: executed points of t-step launches -----------------------
    for l in distinct:
        if l.t_inner <= 1:
            continue
        unit = _beta_unit(l)
        if isinstance(unit, str):
            checks.append(AuditCheck("flops/beta", True, skipped=True,
                                     detail=unit))
            continue
        c, cells = unit
        exact = c["exact"] / (l.t_inner * cells)
        rounding = c["points"] / c["exact"]
        model = _model_beta(l, spec)
        executed = c["points"] / (l.t_inner * cells)
        ok = (math.isclose(exact, model, rel_tol=1e-9)
              and math.isclose(executed, model * rounding, rel_tol=1e-9))
        checks.append(AuditCheck(
            "flops/beta", ok,
            expected={"reuse_beta": model,
                      "at_kernel_rounding": model * rounding},
            actual={"exact_windows": exact, "executed": executed,
                    "excess": rounding},
            detail=f"executed points per output point, {l.family} "
                   f"t_inner={l.t_inner} vs reuse_beta at the launched "
                   "tile (patches / MMA tiles round the step windows up: "
                   "excess)"))

        # ---- full matrix-reuse FLOP model on the reuse launches ---------
        if l.engine in ("matmul", "sparse_matmul") and canonical:
            k = _k_step(l)
            kpad = _ceil(common.BAND_N + 2 * l.radius, k) * k
            n_rows = len(l.band_rows)
            s_meas = base_nnz / (n_rows * kpad)
            kept = sum(_band_ks(l)) * k / (n_rows * kpad)
            (m, n, kk), _ = mma_shape(l)
            per_point = 2 * m * n * kk * c["mma_tiles"] / cells
            model_pp = (model * rounding / s_meas) * l.t_inner * 2 \
                * spec.num_points * kept
            checks.append(AuditCheck(
                "flops/matrix-reuse-model",
                math.isclose(per_point, model_pp, rel_tol=5e-2),
                expected=model_pp, actual=per_point,
                detail="tile MMA FLOPs per output point vs (beta / S) * t * "
                       "2P at the kernel's rounding, S measured from the "
                       "built K-padded bands (* kept k-steps when "
                       "compacted)"))
    return checks, flop_totals(ctx, launches, per_launch)
