"""Window auditor: every CTA's staged windows, enumerated statically.

The port's kernels stage windows computed on the device from the CTA's
index; the host-side functions of ``repro_torch.kernels.common`` name
them exactly as the kernels index them (``tile_windows`` /
``foil_windows`` over ``launch_grid`` in 2D and 3D, ``line_segments`` for
the folded 1D tap-sum, ``line_windows`` for the line fold).  Walking them
-- no tracing, no execution -- gives the cells each CTA reads (its
*windows*), and the kernels' staging loops give the cells each CTA
issues copies for (its *staged* cells: the tap-sums and the 1D kernels
copy whole 16-byte granules, so they stage a few cells past a window;
the folds and every foil stage their windows cell by cell).

A walk is :class:`Walk`: the CTAs one by one when there are at most
:data:`WALK_LIMIT`, else per window class in closed form: a 2D or 3D
launch's windows are a product of per-axis windows, a 1D launch's
segments and rows are full but the last.  Above :data:`MAX_GRID_STEPS`
CTAs the byte checks are skipped (recorded, never failed).

Checks emitted per launch:

  * ``blocks/in-bounds``   -- every cell maps into the grid: the region
    of a CTA starts no deeper than the halo below a non-periodic axis
    (the fill rebuilds the cells within that depth; past the upper edge
    of a ragged tile, cells deeper than the halo feed only masked
    outputs; periodic axes read modulo), a region staging's window is
    the region, and a foil's every window meets it.
  * ``blocks/out-cover``   -- the output tiles cover the grid exactly
    once (ragged tiles clipped, their stores masked).
  * ``blocks/grid-bytes-model`` -- window cells x dtype bytes ==
    ``common.staged_read_bytes`` (1D: the segment / row windows, N + 2h
    per segment, L + 2h per row), exact integer equality.
  * ``blocks/read-amp-geom`` -- window cells / padded output cells (the
    ragged tiles whole) == ``common.staged_read_amp`` (1D: 1 + 2h/S or
    1 + 2h/L), rtol 1e-9.
  * ``blocks/staged-cells`` -- every CTA's staged cells hold its windows;
    the least and the most per CTA are what the counting build of the
    kernels must count on the card (``chip_smoke.py`` phase ``audit``).
  * ``blocks/bands-term``  -- the banded operand a CTA stages, at the
    layout the launch passes, == its built (packed, padded) shape.
  * ``blocks/priced-vs-launched`` -- a record, never a violation: the
    plan's priced read amplification beside the launched one's (and the
    grid-free JAX strip's).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Tuple

from repro_torch.kernels import common
from repro_torch.testing import faults
from .report import AuditCheck

#: Launches of more CTAs than this skip the byte-level checks (recorded as
#: skipped, never violations): the JAX guard, kept.
MAX_GRID_STEPS = 2_000_000

#: Launches of at most this many CTAs (the line fold: rows) are walked one
#: by one; larger ones per window class in closed form.
WALK_LIMIT = 1 << 15


def granule_shift(offset_cells: int, halo: int, in_bytes: int) -> int:
    """``csrc/line_stage.cuh::line_shift``: cells before a 1D window's
    first cell in its 16-byte granule, for a line starting
    ``offset_cells`` cells past a 16-byte aligned allocation."""
    g = 16 // in_bytes
    return ((offset_cells % g - halo) % g + g) % g


@dataclasses.dataclass
class Walk:
    """The windows of one launch.  ``ctas``: CTAs (1D tap-sum: segments;
    line fold: CTA tiles).  ``entries``: per CTA ``(outs, windows,
    staged)`` when walked one by one -- ``outs`` the clipped output range
    per axis, ``windows`` the unwrapped read ranges, ``staged`` the cells
    the staging copies -- else ``None`` and ``axes`` holds per axis the
    ``(out, windows)`` of every tile index (2D / 3D) or ``classes`` the
    1D window classes ``(count, out_cells, window_cells, staged)``."""

    launch: object
    ctas: int
    entries: Optional[list] = None
    axes: Optional[list] = None
    classes: Optional[list] = None

    @property
    def closed_form(self) -> bool:
        return self.entries is None

    def repeat_window(self) -> "Walk":
        """This walk with the first window of its first CTA (closed form:
        of its first tile on the first axis, or of its first 1D item) read
        twice: the ``geometry`` fault."""
        if self.entries is not None:
            outs, wins, staged = self.entries[0]
            extra = math.prod(b - a for a, b in wins[0])
            return dataclasses.replace(self, entries=[
                (outs, (wins[0],) + tuple(wins), staged + extra)]
                + self.entries[1:])
        if self.axes is not None:
            axes = [list(a) for a in self.axes]
            out, wins = axes[0][0]
            axes[0][0] = (out, (wins[0],) + tuple(wins))
            return dataclasses.replace(self, axes=axes)
        (count, out, win, staged), *rest = self.classes
        one = win if self.launch.family == "tapsum1d" else \
            self.launch.geom.w_tile + 2 * self.launch.total_halo
        return dataclasses.replace(self, classes=[
            (count - 1, out, win, staged),
            (1, out, win + one, staged + one)] + rest)


# ---------------------------------------------------------------------------
# What each family stages per CTA
# ---------------------------------------------------------------------------
def _tile(geom) -> Tuple[int, ...]:
    return ((geom.z_slab,) if geom.dim == 3 else ()) + (geom.strip_m,
                                                       geom.w_tile)


def direct_staged_row(launch) -> int:
    """Cells the 2D / 3D tap-sum's ``stage_region`` copies per region row
    (one plane row): ``ld`` cells from the granule holding the region's
    first cell (``common.direct_layout``)."""
    g = launch.geom
    return common.direct_layout(g.strip_m, g.w_tile, launch.total_halo).ld


def staged_per_cta(launch, windows_cells: int) -> int:
    """Cells one CTA of a 2D or 3D launch copies from global memory: the
    tap-sums' region staging copies whole granules (rows x ld per plane),
    the folds' and every foil's staging its windows' cells.  A launch
    spread over a thread-block cluster counts once per cluster, its CTAs'
    staging added (``csrc/cluster.cuh``, as the counting build counts
    it): the slab fold split by dz stages the TZ - 1 planes after each
    CTA's dz range in every CTA, (C - 1)(TZ - 1) planes more than the
    region."""
    if launch.family == "slab_fold" and launch.staging == "region":
        lay = _cluster_of(launch)
        if lay is not None and lay.kind == "dz":
            g, h = launch.geom, launch.total_halo
            planes = g.z_slab + 2 * h
            return windows_cells // planes * (
                planes + (lay.ctas - 1) * (g.z_slab - 1))
    if launch.staging != "region" or launch.family not in ("tapsum2d",
                                                           "tapsum3d"):
        return windows_cells
    g, h = launch.geom, launch.total_halo
    planes = g.z_slab + 2 * h if g.dim == 3 else 1
    return planes * (g.strip_m + 2 * h) * direct_staged_row(launch)


_CLUSTERS: dict = {}


def _cluster_of(launch):
    """The launch's :class:`common.ClusterLayout`, or None on one CTA
    (cached per launch: the walks ask once per CTA)."""
    key = id(launch)
    if key not in _CLUSTERS or _CLUSTERS[key][0] is not launch:
        from .scratch import launch_layout
        lay = launch_layout(launch)
        _CLUSTERS.clear()
        _CLUSTERS[key] = (launch, lay if isinstance(
            lay, common.ClusterLayout) else None)
    return _CLUSTERS[key][1]


def line_staged(launch, cells: int, offset_cells: int = 0) -> int:
    """Cells a folded 1D kernel's staging copies for a window of ``cells``
    cells: whole 16-byte granules from the one holding its first cell
    (``stage_window`` / ``stage_rows``)."""
    gran = 16 // launch.dtype_bytes
    sh = granule_shift(offset_cells, launch.total_halo, launch.dtype_bytes)
    return -(-(sh + cells) // gran) * gran


# ---------------------------------------------------------------------------
# Walks
# ---------------------------------------------------------------------------
def walk_windows(launch, closed_form: Optional[bool] = None) -> Walk:
    """The launch's windows: walked CTA by CTA, or per window class when
    ``closed_form`` (default: past :data:`WALK_LIMIT`).  The ``geometry``
    fault (``repro_torch.testing.faults``) corrupts the walk it returns."""
    shape, g = launch.grid_shape, launch.geom
    if len(shape) == 1:
        n = shape[0]
        if launch.family == "tapsum1d":
            items = -(-n // (common.LINE_ROWS * g.w_tile))
        else:
            items = -(-n // g.w_tile)                  # rows
        if closed_form is None:
            closed_form = items > WALK_LIMIT
        w = _walk_line_closed(launch) if closed_form else _walk_line(launch)
    else:
        ctas = math.prod(common.launch_grid(shape, g))
        if closed_form is None:
            closed_form = ctas > WALK_LIMIT
        w = _walk_axes(launch) if closed_form else _walk_ctas(launch)
    return faults.corrupt_geometry(w)


def _walk_ctas(launch) -> Walk:
    entries = []
    for outs, windows in common.foil_windows(launch.grid_shape, launch.geom,
                                             launch.staging):
        cells = sum(math.prod(b - a for a, b in win) for win in windows)
        entries.append((outs, windows, staged_per_cta(launch, cells)))
    return Walk(launch, len(entries), entries=entries)


def axis_windows(n: int, tile: int, halo: int, lead_axis: bool,
                 staging: str) -> list:
    """One axis of a 2D / 3D launch: per tile index ``(out, windows)``, the
    clipped output range and the unwrapped ranges the staging reads on
    this axis (the region's; a foil's three whole tiles on a staged
    leading axis)."""
    out = []
    for i in range(-(-n // tile)):
        a = i * tile
        if staging == "region" or not lead_axis:
            wins = ((a - halo, a + tile + halo),)
        else:
            wins = tuple((a + d * tile, a + (d + 1) * tile)
                         for d in common.NEIGHBOR_OFFSETS_STRIP)
        out.append(((a, min(a + tile, n)), wins))
    return out


def _walk_axes(launch) -> Walk:
    g, h = launch.geom, launch.total_halo
    tiles = _tile(g)
    axes = [axis_windows(n, tl, h, ax < len(tiles) - 1, launch.staging)
            for ax, (n, tl) in enumerate(zip(launch.grid_shape, tiles))]
    return Walk(launch, math.prod(len(a) for a in axes), axes=axes)


def _walk_line(launch) -> Walk:
    """The folded 1D kernels' windows, item by item: a tap-sum CTA's
    segment, or a line-fold CTA tile's rows (as ``line_windows`` yields
    them, grouped by tile)."""
    n, g = launch.grid_shape[0], launch.geom
    entries = []
    if launch.family == "tapsum1d":
        for _, _, (o0, o1), (r0, r1) in common.line_segments(n, g):
            entries.append((((o0, o1),), (((r0, r1),),),
                            line_staged(launch, r1 - r0)))
    else:
        for _, rows in itertools.groupby(common.line_windows(n, g),
                                         key=lambda r: r[:2]):
            rows = list(rows)
            entries.append((tuple(r[3] for r in rows),
                            tuple((r[4],) for r in rows),
                            sum(line_staged(launch, r[4][1] - r[4][0])
                                for r in rows)))
    return Walk(launch, len(entries), entries=entries)


def _walk_line_closed(launch) -> Walk:
    """The same per window class: the full items, then the last."""
    n, g, h = launch.grid_shape[0], launch.geom, launch.total_halo
    L = g.w_tile
    if launch.family == "tapsum1d":
        seg = common.LINE_ROWS * L
        full, last = divmod(n, seg)
        classes = [(full, seg, seg + 2 * h, line_staged(launch, seg + 2 * h))]
        if last:
            classes.append((1, last, last + 2 * h,
                            line_staged(launch, last + 2 * h)))
        return Walk(launch, full + (1 if last else 0), classes=classes)
    rows = -(-n // L)
    per_row = line_staged(launch, L + 2 * h)
    full, last = divmod(rows, common.LINE_ROWS)
    classes = [(full, common.LINE_ROWS * L, common.LINE_ROWS * (L + 2 * h),
                common.LINE_ROWS * per_row)]
    if last:
        classes.append((1, n - full * common.LINE_ROWS * L,
                        last * (L + 2 * h), last * per_row))
    return Walk(launch, full + (1 if last else 0), classes=classes)


# ---------------------------------------------------------------------------
# Totals of a walk
# ---------------------------------------------------------------------------
def window_cells(walk: Walk) -> int:
    """Cells of every CTA's windows, summed."""
    if walk.entries is not None:
        return sum(math.prod(b - a for a, b in win)
                   for _, wins, _ in walk.entries for win in wins)
    if walk.classes is not None:
        return sum(c * w for c, _, w, _ in walk.classes)
    return math.prod(sum(b - a for _, wins in ax for a, b in wins)
                     for ax in walk.axes)


def staged_range(walk: Walk) -> Tuple[int, int, int]:
    """``(least, most, total)`` staged cells per CTA over the launch."""
    if walk.entries is not None:
        st = [s for _, _, s in walk.entries]
        return min(st), max(st), sum(st)
    if walk.classes is not None:
        st = [(c, s) for c, _, _, s in walk.classes if c]
        return (min(s for _, s in st), max(s for _, s in st),
                sum(c * s for c, s in st))
    per_axis = [[sum(b - a for a, b in wins) for _, wins in ax]
                for ax in walk.axes]
    staged = {staged_per_cta(walk.launch, math.prod(c))
              for c in itertools.product(*map(set, per_axis))}
    if len(staged) == 1:
        (one,) = staged
        return one, one, walk.ctas * one
    total = sum(staged_per_cta(walk.launch, math.prod(c))
                for c in itertools.product(*per_axis))
    return min(staged), max(staged), total


def padded_out_cells(walk: Walk) -> int:
    """Output cells of the launch's tiles taken whole (ragged ones too)."""
    launch = walk.launch
    if len(launch.grid_shape) == 1:
        item = (common.LINE_ROWS * launch.geom.w_tile
                if launch.family == "tapsum1d" else launch.geom.w_tile)
        n_items = (walk.ctas if launch.family == "tapsum1d"
                   else -(-launch.grid_shape[0] // launch.geom.w_tile))
        return n_items * item
    return walk.ctas * math.prod(_tile(launch.geom))


def model_window_bytes(launch) -> int:
    """The byte model of the launch's windows: ``staged_read_bytes`` in 2D
    and 3D; the folded 1D kernels' segment windows (N + 2h per segment)
    or row windows (L + 2h per row)."""
    shape, g, h = launch.grid_shape, launch.geom, launch.total_halo
    if len(shape) > 1:
        return common.staged_read_bytes(shape, g, launch.staging,
                                        launch.dtype_bytes)
    n = shape[0]
    if launch.family == "tapsum1d":
        segs = -(-n // (common.LINE_ROWS * g.w_tile))
        return (n + 2 * h * segs) * launch.dtype_bytes
    return -(-n // g.w_tile) * (g.w_tile + 2 * h) * launch.dtype_bytes


def priced_grid_bytes(grid_shape, geom, dtype_bytes: int,
                      bands_shape=None) -> int:
    """The analytic model's read traffic of one launch on ``geom`` (JAX
    ``blocks._model_grid_bytes``): the JAX strip model
    ``hbm_read_bytes_per_step{,_3d}``; a 1D lift streams each point once
    (read amplification 1), plus the bands once when given."""
    if geom.dim == 1 or len(grid_shape) == 1:
        total = math.prod(grid_shape) * dtype_bytes
        if bands_shape is not None:
            total += math.prod(bands_shape) * dtype_bytes
        return total
    if len(grid_shape) == 3:
        return common.hbm_read_bytes_per_step_3d(grid_shape, geom,
                                                 dtype_bytes,
                                                 bands_shape=bands_shape)
    return common.hbm_read_bytes_per_step(grid_shape, geom.strip_m,
                                          dtype_bytes,
                                          bands_shape=bands_shape,
                                          h_block=geom.h_block,
                                          w_tile=geom.w_tile,
                                          w_block=geom.w_block)


def launched_read_amp(launch) -> float:
    """The launched read amplification: ``staged_read_amp`` of the tile
    in 2D and 3D; the folded 1D kernels' (1 + 2h/S) per segment or
    (1 + 2h/L) per row."""
    g, h = launch.geom, launch.total_halo
    if len(launch.grid_shape) > 1:
        return common.staged_read_amp(g, launch.staging)
    item = (common.LINE_ROWS * g.w_tile if launch.family == "tapsum1d"
            else g.w_tile)
    return 1.0 + 2.0 * h / item


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------
def _axis_modes(launch):
    return launch.boundary or ("periodic",) * len(launch.grid_shape)


def _check_bounds(walk: Walk) -> list:
    """Findings of ``blocks/in-bounds``: a kept window cell outside its
    tile's region, or a region starting deeper than the halo below (or at
    or past the end of) a non-periodic axis."""
    launch = walk.launch
    h, modes, shape = launch.total_halo, _axis_modes(launch), \
        launch.grid_shape
    tiles = _tile(launch.geom) if len(shape) > 1 else (
        (common.LINE_ROWS * launch.geom.w_tile
         if launch.family == "tapsum1d" else launch.geom.w_tile),)
    bad = []

    def axis(ax, out, wins):
        a = out[0]
        if len(shape) == 1 and launch.family == "tapsum1d":
            reg = (a - h, out[1] + h)
        else:
            reg = (a - h, a + tiles[ax] + h)
        if modes[ax] != "periodic" and not -h <= reg[0] < shape[ax]:
            bad.append({"axis": ax, "region": reg, "extent": shape[ax]})
        for lo, hi in wins:
            if min(hi, reg[1]) <= max(lo, reg[0]) or (
                    launch.staging == "region" and (lo, hi) != reg):
                bad.append({"axis": ax, "window": (lo, hi), "region": reg})

    if walk.entries is not None:
        for outs, wins, _ in walk.entries:
            if len(shape) == 1 and launch.family != "tapsum1d":
                for out, win in zip(outs, wins):
                    axis(0, out, win)
                continue
            for ax in range(len(shape)):
                axis(ax, outs[ax], [w[ax] for w in wins])
            if len(bad) >= 8:
                break
    elif walk.axes is not None:
        for ax, entries in enumerate(walk.axes):
            for out, wins in entries:
                axis(ax, out, wins)
    return bad[:8]


def _check_cover(walk: Walk):
    """``(ok, expected, actual)`` of ``blocks/out-cover``: the output
    tiles, on the tile lattice, each once, covering the grid."""
    launch = walk.launch
    shape = launch.grid_shape
    if walk.classes is not None:
        got = sum(c * o for c, o, _, _ in walk.classes)
        return got == shape[0], shape[0], got
    if walk.axes is not None:
        ok, seen = True, []
        for ax, entries in enumerate(walk.axes):
            outs = [o for o, _ in entries]
            ok &= (outs == sorted(set(outs)) and outs[0][0] == 0
                   and outs[-1][1] == shape[ax]
                   and all(a[1] == b[0] for a, b in zip(outs, outs[1:])))
            seen.append(len(outs))
        return ok, [-(-n // t) for n, t in zip(shape, _tile(launch.geom))], \
            seen
    if len(shape) == 1:
        outs = sorted(o for e in walk.entries for o in e[0])
        ok = (bool(outs) and outs[0][0] == 0 and outs[-1][1] == shape[0]
              and all(a[1] == b[0] for a, b in zip(outs, outs[1:])))
        return ok, shape[0], sum(b - a for a, b in outs)
    tiles = _tile(launch.geom)
    lattice = set()
    ok = True
    for outs, _, _ in walk.entries:
        idx = tuple(a // t for (a, _), t in zip(outs, tiles))
        box = tuple((i * t, min(i * t + t, n))
                    for i, t, n in zip(idx, tiles, shape))
        ok &= box == tuple(outs) and idx not in lattice
        lattice.add(idx)
    expected = math.prod(-(-n // t) for n, t in zip(shape, tiles))
    ok &= len(lattice) == expected == walk.ctas
    return ok, expected, len(lattice)


def audit_blocks(launch, walk: Optional[Walk] = None) -> List[AuditCheck]:
    """All window checks of one launch (``walk``: its
    :func:`walk_windows`, computed here when not given)."""
    checks: List[AuditCheck] = []
    shape = launch.grid_shape
    if len(shape) > 1:
        ctas = math.prod(common.launch_grid(shape, launch.geom))
    else:
        n, g = shape[0], launch.geom
        ctas = -(-n // ((common.LINE_ROWS if launch.family == "tapsum1d"
                         else 1) * g.w_tile))
    if ctas > MAX_GRID_STEPS:
        checks.append(AuditCheck(
            "blocks/grid-bytes-model", True, skipped=True,
            detail=f"launch has {ctas} CTAs > {MAX_GRID_STEPS}; the window "
                   "walk is skipped"))
        checks.append(priced_vs_launched(launch))
        return checks
    walk = walk if walk is not None else walk_windows(launch)
    how = ("per window class (closed form)" if walk.closed_form
           else "CTA by CTA")

    bad = _check_bounds(walk)
    checks.append(AuditCheck(
        "blocks/in-bounds", not bad, expected="every kept cell in its "
        "region; regions within the halo of a non-periodic axis",
        actual=bad or "ok",
        detail="" if not bad else "a window escapes its tile's region"))

    ok, expected, actual = _check_cover(walk)
    checks.append(AuditCheck(
        "blocks/out-cover", ok, expected=expected, actual=actual,
        detail="output tiles must cover the grid exactly once"))

    dtype_bytes = launch.dtype_bytes
    audited = window_cells(walk) * dtype_bytes
    model = model_window_bytes(launch)
    checks.append(AuditCheck(
        "blocks/grid-bytes-model", audited == model, expected=model,
        actual=audited,
        detail=f"window cells walked {how} x dtype bytes vs "
               + ("staged_read_bytes" if len(shape) > 1 else
                  "the folded kernels' segment / row windows")))

    model_amp = launched_read_amp(launch)
    if launch.family == "tapsum1d" and \
            shape[0] % (common.LINE_ROWS * launch.geom.w_tile):
        checks.append(AuditCheck(
            "blocks/read-amp-geom", True, skipped=True,
            expected=model_amp,
            detail="the line's last segment is ragged: its window is its "
                   "outputs + 2h, not a whole segment's"))
    else:
        audited_amp = window_cells(walk) / padded_out_cells(walk)
        checks.append(AuditCheck(
            "blocks/read-amp-geom",
            math.isclose(audited_amp, model_amp, rel_tol=1e-9),
            expected=model_amp, actual=audited_amp,
            detail="window cells / padded output cells vs "
                   + ("staged_read_amp" if len(shape) > 1 else
                      "1 + 2h / (segment or row)")))

    checks.append(_staged_check(walk))
    if launch.bands_shape is not None:
        checks.append(_bands_check(launch, walk.ctas))
    checks.append(priced_vs_launched(launch))
    return checks


def _staged_check(walk: Walk) -> AuditCheck:
    """``blocks/staged-cells``: every CTA stages at least its windows, and
    the granule spans hold them (the tap-sums' rows x ld from the granule
    holding the region's first cell; the 1D windows from the granule
    holding theirs)."""
    launch = walk.launch
    lo, hi, total = staged_range(walk)
    win = window_cells(walk)
    problems = []
    if total < win:
        problems.append(f"staged {total} < window cells {win}")
    if launch.family in ("tapsum2d", "tapsum3d") and \
            launch.staging == "region":
        g, h = launch.geom, launch.total_halo
        lay = common.direct_layout(g.strip_m, g.w_tile, h)
        if lay.lead != -h % 4 or lay.ld < lay.lead + g.w_tile + 2 * h \
                or lay.ld % 4:
            problems.append(f"granule span lead {lay.lead} + ld {lay.ld} "
                            f"does not hold {g.w_tile + 2 * h} columns")
    return AuditCheck(
        "blocks/staged-cells", not problems,
        expected={"window_cells": win},
        actual={"per_cta_least": lo, "per_cta_most": hi, "total": total,
                "excess": total / win if win else None,
                "problems": problems or "none"},
        detail="cells each CTA's staging copies (the counting build's "
               "count on the card); the granule spans hold the windows")


def operand_bytes_per_cta(launch, layout=None) -> int:
    """Bytes of the banded operand one CTA of the launch stages, from the
    layout it launches with: the 2D / 3D folds' Toeplitz rows, every warp
    of a line fold its band fragments."""
    from .scratch import _one, launch_layout
    lay = _one(layout if layout is not None else launch_layout(launch))
    cb = launch.compute_bytes
    if launch.family == "line_fold":
        k_step = common.mma_k_step(cb)
        (_, _, _, nk), = launch.band_rows
        return common.LINE_WARPS * nk * k_step * common.BAND_N * cb
    return lay.n_rows * lay.toe_ld * cb


def built_operand_bytes(launch) -> int:
    """Bytes of the built operand at its (packed, K-padded) shape: the
    bands of ``bands_shape`` padded to whole MMA k-steps -- the dense
    ones to kpad, each compacted one to its nk * K -- as the Toeplitz rows
    of the 2D / 3D folds (depth + BAND_N each, the deepest band's depth
    for all), or per warp of a line fold."""
    cb = launch.compute_bytes
    k_step = common.mma_k_step(cb)
    n = launch.n_offsets
    if launch.engine == "matmul":
        depths = [-(-launch.bands_shape[1] // k_step) * k_step] * n
    else:
        depths = [-(-(launch.tile_n + s) // k_step) * k_step
                  for s in launch.band_spans]
    if launch.family == "line_fold":
        return common.LINE_WARPS * depths[0] * launch.tile_n * cb
    return n * (max(depths) + launch.tile_n) * cb


def _bands_check(launch, ctas: int) -> AuditCheck:
    staged = operand_bytes_per_cta(launch) * ctas
    built = built_operand_bytes(launch) * ctas
    return AuditCheck(
        "blocks/bands-term", staged == built, expected=built, actual=staged,
        detail="the banded operand every CTA stages, at the layout the "
               "launch passes, vs its built (packed, K-padded) shape")


def priced_vs_launched(launch) -> AuditCheck:
    """``blocks/priced-vs-launched``: a record, never a violation."""
    grid_free = common.pricing_geom(launch.priced.dim,
                                    max(launch.priced.h_block, 1)
                                    if launch.priced.dim > 1 else 1)
    return AuditCheck(
        "blocks/priced-vs-launched", True,
        expected={"priced_amp": launch.priced.read_amp,
                  "priced": launch.priced.describe(),
                  "priced_bytes": priced_grid_bytes(
                      launch.grid_shape, launch.priced, launch.dtype_bytes)},
        actual={"launched_amp": launched_read_amp(launch),
                "launched_bytes": model_window_bytes(launch),
                "launched_tile": _tile(launch.geom)
                if len(launch.grid_shape) > 1
                else (common.LINE_ROWS * launch.geom.w_tile
                      if launch.family == "tapsum1d" else launch.geom.w_tile),
                "launched_halo": launch.total_halo,
                "grid_free_amp": grid_free.read_amp},
        detail="recorded, never a violation: the plan's decision prices "
               "the tile at the fused halo t*r; this launch runs its own "
               "tile at t_inner*R (grid_free_amp: the 128-row strip the "
               "selector prices without a grid)")


def audited_read_amp(grid_shape, geom, dtype_bytes: int = 4,
                     staging: str = "region") -> float:
    """Window cells over padded output cells of a region (or foil) walk
    of ``geom`` on ``grid_shape`` -- the audited witness of a reason
    string's read amplification.  A 1D geometry is the lift, which
    streams every point once: 1."""
    if geom.dim == 1:
        return 1.0
    if not geom.w_tile:                      # a full-width strip
        geom = dataclasses.replace(geom, w_tile=grid_shape[-1], w_block=0)
    ctas = math.prod(common.launch_grid(grid_shape, geom))
    tiles = _tile(geom)
    if ctas <= WALK_LIMIT:
        cells = sum(math.prod(b - a for a, b in win)
                    for _, wins in common.foil_windows(grid_shape, geom,
                                                       staging)
                    for win in wins)
    else:
        axes = [axis_windows(n, tl, geom.h_block, ax < len(tiles) - 1,
                             staging)
                for ax, (n, tl) in enumerate(zip(grid_shape, tiles))]
        cells = math.prod(sum(b - a for _, wins in ax for a, b in wins)
                          for ax in axes)
    return cells / (ctas * math.prod(tiles))
