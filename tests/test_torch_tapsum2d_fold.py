"""The 2D tap-sum (``csrc/stencil_direct.cu``: K2 on 2D grids, with its
fill, foil and batch forms) on the CPU: a numpy emulation of the kernel
built on its layout (``common.direct_layout``) and its work map alone --
the region staged in 16-byte granules (cell by cell where a granule
cannot serve), NaN in every buffer cell nothing wrote and in every staged
cell outside the domain of a non-periodic axis, every access checked
against the dynamic shared memory, patches of V rows x 4 columns in fixed
cell coordinates, the fill on each step's input window -- against the JAX
package's 2D ``stencil_direct`` in interpret mode, the port's plain
version where JAX refuses the grid (an axis shallower than the halo) or
the grid is bfloat16, and the JAX 1D kernel on the lifted (1, N) view;
then the layout against the tile rule's bound and the 227 KB budget, the
source's constants, and the C launch arguments the wrapper passes.  The
kernel itself builds and runs only on the card (``chip_smoke.py``,
``fold_probe.py tapsum2d``)."""
import contextlib
import functools
import importlib
import pathlib
import re
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.stencil_direct import stencil_direct as j_direct  # noqa
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from repro_torch.stencil import resolve_boundary  # noqa: E402

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")

CSRC = pathlib.Path(common.__file__).parent / "csrc"
SRC = (CSRC / "stencil_direct.cu").read_text()


def _define(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)\b", SRC).group(1))


#: The kernel's patch rows (V) and threads per CTA.
V = _define("DIRECT_ROWS")
THREADS = int(re.search(r"#define CTA_THREADS (\d+)\b",
                        (CSRC / "common.cuh").read_text()).group(1))


# ---------------------------------------------------------------------------
# The kernel, emulated on its layout and work map
# ---------------------------------------------------------------------------
class _Smem:
    """A CTA's dynamic shared memory in floats: NaN until written, every
    read and write checked against both ends, and per step a count of
    the writes each cell took."""

    def __init__(self, nbytes):
        assert nbytes % 4 == 0
        self.a = np.full(nbytes // 4, np.nan)
        self.writes = np.zeros(len(self.a), dtype=np.int64)

    def read(self, lo, hi):
        assert 0 <= lo <= hi <= len(self.a), (lo, hi, len(self.a))
        return self.a[lo:hi]

    def write(self, lo, vals):
        hi = lo + len(vals)
        assert 0 <= lo <= hi <= len(self.a), (lo, hi, len(self.a))
        self.a[lo:hi] = vals
        self.writes[lo:hi] += 1


def work_map(G, nb):
    """The patches (g, b) every thread of a CTA takes in one step, in the
    kernel's order: thread k starts at (k mod G, k div G) and steps by
    (THREADS mod G, THREADS div G), carrying g past G into b."""
    out = []
    for k in range(THREADS):
        g, b = k % G, k // G
        while b < nb:
            out.append((g, b))
            g, b = g + THREADS % G, b + THREADS // G
            if g >= G:
                g, b = g - G, b + 1
    return out


def _fill_axis(win, axis, g0, n, o, mode):
    """common.cuh::fill_axis on a numpy window view (``axis`` 0: rows, 1:
    columns): the cells below the domain and above it within depth o are
    rebuilt from in-domain cells of the same line."""
    ext = win.shape[axis]
    lo, hb, he = min(ext, max(0, -g0)), n - g0, min(ext, n + o - g0)
    for q in list(range(lo)) + list(range(hb, he)):
        g = g0 + q
        dst = (slice(None), q) if axis else (q, slice(None))
        if mode == "zero":
            win[dst] = 0.0
        else:
            gs = ((0 if g < 0 else n - 1) if mode == "replicate"
                  else (-g if g < 0 else 2 * (n - 1) - g))
            win[dst] = win[(slice(None), gs - g0) if axis else (gs - g0, slice(None))]


def _leaves(mode, g0, n, N):
    return mode != "periodic" and (g0 < 0 or g0 + n > N)


def emulate_tapsum2d(x, w, t, geom, modes, staging="region", in_bytes=4,
                     stats=None):
    """The 2D tap-sum on the CPU, CTA by CTA of the (B, H, W) grids ``x``
    (float64 values; a bfloat16 grid's values widened), on the buffers of
    ``direct_layout``: the staging (``"region"``: 16-byte granules of 4
    cells from the granule holding the region's first cell -- grid b
    starts b H W cells into the allocation, taken as 16-byte aligned --
    and cell by cell where the source is off its granule or wraps
    mid-granule; a foil staging writes the region's cells alone), then
    per step the fill when the region leaves a non-periodic axis, the
    patches of the work map, and the tile read at (h, lead + h).
    ``stats`` counts granule and element copies, and with an "fma" key the
    FMAs the patches issue (one per nonzero tap and patch cell)."""
    b_, H, W = x.shape
    r = (w.shape[0] - 1) // 2
    kw = 2 * r + 1
    h = t * r
    tm, tn = geom.strip_m, geom.w_tile
    lay = common.direct_layout(tm, tn, h)
    rows0, cols0, ld, lead = tm + 2 * h, tn + 2 * h, lay.ld, lay.lead
    assert (lay.rows, lay.lead) == (rows0, -h % 4) and ld % 4 == 0
    b0 = common.DIRECT_MARGIN
    b1 = b0 + rows0 * ld + common.DIRECT_MARGIN
    assert b1 + rows0 * ld + common.DIRECT_MARGIN == lay.smem_bytes // 4
    y = np.full(x.shape, np.nan)
    for b in range(b_):
        for i0 in range(0, H, tm):
            for j0 in range(0, W, tn):
                sm = _Smem(lay.smem_bytes)
                _stage(sm, x[b], b * H * W, i0 - h, j0 - h, rows0, cols0, ld,
                       lead, b0, modes, staging, in_bytes, stats)
                fill = (_leaves(modes[0], i0 - h, rows0, H)
                        or _leaves(modes[1], j0 - h, cols0, W))
                bufs = (b0, b1)
                for s in range(t):
                    src, dst = bufs[s % 2], bufs[1 - s % 2]
                    if fill:
                        o, hin, win_ = (t - s) * r, rows0 - 2 * s * r, cols0 - 2 * s * r
                        view = sm.a[src:src + rows0 * ld].reshape(rows0, ld)[
                            s * r:s * r + hin, lead + s * r:lead + s * r + win_]
                        if _leaves(modes[0], i0 - o, hin, H):
                            _fill_axis(view, 0, i0 - o, H, o, modes[0])
                        if _leaves(modes[1], j0 - o, win_, W):
                            _fill_axis(view, 1, j0 - o, W, o, modes[1])
                    _step(sm, src, dst, w, r, kw, s, rows0, cols0, ld, lead,
                          stats)
                fin = bufs[t % 2] + h * ld + lead + h
                for i in range(min(tm, H - i0)):
                    n = min(tn, W - j0)
                    y[b, i0 + i, j0:j0 + n] = sm.read(fin + i * ld, fin + i * ld + n)
    return y


def _stage(sm, xg, base, r0, c0, rows0, cols0, ld, lead, b0, modes, staging,
           in_bytes, stats):
    """The staging of one CTA's region into buffer 0 (see
    emulate_tapsum2d); a staged cell outside the domain of a non-periodic
    axis is NaN, so an output that reads it without the fill shows."""
    H, W = xg.shape

    def cell(q, c):
        gr, gc = r0 + q, c0 + c
        v = xg[gr % H, gc % W]
        out_r = modes[0] != "periodic" and not 0 <= gr < H
        out_c = modes[1] != "periodic" and not 0 <= gc < W
        return np.nan if out_r or out_c else v

    if staging != "region":        # the foils' load_window: region cells
        for q in range(rows0):
            sm.write(b0 + q * ld + lead, [cell(q, k) for k in range(cols0)])
        return
    cb = c0 - lead
    for f in range(rows0 * (ld // 4)):
        q, k = divmod(f, ld // 4)
        gc = (cb + 4 * k) % W
        src = base + ((r0 + q) % H) * W + gc
        granule = gc + 4 <= W and src % 4 == 0   # 16 bytes = 4 cells
        if stats is not None:
            stats["granule" if granule else "element"] += 1
        dst = b0 + q * ld + 4 * k
        assert b0 <= dst and dst + 4 <= b0 + rows0 * ld
        sm.write(dst, [cell(q, 4 * k + u - lead) for u in range(4)])


def _step(sm, src, dst, w, r, kw, s, rows0, cols0, ld, lead, stats=None):
    """One step: every patch of the work map from buffer ``src`` into
    ``dst``; each output of the step's window is written once, and no
    write lands outside ``dst``'s rows."""
    g_lo = (lead + r) >> 2
    G = ((lead + cols0 - r + 3) >> 2) - g_lo
    r_lo, r_end = (s + 1) * r, rows0 - (s + 1) * r
    c_lo, c_end = lead + r_lo, lead + cols0 - (s + 1) * r
    nb = -(-(r_end - r_lo) // V)
    patches = work_map(G, nb)
    assert len(set(patches)) == len(patches) == G * nb
    sm.writes[:] = 0
    for g, b in patches:
        c = (g_lo + g) * 4
        if not (c + 4 > c_lo and c < c_end):
            continue
        r0 = r_lo + b * V
        rows = [sm.read(src + min(r0 - r + q, rows0 - 1) * ld + c - r,
                        src + min(r0 - r + q, rows0 - 1) * ld + c + 4 + r)
                for q in range(V + 2 * r)]
        win = np.stack(rows)
        acc = np.zeros((V, 4))
        for dy in range(kw):
            for dx in range(kw):
                if w[dy, dx] != 0.0:
                    acc = acc + float(w[dy, dx]) * win[dy:dy + V, dx:dx + 4]
                    if stats is not None and "fma" in stats:
                        stats["fma"] += V * 4
        for o in range(V):
            if r0 + o < r_end:
                assert 0 <= (r0 + o) * ld + c and (r0 + o) * ld + c + 4 <= rows0 * ld
                sm.write(dst + (r0 + o) * ld + c, acc[o])
    counts = sm.writes[dst:dst + rows0 * ld].reshape(rows0, ld)
    assert (counts[r_lo:r_end, c_lo:c_end] == 1).all()
    assert counts.max() <= 1 and sm.writes.sum() == counts.sum()


def _tol(x, w, t):
    """f32 sums in another order than the emulation's float64: t steps of
    2^-20 of the largest partial sum, Σ|w|^s max|x| at step s."""
    sw = float(np.abs(w).sum())
    return t * 2.0**-20 * max(1.0, sw) ** t * float(np.abs(x).max())


@functools.lru_cache(maxsize=None)
def _jax(shape, kind, r, t, boundary, seed):
    x = _grid(shape, seed)
    w = _weights(kind, len(shape), r)
    return np.asarray(j_direct(jnp.asarray(x), w, t, interpret=True,
                               boundary=boundary))


def _grid(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _weights(kind, ndim, r):
    return np.asarray(make_weights(JSpec(kind, ndim, r), seed=r), np.float32)


def _run(shape, kind, r, t, boundary, tile=16, batch=1, seed=0, **kw):
    x = _grid(shape, seed)
    w = _weights(kind, 2, r)
    geom = common.launch_geom(shape, t * r, tile, tile)
    modes = resolve_boundary(boundary, 2)
    y = emulate_tapsum2d(np.stack([x] * batch).astype(np.float64), w, t,
                         geom, modes, **kw)
    return x, w, y


# ---------------------------------------------------------------------------
# The emulation against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("kind", ["box", "star"])
def test_emulation_matches_jax_periodic(kind, r, t):
    # 40 x 52 on 16 x 16 tiles: 12 CTAs, the last column of tiles ragged
    shape = (40, 52)
    x, w, y = _run(shape, kind, r, t, None)
    assert np.isfinite(y).all()
    ref = _jax(shape, kind, r, t, None, 0)
    np.testing.assert_allclose(y[0], ref, rtol=0, atol=_tol(x, w, t))


BOUNDARIES = ["zero", "reflect", "replicate", ("reflect", "periodic"),
              ("periodic", "zero"), ("zero", "replicate")]


@pytest.mark.parametrize("boundary", [None] + BOUNDARIES)
@pytest.mark.parametrize("r,t", [(1, 1), (1, 4), (3, 1), (3, 4), (2, 2)])
def test_emulation_matches_jax_on_a_ragged_grid(r, t, boundary):
    # 37 x 45: ragged on both axes, and 45 % 4 = 1, so every row but the
    # first starts off its granule: the staging copies cell by cell
    # there and in the granules that wrap the row's end
    shape = (37, 45)
    stats = {"granule": 0, "element": 0}
    x, w, y = _run(shape, "box", r, t, boundary, stats=stats)
    assert np.isfinite(y).all()
    assert stats["granule"] > 0 and stats["element"] > 0
    ref = _jax(shape, "box", r, t, boundary, 0)
    np.testing.assert_allclose(y[0], ref, rtol=0, atol=_tol(x, w, t))


@pytest.mark.parametrize("boundary", [None, "zero", ("reflect", "periodic")])
def test_emulation_on_the_plan_tile_matches_jax(boundary):
    # the plan's own tile at h = 4 on a 70 x 132 grid (64 x 64 tiles, the
    # lead 0), with the Star taps the kernel skips; every copy a granule
    shape, r, t = (70, 132), 1, 4
    x = _grid(shape, 3)
    w = _weights("star", 2, r)
    geom = common.launch_geom(shape, t * r)
    assert (geom.strip_m, geom.w_tile) == (64, 64)
    stats = {"granule": 0, "element": 0}
    y = emulate_tapsum2d(x[None].astype(np.float64), w, t, geom,
                         resolve_boundary(boundary, 2), stats=stats)
    assert stats["element"] == 0
    ref = _jax(shape, "star", r, t, boundary, 3)
    np.testing.assert_allclose(y[0], ref, rtol=0, atol=_tol(x, w, t))


@pytest.mark.parametrize("n,boundary,r,t", [(67, None, 1, 4), (67, "reflect", 3, 4),
                                            (1000, "zero", 1, 1), (1000, None, 3, 1),
                                            (101, "replicate", 2, 2)])
def test_emulation_on_the_lifted_view_matches_jax_1d(n, boundary, r, t):
    # the (1, N) view with the 1D kernel as the middle row: every region
    # row wraps to row 0, its row axis periodic, its columns in the line's
    # mode, on the lift's own tile
    x = _grid((n,), 5)
    w1 = _weights("box", 1, r)
    geom = common.launch_geom((n,), t * r)
    modes = ("periodic",) + resolve_boundary(boundary, 1)
    y = emulate_tapsum2d(x.reshape(1, 1, n).astype(np.float64),
                         common.lift_weights(w1), t, geom, modes)
    ref = np.asarray(j_direct(jnp.asarray(x), w1, t, interpret=True,
                              boundary=boundary))
    np.testing.assert_allclose(y.reshape(n), ref, rtol=0, atol=_tol(x, w1, t))


@pytest.mark.parametrize("shape,boundary", [((5, 52), None), ((5, 52), "zero"),
                                            ((5, 52), "replicate"),
                                            ((40, 6), ("zero", "periodic")),
                                            ((3, 7), None), ((3, 7), "zero")])
def test_emulation_on_axes_shallower_than_the_halo(shape, boundary):
    # h = 8 on axes of 5, 6 and 3 cells, which JAX refuses ("halo exceeds
    # strip height") and the port runs: held to the plain version
    r, t = 2, 4
    x, w, y = _run(shape, "box", r, t, boundary, batch=2)
    want = t_direct.stencil_direct_plain(torch.from_numpy(x), w, t,
                                         boundary).double().numpy()
    for row in y:
        np.testing.assert_allclose(row, want, rtol=0, atol=_tol(x, w, t))


@pytest.mark.parametrize("boundary", [None, "zero", "reflect"])
@pytest.mark.parametrize("r,t", [(1, 4), (2, 2), (3, 1)])
def test_emulation_of_a_bf16_grid_matches_the_plain_version(r, t, boundary):
    # bfloat16 grids widen at staging (8 bytes, 4 cells, a granule), the
    # sums run in f32 and round once: one bf16 ulp of the output apart
    shape = (37, 48)
    xb = torch.from_numpy(_grid(shape, 7)).to(torch.bfloat16)
    w = _weights("box", 2, r)
    geom = common.launch_geom(shape, t * r, 16, 16)
    stats = {"granule": 0, "element": 0}
    y = emulate_tapsum2d(xb.float().numpy()[None].astype(np.float64), w, t,
                         geom, resolve_boundary(boundary, 2), in_bytes=2,
                         stats=stats)
    assert stats["element"] == 0
    got = torch.from_numpy(y[0]).float().to(torch.bfloat16).float()
    want = t_direct.stencil_direct_plain(xb, w, t, boundary).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2.0**-7 * float(want.abs().max()))


@pytest.mark.parametrize("staging,shape,boundary", [
    ("wholestrip", (37, 45), "zero"), ("wholestrip", (40, 52), None),
    ("wholestrip", (37, 45), ("reflect", "periodic")), ("9tile", (64, 64), None)])
@pytest.mark.parametrize("r,t", [(1, 4), (3, 1)])
def test_foil_stagings_equal_the_region_staging(staging, shape, boundary, r, t):
    # the foils' load_window writes the region's cells alone: the lead
    # cells and the row tails stay NaN, and the outputs are the region
    # staging's bit for bit, so no cell outside the region feeds one
    _, _, y = _run(shape, "star", r, t, boundary)
    _, _, yf = _run(shape, "star", r, t, boundary, staging=staging)
    assert np.isfinite(yf).all()
    np.testing.assert_array_equal(yf, y)


def test_batch_grids_start_on_other_granules():
    # three 37 x 45 grids: grid b starts b * 1665 cells into the batch, so
    # the granule rows differ per grid; every grid equals the first
    _, _, y = _run((37, 45), "box", 1, 4, "zero", batch=3)
    for b in (1, 2):
        np.testing.assert_array_equal(y[b], y[0])


@pytest.mark.parametrize("G,nb", [(1, 1), (7, 3), (18, 9), (18, 14), (35, 17),
                                  (256, 2), (300, 3)])
def test_work_map_takes_every_patch_once(G, nb):
    patches = work_map(G, nb)
    assert sorted(patches) == [(g, b) for g in range(G) for b in range(nb)]


# ---------------------------------------------------------------------------
# The shared-memory layout
# ---------------------------------------------------------------------------
TILES = (16, 32, 64)


@pytest.mark.parametrize("halo", list(range(1, 13)) + [16, 24])
def test_direct_layout_fits_under_the_tile_rule_bound(halo):
    # every 2D tile the rule can pick at this halo: the new layout, front
    # pad and margins included, stays under tile_smem_bound where that
    # fits the budget, so the rule need not move
    for tm in TILES:
        for tn in TILES:
            bound = common.tile_smem_bound(tm, tn, halo)
            lay = common.direct_layout(tm, tn, halo)
            assert lay.smem_bytes <= bound
            if bound <= common.SMEM_BUDGET_BYTES:
                assert lay.smem_bytes <= common.SMEM_BUDGET_BYTES
            assert lay.rows == tm + 2 * halo and lay.lead == -halo % 4
            assert lay.ld % 4 == 0 and lay.lead + tn + 2 * halo <= lay.ld
            assert lay.ld < lay.lead + tn + 2 * halo + 4
            assert (lay.lead + halo) % 4 == 0          # the tile on a granule
            assert lay.smem_bytes == \
                (2 * lay.rows * lay.ld + 3 * common.DIRECT_MARGIN) * 4


@pytest.mark.parametrize("halo", [1, 2, 4, 8, 12])
def test_direct_layout_fits_the_9tile_foil(halo):
    lay = common.direct_layout(128, 128, halo)
    assert lay.smem_bytes <= common.SMEM_BUDGET_BYTES


def test_direct_layout_at_the_main_tile():
    # 64 x 64 at h = 4: lead 0, rows of 72 cells, 41,520 bytes -- 48 more
    # than the two bare regions of the kernel before the redesign
    lay = common.direct_layout(64, 64, 4)
    assert (lay.rows, lay.ld, lay.lead) == (72, 72, 0)
    assert lay.smem_bytes == 2 * 72 * 72 * 4 + 12 * 4 == 41520
    # at h = 1 (the direct regime) three cells lead the region
    lay1 = common.direct_layout(64, 64, 1)
    assert (lay1.lead, lay1.ld) == (3, 72)
    # five CTAs share an SM (228 KB, 1 KB each reserved)
    assert 5 * (lay.smem_bytes + 1024) <= 228 * 1024


def test_direct_layout_raises_past_the_budget():
    # past the 227 KB budget the layout takes the workspace form (the tile
    # rule's fourth rung), which launches on a card only; a foil, which has
    # no workspace form, still raises
    wide = common.SubstrateGeom(dim=2, strip_m=128, h_block=8, w_tile=256,
                                w_block=8)
    lay = t_direct.direct2d_layout(wide, 8)
    assert isinstance(lay, common.WorkspaceLayout)
    assert lay.base == common.direct_layout(128, 256, 8)
    assert lay.base.smem_bytes > common.SMEM_BUDGET_BYTES
    x = torch.zeros((1, 300, 300))
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        t_direct._launch2d(x, np.ones((3, 3), np.float32), 8, 1, wide, (0, 0))
    with pytest.raises(ValueError, match="227 KB"):
        t_direct._launch2d(x, np.ones((3, 3), np.float32), 8, 1, wide, (0, 0),
                           "wholestrip")


# ---------------------------------------------------------------------------
# The source and the C launch arguments
# ---------------------------------------------------------------------------
def test_source_constants_match_the_host():
    assert _define("DIRECT_MARGIN") == common.DIRECT_MARGIN
    assert _define("MAX_TAPS") == t_direct.MAX_TAPS
    assert V in (4, 5, 6, 8)
    # the main build's and the foil build's CTAs per SM
    blocks = [int(n) for n in re.findall(r"#define DIRECT_MIN_BLOCKS (\d+)\b", SRC)]
    assert len(blocks) == 2 and all(2 <= n <= 5 for n in blocks)
    assert ("__launch_bounds__(CTA_THREADS, R <= 3 ? DIRECT_MIN_BLOCKS : "
            "DIRECT_MIN_BLOCKS_WIDE)") in SRC
    assert 1 <= _define("DIRECT_MIN_BLOCKS_WIDE") <= min(blocks)
    assert _define("MAX_RADIUS") == t_direct.MAX_RADIUS == 7
    # radii 1..3 keep their 49-slot argument, radii 4..7 take (2r+1)^2
    assert "const __grid_constant__ KernelTaps<tap_slots(R, 2)> taps" in SRC
    assert "kernel_taps<R, 2>(taps->w)" in SRC
    # the staging is the tap-sums' shared header's, on line_stage.cuh's copy
    stage = (CSRC / "tap_stage.cuh").read_text()
    assert '#include "tap_stage.cuh"' in SRC
    assert '#include "line_stage.cuh"' in stage and "cp_async16(" in stage
    assert 'extern "C" int stencil_direct_ctas_per_sm(int dtype, int fill, int smem_bytes)' \
        in SRC
    # the Taps struct: the dense taps the FMAs read
    body = re.search(r"struct Taps \{(.*?)\};", SRC, re.S).group(1)
    assert re.findall(r"float (\w+)\[MAX_TAPS\];", body) == \
        [f for f, _ in t_direct._Taps._fields_] == ["w"]
    # the new staging is the tap-sums' own (the 3D tap-sum stages each
    # plane with it); the tile fold's 2D loads and the 3D banded kernels
    # keep common.cuh's load_rect (both return the cells a thread copied:
    # the counting build's count, 0 in every other)
    assert "int stage_region(" in stage and "stage_region(" in SRC
    assert "load_rect(" not in SRC + stage
    assert "int load_rect(" in (CSRC / "common.cuh").read_text()


def _c_params(entry: str) -> list:
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', SRC, re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


class _FakeLaunch:
    def __init__(self):
        self.argtypes = self.restype = self.args = None
        self.calls = 0

    def __call__(self, *args):
        self.args = args
        self.calls += 1
        return 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its card
    path on the CPU (the launches are faked)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def fake_card(monkeypatch):
    """The C entries faked, the CUDA context calls made inert, the launch
    counts from 0."""
    fake = _FakeLaunch()
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    t_direct._launcher.cache_clear()
    t_direct._foil_launcher.cache_clear()
    tk.reset_launch_counts()
    yield fake
    t_direct._launcher.cache_clear()
    t_direct._foil_launcher.cache_clear()
    tk.reset_launch_counts()


@pytest.mark.parametrize("staging", ["region", "wholestrip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,t,batch", [(1, 4, 1), (1, 1, 3), (3, 2, 2)])
def test_wrapper_passes_the_layout(fake_card, staging, dtype, r, t, batch):
    w = np.asarray(make_weights(JSpec("star", 2, r), seed=0), np.float32)
    x = torch.zeros((batch, 100, 130), dtype=dtype)
    geom = common.launch_geom((100, 130), t * r)
    y = t_direct._launch2d(x, w, t, r, geom, (0, 1), staging)
    counter = "stencil_direct" + ("" if staging == "region" else f" ({staging})")
    assert {k: v for k, v in tk.launch_counts().items() if v} == {counter: 1}
    assert y.shape == x.shape and y.dtype == dtype
    entry = "stencil_direct" + ("_launch" if staging == "region" else "_foil_launch")
    params = _c_params(entry)
    fake = fake_card
    assert len(fake.args) == len(params) == len(fake.argtypes)
    args = dict(zip(params, fake.args))
    lay = common.direct_layout(geom.strip_m, geom.w_tile, t * r)
    assert (args["H"], args["W"], args["TM"], args["TN"], args["t"], args["r"]) == \
        (100, 130, geom.strip_m, geom.w_tile, t, r)
    assert (args["ld"], args["smem_bytes"]) == (lay.ld, lay.smem_bytes)
    assert (args["mode_y"], args["mode_x"], args["B"], args["grid_elems"]) == \
        (0, 1, batch, 100 * 130)
    assert args["dtype"] == (1 if dtype == torch.bfloat16 else 0)
    if staging != "region":
        assert args["stage"] == common.STAGE_CODES[staging]
    taps = args["taps"]._obj
    assert list(taps.w)[:w.size] == w.ravel().tolist()
    assert list(taps.w)[w.size:] == [0.0] * (t_direct.MAX_TAPS - w.size)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("boundary", [None, "zero"])
def test_2d_calls_on_the_card_launch_the_kernel(fake_card, batched, boundary):
    # stencil_direct, the plan entry stencil_direct_at and its foil
    # staging launch the 2D kernel once per call, batch or not, with the
    # layout's arguments: no other route
    w = np.asarray(make_weights(JSpec("box", 2, 1), seed=0), np.float32)
    shape = (3, 96, 100) if batched else (96, 100)
    x = torch.zeros(shape).as_subclass(_OnCard)
    geom = common.launch_geom((96, 100), 4)
    lay = common.direct_layout(geom.strip_m, geom.w_tile, 4)
    calls = [("stencil_direct", lambda: t_direct.stencil_direct_at(
                 x, w, 4, geom, boundary, "region", batched)),
             ("stencil_direct (wholestrip)", lambda: t_direct.stencil_direct_at(
                 x, w, 4, geom, boundary, "wholestrip", batched))]
    if not batched:
        calls.append(("stencil_direct", lambda: t_direct.stencil_direct(
            x, w, 4, boundary=boundary)))
    want = {}
    for counter, call in calls:
        y = call()
        assert tuple(y.shape) == shape
        want[counter] = want.get(counter, 0) + 1
        assert {n: v for n, v in tk.launch_counts().items() if v} == want
        entry = "stencil_direct_launch" if counter == "stencil_direct" \
            else "stencil_direct_foil_launch"
        args = dict(zip(_c_params(entry), fake_card.args))
        assert (args["ld"], args["smem_bytes"], args["t"]) == (lay.ld, lay.smem_bytes, 4)
        assert args["B"] == (3 if batched else 1)
        assert args["mode_x"] == (0 if boundary is None else 1)
