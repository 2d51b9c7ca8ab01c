"""The 3D tap-sum (``csrc/stencil_direct3d.cu``: K5 with its fill, whole-slab
foil and batch forms) on the CPU: a numpy emulation of the kernel built on
its layout (``common.direct3d_layout``) and its schedule alone -- the
region streamed plane by plane through per-step rings, each plane staged
in 16-byte granules (cell by cell where a granule cannot serve) or, for
the foil, from the three whole y tiles of the plane; NaN in every slot
cell nothing wrote and in every staged cell outside the domain of a
non-periodic axis; every shared access checked against the dynamic
shared memory and against the slots in flight or being written in the
same barrier interval; the steps' patches in fixed cell coordinates; the
y/x fill of each plane entering a ring and the z map on the ring lookup
-- against the JAX package's 3D ``stencil_direct`` in interpret mode, and
the port's plain version where JAX refuses the grid (an axis shallower
than the halo) or the grid is bfloat16; then the ring layout against
the tile rule, the source's constants, and the C launch arguments the
wrapper passes.  The kernel itself builds and runs only on the card
(``chip_smoke.py``, ``fold_probe.py tapsum3d``)."""
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
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")

CSRC = pathlib.Path(common.__file__).parent / "csrc"
SRC = (CSRC / "stencil_direct3d.cu").read_text()


def _define(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)\b", SRC).group(1))


THREADS = int(re.search(r"#define CTA_THREADS (\d+)\b",
                        (CSRC / "common.cuh").read_text()).group(1))
AHEAD, MARGIN = common.DIRECT3D_AHEAD, common.DIRECT3D_MARGIN
#: The kernel's patch rows (V).
V = _define("DIRECT3D_ROWS")
#: axis_source's codes (the source's AXIS_ZERO and AXIS_DEEP).
ZERO, DEEP = -2**31, -2**31 + 1


# ---------------------------------------------------------------------------
# The kernel, emulated on its layout and schedule
# ---------------------------------------------------------------------------
class _Smem:
    """A CTA's dynamic shared memory in floats: NaN until written, every
    read and write checked against both ends."""

    def __init__(self, nbytes):
        assert nbytes % 4 == 0
        self.a = np.full(nbytes // 4, np.nan)

    def take(self, idx):
        assert idx.min() >= 0 and idx.max() < len(self.a), (idx.min(), idx.max())
        return self.a[idx]

    def put(self, idx, vals):
        assert idx.min() >= 0 and idx.max() < len(self.a), (idx.min(), idx.max())
        self.a[idx] = vals


def axis_source(g, n, o, mode):
    """stencil_direct3d.cu::axis_source on an array of global cells: the
    in-domain cell each copies, ZERO under ``zero`` out of the domain, DEEP
    deeper than o above it."""
    g = np.asarray(g, dtype=np.int64)
    if mode == "periodic":
        return g
    if mode == "zero":
        src = np.full(g.shape, ZERO)
    elif mode == "replicate":
        src = np.where(g < 0, 0, n - 1)
    else:
        src = np.where(g < 0, -g, 2 * (n - 1) - g)
    out = np.where((g < 0) | (g >= n), src, g)
    return np.where(g >= n + o, DEEP, out)


def thread_items(counts):
    """The (thread, step, item) triples of one interval, in the kernel's
    order: the steps' items in one list, thread k taking entries k, k +
    THREADS, ...; each is located by walking the steps' counts."""
    out = []
    for k in range(THREADS):
        for f in range(k, sum(counts), THREADS):
            s, i = 0, f
            while i >= counts[s]:
                i, s = i - counts[s], s + 1
            out.append((k, s, i))
    return out


def _leaves(mode, g0, n, big_n):
    return mode != "periodic" and (g0 < 0 or g0 + n > big_n)


def emulate_tapsum3d(x, w, t, geom, modes, staging="region", stats=None):
    """The 3D tap-sum on the CPU, CTA by CTA of the (B, Z, H, W) grids ``x``
    (float64 values; a bfloat16 grid's values widened), on the rings of
    ``direct3d_layout``, interval by interval as the kernel runs them.
    Writes of an interval land at its end (its barrier), so a read of what
    the same interval writes, or of a slot whose staging is in flight,
    fails.  ``stats`` counts granule and element copies and the foil's
    loaded cells, and with an "fma" key the FMAs the kernel's patches
    issue: V-row patches over each live plane's window, one per tap whose
    input plane is read, and cell."""
    b_, Z, H, W = x.shape
    r = (w.shape[0] - 1) // 2
    h = t * r
    tz, tm, tn = geom.z_slab, geom.strip_m, geom.w_tile
    lay = common.direct3d_layout(tm, tn, r, t)
    planes0, rows0, cols0 = tz + 2 * h, tm + 2 * h, tn + 2 * h
    ld, lead, pld = lay.ld, lay.lead, lay.plane_ld
    assert (lay.rows, lay.lead) == (rows0, -h % 4) and ld % 4 == 0
    assert (lay.ring0, lay.ring) == (2 * r + 1 + AHEAD, 2 * r + 2)
    assert lay.slots == lay.ring0 + (t - 1) * lay.ring
    assert lay.smem_bytes == (MARGIN + lay.slots * pld) * 4
    assert pld == rows0 * ld + MARGIN
    taps = [(dz, dy, dx, float(w[dz, dy, dx])) for dz, dy, dx in np.ndindex(*w.shape)
            if w[dz, dy, dx] != 0.0]
    zmap = modes[0] != "periodic"
    ctas = int(np.prod(common.launch_grid((Z, H, W), geom)))
    y = np.full(x.shape, np.nan)

    def slot(s, q):
        assert q >= 0
        i = q % lay.ring0 if s == 0 else lay.ring0 + (s - 1) * lay.ring + q % lay.ring
        assert 0 <= i < lay.slots
        return MARGIN + i * pld

    for b in range(b_):
        for k0 in range(0, Z, tz):
            for i0 in range(0, H, tm):
                for j0 in range(0, W, tn):
                    _cta(x[b], y[b], b * Z * H * W, taps, r, t, k0, i0, j0, tz, tm, tn,
                         planes0, rows0, cols0, ld, lead, lay, slot, zmap, modes,
                         staging, stats, ctas, geom)
    return y


def _cta(xg, yg, base, taps, r, t, k0, i0, j0, tz, tm, tn, planes0, rows0, cols0, ld,
         lead, lay, slot, zmap, modes, staging, stats, ctas, geom):
    Z, H, W = xg.shape
    h = t * r
    z0 = k0 - h
    sm = _Smem(lay.smem_bytes)
    landing = {}                # slot -> (interval issued, interval it lands by)
    loaded = [0]
    fill_yx = (_leaves(modes[1], i0 - h, rows0, H)
               or _leaves(modes[2], j0 - h, cols0, W))

    def cell(zg, rows, cols):
        """Grid cells of plane zg (global, unwrapped) at global rows x cols,
        modulo the grid; NaN out of the domain of a non-periodic axis."""
        v = xg[zg % Z][np.ix_(rows % H, cols % W)].astype(np.float64)
        out = (modes[0] != "periodic" and not 0 <= zg < Z)
        bad = np.zeros(v.shape, bool) | out
        if modes[1] != "periodic":
            bad |= ((rows < 0) | (rows >= H))[:, None]
        if modes[2] != "periodic":
            bad |= ((cols < 0) | (cols >= W))[None, :]
        return np.where(bad, np.nan, v)

    def stage(q, k_issue):
        if q >= planes0:
            return
        s0 = slot(0, q)
        landing[s0] = (k_issue, k_issue + AHEAD)
        zg = z0 + q
        if staging == "region":
            # granule k of row qq: cells [4k, 4k + 4) from global column cb +
            # 4k, one 16-byte copy where the source is on 16 bytes and does
            # not wrap the row, else cell by cell modulo W: the same values
            cb = j0 - h - lead
            rows = i0 - h + np.arange(rows0)
            gc = (cb + 4 * np.arange(ld // 4)) % W
            src = base + (((zg % Z) * H + rows % H) * W)[:, None] + gc[None, :]
            granule = (gc + 4 <= W)[None, :] & (src % 4 == 0)
            if stats is not None:
                stats["granule"] += int(granule.sum())
                stats["element"] += int((~granule).sum())
            sm.put(s0 + np.arange(rows0)[:, None] * ld + np.arange(ld)[None, :],
                   cell(zg, rows, cb + np.arange(ld)))
        else:                   # the foil: the three whole y tiles of the plane
            rows = np.arange(rows0)
            sm.put(s0 + rows[:, None] * ld + lead + np.arange(cols0)[None, :],
                   cell(zg, i0 - h + rows, j0 - h + np.arange(cols0)))
            loaded[0] += 3 * tm * cols0

    if staging != "region":     # the foil's planes outside the region, to the sink
        loaded[0] += sum(3 * tm * cols0 for p in range(-tz, 2 * tz)
                         if not -h <= p < tz + h)
    for a in range(AHEAD):
        stage(a, a - AHEAD)

    def ranges(s, d):
        glo, ghi = k0 - d, min(k0 + tz, Z) + d
        if zmap:
            glo, ghi = max(glo, 0), min(ghi, Z)
        return glo - z0, ghi - z0

    for k in range(planes0 + t - 1):
        if fill_yx:
            for s in range(t):
                q = k - s * (r + 1)
                d = (t - s) * r
                live = q < planes0 if s == 0 else ranges(s, d)[0] <= q < ranges(s, d)[1]
                if live:
                    _fill_plane(sm, slot(s, q), ld, s * r, rows0 - 2 * s * r, lead + s * r,
                                cols0 - 2 * s * r, i0 - h + s * r, j0 - h + s * r, H, W,
                                d, modes[1], modes[2])
        stage(k + AHEAD, k)
        reads, writes = set(), []
        for s in range(t):
            q = k - (s + 1) * r - s
            lo, hi = ranges(s, (t - 1 - s) * r)
            if not lo <= q < hi:
                continue
            po = []
            for dz in range(2 * r + 1):
                qi = q - r + dz
                if zmap:
                    g = int(axis_source(z0 + qi, Z, (t - s) * r, modes[0]))
                    assert g != DEEP
                    qi = -1 if g == ZERO else g - z0
                    assert g == ZERO or q - r <= qi <= q + r   # in the ring
                po.append(None if qi < 0 else slot(s, qi))
            reads |= {p for p in po if p is not None}
            r_lo, r_end = (s + 1) * r, rows0 - (s + 1) * r
            c_lo, c_end = lead + r_lo, lead + cols0 - (s + 1) * r
            g_lo = c_lo >> 2
            gn = ((c_end + 3) >> 2) - g_lo
            rows = np.arange(r_lo, r_end)[:, None]
            cols = np.arange(4 * g_lo, 4 * (g_lo + gn))[None, :]
            acc = np.zeros((rows.size, cols.size))
            if stats is not None and "fma" in stats:
                stats["fma"] += (-(-rows.size // V) * V * cols.size
                                 * sum(po[dz] is not None for dz, *_ in taps))
            for dz, dy, dx, wv in taps:
                if po[dz] is None:
                    continue
                idx = po[dz] + (rows - r + dy) * ld + (cols - r + dx)
                assert idx.min() >= po[dz] - MARGIN
                assert idx.max() < po[dz] + rows0 * ld + MARGIN
                acc = acc + wv * sm.take(idx)
            if s < t - 1:
                out = slot(s + 1, q)
                idx = out + rows * ld + cols
                assert idx.min() >= out and idx.max() < out + rows0 * ld
                writes.append((out, idx, acc))
            else:
                assert 0 <= z0 + q < Z and (g_lo * 4, gn * 4) == (lead + h, tn)
                n_r, n_c = min(tm, H - i0), min(tn, W - j0)
                yg[z0 + q, i0:i0 + n_r, j0:j0 + n_c] = acc[:n_r, :n_c]
        for s0 in reads:
            issued, lands = landing.get(s0, (None, None))
            assert issued is None or not issued <= k < lands, "read of a slot in flight"
        for out, idx, acc in writes:
            assert out not in reads, "a step writes a slot read in the same interval"
            sm.put(idx, acc)
    if staging != "region":
        want = common.staged_read_bytes((Z, H, W), geom, "wholestrip", 1) // ctas
        assert loaded[0] == want
        if stats is not None:
            stats["foil"] += loaded[0]


def _fill_plane(sm, base, ld, r_lo, nr, c_lo, nc, gy0, gx0, H, W, o, my, mx):
    """stencil_direct3d.cu::fill_plane: every window cell out of the domain
    in y or x and not deeper than o on either takes the in-domain cell of
    its two maps (0 under ``zero``); the cells it reads are in the domain
    on both axes, so none of them is written."""
    if not (_leaves(my, gy0, nr, H) or _leaves(mx, gx0, nc, W)):
        return
    gi, gj = gy0 + np.arange(nr), gx0 + np.arange(nc)
    si, sj = axis_source(gi, H, o, my), axis_source(gj, W, o, mx)
    same_i, same_j = si == gi, sj == gj
    deep = (si == DEEP)[:, None] | (sj == DEEP)[None, :]
    zero = (si == ZERO)[:, None] | (sj == ZERO)[None, :]
    write = ~(same_i[:, None] & same_j[None, :]) & ~deep
    dst = base + (r_lo + np.arange(nr))[:, None] * ld + c_lo + np.arange(nc)[None, :]
    copy = write & ~zero
    if copy.any():
        ii, jj = np.nonzero(copy)
        a, b = si[ii] - gy0, sj[jj] - gx0          # the source's window cell
        assert (0 <= a).all() and (a < nr).all() and (0 <= b).all() and (b < nc).all()
        assert same_i[a].all() and same_j[b].all()
        vals = sm.take(base + (r_lo + a) * ld + c_lo + b)
    if (write & zero).any():
        sm.put(dst[write & zero], 0.0)
    if copy.any():
        sm.put(dst[copy], vals)


def _tol(x, w, t):
    """f32 sums in another order than the emulation's float64: t steps of
    2^-20 of the largest partial sum, Σ|w|^s max|x| at step s."""
    sw = float(np.abs(w).sum())
    return t * 2.0**-20 * max(1.0, sw) ** t * float(np.abs(x).max())


def _grid(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _weights(kind, r):
    return np.asarray(make_weights(JSpec(kind, 3, r), seed=r), np.float32)


@functools.lru_cache(maxsize=None)
def _jax(shape, kind, r, t, boundary, seed):
    return np.asarray(j_direct(jnp.asarray(_grid(shape, seed)), _weights(kind, r), t,
                               interpret=True, boundary=boundary))


def _run(shape, kind, r, t, boundary, tile=16, z_slab=4, batch=1, seed=0, **kw):
    x = _grid(shape, seed)
    w = _weights(kind, r)
    geom = common.launch_geom(shape, t * r, tile, tile, z_slab)
    modes = resolve_boundary(boundary, 3)
    y = emulate_tapsum3d(np.stack([x] * batch).astype(np.float64), w, t, geom,
                         modes, **kw)
    return x, w, y


# ---------------------------------------------------------------------------
# The emulation against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,r,t", [("box", 1, 1), ("box", 1, 4), ("star", 1, 4),
                                      ("box", 2, 2), ("star", 3, 1), ("box", 2, 1)])
def test_emulation_matches_jax_periodic(kind, r, t):
    # 12 x 20 x 24 on 4 x 16 x 16 tiles: 12 CTAs, ragged in y and x; 24 %
    # 4 = 0, so every copy is a granule
    shape = (12, 20, 24)
    stats = {"granule": 0, "element": 0}
    x, w, y = _run(shape, kind, r, t, None, stats=stats)
    assert np.isfinite(y).all() and stats["element"] == 0
    np.testing.assert_allclose(y[0], _jax(shape, kind, r, t, None, 0), rtol=0,
                               atol=_tol(x, w, t))


Z_ONLY = [(m, "periodic", "periodic") for m in ("zero", "reflect", "replicate")]
ALL_AXES = ["zero", "reflect", "replicate"]


@pytest.mark.parametrize("boundary", Z_ONLY + ALL_AXES
                         + [("replicate", "reflect", "periodic")])
@pytest.mark.parametrize("r,t", [(1, 1), (1, 4), (2, 2), (3, 1)])
def test_emulation_matches_jax_under_boundaries(r, t, boundary):
    # 13 x 20 x 25: ragged on every axis (the last z tile one plane deep),
    # and 25 % 4 = 1, so most rows start off their granule and copy cell
    # by cell
    shape = (13, 20, 25)
    stats = {"granule": 0, "element": 0}
    x, w, y = _run(shape, "box", r, t, boundary, stats=stats)
    assert np.isfinite(y).all()
    assert stats["granule"] > 0 and stats["element"] > 0
    np.testing.assert_allclose(y[0], _jax(shape, "box", r, t, boundary, 0), rtol=0,
                               atol=_tol(x, w, t))


@pytest.mark.parametrize("shape,boundary", [((60, 70, 130), None),
                                            ((60, 70, 130), "zero"),
                                            ((40, 72, 100), ("replicate", "reflect",
                                                             "periodic"))])
def test_emulation_on_the_plan_tile_matches_jax(shape, boundary):
    # the plan's own tile at h = 4 on chip_smoke.py's ragged grids (16 x 16
    # x 32, the lead 0), Star-3D1R at t = 4, whose zero taps the kernel skips
    r, t = 1, 4
    x = _grid(shape, 3)
    w = _weights("star", r)
    geom = common.launch_geom(shape, t * r)
    assert (geom.z_slab, geom.strip_m, geom.w_tile) == (16, 16, 32)
    y = emulate_tapsum3d(x[None].astype(np.float64), w, t, geom,
                         resolve_boundary(boundary, 3))
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y[0], _jax(shape, "star", r, t, boundary, 3), rtol=0,
                               atol=_tol(x, w, t))


@pytest.mark.parametrize("boundary", [None, "reflect", ("replicate", "reflect", "periodic"),
                                      ("zero", "periodic", "replicate")])
def test_emulation_on_an_8_deep_tile_at_h8_matches_jax(boundary):
    # Box-3D2R at t = 4: h = 8 fits an 8-deep tile, shallower than its
    # halo; the low-z reflect mirrors planes the stream brings later
    shape, r, t = (20, 24, 28), 2, 4
    x, w, y = _run(shape, "box", r, t, boundary, z_slab=8)
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y[0], _jax(shape, "box", r, t, boundary, 0), rtol=0,
                               atol=_tol(x, w, t))


# ---------------------------------------------------------------------------
# The emulation against the plain version, where JAX refuses
# ---------------------------------------------------------------------------
def _plain(x, w, t, boundary):
    return t_direct.stencil_direct_plain(torch.from_numpy(x), w, t,
                                         boundary).double().numpy()


@pytest.mark.parametrize("shape,boundary", [((3, 20, 24), None), ((3, 20, 24), "zero"),
                                            ((12, 5, 24), ("periodic", "replicate", "zero")),
                                            ((12, 20, 6), ("zero", "periodic", "periodic")),
                                            ((3, 7, 5), None)])
def test_emulation_on_axes_shallower_than_the_halo(shape, boundary):
    # h = 8 on axes of 3, 5, 6 and 7 cells, which JAX refuses ("halo exceeds
    # strip height") and the port runs
    r, t = 2, 4
    x, w, y = _run(shape, "box", r, t, boundary, batch=2, z_slab=8)
    want = _plain(x, w, t, boundary)
    for g in y:
        np.testing.assert_allclose(g, want, rtol=0, atol=_tol(x, w, t))


@pytest.mark.parametrize("boundary", [None, "reflect"])
@pytest.mark.parametrize("z_slab", [4, 8])
def test_emulation_on_a_slab_that_does_not_divide_z(z_slab, boundary):
    # 10 planes on 4- and 8-deep tiles: the last z tile is ragged
    shape, r, t = (10, 20, 24), 1, 4
    x, w, y = _run(shape, "box", r, t, boundary, z_slab=z_slab)
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y[0], _plain(x, w, t, boundary), rtol=0,
                               atol=_tol(x, w, t))


@pytest.mark.parametrize("boundary", [None, "zero", "reflect"])
@pytest.mark.parametrize("r,t", [(1, 4), (2, 2), (3, 1)])
def test_emulation_of_a_bf16_grid_matches_the_plain_version(r, t, boundary):
    # bfloat16 grids widen at staging (8 bytes, 4 cells, a granule), the
    # sums run in f32 and round once: one bf16 ulp of the output apart
    shape = (9, 20, 24)
    xb = torch.from_numpy(_grid(shape, 7)).to(torch.bfloat16)
    w = _weights("box", r)
    geom = common.launch_geom(shape, t * r, 16, 16, 4)
    y = emulate_tapsum3d(xb.float().numpy()[None].astype(np.float64), w, t, geom,
                         resolve_boundary(boundary, 3))
    got = torch.from_numpy(y[0]).float().to(torch.bfloat16).float()
    want = t_direct.stencil_direct_plain(xb, w, t, boundary).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2.0**-7 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# The foil, the batch and the work distribution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,boundary", [((13, 20, 25), "zero"), ((12, 20, 24), None),
                                            ((13, 20, 25), ("replicate", "reflect",
                                                            "periodic"))])
@pytest.mark.parametrize("r,t", [(1, 4), (3, 1)])
def test_foil_staging_equals_the_region_staging(shape, boundary, r, t):
    # the foil stages each region plane from its three whole y tiles and
    # the slab's other planes into the sink, exactly the analytic count
    # (asserted in the emulation); the region's cells alone reach the
    # rings -- the lead cells and the row tails stay NaN -- and the
    # outputs are the region staging's bit for bit
    _, _, y = _run(shape, "star", r, t, boundary)
    stats = {"granule": 0, "element": 0, "foil": 0}
    _, _, yf = _run(shape, "star", r, t, boundary, staging="wholestrip", stats=stats)
    assert np.isfinite(yf).all() and stats["foil"] > 0
    np.testing.assert_array_equal(yf, y)


def test_batch_grids_start_on_other_granules():
    # three 13 x 20 x 25 grids: grid b starts b * 6500 cells into the
    # batch, and 6500 % 4 = 0 but the rows' granules differ per plane;
    # every grid equals the first
    stats = {"granule": 0, "element": 0}
    _, _, y = _run((13, 20, 25), "box", 1, 4, "zero", batch=3, stats=stats)
    assert stats["element"] > 0
    for b in (1, 2):
        np.testing.assert_array_equal(y[b], y[0])
    # 7 x 9 x 13 grids: 819 cells each, so grid 1 starts off its granule
    x = _grid((7, 9, 13), 1)
    w = _weights("box", 1)
    geom = common.launch_geom((7, 9, 13), 2, 16, 16, 4)
    y = emulate_tapsum3d(np.stack([x] * 2).astype(np.float64), w, 2, geom,
                         resolve_boundary(None, 3))
    np.testing.assert_array_equal(y[1], y[0])


@pytest.mark.parametrize("counts", [(1,), (60, 50, 50, 32), (256, 256), (300, 7, 255),
                                    (0, 0, 5), (120, 110, 100)])
def test_threads_take_every_item_once_and_share_them(counts):
    items = thread_items(counts)
    assert sorted((s, i) for _, s, i in items) == \
        [(s, i) for s, n in enumerate(counts) for i in range(n)]
    # every thread one patch a round: no thread takes more than one more
    # than any other, and a warp's round is one call of the patch
    per = np.bincount([k for k, _, _ in items], minlength=THREADS)
    assert per.max() - per.min() <= 1
    assert per.max() == -(-sum(counts) // THREADS)


def test_axis_source_is_the_fill_rule():
    # common.cuh::fill_axis's sources: below the domain and above it
    # within depth o; deeper cells are left
    g = np.arange(-3, 12)
    assert list(axis_source(g, 8, 3, "reflect")) == \
        [3, 2, 1, 0, 1, 2, 3, 4, 5, 6, 7, 6, 5, 4, DEEP]
    assert list(axis_source(g, 8, 3, "replicate")) == \
        [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 7, 7, 7, DEEP]
    assert list(axis_source(g, 8, 3, "zero")) == \
        [ZERO] * 3 + list(range(8)) + [ZERO] * 3 + [DEEP]
    assert list(axis_source(g, 8, 3, "periodic")) == list(g)


# ---------------------------------------------------------------------------
# The ring layout
# ---------------------------------------------------------------------------
TILES = (16, 32, 48, 64)


def _old_bound(tz, tm, tn, halo):
    """tile_smem_bound before the rings: the tap-sum's two region buffers
    and the banded kernel's reserve."""
    return max([common.direct3d_reserve(tz, tm, tn, halo)]
               + [common.banded3d_layout(tz, tm, tn, halo // t, t, cb).smem_bytes
                  for t in range(1, halo + 1) if halo % t == 0 for cb in (4, 2)])


@pytest.mark.parametrize("halo", list(range(1, 13)) + [16])
def test_direct3d_layout_fits_under_the_tile_rule_bound(halo):
    # every 3D tile the rule can weigh at this halo (edges clamped to a
    # small grid's extent included), every (r, t) with t*r = halo: the
    # rings stay under tile_smem_bound, and the bound fits the budget
    # exactly where the bound before the rings did but at one tile, 1 x 48
    # x 32 at h = 5, where the rings of t = 5 steps of r = 1 need 234,208
    # bytes: the rule must not pick a tile the kernel cannot launch
    budget = common.SMEM_BUDGET_BYTES
    moved = set()
    for tz in range(1, 17):
        for tm in TILES:
            for tn in TILES:
                bound = common.tile_smem_bound(tm, tn, halo, tz)
                if (bound <= budget) != (_old_bound(tz, tm, tn, halo) <= budget):
                    moved.add((tz, tm, tn))
                for t in range(1, halo + 1):
                    if halo % t or halo // t > 3:
                        continue
                    r = halo // t
                    lay = common.direct3d_layout(tm, tn, r, t)
                    assert lay.smem_bytes <= bound
                    if bound <= budget:
                        assert lay.smem_bytes <= budget
                    d2 = common.direct_layout(tm, tn, halo)
                    assert (lay.rows, lay.ld, lay.lead) == (d2.rows, d2.ld, d2.lead)
                    assert (lay.lead + halo) % 4 == 0          # the tile on a granule
                    assert lay.plane_ld == lay.rows * lay.ld + MARGIN
                    assert lay.slots == (2 * r + 1 + AHEAD) + (t - 1) * (2 * r + 2)
                    assert lay.smem_bytes == (MARGIN + lay.slots * lay.plane_ld) * 4
    assert moved == ({(1, 48, 32)} if halo == 5 else set())
    if halo == 5:
        assert common.direct3d_layout(48, 32, 1, 5).smem_bytes == 234208 > budget


def test_tile_rule_choices_unchanged_at_512():
    # the rule's tiles at 512^3, every halo it fits: those of the rule
    # before the rings
    want = {1: (16, 32, 32), 2: (16, 16, 32), 3: (16, 16, 32), 4: (16, 16, 32),
            5: (16, 16, 16), 6: (8, 16, 32), 7: (8, 16, 16), 8: (8, 16, 16),
            9: (2, 16, 16)}
    got = {}
    for halo in want:
        g = common.resolve_tile_geom((512, 512, 512), halo)
        got[halo] = (g.z_slab, g.strip_m, g.w_tile)
    assert got == want


def test_direct3d_layout_at_the_main_tile():
    # 16 x 16 x 32 at r = 1, t = 4: planes of 24 x 40 floats, 5 + 3 x 4
    # slots, 65,568 bytes where the two whole region buffers took 185,696;
    # three CTAs share an SM (228 KB, 1 KB each reserved)
    lay = common.direct3d_layout(16, 32, 1, 4)
    assert (lay.rows, lay.ld, lay.lead, lay.ring0, lay.ring, lay.slots) == \
        (24, 40, 0, 5, 4, 17)
    assert lay.smem_bytes == (4 + 17 * (24 * 40 + 4)) * 4 == 65568
    assert common.direct3d_reserve(16, 16, 32, 4) == 185696
    assert 3 * (lay.smem_bytes + 1024) <= 228 * 1024
    # at h = 1 (the direct regime's tile, 16 x 32 x 32) registers set the
    # CTAs per SM: the rings take 27 KB
    lay1 = common.direct3d_layout(32, 32, 1, 1)
    assert (lay1.lead, lay1.ld, lay1.slots, lay1.smem_bytes) == (3, 40, 5, 27296)
    # the 8-deep tile at h = 8 (Box-3D2R, t = 4): two CTAs
    lay8 = common.direct3d_layout(16, 16, 2, 4)
    assert (lay8.slots, lay8.smem_bytes) == (25, 102816)
    assert 2 * (lay8.smem_bytes + 1024) <= 228 * 1024


def test_direct3d_rings_raise_past_the_budget():
    # past the 227 KB budget, and with no cluster form at r = 3, the rings
    # take the workspace form (the tile rule's fourth rung), which launches
    # on a card only; the whole-slab foil, which has none, still raises
    wide = common.SubstrateGeom(dim=3, strip_m=64, h_block=9, z_slab=4, z_block=9,
                                w_tile=64, w_block=9)
    lay = t_direct.direct3d_rings(wide, 3, 3)
    assert isinstance(lay, common.WorkspaceLayout)
    assert lay.base == common.direct3d_layout(64, 64, 3, 3)
    assert lay.base.smem_bytes > common.SMEM_BUDGET_BYTES
    x = torch.zeros((1, 8, 100, 100))
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        t_direct._launch3d(x, np.ones((7, 7, 7), np.float32), 3, 3, wide, (0, 0, 0))
    with pytest.raises(ValueError, match="227 KB"):
        t_direct._launch3d(x, np.ones((7, 7, 7), np.float32), 3, 3, wide, (0, 0, 0),
                           "wholestrip")


# ---------------------------------------------------------------------------
# The source and the C launch arguments
# ---------------------------------------------------------------------------
def test_source_constants_match_the_host():
    assert _define("DIRECT3D_AHEAD") == common.DIRECT3D_AHEAD
    assert _define("DIRECT3D_MARGIN") == common.DIRECT3D_MARGIN
    assert _define("MAX_TAPS3D") == t_direct.MAX_TAPS3D == 15**3
    assert _define("MAX_RADIUS3D") == t_direct.MAX_RADIUS == 7
    assert _define("DIRECT3D_ROWS") in (2, 4, 5, 8)
    assert 2 <= _define("DIRECT3D_MIN_BLOCKS_WIDE") <= _define("DIRECT3D_MIN_BLOCKS") <= 4
    assert re.search(r"__launch_bounds__\(CTA_THREADS,\s+R == 1 \? DIRECT3D_MIN_BLOCKS : "
                     r"DIRECT3D_MIN_BLOCKS_WIDE\)", SRC)
    assert '#include "tap_stage.cuh"' in SRC and "stage_region(" in SRC
    # the kernel's by-value taps: the 343 slots of radii 1..3, (2r+1)^3 past
    assert "const __grid_constant__ KernelTaps<tap_slots(R, 3)> taps" in SRC
    assert "kernel_taps<R, 3>(taps->w)" in SRC
    assert 'extern "C" int stencil_direct3d_ctas_per_sm(int dtype, int r, int fill, ' \
           'int smem_bytes)' in SRC
    body = re.search(r"struct Taps3 \{(.*?)\};", SRC, re.S).group(1)
    assert re.findall(r"float (\w+)\[MAX_TAPS3D\];", body) == \
        [f for f, _ in t_direct._Taps3._fields_] == ["w"]
    # the rings replace the whole-region staging, fill and store of common.cuh
    for gone in ("load_region3d", "fill_boundary", "store_tile3d", "TAPS3D_SLOTS"):
        assert gone not in SRC
    assert "cp_async_wait<DIRECT3D_AHEAD - 1>()" in SRC


def _c_params(entry: str) -> list:
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', SRC, re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


class _FakeLaunch:
    def __init__(self):
        self.argtypes = self.restype = self.args = None

    def __call__(self, *args):
        self.args = args
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
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    t_direct._launcher3d.cache_clear()
    t_direct._foil_launcher3d.cache_clear()
    tk.reset_launch_counts()
    yield fake
    t_direct._launcher3d.cache_clear()
    t_direct._foil_launcher3d.cache_clear()
    tk.reset_launch_counts()


@pytest.mark.parametrize("staging", ["region", "wholestrip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,t,batch", [(1, 4, 1), (1, 1, 3), (3, 1, 2), (2, 4, 1)])
def test_wrapper_passes_the_layout(fake_card, staging, dtype, r, t, batch):
    w = np.asarray(make_weights(JSpec("star", 3, r), seed=0), np.float32)
    shape = (40, 72, 100)
    x = torch.zeros((batch,) + shape, dtype=dtype)
    geom = common.launch_geom(shape, t * r)
    y = t_direct._launch3d(x, w, t, r, geom, (3, 2, 0), staging)
    counter = "stencil_direct3d" + ("" if staging == "region" else " (wholeslab)")
    assert {k: v for k, v in tk.launch_counts().items() if v} == {counter: 1}
    assert y.shape == x.shape and y.dtype == dtype
    entry = "stencil_direct3d" + ("_launch" if staging == "region" else "_foil_launch")
    params = _c_params(entry)
    assert len(fake_card.args) == len(params) == len(fake_card.argtypes)
    args = dict(zip(params, fake_card.args))
    lay = common.direct3d_layout(geom.strip_m, geom.w_tile, r, t)
    assert (args["Z"], args["H"], args["W"]) == shape
    assert (args["TZ"], args["TM"], args["TN"], args["t"], args["r"]) == \
        (geom.z_slab, geom.strip_m, geom.w_tile, t, r)
    assert (args["ld"], args["smem_bytes"]) == (lay.ld, lay.smem_bytes)
    assert (args["mode_z"], args["mode_y"], args["mode_x"], args["B"], args["grid_elems"]) == \
        (3, 2, 0, batch, int(np.prod(shape)))
    assert args["dtype"] == (1 if dtype == torch.bfloat16 else 0)
    if staging != "region":
        assert args["stage"] == common.STAGE_CODES[staging]
    taps = args["taps"]._obj
    assert list(taps.w)[:w.size] == w.ravel().tolist()
    assert list(taps.w)[w.size:] == [0.0] * (t_direct.MAX_TAPS3D - w.size)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("boundary", [None, ("replicate", "reflect", "periodic")])
def test_3d_calls_on_the_card_launch_the_kernel(fake_card, batched, boundary):
    # stencil_direct, the plan entry stencil_direct_at and its whole-slab
    # staging launch the 3D kernel once per call, batch or not, with the
    # rings' arguments: no other route
    w = np.asarray(make_weights(JSpec("box", 3, 1), seed=0), np.float32)
    grid_shape = (40, 72, 100)
    shape = (3,) + grid_shape if batched else grid_shape
    x = torch.zeros(shape).as_subclass(_OnCard)
    geom = common.launch_geom(grid_shape, 4)
    lay = common.direct3d_layout(geom.strip_m, geom.w_tile, 1, 4)
    calls = [("stencil_direct3d", lambda: t_direct.stencil_direct_at(
                 x, w, 4, geom, boundary, "region", batched)),
             ("stencil_direct3d (wholeslab)", lambda: t_direct.stencil_direct_at(
                 x, w, 4, geom, boundary, "wholestrip", batched))]
    if not batched:
        calls.append(("stencil_direct3d", lambda: t_direct.stencil_direct(
            x, w, 4, boundary=boundary)))
    want = {}
    for counter, call in calls:
        y = call()
        assert tuple(y.shape) == shape
        want[counter] = want.get(counter, 0) + 1
        assert {n: v for n, v in tk.launch_counts().items() if v} == want
        entry = "stencil_direct3d_launch" if counter == "stencil_direct3d" \
            else "stencil_direct3d_foil_launch"
        args = dict(zip(_c_params(entry), fake_card.args))
        assert (args["ld"], args["smem_bytes"], args["t"]) == (lay.ld, lay.smem_bytes, 4)
        assert args["B"] == (3 if batched else 1)
        assert args["mode_z"] == (0 if boundary is None else 3)
