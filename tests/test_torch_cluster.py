"""The 3D layouts past one CTA, spread over a thread-block cluster (the
tile rule's third rung, ``common.ClusterLayout``), on the CPU.

The cluster kernels (``csrc/cluster.cuh``; the cluster forms in
``csrc/stencil_direct3d.cu`` and ``csrc/slab_fold.cuh``) build and run
only on the card (``chip_smoke.py`` phase ``wide``,
``src/repro_torch/benchmarks/cluster_probe.py``).  Here: the layouts of
the formerly refused cells at full width and at the wide sweep's size --
each CTA's share within the budget, every fused step's ring, band and
region plane owned by exactly one CTA, every plane a CTA reads held in
its share, the cluster the least of 2, 4 and 8 that fits (against every
contiguous split), the degraded budget, the one-CTA layouts kept; a
numpy emulation of the 3D tap-sum's cluster schedule, each rank with its
own shared memory, reading only its own rings and writing the next
rank's, against the one-CTA emulation and JAX's kernel in interpret
mode; and the C launch arguments of the cluster entries."""
import contextlib
import importlib
import itertools
import pathlib
import re
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from repro_torch.stencil.spec import StencilSpec  # noqa: E402
from repro_torch.stencil.weights import fuse_weights, make_weights  # noqa: E402
import test_torch_slab_fold as sf  # noqa: E402
import test_torch_tapsum3d_fold as tap3  # noqa: E402
from test_torch_boundary import _fill_axis  # noqa: E402

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")
t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")
t_sparse = importlib.import_module("repro_torch.kernels.stencil_sparse")

CSRC = pathlib.Path(common.__file__).parent / "csrc"
BUDGET = common.SMEM_BUDGET_BYTES

#: The formerly refused cells: (pattern, t, regime).
DEEP = [(p, t, b) for p in ("Box-3D2R", "Star-3D2R")
        for t, b in [(t, "fused_direct") for t in (6, 7, 8)]
        + [(t, "fused_matmul") for t in (6, 7, 8)]
        + [(8, "fused_matmul_reuse"), (8, "fused_sparse_matmul")]]


def _launch(pattern, t, regime, shape, cdt=torch.float32, budget=BUDGET):
    """``(geom, layout, family, dzs)`` of the cell's one launch as its plan
    resolves it, and each band's dz (the folds)."""
    w = make_weights(StencilSpec.from_name(pattern), seed=0)
    if regime == "fused_direct":
        need = t_direct.tile_need(shape, 2, t, torch.float32)
        geom = common.launch_geom(shape, 2 * t, need=need)
        return geom, t_direct.direct3d_rings(geom, 2, t, budget), "steps", None
    if regime == "fused_matmul":
        wk, tk_, mod = fuse_weights(w, t), 1, t_matmul
    else:
        wk, tk_ = w, t
        mod = t_matmul if regime == "fused_matmul_reuse" else t_sparse
    need = mod.tile_need(shape, wk, tk_, torch.float32, cdt)
    geom = common.launch_geom(shape, 2 * t, need=need)
    if mod is t_sparse:
        dzs = tuple(r[0] for r in t_sparse.band_meta(wk, cdt).rows)
        lay = t_sparse.sparse_tile_layout(shape, wk, tk_, geom, cdt,
                                          budget=budget)
    else:
        dzs = t_matmul.band_dzs(wk)
        lay = t_matmul.slab_launch_layout(geom, (wk.shape[0] - 1) // 2, tk_,
                                          cdt.itemsize, dzs, "3D banded",
                                          budget=budget)
    return geom, lay, "dz" if tk_ == 1 else "planes", dzs


def _share(lay, geom, dzs, lo, hi, cb=4, radius=2):
    """A CTA's bytes owning the items [lo, hi), recounted here from the
    one-CTA layout's strides (csrc: the cluster kernels' carving);
    ``dzs`` each band's dz, sorted (the folds)."""
    base = lay.base
    if lay.kind == "steps":
        slots = sum(base.ring0 if s == 0 else base.ring for s in range(lo, hi))
        return (common.DIRECT3D_MARGIN + slots * base.plane_ld) * 4
    al = lambda n: -(-n // 128) * 128  # noqa: E731
    if lay.kind == "dz":
        planes = geom.z_slab + hi - lo - 1
        bands = int(np.searchsorted(dzs, hi) - np.searchsorted(dzs, lo))
    else:
        planes, bands = min(hi + 2 * radius, base.planes) - lo, len(dzs)
    return (al(planes * base.plane_ld * 4) + al(bands * base.toe_ld * cb)
            + bands * common.SLAB_HEADER_BYTES)


@pytest.mark.parametrize("shape", [(512, 512, 512), (32, 32, 32)])
@pytest.mark.parametrize("pattern,t,regime", DEEP)
def test_the_deep_cells_launch_over_a_cluster(pattern, t, regime, shape):
    geom, lay, kind, dzs = _launch(pattern, t, regime, shape)
    assert isinstance(lay, common.ClusterLayout) and lay.kind == kind
    assert lay.ctas in common.CLUSTER_SIZES
    assert lay.base.smem_bytes > BUDGET                      # no one CTA
    assert max(lay.shares) == lay.smem_bytes <= BUDGET       # each share fits
    split = lay.split
    assert split[0] == 0 and all(b > a for a, b in zip(split, split[1:]))
    n = {"steps": t, "dz": 4 * t + 1, "planes": geom.z_slab + 4 * t}[kind]
    assert split[-1] == n
    for k, ((a, b), (lo, hi)) in enumerate(zip(zip(split, split[1:]),
                                               lay.held)):
        assert lay.shares[k] == _share(lay, geom, dzs, a, b, 4)
        if kind == "steps":
            # each rank holds the rings of its steps; its steps read them
            assert (lo, hi) == (a, b)
        elif kind == "dz":
            # the bands of its dz, and every plane z + dz they read
            assert lay.rows[k + 1] - lay.rows[k] == sum(a <= d < b for d in dzs)
            reads = {z + d for z in range(geom.z_slab) for d in range(a, b)}
            assert reads == set(range(lo, hi))
        else:
            # at every step its output pairs read the planes z .. z + 4,
            # its own and the 4 after them, copied from their owners
            assert (lo, hi) == (a, min(b + 4, n))
            pin = n
            for _ in range(t):
                po = pin - 4
                reads = {z + d for z in range(a, min(b, po)) for d in range(5)}
                assert reads <= set(range(lo, hi))
                pin = po
    if kind == "dz":
        assert lay.rows[0] == 0 and lay.rows[-1] == len(dzs)
        assert list(dzs) == sorted(dzs)                      # bands in dz order


@pytest.mark.parametrize("pattern,t,regime",
                         [c for c in DEEP if c[0] == "Box-3D2R"])
def test_the_cluster_is_the_least_that_fits(pattern, t, regime):
    # no contiguous split into fewer CTAs of 2, 4, 8 fits the budget, and
    # the split taken has the least largest share of all splits into C
    geom, lay, kind, dzs = _launch(pattern, t, regime, (512, 512, 512))
    n = lay.split[-1]
    share = lambda a, b: _share(lay, geom, dzs, a, b, 4)  # noqa: E731

    def splits(c):
        for cut in itertools.combinations(range(1, n), c - 1):
            yield (0,) + cut + (n,)

    def largest(bounds):
        return max(share(a, b) for a, b in zip(bounds, bounds[1:]))

    for c in (c for c in common.CLUSTER_SIZES if c < lay.ctas and c <= n):
        assert all(largest(s) > BUDGET for s in splits(c))
    if lay.ctas <= 4 or n <= 16:
        assert largest(lay.split) == min(largest(s) for s in splits(lay.ctas))


def test_the_degraded_budget_takes_more_ctas(monkeypatch):
    # the guard's degraded rung halves the budget: Box-3D2R's rings at h =
    # 10 (one CTA at the full budget) spread over a cluster, and every
    # share of the deep cells fits the half
    half = BUDGET // 2
    monkeypatch.setenv("REPRO_VMEM_BUDGET", str(half))
    shape = (512, 512, 512)
    geom, lay, _, _ = _launch("Box-3D2R", 5, "fused_direct", shape, budget=half)
    assert isinstance(lay, common.ClusterLayout) and lay.smem_bytes <= half
    monkeypatch.delenv("REPRO_VMEM_BUDGET")
    one = _launch("Box-3D2R", 5, "fused_direct", shape)[1]
    assert isinstance(one, common.Direct3dLayout)
    monkeypatch.setenv("REPRO_VMEM_BUDGET", str(half))
    for pattern, t, regime in DEEP:
        geom, lay, _, _ = _launch(pattern, t, regime, shape, budget=half)
        assert max(lay.shares) <= half
        full = _launch(pattern, t, regime, shape)
        if (full[0].z_slab, full[0].strip_m, full[0].w_tile) == \
                (geom.z_slab, geom.strip_m, geom.w_tile):
            assert lay.ctas >= full[1].ctas


@pytest.mark.parametrize("shape", [(512, 512, 512), (60, 70, 130)])
def test_one_cta_layouts_are_kept(shape):
    # every 3D launch one CTA holds launches its one-CTA layout, on the
    # tile it always had: the tap-sum's rings and the folds' slabs at
    # every halo up to 9 (the reserves') and at 10 (the layouts')
    for h in range(1, 11):
        for r in (r for r in (1, 2, 3) if h % r == 0):
            t = h // r
            need = t_direct.tile_need(shape, r, t, torch.float32)
            geom = common.launch_geom(shape, h, need=need)
            if h <= 9:
                assert geom == common.resolve_tile_geom(shape, h)
            lay = t_direct.direct3d_rings(geom, r, t)
            one = common.direct3d_layout(geom.strip_m, geom.w_tile, r, t)
            # h = 10 at r = 1 (41 rings' slots) fits no one CTA: it was
            # refused before, and launches over a cluster now
            assert lay == one if (h, r) != (10, 1) else lay.base == one
            w = make_weights(StencilSpec("box", 3, r), seed=0)
            need = t_matmul.tile_need(shape, w, t, torch.float32, torch.float32)
            geom = common.launch_geom(shape, h, need=need)
            lay = t_matmul.slab_launch_layout(geom, r, t, 4, t_matmul.band_dzs(w),
                                              "3D banded")
            assert lay == common.slab_fold_layout(geom.z_slab, geom.strip_m,
                                                  geom.w_tile, r, t, 4, 9 if r == 1
                                                  else (2 * r + 1) ** 2)


def test_past_eight_ctas_the_launch_raises():
    # 40 rings of radius 1 (h = 40): a CTA holds one, so no cluster of 8;
    # the launch takes the workspace form (the tile rule's fourth rung)
    geom = common.SubstrateGeom(3, strip_m=16, h_block=40, z_slab=1,
                                z_block=40, w_tile=16, w_block=40)
    lay = t_direct.direct3d_rings(geom, 1, 40)
    assert isinstance(lay, common.WorkspaceLayout)
    assert lay.base == common.direct3d_layout(16, 16, 1, 40)
    assert common.direct3d_cluster(16, 16, 1, 40, BUDGET) is None
    # the cluster form takes radii up to CLUSTER_RADIUS3D, the reuse
    # split bands of up to CLUSTER_REUSE_KS k-steps
    assert common.tapsum_need(3, 3, 3, 4, "fused_direct").cluster is None
    assert common.tapsum_need(3, 2, 3, 4, "fused_direct").cluster is not None
    half = common.slab_fold_layout(16, 32, 32, 4, 2, 4, 81).smem_bytes // 2
    assert common.slab_cluster(16, 32, 32, 4, 2, 4, tuple(
        i // 9 for i in range(81)), None, None, half) is not None
    assert common.slab_cluster(16, 32, 32, 5, 2, 4, tuple(
        i // 11 for i in range(121)), None, None, half) is None  # 4 k-steps


# ---------------------------------------------------------------------------
# The 3D tap-sum's cluster schedule, emulated
# ---------------------------------------------------------------------------
def emulate_cluster_tapsum3d(x, w, t, geom, modes, lay):
    """The cluster form of ``stencil_direct3d.cu`` on the CPU, tile by
    tile of the (Z, H, W) grid ``x``: C ranks, each with its own shared
    memory of ``lay.smem_bytes`` (NaN until written), rank k running the
    fused steps [split[k], split[k + 1]) on its own rings, laid out from
    its first step's; rank 0 stages the region; a step stores its output
    plane into the ring of the rank that runs the next step.  Every read
    is of the reading rank's own memory, of a plane that landed in an
    earlier interval (writes land at the interval's cluster barrier)."""
    Z, H, W = x.shape
    r = (w.shape[0] - 1) // 2
    h = t * r
    tz, tm, tn = geom.z_slab, geom.strip_m, geom.w_tile
    base = lay.base
    planes0, rows0, cols0 = tz + 2 * h, tm + 2 * h, tn + 2 * h
    ld, lead, pld = base.ld, base.lead, base.plane_ld
    taps = [(dz, dy, dx, float(w[dz, dy, dx])) for dz, dy, dx in np.ndindex(*w.shape)
            if w[dz, dy, dx] != 0.0]
    owner = [next(k for k in range(lay.ctas) if lay.split[k] <= s < lay.split[k + 1])
             for s in range(t)]

    def slot(s, q):
        first = lay.split[owner[s]]
        i = ((q % base.ring0 if s == 0 else base.ring0 + (s - 1) * base.ring
              + q % base.ring) if first == 0 else (s - first) * base.ring
             + q % base.ring)
        off = common.DIRECT3D_MARGIN + i * pld
        assert off + rows0 * ld <= lay.smem_bytes // 4
        return owner[s], off

    y = np.full(x.shape, np.nan)
    zmap = modes[0] != "periodic"
    for k0, i0, j0 in itertools.product(range(0, Z, tz), range(0, H, tm),
                                        range(0, W, tn)):
        mem = [tap3._Smem(lay.smem_bytes) for _ in range(lay.ctas)]
        z0 = k0 - h
        fill_yx = (tap3._leaves(modes[1], i0 - h, rows0, H)
                   or tap3._leaves(modes[2], j0 - h, cols0, W))

        def stage(q):
            if q >= planes0:
                return
            rank, s0 = slot(0, q)
            zg = z0 + q
            rows = i0 - h + np.arange(rows0)
            cols = j0 - h - lead + np.arange(ld)
            v = x[zg % Z][np.ix_(rows % H, cols % W)].astype(np.float64)
            bad = np.zeros(v.shape, bool) | (zmap and not 0 <= zg < Z)
            if modes[1] != "periodic":
                bad |= ((rows < 0) | (rows >= H))[:, None]
            if modes[2] != "periodic":
                bad |= ((cols < 0) | (cols >= W))[None, :]
            mem[rank].put(s0 + np.arange(rows0)[:, None] * ld + np.arange(ld)[None, :],
                          np.where(bad, np.nan, v))

        def ranges(d):
            glo, ghi = k0 - d, min(k0 + tz, Z) + d
            if zmap:
                glo, ghi = max(glo, 0), min(ghi, Z)
            return glo - z0, ghi - z0

        for a in range(common.DIRECT3D_AHEAD):
            stage(a)
        for k in range(planes0 + t - 1):
            if fill_yx:
                for s in range(t):
                    q = k - s * (r + 1)
                    d = (t - s) * r
                    if q < planes0 if s == 0 else ranges(d)[0] <= q < ranges(d)[1]:
                        rank, off = slot(s, q)
                        tap3._fill_plane(mem[rank], off, ld, s * r, rows0 - 2 * s * r,
                                         lead + s * r, cols0 - 2 * s * r, i0 - h + s * r,
                                         j0 - h + s * r, H, W, d, modes[1], modes[2])
            stage(k + common.DIRECT3D_AHEAD)
            writes = []
            for s in range(t):
                q = k - (s + 1) * r - s
                lo, hi = ranges((t - 1 - s) * r)
                if not lo <= q < hi:
                    continue
                rank = owner[s]
                po = []
                for dz in range(2 * r + 1):
                    qi = q - r + dz
                    if zmap:
                        g = int(tap3.axis_source(z0 + qi, Z, (t - s) * r, modes[0]))
                        qi = -1 if g == tap3.ZERO else g - z0
                    if qi < 0:
                        po.append(None)
                        continue
                    at, off = slot(s, qi)
                    assert at == rank                    # its own rings only
                    po.append(off)
                r_lo, r_end = (s + 1) * r, rows0 - (s + 1) * r
                g_lo = (lead + r_lo) >> 2
                gn = ((lead + cols0 - (s + 1) * r + 3) >> 2) - g_lo
                rows = np.arange(r_lo, r_end)[:, None]
                cols = np.arange(4 * g_lo, 4 * (g_lo + gn))[None, :]
                acc = np.zeros((rows.size, cols.size))
                for dz, dy, dx, wv in taps:
                    if po[dz] is not None:
                        acc = acc + wv * mem[rank].take(
                            po[dz] + (rows - r + dy) * ld + (cols - r + dx))
                if s < t - 1:
                    to, out = slot(s + 1, q)             # the next step's rank
                    writes.append((to, out + rows * ld + cols, acc))
                else:
                    n_r, n_c = min(tm, H - i0), min(tn, W - j0)
                    y[z0 + q, i0:i0 + n_r, j0:j0 + n_c] = acc[:n_r, :n_c]
            for to, idx, acc in writes:                  # the cluster barrier
                mem[to].put(idx, acc)
    return y


def _emulated(most, kind, r, t, shape, boundary):
    """The emulated cluster form on a tile one CTA holds, at a budget that
    spreads its rings over the fewest CTAs (``most`` False) or the most."""
    w = tap3._weights(kind, r)
    x = tap3._grid(shape, 7)
    modes = tuple(tap3.resolve_boundary(boundary, 3))
    geom = common.launch_geom(shape, t * r, need=t_direct.tile_need(
        shape, r, t, torch.float32))
    full = common.direct3d_layout(geom.strip_m, geom.w_tile, r, t).smem_bytes
    lays = [lay for f in np.arange(0.95, 0.05, -0.05)
            if (lay := common.direct3d_cluster(geom.strip_m, geom.w_tile, r, t,
                                               int(full * f))) is not None]
    lay = max(lays, key=lambda a: a.ctas) if most else lays[0]
    return lay, w, x, geom, modes, emulate_cluster_tapsum3d(
        x, w, t, geom, modes, lay)


@pytest.mark.parametrize("most", [False, True])
@pytest.mark.parametrize("kind,r,t,boundary", [
    ("box", 1, 4, None), ("star", 2, 3, ("replicate", "reflect", "periodic")),
    ("box", 1, 5, ("zero", "zero", "reflect")), ("star", 2, 2, None)])
def test_cluster_schedule_equals_the_one_cta_kernel(most, kind, r, t, boundary):
    # the same sums in the same order, bit for bit (float64 here) with the
    # one-CTA emulation, and within f32 of JAX's kernel
    shape = (12, 20, 24)
    lay, w, x, geom, modes, y = _emulated(most, kind, r, t, shape, boundary)
    assert lay.ctas >= 2
    one = tap3.emulate_tapsum3d(x[None], w, t, geom, modes)[0]
    np.testing.assert_array_equal(y, one)
    want = tap3._jax(shape, kind, r, t, boundary, 7)
    np.testing.assert_allclose(y, want, rtol=0, atol=tap3._tol(x, w, t))


# ---------------------------------------------------------------------------
# The slab fold's cluster schedules, emulated
# ---------------------------------------------------------------------------
def _rank_tiles(pairs, ho, win, wo, radius):
    """``slab_step``'s map (csrc/slab_fold.cuh) of one rank's step: its
    output pairs [0, pairs), ho rows a plane, walked as
    ``common.slab_fold_tiles`` walks one CTA's step."""
    ntiles = -(-pairs // common.MMA_TILE)
    for c, c0 in enumerate(range(0, wo, common.BAND_N)):
        kv = min(common.BAND_N + 2 * radius, win - c0)
        for pss, base in enumerate(range(0, ntiles, common.SLAB_PASS_TILES)):
            for j in range(min(common.SLAB_PASS_TILES, ntiles - base)):
                ms = range((base + j) * common.MMA_TILE,
                           (base + j + 1) * common.MMA_TILE)
                yield common.FoldTile(
                    0, c, pss, base + j, j % 8,
                    tuple(divmod(min(m, pairs - 1), ho) for m in ms),
                    tuple(m < pairs for m in ms),
                    (c0, min(c0 + common.BAND_N, wo)), (None, None, win), kv)


def _stage_planes(share, x, modes, org, h, w0, q0, n):
    """``stage_planes``: region planes [q0, q0 + n) of a tile's step-0
    region (origin ``org`` - h) into the first n planes of ``share``, rows
    and columns by modulo, each y and x cell out of a non-periodic domain
    within depth h NaN (as ``emulate_slab`` marks them, so a fill a rank
    misses shows); a plane out of a non-periodic z domain within depth h
    from the in-domain plane the z fill copies, or zero."""
    Z, H, W = x.shape
    rows = np.arange(org[1] - h, org[1] - h + share.shape[1])
    cols = np.arange(org[2] - h, org[2] - h + w0)
    for p in range(n):
        g = org[0] - h + q0 + p
        src = g if modes[0] == "periodic" else int(tap3.axis_source(g, Z, h, modes[0]))
        if src == tap3.ZERO:
            share[p, :, :w0] = 0.0
            continue
        pl = x[(g if src == tap3.DEEP else src) % Z][np.ix_(rows % H, cols % W)]
        pl = pl.astype(np.float32)
        if modes[1] != "periodic":
            pl[(rows < 0) | (rows >= H) & (rows < H + h)] = np.nan
        if modes[2] != "periodic":
            pl[:, (cols < 0) | (cols >= W) & (cols < W + h)] = np.nan
        share[p, :, :w0] = pl


def _fill_yx(planes, org, depth, shape, modes):
    """``fill_boundary`` with z periodic: y and x of a step's input
    ``planes`` (origin ``org`` - depth) at ``depth``."""
    for ax in (1, 2):
        if modes[ax] != "periodic":
            _fill_axis(planes, ax, org[ax] - depth, shape[ax], depth, modes[ax])


def emulate_cluster_slab(x, w, t, geom, modes, cdt, lay, sparse=False):
    """The slab fold's cluster forms (``csrc/slab_fold.cuh``) on the CPU,
    tile by tile of the (Z, H, W) grid ``x``: C ranks, each with its own
    share of ``lay.held`` planes (NaN until written, the one-CTA layout's
    row stride), reading only it; ``fold_step`` is the one-CTA emulation's
    pass on it.

      * ``"dz"`` (``slab_fold_dz_kernel``, t = 1): rank k stages region
        planes [split[k], split[k + 1] - 1 + TZ) (z by the fill's map),
        fills y and x, rounds TF32 operands, and folds every output pair
        over its bands (rows[k] to rows[k + 1], whose dz all lie in
        [split[k], split[k + 1])) into its share; then the ranks' partial
        sums are added in rank order, in f32.
      * ``"planes"`` (``slab_fold_planes_kernel``, t > 1): rank k owns
        region planes [split[k], split[k + 1]) and holds the 2R after
        them.  Per step the owners fill their planes (z from the owner of
        the plane the fill copies, after a barrier; y and x in place),
        round at step 0, each rank copies the 2R planes after its own from
        their owners, then folds its own pairs in place; after the step
        every cell outside a rank's outputs is NaN, so a plane a rank did
        not copy, or a z fill it missed, shows.

    Writes between two cluster barriers land together, after every read
    of that interval."""
    Z, H, W = x.shape
    r = (w.shape[-1] - 1) // 2
    h = t * r
    tf32 = cdt == torch.float32
    rows, blocks = sf._rows(w, cdt, sparse)
    blocks = [sf._tf32(b) if tf32 else sf._bf16(b) for b in blocks]
    tz, tm, tn = geom.z_slab, geom.strip_m, geom.w_tile
    p0, h0, w0 = tz + 2 * h, tm + 2 * h, tn + 2 * h
    ld, sp, own = lay.base.ld, lay.split, list(zip(lay.split, lay.split[1:]))
    y = np.full(x.shape, np.nan, np.float32)
    for win in common.tile_windows(x.shape, geom):
        org = [a for a, _ in win[:3]]
        shares = [np.full((b - a, h0, ld), np.nan, np.float32) for a, b in lay.held]
        if lay.kind == "dz":
            assert t == 1 and len(rows) == lay.rows[-1]
            out = None
            for k, ((d0, d1), share) in enumerate(zip(own, shares)):
                band = slice(lay.rows[k], lay.rows[k + 1])
                assert all(d0 <= dz < d1 for dz, _, _, _ in rows[band])
                assert share.shape[0] == tz + d1 - d0 - 1
                _stage_planes(share, x, modes, org, h, w0, d0, share.shape[0])
                _fill_yx(share[:, :, :w0], org, h, x.shape, modes)
                if tf32:
                    share[:, :, :w0] = sf._tf32(share[:, :, :w0])
                sf.fold_step(share, _rank_tiles(tz * tm, tm, w0, tn, r), rows[band],
                             blocks[band], cdt, False, dz0=d0)
            for share in shares:                         # the cluster barrier
                out = share[:tz, :tm, :tn].copy() if out is None else \
                    out + share[:tz, :tm, :tn]
        else:
            def plane(q):                                # q in its owner's share
                k = next(k for k, (a, b) in enumerate(own) if a <= q < b)
                return shares[k][q - own[k][0]]

            pin, hin, wi = p0, h0, w0
            for (a, b), share in zip(own, shares):
                assert share.shape[0] == min(b + 2 * r, p0) - a
                _stage_planes(share, x, modes, org, h, w0, a, b - a)
            for s in range(t):
                po, ho, wo = pin - 2 * r, hin - 2 * r, wi - 2 * r
                depth = (t - s) * r
                gz = org[0] - depth
                mine = [max(0, min(b, pin) - a) for a, b in own]
                if s > 0 and modes[0] != "periodic":
                    writes = []
                    for (a, _), share, n in zip(own, shares, mine):
                        for p in range(a, a + n):
                            src = int(tap3.axis_source(gz + p, Z, depth, modes[0]))
                            if src not in (gz + p, tap3.DEEP):
                                writes.append((share, p - a, 0.0 if src == tap3.ZERO
                                               else plane(src - gz)[:hin, :wi].copy()))
                    for share, i, v in writes:           # the cluster barrier
                        share[i, :hin, :wi] = v
                for share, n in zip(shares, mine):
                    _fill_yx(share[:n, :hin, :wi], org, depth, x.shape, modes)
                    if s == 0 and tf32:
                        share[:n, :hin, :wi] = sf._tf32(share[:n, :hin, :wi])
                copies = [(share, p - a, plane(p)[:hin, :wi].copy())
                          for (a, b), share in zip(own, shares)
                          for p in range(b, min(b + 2 * r, pin))]
                for share, i, v in copies:               # the cluster barrier
                    share[i, :hin, :wi] = v
                for (a, b), share in zip(own, shares):
                    n_out = max(0, min(b, po) - a)
                    sf.fold_step(share, _rank_tiles(n_out * ho, ho, wi, wo, r), rows,
                                 blocks, cdt, tf32 and s + 1 < t)
                    share[n_out:] = np.nan
                    share[:, ho:] = np.nan
                    share[:, :, wo:] = np.nan
                pin, hin, wi = po, ho, wo
            out = np.concatenate([share[:max(0, min(b, tz) - a), :tm, :tn]
                                  for (a, b), share in zip(own, shares)])
        dst = tuple(slice(a, c) for a, c in win[:3])
        y[dst] = out[tuple(slice(0, c - a) for a, c in win[:3])]
    return y


def _slab_cluster(w, t, shape, cdt, sparse, most):
    """The fold's launch on ``shape`` (its plan's tile) at a budget that
    spreads its layout over the fewest CTAs (``most`` False) or the most,
    as the wrappers resolve it: ``(geom, layout)``."""
    r = (w.shape[-1] - 1) // 2
    mod = t_sparse if sparse else t_matmul
    geom = common.launch_geom(shape, t * r,
                              need=mod.tile_need(shape, w, t, torch.float32, cdt))

    def at(budget):
        try:
            if sparse:
                return t_sparse.sparse_tile_layout(shape, w, t, geom, cdt, budget=budget)
            return t_matmul.slab_launch_layout(geom, r, t, cdt.itemsize,
                                               t_matmul.band_dzs(w), "3D banded",
                                               budget=budget)
        except ValueError:
            return None
    full = at(None).smem_bytes
    lays = [lay for f in np.arange(0.95, 0.05, -0.05)
            if isinstance(lay := at(int(full * f)), common.ClusterLayout)]
    return geom, (max(lays, key=lambda a: a.ctas) if most else lays[0])


#: (kind, r, t, compacted bands, boundary, operands): the composed
#: contraction's split by dz (t = 1) and the reuse folds' split by planes.
SLAB_CLUSTER_CASES = [
    ("box", 2, 1, False, None, torch.float32),
    ("star", 2, 1, False, ("replicate", "reflect", "periodic"), torch.float32),
    ("box", 2, 1, False, ("zero", "zero", "reflect"), torch.bfloat16),
    ("box", 1, 3, False, ("replicate", "reflect", "periodic"), torch.float32),
    ("star", 2, 2, False, ("reflect", "zero", "replicate"), torch.float32),
    ("star", 1, 3, True, ("zero", "zero", "reflect"), torch.float32),
    ("box", 1, 2, True, None, torch.bfloat16)]


@pytest.mark.parametrize("most", [False, True])
@pytest.mark.parametrize("kind,r,t,sparse,boundary,cdt", SLAB_CLUSTER_CASES)
def test_slab_cluster_schedules_equal_the_one_cta_kernel(most, kind, r, t, sparse,
                                                         boundary, cdt):
    # the planes split takes each output's sums as one CTA does, bit for
    # bit (float64 sums here); the dz split adds its ranks' partial sums,
    # within the kernel's limit of the one-CTA emulation and the JAX oracle
    shape = (14, 20, 37)
    w = make_weights(StencilSpec(kind, 3, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=shape).astype(np.float32)
    modes = tuple(tap3.resolve_boundary(boundary, 3))
    geom, lay = _slab_cluster(w, t, shape, cdt, sparse, most)
    assert lay.ctas >= 2 and lay.kind == ("dz" if t == 1 else "planes")
    assert not most or lay.ctas >= 4
    y = emulate_cluster_slab(x, w, t, geom, modes, cdt, lay, sparse)
    one = sf.emulate_slab(x, w, t, geom, modes, cdt, sparse)
    limit = sf._limit(x, w, t, cdt)
    assert np.isfinite(y).all()
    if lay.kind == "planes":
        np.testing.assert_array_equal(y, one)
    else:
        np.testing.assert_allclose(y, one, rtol=0, atol=limit)
    ref = np.asarray(sf.j_ref(sf.jnp.asarray(x), w, t, boundary=boundary))
    np.testing.assert_allclose(y, ref, rtol=0, atol=limit)


# ---------------------------------------------------------------------------
# The sources and the C launch arguments
# ---------------------------------------------------------------------------
def _c_params(src: str, entry: str) -> list:
    text = (CSRC / src).read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', text, re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


def test_source_constants_match_the_host():
    cl = (CSRC / "cluster.cuh").read_text()
    assert int(re.search(r"#define MAX_CLUSTER (\d+)", cl).group(1)) == \
        common.CLUSTER_SIZES[-1] == 8
    d3 = (CSRC / "stencil_direct3d.cu").read_text()
    assert int(re.search(r"#define MAX_CLUSTER_RADIUS3D (\d+)", d3).group(1)) == \
        common.CLUSTER_RADIUS3D
    # the cluster forms build apart, from the same sources
    for name in _build.CLUSTERED:
        lib = f"{name}_cluster"
        assert lib in _build.KERNELS and _build.source(lib) == name
        assert "-DREPRO_CLUSTER" in _build._flags(lib)
        assert "-DREPRO_CLUSTER" not in _build._flags(name)
        text = (CSRC / f"{name}.cu").read_text()
        assert text.count("REPRO_CLUSTER") >= 1 and \
            f'extern "C" int {name}_cluster_launch(' in text
    slab = (CSRC / "slab_fold.cuh").read_text()
    assert "DZ ? SpMma<TC>::MAX_KS : FoldKs<TC>::SMALL" in slab
    ks = (CSRC / "sparse_mma.cuh").read_text()
    for tc, n in (("float", 4), ("__nv_bfloat16", 2)):
        small = re.search(rf"struct FoldKs<{tc}> \{{\s*static constexpr int SMALL = (\d+);",
                          ks).group(1)
        assert int(small) == common.CLUSTER_REUSE_KS[n]
    assert "cudaLaunchAttributeClusterDimension" in cl
    slab = (CSRC / "slab_fold.cuh").read_text()
    for kernel in ("slab_fold_dz_kernel", "slab_fold_planes_kernel"):
        assert f"{kernel}(const SlabArgs a, const ClusterSplit sp)" in slab
    for name in _build.CLUSTERED:
        assert f"{name} (cluster)" in _build.COUNTERS


class _FakeLaunch:
    def __init__(self):
        self.argtypes = self.restype = self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    fake, one_cta = _FakeLaunch(), _FakeLaunch()
    fake.one_cta = one_cta
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake if name.endswith("_cluster") else one_cta}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    def clear():
        for mod in (t_direct, t_matmul, t_sparse):
            mod._cluster_launcher3d.cache_clear()
            mod._launcher3d.cache_clear()
        tk.reset_launch_counts()
    clear()
    yield fake
    clear()


@pytest.mark.parametrize("pattern,t,regime", [
    ("Box-3D2R", 6, "fused_direct"), ("Star-3D2R", 8, "fused_direct"),
    ("Box-3D2R", 6, "fused_matmul"), ("Star-3D2R", 7, "fused_matmul"),
    ("Box-3D2R", 8, "fused_matmul_reuse"), ("Star-3D2R", 8, "fused_sparse_matmul")])
@pytest.mark.parametrize("batch", [1, 2])
def test_wrapper_passes_the_cluster(fake_card, pattern, t, regime, batch):
    shape = (32, 32, 32)
    geom, lay, kind, _ = _launch(pattern, t, regime, shape)
    w = np.asarray(make_weights(StencilSpec.from_name(pattern), seed=0), np.float32)
    x = torch.zeros((batch,) + shape)
    codes = (1, 2, 0)
    if regime == "fused_direct":
        lib, src = "stencil_direct3d", "stencil_direct3d.cu"
        y = t_direct._launch3d(x, w, t, 2, geom, codes)
    elif regime == "fused_sparse_matmul":
        lib, src = "stencil_sparse3d", "stencil_sparse3d.cu"
        y = t_sparse._launch3d(x, w, t, 2, torch.float32, geom, codes)
    else:
        lib, src = "stencil_banded3d", "stencil_banded3d.cu"
        wk, tk_, rk = (fuse_weights(w, t), 1, 2 * t) if regime == "fused_matmul" \
            else (w, t, 2)
        y = t_matmul._launch3d(x, np.asarray(wk, np.float32), tk_, rk, torch.float32,
                               geom, codes)
    assert y.shape == x.shape and fake_card.one_cta.args is None
    assert {k: v for k, v in tk.launch_counts().items() if v} == {f"{lib} (cluster)": 1}
    assert tk.cluster_ctas() == {f"{lib} (cluster)": lay.ctas}
    params = _c_params(src, f"{lib}_cluster_launch")
    assert len(fake_card.args) == len(params) == len(fake_card.argtypes)
    args = dict(zip(params, fake_card.args))
    assert (args["Z"], args["H"], args["W"]) == shape
    assert (args["TZ"], args["TM"], args["TN"]) == (geom.z_slab, geom.strip_m, geom.w_tile)
    assert (args["ctas"], args["smem_bytes"], args["B"]) == (lay.ctas, lay.smem_bytes, batch)
    assert (args["mode_z"], args["mode_y"], args["mode_x"]) == codes
    split = args["steps"] if regime == "fused_direct" else args["split"]
    assert list(split) == list(lay.split)
    assert args["ld"] == lay.base.ld
    if regime != "fused_direct":
        assert args["plane_ld"] == lay.base.plane_ld
    if regime == "fused_matmul":
        assert list(args["bands"]) == list(lay.rows)
    elif lib == "stencil_banded3d":
        assert args["bands"] is None
