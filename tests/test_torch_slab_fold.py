"""The 3D banded kernels (``csrc/slab_fold.cuh``: K5/K6 banded and K7 on
3D grids) on the CPU: their fold map ``slab_fold_tiles`` as pure Python,
a numpy emulation of their dataflow built on that map alone against the
JAX package's 3D ``stencil_matmul`` and ``stencil_sparse_matmul`` in
interpret mode and against the JAX oracle, their shared-memory layout,
the bands' Toeplitz rows, and the C launch arguments the wrappers pass
(parsed from the ``.cu`` signatures).  The kernels themselves build and
run only on the card (``chip_smoke.py``,
``src/repro_torch/benchmarks/fold_probe.py slab``)."""
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
import jax.numpy as jnp  # noqa: E402

from repro.kernels import stencil_sparse as jsp  # noqa: E402
from repro.kernels.ref import stencil_direct_ref as j_ref  # noqa: E402
from repro.kernels.stencil_matmul import stencil_matmul as j_matmul  # noqa
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from test_torch_boundary import _fill_axis  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")
t_sparse = importlib.import_module("repro_torch.kernels.stencil_sparse")

CSRC = pathlib.Path(common.__file__).parent / "csrc"


# ---------------------------------------------------------------------------
# The fold map
# ---------------------------------------------------------------------------
def _rows(w, cdt, sparse):
    """The bands as the kernels read them: ``(dz, dy, lo, nk)`` each and
    their (nk * K, 16) blocks, K the MMA K step of ``cdt``."""
    k = common.mma_k_step(cdt.itemsize)
    if sparse:
        meta = t_sparse.band_meta(w, cdt)
        starts = np.cumsum([0] + [r[-1] * k for r in meta.rows])
        return list(meta.rows), [meta.packed[a:b] for a, b in
                                 zip(starts[:-1], starts[1:])]
    offsets, bands = t_matmul.build_bands_nd(np.asarray(w, np.float32), 16)
    kpad = -(-bands.shape[1] // k) * k
    bands = np.pad(bands, ((0, 0), (0, kpad - bands.shape[1]), (0, 0)))
    return [tuple(o) + (0, kpad // k) for o in offsets], list(bands)


MAP_TILES = [(shape, r, t) for shape in ((60, 70, 130), (40, 72, 100))
             for r, t in ((1, 1), (1, 4), (2, 2), (4, 1), (2, 4), (1, 8))]


@pytest.mark.parametrize("shape,r,t", MAP_TILES)
def test_fold_map_writes_each_output_once_and_reads_only_what_it_may(
        shape, r, t):
    geom = common.launch_geom(shape, t * r)
    tz, tm, tn = geom.z_slab, geom.strip_m, geom.w_tile
    w = make_weights(JSpec("box", 3, r), seed=0)
    rows, _ = _rows(w, torch.float32, sparse=False)
    tiles = list(common.slab_fold_tiles(tz, tm, tn, r, t))
    h = t * r
    ext = (tz + 2 * h, tm + 2 * h, tn + 2 * h)
    for s in range(t):
        step = [f for f in tiles if f.step == s]
        assert step[0].extent == ext
        po, ho, wo = (e - 2 * r for e in ext)
        writes = np.zeros((po, ho, wo), np.int64)
        written = np.zeros(ext, bool)   # cells earlier chunks or passes wrote
        for (c, pss), group in itertools.groupby(
                step, key=lambda f: (f.chunk, f.pass_)):
            group = list(group)
            assert len(group) <= common.SLAB_PASS_TILES
            per_warp = np.bincount([f.warp for f in group], minlength=8)
            assert per_warp.max() <= common.SLAB_TILES_PER_WARP
            for f in group:
                assert f.cols == (16 * c, min(16 * c + 16, wo))
                assert f.kv == min(16 + 2 * r, ext[2] - 16 * c)
                for z, y, a, v, e in f.reads(rows, 8):
                    assert 0 <= z < ext[0] and 0 <= y < ext[1]
                    assert a >= 16 * c and v <= ext[2]      # loaded cells
                    assert not written[z, y, a:v].any()     # ... still inputs
            for f in group:                 # the pass stores after its reads
                for (z, y), keep in zip(f.pairs, f.stored):
                    if keep:
                        writes[z, y, f.cols[0]:f.cols[1]] += 1
                        written[z, y, f.cols[0]:f.cols[1]] = True
        assert (writes == 1).all()
        ext = (po, ho, wo)


@pytest.mark.parametrize("shape,halo,batch", [((60, 70, 130), 4, 3),
                                              ((40, 72, 100), 8, 2),
                                              ((40, 72, 100), 1, 1)])
def test_fold_map_covers_every_grid_of_a_batch_once(shape, halo, batch):
    # every CTA of every grid runs the map on its own region; the last
    # step's stored pairs are the tile, which the store clips to the grid
    geom = common.launch_geom(shape, halo)
    tz, tm, tn = geom.z_slab, geom.strip_m, geom.w_tile
    last = [f for f in common.slab_fold_tiles(tz, tm, tn, halo, 1)]
    tile = np.zeros((tz, tm, tn), np.int64)
    for f in last:
        for (z, y), keep in zip(f.pairs, f.stored):
            tile[z, y, f.cols[0]:f.cols[1]] += keep
    assert (tile == 1).all()
    hits = np.zeros((batch,) + shape, np.int64)
    for b in range(batch):
        for win in common.tile_windows(shape, geom):
            hits[(b,) + tuple(slice(a, c) for a, c in win[:3])] += \
                tile[tuple(slice(0, c - a) for a, c in win[:3])]
    assert (hits == 1).all()


def test_fold_folds_plane_row_pairs_into_the_mma_rows():
    # the main tile at h = 4: step 0 runs 31 tiles for 22 x 22 pairs where
    # one 16-row tile per plane ran 44; a tile crosses plane boundaries
    tiles = [f for f in common.slab_fold_tiles(16, 16, 32, 1, 4)
             if f.step == 0 and f.chunk == 0]
    assert len(tiles) == 31 and {f.pass_ for f in tiles} == {0}
    assert tiles[1].pairs[:7] == tuple((0, y) for y in range(16, 22)) + \
        ((1, 0),)
    assert tiles[-1].stored == (True,) * 4 + (False,) * 12
    assert tiles[-1].pairs[4:] == ((21, 21),) * 12
    assert [f.warp for f in tiles[:9]] == list(range(8)) + [0]


# ---------------------------------------------------------------------------
# The kernels' dataflow, emulated on the map alone, against JAX
# ---------------------------------------------------------------------------
def _tf32(a):
    """wmma::__float_to_tf32 (cvt.rna.tf32.f32) on float32 values: round
    to 10 mantissa bits, ties away from zero; NaN and Inf as they are."""
    a = np.asarray(a, np.float32)
    bits = a.view(np.uint32).copy()
    fin = np.isfinite(a)
    bits[fin] = (bits[fin] + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def _bf16(a):
    """__float2bfloat16_rn on float32 values, as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def fold_step(reg, tiles, rows, blocks, cdt, round_out, stats=None, dz0=0):
    """One step of the fold on the region ``reg`` (planes, rows, ld), in
    place: per chunk and pass of ``tiles`` (the step's map, in order), every
    tile's sums over the bands ``rows`` with their rounded ``blocks`` (A
    rows of the tile's pairs shifted by (dz - dz0, dy), from column lo, zero
    from chunk column kv on, bf16 operands rounded at the load), accumulated
    in f64, and only then the pass's stores, f32 (TF32-rounded where
    ``round_out``), masked at the step's width and last pair."""
    k_step = common.mma_k_step(cdt.itemsize)
    tf32 = cdt == torch.float32
    ld = reg.shape[-1]
    for _, group in itertools.groupby(tiles, key=lambda f: (f.chunk, f.pass_)):
        group = list(group)
        pz = np.array([[z for z, _ in f.pairs] for f in group])
        py = np.array([[yy for _, yy in f.pairs] for f in group])
        c0, kv = group[0].cols[0], group[0].kv
        acc = np.zeros(pz.shape + (16,))
        for (dz, dy, lo, nk), blk in zip(rows, blocks):
            cols = c0 + lo + np.arange(nk * k_step)
            a = reg[(pz + dz - dz0)[..., None], (py + dy)[..., None],
                    np.minimum(cols, ld - 1)]
            a = np.where(cols - c0 < kv, a, 0.0)
            if not tf32:
                a = _bf16(a)
            acc += a.astype(np.float64) @ blk.astype(np.float64)
            if stats is not None:
                stats["mma"] += len(group) * nk * (
                    1 + (group[0].cols[1] - c0 > 8))
        out = acc.astype(np.float32)
        if round_out:
            out = _tf32(out)
        keep = np.array([f.stored for f in group])
        c1 = group[0].cols[1]
        reg[pz[keep], py[keep], c0:c1] = out[keep][:, :c1 - c0]


def emulate_slab(x, w, t, geom, modes, cdt, sparse=False, stats=None):
    """The 3D banded kernels' dataflow on the CPU, CTA by CTA, on the map
    ``slab_fold_tiles`` alone.  The region is laid out as
    ``slab_fold_layout`` lays it out, its padding columns NaN; it loads by
    modulo indices, every out-of-domain cell of a non-periodic axis within
    the halo's depth NaN, so a cell the fill misses and a valid output
    reads shows (deeper cells, past the domain's edge inside a ragged
    tile, keep what the modulo load put there: the fill leaves them, and
    an A operand of a chunk at the edge holds them at band rows of zero
    weight, where a NaN would reach valid outputs as NaN * 0).  Per step:
    the fill at depth (t-s)r; before step 0, TF32 operands round in place;
    the step's chunks and passes (``fold_step``; the bands' rows rounded as
    the host and the staging round them, the stores TF32-rounded for a
    next step); after the step every cell
    outside its output is set to NaN, as the next step must not read it.
    The last step's tile is stored, clipped to the grid.
    ``stats["mma"]`` counts the products of the tiles' sums: per tile and
    band, each k-step of each n8 half of the chunk that holds an output."""
    r = (w.shape[-1] - 1) // 2
    h = t * r
    tf32 = cdt == torch.float32
    rows, blocks = _rows(w, cdt, sparse)
    blocks = [_tf32(b) if tf32 else _bf16(b) for b in blocks]
    tz, tm, tn = geom.z_slab, geom.strip_m, geom.w_tile
    lay = common.slab_fold_layout(tz, tm, tn, r, t, cdt.itemsize, len(rows))
    tiles = list(common.slab_fold_tiles(tz, tm, tn, r, t))
    y = np.full_like(x, np.nan)
    for win in common.tile_windows(x.shape, geom):
        org = [a for a, _ in win[:3]]
        reg = np.full((tz + 2 * h, tm + 2 * h, lay.ld), np.nan, np.float32)
        reg[:, :, :tn + 2 * h] = x[np.ix_(*(np.arange(a - h, a + tl + h) % n
                                            for a, tl, n in zip(
                                                org, (tz, tm, tn), x.shape)))]
        for ax, (a, tl, n) in enumerate(zip(org, (tz, tm, tn), x.shape)):
            if modes[ax] != "periodic":
                g = np.arange(a - h, a + tl + h)
                np.moveaxis(reg[:, :, :tn + 2 * h], ax, 0)[
                    (g < 0) | (g >= n) & (g < n + h)] = np.nan
        for s in range(t):
            o = (t - s) * r
            pin, hin, win_ = (tz + 2 * o, tm + 2 * o, tn + 2 * o)
            cur = reg[:pin, :hin, :win_]
            for ax, (a, n) in enumerate(zip(org, x.shape)):
                if modes[ax] != "periodic":
                    _fill_axis(cur, ax, a - o, n, o, modes[ax])
            if tf32 and s == 0:
                cur[...] = _tf32(cur)
            fold_step(reg, [f for f in tiles if f.step == s], rows, blocks,
                      cdt, tf32 and s + 1 < t, stats)
            po, ho, wo = pin - 2 * r, hin - 2 * r, win_ - 2 * r
            reg[po:] = np.nan
            reg[:, ho:] = np.nan
            reg[:, :, wo:] = np.nan
        dst = tuple(slice(a, c) for a, c in win[:3])
        y[dst] = reg[tuple(slice(0, c - a) for a, c in win[:3])]
    return y


def _limit(x, w, t, cdt):
    """2^-10 of sum|w| * max|x| per step for TF32 operands (each operand
    rounded to 2^-11), 2^-7 for bf16 (2^-8 each)."""
    per_step = 2.0**-10 if cdt == torch.float32 else 2.0**-7
    return t * per_step * float(np.abs(w).sum()) * float(np.abs(x).max())


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("kind,r,t,boundary", [
    ("box", 1, 4, None), ("star", 1, 2, ("replicate", "reflect", "periodic"))])
def test_fold_emulation_matches_jax_in_interpret_mode(sparse, kind, r, t,
                                                      boundary):
    # 20 x 24 x 40 on a pinned 8 x 16 x 16 tile: ragged in y and z
    shape = (20, 24, 40)
    w = make_weights(JSpec(kind, 3, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=shape).astype(np.float32)
    geom = common.launch_geom(shape, t * r, tile_m=16, w_tile=16, z_slab=8)
    modes = common.resolve_boundary(boundary, 3)
    y = emulate_slab(x, w, t, geom, modes, torch.float32, sparse)
    assert np.isfinite(y).all()
    ref = (jsp.stencil_sparse_matmul(jnp.asarray(x), w, t, tile_n=16,
                                     interpret=True, boundary=boundary)
           if sparse else
           j_matmul(jnp.asarray(x), w, t, interpret=True, boundary=boundary))
    np.testing.assert_allclose(y, np.asarray(ref), rtol=0,
                               atol=_limit(x, w, t, torch.float32))


ORACLE_CASES = [(kind, r, t, bc, sparse)
                for kind in ("box", "star") for r in (1, 2) for t in (1, 2, 4)
                for bc in (None, ("replicate", "reflect", "periodic"))
                for sparse in (False, True)]


@pytest.mark.parametrize("kind,r,t,boundary,sparse", ORACLE_CASES)
def test_fold_emulation_matches_the_jax_oracle(kind, r, t, boundary, sparse):
    # 10 x 20 x 37: ragged on every axis, shallower than the tile rule's
    # tile at small h; the r = 2, t = 4 case runs the 8-deep tile at h = 8
    shape = (10, 20, 37)
    w = make_weights(JSpec(kind, 3, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=shape).astype(np.float32)
    geom = common.launch_geom(shape, t * r)
    modes = common.resolve_boundary(boundary, 3)
    y = emulate_slab(x, w, t, geom, modes, torch.float32, sparse)
    ref = np.asarray(j_ref(jnp.asarray(x), w, t, boundary=boundary))
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=_limit(x, w, t, torch.float32))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("boundary", [None, "zero", "reflect"])
def test_fold_emulation_in_bf16_matches_the_jax_oracle(sparse, boundary):
    shape = (10, 20, 37)
    w = make_weights(JSpec("star", 3, 1), seed=5)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    geom = common.launch_geom(shape, 2)
    modes = common.resolve_boundary(boundary, 3)
    y = emulate_slab(x, w, 2, geom, modes, torch.bfloat16, sparse)
    ref = np.asarray(j_ref(jnp.asarray(x), w, 2, boundary=boundary))
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=_limit(x, w, 2, torch.bfloat16))


def test_fold_emulation_of_the_compacted_bands_equals_the_dense_one():
    # on box and star kernels the compacted products are the dense ones
    shape = (10, 20, 37)
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    modes = ("periodic",) * 3
    for kind in ("box", "star"):
        w = make_weights(JSpec(kind, 3, 1), seed=3)
        geom = common.launch_geom(shape, 2)
        dense = emulate_slab(x, w, 2, geom, modes, torch.float32, False)
        sparse = emulate_slab(x, w, 2, geom, modes, torch.float32, True)
        np.testing.assert_array_equal(dense, sparse)


# ---------------------------------------------------------------------------
# The shared-memory layout and the bands' Toeplitz rows
# ---------------------------------------------------------------------------
LAYOUT_GRIDS = ((512, 512, 512), (60, 70, 130), (40, 72, 100), (10, 20, 37),
                (3, 5, 7))


@pytest.mark.parametrize("halo", range(1, 10))
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_slab_layout_fits_at_every_plan_tile(halo, cdt):
    # every (R, t) with t R = halo, the composed box's (2R + 1)^2 bands
    # (the most a kernel of that radius has), at the tile the rule picks
    # for each grid: under the rule's bound, so under the 227 KB budget
    for shape in LAYOUT_GRIDS:
        g = common.resolve_tile_geom(shape, halo)
        tz, tm, tn = g.z_slab, g.strip_m, g.w_tile
        bound = common.tile_smem_bound(tm, tn, halo, tz)
        for t in (t for t in range(1, halo + 1) if halo % t == 0):
            r = halo // t
            w = make_weights(JSpec("box", 3, r), seed=0)
            lay = common.slab_fold_layout(tz, tm, tn, r, t, cdt.itemsize,
                                          (2 * r + 1) ** 2)
            assert lay.smem_bytes <= bound <= common.SMEM_BUDGET_BYTES
            assert (lay.planes, lay.rows) == (tz + 2 * halo, tm + 2 * halo)
            assert lay.ld >= tn + 2 * halo and lay.ld % 8 == 4
            ho = tm + 2 * (t - 1) * r
            assert lay.plane_ld >= lay.rows * lay.ld
            assert (lay.plane_ld - ho * lay.ld) % 32 == 0
            assert lay.toe_ld == lay.kpad + 16 and lay.toe_ld % 8 == 0
            # ... and the compacted wrapper's layout of the same launch
            geom = common.launch_geom(shape, halo)
            assert t_sparse.sparse_tile_layout(shape, w, t, geom, cdt) == lay


def test_slab_layout_at_the_main_tile_takes_two_ctas_per_sm():
    # 16 x 16 x 32 at h = 4 (Box-3D1R, t = 4): a 24 x 24 x 44 region and
    # nine bands; two CTAs (each with its 1 KB the runtime reserves) fit
    # the SM's 228 KB, where the operand-copy layout took one
    for cb in (4, 2):
        lay = common.slab_fold_layout(16, 16, 32, 1, 4, cb, 9)
        assert (lay.planes, lay.rows, lay.ld, lay.plane_ld) == \
            (24, 24, 44, 1064)
        assert 2 * (lay.smem_bytes + 1024) <= 228 * 1024
        old = common.banded3d_layout(16, 16, 32, 1, 4, cb).smem_bytes
        assert lay.smem_bytes < old and 2 * (old + 1024) > 228 * 1024
    assert common.slab_fold_layout(16, 16, 32, 1, 4, 4, 9).smem_bytes == \
        103824


@pytest.mark.parametrize("t", [1, 2, 4])
def test_fragment_rows_hit_distinct_bank_quads_at_step_0(t):
    # the 8 rows of an A fragment are 8 consecutive pairs m; at step 0
    # their offsets are m * ld mod 32 words, across plane boundaries too
    lay = common.slab_fold_layout(16, 16, 32, 1, t, 4, 9)
    ho = 16 + 2 * (t - 1)           # = po, the step's output planes
    for m0 in range(ho * ho - 8):
        offs = [(m // ho) * lay.plane_ld + (m % ho) * lay.ld
                for m in range(m0, m0 + 8)]
        assert len({(o % 32) // 4 for o in offs}) == 8


def test_toeplitz_rows_of_the_bands():
    w = make_weights(JSpec("box", 3, 2), seed=0)
    offsets, bands = t_matmul.build_bands_nd(np.asarray(w, np.float32), 16)
    bands = np.pad(bands, ((0, 0), (0, 4), (0, 0)))     # kpad 24
    toe = t_matmul.toeplitz_rows(bands)
    assert toe.shape == (25, 24 + 16) and not toe[:, -1].any()
    k, n = np.meshgrid(np.arange(24), np.arange(16), indexing="ij")
    assert np.array_equal(toe[:, k - n + 15], bands)
    bad = bands.copy()
    bad[0, 3, 2] += 1.0
    with pytest.raises(ValueError, match="Toeplitz"):
        t_matmul.toeplitz_rows(bad)
    # the dense wrapper's operand: these rows, and (dz, dy, 0, kpad / K)
    dev_toe, rows = t_matmul._device_toe(np.asarray(w, np.float32).tobytes(),
                                         w.shape, torch.float32, "cpu")
    assert np.array_equal(dev_toe.numpy(), toe)
    assert rows.tolist() == [list(o) + [0, 3] for o in offsets]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_compacted_toeplitz_rows_hold_each_band_from_lo(cdt):
    # a band whose taps sit at dx = 3, 4 of a radius-2 row keeps rows from
    # lo = 3 (test_torch_sparse's shifted band, one rank up)
    w = np.zeros((5, 5, 5), np.float32)
    w[2, 2, 2], w[0, 1, 3], w[0, 1, 4] = 1.0, 0.5, 0.25
    meta = t_sparse.band_meta(w, cdt)
    k = common.mma_k_step(cdt.itemsize)
    toe = t_sparse.band_toeplitz(meta, k)
    deepest = max(r[-1] for r in meta.rows) * k
    assert toe.shape == (2, deepest + 16)
    start = 0
    for row, (dz, dy, lo, nk) in zip(toe, meta.rows):
        block = meta.packed[start:start + nk * k]
        kk, n = np.meshgrid(np.arange(nk * k), np.arange(16), indexing="ij")
        assert np.array_equal(row[kk - n + 15], block)
        assert not row[nk * k + 15:].any()
        start += nk * k
    assert meta.rows[0][:3] == (0, 1, 3)
    lay = t_sparse.sparse_tile_layout((64,) * 3, w, 1,
                                      common.launch_geom((64,) * 3, 2), cdt)
    assert lay.toe_ld == deepest + 16 and lay.a_cols == meta.a_cols


# ---------------------------------------------------------------------------
# The sources and the C launch arguments
# ---------------------------------------------------------------------------
def test_both_3d_kernels_are_the_slab_fold():
    assert (t_matmul.kernel_source(3), t_sparse.kernel_source(3)) == \
        ("stencil_banded3d", "stencil_sparse3d")
    body = (CSRC / "slab_fold.cuh").read_text()
    for name in ("stencil_banded3d", "stencil_sparse3d"):
        src = (CSRC / f"{name}.cu").read_text()
        assert '#include "slab_fold.cuh"' in src
        assert f'extern "C" int {name}_launch(' in src
        assert f'extern "C" int {name}_ctas_per_sm(' in src
        assert "achunk" not in src and "__global__" not in src
    assert "__launch_bounds__(CTA_THREADS, SLAB_MIN_BLOCKS)" in body
    assert re.search(r"#define SLAB_MIN_BLOCKS 2\b", body)
    assert re.search(rf"#define SLAB_TILES_PER_WARP "
                     rf"{common.SLAB_TILES_PER_WARP}\b", body)
    assert "achunk" not in body and "load_region3d<STAGE>" in body


def _c_params(kernel: str, entry: str) -> list:
    src = (CSRC / f"{kernel}.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


class _FakeLaunch:
    def __init__(self):
        self.argtypes = self.restype = self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("sparse,staging", [(False, "region"),
                                            (False, "wholestrip"),
                                            (True, "region")])
@pytest.mark.parametrize("dtype,cdt", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.bfloat16)])
def test_wrappers_pass_the_slab_arguments(monkeypatch, sparse, staging, dtype,
                                          cdt):
    mod = t_sparse if sparse else t_matmul
    kernel = mod.kernel_source(3)
    entry = f"{kernel}_launch" if staging == "region" else \
        f"{kernel}_foil_launch"
    fake = _FakeLaunch()
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    launchers = [mod._launcher3d] + ([] if sparse else [mod._foil_launcher3d])
    for f in launchers:
        f.cache_clear()
    w = np.asarray(make_weights(JSpec("star", 3, 1), seed=0), np.float32)
    shape = (6, 20, 37)
    x = torch.zeros((3,) + shape, dtype=dtype)       # a batch of 3 grids
    geom = common.launch_geom(shape, 2)
    codes = common.kernel_mode_codes(("zero", "periodic", "reflect"))
    tk.reset_launch_counts()
    try:
        if sparse:
            y = mod._launch3d(x, w, 2, 1, cdt, geom, codes)
        else:
            y = mod._launch3d(x, w, 2, 1, cdt, geom, codes, staging)
    finally:
        for f in launchers:
            f.cache_clear()
        counts = tk.launch_counts()
        tk.reset_launch_counts()
    counter = kernel if staging == "region" else f"{kernel} (wholeslab)"
    assert y.shape == x.shape and y.dtype == dtype
    assert counts[counter] == 1 and sum(counts.values()) == 1
    params = _c_params(kernel, entry)
    assert len(fake.args) == len(params) == len(fake.argtypes)
    args = dict(zip(params, fake.args))
    lay = t_sparse.sparse_tile_layout(shape, w, 2, geom, cdt)
    assert (args["Z"], args["H"], args["W"]) == shape
    assert (args["TZ"], args["TM"], args["TN"]) == (geom.z_slab,
                                                    geom.strip_m, geom.w_tile)
    assert (args["t"], args["R"], args["n_rows"]) == (2, 1, 5)
    assert (args["ld"], args["plane_ld"], args["toe_ld"],
            args["smem_bytes"]) == (lay.ld, lay.plane_ld, lay.toe_ld,
                                    lay.smem_bytes)
    assert (args["B"], args["grid_elems"]) == (3, int(np.prod(shape)))
    assert (args["mode_z"], args["mode_y"], args["mode_x"]) == codes
    assert args["dtype"] == (1 if dtype == torch.bfloat16 else 0)
    assert args["compute"] == (1 if cdt == torch.bfloat16 else 0)
    if sparse:
        assert args["a_cols"] == t_sparse.band_meta(w, cdt).a_cols
    else:
        assert args["kpad"] == lay.kpad
    if staging != "region":
        assert args["stage"] == common.STAGE_CODES[staging]
