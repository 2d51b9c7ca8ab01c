"""The 2D banded kernels (``csrc/tile_fold.cuh``: K3/K6 banded, its K8 and
K10 foil builds, and K7 on 2D grids) on the CPU: their fold map
``tile_fold_tiles`` as pure Python, a numpy emulation of their dataflow
built on that map alone against the JAX package's 2D ``stencil_matmul``
and ``stencil_sparse_matmul`` in interpret mode and against the JAX
oracle, their shared-memory layout against the tile rule's bound, and the
C launch arguments the wrappers pass (parsed from the ``.cu``
signatures).  The kernels themselves build and run only on the card
(``chip_smoke.py``, ``src/repro_torch/benchmarks/fold_probe.py tile``)."""
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
from repro_torch.kernels import _build, common, legacy  # noqa: E402
from test_torch_boundary import _fill_axis  # noqa: E402
from test_torch_slab_fold import _bf16, _limit, _rows, _tf32  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")
t_sparse = importlib.import_module("repro_torch.kernels.stencil_sparse")

CSRC = pathlib.Path(common.__file__).parent / "csrc"


def _rows2d(w, cdt, sparse):
    """The bands as the 2D kernels read them: ``(0, dy, lo, nk)`` each and
    their (nk * K, 16) blocks."""
    rows, blocks = _rows(w, cdt, sparse)
    return [(0,) * (4 - len(r)) + tuple(r) for r in rows], blocks


# ---------------------------------------------------------------------------
# The fold map
# ---------------------------------------------------------------------------
MAP_TILES = [(shape, r, t) for shape in ((60, 130), (40, 100), (8192, 8192))
             for r, t in ((1, 1), (1, 4), (2, 2), (4, 1), (2, 4), (3, 4))]


@pytest.mark.parametrize("shape,r,t", MAP_TILES)
def test_tile_map_writes_each_output_once_and_reads_only_what_it_may(
        shape, r, t):
    geom = common.launch_geom(shape, t * r)
    tm, tn = geom.strip_m, geom.w_tile
    w = make_weights(JSpec("box", 2, r), seed=0)
    rows, _ = _rows2d(w, torch.float32, sparse=False)
    tiles = list(common.tile_fold_tiles(tm, tn, r, t))
    h = t * r
    ext = (1, tm + 2 * h, tn + 2 * h)
    for s in range(t):
        step = [f for f in tiles if f.step == s]
        assert step[0].extent == ext
        ho, wo = ext[1] - 2 * r, ext[2] - 2 * r
        nrt = -(-ho // 16)
        # chunk-major, then by row tile: tile j is row tile j % nrt of
        # chunk j // nrt, on warp j mod 8, in pass j // 32
        assert [(f.chunk, f.pairs[0][1] // 16) for f in step] == \
            [divmod(j, nrt) for j in range(len(step))]
        assert len(step) == nrt * -(-wo // 16)
        writes = np.zeros((ho, wo), np.int64)
        written = np.zeros(ext[1:], bool)   # cells earlier passes wrote
        for pss, group in itertools.groupby(step, key=lambda f: f.pass_):
            group = list(group)
            assert len(group) <= common.SLAB_PASS_TILES
            assert [f.warp for f in group] == [j % 8 for j in range(len(group))]
            per_warp = np.bincount([f.warp for f in group], minlength=8)
            assert per_warp.max() <= common.SLAB_TILES_PER_WARP
            for f in group:
                c = f.chunk
                assert f.cols == (16 * c, min(16 * c + 16, wo))
                assert f.kv == min(16 + 2 * r, ext[2] - 16 * c)
                for z, y, a, v, e in f.reads(rows, 8):
                    assert z == 0 and 0 <= y < ext[1]
                    assert a >= 16 * c and v <= ext[2]      # loaded cells
                    assert not written[y, a:v].any()        # ... still inputs
            for f in group:                 # the pass stores after its reads
                for (_, y), keep in zip(f.pairs, f.stored):
                    if keep:
                        writes[y, f.cols[0]:f.cols[1]] += 1
                        written[y, f.cols[0]:f.cols[1]] = True
        assert (writes == 1).all()
        ext = (1, ho, wo)


@pytest.mark.parametrize("shape,halo,batch", [((60, 130), 4, 3),
                                              ((40, 100), 8, 2),
                                              ((1000, 1030), 1, 1)])
def test_tile_map_covers_every_grid_of_a_batch_once(shape, halo, batch):
    # every CTA of every grid runs the map on its own region; the last
    # step's stored rows are the tile, which the store clips to the grid
    geom = common.launch_geom(shape, halo)
    tm, tn = geom.strip_m, geom.w_tile
    tile = np.zeros((tm, tn), np.int64)
    for f in common.tile_fold_tiles(tm, tn, halo, 1):
        for (_, y), keep in zip(f.pairs, f.stored):
            tile[y, f.cols[0]:f.cols[1]] += keep
    assert (tile == 1).all()
    hits = np.zeros((batch,) + shape, np.int64)
    for b in range(batch):
        for win in common.tile_windows(shape, geom):
            hits[(b,) + tuple(slice(a, c) for a, c in win[:2])] += \
                tile[tuple(slice(0, c - a) for a, c in win[:2])]
    assert (hits == 1).all()


def test_tile_map_runs_each_main_tile_step_in_one_pass_across_chunks():
    # 64 x 64 at h = 4 (Box-2D1R, t = 4): steps 0-2 run 5 row tiles of 5
    # chunks, 25 tiles in one pass on all 8 warps where the wmma kernel ran
    # one chunk's 5 tiles at a time; step 3 runs 16
    tiles = list(common.tile_fold_tiles(64, 64, 1, 4))
    per_step = [[f for f in tiles if f.step == s] for s in range(4)]
    assert [len(st) for st in per_step] == [25, 25, 25, 16]
    assert all({f.pass_ for f in st} == {0} for st in per_step)
    step0 = per_step[0]
    assert {f.chunk for f in step0} == set(range(5))
    assert [f.warp for f in step0[:9]] == list(range(8)) + [0]
    assert step0[4].pairs[:6] == tuple((0, y) for y in range(64, 70))
    assert step0[4].stored == (True,) * 6 + (False,) * 10
    assert step0[4].pairs[6:] == ((0, 69),) * 10
    assert step0[-1].cols == (64, 70) and step0[-1].kv == 8


# ---------------------------------------------------------------------------
# The kernels' dataflow, emulated on the map alone, against JAX
# ---------------------------------------------------------------------------
def emulate_tile(x, w, t, geom, modes, cdt, sparse=False, stats=None):
    """The 2D banded kernels' dataflow on the CPU, CTA by CTA, on the map
    ``tile_fold_tiles`` alone.  The region is laid out as
    ``tile_fold_layout`` lays it out, its padding columns NaN; it loads by
    modulo indices, every out-of-domain cell of a non-periodic axis within
    the halo's depth NaN, so a cell the fill misses and a valid output
    reads shows.  Per step: the fill at depth (t-s)r; before step 0, TF32
    operands round in place; per pass, every tile's sums over the bands
    (A rows of the tile shifted by dy, from column lo of its chunk, zero
    from chunk column kv on, bf16 operands rounded at the load; the bands'
    rows rounded as the host and the staging round them), accumulated in
    f64, and only then the pass's stores, f32 (TF32-rounded for a next
    step), masked at the step's width and last row; after the step every
    cell outside its output is set to NaN, as the next step must not read
    it.  The last step's tile is stored, clipped to the grid.
    ``stats["mma"]`` counts the products of the tiles' sums: per band,
    each k-step of each n8 half of the tile's 16 columns that holds an
    output."""
    r = (w.shape[-1] - 1) // 2
    h = t * r
    k_step = common.mma_k_step(cdt.itemsize)
    tf32 = cdt == torch.float32
    rows, blocks = _rows2d(w, cdt, sparse)
    blocks = [_tf32(b) if tf32 else _bf16(b) for b in blocks]
    tm, tn = geom.strip_m, geom.w_tile
    lay = common.tile_fold_layout(tm, tn, r, t, cdt.itemsize, len(rows))
    tiles = list(common.tile_fold_tiles(tm, tn, r, t))
    y = np.full_like(x, np.nan)
    for win in common.tile_windows(x.shape, geom):
        org = [a for a, _ in win[:2]]
        reg = np.full((tm + 2 * h, lay.ld), np.nan, np.float32)
        reg[:, :tn + 2 * h] = x[np.ix_(*(np.arange(a - h, a + tl + h) % n
                                         for a, tl, n in zip(
                                             org, (tm, tn), x.shape)))]
        for ax, (a, tl, n) in enumerate(zip(org, (tm, tn), x.shape)):
            if modes[ax] != "periodic":
                g = np.arange(a - h, a + tl + h)
                np.moveaxis(reg[:, :tn + 2 * h], ax, 0)[
                    (g < 0) | (g >= n) & (g < n + h)] = np.nan
        for s in range(t):
            o = (t - s) * r
            hin, win_ = tm + 2 * o, tn + 2 * o
            cur = reg[:hin, :win_]
            for ax, (a, n) in enumerate(zip(org, x.shape)):
                if modes[ax] != "periodic":
                    _fill_axis(cur, ax, a - o, n, o, modes[ax])
            if tf32 and s == 0:
                cur[...] = _tf32(cur)
            step = [f for f in tiles if f.step == s]
            for _, group in itertools.groupby(step, key=lambda f: f.pass_):
                sums = []
                for f in group:
                    ys = np.array([yy for _, yy in f.pairs])
                    c0 = f.cols[0]
                    acc = np.zeros((16, 16))
                    for (_, dy, lo, nk), blk in zip(rows, blocks):
                        cols = c0 + lo + np.arange(nk * k_step)
                        a = reg[(ys + dy)[:, None], np.minimum(cols, lay.ld - 1)]
                        a = np.where(cols - c0 < f.kv, a, 0.0)
                        if not tf32:
                            a = _bf16(a)
                        acc += a.astype(np.float64) @ blk.astype(np.float64)
                        if stats is not None:
                            stats["mma"] += nk * (1 + (f.cols[1] - c0 > 8))
                    out = acc.astype(np.float32)
                    sums.append((f, ys, _tf32(out) if tf32 and s + 1 < t else out))
                for f, ys, out in sums:
                    keep = np.array(f.stored)
                    c0, c1 = f.cols
                    reg[ys[keep], c0:c1] = out[keep][:, :c1 - c0]
            ho, wo = hin - 2 * r, win_ - 2 * r
            reg[ho:] = np.nan
            reg[:, wo:] = np.nan
        dst = tuple(slice(a, c) for a, c in win[:2])
        y[dst] = reg[tuple(slice(0, c - a) for a, c in win[:2])]
    return y


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("kind,r,t,boundary,cdt", [
    ("box", 1, 4, None, torch.float32),
    ("star", 2, 2, ("reflect", "replicate"), torch.float32),
    ("star", 1, 2, "zero", torch.bfloat16)])
def test_tile_emulation_matches_jax_in_interpret_mode(sparse, kind, r, t,
                                                      boundary, cdt):
    # 40 x 67 on a pinned 16 x 16 tile: ragged on both axes
    shape = (40, 67)
    w = make_weights(JSpec(kind, 2, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=shape).astype(np.float32)
    geom = common.launch_geom(shape, t * r, tile_m=16, w_tile=16)
    modes = common.resolve_boundary(boundary, 2)
    y = emulate_tile(x, w, t, geom, modes, cdt, sparse)
    assert np.isfinite(y).all()
    jdt = jnp.bfloat16 if cdt == torch.bfloat16 else None
    ref = (jsp.stencil_sparse_matmul(jnp.asarray(x), w, t, tile_n=16,
                                     interpret=True, boundary=boundary,
                                     compute_dtype=jdt)
           if sparse else
           j_matmul(jnp.asarray(x), w, t, interpret=True, boundary=boundary,
                    compute_dtype=jdt))
    np.testing.assert_allclose(y, np.asarray(ref, np.float32), rtol=0,
                               atol=_limit(x, w, t, cdt))


ORACLE_CASES = [(kind, r, t, bc, sparse)
                for kind in ("box", "star") for r in (1, 2) for t in (1, 2, 4)
                for bc in (None, ("replicate", "reflect"))
                for sparse in (False, True)]


@pytest.mark.parametrize("kind,r,t,boundary,sparse", ORACLE_CASES)
def test_tile_emulation_matches_the_jax_oracle(kind, r, t, boundary, sparse):
    # 37 x 70: ragged on both axes and, at small h, shallower than the
    # tile rule's 64-row tile
    shape = (37, 70)
    w = make_weights(JSpec(kind, 2, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=shape).astype(np.float32)
    geom = common.launch_geom(shape, t * r)
    modes = common.resolve_boundary(boundary, 2)
    y = emulate_tile(x, w, t, geom, modes, torch.float32, sparse)
    ref = np.asarray(j_ref(jnp.asarray(x), w, t, boundary=boundary))
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=_limit(x, w, t, torch.float32))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("boundary", [None, "zero", "reflect",
                                      ("periodic", "replicate")])
def test_tile_emulation_in_bf16_matches_the_jax_oracle(sparse, boundary):
    shape = (37, 70)
    w = make_weights(JSpec("star", 2, 1), seed=5)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    geom = common.launch_geom(shape, 2)
    modes = common.resolve_boundary(boundary, 2)
    y = emulate_tile(x, w, 2, geom, modes, torch.bfloat16, sparse)
    ref = np.asarray(j_ref(jnp.asarray(x), w, 2, boundary=boundary))
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=_limit(x, w, 2, torch.bfloat16))


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_tile_emulation_of_the_compacted_bands_equals_the_dense_one(cdt):
    # on box and star kernels the compacted products are the dense ones
    shape = (37, 70)
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    for kind, r, bc in (("box", 1, None), ("star", 1, None),
                        ("star", 2, ("zero", "reflect"))):
        w = make_weights(JSpec(kind, 2, r), seed=3)
        geom = common.launch_geom(shape, 2 * r)
        modes = common.resolve_boundary(bc, 2)
        dense = emulate_tile(x, w, 2, geom, modes, cdt, False)
        sparse = emulate_tile(x, w, 2, geom, modes, cdt, True)
        np.testing.assert_array_equal(dense, sparse)


# ---------------------------------------------------------------------------
# The shared-memory layout
# ---------------------------------------------------------------------------
LAYOUT_GRIDS = ((8192, 8192), (1000, 1030), (60, 130), (37, 70), (1, 2**20),
                (5, 7))


@pytest.mark.parametrize("halo", range(1, 25))
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_tile_layout_fits_under_the_tile_rule_at_every_plan_tile(halo, cdt):
    # every (R, t) with t R = halo, the composed box's 2R + 1 bands (the
    # most a kernel of that radius has), at the tile the rule picks for
    # each grid: under the 227 KB budget
    for shape in LAYOUT_GRIDS:
        g = common.resolve_tile_geom(shape, halo)
        tm, tn = g.strip_m, g.w_tile
        bound = common.SMEM_BUDGET_BYTES
        for t in (t for t in range(1, halo + 1) if halo % t == 0):
            r = halo // t
            w = make_weights(JSpec("box", 2, r), seed=0)
            lay = common.tile_fold_layout(tm, tn, r, t, cdt.itemsize, 2 * r + 1)
            assert lay.smem_bytes <= bound <= common.SMEM_BUDGET_BYTES
            assert (lay.planes, lay.rows) == (1, tm + 2 * halo)
            assert lay.ld >= tn + 2 * halo and lay.ld % 8 == 4
            assert lay.toe_ld == lay.kpad + 16 and lay.toe_ld % 8 == 0
            # ... and the compacted wrapper's layout of the same launch
            geom = common.launch_geom(shape, halo)
            assert t_sparse.sparse_tile_layout(shape, w, t, geom, cdt) == lay


def test_tile_layout_at_the_main_tile():
    # 64 x 64 at h = 4 (Box-2D1R, t = 4): a 72 x 72 region, rows 76 floats
    # apart, and three bands of 24 + 16 Toeplitz elements
    lay = common.tile_fold_layout(64, 64, 1, 4, 4, 3)
    assert (lay.rows, lay.ld, lay.toe_ld) == (72, 76, 40)
    assert lay.smem_bytes == 72 * 76 * 4 + 512 + 3 * 16 == 22448
    assert common.tile_fold_layout(64, 64, 1, 4, 2, 3).smem_bytes == 22320


@pytest.mark.parametrize("tm,tn,r,t", [(64, 64, 1, 4), (64, 64, 1, 1),
                                       (64, 128, 3, 4), (32, 64, 2, 2),
                                       (16, 16, 4, 1)])
def test_fragment_rows_hit_distinct_bank_quads_at_step_0(tm, tn, r, t):
    # the 8 rows of an A fragment are 8 consecutive rows of one chunk,
    # m * ld words apart mod 32: eight quads of banks, one per row
    lay = common.tile_fold_layout(tm, tn, r, t, 4, 2 * r + 1)
    ho = tm + 2 * (t - 1) * r
    for m0 in range(ho - 7):
        offs = [m * lay.ld for m in range(m0, m0 + 8)]
        assert len({(o % 32) // 4 for o in offs}) == 8


def test_2d_bands_are_read_as_toeplitz_rows_with_their_headers():
    # the dense operand: every band's Toeplitz row and (0, dy, 0, kpad/K);
    # the lifted 1D kernel's one band (0, 0, 0, kpad/K)
    for w, cdt, nk in ((make_weights(JSpec("box", 2, 2), seed=0),
                        torch.float32, 3),
                       (make_weights(JSpec("star", 2, 1), seed=0),
                        torch.bfloat16, 2),
                       (common.lift_weights(np.asarray(
                           make_weights(JSpec("box", 1, 3), seed=0))),
                        torch.float32, 3)):
        w = np.asarray(w, np.float32)
        offsets, bands = t_matmul.build_bands_nd(w, 16)
        k = common.mma_k_step(cdt.itemsize)
        bands = np.pad(bands, ((0, 0), (0, nk * k - bands.shape[1]), (0, 0)))
        toe, rows = t_matmul._device_toe(w.tobytes(), w.shape, cdt, "cpu")
        assert np.array_equal(toe.float().numpy(),
                              torch.from_numpy(t_matmul.toeplitz_rows(bands))
                              .to(cdt).float().numpy())
        assert rows.tolist() == [[0, o[0], 0, nk] for o in offsets]


# ---------------------------------------------------------------------------
# The sources and the C launch arguments
# ---------------------------------------------------------------------------
def test_both_2d_kernels_are_the_tile_fold():
    assert (t_matmul.kernel_source(2), t_sparse.kernel_source(2)) == \
        ("stencil_banded", "stencil_sparse")
    body = (CSRC / "tile_fold.cuh").read_text()
    for name in ("stencil_banded", "stencil_sparse"):
        src = (CSRC / f"{name}.cu").read_text()
        assert '#include "tile_fold.cuh"' in src
        assert f'extern "C" int {name}_launch(' in src
        assert f'extern "C" int {name}_ctas_per_sm(' in src
        assert "__global__" not in src and "wmma" not in src
        assert "achunk" not in src
    assert 'extern "C" int stencil_banded_foil_launch(' in \
        (CSRC / "stencil_banded.cu").read_text()
    assert '#include "slab_fold.cuh"' in body
    assert "__launch_bounds__(CTA_THREADS, TILE_MIN_BLOCKS)" in body
    assert re.search(r"#define TILE_MIN_BLOCKS [1-9]\b", body)
    assert "load_region<STAGE>" in body and "stage_band(" in body
    # no operand copy, no B fragment from global memory in the MMA loop
    for gone in ("achunk", "load_matrix_sync", "__ldg", "load_b("):
        assert gone not in body


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
                                            (False, "9tile"),
                                            (True, "region")])
@pytest.mark.parametrize("dtype,cdt", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.bfloat16)])
def test_wrappers_pass_the_tile_arguments(monkeypatch, sparse, staging, dtype,
                                          cdt):
    mod = t_sparse if sparse else t_matmul
    kernel = mod.kernel_source(2)
    entry = f"{kernel}_launch" if staging == "region" else \
        f"{kernel}_foil_launch"
    fake = _FakeLaunch()
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    launchers = [mod._launcher] + ([] if sparse else [mod._foil_launcher])
    for f in launchers:
        f.cache_clear()
    w = np.asarray(make_weights(JSpec("star", 2, 1), seed=0), np.float32)
    shape = (64, 96) if staging == "9tile" else (40, 67)
    x = torch.zeros((3,) + shape, dtype=dtype)       # a batch of 3 grids
    geom = (legacy.tile_geom(shape, 32, 32, 2) if staging == "9tile"
            else common.launch_geom(shape, 2))
    bc = ("periodic", "periodic") if staging == "9tile" else ("zero", "reflect")
    codes = common.kernel_mode_codes(bc)
    tk.reset_launch_counts()
    try:
        if sparse:
            y = mod._launch2d(x, w, 2, 1, cdt, geom, codes)
        else:
            y = mod._launch2d(x, w, 2, 1, cdt, geom, codes, staging)
    finally:
        for f in launchers:
            f.cache_clear()
        counts = tk.launch_counts()
        tk.reset_launch_counts()
    counter = kernel if staging == "region" else f"{kernel} ({staging})"
    assert y.shape == x.shape and y.dtype == dtype
    assert counts[counter] == 1 and sum(counts.values()) == 1
    params = _c_params(kernel, entry)
    assert len(fake.args) == len(params) == len(fake.argtypes)
    args = dict(zip(params, fake.args))
    lay = t_sparse.sparse_tile_layout(shape, w, 2, geom, cdt)
    assert (args["H"], args["W"]) == shape
    assert (args["TM"], args["TN"]) == (geom.strip_m, geom.w_tile)
    assert (args["t"], args["R"], args["n_rows"]) == (2, 1, 3)
    assert (args["ld"], args["toe_ld"], args["smem_bytes"]) == \
        (lay.ld, lay.toe_ld, lay.smem_bytes)
    assert (args["B"], args["grid_elems"]) == (3, int(np.prod(shape)))
    assert (args["mode_y"], args["mode_x"]) == codes
    assert args["dtype"] == (1 if dtype == torch.bfloat16 else 0)
    assert args["compute"] == (1 if cdt == torch.bfloat16 else 0)
    if sparse:
        assert args["a_cols"] == t_sparse.band_meta(w, cdt).a_cols
        _, _, rows = t_sparse._device_operand(w.tobytes(), w.shape, cdt, "cpu")
        assert args["meta"] == rows.data_ptr()
        toe = t_sparse._device_toe(w.tobytes(), w.shape, cdt, "cpu")
    else:
        assert args["kpad"] == lay.kpad
        toe, rows = t_matmul._device_toe(w.tobytes(), w.shape, cdt, "cpu")
        assert args["rows"] == rows.data_ptr()
    assert args["toe"] == toe.data_ptr() and toe.dtype == cdt
    assert toe.shape == (3, lay.toe_ld)
    if staging != "region":
        assert args["stage"] == common.STAGE_CODES[staging]
