"""The folded 1D banded kernels (``csrc/line_fold.cuh``: K3 and K7 on 1D
grids) on the CPU: their row map ``line_windows`` as pure Python, a numpy
emulation of their dataflow built on that map alone against the JAX
package's 1D ``stencil_matmul`` and ``stencil_sparse_matmul`` in
interpret mode, their shared-memory layout, and the C launch arguments
the wrappers pass (parsed from the ``.cu`` signatures).  The kernels
themselves build and run only on the card (``chip_smoke.py``)."""
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
from repro.kernels.stencil_matmul import stencil_matmul as j_matmul  # noqa
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.audit import scratch  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")
t_sparse = importlib.import_module("repro_torch.kernels.stencil_sparse")

L, TM = 64, common.LINE_ROWS


# ---------------------------------------------------------------------------
# The row map
# ---------------------------------------------------------------------------
def _check_cover(n, geom, batch=1):
    """Every point of every line of the batch is one row's output exactly
    once; each row reads [q - h, q + L + h); a CTA tile's rows lie in one
    line, consecutive, and start at its TM * L-aligned first output."""
    wt, h = geom.w_tile, geom.w_block
    hits = np.zeros((batch, n), dtype=np.int64)
    tiles = {}
    for b, tile, row, (o0, o1), (r0, r1) in common.line_windows(n, geom,
                                                                batch):
        assert 0 <= o0 < o1 <= n and o1 - o0 <= wt
        assert (r0, r1) == (o0 - h, o0 + wt + h)
        assert o0 == (tile * TM + row) * wt
        hits[b, o0:o1] += 1
        tiles.setdefault((b, tile), []).append(row)
    assert (hits == 1).all()
    assert len({t for _, t in tiles}) == common.line_tiles(n, geom)
    for rows in tiles.values():
        assert rows == list(range(len(rows)))


def test_line_windows_cover_every_short_line_once():
    geom = common.launch_geom((L * TM,), 4)
    assert geom.w_tile == L
    for n in range(1, L * TM + 4):
        _check_cover(n, geom)


@pytest.mark.parametrize("n,batch,halo", [(2**20 + 3, 1, 4), (2**20 + 3, 3, 4),
                                          (L * TM + 3, 5, 12), (67, 8, 1)])
def test_line_windows_cover_long_lines_and_batches(n, batch, halo):
    _check_cover(n, common.launch_geom((n,), halo), batch)


@pytest.mark.parametrize("n,halo,w_tile", [(67, 4, None), (2**20 + 3, 4, None),
                                           (1100, 2, 16), (L * TM + 3, 8, 32)])
def test_fold_rows_are_the_lifted_tiles(n, halo, w_tile):
    # row i of CTA tile k is the lifted kernel's tile k * TM + i: the same
    # outputs and the same read window, so the same chunks
    geom = common.launch_geom((n,), halo, w_tile=w_tile)
    lifted = [(c, p) for _, c, _, p in common.tile_windows((1, n), geom)]
    fold = [(o, r) for *_, o, r in common.line_windows(n, geom)]
    assert fold == lifted


# ---------------------------------------------------------------------------
# The kernels' dataflow, emulated on the map alone, against JAX
# ---------------------------------------------------------------------------
def _fill_line(win, g0, n, o, mode):
    """csrc/line_fold.cuh::fill_line on a numpy row window: cell c is
    global cell g0 + c; the cells below the line and above it within
    depth o are rebuilt from the window's in-domain cells."""
    lo, hb, he = min(len(win), max(0, -g0)), n - g0, min(len(win), n + o - g0)
    for c in itertools.chain(range(lo), range(hb, he)):
        g = g0 + c
        if mode == "zero":
            win[c] = 0.0
        else:
            gs = ((0 if g < 0 else n - 1) if mode == "replicate"
                  else (-g if g < 0 else 2 * (n - 1) - g))
            win[c] = win[gs - g0]


def emulate_fold(x, w, t, geom, mode, stats=None):
    """The folded kernels' dataflow on the CPU, row by row of
    ``line_windows``: the row's window by modulo indices -- every cell
    outside the line NaN under a non-periodic mode, so a cell the fill
    misses and a valid output reads shows -- then per step the fill at
    depth (t-s)R with the window's origin at q - (t-s)R and a shrinking
    valid correlation of the 1D kernel, and the row's outputs stored.
    ``stats["chunks"]`` counts the 16-column output chunks of every row's
    steps."""
    n, r = x.shape[0], (w.shape[0] - 1) // 2
    y = np.full_like(x, np.nan)
    for _, _, _, (o0, o1), (r0, r1) in common.line_windows(n, geom):
        g = np.arange(r0, r1)
        win = x[g % n].astype(np.float64)
        if mode != "periodic":
            win[(g < 0) | (g >= n)] = np.nan
        for s in range(t):
            if mode != "periodic":
                _fill_line(win, o0 - (t - s) * r, n, (t - s) * r, mode)
            out = np.zeros(len(win) - 2 * r)
            if stats is not None:
                stats["chunks"] += -(-len(out) // 16)
            for dx in range(2 * r + 1):
                if w[dx]:
                    out += w[dx] * win[dx:dx + len(out)]
            win = out
        y[o0:o1] = win[:o1 - o0]
    return y


FOLD_CASES = [(mode, r, t) for mode in ("periodic", "zero", "reflect",
                                        "replicate")
              for r in (1, 2) for t in (1, 4)]


@pytest.mark.parametrize("mode,r,t", FOLD_CASES)
def test_fold_emulation_matches_jax(mode, r, t):
    # 1100 points on 16-wide rows: two CTA tiles, the second ragged
    n = 1100
    w = make_weights(JSpec("box", 1, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=n).astype(np.float32)
    geom = common.launch_geom((n,), t * r, w_tile=16)
    assert common.line_tiles(n, geom) == 2
    y = emulate_fold(x, w, t, geom, mode)
    assert np.isfinite(y).all()
    bc = None if mode == "periodic" else mode
    tol = t * 2.0**-10 * float(np.abs(w).sum()) * float(np.abs(x).max())
    for ref in (j_matmul(jnp.asarray(x), w, t, interpret=True, boundary=bc),
                jsp.stencil_sparse_matmul(jnp.asarray(x), w, t, tile_n=16,
                                          interpret=True, boundary=bc)):
        np.testing.assert_allclose(y, np.asarray(ref), rtol=0, atol=tol)


def test_fold_emulation_on_the_plan_tile_matches_jax():
    # the plan's own 64-wide rows at t=4: two CTA tiles of 4096 points
    n, t = L * TM + 67, 4
    w = make_weights(JSpec("star", 1, 1), seed=3)
    x = np.random.default_rng(5).normal(size=n).astype(np.float32)
    geom = common.launch_geom((n,), t)
    y = emulate_fold(x, w, t, geom, "reflect")
    ref = np.asarray(j_matmul(jnp.asarray(x), w, t, interpret=True,
                              boundary="reflect"))
    tol = t * 2.0**-10 * float(np.abs(w).sum()) * float(np.abs(x).max())
    np.testing.assert_allclose(y, ref, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The shared-memory layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r,t", [(1, 1), (1, 4), (4, 1), (3, 4), (2, 4),
                                 (12, 1), (24, 1)])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_line_layout_fits_at_the_plan_tiles(r, t, in_dtype, cdt):
    geom = common.launch_geom((2**26,), t * r)
    lay = t_matmul.line_launch_layout(geom, r, t, in_dtype, cdt, "1D")
    ib, h = in_dtype.itemsize, t * r
    checks = scratch.audit_layout("line_fold", geom, r, t, lay, ib,
                                  cdt.itemsize)
    assert all(c.passed for c in checks), [c.to_dict() for c in checks]
    gran = 16 // ib
    assert lay.rows == TM and lay.smem_bytes <= common.SMEM_BUDGET_BYTES
    # the staged window, from its first cell's 16-byte granule on
    assert lay.lds % gran == 0 and lay.lds >= geom.w_tile + 2 * h + gran - 1
    # the step-0 outputs in whole 16-column chunks
    assert lay.ld >= -(-(geom.w_tile + 2 * (t - 1) * r) // 16) * 16
    # strides 4 mod 8 words: the 8 rows of an A fragment in 8 bank quads
    assert (lay.lds * ib // 4) % 8 == 4 and lay.ld % 8 == 4
    assert lay.stage_bytes % 128 == 0 and lay.warp_bytes % 128 == 0
    if ib == 4:     # f32 lines run their steps in place in the staging
        assert lay.lds >= lay.ld and lay.warp_bytes >= 2 * 16 * lay.lds * 4
    else:           # ... bf16 ones in an f32 region beside it
        assert lay.warp_bytes >= 2 * 16 * lay.lds * ib + 16 * lay.ld * 4
    assert lay.smem_bytes >= common.LINE_WARPS * lay.warp_bytes
    assert lay.kpad == -(-(16 + 2 * r) // common.mma_k_step(cdt.itemsize)) \
        * common.mma_k_step(cdt.itemsize)
    # ... and it is the compacted kernel's layout of the same launch
    w = make_weights(JSpec("box", 1, r), seed=0)
    assert t_sparse.sparse_tile_layout((2**26,), w, t, geom, cdt,
                                       in_dtype) == lay


def test_line_layout_raises_past_the_budget_and_the_depth():
    # a tile the lift's rule would refuse already, held to the budget here
    wide = common.SubstrateGeom(dim=2, strip_m=16, h_block=4, w_tile=2048,
                                w_block=4)
    with pytest.raises(ValueError, match="227 KB"):
        t_matmul.line_launch_layout(wide, 1, 4, torch.float32,
                                    torch.float32, "1D banded")
    # depth 66 (R = 25, padded to 72): past one unrolled piece, the dense
    # kernel takes it in pieces, and its dataflow matches JAX; the
    # compacted kernel stays within MAX_KPAD and refuses it
    deep = common.SubstrateGeom(dim=2, strip_m=16, h_block=25, w_tile=64,
                                w_block=25)
    lay = t_matmul.line_launch_layout(deep, 25, 1, torch.float32,
                                      torch.float32, "1D banded")
    assert lay.kpad == 72 > t_matmul.MAX_KPAD
    with pytest.raises(ValueError, match="contraction depth"):
        t_matmul.line_launch_layout(deep, 25, 1, torch.float32,
                                    torch.float32, "1D compacted banded",
                                    deep=False)
    n = 1100
    w = make_weights(JSpec("box", 1, 25), seed=1)
    x = np.random.default_rng(2).normal(size=n).astype(np.float32)
    geom = common.launch_geom((n,), 25, w_tile=64, need=common.fold_need(
        1, 25, 1, 4, 4, 1, "fused_matmul"))
    y = emulate_fold(x, w, 1, geom, "zero")
    ref = np.asarray(j_matmul(jnp.asarray(x), w, 1, interpret=True,
                              boundary="zero"))
    tol = 2.0**-10 * float(np.abs(w).sum()) * float(np.abs(x).max())
    np.testing.assert_allclose(y, ref, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The sources and the C launch arguments
# ---------------------------------------------------------------------------
def test_kernel_source_names_the_folded_libraries():
    assert t_matmul.kernel_source(1) == "stencil_banded1d"
    assert t_sparse.kernel_source(1) == "stencil_sparse1d"
    assert (t_matmul.kernel_source(2), t_sparse.kernel_source(3)) == \
        ("stencil_banded", "stencil_sparse3d")
    csrc = pathlib.Path(common.__file__).parent / "csrc"
    for name in ("stencil_banded1d", "stencil_sparse1d"):
        assert name in _build.KERNELS and name in _build.COUNTERS
        src = (csrc / f"{name}.cu").read_text()
        assert '#include "line_fold.cuh"' in src
        assert f'extern "C" int {name}_launch(' in src
    body = (csrc / "line_fold.cuh").read_text()
    assert "mma.sync" in (csrc / "sparse_mma.cuh").read_text()
    assert "cp.async" in body and "__launch_bounds__(LINE_THREADS" in body
    for name, value in (("LINE_WARPS", common.LINE_WARPS),
                        ("LINE_TILE_ROWS", common.LINE_TILE_ROWS)):
        assert re.search(rf"#define {name} {value}\b", body)


def _c_params(kernel: str) -> list:
    src = (pathlib.Path(common.__file__).parent / "csrc" /
           f"{kernel}.cu").read_text()
    sig = re.search(rf'extern "C" int {kernel}_launch\((.*?)\)', src,
                    re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


class _FakeLaunch:
    def __init__(self):
        self.argtypes = self.restype = self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("mode", ["periodic", "reflect"])
@pytest.mark.parametrize("dtype,cdt", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.bfloat16)])
def test_wrappers_pass_the_line_arguments(monkeypatch, sparse, mode, dtype,
                                          cdt):
    mod = t_sparse if sparse else t_matmul
    kernel = mod.kernel_source(1)
    fake = _FakeLaunch()
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    mod._launcher1d.cache_clear()
    w = np.asarray(make_weights(JSpec("box", 1, 1), seed=0), np.float32)
    x = torch.zeros((3, 1000), dtype=dtype)         # a batch of 3 lines
    geom = common.launch_geom((1000,), 2)
    code = common.BOUNDARY_CODES[mode]
    tk.reset_launch_counts()
    try:
        y = mod._launch1d(x, w, 2, 1, cdt, geom, code)
    finally:
        mod._launcher1d.cache_clear()
        counts = tk.launch_counts()
        tk.reset_launch_counts()
    assert y.shape == x.shape and y.dtype == dtype
    assert counts[kernel] == 1 and sum(counts.values()) == 1
    params = _c_params(kernel)
    assert len(fake.args) == len(params) == len(fake.argtypes)
    args = dict(zip(params, fake.args))
    lay = t_matmul.line_launch_layout(geom, 1, 2, dtype, cdt, "1D")
    assert (args["N"], args["L"], args["TM"], args["t"], args["R"]) == \
        (1000, geom.w_tile, TM, 2, 1)
    assert (args["lds"], args["ld"], args["stage_bytes"], args["warp_bytes"],
            args["smem_bytes"]) == (lay.lds, lay.ld, lay.stage_bytes,
                                    lay.warp_bytes, lay.smem_bytes)
    assert (args["B"], args["grid_elems"], args["mode_x"]) == (3, 1000, code)
    assert args["dtype"] == (1 if dtype == torch.bfloat16 else 0)
    assert args["compute"] == (1 if cdt == torch.bfloat16 else 0)
    if sparse:
        ((lo, nk),) = t_sparse.band_meta(w, cdt).rows
        assert (args["lo"], args["nk"]) == (lo, nk)
    else:
        assert args["kpad"] == lay.kpad
