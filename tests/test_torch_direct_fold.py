"""The folded 1D tap-sum (``csrc/stencil_direct1d.cu``: K2 on 1D grids,
with its fill and batch forms) on the CPU: its segment map
``line_segments`` as pure Python, a numpy emulation of the kernel's
dataflow built on that map and its layout alone (staging from the 16-byte
granule, NaN in every cell the kernel never writes, groups of 4 outputs
from a 12-cell window, the fill at depth (t - s) R) against the JAX
package's 1D ``stencil_direct`` in interpret mode, its shared-memory
layout, and the C launch arguments the wrapper passes (parsed from the
``.cu`` signature).  The kernel itself builds and runs only on the card
(``chip_smoke.py``)."""
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

from repro.kernels.stencil_direct import stencil_direct as j_direct  # noqa
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.audit import scratch  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_direct = importlib.import_module("repro_torch.kernels.stencil_direct")

TM = common.LINE_ROWS
#: Every halo the plans' tap-sum launches take at r <= 3 and t <= 4, and
#: two deeper ones.
HALOS = (1, 2, 3, 4, 6, 8, 9, 12, 16, 24)


# ---------------------------------------------------------------------------
# The segment map
# ---------------------------------------------------------------------------
def _check_segments(n, geom, batch=1):
    """Every point of every line is one segment's output exactly once; a
    segment is LINE_ROWS tiles of w_tile outputs from a multiple of that,
    and reads [out0 - h, out1 + h); its outputs are the rows of the folded
    banded kernels' CTA tile of the same index."""
    s, h = TM * geom.w_tile, geom.w_block
    hits = np.zeros((batch, n), dtype=np.int64)
    segs = list(common.line_segments(n, geom, batch))
    for b, seg, (o0, o1), (r0, r1) in segs:
        assert o0 == seg * s and 0 <= o0 < o1 <= min(o0 + s, n)
        assert o1 == min(o0 + s, n) and (r0, r1) == (o0 - h, o1 + h)
        hits[b, o0:o1] += 1
    assert (hits == 1).all()
    assert len(segs) == batch * common.line_tiles(n, geom)
    rows = {}
    for b, tile, _, (o0, o1), _ in common.line_windows(n, geom, batch):
        lo, hi = rows.get((b, tile), (o0, o1))
        rows[(b, tile)] = (min(lo, o0), max(hi, o1))
    assert rows == {(b, seg): out for b, seg, out, _ in segs}


def test_line_segments_cover_every_short_line_once():
    geom = common.launch_geom((4096,), 4, w_tile=16)
    assert TM * geom.w_tile == 1024
    for n in range(1, 1024 + 4):
        _check_segments(n, geom)


@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("n,batch", [(67, 1), (1000, 3), (4096 * 3 + 1, 2),
                                     (2**20 + 3, 1), (2**20, 8)])
def test_line_segments_cover_long_lines_and_batches(n, batch, halo):
    geom = common.launch_geom((n,), halo)
    assert geom.w_block == halo
    _check_segments(n, geom, batch)


# ---------------------------------------------------------------------------
# The kernel's dataflow, emulated on the map and the layout, against JAX
# ---------------------------------------------------------------------------
def _fill_line(win, g0, n, o, mode):
    """csrc/line_stage.cuh::fill_line on a numpy window: cell c is global
    cell g0 + c; the cells below the line and above it within depth o
    are rebuilt from the window's in-domain cells."""
    lo, hb, he = min(len(win), max(0, -g0)), n - g0, min(len(win), n + o - g0)
    for c in itertools.chain(range(lo), range(hb, he)):
        g = g0 + c
        if mode == "zero":
            win[c] = 0.0
        else:
            gs = ((0 if g < 0 else n - 1) if mode == "replicate"
                  else (-g if g < 0 else 2 * (n - 1) - g))
            win[c] = win[gs - g0]


class _Buffer:
    """A shared-memory buffer of the layout: ``size`` cells, NaN until
    written, cell c of the window at index ``front + c`` (the 16 bytes the
    kernel keeps before cell 0); every access is checked against both
    ends."""

    def __init__(self, size, front):
        self.a = np.full(size, np.nan)
        self.front = front

    def at(self, lo, hi):
        assert 0 <= self.front + lo and self.front + hi <= len(self.a), \
            (lo, hi, self.front, len(self.a))
        return self.a[self.front + lo:self.front + hi]


def _step(src, dst, w, r, lo, hi, stats=None):
    """One step of csrc/stencil_direct1d.cu::direct1d_step: groups of 4
    outputs from ``lo`` rounded down to a multiple of 4 below ``hi``, each
    from the 12 cells [c - 4, c + 8), taps in ascending dx, zero taps
    skipped (``stats["fma"]`` counts their FMAs)."""
    for c in range(lo & ~3, hi, 4):
        v = src.at(c - 4, c + 8)
        acc = np.zeros(4)
        for dx in range(2 * r + 1):
            if w[dx] != 0.0:
                acc = acc + float(w[dx]) * v[4 + dx - r:8 + dx - r]
                if stats is not None:
                    stats["fma"] += 4
        dst.at(c, c + 4)[:] = acc


def emulate_direct1d(x, w, t, geom, mode, in_bytes=4, stats=None):
    """The folded tap-sum on the CPU, segment by segment of
    ``line_segments``, on the buffers of ``direct1d_layout``: the window
    staged in 16-byte granules from the granule that holds its first cell
    (line b of the batch starts (b N) mod G cells into a granule) -- every
    cell outside the line NaN under a non-periodic mode, so a cell the
    fill misses and a valid output reads shows -- then per step the fill
    at depth (t - s) R when the window leaves the line, the step between
    the two f32 buffers (a float32 line's staging buffer is the second),
    and the segment's outputs read at cell sh + h.  ``stats["fma"]``
    counts the FMAs the steps issue."""
    xs = np.asarray(x, dtype=np.float64).reshape(-1, x.shape[-1])
    batch, n = xs.shape
    r = (len(w) - 1) // 2
    h = t * r
    lay = common.direct1d_layout(geom.w_tile, h, in_bytes)
    g = 16 // in_bytes
    y = np.full_like(xs, np.nan)
    for b, _, (p0, p1), (r0, r1) in common.line_segments(n, geom, batch):
        assert (r0, r1) == (p0 - h, p1 + h)
        nv = p1 - p0
        sh = ((b * n) % g - h) % g
        base = p0 - h - sh
        assert (b * n + base) % g == 0      # whole granules: cp.async
        stage = _Buffer(lay.lds, g)
        for f in range(-(-(sh + nv + 2 * h) // g)):
            cells = np.arange(base + f * g, base + (f + 1) * g)
            vals = xs[b, cells % n]
            if mode != "periodic":
                vals = np.where((cells < 0) | (cells >= n), np.nan, vals)
            stage.at(f * g, (f + 1) * g)[:] = vals
        ping = _Buffer(lay.ld, 4)
        pong = stage if in_bytes == 4 else _Buffer(lay.ld, 4)
        assert lay.smem_bytes >= 2 * lay.stage_bytes + (
            1 if in_bytes == 4 else 2) * lay.work_bytes
        cur = stage
        for s in range(t):
            o = (t - s) * r
            win = nv + 2 * o
            if mode != "periodic" and (p0 - o < 0 or p0 - o + win > n):
                _fill_line(cur.at(sh + s * r, sh + s * r + win), p0 - o, n,
                           o, mode)
            nxt = ping if cur is not ping else pong
            _step(cur, nxt, w, r, sh + (s + 1) * r, sh + h + nv + o - r,
                  stats)
            cur = nxt
        y[b, p0:p1] = cur.at(sh + h, sh + h + nv)
    return y.reshape(x.shape)


def _tol(x, w, t):
    """f32 sums in another order than JAX's: t steps of 2^-20 of the
    largest partial sum, Σ|w|^s max|x| at step s."""
    sw = float(np.abs(w).sum())
    return t * 2.0**-20 * max(1.0, sw) ** t * float(np.abs(x).max())


FOLD_CASES = [(mode, r, t) for mode in ("periodic", "zero", "reflect",
                                        "replicate")
              for r in (1, 2, 3) for t in (1, 4)]


@pytest.mark.parametrize("mode,r,t", FOLD_CASES)
def test_fold_emulation_matches_jax(mode, r, t):
    # 1101 points on 16-wide tiles: two segments of 1024, the second
    # ragged; a batch of the same line twice, the second starting one
    # cell into its granule, so both granule shifts run
    n = 1101
    w = make_weights(JSpec("box", 1, r), seed=r + t)
    x = np.random.default_rng(t).normal(size=n).astype(np.float32)
    geom = common.launch_geom((n,), t * r, w_tile=16)
    assert common.line_tiles(n, geom) == 2
    y = emulate_direct1d(np.stack([x, x]), w, t, geom, mode)
    assert np.isfinite(y).all()
    bc = None if mode == "periodic" else mode
    ref = np.asarray(j_direct(jnp.asarray(x), w, t, interpret=True,
                              boundary=bc))
    for row in y:
        np.testing.assert_allclose(row, ref, rtol=0, atol=_tol(x, w, t))


@pytest.mark.parametrize("mode", ["periodic", "reflect"])
def test_fold_emulation_on_the_plan_tile_matches_jax(mode):
    # the plan's own 64-wide tiles at t=4: two segments of 4096 points,
    # the second 67 long, the taps with zeros the kernel skips
    n, t = 4096 + 67, 4
    w = make_weights(JSpec("box", 1, 2), seed=3)
    w[1] = w[3] = 0.0
    x = np.random.default_rng(5).normal(size=n).astype(np.float32)
    geom = common.launch_geom((n,), 2 * t)
    assert geom.w_tile == 64
    y = emulate_direct1d(x, w, t, geom, mode)
    bc = None if mode == "periodic" else mode
    ref = np.asarray(j_direct(jnp.asarray(x), w, t, interpret=True,
                              boundary=bc))
    np.testing.assert_allclose(y, ref, rtol=0, atol=_tol(x, w, t))


@pytest.mark.parametrize("n,mode,r,t", [(67, "periodic", 3, 4),
                                        (67, "reflect", 3, 4),
                                        (5, "zero", 1, 4),
                                        (2, "replicate", 1, 4),
                                        (3, "periodic", 3, 1)])
def test_fold_emulation_on_lines_shorter_than_the_halo(n, mode, r, t):
    # one segment far longer than the line; windows that wrap the line
    # (periodic) or whose fills span most of it
    w = make_weights(JSpec("box", 1, r), seed=1)
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    geom = common.launch_geom((n,), t * r)
    y = emulate_direct1d(np.stack([x, x, x]), w, t, geom, mode)
    bc = None if mode == "periodic" else mode
    ref = np.asarray(j_direct(jnp.asarray(x), w, t, interpret=True,
                              boundary=bc))
    for row in y:
        np.testing.assert_allclose(row, ref, rtol=0, atol=_tol(x, w, t))


@pytest.mark.parametrize("mode", ["periodic", "zero", "reflect", "replicate"])
@pytest.mark.parametrize("r,t", [(1, 4), (3, 1), (2, 4)])
def test_fold_emulation_of_a_bf16_line_matches_the_plain_version(mode, r, t):
    # bfloat16 lines stage in 8-cell granules: three lines of 1003 start
    # 0, 3 and 6 cells into theirs; the sums run in f32 from the staged
    # values and round once, as the plain version does
    n = 1003
    w = make_weights(JSpec("box", 1, r), seed=2)
    xb = torch.from_numpy(np.random.default_rng(r).normal(size=(3, n))
                          .astype(np.float32)).to(torch.bfloat16)
    geom = common.launch_geom((n,), t * r, w_tile=16)
    y = emulate_direct1d(xb.float().numpy(), w, t, geom, mode, in_bytes=2)
    assert np.isfinite(y).all()
    got = torch.from_numpy(y).float().to(torch.bfloat16).float()
    bc = None if mode == "periodic" else mode
    for b in range(3):
        want = t_direct.stencil_direct_plain(xb[b], w, t, bc).float()
        # one bf16 ulp of the output where the f32 sums round apart
        tol = 2.0**-7 * float(want.abs().max())
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=0,
                                   atol=tol)


# ---------------------------------------------------------------------------
# The shared-memory layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r,t", [(1, 1), (1, 4), (2, 4), (3, 1), (3, 4),
                                 (3, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_direct1d_layout_fits_at_the_plan_tiles(r, t, dtype):
    h = t * r
    geom = common.launch_geom((2**26,), h)
    lay = common.direct1d_layout(geom.w_tile, h, dtype.itemsize)
    ib = dtype.itemsize
    checks = scratch.audit_layout("tapsum1d", geom, r, t, lay, ib)
    assert all(c.passed for c in checks), [c.to_dict() for c in checks]
    assert lay.seg == TM * geom.w_tile
    assert lay.smem_bytes <= common.SMEM_BUDGET_BYTES
    # the window from its granule's first cell, and the read past it
    span = lay.seg + 2 * h + common.DIRECT1D_SLACK
    assert lay.lds >= 16 // ib + span and lay.ld >= 4 + span
    assert lay.stage_bytes >= lay.lds * ib and lay.work_bytes >= lay.ld * 4
    assert lay.stage_bytes % 128 == 0 and lay.work_bytes % 128 == 0
    if ib == 4:     # the staging buffer is the second step buffer
        assert lay.lds >= lay.ld
        assert lay.smem_bytes == 2 * lay.stage_bytes + lay.work_bytes
    else:
        assert lay.smem_bytes == 2 * lay.stage_bytes + 2 * lay.work_bytes
    # at the main path's tile, four CTAs share an SM (228 KB, 1 KB each
    # reserved)
    if h <= 12:
        assert 4 * (lay.smem_bytes + 1024) <= 228 * 1024


def test_direct1d_layout_raises_past_the_budget():
    # a tile the lift's rule would refuse already, held to the budget here
    wide = common.SubstrateGeom(dim=2, strip_m=16, h_block=4, w_tile=2048,
                                w_block=4)
    x = torch.zeros((1, 100000))
    with pytest.raises(ValueError, match="227 KB"):
        t_direct._launch1d(x, np.ones(3, np.float32) / 3, 4, 1, wide, 0)


# ---------------------------------------------------------------------------
# The source and the C launch arguments
# ---------------------------------------------------------------------------
CSRC = pathlib.Path(common.__file__).parent / "csrc"


def test_kernel_source_names_the_folded_library():
    assert t_direct.kernel_source(1) == "stencil_direct1d"
    assert (t_direct.kernel_source(2), t_direct.kernel_source(3)) == \
        ("stencil_direct", "stencil_direct3d")
    assert "stencil_direct1d" in _build.KERNELS
    assert "stencil_direct1d" in _build.COUNTERS
    src = (CSRC / "stencil_direct1d.cu").read_text()
    assert '#include "line_stage.cuh"' in src
    assert 'extern "C" int stencil_direct1d_launch(' in src
    assert "cp_async16" in src and "__launch_bounds__(DIRECT1D_THREADS" in src
    for name, value in (("DIRECT1D_TILES", common.LINE_ROWS),
                        ("DIRECT1D_SLACK", common.DIRECT1D_SLACK),
                        ("MAX_RADIUS", t_direct.MAX_RADIUS)):
        assert re.search(rf"#define {name} {value}\b", src)
    # the fill and the granule copy are the folded banded kernels'
    shared = (CSRC / "line_stage.cuh").read_text()
    assert "void fill_line(" in shared and "int line_shift(" in shared
    assert '#include "line_stage.cuh"' in (CSRC / "line_fold.cuh").read_text()


def _c_params() -> list:
    src = (CSRC / "stencil_direct1d.cu").read_text()
    sig = re.search(r'extern "C" int stencil_direct1d_launch\((.*?)\)', src,
                    re.S).group(1)
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
    """The C entry faked, the CUDA context calls made inert, the launch
    counts from 0, and the lifted 2D launch made to fail if reached."""
    fake = _FakeLaunch()
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fake}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))

    def lifted(*a, **k):
        raise AssertionError("a 1D launch reached the lifted 2D kernel")
    monkeypatch.setattr(t_direct, "_launch2d", lifted)
    t_direct._launcher1d.cache_clear()
    tk.reset_launch_counts()
    yield fake
    t_direct._launcher1d.cache_clear()
    tk.reset_launch_counts()


@pytest.mark.parametrize("mode", ["periodic", "reflect"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 3])
def test_wrapper_passes_the_line_arguments(fake_card, mode, dtype, batch):
    w = np.asarray(make_weights(JSpec("box", 1, 1), seed=0), np.float32)
    x = torch.zeros((batch, 1000), dtype=dtype)
    geom = common.launch_geom((1000,), 2)
    code = common.BOUNDARY_CODES[mode]
    y = t_direct._launch1d(x, w, 2, 1, geom, code)
    counts = {k: v for k, v in tk.launch_counts().items() if v}
    assert y.shape == x.shape and y.dtype == dtype
    assert counts == {"stencil_direct1d": 1}
    params = _c_params()
    fake = fake_card
    assert len(fake.args) == len(params) == len(fake.argtypes)
    args = dict(zip(params, fake.args))
    lay = common.direct1d_layout(geom.w_tile, 2, dtype.itemsize)
    assert (args["N"], args["L"], args["t"], args["r"]) == \
        (1000, geom.w_tile, 2, 1)
    assert (args["B"], args["grid_elems"], args["mode_x"]) == \
        (batch, 1000, code)
    assert (args["lds"], args["ld"], args["stage_bytes"], args["work_bytes"],
            args["smem_bytes"]) == (lay.lds, lay.ld, lay.stage_bytes,
                                    lay.work_bytes, lay.smem_bytes)
    assert args["dtype"] == (1 if dtype == torch.bfloat16 else 0)
    assert list(args["taps"]) == pytest.approx(w.tolist(), abs=0)
    assert (args["x"], args["y"]) == (x.data_ptr(), y.data_ptr())


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("boundary", [None, "zero"])
def test_1d_calls_on_the_card_launch_the_folded_kernel(fake_card, batched,
                                                       boundary):
    # stencil_direct, the plan entry stencil_direct_at and its 1D foil
    # staging all take the folded kernel, one launch per call, batch or
    # not; the lifted 2D launch is never reached
    w = np.asarray(make_weights(JSpec("box", 1, 1), seed=0), np.float32)
    shape = (4, 300) if batched else (300,)
    x = torch.zeros(shape).as_subclass(_OnCard)
    geom = common.launch_geom((300,), 4)
    calls = [lambda: t_direct.stencil_direct_at(x, w, 4, geom, boundary,
                                                "region", batched),
             lambda: t_direct.stencil_direct_at(x, w, 4, geom, boundary,
                                                "wholestrip", batched)]
    if not batched:
        calls.append(lambda: t_direct.stencil_direct(x, w, 4,
                                                     boundary=boundary))
    for k, call in enumerate(calls, 1):
        y = call()
        assert tuple(y.shape) == shape
        counts = {n: v for n, v in tk.launch_counts().items() if v}
        assert counts == {"stencil_direct1d": k}
        args = dict(zip(_c_params(), fake_card.args))
        assert args["B"] == (4 if batched else 1) and args["N"] == 300
        assert args["mode_x"] == (0 if boundary is None else 1)
