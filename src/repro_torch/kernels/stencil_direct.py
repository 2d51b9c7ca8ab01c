"""Tap-sum stencil (the paper's "CUDA core" baseline): the counterpart of
``repro.kernels.stencil_direct``.

``stencil_direct(x, weights, t, boundary=...)`` advances a 1D, 2D or 3D
grid ``t`` fused steps under per-axis boundaries (periodic, zero,
reflect, replicate).  A tensor on the CPU runs :func:`stencil_direct_plain`;
a CUDA tensor launches a hand-written kernel or raises: 2D grids
``csrc/stencil_direct.cu``, 3D grids ``csrc/stencil_direct3d.cu``, and 1D
grids ``csrc/stencil_direct1d.cu``, which folds the line: each CTA one
contiguous segment of ``common.LINE_ROWS`` lifted tiles
(``common.line_segments``).  The 2D kernel on the lifted (1, N) view, with
the kernel as the middle row of a square one (every wrapped row is row 0,
and the zero rows are skipped), as the JAX lift does, its row axis
periodic and its column axis in the grid's mode, computes the same
function bit for bit and stays reachable as :func:`_launch2d` for
comparison.  The kernels accumulate in f32 in the row-major tap order of
the JAX kernel (``stencil_direct.py:88-98``), skip zero taps, rebuild
every non-periodic axis's halo before each step (the in-kernel fill), and
round to ``x.dtype`` once, on store.

The ``staging`` argument of :func:`stencil_direct_at` (a plan's entry)
picks what a CTA reads to build its region (``common.STAGE_CODES``): the
region alone (every main-path launch), or one of the traffic foils,
which read whole neighbour tiles and compute the same function bit for
bit -- ``"wholestrip"`` (K8: 2D the tiles above, at and below, 3D the
3 x 3 whole-slab tiles) and ``"9tile"`` (K9, 2D periodic).  The foils
launch the same kernel built with the foil's staging
(``csrc/stencil_direct{,3d}.cu`` with ``-DREPRO_FOIL``); a 1D grid has
one staging, the folded kernel's, so a foil there is the default.  Their
plain version is the regime's.

With ``batched=True`` (:func:`stencil_direct_at`, a batched plan's entry)
``x`` is ``(B,) + grid_shape``, the grid's rank is the weights', and one
launch advances all B grids, grid b on ``blockIdx.z`` (K11; the 1D kernel's
persistent CTAs walk the (grid, segment) pairs); its plain version is the
loop of the unbatched one.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.stencil.boundary import resolve_boundary
from repro_torch.stencil.reference import pad_boundary
from repro_torch.testing import faults
from . import _build
from .common import (CLUSTER_RADIUS3D, SMEM_BUDGET_BYTES,
                     STAGE_CODES, ClusterLayout, SubstrateGeom, TileNeed,
                     WorkspaceLayout, as_workspace, batch_chunks,
                     batch_grid, check_grid, check_staging, check_tile_halo,
                     direct1d_layout, direct3d_cluster, direct3d_layout,
                     direct_layout, kernel_mode_codes,
                     launch_geom, plain_loop, smem_budget_bytes, tapsum_need,
                     workspace_args)

#: Radii the kernels are specialised on (1..7), and so the taps the host
#: passes the 2D and 3D kernels (a dense r=7 box: 225 and 3,375 floats;
#: each instantiation copies the first (2r+1)^d of them, at least 49 and
#: 343, into its own argument); must match csrc/stencil_direct.cu,
#: csrc/stencil_direct3d.cu and csrc/stencil_direct1d.cu.
MAX_RADIUS = 7
MAX_TAPS = (2 * MAX_RADIUS + 1) ** 2
MAX_TAPS3D = (2 * MAX_RADIUS + 1) ** 3

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: The last arguments of every C entry: the batch B, the cells of one grid,
#: the dynamic shared memory and the stream.
_BATCH_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


class _Taps(ctypes.Structure):
    """``csrc/stencil_direct.cu::Taps``: the (2r+1)^2 taps, row-major,
    zero where skipped and past them."""
    _fields_ = [("w", ctypes.c_float * MAX_TAPS)]


class _Taps3(ctypes.Structure):
    """``csrc/stencil_direct3d.cu::Taps3``: the (2r+1)^3 taps, row-major,
    zero where skipped and past them."""
    _fields_ = [("w", ctypes.c_float * MAX_TAPS3D)]


def nonzero_taps(weights: np.ndarray):
    """``(*offset, w)`` of every nonzero tap in row-major order, ``w`` as
    float32 -- the order in which the kernels and the plain version sum
    (2D: ``(dy, dx, w)``)."""
    w = np.asarray(weights, dtype=np.float32)
    return [idx + (float(w[idx]),) for idx in np.ndindex(*w.shape)
            if w[idx] != 0.0]


def stencil_direct_plain(x: torch.Tensor, weights, t: int = 1,
                         boundary=None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: ``t`` tap-sum steps of the
    whole grid (any rank), accumulated in f32 in row-major tap order with
    zero taps skipped, rounded to ``x.dtype`` at the end.  Every step pads
    each axis by r in its mode (``pad_boundary``, ascending axes; periodic
    wraps, so the shifts are ``torch.roll``'s values) and slices each
    tap's shift out of the padded grid."""
    w = np.asarray(weights, dtype=np.float32)
    r = (w.shape[0] - 1) // 2
    modes = resolve_boundary(boundary, w.ndim)
    cur = x.float()
    for _ in range(t):
        xp = pad_boundary(cur, r, modes)
        acc = torch.zeros_like(cur)
        for *off, wv in nonzero_taps(w):
            acc = acc + wv * xp[tuple(slice(o, o + n)
                                      for o, n in zip(off, cur.shape))]
        cur = acc
    return cur.to(x.dtype)


@functools.lru_cache(maxsize=32)
def _tap_arg(w_bytes: bytes, ndim: int = 2):
    """The 2D (``_Taps``) or 3D (``_Taps3``) kernel's by-value taps of one
    float32 weight array's bytes, built once per weights (plans call the
    wrapper every step; building them took most of the wrapper's host
    time).  The launch copies them, so callers share them read-only."""
    w = np.frombuffer(w_bytes, dtype=np.float32)
    if ndim == 3:
        return _Taps3((ctypes.c_float * MAX_TAPS3D)(*w.tolist()))
    return _Taps((ctypes.c_float * MAX_TAPS)(*w.tolist()))


@functools.lru_cache(maxsize=None)
def _launcher():
    """The 2D kernel's C entry point, built on first use, its ctypes
    signature set once."""
    fn = _build.library("stencil_direct").stencil_direct_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 10 + [
        ctypes.POINTER(_Taps)] + _BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _launcher3d():
    """The 3D kernel's C entry point, built on first use."""
    fn = _build.library("stencil_direct3d").stencil_direct3d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Taps3)] + [
        ctypes.c_int] * 13 + _BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _cluster_launcher3d():
    """The 3D kernel's cluster form's C entry point (the 3D entry's
    arguments, then the cluster's CTAs and the steps each runs), built on
    first use."""
    fn = _build.library("stencil_direct3d_cluster").stencil_direct3d_cluster_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Taps3)] + [
        ctypes.c_int] * 14 + [ctypes.POINTER(ctypes.c_int)] + _BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _workspace_launcher3d():
    """The 3D kernel's workspace form's C entry point (the 3D entry's
    arguments, then the workspace, its slice bytes and the persistent
    CTAs), built on first use."""
    lib = _build.library("stencil_direct3d_workspace")
    fn = lib.stencil_direct3d_workspace_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(_Taps3)] + [ctypes.c_int] * 13 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + _BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _workspace_launcher():
    """The 2D kernel's workspace form's C entry point (the 2D entry's
    arguments, then the workspace, its slice bytes and the persistent
    CTAs), built on first use."""
    fn = _build.library(
        "stencil_direct_workspace").stencil_direct_workspace_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 10 + [
        ctypes.POINTER(_Taps), ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int] + _BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _launcher1d():
    """The folded 1D kernel's C entry point, built on first use."""
    fn = _build.library("stencil_direct1d").stencil_direct1d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 10 + \
        _BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=32)
def _taps1d(w_bytes: bytes):
    """The 1D kernel's 2r + 1 float32 taps as a C array, zero where
    skipped, built once per weights (the launch copies them)."""
    w = np.frombuffer(w_bytes, dtype=np.float32)
    return (ctypes.c_float * w.size)(*w.tolist())


@functools.lru_cache(maxsize=None)
def _foil_launcher():
    """The 2D foils' C entry point (the 2D entry's arguments and the
    staging code after the dtype), built on first use."""
    fn = _build.library("stencil_direct_foil").stencil_direct_foil_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 11 + [
        ctypes.POINTER(_Taps)] + _BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _foil_launcher3d():
    """The whole-slab foil's C entry point, built on first use."""
    fn = _build.library("stencil_direct3d_foil").stencil_direct3d_foil_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Taps3)] + [
        ctypes.c_int] * 14 + _BATCH_ARGS
    return fn


def tile_need(grid_shape, r: int, t: int, dtype: torch.dtype,
              regime: str = "the tap-sum") -> TileNeed:
    """The tap-sum's own shared memory on a candidate tile at ``t`` steps
    of radius ``r`` on a grid of this shape and dtype (``common.
    tapsum_need``), which the tile rule holds candidates to where no
    reserve fits."""
    return tapsum_need(len(grid_shape), r, t, dtype.itemsize, regime)


def kernel_source(ndim: int) -> str:
    """The kernel source a launch on a grid of rank ``ndim`` builds from."""
    return {1: "stencil_direct1d", 3: "stencil_direct3d"}.get(
        ndim, "stencil_direct")


def _entry(ndim: int, staging: str):
    """``(library, C entry, staging arguments, launch counter)`` of a
    tap-sum launch on a grid of rank 2 or 3."""
    src = kernel_source(ndim)
    if staging == "region":
        return (src, _launcher3d() if ndim == 3 else _launcher(), (), src)
    return (f"{src}_foil",
            _foil_launcher3d() if ndim == 3 else _foil_launcher(),
            (STAGE_CODES[staging],),
            f"{src} ({'wholeslab' if ndim == 3 else staging})")


def stencil_direct(x: torch.Tensor, weights, t: int = 1,
                   tile_m: int = None, w_tile: int = None,
                   boundary=None) -> torch.Tensor:
    """``t`` fused tap-sum steps of a 1D, 2D or 3D grid.

    ``weights``: host-side (2r+1)^d ndarray (zeros outside support), d the
    grid rank.  ``tile_m`` / ``w_tile`` pin the CTA's output tile
    (multiples of 16; ``None`` = ``launch_geom``, which in 1D is the
    lift's tile, whose width sets the folded kernel's segment and where
    only ``w_tile`` applies).  ``boundary``: one mode
    for every axis, a per-axis tuple (``None`` entries periodic) or
    ``None`` (periodic).
    """
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    w = np.asarray(weights)
    r, modes = check_grid(x.shape, w, t, boundary, "the tap-sum")
    if x.device.type == "cpu":
        return stencil_direct_plain(x, w, t, modes)
    geom = launch_geom(x.shape, t * r, tile_m, w_tile,
                       need=tile_need(x.shape, r, t, x.dtype))
    return _run(x, w, t, r, geom, modes)


def stencil_direct_at(x: torch.Tensor, weights, t: int,
                      geom: SubstrateGeom, boundary=None,
                      staging: str = "region",
                      batched: bool = False,
                      budget: int = None) -> torch.Tensor:
    """:func:`stencil_direct` on a tile the caller resolved with
    ``launch_geom(grid_shape, t * r, ...)``: a plan resolves it once, when
    it is built, and launches every step on it.  ``batched``: ``x`` is
    ``(B,) + grid_shape`` and one launch advances every grid (K11).
    ``budget``: the shared memory per CTA the tile was resolved under
    (``common.smem_budget_bytes()`` when the plan was built; None: now);
    a 3D launch whose rings exceed it runs the cluster form, and a launch
    that no cluster holds (or a 2D one past it) the workspace form
    (:func:`launch_layout`; a budget of 1 byte forces the workspace form),
    its workspace allocated at each launch.  Inside a plan's first call
    the launch is where the ``compile`` and ``vmem`` fault hooks fire
    (``repro_torch.testing.faults``)."""
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    w = np.asarray(weights)
    shape = batch_grid(x, batched)
    r, modes = check_grid(shape, w, t, boundary, "the tap-sum")
    check_tile_halo(geom, t * r)
    check_staging(shape, geom, t * r, staging)
    faults.on_launch(kernel_source(len(shape)))
    if x.device.type == "cpu":
        return plain_loop(stencil_direct_plain, x, batched, w, t, modes)
    return _run(x, w, t, r, geom, modes, staging, batched, budget)


def _run(x: torch.Tensor, w: np.ndarray, t: int, r: int,
         geom: SubstrateGeom, modes: tuple,
         staging: str = "region", batched: bool = False,
         budget: int = None) -> torch.Tensor:
    """Launch the kernel of the grid's rank on ``geom`` with ``staging``
    (a 1D grid: the folded kernel's one staging) over one grid, or over
    the batch ``x`` holds when ``batched``; or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"stencil_direct runs on cpu or cuda, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"stencil_direct kernel takes float32 or bfloat16 "
                        f"grids, got {x.dtype}")
    if r > MAX_RADIUS:
        raise ValueError(f"the tap-sum kernel is specialised on radius <= "
                         f"{MAX_RADIUS}, got {r}")
    if not x.is_contiguous():
        raise ValueError("stencil_direct kernel takes a contiguous grid")
    w32 = np.ascontiguousarray(w, dtype=np.float32)
    if not w32.any():
        return torch.zeros_like(x)
    codes = kernel_mode_codes(modes)
    xb = x if batched else x.unsqueeze(0)
    if xb.ndim == 4:
        y = _launch3d(xb, w32, t, r, geom, codes, staging, budget)
    elif xb.ndim == 2:
        y = _launch1d(xb, w32, t, r, geom, codes[-1])
    else:
        y = _launch2d(xb, w32, t, r, geom, codes, staging, budget)
    return y if batched else y[0]


def _launch1d(x: torch.Tensor, w32: np.ndarray, t: int, r: int,
              geom, code: int) -> torch.Tensor:
    """The folded 1D kernel on the (B, N) lines ``x``: segments of
    LINE_ROWS tiles of the lifted tile's width ``geom.w_tile``, the
    line's boundary ``code``; one launch for the batch."""
    layout = direct1d_layout(geom.w_tile, t * r, x.dtype.itemsize)
    if layout.smem_bytes > SMEM_BUDGET_BYTES:
        raise ValueError(f"1D tap-sum segment needs {layout.smem_bytes} "
                         "bytes of shared memory, over the 227 KB budget")
    taps = _taps1d(w32.tobytes())
    y = torch.empty_like(x)
    fn = _launcher1d()
    b, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), taps, n, geom.w_tile, t, r,
                 layout.lds, layout.ld, layout.stage_bytes, layout.work_bytes,
                 _DTYPE_CODES[x.dtype], code, b, n, layout.smem_bytes, stream)
    _build.check(err, "stencil_direct1d")
    _build.count_launch("stencil_direct1d")
    return y


def launch_layout(shape, r: int, t: int, geom: SubstrateGeom,
                  budget: int = None, device=None):
    """The layout a launch of the 2D or 3D tap-sum on grids of ``shape``
    takes on ``geom`` at ``t`` steps of radius ``r`` and on ``device``
    (:func:`direct3d_rings`, :func:`direct2d_layout`): what every launch
    runs with, and what a plan reports (``explain``, the auditor) for its
    own device."""
    if len(shape) == 3:
        return direct3d_rings(geom, r, t, budget, device)
    return direct2d_layout(geom, t * r, budget, device)


def direct2d_layout(geom: SubstrateGeom, halo: int, budget: int = None,
                    device=None):
    """The 2D tap-sum's layout on ``geom`` at ``halo``
    (``common.direct_layout``) where it fits ``budget`` bytes of shared
    memory (default: ``common.smem_budget_bytes()``), else its workspace
    form on ``device`` (``common.as_workspace``, the tile rule's fourth
    rung)."""
    budget = smem_budget_bytes() if budget is None else budget
    layout = direct_layout(geom.strip_m, geom.w_tile, halo)
    if layout.smem_bytes <= min(budget, SMEM_BUDGET_BYTES):
        return layout
    return as_workspace(layout, device)


def _launch2d(x: torch.Tensor, w32: np.ndarray, t: int, r: int,
              geom, codes: tuple, staging: str = "region",
              budget: int = None) -> torch.Tensor:
    arg = _tap_arg(w32.tobytes())
    layout = launch_layout(x.shape[1:], r, t, geom, budget, x.device)
    if isinstance(layout, WorkspaceLayout) and staging != "region":
        raise ValueError("a foil runs on one CTA a tile; its buffers need "
                         f"{layout.base.smem_bytes} bytes of shared memory, "
                         "over the 227 KB budget")
    y = torch.empty_like(x)
    b, h, wd = x.shape
    if isinstance(layout, WorkspaceLayout):
        ws, tail = workspace_args(x, layout)
        lib, counter = "stencil_direct_workspace", "stencil_direct (workspace)"

        def launch(stream):
            return _workspace_launcher()(
                x.data_ptr(), y.data_ptr(), h, wd, geom.strip_m, geom.w_tile,
                t, r, layout.base.ld, _DTYPE_CODES[x.dtype], *codes,
                ctypes.byref(arg), *tail, b, h * wd, 0, stream)
    else:
        lib, fn, stage, counter = _entry(2, staging)

        def launch(stream):
            return fn(x.data_ptr(), y.data_ptr(), h, wd, geom.strip_m,
                      geom.w_tile, t, r, layout.ld, _DTYPE_CODES[x.dtype],
                      *stage, *codes, ctypes.byref(arg), b, h * wd,
                      layout.smem_bytes, stream)
    with torch.cuda.device(x.device):
        err = launch(torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, lib)
    _build.count_launch(counter, len(batch_chunks(b)))
    return y


def direct3d_rings(geom: SubstrateGeom, r: int, t: int,
                   budget: int = None, device=None):
    """The 3D tap-sum's rings on ``geom`` at ``t`` steps of radius ``r``:
    ``common.direct3d_layout`` where it fits ``budget`` bytes (default:
    ``common.smem_budget_bytes()``), else its cluster form
    (``common.direct3d_cluster``, a :class:`ClusterLayout`, radii up to
    ``CLUSTER_RADIUS3D``), else its workspace form on ``device``
    (``common.as_workspace``, the tile rule's fourth rung)."""
    budget = smem_budget_bytes() if budget is None else budget
    layout = direct3d_layout(geom.strip_m, geom.w_tile, r, t)
    if layout.smem_bytes <= min(budget, SMEM_BUDGET_BYTES):
        return layout
    cluster = (direct3d_cluster(geom.strip_m, geom.w_tile, r, t, budget)
               if r <= CLUSTER_RADIUS3D else None)
    return as_workspace(layout, device) if cluster is None else cluster


def _launch3d(x: torch.Tensor, w32: np.ndarray, t: int, r: int,
              geom, codes: tuple, staging: str = "region",
              budget: int = None) -> torch.Tensor:
    layout = launch_layout(x.shape[1:], r, t, geom, budget, x.device)
    arg = _tap_arg(w32.tobytes(), 3)
    y = torch.empty_like(x)
    b, z, h, wd = x.shape
    if isinstance(layout, WorkspaceLayout):
        if staging != "region":
            raise ValueError("the whole-slab foil runs on one CTA a tile; its "
                             f"rings need {layout.base.smem_bytes} bytes of "
                             "shared memory, over the 227 KB budget")
        ws, tail = workspace_args(x, layout)
        lib = "stencil_direct3d_workspace"
        counter = "stencil_direct3d (workspace)"

        def launch(stream):
            return _workspace_launcher3d()(
                x.data_ptr(), y.data_ptr(), ctypes.byref(arg), z, h, wd,
                geom.z_slab, geom.strip_m, geom.w_tile, t, r, layout.base.ld,
                _DTYPE_CODES[x.dtype], *codes, *tail, b, z * h * wd, 0,
                stream)
    elif isinstance(layout, ClusterLayout):
        if staging != "region":
            raise ValueError("the whole-slab foil runs on one CTA a tile; its "
                             f"rings need {layout.base.smem_bytes} bytes")
        lib, counter = "stencil_direct3d_cluster", "stencil_direct3d (cluster)"

        def launch(stream):
            return _cluster_launcher3d()(
                x.data_ptr(), y.data_ptr(), ctypes.byref(arg), z, h, wd,
                geom.z_slab, geom.strip_m, geom.w_tile, t, r, layout.base.ld,
                _DTYPE_CODES[x.dtype], *codes, layout.ctas,
                _build.c_ints(layout.split), b, z * h * wd, layout.smem_bytes,
                stream)
    else:
        lib, fn, stage, counter = _entry(3, staging)

        def launch(stream):
            return fn(x.data_ptr(), y.data_ptr(), ctypes.byref(arg), z, h, wd,
                      geom.z_slab, geom.strip_m, geom.w_tile, t, r, layout.ld,
                      _DTYPE_CODES[x.dtype], *stage, *codes, b, z * h * wd,
                      layout.smem_bytes, stream)
    with torch.cuda.device(x.device):
        err = launch(torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, lib)
    _build.count_launch(counter, len(batch_chunks(b)),
                        layout.ctas if isinstance(layout, ClusterLayout) else None)
    return y
