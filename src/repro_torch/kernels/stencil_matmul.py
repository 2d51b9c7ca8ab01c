"""Banded (Toeplitz) stencil contraction on the tensor cores (the paper's
"Tensor Core" adaptation): the counterpart of ``repro.kernels.stencil_matmul``.

Transformation (DESIGN.md §2): each structurally nonzero x-row of the
kernel -- w[dy, :] in 2D, w[dz, dy, :] in 3D -- becomes a banded matrix B
of shape (tile_n + 2R, tile_n) with B[j+dx, j] = w[..., dx]
(``build_bands_nd``, host-side, copied from the JAX package so the
operands match bit for bit), and every chunk of ``tile_n`` output columns
is  sum over rows of  A_row @ B_row,  A_row the (dz, dy)-shifted slab of
the input extended by r per axis in that axis's boundary mode (periodic,
zero, reflect, replicate; rebuilt in shared memory before every step by
the in-kernel fill), accumulated in f32 with the operands in the compute
dtype.

``stencil_matmul(x, weights, t)``: ``t=1`` is one contraction of
``weights`` (which may be a composed radius-t*r kernel: monolithic
fusion); ``t>1`` runs t radius-r contractions with f32 intermediates (the
intermediate-reuse regime).  A tensor on the CPU runs
:func:`stencil_matmul_plain`; a CUDA tensor launches a hand-written
``mma.sync`` kernel (TF32 operands for f32, bf16 for bf16, 16-column
chunks: BAND_N) or raises: 2D grids ``csrc/stencil_banded.cu``, which
runs each step's 16-row tiles of every chunk in passes held in registers
and reads its bands as Toeplitz rows (``csrc/tile_fold.cuh``,
:func:`toeplitz_rows`), 3D grids ``csrc/stencil_banded3d.cu``, which
folds each step's (plane, row) pairs into the MMA rows
(``csrc/slab_fold.cuh``), 1D grids ``csrc/stencil_banded1d.cu``, which
folds the line into the MMA rows (``csrc/line_fold.cuh``): each row one
w_tile-long segment of the line, its one band the 1D kernel.  The 2D
kernel on the lifted (1, N) view, where the kernel's single row is one
band (the lift's row axis periodic, its column axis in the grid's mode),
computes the same function bit for bit and stays reachable as
:func:`_launch2d` for comparison.

The ``staging`` argument of :func:`stencil_matmul_at` picks what a CTA
reads to build its region, as in ``stencil_direct_at``: the region alone, or a traffic foil's whole
neighbour tiles -- ``"wholestrip"`` (K8) and ``"9tile"`` (K10, 2D
periodic) -- launching the same kernel built with the foil's staging
(``csrc/stencil_banded{,3d}.cu`` with ``-DREPRO_FOIL``).  A 1D grid has
one staging, the folded kernel's.  With ``batched=True``, as in
``stencil_direct_at``, ``x`` is ``(B,) + grid_shape`` and one launch
advances all B grids (K11).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.stencil.boundary import resolve_boundary
from repro_torch.stencil.reference import pad_boundary
from repro_torch.testing import faults
from . import _build
from .common import (BAND_N, SMEM_BUDGET_BYTES, STAGE_CODES, ClusterLayout,
                     SubstrateGeom, TileNeed, WorkspaceLayout,
                     as_workspace, batch_chunks, batch_grid, check_grid,
                     check_staging, check_tile_halo, fold_need,
                     kernel_mode_codes, launch_geom, line_layout, mma_k_step,
                     plain_loop, slab_cluster, slab_fold_layout,
                     smem_budget_bytes, tile_fold_layout, workspace_args)

#: Deepest padded contraction one unrolled piece of the kernels takes
#: (BAND_N + 2R <= 64, so R <= 24); must match MAX_KPAD in
#: csrc/banded_mma.cuh.  The 1D and 2D kernels on the dense bands take
#: deeper bands in pieces of it (``FoldKs::DEEP``, a composed kernel past
#: radius 24: 128 deep at Box-2D7R, t = 8), the 2D foils too, and so do
#: the workspace forms of the 2D and 3D folds (the 3D composed
#: contraction past radius 24 runs on no other); the one-CTA and cluster
#: 3D kernels and the compacted ones take at most this.
MAX_KPAD = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: The last arguments of every C entry: the batch B, the cells of one grid,
#: the dynamic shared memory and the stream.
BATCH_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def build_bands(weights: np.ndarray, tile_n: int) -> np.ndarray:
    """(ROWS, TILE_N + 2R, TILE_N) banded weight matrices, one per kernel row.

    ``weights`` is a 2D kernel whose LAST axis carries the x taps (radius
    R from that axis); rows may number 2R+1 (square 2D kernels) or 1 (the
    lifted-1D kernel).
    """
    w = np.asarray(weights)
    rows, kx = w.shape
    radius = (kx - 1) // 2
    bands = np.zeros((rows, tile_n + 2 * radius, tile_n), dtype=w.dtype)
    # Vectorized diagonal fill: tap dx of every row lands on the band
    # (j + dx, j); writing the zero taps too is identical to skipping
    # them, since the destination starts zeroed.
    j = np.arange(tile_n)
    for dx in range(kx):
        bands[:, j + dx, j] = w[:, dx, None]
    return bands


def build_bands_nd(weights: np.ndarray, tile_n: int):
    """Flatten an N-D kernel's leading shift tuples into banded operands.

    Returns ``(offsets, bands)``: ``offsets`` is the host-side list of
    leading-axis shift tuples (e.g. (dz, dy) for 3D) whose x-row
    ``weights[off + (:,)]`` is structurally nonzero, and ``bands`` stacks
    one (TILE_N + 2R, TILE_N) banded matrix per such row.  All-zero rows
    are dropped at build time -- they would contract to exact zeros.
    """
    w = np.asarray(weights)
    lead = w.shape[:-1]
    offsets = [off for off in np.ndindex(*lead)
               if np.count_nonzero(w[off + (slice(None),)])]
    rows = np.stack([w[off + (slice(None),)] for off in offsets])
    return offsets, build_bands(rows, tile_n)


def toeplitz_rows(bands: np.ndarray) -> np.ndarray:
    """The (n, K + BAND_N) Toeplitz rows of (n, K, BAND_N) banded operands,
    as the 2D and 3D kernels read them (``csrc/tile_fold.cuh``,
    ``csrc/slab_fold.cuh``): a band B with
    B[k][j] = f(k - j) is one row T of f, T[d + BAND_N - 1] = f(d) for d
    in [-(BAND_N - 1), K), its last element zero.  Every band of
    ``build_bands_nd`` (B[j + dx, j] = w[dx]), padded with zero rows or
    compacted to its row hull, is Toeplitz; a band that is not raises."""
    bands = np.asarray(bands)
    n, k, cols = bands.shape
    toe = np.zeros((n, k + cols), bands.dtype)
    toe[:, cols - 1:cols - 1 + k] = bands[:, :, 0]
    toe[:, :cols - 1] = bands[:, 0, :0:-1]
    d = np.arange(k)[:, None] - np.arange(cols)[None, :] + cols - 1
    if not np.array_equal(toe[:, d], bands):
        raise ValueError("a band is not Toeplitz: B[k][j] must depend on "
                         "k - j alone")
    return toe


def band_sparsity(weights: np.ndarray, tile_n: int) -> float:
    """Measured S of the built operands = nonzeros / total (sanity vs model).

    Each nonzero tap (off, dx) lands on its own diagonal (j + dx, j),
    contributing exactly ``tile_n`` entries, so over the rows
    ``build_bands_nd`` keeps  S = nnz_taps / (n_rows * (tile_n + 2r)).
    (The H100 kernel also pads K = tile_n + 2r up to the MMA K step; that
    padding is not counted here.)
    """
    w = np.asarray(weights)
    if w.ndim == 1:
        w = w[None, :]
    radius = (w.shape[-1] - 1) // 2
    per_row = np.count_nonzero(w.reshape(-1, w.shape[-1]), axis=1)
    per_row = per_row[per_row > 0]
    return float(per_row.sum()) / (per_row.size * (tile_n + 2 * radius))


def stencil_matmul_plain(x: torch.Tensor, weights, t: int = 1,
                         tile_n: int = BAND_N, compute_dtype=None,
                         boundary=None) -> torch.Tensor:
    """Plain PyTorch version of the kernels on the whole grid (any rank):
    per step, pad every axis by R in its boundary mode (``pad_boundary``,
    ascending axes; periodic is the ``% n`` index) and the columns with
    zeros up to whole chunks, cut each row-shifted slab of
    ``build_bands_nd`` into (tile_n + 2R)-wide chunks at stride ``tile_n``
    and contract it with its band by one ``torch.matmul`` over all
    chunks.  Operands are rounded to the compute dtype and multiplied in
    f32 (exact for bf16), accumulated in f32 in row order; the result
    rounds to ``x.dtype`` at the end."""
    w = np.asarray(weights, dtype=np.float32)
    cdt = x.dtype if compute_dtype is None else compute_dtype
    radius = (w.shape[-1] - 1) // 2
    offsets, bands_np = build_bands_nd(w, tile_n)
    bands = torch.from_numpy(bands_np).to(x.device).to(cdt).float()
    shape = tuple(x.shape)
    lead, wd = shape[:-1], shape[-1]
    nc = -(-wd // tile_n)
    modes = resolve_boundary(boundary, len(shape))
    cur = x.float()
    for _ in range(t):
        xp = pad_boundary(cur, radius, modes)
        xp = F.pad(xp, (0, nc * tile_n - wd)).to(cdt).float()
        acc = torch.zeros(lead + (nc, tile_n), device=x.device)
        for p, off in enumerate(offsets):
            sl = tuple(slice(o, o + n) for o, n in zip(off, lead))
            a = xp[sl].unfold(-1, tile_n + 2 * radius, tile_n)
            acc = acc + torch.matmul(a, bands[p])
        cur = acc.reshape(lead + (nc * tile_n,))[..., :wd]
    return cur.to(x.dtype)


@functools.lru_cache(maxsize=32)
def _device_bands(w_bytes: bytes, shape: tuple, kpad: int,
                  cdt: torch.dtype, device: str):
    """The ``build_bands_nd`` operands of one weight array as the folded 1D
    kernels read them: padded with zero rows to ``kpad`` and stored in the
    compute dtype on the device, built once per weights, dtype and device
    (plans call the wrapper every step)."""
    w = np.frombuffer(w_bytes, dtype=np.float32).reshape(shape)
    _, bands = build_bands_nd(w, BAND_N)
    bands = np.pad(bands, ((0, 0), (0, kpad - bands.shape[1]), (0, 0)))
    return torch.from_numpy(bands).to(device=device, dtype=cdt)


@functools.lru_cache(maxsize=32)
def _device_toe(w_bytes: bytes, shape: tuple, cdt: torch.dtype,
                device: str):
    """``(toe, rows)`` of one 2D or 3D weight array as the 2D and 3D
    kernels read it: the ``build_bands_nd`` bands padded with zero rows to
    the MMA K step of ``cdt`` (kpad) as their Toeplitz rows
    (:func:`toeplitz_rows`) in the compute dtype, and every band's (dz,
    dy, lo, nk) = (dz, dy, 0, kpad / K) as int32, dz = 0 in 2D (the
    compacted operand's form, every row kept), both on the device, built
    once per weights, dtype and device."""
    w = np.frombuffer(w_bytes, dtype=np.float32).reshape(shape)
    offsets, bands = build_bands_nd(w, BAND_N)
    k, step = bands.shape[1], mma_k_step(cdt.itemsize)
    kpad = -(-k // step) * step
    toe = toeplitz_rows(np.pad(bands, ((0, 0), (0, kpad - k), (0, 0))))
    rows = np.asarray([(0,) * (2 - len(o)) + tuple(o) + (0, kpad // step)
                       for o in offsets], dtype=np.int32)
    return (torch.from_numpy(toe).to(device=device, dtype=cdt),
            torch.from_numpy(rows).to(device))


@functools.lru_cache(maxsize=None)
def _launcher():
    """The 2D kernel's C entry point, built on first use, its ctypes
    signature set once."""
    fn = _build.library("stencil_banded").stencil_banded_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _launcher3d():
    """The 3D kernel's C entry point, built on first use."""
    fn = _build.library("stencil_banded3d").stencil_banded3d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 + BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _cluster_launcher3d():
    """The 3D kernel's cluster forms' C entry point (the 3D entry's
    arguments, then the cluster's CTAs, its split and, for a one-step
    launch, its bands' split), built on first use."""
    fn = _build.library("stencil_banded3d_cluster").stencil_banded3d_cluster_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19 + [
        ctypes.POINTER(ctypes.c_int)] * 2 + BATCH_ARGS
    return fn


def workspace_entry(lib: str, dim: int):
    """The C entry point of the workspace form (``<source>_workspace``) of
    a 2D or 3D fold library ``lib``: its main entry's arguments, then the
    workspace, its slice bytes and the persistent CTAs."""
    fn = getattr(_build.library(f"{lib}_workspace"),
                 f"{lib}_workspace_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (
        18 if dim == 3 else 14) + [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int] + BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _workspace_launcher(dim: int):
    """The dense fold's workspace form's C entry point in 2D or 3D, built
    on first use."""
    return workspace_entry(kernel_source(dim), dim)


@functools.lru_cache(maxsize=None)
def _launcher1d():
    """The folded 1D kernel's C entry point, built on first use."""
    fn = _build.library("stencil_banded1d").stencil_banded1d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _foil_launcher():
    """The 2D foils' C entry point (the 2D entry's arguments and the
    staging code after the compute dtype), built on first use."""
    fn = _build.library("stencil_banded_foil").stencil_banded_foil_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _foil_launcher3d():
    """The whole-slab foil's C entry point, built on first use."""
    fn = _build.library("stencil_banded3d_foil").stencil_banded3d_foil_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19 + BATCH_ARGS
    return fn


def band_rows(weights) -> int:
    """The bands ``build_bands_nd`` keeps: the structurally nonzero x-rows
    of the kernel (1 for a 1D kernel)."""
    w = np.asarray(weights)
    return int(np.count_nonzero(np.any(w.reshape(-1, w.shape[-1]) != 0,
                                       axis=1)))


def band_dzs(weights) -> tuple:
    """Each band's dz, in ``build_bands_nd``'s band order, of a 3D kernel:
    what the slab fold's cluster form splits a one-step launch by."""
    w = np.asarray(weights)
    keep = np.any(w.reshape(-1, w.shape[-1]) != 0, axis=1)
    return tuple(int(i) // w.shape[1] for i in np.flatnonzero(keep))


def tile_need(grid_shape, weights, t: int, dtype: torch.dtype,
              compute_dtype: torch.dtype,
              regime: str = "the banded contraction") -> TileNeed:
    """The dense fold's own shared memory on a candidate tile at ``t``
    steps of ``weights`` on a grid of this shape and dtype
    (``common.fold_need``; 3D with its cluster form), which the tile rule
    holds candidates to where no reserve fits."""
    radius = (np.asarray(weights).shape[-1] - 1) // 2
    dzs = band_dzs(weights) if len(grid_shape) == 3 else None
    return fold_need(len(grid_shape), radius, t, dtype.itemsize,
                     compute_dtype.itemsize, band_rows(weights), regime,
                     dzs=dzs)


def kernel_source(ndim: int) -> str:
    """The kernel source a launch on a grid of rank ``ndim`` builds from."""
    return {1: "stencil_banded1d", 3: "stencil_banded3d"}.get(
        ndim, "stencil_banded")


def _entry(ndim: int, staging: str):
    """``(library, C entry, staging arguments, launch counter)`` of a
    banded launch on a grid of rank 2 or 3."""
    src = kernel_source(ndim)
    if staging == "region":
        return (src, _launcher3d() if ndim == 3 else _launcher(), (), src)
    return (f"{src}_foil",
            _foil_launcher3d() if ndim == 3 else _foil_launcher(),
            (STAGE_CODES[staging],),
            f"{src} ({'wholeslab' if ndim == 3 else staging})")


def stencil_matmul(x: torch.Tensor, weights, t: int = 1,
                   tile_m: int = None, w_tile: int = None,
                   compute_dtype=None, boundary=None) -> torch.Tensor:
    """``t`` steps of a 1D, 2D or 3D grid via banded contractions.

    ``t=1``: one contraction of ``weights`` (possibly a fused radius-t*r
    kernel).  ``t>1``: t radius-r contractions with f32 intermediates kept
    on chip.  ``tile_m`` / ``w_tile`` pin the CTA's output tile
    (``None`` = ``launch_geom``; 1D: only ``w_tile``, on the lifted tile);
    ``compute_dtype`` is the MMA operand dtype (default ``x.dtype``).
    Columns go in BAND_N-wide chunks on both devices.  ``boundary``: one
    mode for every axis, a per-axis tuple or ``None`` (periodic), applied
    before each of the t contractions.
    """
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    w = np.asarray(weights, dtype=np.float32)
    radius, modes = check_grid(x.shape, w, t, boundary,
                               "the banded contraction")
    cdt = x.dtype if compute_dtype is None else compute_dtype
    if x.device.type == "cpu":
        return stencil_matmul_plain(x, w, t, BAND_N, cdt, modes)
    geom = launch_geom(x.shape, t * radius, tile_m, w_tile,
                       need=tile_need(x.shape, w, t, x.dtype, cdt))
    return _run(x, w, t, radius, cdt, geom, modes)


def stencil_matmul_at(x: torch.Tensor, weights, t: int, geom: SubstrateGeom,
                      compute_dtype=None, boundary=None,
                      staging: str = "region",
                      batched: bool = False,
                      budget: int = None) -> torch.Tensor:
    """:func:`stencil_matmul` on a tile the caller resolved with
    ``launch_geom(grid_shape, t * R, ...)``: a plan resolves it once, when
    it is built, and launches every step on it.  ``batched``: ``x`` is
    ``(B,) + grid_shape`` and one launch advances every grid (K11).
    ``budget``: the shared memory per CTA the tile was resolved under
    (None: ``common.smem_budget_bytes()`` now); a 3D launch whose layout
    exceeds it runs the cluster form, and one that no cluster holds (or a
    2D one past it) the workspace form (:func:`launch_layout`; a budget of
    1 byte forces the workspace form), its workspace allocated at each
    launch.  Inside a plan's first call the launch is where the
    ``compile`` and ``vmem`` fault hooks fire."""
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    w = np.asarray(weights, dtype=np.float32)
    shape = batch_grid(x, batched)
    radius, modes = check_grid(shape, w, t, boundary,
                               "the banded contraction")
    cdt = x.dtype if compute_dtype is None else compute_dtype
    check_tile_halo(geom, t * radius)
    check_staging(shape, geom, t * radius, staging)
    faults.on_launch(kernel_source(len(shape)))
    if x.device.type == "cpu":
        return plain_loop(stencil_matmul_plain, x, batched, w, t, BAND_N,
                          cdt, modes)
    return _run(x, w, t, radius, cdt, geom, modes, staging, batched, budget)


def _run(x, w, t, radius, cdt, geom, modes, staging: str = "region",
         batched: bool = False, budget: int = None) -> torch.Tensor:
    launch3d = functools.partial(_launch3d, staging=staging, budget=budget)
    launch2d = functools.partial(_launch2d, staging=staging, budget=budget)
    return run_kernel("stencil_matmul", _launch1d, launch2d, launch3d,
                      x, w, t, radius, cdt, geom, modes, batched)


def run_kernel(name, launch1d, launch2d, launch3d, x, w, t, radius, cdt,
               geom, modes, batched: bool = False) -> torch.Tensor:
    """Launch the banded-family kernel of the grid's rank (the weights')
    on ``geom`` over one grid, or over the batch ``x`` holds when
    ``batched``; or raise.  The launchers take a ``(B,) + grid`` tensor
    (``launch1d`` a (B, N) one, the line's mode code only); ``name`` is
    the wrapper's, for the messages."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    if x.dtype not in _DTYPE_CODES or cdt not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 "
                        f"grids and operands, got {x.dtype} / {cdt}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous grid")
    codes = kernel_mode_codes(modes)
    xb = x if batched else x.unsqueeze(0)
    if w.ndim == 1:
        y = launch1d(xb, w, t, radius, cdt, geom, codes[-1])
    elif w.ndim == 3:
        y = launch3d(xb, w, t, radius, cdt, geom, codes)
    else:
        y = launch2d(xb, w, t, radius, cdt, geom, codes)
    return y if batched else y[0]


def _checked(layout, what: str, deep: bool = False):
    """``layout``, or raise past the 227 KB budget or, unless ``deep``
    (the 1D and 2D kernels on the dense bands), past MAX_KPAD."""
    if layout.kpad > MAX_KPAD and not deep:
        raise ValueError(f"{what} needs a contraction depth of "
                         f"{layout.kpad}, over the kernel's {MAX_KPAD} "
                         "(radius <= 24)")
    if layout.smem_bytes > SMEM_BUDGET_BYTES:
        raise ValueError(f"{what} tile needs {layout.smem_bytes} bytes of "
                         "shared memory, over the 227 KB budget")
    return layout


def slab_launch_layout(geom: SubstrateGeom, radius: int, t: int,
                       compute_bytes: int, dzs: tuple, what: str,
                       k_rows: int = None, a_cols: int = None,
                       budget: int = None, cluster: bool = True,
                       workspace: bool = True, device=None):
    """The 3D folds' shared-memory layout of a launch on ``geom`` with the
    bands ``dzs`` (each band's dz): ``common.slab_fold_layout`` where it
    fits ``budget`` bytes (default: ``common.smem_budget_bytes()``) and
    MAX_KPAD, else its cluster form (``common.slab_cluster``, a
    :class:`ClusterLayout`) where ``cluster``, else its workspace form
    on ``device`` (``common.as_workspace``, any contraction depth) where
    ``workspace``; raise where none applies (a foil's)."""
    budget = smem_budget_bytes() if budget is None else budget
    layout = slab_fold_layout(geom.z_slab, geom.strip_m, geom.w_tile,
                              radius, t, compute_bytes, len(dzs), k_rows,
                              a_cols)
    if layout.smem_bytes <= min(budget, SMEM_BUDGET_BYTES) and \
            layout.kpad <= MAX_KPAD:
        return layout
    spread = (slab_cluster(geom.z_slab, geom.strip_m, geom.w_tile, radius,
                           t, compute_bytes, tuple(dzs), k_rows, a_cols,
                           budget)
              if cluster and layout.kpad <= MAX_KPAD else None)
    if spread is not None:
        return spread
    if workspace:
        return as_workspace(layout, device)
    return _checked(layout, what)


def tile_launch_layout(geom: SubstrateGeom, radius: int, t: int,
                       compute_bytes: int, n_rows: int, what: str,
                       k_rows: int = None, a_cols: int = None,
                       budget: int = None, deep: bool = False,
                       workspace: bool = True, device=None):
    """The 2D folds' layout of a launch on ``geom`` (``common.
    tile_fold_layout``) where it fits ``budget`` bytes (default:
    ``common.smem_budget_bytes()``) and, unless ``deep`` (the dense
    bands), MAX_KPAD; else its workspace form on ``device``
    (``common.as_workspace``, any contraction depth) where ``workspace``;
    raise where it does not apply (a foil's)."""
    budget = smem_budget_bytes() if budget is None else budget
    layout = tile_fold_layout(geom.strip_m, geom.w_tile, radius, t,
                              compute_bytes, n_rows, k_rows, a_cols)
    if layout.smem_bytes <= min(budget, SMEM_BUDGET_BYTES) and \
            (deep or layout.kpad <= MAX_KPAD):
        return layout
    if workspace:
        return as_workspace(layout, device)
    return _checked(layout, what, deep)


def launch_layout(shape, w: np.ndarray, t: int, radius: int,
                  cdt: torch.dtype, geom: SubstrateGeom,
                  staging: str = "region", budget: int = None, device=None):
    """The layout a launch of the dense-band fold on grids of ``shape``
    takes on ``geom`` and on ``device`` (:func:`slab_launch_layout` in 3D,
    :func:`tile_launch_layout` in 2D; a foil has no cluster or workspace
    form): what every launch runs with, and what a plan reports
    (``explain``, the auditor) for its own device."""
    region = staging == "region"
    if len(shape) == 3:
        return slab_launch_layout(geom, radius, t, cdt.itemsize, band_dzs(w),
                                  "3D banded", budget=budget, cluster=region,
                                  workspace=region, device=device)
    return tile_launch_layout(geom, radius, t, cdt.itemsize, band_rows(w),
                              "banded", budget=budget, deep=True,
                              workspace=region, device=device)


def line_launch_layout(geom: SubstrateGeom, radius: int, t: int,
                       in_dtype: torch.dtype, cdt: torch.dtype, what: str,
                       deep: bool = True):
    """The folded 1D kernels' shared-memory layout of a launch, checked
    against the 227 KB budget and, for the compacted kernel (``deep``
    False), the deepest contraction it takes."""
    return _checked(line_layout(geom.w_tile, radius, t, in_dtype.itemsize,
                                cdt.itemsize), what, deep)


def _launch1d(x, w, t, radius, cdt, geom, code) -> torch.Tensor:
    """The folded 1D kernel on the (B, N) lines ``x``: rows of the lifted
    tile's width ``geom.w_tile``, the line's boundary ``code``."""
    layout = line_launch_layout(geom, radius, t, x.dtype, cdt, "1D banded")
    bands = _device_bands(w.tobytes(), w.shape, layout.kpad, cdt,
                          str(x.device))
    y = torch.empty_like(x)
    fn = _launcher1d()
    b, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), bands.data_ptr(), n,
                 geom.w_tile, layout.rows, t, radius, layout.lds, layout.ld,
                 layout.kpad, layout.stage_bytes, layout.warp_bytes,
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[cdt], code, b, n,
                 layout.smem_bytes, stream)
    _build.check(err, "stencil_banded1d")
    _build.count_launch("stencil_banded1d")
    return y


def _launch2d(x, w, t, radius, cdt, geom, codes,
              staging: str = "region", budget: int = None) -> torch.Tensor:
    """The tile fold on the dense bands (``csrc/stencil_banded.cu``) on
    the (B, H, W) grids ``x``; its workspace form where the layout exceeds
    ``budget`` (:func:`launch_layout`; not the foils')."""
    toe, rows = _device_toe(w.tobytes(), w.shape, cdt, str(x.device))
    layout = launch_layout(x.shape[1:], w, t, radius, cdt, geom, staging,
                           budget, x.device)
    y = torch.empty_like(x)
    b, h, wd = x.shape
    if isinstance(layout, WorkspaceLayout):
        lib, counter = "stencil_banded_workspace", "stencil_banded (workspace)"
        fn, stage, lay = _workspace_launcher(2), (), layout.base
        ws, tail = workspace_args(x, layout)
    else:
        lib, fn, stage, counter = _entry(2, staging)
        lay, tail = layout, ()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), toe.data_ptr(), rows.data_ptr(),
                 h, wd, geom.strip_m, geom.w_tile, t, radius, lay.ld,
                 lay.kpad, lay.toe_ld, lay.n_rows,
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[cdt], *stage, *codes,
                 *tail, b, h * wd, layout.smem_bytes, stream)
    _build.check(err, lib)
    _build.count_launch(counter, len(batch_chunks(b)))
    return y


def _launch3d(x, w, t, radius, cdt, geom, codes,
              staging: str = "region", budget: int = None) -> torch.Tensor:
    """The slab fold on the dense bands (``csrc/stencil_banded3d.cu``) on
    the (B, Z, H, W) grids ``x``; its cluster form where the layout
    exceeds ``budget``, its workspace form where no cluster holds it
    (:func:`launch_layout`; not the foil's)."""
    toe, rows = _device_toe(w.tobytes(), w.shape, cdt, str(x.device))
    layout = launch_layout(x.shape[1:], w, t, radius, cdt, geom, staging,
                           budget, x.device)
    y = torch.empty_like(x)
    b, z, h, wd = x.shape
    if isinstance(layout, WorkspaceLayout):
        lib = "stencil_banded3d_workspace"
        counter = "stencil_banded3d (workspace)"
        fn, stage, lay = _workspace_launcher(3), (), layout.base
        ws, tail = workspace_args(x, layout)
    elif isinstance(layout, ClusterLayout):
        lib, counter = "stencil_banded3d_cluster", "stencil_banded3d (cluster)"
        lay = layout.base
        tail = (layout.ctas, _build.c_ints(layout.split),
                _build.c_ints(layout.rows) if layout.rows else None)
        fn, stage = _cluster_launcher3d(), ()
    else:
        lib, fn, stage, counter = _entry(3, staging)
        lay, tail = layout, ()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), toe.data_ptr(), rows.data_ptr(),
                 z, h, wd, geom.z_slab, geom.strip_m, geom.w_tile, t, radius,
                 lay.ld, lay.plane_ld, lay.kpad, lay.toe_ld, lay.n_rows,
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[cdt], *stage, *codes,
                 *tail, b, z * h * wd, layout.smem_bytes, stream)
    _build.check(err, lib)
    _build.count_launch(counter, len(batch_chunks(b)),
                        layout.ctas if isinstance(layout, ClusterLayout) else None)
    return y
