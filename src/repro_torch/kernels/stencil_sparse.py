"""Sparse-compacted banded contraction on the tensor cores: the counterpart
of ``repro.kernels.stencil_sparse`` (the paper's Sparse-Tensor-Core
regime, ``sparse_matmul`` / ``fused_sparse_matmul``).

The banded operands of ``build_bands_nd`` are mostly structural zeros on
star stencils: a single-tap x-row keeps ``BAND_N`` nonzero band rows of
``BAND_N + 2R``.  :func:`compact_bands` (copied from the JAX package, so
the operands match bit for bit) keeps each band's contiguous nonzero row
hull [lo_p, lo_p + BAND_N + span_p); the contraction of band p then reads
the input slab at offset ``lo_p`` and runs only over those rows.  Dropped
rows are exact zeros, so the result is the dense banded contraction's.

``stencil_sparse_matmul(x, weights, t)`` has the fusion regimes of
``stencil_matmul``: ``t=1`` one contraction, ``t>1`` t radius-r
contractions with f32 intermediates on chip.  A tensor on the CPU runs
:func:`stencil_sparse_matmul_plain`; a CUDA tensor launches a hand-written
kernel (``mma.sync``: TF32 m16n8k4 pairs for f32 operands, bf16 m16n8k16
for bf16 operands, f32 accumulators) or raises: 2D grids
``csrc/stencil_sparse.cu`` (the tile fold, ``csrc/tile_fold.cuh``) and 3D
grids ``csrc/stencil_sparse3d.cu`` (the slab fold,
``csrc/slab_fold.cuh``), each on the compacted bands' Toeplitz rows, 1D
grids ``csrc/stencil_sparse1d.cu``, the folded 1D kernel
(``csrc/line_fold.cuh``) on the compacted band, which equals the dense
folded kernel bit for bit on box and star kernels (the 2D kernel on the
lifted (1, N) view stays reachable as :func:`_launch2d` for
comparison).  The kernels run dense
MMAs over fewer k-steps (no 2:4 ``mma.sp``): band p takes
``kpad_p / K`` steps, kpad_p = BAND_N + span_p rounded up to the K step.
With ``batched=True`` (:func:`stencil_sparse_matmul_at`) ``x`` is
``(B,) + grid_shape`` and one launch advances all B grids (K11).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.stencil.reference import pad_boundary
from repro_torch.stencil.boundary import resolve_boundary
from repro_torch.testing import faults
from . import _build
from .common import (BAND_N, ClusterLayout, SubstrateGeom, TileNeed,
                     WorkspaceLayout, batch_chunks, batch_grid,
                     check_grid, check_tile_halo, fold_need,
                     launch_geom, mma_k_step, plain_loop, workspace_args)
from .stencil_matmul import (_DTYPE_CODES, BATCH_ARGS, build_bands_nd,
                             line_launch_layout, run_kernel,
                             slab_launch_layout, tile_launch_layout,
                             toeplitz_rows, workspace_entry)


def compact_bands(offsets, bands: np.ndarray):
    """Compact banded operands to their structurally-nonzero band rows
    (the JAX ``compact_bands``).

    ``offsets``/``bands`` as returned by ``build_bands_nd``.  Returns
    ``(row_index, packed_bands)``: per band the np.arange of kept
    contraction rows, the contiguous hull [dx_min, dx_max + tile_n) of
    its nonzero rows, and the kept rows of all bands stacked along axis
    0 into one (sum_p(tile_n + span_p), tile_n) array.
    """
    bands = np.asarray(bands)
    if len(offsets) != bands.shape[0]:
        raise ValueError(f"{len(offsets)} offsets != {bands.shape[0]} bands")
    row_index = []
    packed = []
    for p in range(bands.shape[0]):
        nz = np.flatnonzero(np.any(bands[p] != 0, axis=1))
        if nz.size == 0:
            raise ValueError(f"band {p} is all-zero (offset {offsets[p]}); "
                             "build_bands_nd should have dropped it")
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        row_index.append(np.arange(lo, hi))
        packed.append(bands[p, lo:hi])
    return tuple(row_index), np.concatenate(packed, axis=0)


def band_row_meta(row_index, tile_n: int):
    """Per band ``(lo, span, row_start)`` from ``compact_bands`` row
    indices: the input offset, the tap span (kept rows = tile_n + span)
    and the band's first row in the packed operand (the JAX
    ``band_row_meta``)."""
    meta = []
    start = 0
    for idx in row_index:
        lo = int(idx[0])
        span = int(idx.size) - tile_n
        if span < 0:
            raise ValueError(f"band keeps {idx.size} rows < tile_n {tile_n}")
        meta.append((lo, span, start))
        start += int(idx.size)
    return tuple(meta)


def kept_row_fraction(weights, tile_n: int) -> float:
    """Kept-row fraction S = sum_p(tile_n + span_p) / (n_rows * (tile_n +
    2r)) of the compacted operand (<= 1; 1 for box; the JAX
    ``kept_row_fraction``)."""
    w = np.asarray(weights, dtype=np.float32)
    if w.ndim == 1:
        w = w[None, :]
    offsets, bands = build_bands_nd(w, tile_n)
    row_index, packed = compact_bands(offsets, bands)
    radius = (bands.shape[1] - bands.shape[2]) // 2
    return packed.shape[0] / (len(offsets) * (tile_n + 2 * radius))


def stencil_sparse_matmul_plain(x: torch.Tensor, weights, t: int = 1,
                                tile_n: int = BAND_N, compute_dtype=None,
                                boundary=None) -> torch.Tensor:
    """Plain PyTorch version of the compacted kernels on the whole grid (any
    rank): per step, pad every axis by R in its boundary mode
    (``pad_boundary``) and the columns with zeros up to whole chunks, then
    for every band cut its row-shifted slab into (tile_n + span_p)-wide
    chunks at offset ``lo_p`` and stride ``tile_n`` and contract them with
    the band's kept rows by one ``torch.matmul``.  Operands round to the
    compute dtype and multiply in f32, accumulated in f32 in band order;
    the result rounds to ``x.dtype`` at the end."""
    w = np.asarray(weights, dtype=np.float32)
    cdt = x.dtype if compute_dtype is None else compute_dtype
    radius = (w.shape[-1] - 1) // 2
    offsets, bands_np = build_bands_nd(w, tile_n)
    row_index, packed_np = compact_bands(offsets, bands_np)
    meta = band_row_meta(row_index, tile_n)
    packed = torch.from_numpy(packed_np).to(x.device).to(cdt).float()
    shape = tuple(x.shape)
    lead, wd = shape[:-1], shape[-1]
    nc = -(-wd // tile_n)
    modes = resolve_boundary(boundary, len(shape))
    cur = x.float()
    for _ in range(t):
        xp = pad_boundary(cur, radius, modes)
        xp = F.pad(xp, (0, nc * tile_n - wd)).to(cdt).float()
        acc = torch.zeros(lead + (nc, tile_n), device=x.device)
        for off, (lo, span, rs) in zip(offsets, meta):
            sl = tuple(slice(o, o + n) for o, n in zip(off, lead))
            a = xp[sl][..., lo:].unfold(-1, tile_n + span, tile_n)[..., :nc, :]
            acc = acc + torch.matmul(a, packed[rs:rs + tile_n + span])
        cur = acc.reshape(lead + (nc * tile_n,))[..., :wd]
    return cur.to(x.dtype)


class BandMeta(NamedTuple):
    """The compacted operand as the kernels read it, for one weight array
    and MMA K step: per band its leading-axis offset, ``lo`` and k-step
    count ``nk`` (``rows``: offset + (lo, nk)), the kept rows of every band
    padded with zero rows to ``nk * K`` and stacked (``packed``, f32), and
    the operand copy width ``a_cols = max_p(lo_p + nk_p * K)``."""

    rows: Tuple[tuple, ...]
    packed: np.ndarray
    a_cols: int


@functools.lru_cache(maxsize=64)
def _band_meta(w_bytes: bytes, shape: tuple, k_step: int) -> BandMeta:
    w = np.frombuffer(w_bytes, dtype=np.float32).reshape(shape)
    offsets, bands = build_bands_nd(w, BAND_N)
    row_index, packed = compact_bands(offsets, bands)
    rows, blocks = [], []
    for off, (lo, span, rs) in zip(offsets, band_row_meta(row_index, BAND_N)):
        nk = -(-(BAND_N + span) // k_step)
        blocks.append(np.pad(packed[rs:rs + BAND_N + span],
                             ((0, nk * k_step - BAND_N - span), (0, 0))))
        rows.append(tuple(off) + (lo, nk))
    a_cols = max(r[-2] + r[-1] * k_step for r in rows)
    return BandMeta(tuple(rows), np.concatenate(blocks), a_cols)


def band_meta(weights, compute_dtype: torch.dtype) -> BandMeta:
    """:class:`BandMeta` of ``weights`` (1D, 2D or 3D; 1D rows are
    ``(lo, nk)``) for MMA operands in ``compute_dtype``."""
    w = np.ascontiguousarray(weights, dtype=np.float32)
    return _band_meta(w.tobytes(), w.shape,
                      mma_k_step(compute_dtype.itemsize))


def band_toeplitz(meta: BandMeta, k_step: int) -> np.ndarray:
    """The compacted operand as the 2D and 3D kernels read it: each band's
    kept rows, padded to nk * K, as its Toeplitz row (``toeplitz_rows``),
    the rows padded with zeros to the deepest band's max(nk) * K +
    BAND_N."""
    deepest = max(r[-1] for r in meta.rows) * k_step
    toe = np.zeros((len(meta.rows), deepest + BAND_N), np.float32)
    start = 0
    for p, r in enumerate(meta.rows):
        k = r[-1] * k_step
        block = meta.packed[None, start:start + k]
        toe[p, :k + BAND_N] = toeplitz_rows(block)[0]
        start += k
    return toe


@functools.lru_cache(maxsize=32)
def _device_toe(w_bytes: bytes, shape: tuple, cdt: torch.dtype,
                device: str):
    """The :func:`band_toeplitz` rows of one 2D or 3D weight array in the
    compute dtype on the device, built once per weights, dtype and
    device."""
    meta = _band_meta(w_bytes, shape, mma_k_step(cdt.itemsize))
    return torch.from_numpy(band_toeplitz(meta, mma_k_step(cdt.itemsize))
                            ).to(device=device, dtype=cdt)


@functools.lru_cache(maxsize=32)
def _device_operand(w_bytes: bytes, shape: tuple, cdt: torch.dtype,
                    device: str):
    """``(meta, packed, rows)`` of one weight array on the device: the
    :class:`BandMeta`, its packed operand in the compute dtype, and its
    per-band ``rows`` as (dz, dy, lo, nk) int32 (dz = 0 in 2D, dz = dy =
    0 in 1D), built once per weights, dtype and device (plans call the
    wrapper every step)."""
    meta = _band_meta(w_bytes, shape, mma_k_step(cdt.itemsize))
    rows = np.asarray([(0,) * (4 - len(r)) + tuple(r) for r in meta.rows],
                      dtype=np.int32)
    return (meta,
            torch.from_numpy(meta.packed).to(device=device, dtype=cdt),
            torch.from_numpy(rows).to(device))


def sparse_tile_layout(grid_shape, weights, t: int, geom: SubstrateGeom,
                       compute_dtype: torch.dtype,
                       in_dtype: torch.dtype = torch.float32,
                       budget: int = None, device=None):
    """The shared-memory layout the compacted kernel of a grid of this
    rank launches ``weights`` with at ``t`` fused steps on ``geom``.  A 1D
    launch raises when it passes the 227 KB budget (or the deepest
    contraction the kernels take).  A 3D launch of t > 1 steps whose
    layout exceeds ``budget`` (default ``common.smem_budget_bytes()``)
    takes the slab fold's cluster form, and a 2D or 3D launch that no
    cluster holds its workspace form on ``device`` (``stencil_matmul.
    slab_launch_layout`` / ``tile_launch_layout``).
    Plans call it when they are built, for their own device (``explain``,
    the auditor), and the launches at every call, for theirs (the 2D
    kernel on the lifted (1, N) view with the lifted (1, N) grid and
    kernel).  A 1D grid's folded layout depends on the grid's dtype too;
    ``in_dtype`` is it (default: float32, the larger staging)."""
    w = np.asarray(weights, dtype=np.float32)
    radius = (w.shape[-1] - 1) // 2
    cb = compute_dtype.itemsize
    if len(grid_shape) == 1:
        return line_launch_layout(geom, radius, t, in_dtype, compute_dtype,
                                  "1D compacted banded", deep=False)
    meta = band_meta(w, compute_dtype)
    k_rows = max(r[-1] for r in meta.rows) * mma_k_step(cb)
    if len(grid_shape) == 3:
        return slab_launch_layout(geom, radius, t, cb,
                                  tuple(r[0] for r in meta.rows),
                                  "3D compacted banded", k_rows, meta.a_cols,
                                  budget, cluster=t > 1, device=device)
    return tile_launch_layout(geom, radius, t, cb, len(meta.rows),
                              "compacted banded", k_rows, meta.a_cols, budget,
                              device=device)


def tile_need(grid_shape, weights, t: int, dtype: torch.dtype,
              compute_dtype: torch.dtype,
              regime: str = "the compacted banded contraction") -> TileNeed:
    """The compacted fold's own shared memory on a candidate tile at ``t``
    steps of ``weights`` (:func:`sparse_tile_layout`'s, as
    ``common.fold_need``), which the tile rule holds candidates to where
    no reserve fits."""
    w = np.asarray(weights, dtype=np.float32)
    radius = (w.shape[-1] - 1) // 2
    meta = band_meta(w, compute_dtype)
    k_rows = max(r[-1] for r in meta.rows) * mma_k_step(compute_dtype.itemsize)
    dzs = (tuple(r[0] for r in meta.rows) if len(grid_shape) == 3 and t > 1
           else None)                   # the reuse fold's cluster form
    return fold_need(len(grid_shape), radius, t, dtype.itemsize,
                     compute_dtype.itemsize, len(meta.rows), regime, k_rows,
                     meta.a_cols, dzs)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The 2D kernel's C entry point, built on first use, its ctypes
    signature set once."""
    fn = _build.library("stencil_sparse").stencil_sparse_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _workspace_launcher(dim: int):
    """The compacted fold's workspace form's C entry point in 2D or 3D,
    built on first use."""
    return workspace_entry(kernel_source(dim), dim)


@functools.lru_cache(maxsize=None)
def _launcher1d():
    """The folded 1D kernel's C entry point, built on first use."""
    fn = _build.library("stencil_sparse1d").stencil_sparse1d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _launcher3d():
    """The 3D kernel's C entry point, built on first use."""
    fn = _build.library("stencil_sparse3d").stencil_sparse3d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 + BATCH_ARGS
    return fn


@functools.lru_cache(maxsize=None)
def _cluster_launcher3d():
    """The 3D kernel's cluster form's C entry point (the 3D entry's
    arguments, then the cluster's CTAs and its split), built on first
    use."""
    fn = _build.library("stencil_sparse3d_cluster").stencil_sparse3d_cluster_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19 + [
        ctypes.POINTER(ctypes.c_int)] + BATCH_ARGS
    return fn


def kernel_source(ndim: int) -> str:
    """The kernel source a launch on a grid of rank ``ndim`` builds from."""
    return {1: "stencil_sparse1d", 3: "stencil_sparse3d"}.get(
        ndim, "stencil_sparse")


def stencil_sparse_matmul(x: torch.Tensor, weights, t: int = 1,
                          tile_m: int = None, w_tile: int = None,
                          compute_dtype=None, boundary=None) -> torch.Tensor:
    """``t`` steps of a 1D, 2D or 3D grid via compacted banded
    contractions: the function of ``stencil_matmul`` with the same
    arguments (``tile_m`` / ``w_tile`` pin the CTA tile, ``None`` =
    ``launch_geom``; ``compute_dtype`` the MMA operand dtype; ``boundary``
    applied before each of the t contractions)."""
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    w = np.asarray(weights, dtype=np.float32)
    radius, modes = check_grid(x.shape, w, t, boundary,
                               "the compacted banded contraction")
    cdt = x.dtype if compute_dtype is None else compute_dtype
    if x.device.type == "cpu":
        return stencil_sparse_matmul_plain(x, w, t, BAND_N, cdt, modes)
    geom = launch_geom(x.shape, t * radius, tile_m, w_tile,
                       need=tile_need(x.shape, w, t, x.dtype, cdt))
    return _run(x, w, t, radius, cdt, geom, modes)


def stencil_sparse_matmul_at(x: torch.Tensor, weights, t: int,
                             geom: SubstrateGeom, compute_dtype=None,
                             boundary=None,
                             batched: bool = False,
                             budget: int = None) -> torch.Tensor:
    """:func:`stencil_sparse_matmul` on a tile the caller resolved with
    ``launch_geom(grid_shape, t * R, ...)``, as plans do when built.
    ``batched``: ``x`` is ``(B,) + grid_shape`` and one launch advances
    every grid (K11).  ``budget``: the shared memory per CTA the tile was
    resolved under, as in ``stencil_matmul_at``.  Inside a plan's first call the
    launch is where the ``compile`` and ``vmem`` fault hooks fire."""
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    w = np.asarray(weights, dtype=np.float32)
    shape = batch_grid(x, batched)
    radius, modes = check_grid(shape, w, t, boundary,
                               "the compacted banded contraction")
    cdt = x.dtype if compute_dtype is None else compute_dtype
    check_tile_halo(geom, t * radius)
    faults.on_launch(kernel_source(len(shape)))
    if x.device.type == "cpu":
        return plain_loop(stencil_sparse_matmul_plain, x, batched, w, t,
                          BAND_N, cdt, modes)
    return _run(x, w, t, radius, cdt, geom, modes, batched, budget)


def _run(x, w, t, radius, cdt, geom, modes,
         batched: bool = False, budget: int = None) -> torch.Tensor:
    return run_kernel("stencil_sparse_matmul", _launch1d,
                      functools.partial(_launch2d, budget=budget),
                      functools.partial(_launch3d, budget=budget), x, w, t,
                      radius, cdt, geom, modes, batched)


def _launch1d(x, w, t, radius, cdt, geom, code) -> torch.Tensor:
    """The folded 1D kernel on the compacted band, on the (B, N) lines
    ``x``: rows of the lifted tile's width, the line's boundary ``code``."""
    meta, packed, _ = _device_operand(w.tobytes(), w.shape, cdt,
                                      str(x.device))
    layout = sparse_tile_layout(x.shape[1:], w, t, geom, cdt, x.dtype)
    ((lo, nk),) = meta.rows
    y = torch.empty_like(x)
    fn = _launcher1d()
    b, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), packed.data_ptr(), n,
                 geom.w_tile, layout.rows, t, radius, layout.lds, layout.ld,
                 lo, nk, layout.stage_bytes, layout.warp_bytes,
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[cdt], code, b, n,
                 layout.smem_bytes, stream)
    _build.check(err, "stencil_sparse1d")
    _build.count_launch("stencil_sparse1d")
    return y


def _launch2d(x, w, t, radius, cdt, geom, codes,
              budget: int = None) -> torch.Tensor:
    """The tile fold on the compacted bands (``csrc/stencil_sparse.cu``)
    on the (B, H, W) grids ``x``; its workspace form where the layout
    exceeds ``budget``."""
    _, _, rows = _device_operand(w.tobytes(), w.shape, cdt, str(x.device))
    toe = _device_toe(w.tobytes(), w.shape, cdt, str(x.device))
    layout = sparse_tile_layout(x.shape[1:], w, t, geom, cdt, budget=budget,
                                device=x.device)
    y = torch.empty_like(x)
    b, h, wd = x.shape
    if isinstance(layout, WorkspaceLayout):
        lib = "stencil_sparse_workspace"
        counter = "stencil_sparse (workspace)"
        fn, lay = _workspace_launcher(2), layout.base
        ws, tail = workspace_args(x, layout)
    else:
        lib = counter = "stencil_sparse"
        fn, lay, tail = _launcher(), layout, ()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), toe.data_ptr(), rows.data_ptr(),
                 h, wd, geom.strip_m, geom.w_tile, t, radius, lay.ld,
                 lay.a_cols, lay.toe_ld, lay.n_rows,
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[cdt], *codes, *tail,
                 b, h * wd, layout.smem_bytes, stream)
    _build.check(err, lib)
    _build.count_launch(counter, len(batch_chunks(b)))
    return y


def _launch3d(x, w, t, radius, cdt, geom, codes,
              budget: int = None) -> torch.Tensor:
    """The slab fold on the compacted bands (``csrc/stencil_sparse3d.cu``)
    on the (B, Z, H, W) grids ``x``; its cluster form where the layout of
    a launch of t > 1 steps exceeds ``budget``, its workspace form where
    no cluster holds it."""
    _, _, rows = _device_operand(w.tobytes(), w.shape, cdt, str(x.device))
    toe = _device_toe(w.tobytes(), w.shape, cdt, str(x.device))
    layout = sparse_tile_layout(x.shape[1:], w, t, geom, cdt, budget=budget,
                                device=x.device)
    y = torch.empty_like(x)
    b, z, h, wd = x.shape
    if isinstance(layout, WorkspaceLayout):
        lib = "stencil_sparse3d_workspace"
        counter = "stencil_sparse3d (workspace)"
        fn, lay = _workspace_launcher(3), layout.base
        ws, tail = workspace_args(x, layout)
    elif isinstance(layout, ClusterLayout):
        lib, counter = "stencil_sparse3d_cluster", "stencil_sparse3d (cluster)"
        fn, lay = _cluster_launcher3d(), layout.base
        tail = (layout.ctas, _build.c_ints(layout.split))
    else:
        lib = counter = "stencil_sparse3d"
        fn, lay, tail = _launcher3d(), layout, ()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), toe.data_ptr(), rows.data_ptr(),
                 z, h, wd, geom.z_slab, geom.strip_m, geom.w_tile, t, radius,
                 lay.ld, lay.plane_ld, lay.a_cols, lay.toe_ld, lay.n_rows,
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[cdt], *codes, *tail,
                 b, z * h * wd, layout.smem_bytes, stream)
    _build.check(err, lib)
    _build.count_launch(counter, len(batch_chunks(b)),
                        layout.ctas if isinstance(layout, ClusterLayout) else None)
    return y
