"""Banded (Toeplitz) stencil contraction on the tensor cores (the paper's
"Tensor Core" adaptation): the counterpart of ``repro.kernels.stencil_matmul``.

Transformation (DESIGN.md §2): each nonzero kernel row w[dy, :] becomes a
banded matrix B_dy of shape (tile_n + 2R, tile_n) with B_dy[j+dx, j] =
w[dy, dx] (``build_bands_nd``, host-side, copied from the JAX package so
the operands match bit for bit), and every chunk of ``tile_n`` output
columns is  sum_dy  A_dy @ B_dy,  A_dy the dy-shifted (rows, tile_n + 2R)
slab of the periodically extended input, accumulated in f32 with the
operands in the compute dtype.

``stencil_matmul(x, weights, t)``: ``t=1`` is one contraction of
``weights`` (which may be a composed radius-t*r kernel: monolithic
fusion); ``t>1`` runs t radius-r contractions with f32 intermediates (the
intermediate-reuse regime).  A tensor on the CPU runs
:func:`stencil_matmul_plain`; a CUDA tensor launches the hand-written wmma
kernel ``csrc/stencil_banded.cu`` (TF32 operands for f32, bf16 for bf16,
16-column chunks: BAND_N) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.stencil.boundary import is_periodic
from . import _build
from .common import (BAND_N, SMEM_BUDGET_BYTES, _check_wrap_radius,
                     banded_layout, resolve_tile_geom)

#: Most band rows (kernel rows) one launch takes; must match MAX_ROWS in
#: csrc/stencil_banded.cu.
MAX_ROWS = 64

#: Deepest padded contraction the kernel holds in registers (BAND_N + 2R
#: <= 64, so R <= 24); must match MAX_KPAD in csrc/stencil_banded.cu.
MAX_KPAD = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class _BandRows(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("dy", ctypes.c_int * MAX_ROWS)]


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
                         tile_n: int = BAND_N,
                         compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel on the whole periodic grid: per
    step, pad the columns periodically by R (and with zeros up to whole
    chunks), cut each dy-shifted row slab into (tile_n + 2R)-wide chunks
    at stride ``tile_n`` and contract it with its ``build_bands_nd`` band
    by ``torch.matmul``.  Operands are rounded to the compute dtype and
    multiplied in f32 (exact for bf16), accumulated in f32; the result
    rounds to ``x.dtype`` at the end."""
    w = np.asarray(weights, dtype=np.float32)
    cdt = x.dtype if compute_dtype is None else compute_dtype
    radius = (w.shape[-1] - 1) // 2
    offsets, bands_np = build_bands_nd(w, tile_n)
    bands = torch.from_numpy(bands_np).to(x.device).to(cdt).float()
    h, wd = x.shape
    nc = -(-wd // tile_n)
    rows = (torch.arange(-radius, h + radius, device=x.device) % h)
    cols = (torch.arange(-radius, wd + radius, device=x.device) % wd)
    cur = x.float()
    for _ in range(t):
        xp = cur.index_select(0, rows).index_select(1, cols)
        xp = F.pad(xp, (0, nc * tile_n - wd)).to(cdt).float()
        acc = torch.zeros(h, nc, tile_n, device=x.device)
        for p, (dy,) in enumerate(offsets):
            a = xp[dy:dy + h].unfold(1, tile_n + 2 * radius, tile_n)
            acc = acc + torch.matmul(a, bands[p])
        cur = acc.reshape(h, nc * tile_n)[:, :wd]
    return cur.to(x.dtype)


@functools.lru_cache(maxsize=32)
def _device_bands(w_bytes: bytes, shape: tuple, kpad: int,
                  cdt: torch.dtype, device: str):
    """``(dy offsets, bands)`` of one weight array as the kernel reads them:
    the ``build_bands_nd`` operands padded with zero rows to ``kpad`` and
    stored in the compute dtype on the device, built once per weights,
    dtype and device (plans call the wrapper every step)."""
    w = np.frombuffer(w_bytes, dtype=np.float32).reshape(shape)
    offsets, bands = build_bands_nd(w, BAND_N)
    bands = np.pad(bands, ((0, 0), (0, kpad - bands.shape[1]), (0, 0)))
    return (tuple(dy for (dy,) in offsets),
            torch.from_numpy(bands).to(device=device, dtype=cdt))


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point, built on first use, its ctypes
    signature set once."""
    fn = _build.library("stencil_banded").stencil_banded_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [
        ctypes.POINTER(_BandRows), ctypes.c_int, ctypes.c_void_p]
    return fn


def stencil_matmul(x: torch.Tensor, weights, t: int = 1,
                   tile_m: int = None, w_tile: int = None,
                   compute_dtype=None, boundary=None) -> torch.Tensor:
    """``t`` steps of a 2D periodic grid via banded contractions.

    ``t=1``: one contraction of ``weights`` (possibly a fused radius-t*r
    kernel).  ``t>1``: t radius-r contractions with f32 intermediates kept
    on chip.  ``tile_m`` / ``w_tile`` pin the CTA's output tile;
    ``compute_dtype`` is the MMA operand dtype (default ``x.dtype``).
    Columns go in BAND_N-wide chunks on both devices.  Only periodic
    boundaries run here.
    """
    w = np.asarray(weights, dtype=np.float32)
    if x.ndim != 2 or w.ndim != 2:
        raise NotImplementedError(
            f"the port's banded contraction runs 2D grids, got grid rank "
            f"{x.ndim} and kernel rank {w.ndim}; 1D and 3D are ROADMAP "
            "queue 1, item 8")
    if w.shape[0] != w.shape[1] or w.shape[0] % 2 == 0:
        raise ValueError(f"weights must be a square (2R+1)^2 kernel, "
                         f"got {w.shape}")
    if not is_periodic(boundary):
        raise NotImplementedError(
            f"boundary={boundary!r}: the port's kernels are periodic only; "
            "per-axis boundaries are ROADMAP queue 1, item 9 (K6)")
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    radius = (w.shape[0] - 1) // 2
    _check_wrap_radius(x.shape[-1], radius)
    cdt = x.dtype if compute_dtype is None else compute_dtype
    if x.device.type == "cpu":
        return stencil_matmul_plain(x, w, t, BAND_N, cdt)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_matmul runs on cpu or cuda, got {x.device}")
    if x.dtype not in _DTYPE_CODES or cdt not in _DTYPE_CODES:
        raise TypeError(f"stencil_matmul kernel takes float32 or bfloat16 "
                        f"grids and operands, got {x.dtype} / {cdt}")
    if not x.is_contiguous():
        raise ValueError("stencil_matmul kernel takes a contiguous grid")
    geom = resolve_tile_geom(x.shape, t * radius, tile_m, w_tile)
    layout = banded_layout(geom.strip_m, geom.w_tile, radius, t,
                           cdt.itemsize)
    if layout.kpad > MAX_KPAD:
        raise ValueError(f"radius {radius} needs a contraction depth of "
                         f"{layout.kpad}, over the kernel's {MAX_KPAD} "
                         "(radius <= 24)")
    if layout.smem_bytes > SMEM_BUDGET_BYTES:
        raise ValueError(f"banded tile needs {layout.smem_bytes} bytes of "
                         "shared memory, over the 227 KB budget")
    dys, bands = _device_bands(w.tobytes(), w.shape, layout.kpad, cdt,
                               str(x.device))
    if len(dys) > MAX_ROWS:
        raise ValueError(f"{len(dys)} band rows exceed the kernel's "
                         f"{MAX_ROWS}")
    arg = _BandRows(len(dys))
    for k, dy in enumerate(dys):
        arg.dy[k] = dy
    y = torch.empty_like(x)
    fn = _launcher()
    h, wd = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), bands.data_ptr(), h, wd,
                 geom.strip_m, geom.w_tile, t, radius, layout.rows,
                 layout.ld, layout.a_rows, layout.kpad, _DTYPE_CODES[x.dtype],
                 _DTYPE_CODES[cdt], ctypes.byref(arg), layout.smem_bytes,
                 stream)
    _build.check(err, "stencil_banded")
    _build.count_launch("stencil_banded")
    return y
