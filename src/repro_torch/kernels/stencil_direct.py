"""Tap-sum stencil (the paper's "CUDA core" baseline): the counterpart of
``repro.kernels.stencil_direct``.

``stencil_direct(x, weights, t)`` advances a 2D periodic grid ``t`` fused
steps.  A tensor on the CPU runs :func:`stencil_direct_plain`; a CUDA tensor
launches the hand-written kernel ``csrc/stencil_direct.cu`` or raises.
The kernel accumulates in f32 in the row-major tap order of the JAX kernel
(``stencil_direct.py:91-97``), skips zero taps, and rounds to ``x.dtype``
once, on store.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.stencil.boundary import is_periodic
from . import _build
from .common import (SMEM_BUDGET_BYTES, _check_wrap_radius, direct_layout,
                     resolve_tile_geom)

#: Radii the kernel is specialised on (1..3), and so the most taps it
#: takes (a dense r=3 box); must match csrc/stencil_direct.cu.
MAX_RADIUS = 3
MAX_TAPS = (2 * MAX_RADIUS + 1) ** 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class _Taps(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("dy", ctypes.c_int * MAX_TAPS),
                ("dx", ctypes.c_int * MAX_TAPS),
                ("w", ctypes.c_float * MAX_TAPS)]


def nonzero_taps(weights: np.ndarray):
    """``(dy, dx, w)`` of every nonzero tap in row-major order, ``w`` as
    float32 -- the kernel's tap list."""
    w = np.asarray(weights, dtype=np.float32)
    return [(dy, dx, float(w[dy, dx])) for dy, dx in np.ndindex(*w.shape)
            if w[dy, dx] != 0.0]


def stencil_direct_plain(x: torch.Tensor, weights, t: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``t`` tap-sum steps of the whole
    periodic grid by ``torch.roll``, accumulated in f32 in row-major tap
    order with zero taps skipped, rounded to ``x.dtype`` at the end."""
    w = np.asarray(weights, dtype=np.float32)
    r = (w.shape[0] - 1) // 2
    cur = x.float()
    for _ in range(t):
        acc = torch.zeros_like(cur)
        for dy, dx, wv in nonzero_taps(w):
            acc = acc + wv * torch.roll(cur, shifts=(r - dy, r - dx),
                                        dims=(0, 1))
        cur = acc
    return cur.to(x.dtype)


def _check_args(x: torch.Tensor, w: np.ndarray, boundary) -> int:
    if x.ndim != 2 or w.ndim != 2:
        raise NotImplementedError(
            f"the port's tap-sum runs 2D grids, got grid rank {x.ndim} and "
            f"kernel rank {w.ndim}; 1D and 3D are ROADMAP queue 1, item 8")
    if w.shape[0] != w.shape[1] or w.shape[0] % 2 == 0:
        raise ValueError(f"weights must be a square (2r+1)^2 kernel, "
                         f"got {w.shape}")
    if not is_periodic(boundary):
        raise NotImplementedError(
            f"boundary={boundary!r}: the port's kernels are periodic only; "
            "per-axis boundaries are ROADMAP queue 1, item 9 (K6)")
    r = (w.shape[0] - 1) // 2
    _check_wrap_radius(x.shape[-1], r)
    return r


@functools.lru_cache(maxsize=32)
def _tap_arg(w_bytes: bytes, shape: tuple) -> _Taps:
    """The kernel's by-value tap list of one float32 weight array, built
    once per weights (plans call the wrapper every step; building it took
    most of the wrapper's host time).  The launch copies it, so callers
    share it read-only."""
    taps = nonzero_taps(np.frombuffer(w_bytes, dtype=np.float32).reshape(shape))
    arg = _Taps(len(taps))
    for k, (dy, dx, wv) in enumerate(taps):
        arg.dy[k], arg.dx[k], arg.w[k] = dy, dx, wv
    return arg


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point, built on first use, its ctypes
    signature set once."""
    fn = _build.library("stencil_direct").stencil_direct_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.POINTER(_Taps), ctypes.c_int, ctypes.c_void_p]
    return fn


def stencil_direct(x: torch.Tensor, weights, t: int = 1,
                   tile_m: int = None, w_tile: int = None,
                   boundary=None) -> torch.Tensor:
    """``t`` fused tap-sum steps of a 2D periodic grid.

    ``weights``: host-side (2r+1)^2 ndarray (zeros outside support).
    ``tile_m`` / ``w_tile`` pin the CTA's output tile (multiples of 16;
    ``None`` = ``resolve_tile_geom``).  Only periodic boundaries run here.
    """
    w = np.asarray(weights)
    r = _check_args(x, w, boundary)
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    if x.device.type == "cpu":
        return stencil_direct_plain(x, w, t)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_direct runs on cpu or cuda, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"stencil_direct kernel takes float32 or bfloat16 "
                        f"grids, got {x.dtype}")
    if r > MAX_RADIUS:
        raise ValueError(f"the tap-sum kernel is specialised on radius <= "
                         f"{MAX_RADIUS}, got {r}")
    w32 = np.ascontiguousarray(w, dtype=np.float32)
    arg = _tap_arg(w32.tobytes(), w32.shape)
    if arg.n == 0:
        return torch.zeros_like(x)
    geom = resolve_tile_geom(x.shape, t * r, tile_m, w_tile)
    layout = direct_layout(geom.strip_m, geom.w_tile, t * r)
    if layout.smem_bytes > SMEM_BUDGET_BYTES:
        raise ValueError(f"tap-sum tile needs {layout.smem_bytes} bytes of "
                         "shared memory, over the 227 KB budget")
    if not x.is_contiguous():
        raise ValueError("stencil_direct kernel takes a contiguous grid")
    y = torch.empty_like(x)
    fn = _launcher()
    h, wd = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), h, wd, geom.strip_m,
                 geom.w_tile, t, r, _DTYPE_CODES[x.dtype], ctypes.byref(arg),
                 layout.smem_bytes, stream)
    _build.check(err, "stencil_direct")
    _build.count_launch("stencil_direct")
    return y

