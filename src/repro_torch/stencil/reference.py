"""Plain PyTorch oracles for stencil computation (the port's ground truth).

The counterpart of ``repro.stencil.reference``.  Boundary conditions follow
:mod:`repro_torch.stencil.boundary`: per-axis ``periodic``, ``zero``,
``reflect`` and ``replicate``, passed as one mode for every axis or a
per-axis tuple.

``apply_stencil`` is the shift-and-accumulate oracle: O(K) rolls (or
mode-padded slices) in the row-major tap order of the JAX oracle, used to
validate every other execution path.  ``apply_stencil_conv`` is the second
oracle, through ``torch.nn.functional.conv{1,2,3}d`` with cuDNN's TF32 off.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from .boundary import BoundaryLike, is_periodic, resolve_boundary


def _offsets(radius: int, dim: int):
    """All kernel offsets of a radius-R, d-dimensional box, row-major
    (``np.ndindex``) order -- the accumulation order every oracle and the
    kernels share."""
    rng = range(-radius, radius + 1)
    return list(itertools.product(rng, repeat=dim))


def _pad_index(n: int, radius: int, mode: str, device) -> torch.Tensor:
    """Source index of every cell of one axis padded by ``radius`` per side
    (``np.pad`` semantics for wrap / reflect / edge)."""
    i = torch.arange(-radius, n + radius, device=device)
    if mode == "periodic":
        return i % n
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        i = i % period
        return torch.where(i < n, i, period - i)
    raise ValueError(f"no index map for boundary mode {mode!r}")


def pad_boundary(x: torch.Tensor, radius: int, modes) -> torch.Tensor:
    """Pad ``radius`` cells per side with each axis's boundary mode.

    Axes pad sequentially in ascending order, so a later axis's halo is
    built from the already-padded earlier axes -- ``np.pad``'s corner
    semantics, as in the JAX oracle.
    """
    xp = x
    for ax, m in enumerate(modes):
        if m == "zero":
            pad = [0, 0] * x.ndim
            k = 2 * (x.ndim - 1 - ax)        # F.pad lists the last axis first
            pad[k] = pad[k + 1] = radius
            xp = F.pad(xp, pad)
        else:
            idx = _pad_index(xp.shape[ax], radius, m, xp.device)
            xp = xp.index_select(ax, idx)
    return xp


def apply_stencil(x: torch.Tensor, weights,
                  boundary: BoundaryLike = "periodic") -> torch.Tensor:
    """One stencil update:  y[i] = sum_o w[o] * x[i+o], in ``x.dtype``.

    ``weights`` is a dense ``(2R+1,)*d`` kernel (zeros outside support);
    its radius R may exceed the base spec's r (fused kernels).
    """
    w = torch.as_tensor(weights).to(device=x.device, dtype=x.dtype)
    dim = w.ndim
    if x.ndim != dim:
        raise ValueError(f"grid rank {x.ndim} != kernel rank {dim}")
    radius = (w.shape[0] - 1) // 2
    modes = resolve_boundary(boundary, dim)
    periodic = is_periodic(modes)
    xp = None if periodic else pad_boundary(x, radius, modes)

    y = torch.zeros_like(x)
    for off in _offsets(radius, dim):
        widx = tuple(o + radius for o in off)
        if periodic:
            shifted = torch.roll(x, shifts=tuple(-o for o in off),
                                 dims=tuple(range(dim)))
        else:
            sl = tuple(slice(radius + o, radius + o + n)
                       for o, n in zip(off, x.shape))
            shifted = xp[sl]
        y = y + w[widx] * shifted
    return y


def apply_stencil_steps(x: torch.Tensor, weights, t: int,
                        boundary: BoundaryLike = "periodic") -> torch.Tensor:
    """``t`` sequential stencil updates (the un-fused ground truth)."""
    for _ in range(t):
        x = apply_stencil(x, weights, boundary)
    return x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def apply_stencil_conv(x: torch.Tensor, weights,
                       boundary: BoundaryLike = "periodic") -> torch.Tensor:
    """One update through ``F.conv{d}d`` (a correlation with the kernel as
    given, which is the stencil definition).  cuDNN's TF32 is switched off
    for the call, so an f32 grid is computed in f32 on the card too."""
    w = torch.as_tensor(weights).to(device=x.device, dtype=x.dtype)
    dim = w.ndim
    if x.ndim != dim:
        raise ValueError(f"grid rank {x.ndim} != kernel rank {dim}")
    radius = (w.shape[0] - 1) // 2
    xin = pad_boundary(x, radius, resolve_boundary(boundary, dim))
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        out = _CONV[dim](xin[None, None], w[None, None])
    return out[0, 0]
