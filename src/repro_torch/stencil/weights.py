"""Stencil weight generation and temporal-fusion composition.

A linear stencil update is a cross-correlation:

    y[i] = sum_o  w[o] * x[i + o],        o in support(spec)

Composing two linear stencil applications is again a linear stencil whose
kernel is the *convolution* of the two kernels:

    corr(w1, corr(w2, x)) == corr(conv(w1, w2), x)

Temporal "kernel fusion" (paper §2.2.3) therefore composes the stencil with
itself ``t`` times; the fused kernel spans radius ``t*r`` and its point count
``K^(t)`` drives the redundancy factor  ``alpha = K^(t) / (t*K)``  (Eq. 9).

This module computes fused kernels *numerically* (exact, shape-agnostic), so
``alpha`` can always be derived from the actual composed support -- matching
the paper's closed form for box stencils (Eq. 10) and providing the correct
value for star stencils (whose fused support is an L1 ball, not a star).

A copy of ``repro.stencil.weights``: the same seed gives the same array
bit for bit.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def convolve(a, b, mode="full"):
    """Direct-method convolution: FFT convolution leaves ~1e-18 junk
    outside the true support, which corrupts structural-zero accounting
    (sparsity factors, fused support counts).  ``scipy.signal`` is
    imported here, not with the module: it takes seconds to import, which
    every rank process of a distributed world would pay."""
    from scipy.signal import convolve as _convolve
    return _convolve(a, b, mode=mode, method="direct")

from .spec import StencilSpec


def make_weights(
    spec: StencilSpec,
    seed: Optional[int] = 0,
    normalize: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """Dense ``(2r+1)^d`` kernel with zeros outside the stencil support.

    ``normalize=True`` scales weights to sum to 1 (a smoothing/Jacobi-like
    kernel) which keeps iterated application numerically stable -- important
    for deep temporal fusion tests.
    """
    rng = np.random.default_rng(seed)
    mask = spec.support_mask()
    w = rng.uniform(0.1, 1.0, size=spec.kernel_shape) * mask
    if normalize:
        w = w / w.sum()
    return w.astype(dtype)


def jacobi_weights(spec: StencilSpec, dtype=np.float32) -> np.ndarray:
    """Uniform averaging kernel (the classic Jacobi iteration weights)."""
    mask = spec.support_mask().astype(np.float64)
    return (mask / mask.sum()).astype(dtype)


def fuse_weights(w: np.ndarray, t: int) -> np.ndarray:
    """Kernel of ``t`` composed applications of ``w`` (full convolution).

    The result spans radius ``t*r``:  shape ``(2*t*r + 1,)*d`` for an input
    kernel of shape ``(2r+1,)*d``.
    """
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    out = w.astype(np.float64)
    for _ in range(t - 1):
        out = convolve(out, w.astype(np.float64), mode="full")
    return out.astype(w.dtype)


@functools.lru_cache(maxsize=None)
def fused_num_points(spec: StencilSpec, t: int) -> int:
    """K^(t): support size of the t-fused kernel (exact).

    For box stencils this equals the paper's closed form ``(2rt+1)^d``.
    A star's t-fused support (the support masks composed t times, as the
    JAX package counts it) is every offset reachable in t star steps: a
    step moves along one axis by at most r, so offset a needs
    ceil(|a_i| / r) steps on axis i, and it is in the support when those
    sum to at most t.  Counted here axis by axis (1 offset of an axis
    takes no step, 2r take k for each k >= 1), in microseconds where the
    composed masks took a minute at radius 6, t = 5 (3D).
    """
    if t == 1:
        return spec.num_points
    if spec.shape == "box":
        return (2 * spec.radius * t + 1) ** spec.dim
    ways = [1] + [0] * t            # offsets so far by the steps they need
    for _ in range(spec.dim):
        nxt = [0] * (t + 1)
        for s, n in enumerate(ways):
            nxt[s] += n
            for k in range(1, t - s + 1):
                nxt[s + k] += n * 2 * spec.radius
        ways = nxt
    return sum(ways)


def alpha(spec: StencilSpec, t: int) -> float:
    """Fusion redundancy factor ``alpha = K^(t) / (t*K)`` (paper Eq. 9/10)."""
    return fused_num_points(spec, t) / (t * spec.num_points)
