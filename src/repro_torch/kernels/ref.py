"""Plain PyTorch oracles for every kernel entry point (the ground truth);
the counterpart of ``repro.kernels.ref``."""
from __future__ import annotations

import torch

from repro_torch.stencil.reference import apply_stencil, apply_stencil_steps
from repro_torch.stencil.weights import fuse_weights


def stencil_direct_ref(x: torch.Tensor, weights, t: int = 1,
                       boundary=None) -> torch.Tensor:
    """Oracle for kernels.stencil_direct: t boundary-aware stencil steps
    (``boundary`` per-axis, ``None`` = periodic)."""
    b = "periodic" if boundary is None else boundary
    return apply_stencil_steps(x, weights, t, b)


def stencil_matmul_ref(x: torch.Tensor, weights,
                       boundary=None) -> torch.Tensor:
    """Oracle for kernels.stencil_matmul: one boundary-aware step of
    ``weights`` (which may itself be a fused kernel)."""
    b = "periodic" if boundary is None else boundary
    return apply_stencil(x, weights, b)


def stencil_fused_matmul_ref(x: torch.Tensor, weights, t: int,
                             boundary=None) -> torch.Tensor:
    """Oracle for the fused-matmul path: t steps == one fused-kernel step."""
    b = "periodic" if boundary is None else boundary
    return apply_stencil_steps(x, weights, t, b)


def fused_kernel(weights, t: int):
    return fuse_weights(weights, t)
