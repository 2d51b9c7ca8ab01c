"""Stencil problem domain: specs, weights, boundaries and the plain
PyTorch oracles (the counterpart of ``repro.stencil``)."""
from .boundary import MODES as BOUNDARY_MODES
from .boundary import BoundarySpec, is_periodic, resolve_boundary
from .spec import StencilSpec, box, star
from .weights import make_weights, jacobi_weights, fuse_weights, fused_num_points, alpha

__all__ = [
    "StencilSpec",
    "box",
    "star",
    "make_weights",
    "jacobi_weights",
    "fuse_weights",
    "fused_num_points",
    "alpha",
    "BOUNDARY_MODES",
    "BoundarySpec",
    "is_periodic",
    "resolve_boundary",
]
