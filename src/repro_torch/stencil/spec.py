"""Stencil problem specification.

A stencil is characterized (paper §1) by three parameters:
  * shape  -- ``box`` (full hyper-rectangular neighborhood) or ``star``
              (axis-aligned points only),
  * radius -- ``r`` (a.k.a. order), the neighborhood extent,
  * dim    -- ``d`` the dimensionality of the grid.

``StencilSpec`` is a frozen value object used across the whole stack:
weights generation, the reference oracles, the CUDA kernels and the
performance model.  A copy of ``repro.stencil.spec``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

Shape = str  # "box" | "star"

_VALID_SHAPES = ("box", "star")


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """Static description of a stencil pattern."""

    shape: Shape = "box"
    dim: int = 2
    radius: int = 1

    def __post_init__(self) -> None:
        if self.shape not in _VALID_SHAPES:
            raise ValueError(f"shape must be one of {_VALID_SHAPES}, got {self.shape!r}")
        if self.dim < 1 or self.dim > 3:
            raise ValueError(f"dim must be in [1, 3], got {self.dim}")
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")

    # ------------------------------------------------------------------
    # Geometry
    # ------------------------------------------------------------------
    @property
    def width(self) -> int:
        """Side length of the enclosing box, ``2r + 1``."""
        return 2 * self.radius + 1

    @property
    def kernel_shape(self) -> Tuple[int, ...]:
        return (self.width,) * self.dim

    def support_mask(self) -> np.ndarray:
        """Boolean mask of the stencil support inside the enclosing box."""
        if self.shape == "box":
            return np.ones(self.kernel_shape, dtype=bool)
        # star: points aligned with the coordinate axes through the center
        mask = np.zeros(self.kernel_shape, dtype=bool)
        center = (self.radius,) * self.dim
        mask[center] = True
        for axis in range(self.dim):
            idx = list(center)
            for off in range(-self.radius, self.radius + 1):
                idx[axis] = self.radius + off
                mask[tuple(idx)] = True
        return mask

    @property
    def num_points(self) -> int:
        """K -- number of points in the stencil kernel (paper Table 1)."""
        if self.shape == "box":
            return self.width**self.dim
        return 2 * self.dim * self.radius + 1

    # ------------------------------------------------------------------
    # Work per output point (paper §3.2.1)
    # ------------------------------------------------------------------
    def flops_per_point(self) -> int:
        """C = 2K -- one FMA (mul+add) per neighboring point."""
        return 2 * self.num_points

    def bytes_per_point(self, dtype_bytes: int) -> int:
        """M = 2D -- ideal traffic: one read + one write per point."""
        return 2 * dtype_bytes

    def arithmetic_intensity(self, dtype_bytes: int) -> float:
        """I = C / M = K / D (paper Eq. 6)."""
        return self.num_points / dtype_bytes

    # ------------------------------------------------------------------
    # Convenience naming, e.g. "Box-2D1R" as used by the paper's tables.
    # ------------------------------------------------------------------
    @property
    def name(self) -> str:
        return f"{self.shape.capitalize()}-{self.dim}D{self.radius}R"

    @staticmethod
    def from_name(name: str) -> "StencilSpec":
        """Parse names like ``Box-2D1R`` / ``star-3d2r``."""
        shape, rest = name.lower().split("-")
        d, r = rest.split("d")
        return StencilSpec(shape=shape, dim=int(d), radius=int(r.rstrip("r")))


def box(dim: int, radius: int) -> StencilSpec:
    return StencilSpec("box", dim, radius)


def star(dim: int, radius: int) -> StencilSpec:
    return StencilSpec("star", dim, radius)
