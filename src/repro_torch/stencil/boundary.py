"""Per-axis boundary specification for the halo substrate.

A copy of ``repro.stencil.boundary``, so resolved modes and plan keys
match the JAX package without importing it.

A :data:`BoundarySpec` names, for every grid axis, how out-of-domain
neighbor cells are synthesized:

``periodic``
    The domain wraps (the historical — and default — behavior: halo
    fetches walk ``(i±1) mod nb`` and full-width kernels wrap columns).
``zero``
    Out-of-domain cells read as 0 (Dirichlet-0 / zero padding).
``reflect``
    Mirror about the edge *cell*, excluding it (``np.pad`` mode
    ``"reflect"``): cell ``-k`` reads cell ``+k``.  Requires the axis
    extent to exceed the halo depth (``extent >= t*r + 1``).
``replicate``
    The edge cell extends outward (``np.pad`` mode ``"edge"`` /
    clamp-to-edge).

The spec is resolved once at plan time into a per-axis tuple and flows
through the plan-cache key, the launch geometry (index maps +
in-kernel halo fills), the oracle, the auditor and the distributed
stepper.  ``None`` and all-``periodic`` specs take exactly the
historical code paths, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

#: The supported per-axis modes.
MODES: Tuple[str, ...] = ("periodic", "zero", "reflect", "replicate")

#: What callers may pass: nothing, one mode for every axis, or a
#: per-axis sequence (entries may be None meaning periodic).
BoundaryLike = Union[None, str, Sequence[Optional[str]]]

#: A fully resolved spec: one mode string per grid axis.
BoundarySpec = Tuple[str, ...]

#: ``np.pad`` mode implementing each boundary mode.
PAD_MODE = {"periodic": "wrap", "zero": "constant",
            "reflect": "reflect", "replicate": "edge"}


def resolve_boundary(boundary: BoundaryLike, dim: int) -> BoundarySpec:
    """Normalize a user-facing boundary argument to a per-axis tuple.

    ``None`` -> all periodic; a bare string applies to every axis; a
    sequence must have one entry per grid axis (``None`` entries mean
    periodic).  Raises ``ValueError`` on unknown modes or a length
    mismatch -- plan-signature validation calls this, so bad specs fail
    in the caller's frame before any plan is built.
    """
    if boundary is None:
        return ("periodic",) * dim
    if isinstance(boundary, str):
        if boundary not in MODES:
            raise ValueError(f"unknown boundary mode {boundary!r}; "
                             f"expected one of {MODES}")
        return (boundary,) * dim
    modes = tuple("periodic" if m is None else m for m in boundary)
    if len(modes) != dim:
        raise ValueError(f"boundary spec {tuple(boundary)!r} has "
                         f"{len(modes)} entries for a {dim}-D grid")
    for m in modes:
        if m not in MODES:
            raise ValueError(f"unknown boundary mode {m!r}; "
                             f"expected one of {MODES}")
    return modes


def is_periodic(boundary: BoundaryLike) -> bool:
    """True iff the spec resolves to all-periodic (the historical paths)."""
    if boundary is None:
        return True
    if isinstance(boundary, str):
        return boundary == "periodic"
    return all(m in (None, "periodic") for m in boundary)


def boundary_label(modes: Sequence[str]) -> str:
    """Compact human-readable form, e.g. ``reflect×periodic``."""
    return "×".join(modes)
