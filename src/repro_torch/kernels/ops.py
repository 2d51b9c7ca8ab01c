"""One-shot entry points over the plan API (the counterpart of
``repro.kernels.ops``).

``stencil_apply(x, weights, t, backend="auto")`` builds-or-fetches the
:class:`~repro_torch.kernels.plan.StencilPlan` of the call's signature on
``x``'s device and runs it.  Backends: ``direct``, ``fused_direct``,
``matmul``, ``fused_matmul``, ``fused_matmul_reuse``, ``sparse_matmul``
and ``fused_sparse_matmul`` (the banded operand compacted to its nonzero
band rows; priced only under ``use_sparse_unit``), ``reference``, the
unpriced traffic foils (``legacy_direct``, ``legacy_matmul`` and the
``*_wholestrip`` regimes), and ``auto`` (the selector decides among the
priced ones).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import perfmodel as pm
from repro_torch.core.selector import Decision
from repro_torch.stencil.boundary import resolve_boundary
from . import registry
from .common import BAND_N
from .plan import (auto_decision, decide, geom_pricing, spec_from_weights,
                   stencil_plan)


def __getattr__(name):
    # Computed on access so late-registered backends are visible.
    if name == "BACKENDS":
        return registry.registered_backends() + ("auto",)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def stencil_apply(
    x: torch.Tensor,
    weights,
    t: int = 1,
    backend: str = "auto",
    hw: pm.HardwareSpec = pm.H100_SXM_DATASHEET,
    tile_m: Optional[int] = None,
    w_tile: Optional[int] = None,
    compute_dtype=None,
    use_sparse_unit: bool = False,
    guard: bool = False,
    watchdog: Optional[bool] = None,
    boundary=None,
) -> torch.Tensor:
    """Advance the grid ``t`` time steps with the selected backend, on
    ``x``'s device: equivalent to ``stencil_plan(weights, x.shape,
    x.dtype, t, device=x.device, ...)(x)``.  ``guard=True`` routes through
    the guarded execution layer (``repro_torch.kernels.guard``): kernel
    failures degrade down the fallback ladder instead of raising, and
    ``watchdog`` (None = the ``REPRO_NAN_WATCHDOG`` env flag) arms the
    NaN/Inf check with a checked re-run.  On a clean run both paths run
    the identical cached plan."""
    kw = dict(hw=hw, backend=None if backend == "auto" else backend,
              tile_m=tile_m, w_tile=w_tile, compute_dtype=compute_dtype,
              use_sparse_unit=use_sparse_unit, boundary=boundary,
              device=x.device)
    if guard:
        from .guard import guarded_stencil_plan
        plan = guarded_stencil_plan(weights, x.shape, x.dtype, t,
                                    watchdog=watchdog, **kw)
    else:
        plan = stencil_plan(weights, x.shape, x.dtype, t, **kw)
    return plan(x)


def explain(
    weights, t: int, dtype_bytes: int = 4,
    hw: pm.HardwareSpec = pm.H100_SXM_DATASHEET,
    tile_n: Optional[int] = None,
    strip_m: int = 128, h_block: Optional[int] = None,
    w_tile: Optional[int] = None, w_block: Optional[int] = None,
    grid_shape=None, tile_m: Optional[int] = None,
    use_sparse_unit: bool = False,
    boundary=None,
) -> Decision:
    """The dispatch decision (scenario, predicted speedup, reason) through
    ``plan.decide``, the one decision path plans use.  With ``grid_shape``
    (1D, 2D or 3D, and the ``tile_m`` / ``w_tile`` pins a plan would get)
    the CTA tile resolves exactly as in ``stencil_plan``, so the result
    equals that plan's ``decision``; without it the decision is priced at
    the given ``strip_m`` / ``h_block`` / ``w_tile`` / ``w_block``.
    ``tile_n`` defaults to the banded kernel's chunk width BAND_N."""
    spec = spec_from_weights(weights)
    geom_args = dict(strip_m=strip_m, h_block=h_block, w_tile=w_tile,
                     w_block=w_block)
    if grid_shape is not None:
        geom_args = geom_pricing(auto_decision(
            spec, grid_shape, {2: torch.bfloat16, 8: torch.float64}.get(
                dtype_bytes, torch.float32), t, tile_m=tile_m,
            w_tile=w_tile)[0])
    if boundary is not None:
        boundary = resolve_boundary(boundary, spec.dim)
    return decide(spec, t, dtype_bytes, hw,
                  tile_n=BAND_N if tile_n is None else tile_n,
                  use_sparse_unit=use_sparse_unit, boundary=boundary,
                  **geom_args)
