"""repro_torch.audit -- the static plan auditor on the port's own launches
(the counterpart of ``repro.audit``).

Proves the port's byte and FLOP model against what its kernels launch,
without executing anything:

  * :mod:`.blocks`  walks every CTA's staged windows over the launch grid
    (``common.tile_windows`` / ``foil_windows``, ``line_segments``,
    ``line_windows``) and checks them against ``staged_read_bytes`` /
    ``staged_read_amp``; it records the plan's priced read amplification
    beside the launched one, and the cells each CTA's staging copies,
    which the counting build of the kernels measures on the card;
  * :mod:`.scratch` checks each launch's shared-memory layout (disjoint,
    aligned regions; the staged region the tile plus its halo; the 3D
    tap-sum's rings) and that its fixed cell coordinates name the true
    global cells;
  * :mod:`.flops`   mirrors the kernels' compute loops (tap FMAs, MMAs)
    and checks the model's alpha, beta and S terms against them.

Entry points: :func:`audit_context` audits one backend under one
:class:`~repro_torch.kernels.registry.PlanContext` (the plan layer
attaches its report via ``stencil_plan(..., audit=True)`` /
``REPRO_AUDIT=1``); ``python -m repro_torch.audit`` sweeps the registry
over a grid matrix on the CPU and exits nonzero on any violation.
"""
from __future__ import annotations

import math
import re

from .report import AuditCheck, AuditReport
from .blocks import audit_blocks, audited_read_amp, walk_windows
from .scratch import audit_scratch
from .flops import audit_flops

__all__ = [
    "AuditCheck", "AuditReport", "audit_context", "audit_reason_read_amp",
    "audit_blocks", "audit_scratch", "audit_flops", "audited_read_amp",
    "walk_windows",
]


def audit_context(ctx, backend_name: str, flops: bool = True) -> AuditReport:
    """Audit one backend's declared launches under a plan context.

    Returns the report; never raises on violations (callers decide -- the
    sweep exits nonzero, the plan layer counts and attaches).  A backend
    the context cannot build raises its ``build``'s ``ValueError``."""
    from repro_torch.kernels import registry

    bd = registry.get_backend(backend_name)
    report = AuditReport(backend=backend_name,
                         grid_shape=tuple(ctx.grid_shape), t=ctx.t,
                         dtype=str(ctx.dtype).replace("torch.", ""))
    if bd.audit is None:
        report.exempt = "backend declares no audit hook"
        return report
    spec = bd.audit(ctx)
    if spec.exempt is not None:
        report.exempt = spec.exempt
        return report
    bd.build(ctx)            # what ``build`` rejects has nothing to audit
    seen = set()
    for launch in spec.launches:
        if id(launch) in seen:      # t identical sequential launches
            continue
        seen.add(id(launch))
        walk = walk_windows(launch)
        report.extend(audit_blocks(launch, walk))
        report.extend(audit_scratch(launch, walk))
    if flops:
        checks, report.flops = audit_flops(ctx, spec)
        report.extend(checks)
    return report


_READ_AMP_RE = re.compile(r"read_amp=([0-9.]+)x")


def audit_reason_read_amp(reason: str, grid_shape, geom_px,
                          dtype_bytes: int = 4,
                          launched=None) -> AuditCheck:
    """The selector's reason string quotes the PRICED geometry's read_amp
    (``SubstrateGeom.describe``); re-derive that number from the audited
    window walk of the same geometry and compare at the string's printed
    precision (%.3f => 5.0005e-4 absolute).  ``launched`` (a launched
    tile's read amplification, when given) is recorded beside it."""
    m = _READ_AMP_RE.search(reason or "")
    if not m:
        return AuditCheck(
            "blocks/reason-read-amp", False,
            expected="read_amp=<amp>x in the decision reason",
            actual=reason,
            detail="selector reason string must quote the priced "
                   "substrate geometry")
    quoted = float(m.group(1))
    audited = audited_read_amp(tuple(grid_shape), geom_px, dtype_bytes)
    actual = audited if launched is None else {"audited": audited,
                                               "launched": launched}
    return AuditCheck(
        "blocks/reason-read-amp",
        math.isclose(audited, quoted, abs_tol=5.0005e-4),
        expected=quoted, actual=actual,
        detail="reason-string read_amp vs the audited window walk of the "
               "priced geometry (the launched tile's beside it)")
