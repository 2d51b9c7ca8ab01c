"""Audit report containers: typed check results with JSON serialization
(the counterpart of ``repro.audit.report``: the same fields, states,
``violations`` and JSON form).

Every proof obligation of the auditor (``repro_torch.audit``) is one
:class:`AuditCheck` -- named, with expected/actual values -- and one
backend x grid audit collects its checks into an :class:`AuditReport`.
Checks come in three states:

  * passed   -- the obligation holds exactly (or within its stated tol);
  * failed   -- model and code disagree: a VIOLATION (``report.ok`` is
    False; ``python -m repro_torch.audit`` exits nonzero);
  * skipped  -- the obligation is not provable here (a launch past
    ``MAX_GRID_STEPS``, non-canonical weights for a spec-level model
    term); recorded with a reason, never counted as a violation.

A check may also be a record (``blocks/priced-vs-launched``): it always
passes and carries its numbers in ``actual``.  A report carries the
launches' executed and useful FLOPs (``flops``) beside its checks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class AuditCheck:
    """One proof obligation of the model==code audit."""

    name: str                    # e.g. "blocks/grid-bytes-model"
    passed: bool
    expected: object = None
    actual: object = None
    detail: str = ""
    skipped: bool = False        # not provable here (reason in detail)

    def to_dict(self) -> dict:
        d = {"name": self.name,
             "status": ("skipped" if self.skipped
                        else "passed" if self.passed else "VIOLATION")}
        if self.expected is not None:
            d["expected"] = _jsonable(self.expected)
        if self.actual is not None:
            d["actual"] = _jsonable(self.actual)
        if self.detail:
            d["detail"] = self.detail
        return d


@dataclasses.dataclass
class AuditReport:
    """All checks of one backend x (grid, t, dtype) audit."""

    backend: str
    grid_shape: Tuple[int, ...]
    t: int
    dtype: str
    checks: List[AuditCheck] = dataclasses.field(default_factory=list)
    #: Non-None when the backend declared itself exempt (the 9-tile foils,
    #: the reference oracle, batched plans).
    exempt: Optional[str] = None
    #: Executed and useful FLOPs of the audited launches per unit
    #: (``audit.flops.flop_totals``); ``None`` until the FLOP audit ran.
    flops: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def violations(self) -> List[AuditCheck]:
        return [c for c in self.checks if not c.passed and not c.skipped]

    def extend(self, checks) -> None:
        self.checks.extend(checks)

    def check(self, name: str) -> Optional[AuditCheck]:
        """The first check named ``name``, or None."""
        return next((c for c in self.checks if c.name == name), None)

    def summary(self) -> str:
        if self.exempt is not None:
            return (f"{self.backend} grid={self.grid_shape} t={self.t}: "
                    f"EXEMPT ({self.exempt})")
        n_skip = sum(1 for c in self.checks if c.skipped)
        head = (f"{self.backend} grid={self.grid_shape} t={self.t}: "
                f"{len(self.checks)} checks, "
                f"{len(self.violations)} violations"
                + (f", {n_skip} skipped" if n_skip else ""))
        lines = [head]
        for c in self.violations:
            lines.append(f"  VIOLATION {c.name}: expected {c.expected!r}, "
                         f"got {c.actual!r} {c.detail}".rstrip())
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "backend": self.backend,
            "grid_shape": list(self.grid_shape),
            "t": self.t,
            "dtype": self.dtype,
            "ok": self.ok,
            "exempt": self.exempt,
            "n_violations": len(self.violations),
            "flops": _jsonable(self.flops),
            "checks": [c.to_dict() for c in self.checks],
        }


def _jsonable(v):
    """Best-effort JSON-safe rendering of expected/actual values."""
    import numpy as np
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)
