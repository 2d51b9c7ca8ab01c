"""The static plan audit sweep of the port (the counterpart of
``scripts/audit.py``): prove model == code across the registry.

Runs :func:`repro_torch.audit.audit_context` for every registered backend
over ``scripts/audit.py``'s grid matrix (the port's pins: a ``w_tile``
pin stands for JAX's ``w_tile`` / ``w_block`` pair), the port's main
cells (8192^2 Box / Star-2D1R, 512^3 Box / Star-3D1R, 2^26 Box-1D1R, at
t=4) and the wide cells (radius-7 stencils and 3D halos past 9), writes a JSON report, prints one line per audit and exits nonzero
if ANY check is violated.  Everything is static -- no kernel runs, no
card is needed -- so it runs on the CPU:

    PYTHONPATH=src python -m repro_torch.audit [--out AUDIT_torch_report.json]
        [--cells matrix,main,wide]
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import audit
from repro_torch.kernels import registry
from repro_torch.stencil.boundary import resolve_boundary
from repro_torch.stencil.spec import StencilSpec
from repro_torch.stencil.weights import jacobi_weights

# (grid, t, spec kwargs, pins): scripts/audit.py's MATRIX -- the three
# ranks, divisible and remainder widths, the boundary rows.
MATRIX = [
    ((1000,), 2, dict(dim=1, radius=1, shape="star"), {}),
    ((4096,), 3, dict(dim=1, radius=2, shape="star"), {}),
    ((256, 512), 2, dict(dim=2, radius=1, shape="box"), {}),
    ((256, 512), 3, dict(dim=2, radius=2, shape="star"), {}),
    ((128, 257), 2, dict(dim=2, radius=1, shape="box"), dict(w_tile=128)),
    ((128, 300), 2, dict(dim=2, radius=1, shape="star"), dict(w_tile=128)),
    ((32, 64, 128), 2, dict(dim=3, radius=1, shape="box"), {}),
    ((24, 48, 100), 2, dict(dim=3, radius=1, shape="star"), {}),
    ((256, 512), 2, dict(dim=2, radius=1, shape="box"),
     dict(boundary="reflect")),
    ((256, 512), 2, dict(dim=2, radius=2, shape="star"),
     dict(boundary=("zero", "replicate"))),
    ((128, 300), 2, dict(dim=2, radius=1, shape="star"),
     dict(w_tile=128, boundary=("reflect", "periodic"))),
    ((1000,), 2, dict(dim=1, radius=1, shape="star"),
     dict(boundary="replicate")),
    ((32, 64, 128), 2, dict(dim=3, radius=1, shape="box"),
     dict(boundary=("reflect", "periodic", "zero"))),
]

#: The wide stencils and deep halos (past the 3D reserves, the tile rule's
#: second half; csrc's radius-7 tap-sums, the 2D and 1D folds
#: past contraction depth 64; its third rung, the 3D layouts spread over a
#: thread-block cluster), at sizes the sweep walks quickly: Box-2D7R at t
#: = 4 and 8 (h = 28, 56; fused_matmul 72 and 128 deep), Box-3D2R at t =
#: 5, 6 and 8 and Star-3D2R at t = 7 (h = 10, 12, 16, 14: the tap-sum's
#: rings and the composed slab past one CTA from h = 12, the reuse slabs,
#: dense and compacted, at h = 16), a radius-7 line at t = 8, and a zero
#: boundary row.
WIDE_CELLS = [
    ((256, 320), 4, dict(dim=2, radius=7, shape="box"), {}),
    ((200, 300), 8, dict(dim=2, radius=7, shape="box"), {}),
    ((40, 72, 100), 5, dict(dim=3, radius=2, shape="box"), {}),
    ((40, 72, 100), 7, dict(dim=3, radius=2, shape="star"), {}),
    ((40, 72, 100), 6, dict(dim=3, radius=2, shape="box"), {}),
    ((40, 72, 100), 8, dict(dim=3, radius=2, shape="box"), {}),
    ((5000,), 8, dict(dim=1, radius=7, shape="box"), {}),
    ((200, 300), 5, dict(dim=2, radius=7, shape="star"),
     dict(boundary=("zero", "reflect"))),
]

#: The port's main cells (chip_smoke.py's PATHS) at t=4.
MAIN_CELLS = [
    ((8192, 8192), 4, dict(dim=2, radius=1, shape="box"), {}),
    ((8192, 8192), 4, dict(dim=2, radius=1, shape="star"), {}),
    ((512, 512, 512), 4, dict(dim=3, radius=1, shape="box"), {}),
    ((512, 512, 512), 4, dict(dim=3, radius=1, shape="star"), {}),
    ((2**26,), 4, dict(dim=1, radius=1, shape="box"), {}),
]


def context(grid, t, spec_kw, pins):
    """The plan context of one sweep row (Jacobi weights, float32)."""
    spec = StencilSpec(**spec_kw)
    return registry.PlanContext(
        spec=spec, weights=jacobi_weights(spec), grid_shape=tuple(grid),
        dtype=torch.float32, t=t, tile_m=pins.get("tile_m"),
        w_tile=pins.get("w_tile"), z_slab=pins.get("z_slab"),
        boundary=resolve_boundary(pins.get("boundary"), len(grid)))


def sweep(rows):
    """``(reports, incompatible)`` of every backend on every row; a
    backend whose ``build`` rejects the row (monolithic fusion under a
    non-periodic boundary) is listed, not audited."""
    reports, skipped = [], []
    for grid, t, spec_kw, pins in rows:
        for name in registry.registered_backends():
            try:
                rep = audit.audit_context(context(grid, t, spec_kw, pins),
                                          name)
            except ValueError as e:
                skipped.append({"backend": name, "grid": list(grid), "t": t,
                                "reason": str(e)})
                continue
            reports.append(rep)
    return reports, skipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="AUDIT_torch_report.json",
                    help="report path (default AUDIT_torch_report.json)")
    ap.add_argument("--cells", default="matrix,main,wide",
                    help="comma list of 'matrix', 'main' and 'wide' (default "
                         "all three)")
    args = ap.parse_args(argv)
    rows = []
    for name in args.cells.split(","):
        rows += {"matrix": MATRIX, "main": MAIN_CELLS,
                 "wide": WIDE_CELLS}[name.strip()]
    reports, skipped = sweep(rows)
    for rep in reports:
        print(rep.summary())
    violations = sum(len(r.violations) for r in reports)
    audited = [r for r in reports if r.exempt is None]
    payload = {
        "ok": violations == 0,
        "n_audits": len(audited),
        "n_exempt": len(reports) - len(audited),
        "n_violations": violations,
        "n_checks": sum(len(r.checks) for r in reports),
        "incompatible_configs": skipped,
        "reports": [r.to_dict() for r in reports],
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"audit: {len(audited)} audits ({payload['n_checks']} checks), "
          f"{payload['n_exempt']} exempt, {len(skipped)} incompatible "
          f"configs, {violations} violations -> {args.out}")
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
