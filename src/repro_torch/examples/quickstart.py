"""Quickstart (the counterpart of ``examples/quickstart.py``): build a
stencil execution plan once, run it many times.

``stencil_plan`` performs the paper's analytical backend selection, tile
sizing and weight preprocessing exactly once; ``plan(x)`` then executes
with zero re-analysis.  ``stencil_apply`` remains as the one-shot wrapper
(it builds or fetches the same plan from the process cache).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the card unless given ``--device cpu`` (the kernels' plain
versions on the CPU), and exits 1 if a backend lies outside its tolerance
against the oracle (tap-sum 1e-5 * t * max|x|, banded
t * 2^-10 * sum|w| * max|x|) or the wrapper's output differs from the plan's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import perfmodel as pm
from repro_torch.kernels import (plan_cache_stats, registered_backends,
                                 stencil_apply, stencil_plan)
from repro_torch.kernels.ref import oracle_tolerance, stencil_direct_ref
from repro_torch.stencil import StencilSpec, make_weights

T = 4                                          # fuse 4 time steps


def problem(device):
    """The example's stencil, weights and 256^2 grid on ``device``."""
    spec = StencilSpec("box", 2, 1)           # the classic Box-2D1R
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256, 256))
                         .astype(np.float32)).to(device)
    return spec, make_weights(spec, seed=0), x


def backend_errors(device="cuda") -> list:
    """(backend, max|err| vs the oracle, tolerance) of every registered
    backend on a 256^2 Box-2D1R grid at t=4."""
    _, w, x = problem(device)
    ref = stencil_direct_ref(x, w, T)
    rows = []
    for backend in registered_backends():
        plan = stencil_plan(w, x.shape, x.dtype, T, backend=backend,
                            device=device)
        err = float((plan(x) - ref).abs().max())
        rows.append((backend, err, oracle_tolerance(backend, T, w, x)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the "
                         "kernels' plain versions on the CPU")
    spec, w, x = problem(args.device)
    print(f"stencil {spec.name}: K={spec.num_points} points, "
          f"C={spec.flops_per_point()} flops/pt, I={spec.arithmetic_intensity(4)}")

    # every registered backend executes through the same plan object
    ok = True
    for backend, err, tol in backend_errors(args.device):
        ok &= err <= tol
        print(f"  backend={backend:30s} max|err| vs oracle = {err:.2e} "
              f"(tol {tol:.2e})")

    # the paper's criteria as a scheduler (H100 data-sheet constants):
    # selection runs ONCE at plan build; plan.decision is the priced Decision
    hw = pm.H100_SXM_DATASHEET
    plan = stencil_plan(w, x.shape, x.dtype, T, hw=hw, device=args.device)
    print(f"\nauto plan on {hw.name} "
          f"(built in {plan.build_time_s*1e3:.1f} ms):")
    print(plan.explain())

    # serving loop: millions of steps would hit this line only
    y = plan.run(x, n_steps=3)                 # 3 * t = 12 time steps
    ref12 = stencil_direct_ref(x, w, 3 * T)
    print(f"  plan.run(x, 3) err  : {float((y - ref12).abs().max()):.2e}")

    # the compatibility wrapper fetches the SAME cached plan
    y2 = stencil_apply(x, w, t=T, backend="auto", hw=hw)
    same = bool((y2 == plan(x)).all())
    print(f"  wrapper parity      : {'bit-identical' if same else 'MISMATCH'}")
    print(f"  plan cache          : {plan_cache_stats()}")
    return 0 if ok and same else 1


if __name__ == "__main__":
    raise SystemExit(main())
