"""Paper Figure 16 (the counterpart of ``benchmarks/fig16.py``): throughput
of the vector and the matrix path.

Two views:
  * MODEL: GStencils/s of the vector path (``fused_direct``) and the matrix
    path (``fused_matmul``, one banded contraction of the composed kernel)
    predicted by the enhanced roofline for an H100 SXM (NVIDIA data-sheet
    figures, ``perfmodel.H100_SXM_DATASHEET``), the matrix path at
    S = ``sparsity_banded(r*t, BAND_N)``, as the port's selector prices it;
  * WALL: the port's own plans of both paths timed on the card with CUDA
    events (``repro_torch.benchmarks.timing.time_us``) at full width --
    8192^2 for the 2D patterns, 512^3 for Box-3D1R -- as microseconds per
    call and GStencils/s (grid points x t per second), columns ``card_``.
    The JAX figure could only time CPU ``jnp`` lowerings.  Each plan is
    first held against the ``reference`` backend's output (tap-sum
    1e-5 * t * max|x|, banded t * 2^-10 * sum|w| * max|x|), and a plan the
    port refuses at a shape (at build or at its first launch) prints its
    refusal in its column: nothing falls back to another regime.

With ``device="cpu"`` the WALL view times the plans' plain versions on the
JAX figure's small grids (256^2, 48^3) with the host clock, in columns
``cpu_``.  Every row carries the name of the device it was timed on.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import perfmodel as pm
from repro_torch.kernels import stencil_plan
from repro_torch.kernels.common import BAND_N
from repro_torch.kernels.ref import oracle_tolerance
from repro_torch.stencil import StencilSpec, make_weights

PATTERNS = ["Box-2D1R", "Star-2D1R", "Box-2D3R", "Box-2D7R", "Box-3D1R"]
#: The grids of the WALL view, by rank: full width on the card, the JAX
#: figure's on the CPU.
GRIDS = {"cuda": {2: (8192, 8192), 3: (512, 512, 512)},
         "cpu": {2: (256, 256), 3: (48, 48, 48)}}
#: The two paths: (model unit, backend).
PATHS = (("vector", "fused_direct"), ("matrix", "fused_matmul"))
#: Timed calls per plan after one warm-up (``quick``: fewer).
ITERS, QUICK_ITERS = 10, 3


def model_gstencils(spec: StencilSpec, t: int, hw, unit: str) -> float:
    """Predicted GStencils/s (one update = one point and step)."""
    w = pm.StencilWorkload(spec, t, 4)
    if unit == "vector":
        p = pm.perf_vector(w, hw)
    else:
        p = pm.perf_matrix(w, hw, pm.sparsity_banded(spec.radius * t, BAND_N))
    return p.stencil_throughput(w) * t / 1e9


def _host_us(fn, x, iters: int) -> float:
    fn(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    return (time.perf_counter() - t0) / iters * 1e6


def _wall(spec, t, w, x, ref, backend, device, iters):
    """(us per call, None) of the checked plan, or (None, refusal)."""
    try:
        plan = stencil_plan(w, tuple(x.shape), x.dtype, t, backend=backend,
                            device=device)
        y = plan(x)
    except ValueError as e:               # the port refuses this regime here
        return None, str(e)
    err = float((y - ref).abs().max())
    tol = oracle_tolerance(backend, t, w, x)
    if not err <= tol:
        raise RuntimeError(f"fig16: {spec.name} {backend} on {tuple(x.shape)}: "
                           f"max|err| vs reference {err:.3e} > tol {tol:.3e}")
    del y
    if device == "cpu":
        return _host_us(plan, x, iters), None
    from repro_torch.benchmarks.timing import time_us
    return time_us(plan, x, iters=iters, warmup=1), None


def run(device="cuda", quick: bool = False, patterns=None) -> list[str]:
    hw = pm.H100_SXM_DATASHEET
    p = "cpu_" if device == "cpu" else "card_"
    name = "cpu" if device == "cpu" else torch.cuda.get_device_name(0)
    iters = QUICK_ITERS if quick else ITERS
    out = [f"fig16.pattern,t,model_vec_GSt/s,model_mat_GSt/s,model_winner,grid,"
           f"{p}vec_us,{p}vec_GSt/s,{p}mat_us,{p}mat_GSt/s,{p}winner,device"]
    for pattern in PATTERNS if patterns is None else patterns:
        spec = StencilSpec.from_name(pattern)
        t = 4 if spec.dim == 2 else 2              # the JAX figure's depths
        gv = model_gstencils(spec, t, hw, "vector")
        gm = model_gstencils(spec, t, hw, "matrix")
        shape = GRIDS["cpu" if device == "cpu" else "cuda"][spec.dim]
        w = make_weights(spec, seed=0)
        x = torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                             .astype(np.float32)).to(device)
        ref = stencil_plan(w, shape, torch.float32, t, backend="reference",
                           device=device)(x)
        cols, us = [], {}
        for unit, backend in PATHS:
            us[unit], refusal = _wall(spec, t, w, x, ref, backend, device, iters)
            if refusal is None:
                rate = x.numel() * t / us[unit] / 1e3
                cols += [f"{us[unit]:.1f}", f"{rate:.4g}"]
            else:
                cols += ["refused: " + refusal.replace(",", ";"), "-"]
        timed = {u: v for u, v in us.items() if v is not None}
        winner = min(timed, key=timed.get) if timed else "-"
        out.append(f"fig16.{pattern},{t},{gv:.1f},{gm:.1f},"
                   f"{'vector' if gv >= gm else 'matrix'},"
                   f"{'x'.join(map(str, shape))},{','.join(cols)},{winner},{name}")
        del x, ref
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.fig16")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    print("\n".join(run(args.device, args.quick)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
