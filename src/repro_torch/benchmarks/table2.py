"""Paper Table 2 (the counterpart of ``benchmarks/table2.py``): analytical
against measured C / M / I.

The analytic columns come from the performance model (Eq. 8/11).  The
"measured" C is counted by ``repro_torch.core.hlo_cost.analyze_program``
over the aten ops of the same two programs that the JAX table compiles:
the vector path is t applications of ``apply_stencil_valid`` (the
distributed stepper's local update) on the (N + 2tr)^2 halo-extended grid,
the matrix path the per-row banded contraction on (128, TILE_N + 2R) x
(TILE_N + 2R, TILE_N) operands (``build_bands``).  Eager torch counts each
step's multiply and add on every element it produces, so a fused vector
row counts 2K * sum_{s<t} (N + 2sr)^2 / N^2 per point, where XLA counts
its fusion as one FLOP per produced element (JAX prints 53.4 and 125.9
where this table prints 54.4 and 129.0).  The table reproduces the paper's
and is no measurement of the card: the counts are the same on any device
(``chip_smoke.py`` holds the card's count to the CPU's).

    PYTHONPATH=src python -m repro_torch.benchmarks.table2 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import perfmodel as pm
from repro_torch.core.hlo_cost import analyze_program
from repro_torch.kernels.stencil_matmul import build_bands
from repro_torch.stencil import StencilSpec, fuse_weights, make_weights
from repro_torch.stencil.distributed import apply_stencil_valid

N = 512          # benchmark grid edge (points counted per point at the end)
TILE_N = 128

ROWS = [
    # (impl, spec, t, dtype_bytes, S) -- S None = vector path
    ("vector(EBISU-like)", StencilSpec("box", 2, 1), 3, 8, None),
    ("vector(EBISU-like)", StencilSpec("box", 2, 3), 1, 8, None),
    ("vector(EBISU-like)", StencilSpec("box", 2, 1), 7, 4, None),
    ("vector(EBISU-like)", StencilSpec("box", 2, 7), 1, 4, None),
    ("matrix(banded-MXU)", StencilSpec("box", 2, 1), 3, 8, "banded"),
    ("matrix(banded-MXU)", StencilSpec("box", 2, 1), 7, 4, "banded"),
    ("matrix(ConvStencil-S)", StencilSpec("box", 2, 1), 3, 8, 0.5),
    ("matrix(SPIDER-S)", StencilSpec("box", 2, 1), 7, 4, 0.47),
]


def _grid(shape, dtype, device) -> torch.Tensor:
    x = np.random.default_rng(0).normal(size=shape)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def measured_vector(spec, t, dtype, device) -> float:
    """Counted FLOPs per point of the t-fused vector-unit program."""
    w = make_weights(spec, seed=0).astype(np.float64 if dtype == torch.float64
                                          else np.float32)
    sup = w != 0
    n = N + 2 * t * spec.radius

    def run(xe):
        for _ in range(t):
            xe = apply_stencil_valid(xe, w, support=sup)
        return xe

    return analyze_program(run, _grid((n, n), dtype, device)).flops / (N * N)


def measured_matrix(spec, t, dtype, device) -> float:
    """Counted FLOPs per output point of the banded-matmul program: one
    (128, TILE_N + 2R) x (TILE_N + 2R, TILE_N) product per kernel row of
    the radius-tr composed kernel, accumulated."""
    wf = fuse_weights(make_weights(spec, seed=0), t)
    R = (wf.shape[0] - 1) // 2
    bands = torch.from_numpy(build_bands(wf.astype(np.float32), TILE_N)).to(
        device=device, dtype=dtype)

    def run(a):
        acc = torch.zeros((128, TILE_N), dtype=dtype, device=device)
        for dy in range(2 * R + 1):
            acc = acc + a @ bands[dy]
        return acc

    a = _grid((128, TILE_N + 2 * R), dtype, device)
    return analyze_program(run, a).flops / (128 * TILE_N)


def rows(device="cuda") -> list[dict]:
    """Every row's numbers, C_measured unrounded."""
    out = []
    for impl, spec, t, D, S in ROWS:
        w = pm.StencilWorkload(spec, t, D)
        dtype = torch.float32 if D == 4 else torch.float64
        if S is None:
            c_model = w.flops_vector()
            c_meas = measured_vector(spec, t, dtype, device)
            i_model = w.intensity_vector()
        else:
            s_val = (pm.sparsity_banded(spec.radius * t, TILE_N)
                     if S == "banded" else S)
            c_model = w.flops_matrix(s_val)
            i_model = w.intensity_matrix(s_val)
            c_meas = (measured_matrix(spec, t, dtype, device) if S == "banded"
                      else c_model)      # published-scheme S: no local program
        out.append(dict(impl=impl, pattern=spec.name, t=t, D=D, c_model=c_model,
                        c_meas=c_meas, i_model=i_model,
                        m_ideal=w.bytes_per_output()))
    return out


def run(device="cuda") -> list[str]:
    out = ["table2.impl,pattern,t,dtype,C_analytic,C_measured,dC%,I_analytic,M_ideal"]
    for r in rows(device):
        d = 100 * (r["c_meas"] - r["c_model"]) / r["c_model"]
        out.append(f"table2.{r['impl']},{r['pattern']},{r['t']},"
                   f"{'f32' if r['D'] == 4 else 'f64'},"
                   f"{r['c_model']:.1f},{r['c_meas']:.1f},{d:+.1f}%,"
                   f"{r['i_model']:.2f},{r['m_ideal']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.table2")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    print("\n".join(run(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
