"""Paper Table 4 (the counterpart of ``benchmarks/table4.py``): dense
against sparse tensor cores, Box-2D1R, t=7, float.

The A100 rows reproduce the paper's ridge shift (81 -> 161), the
bottleneck flip (compute -> memory) and the predicted gain; the paper
measures 3.06x wall clock (its dense baseline sits below its roofline).
The H100 rows ask the same question of the port's card, with the port's
own banded scheme: the dense TF32 tensor-core peak against the 2:4-sparse
one, at D=4, with S = ``sparsity_banded(7, BAND_N)`` (the port contracts
BAND_N = 16-column bands).  The H100 figures are NVIDIA data-sheet figures
(``perfmodel.H100_SXM_DATASHEET``), not measurements.

    PYTHONPATH=src python -m repro_torch.benchmarks.table4
"""
from __future__ import annotations

from repro_torch.core import perfmodel as pm
from repro_torch.kernels.common import BAND_N
from repro_torch.stencil import StencilSpec


def run() -> list[str]:
    out = ["table4.unit,I,ridge,bottleneck,P_actual_TFLOPs,gain"]
    spec = StencilSpec("box", 2, 1)
    w = pm.StencilWorkload(spec, 7, 4)
    dense = pm.perf_matrix(w, pm.A100_FLOAT, 0.47)
    sparse = pm.perf_sparse_matrix(w, pm.A100_FLOAT, 0.47)
    out.append(f"table4.A100-dense-TC,{dense.intensity:.0f},{dense.ridge:.0f},"
               f"{dense.bound.value},{dense.actual_flops/1e12:.2f},1.00x")
    out.append(f"table4.A100-sparse-TC,{sparse.intensity:.0f},{sparse.ridge:.0f},"
               f"{sparse.bound.value},{sparse.actual_flops/1e12:.2f},"
               f"{sparse.actual_flops/dense.actual_flops:.2f}x")
    # H100 (data sheet): dense TF32 tensor cores against 2:4-sparse ones
    hw = pm.H100_SXM_DATASHEET
    s = pm.sparsity_banded(spec.radius * 7, BAND_N)
    hd = pm.perf_matrix(w, hw, s)
    hs = pm.perf_sparse_matrix(w, hw, s)
    out.append(f"table4.H100-dense-TC,{hd.intensity:.0f},{hd.ridge:.0f},"
               f"{hd.bound.value},{hd.actual_flops/1e12:.3f},1.00x")
    out.append(f"table4.H100-sparse-TC,{hs.intensity:.0f},{hs.ridge:.0f},"
               f"{hs.bound.value},{hs.actual_flops/1e12:.3f},"
               f"{hs.actual_flops/hd.actual_flops:.2f}x")
    return out


if __name__ == "__main__":
    print("\n".join(run()))
