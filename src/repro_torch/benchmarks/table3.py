"""Paper Table 3 (the counterpart of ``benchmarks/table3.py``): the six
representative cases -- scenario classification, bottlenecks and predicted
performance direction, reproduced from the analytical criteria on the
paper's A100.  The paper's empirically observed direction is listed for
comparison (down / approx / up).

    PYTHONPATH=src python -m repro_torch.benchmarks.table3
"""
from __future__ import annotations

from repro_torch.core import perfmodel as pm
from repro_torch.stencil import StencilSpec

CASES = [
    # (pattern, t, dtype_bytes, hw, S, sparse_unit, paper_observed)
    ("Box-2D1R", 3, 8, pm.A100_DOUBLE, 0.5, False, "down"),
    ("Box-2D3R", 1, 8, pm.A100_DOUBLE, 0.5, False, "approx"),
    ("Box-2D1R", 7, 4, pm.A100_FLOAT, 0.47, True, "up"),
    ("Box-2D7R", 1, 4, pm.A100_FLOAT, 0.47, True, "up"),
    ("Box-3D1R", 3, 8, pm.A100_DOUBLE, 0.5, False, "down"),
    ("Box-3D1R", 7, 4, pm.A100_FLOAT, 0.47, True, "down"),
]


def _direction(speedup: float) -> str:
    if speedup > 1.05:
        return "up"
    if speedup < 0.95:
        return "down"
    return "approx"


def run() -> list[str]:
    out = ["table3.case,pattern,t,hw,scenario,I_vec,I_mat,ridge_vec,ridge_mat,"
           "bottleneck_vec,bottleneck_mat,pred_speedup,pred_dir,paper_dir,match"]
    for i, (name, t, D, hw, S, sp, observed) in enumerate(CASES, 1):
        spec = StencilSpec.from_name(name)
        w = pm.StencilWorkload(spec, t, D)
        c = pm.compare(w, hw, S, use_sparse_unit=sp)
        pred = _direction(c.speedup)
        ridge_m = hw.ridge_sparse if sp else hw.ridge_matrix
        out.append(
            f"table3.case{i},{name},{t},{hw.name.split()[0]},S{c.scenario.value},"
            f"{c.vector.intensity:.2f},{c.matrix.intensity:.2f},"
            f"{hw.ridge_vector:.0f},{ridge_m:.0f},"
            f"{c.vector.bound.value},{c.matrix.bound.value},"
            f"{c.speedup:.3f},{pred},{observed},"
            f"{'YES' if pred == observed else 'NO'}")
    return out


if __name__ == "__main__":
    print("\n".join(run()))
