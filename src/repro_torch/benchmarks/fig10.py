"""Paper Figure 10 (the counterpart of ``benchmarks/fig10.py``): memory-
or compute-bound classification of stencil configurations against the
temporal fusion depth, on the paper's A100 and on the port's H100 (NVIDIA
data-sheet figures, ``perfmodel.H100_SXM_DATASHEET``, not measurements).
Reports the transition depth t* per configuration -- the paper's §4.2
finding is box ~ t=3, star ~ t=5 on A100/float.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig10
"""
from __future__ import annotations

from repro_torch.core import perfmodel as pm
from repro_torch.core.selector import transition_depth
from repro_torch.stencil import StencilSpec

CONFIGS = [
    ("Box-2D1R", 4), ("Box-2D3R", 4), ("Box-2D7R", 4),
    ("Star-2D1R", 4), ("Star-2D3R", 4),
    ("Box-3D1R", 4), ("Box-3D2R", 4), ("Star-3D1R", 4),
    ("Box-2D1R", 8), ("Box-3D1R", 8), ("Star-2D1R", 8),
]


def run() -> list[str]:
    out = ["fig10.pattern,dtype,hw,transition_t,bound_at_t1,bound_at_t8"]
    for hw in (pm.A100_FLOAT, pm.H100_SXM_DATASHEET):
        for name, D in CONFIGS:
            spec = StencilSpec.from_name(name)
            tstar = transition_depth(spec, D, hw, t_max=64)
            b1 = pm.bound_state(hw.p_vector, hw.bandwidth,
                                pm.StencilWorkload(spec, 1, D).intensity_vector())
            b8 = pm.bound_state(hw.p_vector, hw.bandwidth,
                                pm.StencilWorkload(spec, 8, D).intensity_vector())
            out.append(f"fig10.{name},{'f32' if D == 4 else 'f64'},"
                       f"{hw.name.split()[0]},{tstar},{b1.value},{b8.value}")
    return out


if __name__ == "__main__":
    print("\n".join(run()))
