"""Sweet-spot explorer (the counterpart of
``examples/sweet_spot_explorer.py``): the paper's Figures 9/13/14 decision
surfaces as tables, for the paper's A100 and for the port's H100 (NVIDIA
data-sheet figures, ``perfmodel.H100_SXM_DATASHEET``, not measurements).

    PYTHONPATH=src python -m repro_torch.examples.sweet_spot_explorer
"""
from repro_torch.core import perfmodel as pm
from repro_torch.kernels.common import BAND_N
from repro_torch.stencil import StencilSpec


def surface(hw, sparsity_fn, use_sparse, title) -> list[str]:
    out = [f"\n=== {title} ===",
           "pattern      " + "".join(f"  t={t:<3}" for t in range(1, 9))]
    for name in ("Box-2D1R", "Box-2D3R", "Star-2D1R", "Box-3D1R", "Box-2D7R"):
        spec = StencilSpec.from_name(name)
        row = []
        for t in range(1, 9):
            s = sparsity_fn(spec, t)
            c = pm.compare(pm.StencilWorkload(spec, t, 4), hw, s,
                           use_sparse_unit=use_sparse)
            mark = {1: "=", 2: "x", 3: "O", 4: "o" if c.profitable else "x"}[
                c.scenario.value]
            row.append(mark)
        out.append(f"{name:12s} " + "".join(f"    {m} " for m in row))
    out.append("  O = breaks the ceiling (scenario 3)   o = sweet spot (scenario 4)")
    out.append("  x = matrix unit loses                 = = equal (both memory-bound)")
    return out


def lines() -> list[str]:
    # paper setting: ConvStencil-style S=0.5 on A100 float
    out = surface(pm.A100_FLOAT, lambda s, t: 0.5, False,
                  "A100 fp32, dense Tensor Cores, S=0.5 (Fig. 9)")
    # paper §4.3: Sparse Tensor Cores widen the region (Fig. 13/14)
    out += surface(pm.A100_FLOAT, lambda s, t: 0.47, True,
                   "A100 fp32, SPARSE Tensor Cores, S=0.47 (Fig. 14)")
    # the port's card with its banded scheme's structural sparsity
    out += surface(pm.H100_SXM_DATASHEET,
                   lambda s, t: pm.sparsity_banded(s.radius * t, BAND_N), False,
                   f"H100 SXM fp32/TF32 (data sheet), banded tensor-core "
                   f"scheme, BAND_N={BAND_N} (this port)")
    out.append(f"""
Reading the H100 surface: the port contracts bands BAND_N = {BAND_N} columns
wide, so S = (2R+1)/({BAND_N}+2R) stays large (0.5 at R=7, against 0.11 on
128-wide tiles), and the data sheet's TF32 tensor cores run 7.4x the f32
CUDA cores.  Radius-1 2D stencils stay memory-bound on the CUDA cores up to
t=8, so both units tie; the wide 2D stencils (r=3, 7) favour the tensor
cores (O, then o) from t=2 (r=7: t=1) until fusion's redundancy alpha
outgrows S * P_TC / P_CU at t=8; Box-3D1R loses from t=3, its alpha growing as the cube of the
composed width -- the paper's criteria, instantiated for the card, say when
the banded path is worth it (repro_torch.benchmarks.fig16 times both paths
on the card).""")
    return out


def main():
    print("\n".join(lines()))


if __name__ == "__main__":
    main()
