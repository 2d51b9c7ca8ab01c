// The folded 1D banded kernel on the dense band operand: K3 on 1D grids
// (replaces repro/kernels/stencil_matmul.py:248, the JAX package's 1D
// banded contraction on the lifted (1, N) view).  The body, its design and
// what bounds it are in line_fold.cuh; the host builds the operand with
// build_bands_nd, as the JAX package does, one band of (BAND_N + 2R,
// BAND_N) padded with zero rows to kpad, and every k-step of it runs
// (lo = 0, nk = kpad / K); a band past MAX_KPAD (a composed kernel past
// radius 24) runs the DEEP instantiation.
#include "line_fold.cuh"

// x and y hold B lines of N = grid_elems cells each; bands is (kpad, 16)
// in the compute dtype; L is the lifted tile's width, TM the CTA tile's
// rows; lds, ld, stage_bytes, warp_bytes and smem_bytes the shared-memory
// layout of repro_torch/kernels/common.py::line_layout; dtype / compute:
// 0 = float32 (TF32 MMA operands), 1 = bfloat16; mode_x: the line's
// boundary code (MODE_*).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int stencil_banded1d_launch(const void* x, void* y, const void* bands, int N, int L,
                                       int TM, int t, int R, int lds, int ld, int kpad,
                                       int stage_bytes, int warp_bytes, int dtype, int compute,
                                       int mode_x, int B, long long grid_elems, int smem_bytes,
                                       void* stream) {
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (kpad < BAND_N + 2 * R || kpad % k != 0)
        return (int)cudaErrorInvalidValue;
    LineArgs a{};
    a.x = x;
    a.y = y;
    a.band = bands;
    a.grid_elems = grid_elems;
    a.N = N;
    a.L = L;
    a.TM = TM;
    a.t = t;
    a.R = R;
    a.lds = lds;
    a.ld = ld;
    a.lo = 0;
    a.nk = kpad / k;
    a.mode = mode_x;
    a.stage_bytes = stage_bytes;
    a.warp_bytes = warp_bytes;
    return line_launch_types<true>(a, B, dtype, compute, smem_bytes,
                                   static_cast<cudaStream_t>(stream));
}
