// The 2D banded kernel on the dense band operand: K3/K6 banded, the
// Toeplitz contraction on 2D grids (replaces
// repro/kernels/stencil_matmul.py::stencil_matmul / _banded_step /
// _banded_steps, with the halo staging of repro/kernels/common.py::
// _launch).  The body, its design and what bounds it are in tile_fold.cuh;
// the host builds the operand with build_bands_nd, as the JAX package
// does, one band of (BAND_N + 2R, BAND_N) per structurally nonzero kernel
// row dy, padded with zero rows to kpad, and passes each as its Toeplitz
// row; every k-step of every band runs (lo = 0, nk = kpad / K).  The main
// build takes bands past MAX_KPAD (a composed kernel past radius 24: 128
// deep at Box-2D7R, t = 8) in pieces of MAX_KPAD (FoldKs::DEEP), and so
// do the foils.
//
// The same source built with -DREPRO_FOIL is the library of the traffic
// foils (K8 whole-strip, replacing repro/kernels/common.py::_launch kind
// wholestrip via _assemble_foil; K10 the seed 9-tile kernel,
// repro/kernels/legacy.py::stencil_matmul_9pt, one contraction of the
// composed kernel): this body with the STAGE_STRIP or STAGE_NINE staging
// of common.cuh, which reads 3 (TN+2h)/TN or 9 times the grid for the
// same compute.
#include "tile_fold.cuh"

// The dense bands: rows is (n_rows, 4) int32, each band's (0, dy, 0,
// kpad / K), toe the (n_rows, toe_ld) Toeplitz rows of the (kpad, 16)
// bands.  The arguments are the entries'.
template <int STAGE>
static int banded2d(const void* x, void* y, const void* toe, const void* rows, int H, int W,
                    int TM, int TN, int t, int R, int ld, int kpad, int toe_ld, int n_rows,
                    int dtype, int compute, int mode_y, int mode_x, int B, long long grid_elems,
                    int smem_bytes, void* stream) {
    constexpr bool kDeep = true;
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (grid_elems != (long long)H * W || (!kDeep && kpad > MAX_KPAD) || kpad % k != 0 ||
        kpad < BAND_N + 2 * R || toe_ld < kpad + BAND_N - 1)
        return (int)cudaErrorInvalidValue;
    return tile_launch_types<STAGE, kDeep>(
        tile_args(x, y, toe, rows, H, W, TM, TN, t, R, ld, toe_ld, n_rows, mode_y, mode_x,
                  grid_elems),
        B, dtype, compute, smem_bytes, static_cast<cudaStream_t>(stream));
}

#define ARGS x, y, toe, rows, H, W, TM, TN, t, R, ld, kpad, toe_ld, n_rows, dtype, compute, \
             mode_y, mode_x, B, grid_elems, smem_bytes, stream
#ifndef REPRO_FOIL
// x and y hold B grids of grid_elems = H * W cells each (the batch, K11);
// ld, toe_ld and smem_bytes are the layout of
// repro_torch/kernels/common.py::tile_fold_layout; dtype / compute: 0 =
// float32 (TF32 MMA operands), 1 = bfloat16; mode_y, mode_x: the rows'
// and the columns' boundary codes (MODE_*).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int stencil_banded_launch(const void* x, void* y, const void* toe, const void* rows,
                                     int H, int W, int TM, int TN, int t, int R, int ld, int kpad,
                                     int toe_ld, int n_rows, int dtype, int compute, int mode_y,
                                     int mode_x, int B, long long grid_elems, int smem_bytes,
                                     void* stream) {
    return banded2d<STAGE_REGION>(ARGS);
}

// CTAs per SM of the instantiation a launch in these types (dtype,
// compute) and fill takes with smem_bytes (tile_ctas_per_sm).
extern "C" int stencil_banded_ctas_per_sm(int dtype, int compute, int fill, int smem_bytes) {
    return tile_ctas_per_sm<STAGE_REGION>(dtype, compute, fill, smem_bytes);
}
#else
// The foils: stencil_banded_launch's arguments and the staging, stage =
// STAGE_STRIP (any boundary) or STAGE_NINE (periodic only).
extern "C" int stencil_banded_foil_launch(const void* x, void* y, const void* toe,
                                          const void* rows, int H, int W, int TM, int TN, int t,
                                          int R, int ld, int kpad, int toe_ld, int n_rows,
                                          int dtype, int compute, int stage, int mode_y,
                                          int mode_x, int B, long long grid_elems,
                                          int smem_bytes, void* stream) {
    if (stage == STAGE_STRIP) return banded2d<STAGE_STRIP>(ARGS);
    if (stage == STAGE_NINE) return banded2d<STAGE_NINE>(ARGS);
    return (int)cudaErrorInvalidValue;
}
#endif
#undef ARGS
