// The 3D banded kernel on the dense band operand: K5/K6 banded, the
// Toeplitz contraction on 3D grids (replaces
// repro/kernels/stencil_matmul.py::stencil_matmul / _banded_step /
// _banded_steps on 3D grids, with the slab substrate of
// repro/kernels/common.py::slab_substrate_call).  The body, its design and
// what bounds it are in slab_fold.cuh; the host builds the operand with
// build_bands_nd, as the JAX package does, one band of (BAND_N + 2R,
// BAND_N) per structurally nonzero x-row (dz, dy), padded with zero rows
// to kpad, and passes each as its Toeplitz row; every k-step of every
// band runs (lo = 0, nk = kpad / K).
//
// The same source built with -DREPRO_FOIL is the library of the
// whole-slab traffic foil (K8, replacing repro/kernels/common.py::_launch
// kind wholeslab via _assemble_foil): this body with the STAGE_STRIP
// staging of common.cuh, the 3 x 3 whole (z, y) neighbour tiles, which
// reads 9 (TN+2h)/TN times the grid for the same compute.
#include "slab_fold.cuh"

// The dense bands: rows is (n_rows, 4) int32, each band's (dz, dy, 0,
// kpad / K), toe the (n_rows, toe_ld) Toeplitz rows of the (kpad, 16)
// bands.  The arguments are the entries'.
template <int STAGE>
static int banded3d(const void* x, void* y, const void* toe, const void* rows, int Z, int H, int W,
                    int TZ, int TM, int TN, int t, int R, int ld, int plane_ld, int kpad,
                    int toe_ld, int n_rows, int dtype, int compute, int mode_z, int mode_y,
                    int mode_x, int B, long long grid_elems, int smem_bytes, void* stream) {
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (grid_elems != (long long)Z * H * W || kpad > MAX_KPAD || kpad % k != 0 ||
        kpad < BAND_N + 2 * R || toe_ld < kpad + BAND_N - 1)
        return (int)cudaErrorInvalidValue;
    SlabArgs a{};
    a.x = x;
    a.y = y;
    a.toe = toe;
    a.rows = static_cast<const int*>(rows);
    a.grid_elems = (size_t)grid_elems;
    a.Z = Z, a.H = H, a.W = W, a.TZ = TZ, a.TM = TM, a.TN = TN, a.t = t, a.R = R;
    a.ld = ld, a.plane_ld = plane_ld, a.toe_ld = toe_ld, a.n_rows = n_rows;
    a.mz = mode_z, a.my = mode_y, a.mx = mode_x;
    return slab_launch_types<STAGE>(a, B, dtype, compute, smem_bytes,
                                    static_cast<cudaStream_t>(stream));
}

#define ARGS x, y, toe, rows, Z, H, W, TZ, TM, TN, t, R, ld, plane_ld, kpad, toe_ld, n_rows, \
             dtype, compute, mode_z, mode_y, mode_x, B, grid_elems, smem_bytes, stream
#if defined(REPRO_WORKSPACE)
// stencil_banded3d_launch's arguments, then the workspace ws of ctas
// slices of slice_bytes each (common.py::WorkspaceLayout: the region and
// the band headers; the Toeplitz rows toe stay where they are), the bands
// of any depth (the composed contraction past MAX_KPAD); smem_bytes must
// be 0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_banded3d_workspace_launch(const void* x, void* y, const void* toe,
                                                 const void* rows, int Z, int H, int W, int TZ,
                                                 int TM, int TN, int t, int R, int ld,
                                                 int plane_ld, int kpad, int toe_ld, int n_rows,
                                                 int dtype, int compute, int mode_z, int mode_y,
                                                 int mode_x, void* ws, long long slice_bytes,
                                                 int ctas, int B, long long grid_elems,
                                                 int smem_bytes, void* stream) {
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (grid_elems != (long long)Z * H * W || kpad % k != 0 || kpad < BAND_N + 2 * R ||
        toe_ld < kpad + BAND_N - 1 || smem_bytes != 0)
        return (int)cudaErrorInvalidValue;
    SlabArgs a{};
    a.x = x;
    a.y = y;
    a.toe = toe;
    a.rows = static_cast<const int*>(rows);
    a.grid_elems = (size_t)grid_elems;
    a.Z = Z, a.H = H, a.W = W, a.TZ = TZ, a.TM = TM, a.TN = TN, a.t = t, a.R = R;
    a.ld = ld, a.plane_ld = plane_ld, a.toe_ld = toe_ld, a.n_rows = n_rows;
    a.mz = mode_z, a.my = mode_y, a.mx = mode_x;
    return slab_workspace_types(a, B, dtype, compute, ws, slice_bytes, ctas,
                                static_cast<cudaStream_t>(stream));
}
#elif defined(REPRO_CLUSTER)
// stencil_banded3d_launch's arguments and the cluster (slab_fold.cuh's
// cluster forms): ctas (2, 4 or 8) and split[0..ctas], rank k owning the
// kernel planes dz [split[k], split[k + 1]) and the bands [bands[k],
// bands[k + 1]) of a one-step launch (t = 1, the composed contraction), or
// the region planes [split[k], split[k + 1]) of a launch of t > 1 steps
// (bands: null); smem_bytes the largest share (common.py::slab_cluster).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_banded3d_cluster_launch(const void* x, void* y, const void* toe,
                                               const void* rows, int Z, int H, int W, int TZ,
                                               int TM, int TN, int t, int R, int ld, int plane_ld,
                                               int kpad, int toe_ld, int n_rows, int dtype,
                                               int compute, int mode_z, int mode_y, int mode_x,
                                               int ctas, const int* split, const int* bands,
                                               int B, long long grid_elems, int smem_bytes,
                                               void* stream) {
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (grid_elems != (long long)Z * H * W || kpad > MAX_KPAD || kpad % k != 0 ||
        kpad < BAND_N + 2 * R || toe_ld < kpad + BAND_N - 1 || ctas < 2 || ctas > MAX_CLUSTER ||
        (t == 1) != (bands != nullptr))
        return (int)cudaErrorInvalidValue;
    SlabArgs a{};
    a.x = x;
    a.y = y;
    a.toe = toe;
    a.rows = static_cast<const int*>(rows);
    a.grid_elems = (size_t)grid_elems;
    a.Z = Z, a.H = H, a.W = W, a.TZ = TZ, a.TM = TM, a.TN = TN, a.t = t, a.R = R;
    a.ld = ld, a.plane_ld = plane_ld, a.toe_ld = toe_ld, a.n_rows = n_rows;
    a.mz = mode_z, a.my = mode_y, a.mx = mode_x;
    const ClusterSplit sp = split_from(ctas, split, bands);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (t == 1) return slab_cluster_launch_types<true>(a, sp, B, dtype, compute, smem_bytes, s);
    return slab_cluster_launch_types<false>(a, sp, B, dtype, compute, smem_bytes, s);
}
#elif !defined(REPRO_FOIL)
// x and y hold B grids of grid_elems = Z * H * W cells each (the batch,
// K11); ld, plane_ld, toe_ld and smem_bytes are the layout of
// repro_torch/kernels/common.py::slab_fold_layout; dtype / compute: 0 =
// float32 (TF32 MMA operands), 1 = bfloat16; mode_z, mode_y, mode_x: each
// axis's boundary code (MODE_*).  Returns the cudaError_t of the launch (0
// on success).
extern "C" int stencil_banded3d_launch(const void* x, void* y, const void* toe, const void* rows,
                                       int Z, int H, int W, int TZ, int TM, int TN, int t, int R,
                                       int ld, int plane_ld, int kpad, int toe_ld, int n_rows,
                                       int dtype, int compute, int mode_z, int mode_y, int mode_x,
                                       int B, long long grid_elems, int smem_bytes, void* stream) {
    return banded3d<STAGE_REGION>(ARGS);
}

// CTAs per SM of the instantiation a launch in these types (dtype,
// compute) and fill takes with smem_bytes (slab_ctas_per_sm).
extern "C" int stencil_banded3d_ctas_per_sm(int dtype, int compute, int fill, int smem_bytes) {
    return slab_ctas_per_sm<STAGE_REGION>(dtype, compute, fill, smem_bytes);
}
#else
// The whole-slab foil: stencil_banded3d_launch's arguments and the
// staging, stage = STAGE_STRIP (any boundary).
extern "C" int stencil_banded3d_foil_launch(const void* x, void* y, const void* toe,
                                            const void* rows, int Z, int H, int W, int TZ, int TM,
                                            int TN, int t, int R, int ld, int plane_ld, int kpad,
                                            int toe_ld, int n_rows, int dtype, int compute,
                                            int stage, int mode_z, int mode_y, int mode_x, int B,
                                            long long grid_elems, int smem_bytes, void* stream) {
    if (stage != STAGE_STRIP) return (int)cudaErrorInvalidValue;
    return banded3d<STAGE_STRIP>(ARGS);
}
#endif
#undef ARGS
