// The 2D banded kernel on the compacted band operand: K7 on 2D grids
// (replaces repro/kernels/stencil_sparse.py::stencil_sparse_matmul /
// _sparse_banded_step / _sparse_banded_steps, with the halo staging of
// repro/kernels/common.py::_launch).  The body, its design and what bounds
// it are in tile_fold.cuh; the host compacts the build_bands_nd operands
// with compact_bands, as the JAX package does: band p (kernel row dy_p)
// keeps only its nonzero row hull [lo_p, lo_p + BAND_N + span_p), padded
// with zero rows to nk_p * K, and runs only those k-steps, from column
// lo_p of each chunk (Star-2D1R in TF32: 7 k-steps per tile and step
// against the dense kernel's 9).  The products are those of the dense
// kernel over the kept rows, so on a box or star kernel it equals
// stencil_banded bit for bit.
#include "tile_fold.cuh"

#if defined(REPRO_WORKSPACE)
// stencil_sparse_launch's arguments, then the workspace ws of ctas slices
// of slice_bytes each (common.py::WorkspaceLayout: the region and the band
// headers); smem_bytes must be 0.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int stencil_sparse_workspace_launch(const void* x, void* y, const void* toe,
                                               const void* meta, int H, int W, int TM, int TN,
                                               int t, int R, int ld, int a_cols, int toe_ld,
                                               int n_rows, int dtype, int compute, int mode_y,
                                               int mode_x, void* ws, long long slice_bytes,
                                               int ctas, int B, long long grid_elems,
                                               int smem_bytes, void* stream) {
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (grid_elems != (long long)H * W || a_cols > MAX_KPAD + k || smem_bytes != 0)
        return (int)cudaErrorInvalidValue;
    return tile_workspace_types(tile_args(x, y, toe, meta, H, W, TM, TN, t, R, ld, toe_ld, n_rows,
                                          mode_y, mode_x, grid_elems),
                                B, dtype, compute, ws, slice_bytes, ctas,
                                static_cast<cudaStream_t>(stream));
}
#else
// stencil_banded_launch's arguments with the compacted operand: toe holds
// the (n_rows, toe_ld) Toeplitz rows of the compacted bands, meta is
// (n_rows, 4) int32 (0, dy, lo, nk), and a_cols = max_p(lo_p + nk_p * K),
// the widest chunk column a band reads (the wrapper's BandMeta).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int stencil_sparse_launch(const void* x, void* y, const void* toe, const void* meta,
                                     int H, int W, int TM, int TN, int t, int R, int ld,
                                     int a_cols, int toe_ld, int n_rows, int dtype, int compute,
                                     int mode_y, int mode_x, int B, long long grid_elems,
                                     int smem_bytes, void* stream) {
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (grid_elems != (long long)H * W || a_cols > MAX_KPAD + k)
        return (int)cudaErrorInvalidValue;
    return tile_launch_types<STAGE_REGION>(
        tile_args(x, y, toe, meta, H, W, TM, TN, t, R, ld, toe_ld, n_rows, mode_y, mode_x,
                  grid_elems),
        B, dtype, compute, smem_bytes, static_cast<cudaStream_t>(stream));
}

// CTAs per SM of the instantiation a launch in these types (dtype,
// compute) and fill takes with smem_bytes (tile_ctas_per_sm).
extern "C" int stencil_sparse_ctas_per_sm(int dtype, int compute, int fill, int smem_bytes) {
    return tile_ctas_per_sm<STAGE_REGION>(dtype, compute, fill, smem_bytes);
}
#endif
