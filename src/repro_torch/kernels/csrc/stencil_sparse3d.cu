// The 3D banded kernel on the compacted band operand: K7 on 3D grids
// (replaces repro/kernels/stencil_sparse.py::stencil_sparse_matmul /
// _sparse_banded_step / _sparse_banded_steps on 3D grids, with the slab
// substrate of repro/kernels/common.py::slab_substrate_call).  The body,
// its design and what bounds it are in slab_fold.cuh; the host compacts
// the build_bands_nd operands with compact_bands, as the JAX package does:
// band p (kernel x-row (dz_p, dy_p)) keeps only its nonzero row hull
// [lo_p, lo_p + BAND_N + span_p), padded with zero rows to nk_p * K, and
// runs only those k-steps, from column lo_p of each chunk (Star-3D1R in
// TF32: 11 k-steps per tile and step against the dense kernel's 27).  The
// products are those of the dense kernel over the kept rows, so on a box
// or star kernel it equals stencil_banded3d bit for bit.
#include "slab_fold.cuh"

#ifdef REPRO_CLUSTER
// stencil_sparse3d_launch's arguments and the cluster of a launch of t > 1
// steps (the reuse split of slab_fold.cuh): ctas (2, 4 or 8) and
// split[0..ctas], rank k owning the region planes [split[k], split[k + 1]);
// smem_bytes the largest share (common.py::slab_cluster).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int stencil_sparse3d_cluster_launch(const void* x, void* y, const void* toe,
                                               const void* meta, int Z, int H, int W, int TZ,
                                               int TM, int TN, int t, int R, int ld, int plane_ld,
                                               int a_cols, int toe_ld, int n_rows, int dtype,
                                               int compute, int mode_z, int mode_y, int mode_x,
                                               int ctas, const int* split, int B,
                                               long long grid_elems, int smem_bytes,
                                               void* stream) {
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (grid_elems != (long long)Z * H * W || a_cols > MAX_KPAD + k || t < 2 || ctas < 2 ||
        ctas > MAX_CLUSTER)
        return (int)cudaErrorInvalidValue;
    SlabArgs a{};
    a.x = x;
    a.y = y;
    a.toe = toe;
    a.rows = static_cast<const int*>(meta);
    a.grid_elems = (size_t)grid_elems;
    a.Z = Z, a.H = H, a.W = W, a.TZ = TZ, a.TM = TM, a.TN = TN, a.t = t, a.R = R;
    a.ld = ld, a.plane_ld = plane_ld, a.toe_ld = toe_ld, a.n_rows = n_rows;
    a.mz = mode_z, a.my = mode_y, a.mx = mode_x;
    return slab_cluster_launch_types<false>(a, split_from(ctas, split, nullptr), B, dtype,
                                            compute, smem_bytes,
                                            static_cast<cudaStream_t>(stream));
}
#else
// stencil_banded3d_launch's arguments with the compacted operand: toe
// holds the (n_rows, toe_ld) Toeplitz rows of the compacted bands, meta
// is (n_rows, 4) int32 (dz, dy, lo, nk), and a_cols = max_p(lo_p + nk_p *
// K), the widest chunk column a band reads (the wrapper's BandMeta).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_sparse3d_launch(const void* x, void* y, const void* toe, const void* meta,
                                       int Z, int H, int W, int TZ, int TM, int TN, int t, int R,
                                       int ld, int plane_ld, int a_cols, int toe_ld, int n_rows,
                                       int dtype, int compute, int mode_z, int mode_y, int mode_x,
                                       int B, long long grid_elems, int smem_bytes, void* stream) {
    const int k = compute == 0 ? SpMma<float>::K : SpMma<__nv_bfloat16>::K;
    if (grid_elems != (long long)Z * H * W || a_cols > MAX_KPAD + k)
        return (int)cudaErrorInvalidValue;
    SlabArgs a{};
    a.x = x;
    a.y = y;
    a.toe = toe;
    a.rows = static_cast<const int*>(meta);
    a.grid_elems = (size_t)grid_elems;
    a.Z = Z, a.H = H, a.W = W, a.TZ = TZ, a.TM = TM, a.TN = TN, a.t = t, a.R = R;
    a.ld = ld, a.plane_ld = plane_ld, a.toe_ld = toe_ld, a.n_rows = n_rows;
    a.mz = mode_z, a.my = mode_y, a.mx = mode_x;
    return slab_launch_types<STAGE_REGION>(a, B, dtype, compute, smem_bytes,
                                           static_cast<cudaStream_t>(stream));
}

// CTAs per SM of the instantiation a launch in these types (dtype,
// compute) and fill takes with smem_bytes (slab_ctas_per_sm).
extern "C" int stencil_sparse3d_ctas_per_sm(int dtype, int compute, int fill, int smem_bytes) {
    return slab_ctas_per_sm<STAGE_REGION>(dtype, compute, fill, smem_bytes);
}
#endif
