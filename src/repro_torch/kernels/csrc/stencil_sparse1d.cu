// The folded 1D banded kernel on the compacted band operand: K7 on 1D
// grids (replaces repro/kernels/stencil_sparse.py:229, the JAX package's
// 1D compacted contraction on the lifted (1, N) view).  The body, its
// design and what bounds it are in line_fold.cuh; the host compacts the
// build_bands_nd operand with compact_bands, as the JAX package does: the
// band keeps its nonzero row hull [lo, lo + BAND_N + span), padded with
// zero rows to nk * K, and only those k-steps run, from column lo of each
// chunk.  The products are those of the dense 1D kernel over the kept
// rows, so on a box or star kernel (whose hull is the whole band) it
// equals stencil_banded1d bit for bit.
#include "line_fold.cuh"

// stencil_banded1d_launch's arguments with the compacted operand: packed
// is (nk * K, 16) in the compute dtype, lo its first kept band row, nk its
// k-steps.  Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_sparse1d_launch(const void* x, void* y, const void* packed, int N, int L,
                                       int TM, int t, int R, int lds, int ld, int lo, int nk,
                                       int stage_bytes, int warp_bytes, int dtype, int compute,
                                       int mode_x, int B, long long grid_elems, int smem_bytes,
                                       void* stream) {
    LineArgs a{};
    a.x = x;
    a.y = y;
    a.band = packed;
    a.grid_elems = grid_elems;
    a.N = N;
    a.L = L;
    a.TM = TM;
    a.t = t;
    a.R = R;
    a.lds = lds;
    a.ld = ld;
    a.lo = lo;
    a.nk = nk;
    a.mode = mode_x;
    a.stage_bytes = stage_bytes;
    a.warp_bytes = warp_bytes;
    return line_launch_types(a, B, dtype, compute, smem_bytes, static_cast<cudaStream_t>(stream));
}
