// Sparse-compacted banded (Toeplitz) stencil contraction on the tensor
// cores for Hopper (sm_90a): t steps of a 2D stencil with per-axis
// boundaries (periodic, zero, reflect, replicate), one (TM x TN) output
// tile per CTA, every product an mma.sync (TF32 m16n8k4 pairs for f32
// operands, bf16 m16n8k16 for bf16 operands) with f32 accumulators.  1D
// grids run it on the lifted (1, N) view.
//
// Replaces repro/kernels/stencil_sparse.py::stencil_sparse_matmul /
// _sparse_banded_step / _sparse_banded_steps (on 2D grids and the 1D
// lift), with the halo staging of repro/kernels/common.py::_launch.  The
// host compacts the build_bands_nd operands with compact_bands, as the
// JAX package does: band p (kernel row dy_p) keeps only its contiguous
// nonzero row hull [lo_p, lo_p + BAND_N + span_p), here padded with zero
// rows to kpad_p = nk_p * K and stacked in one packed array (compute
// dtype, K-aligned row starts).  An output chunk of 16 columns is
// sum_p  A_p @ B_p,  A_p the dy_p-shifted (16, kpad_p) slab of the input
// region from column lo_p of the chunk: band p runs nk_p k-steps where the
// dense kernel (stencil_banded.cu) runs kpad / K on every band.  On a star
// only the centre row spans 2R; for Star-2D1R in TF32 that is 7 k-steps
// per tile and step against 9.
//
// What bounds it on an H100: bytes, as the dense kernel (the stencil's
// useful FLOPs are far below the 495 TFLOP/s TF32 roof); so it keeps the
// dense kernel's design and differs only in the products.  Each tile's
// (TM+2h) x (TN+2h) region is read from global memory once (h = t*R,
// modulo indices), all t steps run in shared memory in f32, the x-halo is
// carried and both axes shrink by R per step, and the tile is written
// once, masked at the ragged edge.  Each step fills the non-periodic axes
// (fill_boundary, common.cuh; FILL instantiation only) and waits, then
// copies the f32 region into the chunked operand array
// A[c][row][k] = region[row][16c + k] in the compute dtype, a_cols =
// max_p(lo_p + kpad_p) columns wide (a band with lo_p > 0 reads past the
// dense kpad), zero for k >= BAND_N + 2R and past the region's valid
// extent, so a shifted read never leaves zeroed storage and NaN * 0
// never reaches a valid output.  wmma cannot load an A operand from a
// column lo_p that is not a multiple of the K step, so the products are
// mma.sync with per-lane fragment loads (sparse_mma.cuh); each warp takes
// two 16x16 output tiles, runs every band against them with its B
// fragments from global memory (L1/L2-resident), and stores the sums back
// into the region.  Measured on the card, the dense kernel spends its time
// on the copies and the global load, not on the MMAs, so the compacted
// kernel is expected to run close to it.
//
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// replacing repro/kernels/common.py::fold_batch mode vmap; common.cuh,
// grid_at / for_each_chunk); B = 1 is the unbatched call.
#include "sparse_mma.cuh"

#define MAX_ROWS 64

// Per band p: its kernel row dy, its input offset lo and its k-steps nk
// (kpad_p = nk * K rows in the packed array, bands in order).
struct SparseRows {
    int n;
    int dy[MAX_ROWS];
    int lo[MAX_ROWS];
    int nk[MAX_ROWS];
};

// Shared memory: the f32 region (rows x ld), then the chunked operand array
// (chunks x a_rows x a_cols, compute dtype), 128-byte aligned.  The host
// sizes all of these (repro_torch/kernels/common.py::sparse_layout) and
// passes the byte count at launch.
template <typename TIn, typename TC, bool FILL>
__global__ void __launch_bounds__(CTA_THREADS)
stencil_sparse_kernel(const TIn* __restrict__ x, TIn* __restrict__ y,
                      const TC* __restrict__ packed, int H, int W, int TM, int TN, int t,
                      int R, int rows, int ld, int a_rows, int a_cols, int my, int mx,
                      SparseRows br, size_t grid_elems) {
    using M = Mma<TC>;
    extern __shared__ __align__(128) unsigned char smem[];
    float* const region = reinterpret_cast<float*>(smem);
    TC* const achunks = reinterpret_cast<TC*>(smem + align128((size_t)rows * ld * sizeof(float)));

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q4 = lane & 3;
    const int halo = t * R;
    const int h0 = TM + 2 * halo, w0 = TN + 2 * halo;
    const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
    const int band_k = BAND_N + 2 * R;  // rows of one dense band
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }

    load_region<STAGE_REGION>(region, ld, nullptr, x, H, W, i0 - halo, j0 - halo, h0, w0, TM,
                              TN);
    __syncthreads();
    const bool fill =
        FILL && (leaves_domain(my, i0 - halo, h0, H) || leaves_domain(mx, j0 - halo, w0, W));

    int hin = h0, win = w0;
    for (int s = 0; s < t; ++s) {
        const int ho = hin - 2 * R, wo = win - 2 * R;
        const int nch = (wo + BAND_N - 1) / BAND_N;
        const int ntiles = ((ho + MMA_TILE - 1) / MMA_TILE) * nch;
        if (fill) {
            const int depth = (t - s) * R;
            fill_boundary(region, 0, ld, 1, hin, win, 0, i0 - depth, j0 - depth, 1, H, W, depth,
                          MODE_PERIODIC, my, mx);
        }

        // Chunked, rounded, zero-padded copy of the step's input, a_cols
        // wide.  Four rows per warp at a time, so four loads are in flight.
        for (int c = 0; c < nch; ++c) {
            const int c0 = c * BAND_N;
            const int kv = min(band_k, win - c0);
            TC* dst = achunks + (size_t)c * a_rows * a_cols;
            for (int rb = warp * 4; rb < a_rows; rb += CTA_WARPS * 4)
                for (int k = lane; k < a_cols; k += 32) {
                    float v[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        v[u] = (rb + u < hin && k < kv) ? region[(rb + u) * ld + c0 + k] : 0.f;
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (rb + u < a_rows) dst[(rb + u) * a_cols + k] = M::cvt(v[u]);
                }
        }
        __syncthreads();

        for (int base = 0; base < ntiles; base += CTA_WARPS * MAX_TILES_PER_WARP) {
            SpAcc acc;
#pragma unroll
            for (int u = 0; u < MAX_TILES_PER_WARP; ++u)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc.c[u][h][e] = 0.f;

            // Tiles past the last are clamped onto it (computed, not
            // stored), so the loops carry no branches.
            const TC* tile_a[MAX_TILES_PER_WARP];
#pragma unroll
            for (int u = 0; u < MAX_TILES_PER_WARP; ++u) {
                const int tile = min(base + u * CTA_WARPS + warp, ntiles - 1);
                const int mt = tile / nch, nt = tile - mt * nch;
                tile_a[u] = achunks + (size_t)(nt * a_rows + mt * MMA_TILE) * a_cols;
            }
            const TC* bp = packed;
            for (int p = 0; p < br.n; ++p) {
                const int shift = br.dy[p] * a_cols + br.lo[p];
                const TC* a[MAX_TILES_PER_WARP];
#pragma unroll
                for (int u = 0; u < MAX_TILES_PER_WARP; ++u) a[u] = tile_a[u] + shift;
                sparse_band<TC>(acc, bp, a, a_cols, br.nk[p], g, q4);
                bp += br.nk[p] * SpMma<TC>::K * BAND_N;
            }
            // The operands live in achunks, so the sums may overwrite the region.
#pragma unroll
            for (int u = 0; u < MAX_TILES_PER_WARP; ++u) {
                const int tile = base + u * CTA_WARPS + warp;
                if (tile < ntiles) {
                    const int mt = tile / nch, nt = tile - mt * nch;
                    store_acc(acc, u, region + (size_t)mt * MMA_TILE * ld + nt * BAND_N, ld, g,
                              q4);
                }
            }
        }
        __syncthreads();
        hin = ho;
        win = wo;
    }

    store_tile(y, H, W, i0, j0, TM, TN, region, ld);
}

template <typename TIn, typename TC>
static int launch(const void* x, void* y, const void* packed, int H, int W, int TM, int TN,
                  int t, int R, int rows, int ld, int a_rows, int a_cols, int my, int mx,
                  const SparseRows* br, int B, long long grid_elems, int smem_bytes,
                  cudaStream_t stream) {
    for (int p = 0; p < br->n; ++p)
        if (br->nk[p] < 1 || br->nk[p] > SpMma<TC>::MAX_KS || br->lo[p] < 0 ||
            br->lo[p] + br->nk[p] * SpMma<TC>::K > a_cols)
            return (int)cudaErrorInvalidValue;
    const bool fill = my != MODE_PERIODIC || mx != MODE_PERIODIC;
    auto* kernel =
        fill ? stencil_sparse_kernel<TIn, TC, true> : stencil_sparse_kernel<TIn, TC, false>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    cudaError_t err = prepare_launch(kernel, attributes_set[fill]);
    if (err != cudaSuccess) return (int)err;
    return for_each_chunk(B, [&](int b0, int nb) {
        dim3 grid((W + TN - 1) / TN, (H + TM - 1) / TM, nb);
        kernel<<<grid, CTA_THREADS, smem_bytes, stream>>>(
            grid_at(static_cast<const TIn*>(x), b0, grid_elems),
            grid_at(static_cast<TIn*>(y), b0, grid_elems), static_cast<const TC*>(packed), H, W,
            TM, TN, t, R, rows, ld, a_rows, a_cols, my, mx, *br, (size_t)grid_elems);
        return (int)cudaGetLastError();
    });
}

// dtype / compute: 0 = float32 (TF32 MMA operands), 1 = bfloat16; packed is
// (sum_p nk_p * K, 16) in the compute dtype, band by band; mode_y, mode_x:
// the rows' and the columns' boundary codes (MODE_*); x and y hold B grids
// of grid_elems = H * W cells each (the batch, K11).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int stencil_sparse_launch(const void* x, void* y, const void* packed, int H, int W,
                                     int TM, int TN, int t, int R, int rows, int ld, int a_rows,
                                     int a_cols, int dtype, int compute, int mode_y, int mode_x,
                                     const SparseRows* br, int B, long long grid_elems,
                                     int smem_bytes, void* stream) {
    if (br->n < 1 || br->n > MAX_ROWS || grid_elems != (long long)H * W)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS x, y, packed, H, W, TM, TN, t, R, rows, ld, a_rows, a_cols, mode_y, mode_x, br, B, \
             grid_elems, smem_bytes, s
    if (dtype == 0 && compute == 0) return launch<float, float>(ARGS);
    if (dtype == 0 && compute == 1) return launch<float, __nv_bfloat16>(ARGS);
    if (dtype == 1 && compute == 0) return launch<__nv_bfloat16, float>(ARGS);
    if (dtype == 1 && compute == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}
