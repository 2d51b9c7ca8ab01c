// Sparse-compacted banded (Toeplitz) stencil contraction on the tensor
// cores for Hopper (sm_90a): t steps of a 3D stencil with per-axis
// boundaries (periodic, zero, reflect, replicate), one (TZ x TM x TN)
// output tile per CTA, every product an mma.sync (TF32 m16n8k4 pairs for
// f32 operands, bf16 m16n8k16 for bf16 operands) with f32 accumulators.
//
// Replaces repro/kernels/stencil_sparse.py::stencil_sparse_matmul /
// _sparse_banded_step / _sparse_banded_steps on 3D grids, with the slab
// substrate of repro/kernels/common.py::slab_substrate_call.  The host
// compacts the build_bands_nd operands with compact_bands, as the JAX
// package does: band p (kernel x-row (dz_p, dy_p)) keeps only its nonzero
// row hull [lo_p, lo_p + BAND_N + span_p), padded with zero rows to
// kpad_p = nk_p * K and stacked in one packed array (compute dtype), and
// beside it the (dz, dy, lo, nk) of every band, both in device memory (a
// composed Box-3D1R kernel at t = 4 has 81 bands).  A 16 x 16 output tile
// of plane z, rows m.., columns c.. is  sum_p A_p @ B_p,  A_p the
// (16, kpad_p) slab of input plane z + dz_p, rows m + dy_p.., columns
// c + lo_p..: band p runs nk_p k-steps where the dense kernel
// (stencil_banded3d.cu) runs kpad / K on every band (Star-3D1R in TF32:
// 11 per tile and step against 15).
//
// What bounds it on an H100: bytes, as the dense kernel; it keeps that
// kernel's design and differs only in the products.  Each tile's
// (TZ+2h)(TM+2h)(TN+2h) region is read from global memory once (h = t*R,
// modulo indices, 64-bit offsets), all t steps run in shared memory in
// f32, every axis shrinks by R per step, and the tile is written once,
// masked at every ragged edge.  Each step fills the non-periodic axes
// (fill_boundary, common.cuh; FILL instantiation only) and waits, then
// walks its 16-column output chunks in order: chunk c copies the region's
// columns [16c, 16c + a_cols) of every plane into the operand array
// A[plane][row][k] in the compute dtype, a_cols = max_p(lo_p + kpad_p)
// wide, zero for k >= BAND_N + 2R and past the region's valid extent;
// each warp runs every band against two output tiles with mma.sync from
// per-lane fragment loads (sparse_mma.cuh: band p's A operand starts at
// column lo_p, which wmma cannot load) and stores the sums back into the
// region at columns [16c, 16c + 16).  Chunk c + 1 reads from column
// 16(c + 1) on, so the in-place store is safe and A holds one chunk.
//
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// replacing repro/kernels/common.py::fold_batch mode vmap; common.cuh,
// grid_at / for_each_chunk); B = 1 is the unbatched call.
#include "sparse_mma.cuh"

// Shared memory: the f32 region (planes x rows x ld), then one chunk's
// operand array (planes x a_rows x a_cols, compute dtype), 128-byte
// aligned.  The host sizes all of these (repro_torch/kernels/common.py::
// sparse3d_layout) and passes the byte count at launch.  meta holds the
// (dz, dy, lo, nk) of each of the n_rows bands.
template <typename TIn, typename TC, bool FILL>
__global__ void __launch_bounds__(CTA_THREADS)
stencil_sparse3d_kernel(const TIn* __restrict__ x, TIn* __restrict__ y,
                        const TC* __restrict__ packed, const int* __restrict__ meta, int Z,
                        int H, int W, int TZ, int TM, int TN, int t, int R, int rows, int ld,
                        int a_rows, int a_cols, int n_rows, int gx, int gy, int mz, int my,
                        int mx, size_t grid_elems) {
    using M = Mma<TC>;
    extern __shared__ __align__(128) unsigned char smem[];
    const int halo = t * R;
    const int p0 = TZ + 2 * halo, h0 = TM + 2 * halo, w0 = TN + 2 * halo;
    const int rplane = rows * ld;        // region plane stride (f32)
    const int aplane = a_rows * a_cols;  // operand plane stride (compute dtype)
    float* const region = reinterpret_cast<float*>(smem);
    TC* const achunk = reinterpret_cast<TC*>(smem + align128((size_t)p0 * rplane * sizeof(float)));

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q4 = lane & 3;
    const Tile3 tl = tile3(blockIdx.x, gx, gy);
    const int k0 = tl.bz * TZ, i0 = tl.by * TM, j0 = tl.bx * TN;
    const int band_k = BAND_N + 2 * R;  // rows of one dense band
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }

    load_region3d<STAGE_REGION>(region, ld, rplane, nullptr, x, Z, H, W, k0 - halo, i0 - halo,
                                j0 - halo, p0, h0, w0, TZ, TM);
    __syncthreads();
    const bool fill = FILL && (leaves_domain(mz, k0 - halo, p0, Z) ||
                               leaves_domain(my, i0 - halo, h0, H) ||
                               leaves_domain(mx, j0 - halo, w0, W));

    int pin = p0, hin = h0, win = w0;
    for (int s = 0; s < t; ++s) {
        const int po = pin - 2 * R, ho = hin - 2 * R, wo = win - 2 * R;
        const int nch = (wo + BAND_N - 1) / BAND_N;
        const int mtiles = (ho + MMA_TILE - 1) / MMA_TILE;
        const int ntiles = po * mtiles;
        const int arows = pin * a_rows;  // (plane, row) pairs of A
        if (fill) {
            const int depth = (t - s) * R;
            fill_boundary(region, rplane, ld, pin, hin, win, k0 - depth, i0 - depth, j0 - depth,
                          Z, H, W, depth, mz, my, mx);
        }
        for (int c = 0; c < nch; ++c) {
            const int c0 = c * BAND_N;
            const int kv = min(band_k, win - c0);
            // Chunk c's rounded, zero-padded operands, a_cols wide; four
            // (plane, row) pairs per warp at a time, so four loads are in
            // flight.
            for (int rb = warp * 4; rb < arows; rb += CTA_WARPS * 4)
                for (int k = lane; k < a_cols; k += 32) {
                    float v[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const int fr = rb + u;
                        const int pl = fr / a_rows, rr = fr - pl * a_rows;
                        v[u] = (fr < arows && rr < hin && k < kv)
                                   ? region[pl * rplane + rr * ld + c0 + k]
                                   : 0.f;
                    }
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (rb + u < arows) achunk[(rb + u) * a_cols + k] = M::cvt(v[u]);
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
                    const int zp = tile / mtiles, mt = tile - zp * mtiles;
                    tile_a[u] = achunk + zp * aplane + mt * MMA_TILE * a_cols;
                }
                const TC* bp = packed;
                for (int p = 0; p < n_rows; ++p) {
                    const int nk = __ldg(meta + 4 * p + 3);
                    const int shift = __ldg(meta + 4 * p) * aplane +
                                      __ldg(meta + 4 * p + 1) * a_cols + __ldg(meta + 4 * p + 2);
                    const TC* a[MAX_TILES_PER_WARP];
#pragma unroll
                    for (int u = 0; u < MAX_TILES_PER_WARP; ++u) a[u] = tile_a[u] + shift;
                    sparse_band<TC>(acc, bp, a, a_cols, nk, g, q4);
                    bp += nk * SpMma<TC>::K * BAND_N;
                }
                // The operands live in achunk, and no later chunk reads
                // these columns, so the sums may overwrite the region.
#pragma unroll
                for (int u = 0; u < MAX_TILES_PER_WARP; ++u) {
                    const int tile = base + u * CTA_WARPS + warp;
                    if (tile < ntiles) {
                        const int zp = tile / mtiles, mt = tile - zp * mtiles;
                        store_acc(acc, u, region + zp * rplane + mt * MMA_TILE * ld + c0, ld, g,
                                  q4);
                    }
                }
            }
            __syncthreads();
        }
        pin = po;
        hin = ho;
        win = wo;
    }

    store_tile3d(y, Z, H, W, k0, i0, j0, TZ, TM, TN, region, rplane, ld);
}

template <typename TIn, typename TC>
static int launch(const void* x, void* y, const void* packed, const int* meta, int Z, int H,
                  int W, int TZ, int TM, int TN, int t, int R, int rows, int ld, int a_rows,
                  int a_cols, int n_rows, const int* modes, int B, long long grid_elems,
                  int smem_bytes, cudaStream_t stream) {
    const bool fill = modes[0] != MODE_PERIODIC || modes[1] != MODE_PERIODIC ||
                      modes[2] != MODE_PERIODIC;
    auto* kernel =
        fill ? stencil_sparse3d_kernel<TIn, TC, true> : stencil_sparse3d_kernel<TIn, TC, false>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    cudaError_t err = prepare_launch(kernel, attributes_set[fill]);
    if (err != cudaSuccess) return (int)err;
    const long long ctas = grid3_ctas(Z, H, W, TZ, TM, TN);
    if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
    const int gx = (W + TN - 1) / TN, gy = (H + TM - 1) / TM;
    return for_each_chunk(B, [&](int b0, int nb) {
        kernel<<<dim3((unsigned)ctas, 1, nb), CTA_THREADS, smem_bytes, stream>>>(
            grid_at(static_cast<const TIn*>(x), b0, grid_elems),
            grid_at(static_cast<TIn*>(y), b0, grid_elems), static_cast<const TC*>(packed), meta,
            Z, H, W, TZ, TM, TN, t, R, rows, ld, a_rows, a_cols, n_rows, gx, gy, modes[0],
            modes[1], modes[2], (size_t)grid_elems);
        return (int)cudaGetLastError();
    });
}

// dtype / compute: 0 = float32 (TF32 MMA operands), 1 = bfloat16; packed
// is (sum_p nk_p * K, 16) in the compute dtype, band by band; meta
// (n_rows, 4) int32 (dz, dy, lo, nk), each band's lo + nk * K <= a_cols
// (the wrapper's BandMeta); mode_z, mode_y, mode_x: each axis's boundary
// code (MODE_*); x and y hold B grids of grid_elems = Z * H * W cells
// each (the batch, K11).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int stencil_sparse3d_launch(const void* x, void* y, const void* packed,
                                       const void* meta, int Z, int H, int W, int TZ, int TM,
                                       int TN, int t, int R, int rows, int ld, int a_rows,
                                       int a_cols, int n_rows, int dtype, int compute,
                                       int mode_z, int mode_y, int mode_x, int B,
                                       long long grid_elems, int smem_bytes, void* stream) {
    if (n_rows < 1 || grid_elems != (long long)Z * H * W) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* m = static_cast<const int*>(meta);
    const int modes[3] = {mode_z, mode_y, mode_x};
#define ARGS x, y, packed, m, Z, H, W, TZ, TM, TN, t, R, rows, ld, a_rows, a_cols, n_rows, modes, \
             B, grid_elems, smem_bytes, s
    if (dtype == 0 && compute == 0) return launch<float, float>(ARGS);
    if (dtype == 0 && compute == 1) return launch<float, __nv_bfloat16>(ARGS);
    if (dtype == 1 && compute == 0) return launch<__nv_bfloat16, float>(ARGS);
    if (dtype == 1 && compute == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}
