// Banded (Toeplitz) stencil contraction on the tensor cores for Hopper
// (sm_90a): t steps of a 3D stencil with per-axis boundaries (periodic,
// zero, reflect, replicate), one (TZ x TM x TN) output tile per CTA, every
// product a wmma MMA (TF32 m16n16k8 for f32 operands,
// bf16 m16n16k16 for bf16 operands) with f32 accumulators.
//
// Replaces repro/kernels/stencil_matmul.py::stencil_matmul / _banded_step /
// _banded_steps on 3D grids, together with the slab substrate that
// repro/kernels/common.py::slab_substrate_call (kinds slab_subblocked /
// slab_coltiled, geometry slab_launch_geometry) builds for it on the TPU.
// The host builds the operands with build_bands_nd, as the JAX package
// does: for every structurally nonzero x-row (dz, dy) of the kernel a band
// B of (BAND_N + 2R, BAND_N) with B[j + dx, j] = w[dz, dy, dx], padded
// with zero rows to KPAD (the MMA K step) and stored in the compute dtype,
// and beside the bands the (dz, dy) pair of each row, both in device
// memory: a composed Box-3D1R kernel at t = 4 has 9 x 9 = 81 rows,
// Box-3D2R's 17 x 17 = 289, past what a by-value argument holds.  A 16 x
// 16 output tile of plane z, rows m.., columns c.. is  sum over rows of
// A_(dz,dy) @ B_(dz,dy),  A_(dz,dy) the (16, KPAD) slab of input plane
// z + dz, rows m + dy.., columns c...
//
// What bounds it on an H100: for the stencils of this repository, bytes
// (the band form's KPAD * 16 MACs per 16 outputs per row stay under the
// 495 TFLOP/s TF32 roof next to 3.35 TB/s of HBM for small t*R).  So, as
// in the 2D kernel, each tile's (TZ+2h)(TM+2h)(TN+2h) region is read from
// global memory once (h = t*R, modulo indices on all three axes,
// 64-bit offsets), all t steps run in shared memory (intermediates stay
// f32 and round to the compute dtype only as MMA operands, as
// stencil_matmul.py:175 does), the halo is carried and every axis shrinks
// by R per step, and the tile is written once, masked at every ragged
// edge.  Its cost is the region's read amplification, 2.81x the grid for
// a 16x16x32 tile at h = 4, which the plan prices.
//
// Each step first rebuilds the non-periodic axes' halo in the f32 region
// (fill_boundary, common.cuh; compiled only into the FILL instantiation,
// which launches with a non-periodic axis) and waits for it, before chunk
// 0 copies its operands: the chunks store their sums back into the region
// in place, so a fill after any chunk had run would mirror a column
// already overwritten.  Then the step walks the 16-column chunks of its
// output in order.  For chunk c it copies the region's columns
// [16c, 16c + KPAD) of every plane into the operand array
// A[plane][row][k] in the compute dtype, with zeros for
// k >= BAND_N + 2R (the K padding) and past the region's valid extent, so
// NaN * 0 never reaches a valid output; then each warp takes two output
// tiles, runs every band row against them with one row's band fragments
// at a time from global memory (L1/L2-resident), and stores the sums back
// into the region at columns [16c, 16c + 16), which no later chunk reads:
// so A holds one chunk, not all of them, and a 16x16x32 tile at h = 4
// fits the 227 KB of one SM.
//
// The same source built with -DREPRO_FOIL is the library of the
// whole-slab traffic foil (K8, replacing repro/kernels/common.py::_launch
// kind wholeslab via _assemble_foil): this kernel with the STAGE_STRIP
// staging of common.cuh, the 3 x 3 whole (z, y) neighbour tiles, which
// reads 9 (TN+2h)/TN times the grid for the same compute; its sink slots
// lie in the operand array, which nothing reads before the first copy.
//
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// replacing repro/kernels/common.py::fold_batch mode vmap; common.cuh,
// grid_at / for_each_chunk); B = 1 is the unbatched call.
#include "banded_mma.cuh"

// Shared memory: the f32 region (planes x rows x ld), then one chunk's
// operand array (planes x a_rows x kpad, compute dtype), 128-byte aligned.
// The host sizes all of these (repro_torch/kernels/common.py::
// banded3d_layout) and passes the byte count at launch.  offs holds the
// (dz, dy) pair of each of the n_rows bands.
template <typename TIn, typename TC, bool FILL, int STAGE>
__global__ void __launch_bounds__(CTA_THREADS)
stencil_banded3d_kernel(const TIn* __restrict__ x, TIn* __restrict__ y,
                        const TC* __restrict__ bands, const int* __restrict__ offs, int Z,
                        int H, int W, int TZ, int TM, int TN, int t, int R, int rows, int ld,
                        int a_rows, int kpad, int n_rows, int gx, int gy, int mz, int my,
                        int mx, size_t grid_elems) {
    using M = Mma<TC>;
    extern __shared__ __align__(128) unsigned char smem[];
    const int halo = t * R;
    const int p0 = TZ + 2 * halo, h0 = TM + 2 * halo, w0 = TN + 2 * halo;
    const int rplane = rows * ld;     // region plane stride (f32)
    const int aplane = a_rows * kpad;  // operand plane stride (compute dtype)
    float* const region = reinterpret_cast<float*>(smem);
    TC* const achunk = reinterpret_cast<TC*>(smem + align128((size_t)p0 * rplane * sizeof(float)));

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const Tile3 tl = tile3(blockIdx.x, gx, gy);
    const int k0 = tl.bz * TZ, i0 = tl.by * TM, j0 = tl.bx * TN;
    const int band_k = BAND_N + 2 * R;  // valid rows of one band
    const int nks = kpad / M::K;
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }

    load_region3d<STAGE>(region, ld, rplane,
                         sink_slot<STAGE>(reinterpret_cast<float*>(achunk),
                                          a_rows * kpad * (int)sizeof(TC) / 4),
                         x, Z, H, W, k0 - halo, i0 - halo, j0 - halo, p0, h0, w0, TZ, TM);
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
            // Chunk c's rounded, zero-padded operands; four (plane, row)
            // pairs per warp at a time, so four loads are in flight.
            for (int rb = warp * 4; rb < arows; rb += CTA_WARPS * 4)
                for (int k = lane; k < kpad; k += 32) {
                    float v[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const int fr = rb + u;
                        const int q = fr / a_rows, rr = fr - q * a_rows;
                        v[u] = (fr < arows && rr < hin && k < kv)
                                   ? region[q * rplane + rr * ld + c0 + k]
                                   : 0.f;
                    }
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (rb + u < arows) achunk[(rb + u) * kpad + k] = M::cvt(v[u]);
                }
            __syncthreads();

            for (int base = 0; base < ntiles; base += CTA_WARPS * MAX_TILES_PER_WARP) {
                typename M::C acc[MAX_TILES_PER_WARP];
#pragma unroll
                for (int q = 0; q < MAX_TILES_PER_WARP; ++q) wmma::fill_fragment(acc[q], 0.f);

                // Tiles past the last are clamped onto it (computed, not
                // stored), so the loops carry no branches.
                int a_off[MAX_TILES_PER_WARP];
#pragma unroll
                for (int q = 0; q < MAX_TILES_PER_WARP; ++q) {
                    const int tile = min(base + q * CTA_WARPS + warp, ntiles - 1);
                    const int zp = tile / mtiles, mt = tile - zp * mtiles;
                    a_off[q] = zp * aplane + mt * MMA_TILE * kpad;
                }
                for (int p = 0; p < n_rows; ++p) {
                    const TC* bp = bands + (size_t)p * kpad * BAND_N;
                    const int row_off = __ldg(offs + 2 * p) * aplane + __ldg(offs + 2 * p + 1) * kpad;
#pragma unroll
                    for (int ks = 0; ks < M::MAX_KS; ++ks)
                        if (ks < nks) {
                            typename M::B b;
                            wmma::load_matrix_sync(b, bp + ks * M::K * BAND_N, BAND_N);
                            M::round_b(b);
                            typename M::A a[MAX_TILES_PER_WARP];
#pragma unroll
                            for (int q = 0; q < MAX_TILES_PER_WARP; ++q)
                                wmma::load_matrix_sync(a[q], achunk + a_off[q] + row_off + ks * M::K,
                                                       kpad);
#pragma unroll
                            for (int q = 0; q < MAX_TILES_PER_WARP; ++q)
                                wmma::mma_sync(acc[q], a[q], b, acc[q]);
                        }
                }
                // The operands live in achunk, and no later chunk reads
                // these columns, so the sums may overwrite the region.
#pragma unroll
                for (int q = 0; q < MAX_TILES_PER_WARP; ++q) {
                    const int tile = base + q * CTA_WARPS + warp;
                    if (tile < ntiles) {
                        const int zp = tile / mtiles, mt = tile - zp * mtiles;
                        wmma::store_matrix_sync(region + zp * rplane + mt * MMA_TILE * ld + c0,
                                                acc[q], ld, wmma::mem_row_major);
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

template <typename TIn, typename TC, int STAGE>
static int launch(const void* x, void* y, const void* bands, const int* offs, int Z, int H, int W,
                  int TZ, int TM, int TN, int t, int R, int rows, int ld, int a_rows, int kpad,
                  int n_rows, const int* modes, int B, long long grid_elems, int smem_bytes,
                  cudaStream_t stream) {
    const bool fill = modes[0] != MODE_PERIODIC || modes[1] != MODE_PERIODIC ||
                      modes[2] != MODE_PERIODIC;
    auto* kernel = fill ? stencil_banded3d_kernel<TIn, TC, true, STAGE>
                        : stencil_banded3d_kernel<TIn, TC, false, STAGE>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    cudaError_t err = prepare_launch(kernel, attributes_set[fill]);
    if (err != cudaSuccess) return (int)err;
    const long long ctas = grid3_ctas(Z, H, W, TZ, TM, TN);
    if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
    const int gx = (W + TN - 1) / TN, gy = (H + TM - 1) / TM;
    return for_each_chunk(B, [&](int b0, int nb) {
        kernel<<<dim3((unsigned)ctas, 1, nb), CTA_THREADS, smem_bytes, stream>>>(
            grid_at(static_cast<const TIn*>(x), b0, grid_elems),
            grid_at(static_cast<TIn*>(y), b0, grid_elems), static_cast<const TC*>(bands), offs,
            Z, H, W, TZ, TM, TN, t, R, rows, ld, a_rows, kpad, n_rows, gx, gy, modes[0],
            modes[1], modes[2], (size_t)grid_elems);
        return (int)cudaGetLastError();
    });
}

template <int STAGE>
static int launch_types(const void* x, void* y, const void* bands, const int* o, int Z, int H,
                        int W, int TZ, int TM, int TN, int t, int R, int rows, int ld,
                        int a_rows, int kpad, int n_rows, int dtype, int compute,
                        const int* modes, int B, long long grid_elems, int smem_bytes,
                        cudaStream_t s) {
#define ARGS x, y, bands, o, Z, H, W, TZ, TM, TN, t, R, rows, ld, a_rows, kpad, n_rows, modes, \
             B, grid_elems, smem_bytes, s
    if (dtype == 0 && compute == 0) return launch<float, float, STAGE>(ARGS);
    if (dtype == 0 && compute == 1) return launch<float, __nv_bfloat16, STAGE>(ARGS);
    if (dtype == 1 && compute == 0) return launch<__nv_bfloat16, float, STAGE>(ARGS);
    if (dtype == 1 && compute == 1) return launch<__nv_bfloat16, __nv_bfloat16, STAGE>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}

#define ARGS x, y, bands, static_cast<const int*>(offs), Z, H, W, TZ, TM, TN, t, R, rows, ld, \
             a_rows, kpad, n_rows, dtype, compute, modes, B, grid_elems, smem_bytes, \
             static_cast<cudaStream_t>(stream)
#ifndef REPRO_FOIL
// dtype / compute: 0 = float32 (TF32 MMA operands), 1 = bfloat16; bands
// are (n_rows, kpad, 16) in the compute dtype, offs (n_rows, 2) int32
// (dz, dy); mode_z, mode_y, mode_x: each axis's boundary code (MODE_*);
// x and y hold B grids of grid_elems = Z * H * W cells each (the batch,
// K11).  Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_banded3d_launch(const void* x, void* y, const void* bands, const void* offs,
                                       int Z, int H, int W, int TZ, int TM, int TN, int t, int R,
                                       int rows, int ld, int a_rows, int kpad, int n_rows,
                                       int dtype, int compute, int mode_z, int mode_y, int mode_x,
                                       int B, long long grid_elems, int smem_bytes, void* stream) {
    if (n_rows < 1 || kpad > MAX_KPAD || grid_elems != (long long)Z * H * W)
        return (int)cudaErrorInvalidValue;
    const int modes[3] = {mode_z, mode_y, mode_x};
    return launch_types<STAGE_REGION>(ARGS);
}
#else
// The whole-slab foil: stencil_banded3d_launch's arguments and the
// staging, stage = STAGE_STRIP (any boundary).
extern "C" int stencil_banded3d_foil_launch(const void* x, void* y, const void* bands,
                                            const void* offs, int Z, int H, int W, int TZ, int TM,
                                            int TN, int t, int R, int rows, int ld, int a_rows,
                                            int kpad, int n_rows, int dtype, int compute,
                                            int stage, int mode_z, int mode_y, int mode_x,
                                            int B, long long grid_elems, int smem_bytes,
                                            void* stream) {
    if (n_rows < 1 || kpad > MAX_KPAD || grid_elems != (long long)Z * H * W)
        return (int)cudaErrorInvalidValue;
    const int modes[3] = {mode_z, mode_y, mode_x};
    if (stage == STAGE_STRIP) return launch_types<STAGE_STRIP>(ARGS);
    return (int)cudaErrorInvalidValue;
}
#endif
#undef ARGS
