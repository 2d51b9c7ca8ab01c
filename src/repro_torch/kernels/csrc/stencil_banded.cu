// Banded (Toeplitz) stencil contraction on the tensor cores for Hopper
// (sm_90a): t steps of a 2D stencil with per-axis boundaries (periodic,
// zero, reflect, replicate), one (TM x TN) output tile per CTA, every
// product a wmma MMA (TF32 m16n16k8 for f32 operands, bf16 m16n16k16 for
// bf16 operands) with f32 accumulators.
//
// Replaces repro/kernels/stencil_matmul.py::stencil_matmul / _banded_step /
// _banded_steps together with the halo staging that
// repro/kernels/common.py::_launch (kinds subblocked / flat) does for it on
// the TPU.  The host builds the operands with build_bands_nd, as the JAX
// package does: for every structurally nonzero kernel row dy a band
// B_dy of (BAND_N + 2R, BAND_N) with B_dy[j + dx, j] = w[dy, dx], here
// padded with zero rows to KPAD (the MMA K step) and stored in the compute
// dtype.  An output chunk of 16 columns is  sum_dy  A_dy @ B_dy,  A_dy the
// dy-shifted (16, KPAD) slab of the input region.
//
// What bounds it on an H100: for the stencils of this repository, bytes.
// The band form spends KPAD * 16 MACs per 16 outputs per kernel row,
// KPAD / (2R + 1) times the useful work, and still stays under the
// 495 TFLOP/s TF32 roof next to 3.35 TB/s of HBM for small t*R.  So, as in
// the tap-sum kernel, each tile's (TM+2h) x (TN+2h) region is read from
// global memory once (h = t*R, modulo indices on both axes), all
// t steps run in shared memory (intermediates stay f32 and round to the
// compute dtype only as MMA operands, as stencil_matmul.py:175 does), the
// x-halo is carried and both axes shrink by R per step, and the tile is
// written once, masked at the ragged edge.
//
// Each step first rebuilds the non-periodic axes' halo in the f32 region
// (fill_boundary, common.cuh; compiled only into the FILL instantiation,
// which launches with a non-periodic axis) and waits for it: the sums of the previous
// step sit in the same buffer, and a reflect on x must read its mirror
// column before any chunk of this step overwrites it.  Then it copies the
// f32 region into a chunked operand array
// A[c][row][k] = region[row][16c + k] in the compute dtype, with zeros
// for k >= BAND_N + 2R (the K padding) and past the region's valid extent,
// so NaN * 0 never reaches a valid output and every A_dy is a plain
// aligned fragment load.  Then each warp takes one kernel row's band at a
// time into registers (B fragments loaded from global memory, where it is
// L1/L2-resident; never the whole stack: a monolithically fused r=3, t=4
// stencil has 25 bands) and runs it against two 16x16 output tiles per
// pass, whose accumulators stay in registers across the rows; the sums land
// back in the (single) f32 region buffer.  Measured on the card, these
// copies and the global load, not the MMAs, took most of the time: both
// keep several loads in flight per thread, and the largest shared-memory
// carveout lets three CTAs share an SM.
//
// The same source built with -DREPRO_FOIL is the library of the traffic
// foils (K8 whole-strip, replacing repro/kernels/common.py::_launch kind
// wholestrip via _assemble_foil; K10 the seed 9-tile kernel,
// repro/kernels/legacy.py::stencil_matmul_9pt, one contraction of the
// composed kernel): this kernel with the STAGE_STRIP or STAGE_NINE staging
// of common.cuh, which reads 3 (TN+2h)/TN or 9 times the grid for the same
// compute.  A foil's sink slots lie in the operand array, which nothing
// reads before the first copy.
//
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// replacing repro/kernels/common.py::fold_batch mode vmap; common.cuh,
// grid_at / for_each_chunk); B = 1 is the unbatched call.
#include "banded_mma.cuh"

#define MAX_ROWS 64

struct BandRows {
    int n;
    int dy[MAX_ROWS];
};

// Shared memory: the f32 region (rows x ld), then the chunked operand array
// (chunks x a_rows x kpad, compute dtype), 128-byte aligned.  The host sizes
// all of these (repro_torch/kernels/common.py::banded_layout) and passes
// the byte count at launch.
template <typename TIn, typename TC, bool FILL, int STAGE>
__global__ void __launch_bounds__(CTA_THREADS)
stencil_banded_kernel(const TIn* __restrict__ x, TIn* __restrict__ y,
                      const TC* __restrict__ bands, int H, int W, int TM, int TN, int t,
                      int R, int rows, int ld, int a_rows, int kpad, int my, int mx,
                      BandRows br, size_t grid_elems) {
    using M = Mma<TC>;
    extern __shared__ __align__(128) unsigned char smem[];
    float* const region = reinterpret_cast<float*>(smem);
    TC* const achunks = reinterpret_cast<TC*>(smem + align128((size_t)rows * ld * sizeof(float)));

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int halo = t * R;
    const int h0 = TM + 2 * halo, w0 = TN + 2 * halo;
    const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
    const int band_k = BAND_N + 2 * R;  // valid rows of one band
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }
    const int nks = kpad / M::K;

    load_region<STAGE>(region, ld,
                       sink_slot<STAGE>(reinterpret_cast<float*>(achunks),
                                        a_rows * kpad * (int)sizeof(TC) / 4),
                       x, H, W, i0 - halo, j0 - halo, h0, w0, TM, TN);
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

        // Chunked, rounded, zero-padded copy of the step's input.
        // Four rows per warp at a time, so four loads are in flight.
        for (int c = 0; c < nch; ++c) {
            const int c0 = c * BAND_N;
            const int kv = min(band_k, win - c0);
            TC* dst = achunks + (size_t)c * a_rows * kpad;
            for (int rb = warp * 4; rb < a_rows; rb += CTA_WARPS * 4)
                for (int k = lane; k < kpad; k += 32) {
                    float v[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        v[u] = (rb + u < hin && k < kv) ? region[(rb + u) * ld + c0 + k] : 0.f;
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (rb + u < a_rows) dst[(rb + u) * kpad + k] = M::cvt(v[u]);
                }
        }
        __syncthreads();

        for (int base = 0; base < ntiles; base += CTA_WARPS * MAX_TILES_PER_WARP) {
            typename M::C acc[MAX_TILES_PER_WARP];
#pragma unroll
            for (int q = 0; q < MAX_TILES_PER_WARP; ++q) wmma::fill_fragment(acc[q], 0.f);

            // Tiles past the last are clamped onto it (computed, not
            // stored), so the loops carry no branches and the warp's
            // MAX_TILES_PER_WARP products of one k-step issue back to back.
            int a_off[MAX_TILES_PER_WARP];
#pragma unroll
            for (int q = 0; q < MAX_TILES_PER_WARP; ++q) {
                const int tile = min(base + q * CTA_WARPS + warp, ntiles - 1);
                const int mt = tile / nch, nt = tile - mt * nch;
                a_off[q] = (nt * a_rows + mt * MMA_TILE) * kpad;
            }
            for (int p = 0; p < br.n; ++p) {
                const TC* bp = bands + (size_t)p * kpad * BAND_N;
                const int dy_off = br.dy[p] * kpad;
#pragma unroll
                for (int ks = 0; ks < M::MAX_KS; ++ks)
                    if (ks < nks) {
                        typename M::B b;
                        wmma::load_matrix_sync(b, bp + ks * M::K * BAND_N, BAND_N);
                        M::round_b(b);
                        typename M::A a[MAX_TILES_PER_WARP];
#pragma unroll
                        for (int q = 0; q < MAX_TILES_PER_WARP; ++q)
                            wmma::load_matrix_sync(a[q], achunks + a_off[q] + dy_off + ks * M::K, kpad);
#pragma unroll
                        for (int q = 0; q < MAX_TILES_PER_WARP; ++q)
                            wmma::mma_sync(acc[q], a[q], b, acc[q]);
                    }
            }
            // The operands live in achunks, so the sums may overwrite the region.
#pragma unroll
            for (int q = 0; q < MAX_TILES_PER_WARP; ++q) {
                const int tile = base + q * CTA_WARPS + warp;
                if (tile < ntiles) {
                    const int mt = tile / nch, nt = tile - mt * nch;
                    wmma::store_matrix_sync(region + (size_t)mt * MMA_TILE * ld + nt * BAND_N, acc[q],
                                            ld, wmma::mem_row_major);
                }
            }
        }
        __syncthreads();
        hin = ho;
        win = wo;
    }

    store_tile(y, H, W, i0, j0, TM, TN, region, ld);
}

template <typename TIn, typename TC, int STAGE>
static int launch(const void* x, void* y, const void* bands, int H, int W, int TM, int TN,
                  int t, int R, int rows, int ld, int a_rows, int kpad, int my, int mx,
                  const BandRows* br, int B, long long grid_elems, int smem_bytes,
                  cudaStream_t stream) {
    const bool fill = my != MODE_PERIODIC || mx != MODE_PERIODIC;
    if (STAGE == STAGE_NINE && fill) return (int)cudaErrorInvalidValue;  // periodic only
    constexpr bool kFill = STAGE != STAGE_NINE;
    auto* kernel = fill ? stencil_banded_kernel<TIn, TC, kFill, STAGE>
                        : stencil_banded_kernel<TIn, TC, false, STAGE>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    cudaError_t err = prepare_launch(kernel, attributes_set[fill]);
    if (err != cudaSuccess) return (int)err;
    return for_each_chunk(B, [&](int b0, int nb) {
        dim3 grid((W + TN - 1) / TN, (H + TM - 1) / TM, nb);
        kernel<<<grid, CTA_THREADS, smem_bytes, stream>>>(
            grid_at(static_cast<const TIn*>(x), b0, grid_elems),
            grid_at(static_cast<TIn*>(y), b0, grid_elems), static_cast<const TC*>(bands), H, W,
            TM, TN, t, R, rows, ld, a_rows, kpad, my, mx, *br, (size_t)grid_elems);
        return (int)cudaGetLastError();
    });
}

template <int STAGE>
static int launch_types(const void* x, void* y, const void* bands, int H, int W, int TM, int TN,
                        int t, int R, int rows, int ld, int a_rows, int kpad, int dtype,
                        int compute, int mode_y, int mode_x, const BandRows* br, int B,
                        long long grid_elems, int smem_bytes, cudaStream_t s) {
#define ARGS x, y, bands, H, W, TM, TN, t, R, rows, ld, a_rows, kpad, mode_y, mode_x, br, B, \
             grid_elems, smem_bytes, s
    if (dtype == 0 && compute == 0) return launch<float, float, STAGE>(ARGS);
    if (dtype == 0 && compute == 1) return launch<float, __nv_bfloat16, STAGE>(ARGS);
    if (dtype == 1 && compute == 0) return launch<__nv_bfloat16, float, STAGE>(ARGS);
    if (dtype == 1 && compute == 1) return launch<__nv_bfloat16, __nv_bfloat16, STAGE>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}

#define ARGS x, y, bands, H, W, TM, TN, t, R, rows, ld, a_rows, kpad, dtype, compute, mode_y, \
             mode_x, br, B, grid_elems, smem_bytes, static_cast<cudaStream_t>(stream)
#ifndef REPRO_FOIL
// dtype / compute: 0 = float32 (TF32 MMA operands), 1 = bfloat16; bands are
// (n, kpad, 16) in the compute dtype; mode_y, mode_x: the rows' and the
// columns' boundary codes (MODE_*); x and y hold B grids of grid_elems =
// H * W cells each (the batch, K11).  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int stencil_banded_launch(const void* x, void* y, const void* bands, int H, int W,
                                     int TM, int TN, int t, int R, int rows, int ld, int a_rows,
                                     int kpad, int dtype, int compute, int mode_y, int mode_x,
                                     const BandRows* br, int B, long long grid_elems,
                                     int smem_bytes, void* stream) {
    if (br->n < 1 || br->n > MAX_ROWS || kpad > MAX_KPAD || grid_elems != (long long)H * W)
        return (int)cudaErrorInvalidValue;
    return launch_types<STAGE_REGION>(ARGS);
}
#else
// The foils: stencil_banded_launch's arguments and the staging, stage =
// STAGE_STRIP (any boundary) or STAGE_NINE (periodic only).
extern "C" int stencil_banded_foil_launch(const void* x, void* y, const void* bands, int H,
                                          int W, int TM, int TN, int t, int R, int rows, int ld,
                                          int a_rows, int kpad, int dtype, int compute, int stage,
                                          int mode_y, int mode_x, const BandRows* br, int B,
                                          long long grid_elems, int smem_bytes, void* stream) {
    if (br->n < 1 || br->n > MAX_ROWS || kpad > MAX_KPAD || grid_elems != (long long)H * W)
        return (int)cudaErrorInvalidValue;
    if (stage == STAGE_STRIP) return launch_types<STAGE_STRIP>(ARGS);
    if (stage == STAGE_NINE) return launch_types<STAGE_NINE>(ARGS);
    return (int)cudaErrorInvalidValue;
}
#endif
#undef ARGS
