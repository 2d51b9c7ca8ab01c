// Tap-sum stencil kernel for Hopper (sm_90a): t fused steps of a 2D
// stencil with per-axis boundaries (periodic, zero, reflect, replicate),
// one (TM x TN) output tile per CTA.
//
// Replaces repro/kernels/stencil_direct.py::stencil_direct / _stencil_steps
// together with the halo staging that repro/kernels/common.py::_launch
// (kinds subblocked / flat) does for it on the TPU.
//
// What bounds it on an H100: bytes.  A step costs 2K flops per point
// (K <= 49 taps) against 8 bytes moved for an f32 grid, far below the
// 67 TFLOP/s / 3.35 TB/s = 20 flop/byte ridge of the CUDA cores until
// t*K is large.  The design therefore reads each tile's
// (TM+2h) x (TN+2h) region from global memory once (h = t*r,
// modulo indices on both axes; Hopper blocks may read overlapping
// regions, so there is no halo ring), runs all t steps out of two
// ping-pong f32 buffers in shared memory, carrying the x-halo and
// shrinking both axes by r per step, and writes the tile once, masked at
// the ragged grid edge.  Between those, what costs is latency and
// instruction issue: the region load keeps 32 loads in flight per thread,
// and each thread computes V rows of one column from a (V+2r) x (2r+1)
// register window, so an output costs (2r+1)(V+2r)/V shared-memory loads
// instead of K.  The taps come in as a by-value argument in row-major
// order with the zero taps left out, as the JAX kernel skips them at
// trace time; the kernel is specialised on r <= 3.  Non-periodic axes
// are rebuilt in the input buffer before every step by fill_boundary
// (common.cuh), as the JAX kernel's apply_boundary_fills does per step;
// the fill is compiled only into the FILL instantiation, which launches
// with a non-periodic axis, so a periodic launch runs the periodic code.
//
// The same source built with -DREPRO_FOIL is the library of the traffic
// foils (K8 whole-strip, replacing repro/kernels/common.py::_launch kind
// wholestrip via _assemble_foil; K9 the seed 9-tile kernel,
// repro/kernels/legacy.py::stencil_direct_9pt): this kernel with the
// STAGE_STRIP or STAGE_NINE staging of common.cuh, which reads 3 (TN+2h)/TN
// or 9 times the grid where the region reads (1+2h/TM)(1+2h/TN), for the
// same compute.  What bounds a foil is the bytes it requests; its point
// is to measure what they cost.  The foils build into a library of their
// own, so the main path's build does not grow.
//
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// replacing repro/kernels/common.py::fold_batch mode vmap; common.cuh,
// grid_at / for_each_chunk); B = 1 is the unbatched call.
#include "common.cuh"

#define MAX_TAPS 49
#define ROWS_PER_THREAD 8

struct Taps {
    int n;
    int dy[MAX_TAPS];
    int dx[MAX_TAPS];
    float w[MAX_TAPS];
};

template <typename T, int R, bool FILL, int STAGE>
__global__ void __launch_bounds__(CTA_THREADS)
stencil_direct_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W,
                      int TM, int TN, int t, int my, int mx, Taps taps, size_t grid_elems) {
    constexpr int KW = 2 * R + 1;
    constexpr int V = ROWS_PER_THREAD;
    extern __shared__ float smem[];
    __shared__ float wsh[KW * KW];  // dense taps; zero where skipped

    const int halo = t * R;
    const int rows0 = TM + 2 * halo;
    const int ld = TN + 2 * halo;
    float* const b0 = smem;
    float* const b1 = smem + rows0 * ld;
    const int i0 = blockIdx.y * TM;
    const int j0 = blockIdx.x * TN;
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }

    if (threadIdx.x < KW * KW) wsh[threadIdx.x] = 0.f;
    __syncthreads();
    if (threadIdx.x < taps.n) wsh[taps.dy[threadIdx.x] * KW + taps.dx[threadIdx.x]] = taps.w[threadIdx.x];
    load_region<STAGE>(b0, ld, sink_slot<STAGE>(b1, rows0 * ld), x, H, W, i0 - halo, j0 - halo,
                       rows0, ld, TM, TN);
    __syncthreads();
    const bool fill = FILL && (leaves_domain(my, i0 - halo, rows0, H) ||
                               leaves_domain(mx, j0 - halo, ld, W));

    int hin = rows0, win = ld;
    for (int s = 0; s < t; ++s) {
        float* in = (s & 1) ? b1 : b0;
        float* out = (s & 1) ? b0 : b1;
        if (fill) {
            const int depth = (t - s) * R;
            fill_boundary(in, 0, ld, 1, hin, win, 0, i0 - depth, j0 - depth, 1, H, W, depth,
                          MODE_PERIODIC, my, mx);
        }
        const int ho = hin - 2 * R, wo = win - 2 * R;
        const int strips = ((ho + V - 1) / V) * wo;
        for (int sid = threadIdx.x; sid < strips; sid += blockDim.x) {
            const int rb = sid / wo;
            const int j = sid - rb * wo;
            const int r0 = rb * V;
            float win_[V + 2 * R][KW];
#pragma unroll
            for (int q = 0; q < V + 2 * R; ++q)
#pragma unroll
                for (int dx = 0; dx < KW; ++dx)
                    win_[q][dx] = (r0 + q < hin) ? in[(r0 + q) * ld + j + dx] : 0.f;
            float acc[V];
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = 0.f;
            // Row-major tap order per output; zero taps are skipped.
#pragma unroll
            for (int dy = 0; dy < KW; ++dy)
#pragma unroll
                for (int dx = 0; dx < KW; ++dx) {
                    const float wv = wsh[dy * KW + dx];
                    if (wv != 0.f) {
#pragma unroll
                        for (int v = 0; v < V; ++v) acc[v] = fmaf(wv, win_[v + dy][dx], acc[v]);
                    }
                }
#pragma unroll
            for (int v = 0; v < V; ++v)
                if (r0 + v < ho) out[(r0 + v) * ld + j] = acc[v];
        }
        __syncthreads();
        hin = ho;
        win = wo;
    }
    store_tile(y, H, W, i0, j0, TM, TN, (t & 1) ? b1 : b0, ld);
}

template <typename T, int R, int STAGE>
static int launch(const void* x, void* y, int H, int W, int TM, int TN, int t, int my,
                  int mx, const Taps* taps, int B, long long grid_elems, int smem_bytes,
                  cudaStream_t stream) {
    const bool fill = my != MODE_PERIODIC || mx != MODE_PERIODIC;
    if (STAGE == STAGE_NINE && fill) return (int)cudaErrorInvalidValue;  // periodic only
    constexpr bool kFill = STAGE != STAGE_NINE;
    auto* kernel = fill ? stencil_direct_kernel<T, R, kFill, STAGE>
                        : stencil_direct_kernel<T, R, false, STAGE>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    cudaError_t err = prepare_launch(kernel, attributes_set[fill]);
    if (err != cudaSuccess) return (int)err;
    return for_each_chunk(B, [&](int b0, int nb) {
        dim3 grid((W + TN - 1) / TN, (H + TM - 1) / TM, nb);
        kernel<<<grid, CTA_THREADS, smem_bytes, stream>>>(
            grid_at(static_cast<const T*>(x), b0, grid_elems),
            grid_at(static_cast<T*>(y), b0, grid_elems), H, W, TM, TN, t, my, mx, *taps,
            (size_t)grid_elems);
        return (int)cudaGetLastError();
    });
}

template <typename T, int STAGE>
static int launch_r(const void* x, void* y, int H, int W, int TM, int TN, int t, int r,
                    int my, int mx, const Taps* taps, int B, long long grid_elems,
                    int smem_bytes, cudaStream_t s) {
#define ARGS x, y, H, W, TM, TN, t, my, mx, taps, B, grid_elems, smem_bytes, s
    if (r == 1) return launch<T, 1, STAGE>(ARGS);
    if (r == 2) return launch<T, 2, STAGE>(ARGS);
    if (r == 3) return launch<T, 3, STAGE>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}

#define ARGS x, y, H, W, TM, TN, t, r, mode_y, mode_x, taps, B, grid_elems, smem_bytes, s
#ifndef REPRO_FOIL
// dtype: 0 = float32, 1 = bfloat16 (input and output); r in 1..3; mode_y,
// mode_x: the rows' and the columns' boundary codes (MODE_*); x and y
// hold B grids of grid_elems = H * W cells each (the batch, K11).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_direct_launch(const void* x, void* y, int H, int W, int TM, int TN,
                                     int t, int r, int dtype, int mode_y, int mode_x,
                                     const Taps* taps, int B, long long grid_elems,
                                     int smem_bytes, void* stream) {
    if (taps->n < 1 || taps->n > MAX_TAPS || grid_elems != (long long)H * W)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_r<float, STAGE_REGION>(ARGS);
    if (dtype == 1) return launch_r<__nv_bfloat16, STAGE_REGION>(ARGS);
    return (int)cudaErrorInvalidValue;
}
#else
// The foils: stencil_direct_launch's arguments and the staging, stage =
// STAGE_STRIP (any boundary) or STAGE_NINE (periodic only).
extern "C" int stencil_direct_foil_launch(const void* x, void* y, int H, int W, int TM, int TN,
                                          int t, int r, int dtype, int stage, int mode_y,
                                          int mode_x, const Taps* taps, int B,
                                          long long grid_elems, int smem_bytes, void* stream) {
    if (taps->n < 1 || taps->n > MAX_TAPS || grid_elems != (long long)H * W)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (stage == STAGE_STRIP && dtype == 0) return launch_r<float, STAGE_STRIP>(ARGS);
    if (stage == STAGE_STRIP && dtype == 1) return launch_r<__nv_bfloat16, STAGE_STRIP>(ARGS);
    if (stage == STAGE_NINE && dtype == 0) return launch_r<float, STAGE_NINE>(ARGS);
    if (stage == STAGE_NINE && dtype == 1) return launch_r<__nv_bfloat16, STAGE_NINE>(ARGS);
    return (int)cudaErrorInvalidValue;
}
#endif
#undef ARGS
