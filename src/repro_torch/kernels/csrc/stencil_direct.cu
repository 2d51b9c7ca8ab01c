// Tap-sum stencil kernel for Hopper (sm_90a): t fused steps of a 2D
// stencil with per-axis boundaries (periodic, zero, reflect, replicate),
// one (TM x TN) output tile per CTA.
//
// Replaces repro/kernels/stencil_direct.py::stencil_direct / _stencil_steps
// together with the halo staging that repro/kernels/common.py::_launch
// (kinds subblocked / flat) does for it on the TPU.
//
// What bounds it on an H100: bytes, then shared-memory bandwidth and issue,
// for radii up to 3.  A step costs 2K flops per point (K <= 49 taps) against
// 8 bytes moved for an f32 grid, far below the 67 TFLOP/s / 3.35 TB/s = 20
// flop/byte ridge of the CUDA cores until t*K is large; a dense radius-7
// box (K = 225) at t = 4 is past it, bound by its FMAs.  So each CTA reads its tile's
// (TM+2h) x (TN+2h) region (h = t*r) from global memory once, runs all t
// steps out of two f32 buffers in shared memory and writes the tile once,
// masked at the ragged grid edge.  What the design does about the rest:
//   * the staging (stage_region) copies the region in 16-byte granules
//     with cp.async, 4 cells each, spread evenly over the CTA's threads.
//     A buffer row starts at the granule that holds the region's first
//     cell: `lead` = (-h) mod 4 cells come before it (the tile's columns
//     are multiples of 16, so the lead is the same in every CTA), and the
//     tile's first column sits on a granule.  A granule whose source is
//     not on 16 bytes (rows of a grid whose width is not a multiple of 4,
//     a misaligned base) or that wraps the grid's edge mid-granule is
//     copied cell by cell, modulo (H, W).  bfloat16 grids load 8 bytes (4
//     cells) a granule and widen to f32 at staging: the steps and the fill
//     then read one layout whatever the grid's type.
//   * the steps keep every cell in place: region cell (i, j) is buffer
//     cell (i, lead + j) of both buffers, and a step's output at (i, j)
//     goes to (i, j) of the other buffer, so every step's reads and
//     stores stay on 16 bytes.  A thread computes a patch of V rows x 4
//     columns, streaming the V + 2r input rows it needs one at a time
//     (a 16-byte word and the r cells each side, direct_row) into V x 4
//     f32 sums; a patch reads (V+2r)(4+2r) cells for 4V outputs.  The
//     work map (g, b) of the patches is fixed per thread from the thread
//     index once per CTA, the patches of every step on the first step's
//     column groups; a group that holds no output of a later step is
//     skipped.  Cells a patch computes outside the step's output window
//     feed no output: rows past it are not stored, and columns past it
//     are only ever read by cells outside the next window.
//   * __launch_bounds__(CTA_THREADS, DIRECT_MIN_BLOCKS) bounds the
//     registers so that that many CTAs share an SM (the main tile's two
//     buffers take 41,520 bytes, so shared memory allows 5, and 5 run).
// Every output starts at 0.f and takes fmaf in ascending (dy, dx) order
// (dy rises with the streamed row), zero taps skipped, in f32, and rounds
// to the grid's type once, on store: the JAX kernel's order
// (stencil_direct.py:88-98), so the 2D kernel on the lifted (1, N) view
// equals the folded 1D tap-sum bit for bit.  The taps come in as a
// by-value argument, read by the FMAs from the parameter bank; the kernel
// is specialised on r <= 7.  Radii 4..7 (the wide patch, direct_patch_wide)
// stream each output row's 2r+1 input rows in a loop over dy, dx unrolled,
// so a patch reads V (2r+1) rows where the narrow patch reads V + 2r, and
// its code stays small; their taps, (2r+1)^2 floats (900 bytes at r = 7),
// are an argument of their own size.  Non-periodic
// axes are rebuilt in the input buffer before every step by
// fill_boundary (common.cuh), on the step's input window, as the JAX
// kernel's apply_boundary_fills does per step; the fill is compiled only
// into the FILL instantiation, which launches with a non-periodic axis, so
// a periodic launch runs the periodic code.
//
// The same source built with -DREPRO_FOIL is the library of the traffic
// foils (K8 whole-strip, replacing repro/kernels/common.py::_launch kind
// wholestrip via _assemble_foil; K9 the seed 9-tile kernel,
// repro/kernels/legacy.py::stencil_direct_9pt): this kernel with the
// STAGE_STRIP or STAGE_NINE staging of common.cuh (load_region, into the
// same layout at the buffer's column `lead`), which reads 3 (TN+2h)/TN
// or 9 times the grid where the region reads (1+2h/TM)(1+2h/TN), for the
// same compute.  What bounds a foil is the bytes it requests; its point
// is to measure what they cost.  The foils build into a library of their
// own, so the main path's build does not grow.
//
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// replacing repro/kernels/common.py::fold_batch mode vmap; common.cuh,
// grid_at / for_each_chunk); B = 1 is the unbatched call.
//
// Past one CTA (two buffers of (TM+2h)(TN+2h) floats pass 227 KB from h =
// 56 on the 16 x 16 tile: Box-2D7R at t = 16..29, h = 112..203, where the
// JAX substrate holds them in VMEM): the workspace form, this kernel built
// with -DREPRO_WORKSPACE into a library of its own,
// stencil_direct_workspace (common.cuh): the buffers in a device
// workspace, persistent CTAs walking the tiles, every output the one-CTA
// kernel's bit for bit, bound by the buffers' traffic through L1 and L2.
#include "tap_stage.cuh"

// The radii the kernel takes, and the taps the host passes: the dense
// (2r+1)^2 of any of them, row-major, the rest zero (kernel_taps).
#define MAX_RADIUS 7
#define MAX_TAPS 225
// V, the rows of a thread's patch, and the CTAs per SM __launch_bounds__
// asks registers for: chosen by timing V in {4, 5, 6, 8} x N in {2..5} on
// the H100 (8192^2, t = 4, fold_probe.py tapsum2d-times on copies of this
// source).  V = 5 at N = 5 (48 registers) ran fused_direct in 0.338-0.346
// ms, V = 5 at 4 in 0.360-0.369, V = 8 at 3 in 0.49-0.51.  At the main
// tile (70 rows, 18 column groups at step 0) 5-row patches give 252 of
// the 256 threads one patch a step.  The foil build keeps N = 4: its
// window loads hold 32 values in flight a thread, which spill at 48
// registers (the 9-tile foil 3.16 ms at N = 5 against 1.63 at 4).
#define DIRECT_ROWS 5
#ifndef REPRO_FOIL
#define DIRECT_MIN_BLOCKS 5
#else
#define DIRECT_MIN_BLOCKS 4
#endif
// The wide radii's CTAs per SM: the main tile's buffers at r = 7, t = 1
// take 50 KB, so shared memory allows 4; the patch's 20 sums and 4 + 2r
// row cells then fit in registers.  The foil build takes them too, so a
// foil plan of a wide stencil launches (bit for bit the default kernel).
#define DIRECT_MIN_BLOCKS_WIDE 2
// Floats before the first buffer, between the two and after the second:
// a patch's reads run up to 3 cells past its buffer's rows.  Must match
// repro_torch/kernels/common.py::DIRECT_MARGIN.
#define DIRECT_MARGIN 4

// The arguments the workspace form adds: its workspace, the floats of one
// CTA's slice and the (tile, grid) items.
#ifdef REPRO_WORKSPACE
#define DIRECT_WORKSPACE_ARGS , float* ws, size_t ws_floats, long long items
#else
#define DIRECT_WORKSPACE_ARGS
#endif

// The host's taps: the (2r+1)^2 taps of radius r, row-major, zero where
// skipped and past them.
struct Taps {
    float w[MAX_TAPS];
};

// One patch of one step: outputs at rows [r0, r0 + V) (those below r_end
// stored) and columns [c, c + 4) of `out`, from rows [r0 - R, r0 + V + R)
// of `in` (clamped to its last row, r_last).
template <int R, int V, typename TAPS>
__device__ __forceinline__ void direct_patch(const float* in, float* out, int ld, int r0, int c,
                                             int r_last, int r_end, const TAPS& taps) {
    constexpr int KW = 2 * R + 1;
    float acc[V][4];
#pragma unroll
    for (int o = 0; o < V; ++o)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[o][k] = 0.f;
#pragma unroll
    for (int q = 0; q < V + 2 * R; ++q) {
        float v[4 + 2 * R];
        direct_row<R>(in + min(r0 - R + q, r_last) * ld + c, v);
#pragma unroll
        for (int dy = 0; dy < KW; ++dy) {
            const int o = q - dy;  // the output row this input row is tap row dy of
            if (o < 0 || o >= V) continue;
#pragma unroll
            for (int dx = 0; dx < KW; ++dx) {
                const float wv = taps.w[dy * KW + dx];
                if (wv != 0.f) {
#pragma unroll
                    for (int k = 0; k < 4; ++k) acc[o][k] = fmaf(wv, v[k + dx], acc[o][k]);
                }
            }
        }
    }
#pragma unroll
    for (int o = 0; o < V; ++o)
        if (r0 + o < r_end)
            *reinterpret_cast<float4*>(out + (r0 + o) * ld + c) =
                make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
}

// direct_patch for the wide radii (R >= 4): for each tap row dy in turn,
// each output row's input row at dy, its 2R + 1 taps unrolled.  Every
// output takes its fmaf in the same ascending (dy, dx) order.
template <int R, int V, typename TAPS>
__device__ __forceinline__ void direct_patch_wide(const float* in, float* out, int ld, int r0,
                                                  int c, int r_last, int r_end,
                                                  const TAPS& taps) {
    constexpr int KW = 2 * R + 1;
    float acc[V][4];
#pragma unroll
    for (int o = 0; o < V; ++o)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[o][k] = 0.f;
#pragma unroll 1
    for (int dy = 0; dy < KW; ++dy) {
        const float* w = taps.w + dy * KW;
#pragma unroll
        for (int o = 0; o < V; ++o) {
            float v[4 + 2 * R];
            direct_row<R>(in + min(r0 - R + o + dy, r_last) * ld + c, v);
#pragma unroll
            for (int dx = 0; dx < KW; ++dx) {
                const float wv = w[dx];
                if (wv != 0.f) {
#pragma unroll
                    for (int k = 0; k < 4; ++k) acc[o][k] = fmaf(wv, v[k + dx], acc[o][k]);
                }
            }
        }
    }
#pragma unroll
    for (int o = 0; o < V; ++o)
        if (r0 + o < r_end)
            *reinterpret_cast<float4*>(out + (r0 + o) * ld + c) =
                make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
}

// Stores the TM x TN tile at src (row stride ld, on 16 bytes) to y at
// (i0, j0), masked at the grid's ragged edge, 4 cells a store where the
// destination is on 4 * sizeof(T) bytes.
template <typename T>
__device__ __forceinline__ void store_tile4(T* __restrict__ y, int H, int W, int i0, int j0,
                                            int TM, int TN, const float* src, int ld) {
    const int gpr = TN >> 2;
    for (int f = threadIdx.x; f < TM * gpr; f += CTA_THREADS) {
        const int i = f / gpr;
        const int j = 4 * (f - i * gpr);
        if (i0 + i >= H || j0 + j >= W) continue;
        const float4 v = *reinterpret_cast<const float4*>(src + i * ld + j);
        T* dst = y + (size_t)(i0 + i) * W + j0 + j;
        if (j0 + j + 4 <= W && on_bytes(dst, 4 * sizeof(T))) {
            if constexpr (sizeof(T) == 4) {
                *reinterpret_cast<float4*>(dst) = v;
            } else {
                uint2 u;
                *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
                *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
                *reinterpret_cast<uint2*>(dst) = u;
            }
        } else {
            const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (j0 + j + u < W) dst[u] = from_f32<T>(c[u]);
        }
    }
}

template <typename T, int R, bool FILL, int STAGE>
__global__ void __launch_bounds__(CTA_THREADS, R <= 3 ? DIRECT_MIN_BLOCKS : DIRECT_MIN_BLOCKS_WIDE)
stencil_direct_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, int TM, int TN,
                      int t, int ld, int my, int mx,
                      const __grid_constant__ KernelTaps<tap_slots(R, 2)> taps,
                      size_t grid_elems DIRECT_WORKSPACE_ARGS) {
    constexpr int V = DIRECT_ROWS;
#ifdef REPRO_WORKSPACE
    // this CTA's slice; item i is tile i % tiles of grid i / tiles
    float* const smem = ws + (size_t)blockIdx.x * ws_floats;
    const int gx = (W + TN - 1) / TN;
    const long long tiles = (long long)gx * ((H + TM - 1) / TM);
    const T* const x0 = x;
    T* const y0 = y;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    x = grid_at(x0, (unsigned long long)(item / tiles), grid_elems);
    y = grid_at(y0, (unsigned long long)(item / tiles), grid_elems);
    const int tile = (int)(item % tiles);
#else
    extern __shared__ __align__(16) float smem[];
#endif
    const int halo = t * R;
    const int rows0 = TM + 2 * halo, cols0 = TN + 2 * halo;
    const int lead = (-halo) & 3;
    float* const b0 = smem + DIRECT_MARGIN;
    float* const b1 = b0 + rows0 * ld + DIRECT_MARGIN;
#ifdef REPRO_WORKSPACE
    const int i0 = (tile / gx) * TM;
    const int j0 = (tile % gx) * TN;
#else
    const int i0 = blockIdx.y * TM;
    const int j0 = blockIdx.x * TN;
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }
#endif

    if constexpr (STAGE == STAGE_REGION) {
        count_cta_loads(stage_region(b0, ld, x, H, W, i0 - halo, j0 - halo - lead, rows0));
        cp_async_commit();
        cp_async_wait<0>();
    } else {
        load_region<STAGE>(b0 + lead, ld, sink_slot<STAGE>(b1, rows0 * ld), x, H, W, i0 - halo,
                           j0 - halo, rows0, cols0, TM, TN);
    }
    __syncthreads();
    const bool fill = FILL && (leaves_domain(my, i0 - halo, rows0, H) ||
                               leaves_domain(mx, j0 - halo, cols0, W));

    // The work map: this thread's first patch (g, b) -- column group g_lo +
    // g, row block b -- and the step to its next, on the first step's
    // groups.
    const int g_lo = (lead + R) >> 2;
    const int G = ((lead + cols0 - R + 3) >> 2) - g_lo;
    const int g_first = threadIdx.x % G, b_first = threadIdx.x / G;
    const int g_step = CTA_THREADS % G, b_step = CTA_THREADS / G;
    for (int s = 0; s < t; ++s) {
        float* in = (s & 1) ? b1 : b0;
        float* out = (s & 1) ? b0 : b1;
        if (fill) {
            const int depth = (t - s) * R;
            fill_boundary(in + s * R * ld + lead + s * R, 0, ld, 1, rows0 - 2 * s * R,
                          cols0 - 2 * s * R, 0, i0 - depth, j0 - depth, 1, H, W, depth,
                          MODE_PERIODIC, my, mx);
        }
        const int r_lo = (s + 1) * R, r_end = rows0 - (s + 1) * R;
        const int c_lo = lead + r_lo, c_end = lead + cols0 - (s + 1) * R;
        const int nb = (r_end - r_lo + V - 1) / V;
        for (int g = g_first, b = b_first; b < nb;) {
            const int c = (g_lo + g) * 4;
            if (c + 4 > c_lo && c < c_end) {
                if constexpr (R <= 3)
                    direct_patch<R, V>(in, out, ld, r_lo + b * V, c, rows0 - 1, r_end, taps);
                else
                    direct_patch_wide<R, V>(in, out, ld, r_lo + b * V, c, rows0 - 1, r_end, taps);
            }
            g += g_step;
            b += b_step;
            if (g >= G) g -= G, ++b;
        }
        __syncthreads();
    }
    store_tile4(y, H, W, i0, j0, TM, TN, ((t & 1) ? b1 : b0) + halo * ld + lead + halo, ld);
#ifdef REPRO_WORKSPACE
    __syncthreads();  // every thread is done with the slice before the next item
    }
#endif
}

// The instantiation a launch in this type, radius, fill and staging takes,
// its launch attributes set on the current device (err: the outcome).  The
// 9-tile foil stages periodic grids only, so it has no FILL instantiation.
template <typename T, int R, int STAGE>
static auto direct_kernel(bool fill, cudaError_t& err) {
    constexpr bool kFill = STAGE != STAGE_NINE;
    auto* kernel = fill ? stencil_direct_kernel<T, R, kFill, STAGE>
                        : stencil_direct_kernel<T, R, false, STAGE>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    err = prepare_launch(kernel, attributes_set[fill]);
    return kernel;
}

// The dynamic shared memory of the layout: the two buffers of rows x ld
// floats and the three margins (repro_torch/kernels/common.py::
// direct_layout).
static inline long long direct_smem_bytes(int rows, int ld) {
    return (2LL * rows * ld + 3 * DIRECT_MARGIN) * (long long)sizeof(float);
}

template <typename T, int R, int STAGE>
static int launch(const void* x, void* y, int H, int W, int TM, int TN, int t, int ld, int my,
                  int mx, const Taps* taps, int B, long long grid_elems, int smem_bytes,
                  cudaStream_t stream) {
    const bool fill = my != MODE_PERIODIC || mx != MODE_PERIODIC;
    if (STAGE == STAGE_NINE && fill) return (int)cudaErrorInvalidValue;  // periodic only
    const int halo = t * R, lead = (-halo) & 3;
    if (TM < 1 || TN < 4 || TN % 4 != 0 || t < 1 || ld % 4 != 0 ||
        ld < lead + TN + 2 * halo || smem_bytes < direct_smem_bytes(TM + 2 * halo, ld))
        return (int)cudaErrorInvalidValue;
    cudaError_t err;
    auto* kernel = direct_kernel<T, R, STAGE>(fill, err);
    if (err != cudaSuccess) return (int)err;
    const auto kt = kernel_taps<R, 2>(taps->w);
    return for_each_chunk(B, [&](int b0, int nb) {
        dim3 grid((W + TN - 1) / TN, (H + TM - 1) / TM, nb);
        kernel<<<grid, CTA_THREADS, smem_bytes, stream>>>(
            grid_at(static_cast<const T*>(x), b0, grid_elems),
            grid_at(static_cast<T*>(y), b0, grid_elems), H, W, TM, TN, t, ld, my, mx, kt,
            (size_t)grid_elems);
        return (int)cudaGetLastError();
    });
}

template <typename T, int STAGE>
static int launch_r(const void* x, void* y, int H, int W, int TM, int TN, int t, int r, int ld,
                    int my, int mx, const Taps* taps, int B, long long grid_elems,
                    int smem_bytes, cudaStream_t s) {
#define ARGS x, y, H, W, TM, TN, t, ld, my, mx, taps, B, grid_elems, smem_bytes, s
    if (r == 1) return launch<T, 1, STAGE>(ARGS);
    if (r == 2) return launch<T, 2, STAGE>(ARGS);
    if (r == 3) return launch<T, 3, STAGE>(ARGS);
    if (r == 4) return launch<T, 4, STAGE>(ARGS);
    if (r == 5) return launch<T, 5, STAGE>(ARGS);
    if (r == 6) return launch<T, 6, STAGE>(ARGS);
    if (r == 7) return launch<T, 7, STAGE>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}

#define ARGS x, y, H, W, TM, TN, t, r, ld, mode_y, mode_x, taps, B, grid_elems, smem_bytes, s
#if defined(REPRO_WORKSPACE)
// The workspace form's instantiations (radii 1..7, one each per grid
// dtype, the fill compiled in and gated by the modes at run time) and
// launch: min(ctas, tiles x B) persistent CTAs, CTA c on the slice_bytes at
// ws + c * slice_bytes, which hold the two buffers of
// common.py::direct_layout.
template <typename T, int R>
static int launch_workspace(const void* x, void* y, int H, int W, int TM, int TN, int t, int ld,
                            int my, int mx, const Taps* taps, void* ws, long long slice_bytes,
                            int ctas, int B, long long grid_elems, cudaStream_t stream) {
    const int halo = t * R, lead = (-halo) & 3;
    if (TM < 1 || TN < 4 || TN % 4 != 0 || t < 1 || ld % 4 != 0 || ld < lead + TN + 2 * halo ||
        ws == nullptr || slice_bytes % 128 != 0 ||
        slice_bytes < direct_smem_bytes(TM + 2 * halo, ld) || B < 1)
        return (int)cudaErrorInvalidValue;
    auto* kernel = stencil_direct_kernel<T, R, true, STAGE_REGION>;
    static std::atomic<bool> attributes_set[MAX_DEVICES];
    cudaError_t err = prepare_workspace_launch(kernel, attributes_set);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (long long)((W + TN - 1) / TN) * ((H + TM - 1) / TM);
    const int grid = workspace_grid(tiles * B, ctas);
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    kernel<<<grid, CTA_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), H, W, TM, TN, t, ld, my, mx,
        kernel_taps<R, 2>(taps->w), (size_t)grid_elems, static_cast<float*>(ws),
        (size_t)(slice_bytes / 4), tiles * B);
    return (int)cudaGetLastError();
}

// stencil_direct_launch's arguments, then the workspace ws of ctas slices
// of slice_bytes each (common.py::WorkspaceLayout); smem_bytes must be 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_direct_workspace_launch(const void* x, void* y, int H, int W, int TM,
                                               int TN, int t, int r, int ld, int dtype,
                                               int mode_y, int mode_x, const Taps* taps,
                                               void* ws, long long slice_bytes, int ctas, int B,
                                               long long grid_elems, int smem_bytes,
                                               void* stream) {
    if (grid_elems != (long long)H * W || smem_bytes != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WARGS x, y, H, W, TM, TN, t, ld, mode_y, mode_x, taps, ws, slice_bytes, ctas, B, \
              grid_elems, s
    if (dtype == 0) {
        if (r == 1) return launch_workspace<float, 1>(WARGS);
        if (r == 2) return launch_workspace<float, 2>(WARGS);
        if (r == 3) return launch_workspace<float, 3>(WARGS);
        if (r == 4) return launch_workspace<float, 4>(WARGS);
        if (r == 5) return launch_workspace<float, 5>(WARGS);
        if (r == 6) return launch_workspace<float, 6>(WARGS);
        if (r == 7) return launch_workspace<float, 7>(WARGS);
    } else if (dtype == 1) {
        using BF = __nv_bfloat16;
        if (r == 1) return launch_workspace<BF, 1>(WARGS);
        if (r == 2) return launch_workspace<BF, 2>(WARGS);
        if (r == 3) return launch_workspace<BF, 3>(WARGS);
        if (r == 4) return launch_workspace<BF, 4>(WARGS);
        if (r == 5) return launch_workspace<BF, 5>(WARGS);
        if (r == 6) return launch_workspace<BF, 6>(WARGS);
        if (r == 7) return launch_workspace<BF, 7>(WARGS);
    }
#undef WARGS
    return (int)cudaErrorInvalidValue;
}
#elif !defined(REPRO_FOIL)
// dtype: 0 = float32, 1 = bfloat16 (input and output); r in 1..7; ld and
// smem_bytes: the layout of repro_torch/kernels/common.py::direct_layout;
// mode_y, mode_x: the rows' and the columns' boundary codes (MODE_*); x
// and y hold B grids of grid_elems = H * W cells each (the batch, K11).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_direct_launch(const void* x, void* y, int H, int W, int TM, int TN,
                                     int t, int r, int ld, int dtype, int mode_y, int mode_x,
                                     const Taps* taps, int B, long long grid_elems,
                                     int smem_bytes, void* stream) {
    if (grid_elems != (long long)H * W) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_r<float, STAGE_REGION>(ARGS);
    if (dtype == 1) return launch_r<__nv_bfloat16, STAGE_REGION>(ARGS);
    return (int)cudaErrorInvalidValue;
}

// CTAs of the radius-1 instantiation a launch of this dtype and fill takes
// that fit on one SM at once with smem_bytes of dynamic shared memory, as
// the runtime counts them (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the cudaError_t of a failed query.
extern "C" int stencil_direct_ctas_per_sm(int dtype, int fill, int smem_bytes) {
    cudaError_t err = cudaErrorInvalidValue;
    int n = 0;
    if (dtype == 0) {
        auto* kernel = direct_kernel<float, 1, STAGE_REGION>(fill != 0, err);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CTA_THREADS,
                                                                smem_bytes);
    } else if (dtype == 1) {
        auto* kernel = direct_kernel<__nv_bfloat16, 1, STAGE_REGION>(fill != 0, err);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CTA_THREADS,
                                                                smem_bytes);
    }
    return err == cudaSuccess ? n : -(int)err;
}
#else
// The foils: stencil_direct_launch's arguments and the staging, stage =
// STAGE_STRIP (any boundary) or STAGE_NINE (periodic only).
extern "C" int stencil_direct_foil_launch(const void* x, void* y, int H, int W, int TM, int TN,
                                          int t, int r, int ld, int dtype, int stage, int mode_y,
                                          int mode_x, const Taps* taps, int B,
                                          long long grid_elems, int smem_bytes, void* stream) {
    if (grid_elems != (long long)H * W) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (stage == STAGE_STRIP && dtype == 0) return launch_r<float, STAGE_STRIP>(ARGS);
    if (stage == STAGE_STRIP && dtype == 1) return launch_r<__nv_bfloat16, STAGE_STRIP>(ARGS);
    if (stage == STAGE_NINE && dtype == 0) return launch_r<float, STAGE_NINE>(ARGS);
    if (stage == STAGE_NINE && dtype == 1) return launch_r<__nv_bfloat16, STAGE_NINE>(ARGS);
    return (int)cudaErrorInvalidValue;
}
#endif
#undef ARGS
