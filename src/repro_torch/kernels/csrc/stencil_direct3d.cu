// Tap-sum stencil kernel for Hopper (sm_90a): t fused steps of a 3D
// stencil with per-axis boundaries (periodic, zero, reflect, replicate),
// one (TZ x TM x TN) output tile per CTA.
//
// Replaces repro/kernels/stencil_direct.py::stencil_direct / _stencil_steps
// on 3D grids, together with the slab substrate that
// repro/kernels/common.py::slab_substrate_call (kinds slab_subblocked /
// slab_coltiled, geometry slab_launch_geometry) builds for it on the TPU.
//
// What bounds it on an H100: bytes.  A step costs 2K flops per point
// (K <= 343 taps, 27 for Box-3D1R) against 8 bytes moved for an f32 grid,
// below the 67 TFLOP/s / 3.35 TB/s = 20 flop/byte ridge of the CUDA cores
// for the paper's stencils until t*K is large.  The design is the 2D
// kernel's one rank up: each tile's (TZ+2h)(TM+2h)(TN+2h) region is read
// from global memory once (h = t*r, modulo indices on all three
// axes, 64-bit offsets), all t steps run out of two ping-pong f32 buffers
// in shared memory, carrying the halo and shrinking every axis by r per
// step, and the tile is written once, masked at every ragged edge.  Its
// cost is the region's read amplification, (1+2h/TZ)(1+2h/TM)(1+2h/TN):
// 2.81x for a 16x16x32 tile at h = 4, which the plan prices.  A CTA reads
// the dense (2r+1)^3 taps from global memory into shared memory (a 3D r=3
// box has 343 taps, too many to pass by value); every output is
// accumulated in f32 in row-major (dz, dy, dx) order, zero taps skipped,
// and each thread computes V rows of one column of one plane from a
// (V+2r) x (2r+1) register window per dz, as in the 2D kernel.  The
// kernel is specialised on r <= 3.  Non-periodic axes are rebuilt in the
// input buffer before every step by fill_boundary (common.cuh); a tile
// may be shallower than its halo (8 deep at h = 8), so the fill goes by
// global index on every axis.  The fill is compiled only into the FILL
// instantiation, which launches with a non-periodic axis.
//
// The same source built with -DREPRO_FOIL is the library of the
// whole-slab traffic foil (K8, replacing repro/kernels/common.py::_launch
// kind wholeslab via _assemble_foil): this kernel with the STAGE_STRIP
// staging of common.cuh, the 3 x 3 whole (z, y) neighbour tiles, which
// reads 9 (TN+2h)/TN times the grid for the same compute.
//
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// replacing repro/kernels/common.py::fold_batch mode vmap; common.cuh,
// grid_at / for_each_chunk); B = 1 is the unbatched call.
#include "common.cuh"

#define TAPS3D_SLOTS 344  // (2*3+1)^3 = 343, rounded to 16 bytes
#define ROWS_PER_THREAD 8

template <typename T, int R, bool FILL, int STAGE>
__global__ void __launch_bounds__(CTA_THREADS)
stencil_direct3d_kernel(const T* __restrict__ x, T* __restrict__ y,
                        const float* __restrict__ taps, int Z, int H, int W, int TZ, int TM,
                        int TN, int t, int gx, int gy, int mz, int my, int mx,
                        size_t grid_elems) {
    constexpr int KW = 2 * R + 1;
    constexpr int V = ROWS_PER_THREAD;
    extern __shared__ float smem[];
    float* const wsh = smem;  // dense taps; zero where skipped

    const int halo = t * R;
    const int planes0 = TZ + 2 * halo, rows = TM + 2 * halo, ld = TN + 2 * halo;
    const int plane_ld = rows * ld;
    float* const b0 = smem + TAPS3D_SLOTS;
    float* const b1 = b0 + planes0 * plane_ld;
    const Tile3 tl = tile3(blockIdx.x, gx, gy);
    const int k0 = tl.bz * TZ, i0 = tl.by * TM, j0 = tl.bx * TN;
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }

    for (int i = threadIdx.x; i < KW * KW * KW; i += blockDim.x) wsh[i] = taps[i];
    load_region3d<STAGE>(b0, ld, plane_ld, sink_slot<STAGE>(b1, planes0 * plane_ld), x, Z, H, W,
                         k0 - halo, i0 - halo, j0 - halo, planes0, rows, ld, TZ, TM);
    __syncthreads();
    const bool fill = FILL && (leaves_domain(mz, k0 - halo, planes0, Z) ||
                               leaves_domain(my, i0 - halo, rows, H) ||
                               leaves_domain(mx, j0 - halo, ld, W));

    int pin = planes0, hin = rows, win = ld;
    for (int s = 0; s < t; ++s) {
        float* in = (s & 1) ? b1 : b0;
        float* out = (s & 1) ? b0 : b1;
        if (fill) {
            const int depth = (t - s) * R;
            fill_boundary(in, plane_ld, ld, pin, hin, win, k0 - depth, i0 - depth, j0 - depth, Z,
                          H, W, depth, mz, my, mx);
        }
        const int po = pin - 2 * R, ho = hin - 2 * R, wo = win - 2 * R;
        const int nrb = (ho + V - 1) / V;
        const int strips = po * nrb * wo;
        for (int sid = threadIdx.x; sid < strips; sid += blockDim.x) {
            const int j = sid % wo;
            const int rest = sid / wo;
            const int rb = rest % nrb;
            const int p = rest / nrb;
            const int r0 = rb * V;
            float acc[V];
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = 0.f;
            // Row-major (dz, dy, dx) tap order per output; zero taps skipped.
#pragma unroll
            for (int dz = 0; dz < KW; ++dz) {
                const float* pl = in + (p + dz) * plane_ld;
                float win_[V + 2 * R][KW];
#pragma unroll
                for (int q = 0; q < V + 2 * R; ++q)
#pragma unroll
                    for (int dx = 0; dx < KW; ++dx)
                        win_[q][dx] = (r0 + q < hin) ? pl[(r0 + q) * ld + j + dx] : 0.f;
#pragma unroll
                for (int dy = 0; dy < KW; ++dy)
#pragma unroll
                    for (int dx = 0; dx < KW; ++dx) {
                        const float wv = wsh[(dz * KW + dy) * KW + dx];
                        if (wv != 0.f) {
#pragma unroll
                            for (int v = 0; v < V; ++v) acc[v] = fmaf(wv, win_[v + dy][dx], acc[v]);
                        }
                    }
            }
            float* o = out + p * plane_ld + j;
#pragma unroll
            for (int v = 0; v < V; ++v)
                if (r0 + v < ho) o[(r0 + v) * ld] = acc[v];
        }
        __syncthreads();
        pin = po;
        hin = ho;
        win = wo;
    }
    store_tile3d(y, Z, H, W, k0, i0, j0, TZ, TM, TN, (t & 1) ? b1 : b0, plane_ld, ld);
}

template <typename T, int R, int STAGE>
static int launch(const void* x, void* y, const float* taps, int Z, int H, int W, int TZ, int TM,
                  int TN, int t, const int* modes, int B, long long grid_elems, int smem_bytes,
                  cudaStream_t stream) {
    const bool fill = modes[0] != MODE_PERIODIC || modes[1] != MODE_PERIODIC ||
                      modes[2] != MODE_PERIODIC;
    auto* kernel = fill ? stencil_direct3d_kernel<T, R, true, STAGE>
                        : stencil_direct3d_kernel<T, R, false, STAGE>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    cudaError_t err = prepare_launch(kernel, attributes_set[fill]);
    if (err != cudaSuccess) return (int)err;
    const long long ctas = grid3_ctas(Z, H, W, TZ, TM, TN);
    if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
    const int gx = (W + TN - 1) / TN, gy = (H + TM - 1) / TM;
    return for_each_chunk(B, [&](int b0, int nb) {
        kernel<<<dim3((unsigned)ctas, 1, nb), CTA_THREADS, smem_bytes, stream>>>(
            grid_at(static_cast<const T*>(x), b0, grid_elems),
            grid_at(static_cast<T*>(y), b0, grid_elems), taps, Z, H, W, TZ, TM, TN, t, gx, gy,
            modes[0], modes[1], modes[2], (size_t)grid_elems);
        return (int)cudaGetLastError();
    });
}

template <typename T, int STAGE>
static int launch_r(const void* x, void* y, const float* taps, int Z, int H, int W, int TZ,
                    int TM, int TN, int t, int r, const int* modes, int B, long long grid_elems,
                    int smem_bytes, cudaStream_t s) {
#define ARGS x, y, taps, Z, H, W, TZ, TM, TN, t, modes, B, grid_elems, smem_bytes, s
    if (r == 1) return launch<T, 1, STAGE>(ARGS);
    if (r == 2) return launch<T, 2, STAGE>(ARGS);
    if (r == 3) return launch<T, 3, STAGE>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}

#define ARGS x, y, static_cast<const float*>(taps), Z, H, W, TZ, TM, TN, t, r, modes, B, \
             grid_elems, smem_bytes, static_cast<cudaStream_t>(stream)
#ifndef REPRO_FOIL
// taps: the dense (2r+1)^3 float32 weights on the device.  dtype: 0 =
// float32, 1 = bfloat16 (input and output); r in 1..3; mode_z, mode_y,
// mode_x: each axis's boundary code (MODE_*); x and y hold B grids of
// grid_elems = Z * H * W cells each (the batch, K11).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int stencil_direct3d_launch(const void* x, void* y, const void* taps, int Z, int H,
                                       int W, int TZ, int TM, int TN, int t, int r, int dtype,
                                       int mode_z, int mode_y, int mode_x, int B,
                                       long long grid_elems, int smem_bytes, void* stream) {
    if (grid_elems != (long long)Z * H * W) return (int)cudaErrorInvalidValue;
    const int modes[3] = {mode_z, mode_y, mode_x};
    if (dtype == 0) return launch_r<float, STAGE_REGION>(ARGS);
    if (dtype == 1) return launch_r<__nv_bfloat16, STAGE_REGION>(ARGS);
    return (int)cudaErrorInvalidValue;
}
#else
// The whole-slab foil: stencil_direct3d_launch's arguments and the
// staging, stage = STAGE_STRIP (any boundary).
extern "C" int stencil_direct3d_foil_launch(const void* x, void* y, const void* taps, int Z,
                                            int H, int W, int TZ, int TM, int TN, int t, int r,
                                            int dtype, int stage, int mode_z, int mode_y,
                                            int mode_x, int B, long long grid_elems,
                                            int smem_bytes, void* stream) {
    if (grid_elems != (long long)Z * H * W) return (int)cudaErrorInvalidValue;
    const int modes[3] = {mode_z, mode_y, mode_x};
    if (stage == STAGE_STRIP && dtype == 0) return launch_r<float, STAGE_STRIP>(ARGS);
    if (stage == STAGE_STRIP && dtype == 1) return launch_r<__nv_bfloat16, STAGE_STRIP>(ARGS);
    return (int)cudaErrorInvalidValue;
}
#endif
#undef ARGS
