// Pieces both stencil kernels share: the periodic index wrap, dtype
// conversion, the halo-region load, the tile store and the launch
// attributes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

#define CTA_THREADS 256
#define CTA_WARPS (CTA_THREADS / 32)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// v mod n for any int v (n > 0); the common case is one add or subtract.
__device__ __forceinline__ int wrap(int v, int n) {
    if (v < 0) v += n;
    else if (v >= n) v -= n;
    if ((unsigned)v >= (unsigned)n) {
        v %= n;
        if (v < 0) v += n;
    }
    return v;
}

// Loads the rows x cols region whose first cell is global (r0, c0), taken
// modulo (H, W), into dst (row stride ld) as f32.  A global load waits
// ~1 us, so each warp issues 8 rows x 4 column chunks of 32 before storing
// any: a thread keeps 32 loads in flight.
template <typename T>
__device__ __forceinline__ void load_region(float* dst, int ld, const T* __restrict__ x, int H,
                                            int W, int r0, int c0, int rows, int cols) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int cb = 0; cb < cols; cb += 128) {
        int gj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) gj[c] = wrap(c0 + cb + lane + 32 * c, W);
        for (int rb = warp * 8; rb < rows; rb += CTA_WARPS * 8) {
            float v[8][4];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const T* src = x + (size_t)wrap(r0 + min(rb + u, rows - 1), H) * W;
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    v[u][c] = (rb + u < rows && cb + lane + 32 * c < cols) ? to_f32(src[gj[c]]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (rb + u < rows && cb + lane + 32 * c < cols)
                        dst[(rb + u) * ld + cb + lane + 32 * c] = v[u][c];
        }
    }
}

// The 3D form of load_region: the planes x rows x cols region whose first
// cell is global (p0, r0, c0), taken modulo (Z, H, W), into dst (plane
// stride plane_ld, row stride ld) as f32.  The (plane, row) pairs are
// walked as one flattened row index, 8 per warp at a time as in
// load_region, and every global offset is 64-bit ((z*H + y)*W + x passes
// 2^31 at 2048 x 1024 x 1024).
template <typename T>
__device__ __forceinline__ void load_region3d(float* dst, int ld, size_t plane_ld,
                                              const T* __restrict__ x, int Z, int H, int W,
                                              int p0, int r0, int c0, int planes, int rows,
                                              int cols) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nrows = planes * rows;
    for (int cb = 0; cb < cols; cb += 128) {
        int gj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) gj[c] = wrap(c0 + cb + lane + 32 * c, W);
        for (int rb = warp * 8; rb < nrows; rb += CTA_WARPS * 8) {
            float v[8][4];
            size_t doff[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int fr = min(rb + u, nrows - 1);
                const int q = fr / rows, rr = fr - q * rows;
                doff[u] = q * plane_ld + (size_t)rr * ld + cb + lane;
                const T* src = x + ((size_t)wrap(p0 + q, Z) * H + wrap(r0 + rr, H)) * (size_t)W;
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    v[u][c] = (rb + u < nrows && cb + lane + 32 * c < cols) ? to_f32(src[gj[c]]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (rb + u < nrows && cb + lane + 32 * c < cols) dst[doff[u] + 32 * c] = v[u][c];
        }
    }
}

// Stores the TZ x TM x TN tile at the start of src (plane stride
// plane_ld, row stride ld) to y at (k0, i0, j0), masked at every ragged
// edge of the grid, with 64-bit offsets.
template <typename T>
__device__ __forceinline__ void store_tile3d(T* __restrict__ y, int Z, int H, int W, int k0,
                                             int i0, int j0, int TZ, int TM, int TN,
                                             const float* src, size_t plane_ld, int ld) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int pr = warp; pr < TZ * TM; pr += CTA_WARPS) {
        const int p = pr / TM, i = pr - p * TM;
        if (k0 + p >= Z || i0 + i >= H) continue;
        T* dst = y + ((size_t)(k0 + p) * H + (i0 + i)) * (size_t)W + j0;
        const float* s = src + p * plane_ld + (size_t)i * ld;
        for (int j = lane; j < TN && j0 + j < W; j += 32) dst[j] = from_f32<T>(s[j]);
    }
}

// The 3D kernels run one CTA per output tile on a one-dimensional grid,
// x fastest: (bx, by, bz) of tile `tile` in a gx x gy x gz tiling.
struct Tile3 {
    int bx, by, bz;
};
__device__ __forceinline__ Tile3 tile3(int tile, int gx, int gy) {
    Tile3 t;
    t.bx = tile % gx;
    t.by = (tile / gx) % gy;
    t.bz = tile / (gx * gy);
    return t;
}

// Number of CTAs of a 3D tiling, or -1 past the one-dimensional grid limit.
static inline long long grid3_ctas(int Z, int H, int W, int TZ, int TM, int TN) {
    const long long n = (long long)((W + TN - 1) / TN) * ((H + TM - 1) / TM) * ((Z + TZ - 1) / TZ);
    return n > 2147483647LL ? -1 : n;
}

// Stores the TM x TN tile at the start of src (row stride ld) to y at
// (i0, j0), masked at the grid's ragged edge.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ y, int H, int W, int i0, int j0,
                                           int TM, int TN, const float* src, int ld) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = warp; i < TM && i0 + i < H; i += CTA_WARPS)
        for (int j = lane; j < TN && j0 + j < W; j += 32)
            y[(size_t)(i0 + i) * W + j0 + j] = from_f32<T>(src[i * ld + j]);
}

#define MAX_DEVICES 64

// Dynamic shared memory above 48 KB needs opting in; the largest carveout
// lets as many CTAs share an SM as registers allow (the default carveout
// held the banded kernel to 2).  The attributes belong to the kernel on
// the current device, so they are set once per kernel and device, the
// dynamic size to all the device's opt-in limit leaves beside the
// kernel's static shared memory; a launch then takes what it asks for,
// and one over the limit fails to launch.  `done` is the calling kernel's
// own flag array (a static of its launch function).
template <typename K>
static cudaError_t prepare_launch(K* kernel, std::atomic<bool>* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
    return err;
}

extern "C" const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
