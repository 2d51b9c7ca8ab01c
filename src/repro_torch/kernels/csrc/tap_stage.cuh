// Pieces the tap-sum kernels share (stencil_direct.cu, the 2D kernel, and
// stencil_direct3d.cu, the 3D one, which stages each plane of its region
// as the 2D kernel stages its region): the staging of a region's rows in
// 16-byte granules with cp.async, the read of one patch row, and the taps
// argument.
#pragma once

#include "line_stage.cuh"

__device__ __forceinline__ bool on_bytes(const void* p, int n) {
    return ((uintptr_t)p & (uintptr_t)(n - 1)) == 0;
}

// One granule: the 4 cells from src (on 4 * sizeof(T) bytes) to dst (on
// 16 bytes) as f32.  A workspace form's dst lies in device memory, where
// cp.async cannot land: a 16-byte load and store there.
#ifdef REPRO_WORKSPACE
__device__ __forceinline__ void granule(float* dst, const float* src) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
#else
__device__ __forceinline__ void granule(float* dst, const float* src) { cp_async16(dst, src); }
#endif
__device__ __forceinline__ void granule(float* dst, const __nv_bfloat16* src) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
}

// The region staging: buffer cell (q, c) of buf (row stride ld, c < ld) is
// global cell (r0 + q, c0 + c) taken modulo (H, W), as f32; granule k of
// row q holds cells [4k, 4k + 4).  Leaves cp.async copies in flight.
// Returns the cells this thread copied in the counting build, 0 in every
// other.
template <typename T>
__device__ __forceinline__ int stage_region(float* buf, int ld, const T* __restrict__ x, int H,
                                            int W, int r0, int c0, int rows) {
    const int gpr = ld >> 2;
    const int n = rows * gpr;
    int cells = 0;
    for (int f = threadIdx.x; f < n; f += CTA_THREADS) {
        COUNT_CELLS(cells, 4);
        const int q = f / gpr;
        const int k = f - q * gpr;
        const T* row = x + (size_t)wrap(r0 + q, H) * W;
        const int gc = wrap(c0 + 4 * k, W);
        float* dst = buf + q * ld + 4 * k;
        if (gc + 4 <= W && on_bytes(row + gc, 4 * sizeof(T))) {
            granule(dst, row + gc);
        } else {
#pragma unroll 1
            for (int u = 0; u < 4; ++u) dst[u] = to_f32(row[wrap(c0 + 4 * k + u, W)]);
        }
    }
    return cells;
}

// The 4 + 2R cells [c - R, c + 4 + R) of a buffer row, p at cell c (on
// 16 bytes): a 16-byte word and the R cells each side, in words of 16
// bytes and 8 bytes where they are on them (R <= 7), no cell outside.
template <int R>
__device__ __forceinline__ void direct_row(const float* p, float (&v)[4 + 2 * R]) {
    static_assert(R >= 1 && R <= 7, "a patch row covers radii 1..7");
    const float4 m = *reinterpret_cast<const float4*>(p);
    v[R] = m.x, v[R + 1] = m.y, v[R + 2] = m.z, v[R + 3] = m.w;
    if constexpr (R == 1) {
        v[0] = p[-1], v[5] = p[4];
    } else if constexpr (R <= 3) {
        const float2 l = *reinterpret_cast<const float2*>(p - 2);
        const float2 r = *reinterpret_cast<const float2*>(p + 4);
        v[R - 2] = l.x, v[R - 1] = l.y, v[R + 4] = r.x, v[R + 5] = r.y;
        if constexpr (R == 3) v[0] = p[-3], v[9] = p[6];
    } else {
        const float4 l = *reinterpret_cast<const float4*>(p - 4);
        const float4 r = *reinterpret_cast<const float4*>(p + 4);
        v[R - 4] = l.x, v[R - 3] = l.y, v[R - 2] = l.z, v[R - 1] = l.w;
        v[R + 4] = r.x, v[R + 5] = r.y, v[R + 6] = r.z, v[R + 7] = r.w;
        if constexpr (R >= 6) {
            const float2 l2 = *reinterpret_cast<const float2*>(p - 6);
            const float2 r2 = *reinterpret_cast<const float2*>(p + 8);
            v[R - 6] = l2.x, v[R - 5] = l2.y, v[R + 8] = r2.x, v[R + 9] = r2.y;
        }
        if constexpr (R == 5 || R == 7) v[0] = p[-R], v[2 * R + 3] = p[R + 3];
    }
}

// The taps a kernel of radius R takes by value, (dz,) dy, dx row-major,
// zero where skipped: N floats, N = (2R + 1)^D for the wide radii R >= 4,
// and for R <= 3 the (2*3 + 1)^D slots the kernels have always taken.
template <int N>
struct KernelTaps {
    float w[N];
};
__host__ __device__ constexpr int tap_slots(int R, int D) {
    return D == 2 ? (R <= 3 ? 49 : (2 * R + 1) * (2 * R + 1))
                  : (R <= 3 ? 343 : (2 * R + 1) * (2 * R + 1) * (2 * R + 1));
}

// The taps of radius R in D dimensions from the host's dense array of at
// least tap_slots(R, D) floats.
template <int R, int D>
static inline KernelTaps<tap_slots(R, D)> kernel_taps(const float* w) {
    KernelTaps<tap_slots(R, D)> k;
    for (int i = 0; i < tap_slots(R, D); ++i) k.w[i] = w[i];
    return k;
}
