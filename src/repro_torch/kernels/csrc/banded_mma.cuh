// wmma operand traits and constants both banded kernels share: TF32
// m16n16k8 for f32 operands, bf16 m16n16k16 for bf16 operands, f32
// accumulators; 16-column band chunks (BAND_N), contraction depth padded
// to the K step and at most MAX_KPAD.
#pragma once

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

#define MMA_TILE 16
#define BAND_N 16
#define MAX_TILES_PER_WARP 2
#define MAX_KPAD 64

template <typename TC> struct Mma;

template <> struct Mma<float> {  // TF32 operands
    static constexpr int K = 8;
    static constexpr int MAX_KS = MAX_KPAD / 8;
    using A = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
    using B = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
    using C = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
    __device__ static __forceinline__ float cvt(float v) { return wmma::__float_to_tf32(v); }
    __device__ static __forceinline__ void round_b(B& b) {
#pragma unroll
        for (int i = 0; i < b.num_elements; ++i) b.x[i] = wmma::__float_to_tf32(b.x[i]);
    }
};

template <> struct Mma<__nv_bfloat16> {
    static constexpr int K = 16;
    static constexpr int MAX_KS = MAX_KPAD / 16;
    using A = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    using B = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    using C = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
    __device__ static __forceinline__ __nv_bfloat16 cvt(float v) { return __float2bfloat16_rn(v); }
    __device__ static __forceinline__ void round_b(B&) {}  // host stored bf16
};

__host__ __device__ __forceinline__ size_t align128(size_t n) { return (n + 127) & ~(size_t)127; }
