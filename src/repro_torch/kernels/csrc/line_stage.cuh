// Pieces the folded 1D kernels share (line_fold.cuh, the banded and
// compacted ones; stencil_direct1d.cu, the tap-sum): the cp.async copy of
// 16-byte granules, the shift that puts a window's first cell into its
// granule, and the boundary fill of one window of the line.
#pragma once

#include <stdint.h>

#include "common.cuh"

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The staged row's first column: the window's first cell sits `sh`
// elements into a 16-byte granule of the input, so the granules copy
// whole (the same for every row of a grid, L being a multiple of 16).
template <typename TIn>
__device__ __forceinline__ int line_shift(const TIn* xg, int h) {
    constexpr int G = 16 / (int)sizeof(TIn);
    const int mis = (int)(((uintptr_t)xg % 16) / sizeof(TIn));
    return ((mis - h) % G + G) % G;
}

// The boundary fill of one row window (common.cuh::fill_axis on a line):
// cell c of `row` is global cell g0 + c; cells below the line and cells
// above it within depth o are rewritten from the row's in-domain cells.
template <typename T>
__device__ __forceinline__ void fill_line(T* row, int win, int g0, int N, int o, int mode,
                                          int lane) {
    const int lo = min(win, max(0, -g0));
    const int hb = N - g0;
    const int he = min(win, N + o - g0);
    const int nf = lo + max(0, he - hb);
    for (int f = lane; f < nf; f += 32) {
        const int c = f < lo ? f : hb + (f - lo);
        const int g = g0 + c;
        T v = from_f32<T>(0.f);
        if (mode != MODE_ZERO) {
            const int gs = mode == MODE_REPLICATE ? (g < 0 ? 0 : N - 1)
                                                  : (g < 0 ? -g : 2 * (N - 1) - g);
            v = row[gs - g0];
        }
        row[c] = v;
    }
}
