// mma.sync operand fragments for the folded banded kernels (line_fold.cuh
// in 1D, tile_fold.cuh in 2D, slab_fold.cuh in 3D, dense and compacted):
// TF32 for f32 operands (a K = 8 step of the m16n8k8 fragment layout,
// issued as two m16n8k4 products), bf16 m16n8k16 for bf16 operands, f32
// accumulators.  A 16 x 16 output tile is two 16 x 8 halves.  Each lane
// loads its own fragment elements (the layouts of the PTX ISA's "Matrix
// Fragments for mma.m16n8k8 / m16n8k16"), so an A operand may start at any
// column of the shared-memory rows: band p reads from column lo_p, which
// wmma::load_matrix_sync (256-bit aligned pointers only) cannot.  With
// g = lane / 4 and q = lane % 4:
//   TF32 A (16 x 8): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4);
//        B (8 x 8):  b0 (q, g), b1 (q + 4, g);
//   bf16 A (16 x 16), two elements per register, the lower index in the
//        low half: a0 (g, 2q..), a1 (g + 8, 2q..), a2 (g, 2q + 8..),
//        a3 (g + 8, 2q + 8..);  B (16 x 8): b0 (2q.., g), b1 (2q + 8.., g);
//   C (16 x 8): c0, c1 (g, 2q + 0/1), c2, c3 (g + 8, 2q + 0/1).
// Operands are rounded as the wmma kernels before the folds rounded them
// (A by wmma::__float_to_tf32 / __float2bfloat16_rn, TF32 B by
// __float_to_tf32), and wmma's m16n16k8 / m16n16k16 products compiled to
// the same instructions (HMMA.1684 pairs, HMMA.16816), so the folds equal
// those kernels bit for bit; on a star or box kernel, where a band's kept
// rows keep its taps in one k-step grouping or hold a single tap, the
// compacted sums equal the dense ones bit for bit.
#pragma once

#include <stdint.h>

#include "banded_mma.cuh"

template <typename TC> struct SpMma;

template <> struct SpMma<float> {
    static constexpr int K = 8;
    static constexpr int MAX_KS = MAX_KPAD / 8;
    // The 8 x 8 B fragment at p of a row-major (k, BAND_N) band.
    __device__ static __forceinline__ void load_b(uint32_t (&b)[2], const float* __restrict__ p,
                                                  int g, int q) {
        b[0] = __float_as_uint(wmma::__float_to_tf32(__ldg(p + q * BAND_N + g)));
        b[1] = __float_as_uint(wmma::__float_to_tf32(__ldg(p + (q + 4) * BAND_N + g)));
    }
    // One K = 8 step as two m16n8k4 products, columns 0-3 then 4-7: the
    // HMMA.1684 pair wmma's m16n16k8 TF32 product compiles to on sm_90a
    // (cuobjdump), so each step rounds its sums where the dense kernel's
    // does.  (One m16n8k8, HMMA.1688, sums all eight before rounding and
    // differed from the dense kernel in the last bit.)
    __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(b[0]));
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[2]), "r"(a[3]), "r"(b[1]));
    }
};

template <> struct SpMma<__nv_bfloat16> {
    static constexpr int K = 16;
    static constexpr int MAX_KS = MAX_KPAD / 16;
    __device__ static __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
        return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
    }
    __device__ static __forceinline__ void load_b(uint32_t (&b)[2],
                                                  const __nv_bfloat16* __restrict__ p, int g,
                                                  int q) {
        const __nv_bfloat16* c = p + 2 * q * BAND_N + g;
        b[0] = pack(c[0], c[BAND_N]);
        b[1] = pack(c[8 * BAND_N], c[9 * BAND_N]);
    }
    __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
};

// k-steps of a band the folded kernels' instantiation for small radii
// unrolls (R <= 4 in TF32, R <= 8 in bf16: line_fold.cuh holds them in
// registers); their other instantiation takes MAX_KS.  DEEP, past MAX_KS,
// names the instantiation of the 1D and 2D dense folds for bands deeper
// than MAX_KPAD (a composed kernel past radius 24): the tile fold runs a
// band's k-steps in pieces of MAX_KS into the same sums, the line fold
// loads each k-step's B fragments as it runs it.  Its k-steps, and the
// order of its products, are those of one unrolled loop over the band.
template <typename TC> struct FoldKs;
template <> struct FoldKs<float> {
    static constexpr int SMALL = 3;
    static constexpr int DEEP = 2 * SpMma<float>::MAX_KS;
};
template <> struct FoldKs<__nv_bfloat16> {
    static constexpr int SMALL = 2;
    static constexpr int DEEP = 2 * SpMma<__nv_bfloat16>::MAX_KS;
};

// The folded kernels (line_fold.cuh, slab_fold.cuh) keep no operand copy:
// each lane loads its A fragment elements straight from the rows the MMA
// rows fold, f32 sums (or a staged input row), and rounds them as the
// copy of the kernels before them rounded them.  Element k of a row as
// f32, zero from k >= kv on (past the band's rows or the row's valid
// extent, so NaN * 0 never reaches a valid output):
template <typename T>
__device__ __forceinline__ float fold_at(const T* row, int k, int kv) {
    return k < kv ? to_f32(row[k]) : 0.f;
}

// The A fragment of one k-step whose first column is k of the chunk (MMA
// rows g and g + 8 at r0 and r8), in the layouts above, rounded by
// wmma::__float_to_tf32 / __float2bfloat16_rn.
template <typename TC> struct FoldA;
template <> struct FoldA<float> {
    template <typename T>
    __device__ static __forceinline__ void load(uint32_t (&a)[4], const T* r0, const T* r8, int k,
                                                int kv, int q) {
        a[0] = __float_as_uint(wmma::__float_to_tf32(fold_at(r0, k + q, kv)));
        a[1] = __float_as_uint(wmma::__float_to_tf32(fold_at(r8, k + q, kv)));
        a[2] = __float_as_uint(wmma::__float_to_tf32(fold_at(r0, k + q + 4, kv)));
        a[3] = __float_as_uint(wmma::__float_to_tf32(fold_at(r8, k + q + 4, kv)));
    }
};
template <> struct FoldA<__nv_bfloat16> {
    __device__ static __forceinline__ uint32_t pair(float lo, float hi) {
        return SpMma<__nv_bfloat16>::pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
    }
    template <typename T>
    __device__ static __forceinline__ void load(uint32_t (&a)[4], const T* r0, const T* r8, int k,
                                                int kv, int q) {
        const int c = k + 2 * q;
        a[0] = pair(fold_at(r0, c, kv), fold_at(r0, c + 1, kv));
        a[1] = pair(fold_at(r8, c, kv), fold_at(r8, c + 1, kv));
        a[2] = pair(fold_at(r0, c + 8, kv), fold_at(r0, c + 9, kv));
        a[3] = pair(fold_at(r8, c + 8, kv), fold_at(r8, c + 9, kv));
    }
};
