// The folded 1D banded kernel for Hopper (sm_90a): t steps of a 1D stencil
// with a boundary mode at the line's two ends (periodic, zero, reflect,
// replicate), every product an mma.sync (TF32 m16n8k4 pairs for f32
// operands, bf16 m16n8k16 for bf16 operands) with f32 accumulators.  One
// body serves the dense banded operand (stencil_banded1d.cu, K3 on 1D
// grids) and the compacted one (stencil_sparse1d.cu, K7 on 1D grids): the
// band's kept rows start at row lo and run nk k-steps (dense: lo = 0,
// nk = kpad / K).
//
// Replaces repro/kernels/stencil_matmul.py:248 and
// repro/kernels/stencil_sparse.py:229, the JAX package's 1D banded
// contractions, which lift the line to a (1, N) grid.  The 2D kernels on
// that lifted view (stencil_banded.cu / stencil_sparse.cu, kept for
// comparison) run 16-row MMA tiles of which one row is the line: 15 of
// every 16 rows, and the 24 halo rows staged per CTA, are copies of row 0.
//
// The fold: the line's TM * L consecutive outputs of a CTA tile (TM =
// LINE_WARPS * 16 rows of L = w_tile columns, L the lifted tile's width)
// are TM rows, row i the segment [p0 + i L, p0 + (i + 1) L) with its own
// x-halo of h = t R on both sides, so a 16-row MMA tile is 16 distinct
// segments.  Each row's chunks start at the lifted tile's columns and its
// arithmetic is the lifted kernel's row, so the outputs equal the lifted
// kernel's bit for bit.  Rows need no row halo (the 1D band has one row),
// so each warp owns 16 rows of the CTA tile and works alone: it stages
// them, runs its t steps and stores them with no CTA barrier.
//
// What bounds it on an H100: bytes (one read and one write of the line at
// 3.35 TB/s; the MMAs run 16 (16 + 2R) MACs per 16 outputs and step, far
// under the TF32 roof).  So:
//   * each row's window [q - h, q + L + h) is copied global -> shared
//     memory with cp.async, 16-byte granules where the granule lies inside
//     the line and element copies (modulo N) at its ends, into a row
//     window whose stride is not a multiple of 32 words (conflict-free
//     A-fragment loads); the rows' overlapping halos are re-read from
//     L1/L2, so HBM reads the line about once, 1 + 2h / (16 L) times;
//   * the CTAs are persistent (a few per SM, __launch_bounds__ with a
//     minimum of CTAs per SM) and each warp double-buffers: it stages its
//     rows of the next tile while it computes this one;
//   * the band's B fragments are loaded once per warp into registers,
//     before every tile: one band serves every row, chunk and step (a band
//     deeper than MAX_KPAD, a composed kernel past radius 24, runs the
//     DEEP instantiation, which loads each k-step's B fragments from the
//     L1-cached band as it runs it, in the same order);
//   * there is no operand copy: each lane loads its A fragment elements
//     straight from the row windows (step 0 from the staged input, later
//     steps from the f32 sums of the step before), rounds them as the
//     lifted kernel's copy rounds them (wmma::__float_to_tf32 /
//     __float2bfloat16_rn), and zeroes every k >= BAND_N + 2R and every
//     column past the row's valid extent, so NaN * 0 never reaches a
//     valid output; the sums of a step land back in the rows (a float32
//     line's in place in its staging buffer: chunk c writes the columns
//     [16c, 16c + 16) no later chunk reads, and the smaller footprint
//     lets more CTAs share an SM; a bfloat16 line's in an f32 region), and
//     the last step leaves them through 16-byte stores, masked at the
//     ragged end.
// Only the rows whose window leaves the line (the first row of a line and
// its last valid rows) are filled, before every step at depth (t - s) R,
// by the fill rule of common.cuh::fill_axis (a FILL instantiation, so the
// periodic build carries no fill code); reflect's mirror always lies in the
// row's own window.
//
// A launch advances a batch of B lines (K11): the persistent CTAs walk the
// B * tiles (grid, CTA tile) pairs, each grid at a 64-bit offset.
#pragma once

#include <stdint.h>

#include "line_stage.cuh"
#include "sparse_mma.cuh"

#define LINE_WARPS 4
#define LINE_THREADS (LINE_WARPS * 32)
#define LINE_TILE_ROWS 16  // rows per warp: the MMA's M
#define LINE_MIN_BLOCKS 4

// One launch's geometry and operands; the shared-memory sizes are the
// host's (repro_torch/kernels/common.py::line_layout).
struct LineArgs {
    const void* x;
    void* y;
    const void* band;          // (nk * K, BAND_N) in the compute dtype
    long long grid_elems;      // N: cells of one grid of the batch
    long long items;           // B * tiles (grid, CTA tile) pairs
    int N, L, TM, t, R;
    int lds;                   // staged row stride, input-dtype elements
    int ld;                    // f32 row stride of a bf16 line's region
    int lo, nk;                // the band's first kept row and k-steps
    int mode;                  // the line's boundary code (MODE_*)
    int tiles;                 // CTA tiles per grid: ceil(N / (TM L))
    int stage_bytes;           // one staging buffer of a warp
    int warp_bytes;            // a warp's two staging buffers (and region)
};

// Where a CTA tile's rows lie: grid b of the batch, first output p0.
struct LineTile {
    long long b;
    int p0;
};
__device__ __forceinline__ LineTile line_tile(const LineArgs& a, long long item) {
    LineTile tl;
    tl.b = item / a.tiles;
    tl.p0 = (int)(item - tl.b * a.tiles) * a.TM * a.L;
    return tl;
}

// Issues the copies of this warp's valid rows of a CTA tile into `stage`:
// row r's window [q - h, q + L + 2h) lands at columns [sh, sh + L + 2h).
// Granules inside the line go by cp.async, the others (the line's ends)
// element by element, modulo N.  Returns the cells this lane copied in the
// counting build, 0 in every other.
template <typename TIn>
__device__ __forceinline__ int stage_rows(TIn* stage, const LineArgs& a, long long item,
                                          int row0, int lane) {
    constexpr int G = 16 / (int)sizeof(TIn);
    const LineTile tl = line_tile(a, item);
    const TIn* xg = grid_at(static_cast<const TIn*>(a.x), tl.b, (size_t)a.grid_elems);
    const int h = a.t * a.R;
    const int q0 = tl.p0 + row0 * a.L;  // the warp's first output
    int cells = 0;
    if (q0 >= a.N) return cells;
    const int nrows = min(LINE_TILE_ROWS, (a.N - q0 + a.L - 1) / a.L);
    const int sh = line_shift(xg, h);
    const int nb = (sh + a.L + 2 * h + G - 1) / G;  // granules per row
    for (int f = lane; f < nrows * nb; f += 32) {
        const int r = f / nb, j = f - r * nb;
        const int s0 = q0 + r * a.L - h - sh + j * G;  // the granule's first cell
        TIn* dst = stage + r * a.lds + j * G;
        COUNT_CELLS(cells, G);
        if (s0 >= 0 && s0 + G <= a.N) {
            cp_async16(dst, xg + s0);
        } else {
#pragma unroll
            for (int e = 0; e < G; ++e) dst[e] = xg[wrap(s0 + e, a.N)];
        }
    }
    return cells;
}

// Fills every valid row of the warp whose window leaves the line at step
// depth o (the window of `win` cells starting at q - o).
template <typename T>
__device__ __forceinline__ void fill_rows(T* rows, int ld, int q0, int nrows, int L, int win,
                                          int N, int o, int mode, int lane) {
    if (!leaves_domain(mode, q0 - o, (nrows - 1) * L + win, N)) return;
    for (int r = 0; r < nrows; ++r) {
        const int g0 = q0 + r * L - o;
        if (leaves_domain(mode, g0, win, N)) fill_line(rows + r * ld, win, g0, N, o, mode, lane);
    }
    __syncwarp();
}

// One step of the warp's 16 rows: the win-cell windows at src (row stride
// lds) give the (win - 2R)-cell outputs, chunk by chunk in column order,
// into dst (row stride ld).  dst may be src: chunk c writes columns
// [16c, 16c + 16), which no later chunk reads, after its own operands are
// in registers (mma.sync waits for every lane's).  The B fragments are bfr,
// or in the DEEP instantiation (MAXKS > MAX_KS) loaded from `band` per
// k-step.
template <typename TC, int MAXKS, typename TS>
__device__ __forceinline__ void line_step(const TS* src, int lds, float* dst, int ld, int win,
                                          int R, int lo, int nk,
                                          const uint32_t (&bfr)[MAXKS][2][2], const TC* band,
                                          int g, int q) {
    using S = SpMma<TC>;
    const int nch = (win - 2 * R + BAND_N - 1) / BAND_N;
    const int band_k = BAND_N + 2 * R;
    const TS* r0 = src + g * lds;
    const TS* r8 = r0 + 8 * lds;
    for (int c = 0; c < nch; ++c) {
        const int c0 = c * BAND_N;
        const int kv = min(band_k, win - c0);
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (MAXKS > S::MAX_KS) {
#pragma unroll 2
            for (int ks = 0; ks < nk; ++ks) {
                uint32_t af[4], b[2][2];
                S::load_b(b[0], band + ks * S::K * BAND_N, g, q);
                S::load_b(b[1], band + ks * S::K * BAND_N + 8, g, q);
                FoldA<TC>::load(af, r0 + c0, r8 + c0, lo + ks * S::K, kv, q);
                S::mma(acc[0], af, b[0]);
                S::mma(acc[1], af, b[1]);
            }
        } else {
#pragma unroll
            for (int ks = 0; ks < MAXKS; ++ks)
                if (ks < nk) {
                    uint32_t af[4];
                    FoldA<TC>::load(af, r0 + c0, r8 + c0, lo + ks * S::K, kv, q);
                    S::mma(acc[0], af, bfr[ks][0]);
                    S::mma(acc[1], af, bfr[ks][1]);
                }
        }
        __syncwarp();
        float* d0 = dst + g * ld + c0 + 2 * q;
        float* d8 = d0 + 8 * ld;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            *reinterpret_cast<float2*>(d0 + 8 * hh) = make_float2(acc[hh][0], acc[hh][1]);
            *reinterpret_cast<float2*>(d8 + 8 * hh) = make_float2(acc[hh][2], acc[hh][3]);
        }
    }
}

// Stores the warp's outputs (columns [0, L) of its rows in `region`) to y
// at its first output q0: 16-byte stores where y is aligned, masked at N.
template <typename T>
__device__ __forceinline__ void store_rows(T* yg, const float* region, int ld, int q0, int L,
                                           int N, int lane) {
    constexpr int V = 16 / (int)sizeof(T);
    const int total = min(LINE_TILE_ROWS * L, N - q0);
    T* out = yg + q0;
    if ((uintptr_t)out % 16 == 0) {
        for (int v = lane * V; v < total; v += 32 * V) {
            const int r = v / L, c = v - r * L;
            const float* s = region + r * ld + c;
            if (v + V <= total) {
                if constexpr (V == 4) {
                    *reinterpret_cast<float4*>(out + v) = *reinterpret_cast<const float4*>(s);
                } else {
                    const float4 lo = *reinterpret_cast<const float4*>(s);
                    const float4 hi = *reinterpret_cast<const float4*>(s + 4);
                    uint4 u;
                    u.x = SpMma<__nv_bfloat16>::pack(from_f32<T>(lo.x), from_f32<T>(lo.y));
                    u.y = SpMma<__nv_bfloat16>::pack(from_f32<T>(lo.z), from_f32<T>(lo.w));
                    u.z = SpMma<__nv_bfloat16>::pack(from_f32<T>(hi.x), from_f32<T>(hi.y));
                    u.w = SpMma<__nv_bfloat16>::pack(from_f32<T>(hi.z), from_f32<T>(hi.w));
                    *reinterpret_cast<uint4*>(out + v) = u;
                }
            } else {
                for (int e = 0; v + e < total; ++e) out[v + e] = from_f32<T>(s[e]);
            }
        }
    } else {
        for (int v = lane; v < total; v += 32) {
            const int r = v / L;
            out[v] = from_f32<T>(region[r * ld + v - r * L]);
        }
    }
}

template <typename TIn, typename TC, bool FILL, int MAXKS>
__global__ void __launch_bounds__(LINE_THREADS, LINE_MIN_BLOCKS) line_fold_kernel(LineArgs a) {
    using S = SpMma<TC>;
    extern __shared__ __align__(128) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    unsigned char* const mine = smem + (size_t)warp * a.warp_bytes;
    auto stage = [&](int k) { return reinterpret_cast<TIn*>(mine + (k & 1) * a.stage_bytes); };
    // f32 lines run their steps in place in the staging buffer; bf16 ones
    // in an f32 region after the two buffers.
    constexpr bool kInPlace = sizeof(TIn) == 4;
    const int row0 = warp * LINE_TILE_ROWS;  // the warp's rows of a CTA tile
    const int h = a.t * a.R;

    // The band, once: every row, chunk and step of this warp uses it (the
    // DEEP instantiation loads it per k-step instead).
    uint32_t bfr[MAXKS][2][2];
    const TC* band = static_cast<const TC*>(a.band);
    if constexpr (MAXKS <= S::MAX_KS) {
#pragma unroll
        for (int ks = 0; ks < MAXKS; ++ks)
            if (ks < a.nk) {
                S::load_b(bfr[ks][0], band + ks * S::K * BAND_N, g, q);
                S::load_b(bfr[ks][1], band + ks * S::K * BAND_N + 8, g, q);
            }
    }

    long long item = blockIdx.x;
    if (item < a.items) count_cta_loads(stage_rows(stage(0), a, item, row0, lane));
    cp_async_commit();
    for (int k = 0; item < a.items; ++k) {
        const long long next = item + gridDim.x;
        if (next < a.items) count_cta_loads(stage_rows(stage(k + 1), a, next, row0, lane));
        cp_async_commit();
        cp_async_wait<1>();  // this tile's copies have landed
        __syncwarp();
        const LineTile tl = line_tile(a, item);
        const int q0 = tl.p0 + row0 * a.L;
        if (q0 < a.N) {
            const TIn* xg = grid_at(static_cast<const TIn*>(a.x), tl.b, (size_t)a.grid_elems);
            const int nrows = min(LINE_TILE_ROWS, (a.N - q0 + a.L - 1) / a.L);
            TIn* in = stage(k) + line_shift(xg, h);
            float* const region = kInPlace ? reinterpret_cast<float*>(stage(k))
                                           : reinterpret_cast<float*>(mine + 2 * a.stage_bytes);
            const int ld = kInPlace ? a.lds : a.ld;
            int win = a.L + 2 * h;
            for (int s = 0; s < a.t; ++s) {
                const int depth = (a.t - s) * a.R;
                if (s == 0) {
                    if (FILL) fill_rows(in, a.lds, q0, nrows, a.L, win, a.N, depth, a.mode, lane);
                    line_step<TC, MAXKS>(in, a.lds, region, ld, win, a.R, a.lo, a.nk, bfr, band,
                                         g, q);
                } else {
                    if (FILL) fill_rows(region, ld, q0, nrows, a.L, win, a.N, depth, a.mode, lane);
                    line_step<TC, MAXKS>(region, ld, region, ld, win, a.R, a.lo, a.nk, bfr,
                                         band, g, q);
                }
                __syncwarp();
                win -= 2 * a.R;
            }
            store_rows(grid_at(static_cast<TIn*>(a.y), tl.b, (size_t)a.grid_elems), region, ld,
                       q0, a.L, a.N, lane);
            __syncwarp();
        }
        item = next;
    }
    cp_async_wait<0>();
}

// Launches the instantiation of the launch's types, boundary and band
// depth on a persistent grid: as many CTAs as fit on the card at once (at
// most one per CTA tile).  DEEP: a dense band (lo = 0) may run past MAX_KS
// k-steps, in the DEEP instantiation; the compacted bands stay within it.
template <typename TIn, typename TC, bool DEEP>
static int line_launch(const LineArgs& a, int smem_bytes, cudaStream_t stream) {
    using S = SpMma<TC>;
    const bool deep = DEEP && a.nk > S::MAX_KS;
    if (a.nk < 1 || a.lo < 0 ||
        (deep ? a.lo != 0 : a.nk > S::MAX_KS || a.lo + a.nk * S::K > MAX_KPAD + S::K))
        return (int)cudaErrorInvalidValue;
    const bool fill = a.mode != MODE_PERIODIC;
    const bool small = a.nk <= FoldKs<TC>::SMALL;
    constexpr int KS = FoldKs<TC>::SMALL, KL = S::MAX_KS, KD = FoldKs<TC>::DEEP;
    void (*kernel)(LineArgs) = fill ? (small ? line_fold_kernel<TIn, TC, true, KS>
                                             : line_fold_kernel<TIn, TC, true, KL>)
                                    : (small ? line_fold_kernel<TIn, TC, false, KS>
                                             : line_fold_kernel<TIn, TC, false, KL>);
    if constexpr (DEEP) {
        if (deep)
            kernel = fill ? line_fold_kernel<TIn, TC, true, KD>
                          : line_fold_kernel<TIn, TC, false, KD>;
    }
    static std::atomic<bool> attributes_set[6][MAX_DEVICES];
    cudaError_t err =
        prepare_launch(kernel, attributes_set[deep ? 4 + fill : 2 * fill + small]);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LINE_THREADS,
                                                        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long ctas = a.items < (long long)per_sm * sms ? a.items : (long long)per_sm * sms;
    kernel<<<(unsigned)ctas, LINE_THREADS, smem_bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

// Checks a launch's arguments against the host's layout and launches it in
// its types: dtype / compute 0 = float32 (TF32 MMA operands), 1 = bfloat16
// (DEEP: as line_launch).
template <bool DEEP = false>
static int line_launch_types(LineArgs a, int B, int dtype, int compute, int smem_bytes,
                             cudaStream_t stream) {
    const int in_bytes = dtype == 0 ? 4 : 2;
    if (B < 1 || a.N < 1 || a.grid_elems != a.N || a.L < BAND_N || a.L % BAND_N != 0 ||
        a.TM != LINE_WARPS * LINE_TILE_ROWS || a.t < 1 || a.R < 1 ||
        a.lds < a.L + 2 * a.t * a.R + 16 / in_bytes - 1 || a.lds % (16 / in_bytes) != 0 ||
        a.ld < (a.L + 2 * (a.t - 1) * a.R + BAND_N - 1) / BAND_N * BAND_N || a.ld % 4 != 0 ||
        a.stage_bytes < LINE_TILE_ROWS * a.lds * in_bytes || a.stage_bytes % 16 != 0 ||
        a.warp_bytes < 2 * a.stage_bytes + (in_bytes == 4 ? 0 : LINE_TILE_ROWS * a.ld * 4) ||
        (in_bytes == 4 && a.lds < a.ld) ||
        smem_bytes < LINE_WARPS * a.warp_bytes)
        return (int)cudaErrorInvalidValue;
    a.tiles = (int)((a.N + (long long)a.TM * a.L - 1) / ((long long)a.TM * a.L));
    a.items = (long long)B * a.tiles;
    using BF = __nv_bfloat16;
    if (dtype == 0 && compute == 0) return line_launch<float, float, DEEP>(a, smem_bytes, stream);
    if (dtype == 0 && compute == 1) return line_launch<float, BF, DEEP>(a, smem_bytes, stream);
    if (dtype == 1 && compute == 0) return line_launch<BF, float, DEEP>(a, smem_bytes, stream);
    if (dtype == 1 && compute == 1) return line_launch<BF, BF, DEEP>(a, smem_bytes, stream);
    return (int)cudaErrorInvalidValue;
}
