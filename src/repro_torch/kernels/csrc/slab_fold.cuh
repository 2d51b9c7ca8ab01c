// The slab fold, the 3D banded kernels for Hopper (sm_90a): t steps of a
// 3D stencil with per-axis boundaries (periodic, zero, reflect,
// replicate), one (TZ x TM x TN) output tile per CTA, every product an
// mma.sync (TF32 m16n8k4 pairs for f32 operands, bf16 m16n8k16 for bf16
// operands, sparse_mma.cuh) with f32 accumulators.  One body serves the
// dense banded operand (stencil_banded3d.cu, K5/K6 banded) and the
// compacted one (stencil_sparse3d.cu, K7 on 3D grids): band p of a step
// is the kernel x-row (dz_p, dy_p), its kept rows start at row lo_p and
// run nk_p k-steps (dense: lo = 0, nk = kpad / K for every band).
//
// Replaces repro/kernels/stencil_matmul.py::_banded_step / _banded_steps
// and repro/kernels/stencil_sparse.py::_sparse_banded_step /
// _sparse_banded_steps on 3D grids, with the slab substrate that
// repro/kernels/common.py::slab_substrate_call builds for them.  An output
// tile of the step is 16 rows of 16 columns: sum_p A_p @ B_p, A_p the 16
// rows' input rows shifted by (dz_p, dy_p) from column c + lo_p on, B_p the
// band.
//
// What bounds it on an H100: bytes for the stencils of this repository
// (one read and one write of the grid at 3.35 TB/s, times the region's
// read amplification, 2.81 at h = 4 on the 16x16x32 tile; the MMAs do
// under 1 ms of TF32 work at 512^3, t = 4, Box-3D1R), if the CTA's steps
// in shared memory keep pace.  So each tile's (TZ+2h)(TM+2h)(TN+2h) region
// is read from global memory once (load_region3d, common.cuh: h = t*R,
// modulo indices, 64-bit offsets), all t steps run in shared memory in
// f32, every axis shrinks by R per step, and the tile is written once,
// masked at every ragged edge.  The steps:
//   * the fold: a step's outputs are its po x ho (plane, row) pairs, and
//     a 16-row MMA tile is any 16 consecutive pairs (plane-major), so a
//     tile runs across plane boundaries and only the step's last tile is
//     ragged (at h = 4 on the main tile, step 0 runs 31 tiles for 484
//     pairs where a 16-row tile per plane ran 44);
//   * no operand copy: each lane loads its A fragment elements straight
//     from the f32 region at the band's column, zeroing every chunk column
//     >= kv (past BAND_N + 2R or the row's valid extent) so NaN * 0 never
//     reaches a valid output, in the k-steps that reach kv only.  Operands
//     are rounded as the copy of the kernel before this fold rounded them:
//     bf16 ones at the load (FoldA), TF32 ones in the region, once per
//     cell: the step-0 region in place (slab_round), every later step's
//     input as the step before stores it, so the MMA loop issues loads and
//     products only;
//   * in place: the step walks its 16-column chunks in order, and a chunk
//     in passes of at most SLAB_PASS_TILES tiles in pair order, warp w
//     taking tiles w, w + 8, ...: TPW = ceil(tiles / 8) slots per warp,
//     an instantiation of the pass per TPW, its k-steps unrolled (an
//     instantiation of the kernel for bands of at most FoldKs<TC>::SMALL
//     k-steps, one for MAX_KS).  A pass holds its sums in registers,
//     passes one CTA barrier, and stores them into the region at the
//     pairs' own cells, columns [16c, 16c + 16) masked at the step's
//     width.  No later chunk reads those columns (chunk c + 1 reads from
//     16(c + 1) on), and no later pass reads those cells (a pair reads the
//     pairs at or after it, dz, dy >= 0), so one barrier per pass and one
//     per step suffice;
//   * the band once per CTA: a band is Toeplitz, B_p[k][n] = f_p(k - n),
//     so the host passes each as one row of toe_ld numbers, f_p(d) at
//     d + BAND_N - 1 (kpad + 15 used), staged in shared memory beside
//     every band's header (its row shift dz*plane_ld + dy*ld, lo, nk);
//     TF32 B is rounded once, there, by __float_to_tf32;
//   * the region's row stride is 4 mod 8 words and its plane stride
//     continues the rows of step 0's ho (host: common.py::
//     slab_fold_layout), so the 8 rows of an A fragment hit 8 bank quads,
//     across a plane boundary too (at step 0; later steps shrink ho and
//     may pair two rows on a bank there);
//   * two CTAs per SM (__launch_bounds__ minimum SLAB_MIN_BLOCKS): the
//     main tile's region and band take 103,824 bytes.
// The accumulation runs band p outer, k-steps inner, HMMA.1684 pairs for
// TF32, on the operand values of the wmma kernel before this fold, so the
// outputs equal it bit for bit.
//
// Each step first rebuilds the non-periodic axes' halo in the region
// (fill_boundary, common.cuh; compiled only into the FILL instantiation)
// and waits for it.  The same body built with STAGE_STRIP is the
// whole-slab foil (K8, stencil_banded3d.cu with -DREPRO_FOIL); its sink
// slots lie in the band's slots, which it stages only after a barrier.
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// common.cuh, grid_at / for_each_chunk).
//
// Past one CTA (the composed contraction at h = 12..16: up to 1089 bands
// of Box-3D2R composed to radius 16 and a 33-plane region; the reuse
// folds at h = 16: a 48-plane region), the two cluster forms at the end of
// this file spread the slab over a thread-block cluster (cluster.cuh):
// the composed contraction split by the kernel's planes dz, each CTA
// folding every output pair over its bands and the partial sums added
// through distributed shared memory (slab_fold_dz_kernel); the reuse
// folds split by the region's planes, each CTA folding its own pairs and
// copying the 2R planes after its own from their owners before each step
// (slab_fold_planes_kernel).  The bound is the one-CTA kernel's; what the
// split adds is the copied planes (reuse) or the TZ - 1 planes each CTA
// stages twice and one add per output and CTA (composed).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "sparse_mma.cuh"

#define SLAB_MIN_BLOCKS 2
#define SLAB_TILES_PER_WARP 4
#define SLAB_PASS_TILES (CTA_WARPS * SLAB_TILES_PER_WARP)

// One launch's geometry and operands; the shared-memory layout is the
// host's (repro_torch/kernels/common.py::slab_fold_layout).
struct SlabArgs {
    const void* x;
    void* y;
    const void* toe;   // (n_rows, toe_ld) Toeplitz rows in the compute dtype
    const int* rows;   // (n_rows, 4): each band's (dz, dy, lo, nk)
    size_t grid_elems;  // Z * H * W: cells of one grid of the batch
    int Z, H, W, TZ, TM, TN, t, R;
    int ld, plane_ld;   // the f32 region's row and plane strides
    int toe_ld, n_rows;
    int gx, gy;         // CTA tiles along x and y
    int mz, my, mx;     // each axis's boundary code (MODE_*)
};

// Byte offsets of the band's Toeplitz rows and of its headers (int4 each)
// after the region, and the bytes of all three.
__host__ __device__ __forceinline__ size_t slab_toe_offset(const SlabArgs& a) {
    return align128((size_t)(a.TZ + 2 * a.t * a.R) * a.plane_ld * sizeof(float));
}
__host__ __device__ __forceinline__ size_t slab_hdr_offset(const SlabArgs& a, int tc_bytes) {
    return slab_toe_offset(a) + align128((size_t)a.n_rows * a.toe_ld * tc_bytes);
}
static inline size_t slab_smem_bytes(const SlabArgs& a, int tc_bytes) {
    return slab_hdr_offset(a, tc_bytes) + (size_t)a.n_rows * sizeof(int4);
}

// The B fragments of one k-step from a band's Toeplitz row: t points at
// f(k0 - n) for this lane's n (the half's g) and the step's first row k0.
template <typename TC> struct SlabB;
template <> struct SlabB<float> {
    __device__ static __forceinline__ float round(float v) { return wmma::__float_to_tf32(v); }
    __device__ static __forceinline__ void load(uint32_t (&b)[2], const float* t, int q) {
        b[0] = __float_as_uint(t[q]);
        b[1] = __float_as_uint(t[q + 4]);
    }
};
template <> struct SlabB<__nv_bfloat16> {
    __device__ static __forceinline__ __nv_bfloat16 round(__nv_bfloat16 v) { return v; }
    __device__ static __forceinline__ void load(uint32_t (&b)[2], const __nv_bfloat16* t, int q) {
        using S = SpMma<__nv_bfloat16>;
        b[0] = S::pack(t[2 * q], t[2 * q + 1]);
        b[1] = S::pack(t[2 * q + 8], t[2 * q + 9]);
    }
};

// Element k of a region row as f32: zero from kv on (MASK), or loaded.
template <bool MASK>
__device__ __forceinline__ float slab_at(const float* row, int k, int kv) {
    return MASK ? fold_at(row, k, kv) : row[k];
}

// The A fragment of one k-step: r0 and r8 point at this lane's first
// column of rows g and g + 8 (column q in TF32, 2q in bf16), k is the
// k-step's first column, and columns >= lim (this lane's kv) read as zero
// (MASK) or all load.  TF32 operands lie in the region rounded already
// (slab_round before step 0, the passes' stores after it), so they load
// as they are; bf16 ones are rounded here, as FoldA rounds them.
template <typename TC, bool MASK>
__device__ __forceinline__ void slab_a(uint32_t (&a)[4], const float* r0, const float* r8, int k,
                                       int lim) {
    if constexpr (std::is_same<TC, float>::value) {
        a[0] = __float_as_uint(slab_at<MASK>(r0, k, lim));
        a[1] = __float_as_uint(slab_at<MASK>(r8, k, lim));
        a[2] = __float_as_uint(slab_at<MASK>(r0, k + 4, lim));
        a[3] = __float_as_uint(slab_at<MASK>(r8, k + 4, lim));
    } else {
        using A = FoldA<__nv_bfloat16>;
        a[0] = A::pair(slab_at<MASK>(r0, k, lim), slab_at<MASK>(r0, k + 1, lim));
        a[1] = A::pair(slab_at<MASK>(r8, k, lim), slab_at<MASK>(r8, k + 1, lim));
        a[2] = A::pair(slab_at<MASK>(r0, k + 8, lim), slab_at<MASK>(r0, k + 9, lim));
        a[3] = A::pair(slab_at<MASK>(r8, k + 8, lim), slab_at<MASK>(r8, k + 9, lim));
    }
}

// A value as the next step's operand: TF32-rounded where `round`.
__device__ __forceinline__ float slab_operand(float v, bool round) {
    return round ? wmma::__float_to_tf32(v) : v;
}

// Rounds the step-0 region, p x h x w cells, to TF32 in place, for TF32
// operands only (a step's passes round what they store for the next): an
// A operand then loads the value FoldA's rounding at the load would give
// it, rounded once per cell instead of once per band and tile.  Four rows
// per warp at a time, so four loads are in flight; ends with a barrier.
template <typename TC>
__device__ __forceinline__ void slab_round(float* region, int plane_ld, int ld, int p, int h,
                                           int w) {
    if constexpr (std::is_same<TC, float>::value) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const int rows = p * h;
        for (int rb = warp * 4; rb < rows; rb += CTA_WARPS * 4)
            for (int c = lane; c < w; c += 32) {
                float* at[4];
                float v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int pr = min(rb + u, rows - 1), z = pr / h;
                    at[u] = region + z * plane_ld + (pr - z * h) * ld + c;
                    v[u] = *at[u];
                }
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (rb + u < rows) *at[u] = wmma::__float_to_tf32(v[u]);
            }
        __syncthreads();
    }
}

// Region offset of the (plane, row) pair m of a step whose planes hold ho
// output rows.
__device__ __forceinline__ int slab_pair(int m, int ho, int plane_ld, int ld) {
    const int z = m / ho;
    return z * plane_ld + (m - z * ho) * ld;
}

// One pass of a chunk: this warp's `mine` (TPW or TPW - 1) tiles, tile0,
// tile0 + CTA_WARPS, ..., of a step with `pairs` output pairs; their sums
// over every band (each of at most KS k-steps, unrolled), then (after the
// barrier every warp passes) their store at the pairs' own cells, columns
// [c0, c0 + 16) below wo, TF32-rounded where `round`.  `two`: the chunk's
// second n8 half holds outputs.  Every slot but the last holds one of the
// warp's tiles, whose loads need no mask in a k-step whose columns all lie
// below kv; the last slot's loads are masked, to nothing where the warp
// has no such tile (its zero products are not stored).
template <typename TC, int KS, int TPW>
__device__ __forceinline__ void slab_pass(float* region, const TC* toe, const int4* hdr,
                                          int n_rows, int toe_ld, int tile0, int mine, int pairs,
                                          int ho, int plane_ld, int ld, int c0, int kv, int wo,
                                          bool two, bool round, int g, int q) {
    using S = SpMma<TC>;
    float acc[TPW][2][4];
    int off[TPW][2];  // rows g and g + 8 of each slot, at the chunk's column 0
#pragma unroll
    for (int u = 0; u < TPW; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][h][e] = 0.f;
        const int m = (tile0 + min(u, max(mine - 1, 0)) * CTA_WARPS) * MMA_TILE + g;
        off[u][0] = slab_pair(min(m, pairs - 1), ho, plane_ld, ld) + c0;
        off[u][1] = slab_pair(min(m + 8, pairs - 1), ho, plane_ld, ld) + c0;
    }
    // This lane's first A column: q in TF32, 2q in bf16.
    const int lq = std::is_same<TC, float>::value ? q : 2 * q;
    const int kv_last = mine == TPW ? kv : 0;
    const TC* bt = toe + (BAND_N - 1) - g;
    for (int p = 0; p < n_rows; ++p, bt += toe_ld) {
        const int4 hd = hdr[p];  // row shift, lo, nk
        const float* r[TPW][2];  // the slots' rows at this lane's first column
#pragma unroll
        for (int u = 0; u < TPW; ++u) {
            r[u][0] = region + hd.x + hd.y + lq + off[u][0];
            r[u][1] = region + hd.x + hd.y + lq + off[u][1];
        }
        const int lim = kv - hd.y - lq, lim_last = kv_last - hd.y - lq;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
            if (ks < hd.z) {
                const int k = ks * S::K;  // the k-step's first column past lo
                uint32_t b[2][2];
                SlabB<TC>::load(b[0], bt + k, q);
                SlabB<TC>::load(b[1], bt + k - 8, q);
                uint32_t af[TPW][4];
                if (hd.y + k + S::K <= kv) {
#pragma unroll
                    for (int u = 0; u < TPW - 1; ++u)
                        slab_a<TC, false>(af[u], r[u][0], r[u][1], k, lim);
                } else {
#pragma unroll
                    for (int u = 0; u < TPW - 1; ++u)
                        slab_a<TC, true>(af[u], r[u][0], r[u][1], k, lim);
                }
                slab_a<TC, true>(af[TPW - 1], r[TPW - 1][0], r[TPW - 1][1], k, lim_last);
#pragma unroll
                for (int u = 0; u < TPW; ++u) {
                    S::mma(acc[u][0], af[u], b[0]);
                    if (two) S::mma(acc[u][1], af[u], b[1]);
                }
            }
    }
    __syncthreads();  // every tile of the pass has read its operands
#pragma unroll
    for (int u = 0; u < TPW; ++u)
        if (u < mine) {
            const int m = (tile0 + u * CTA_WARPS) * MMA_TILE + g;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = 8 * h + 2 * q;
                if (c0 + col >= wo) continue;  // wo is even: both columns or neither
                if (m < pairs)
                    *reinterpret_cast<float2*>(region + off[u][0] + col) =
                        make_float2(slab_operand(acc[u][h][0], round),
                                    slab_operand(acc[u][h][1], round));
                if (m + 8 < pairs)
                    *reinterpret_cast<float2*>(region + off[u][1] + col) =
                        make_float2(slab_operand(acc[u][h][2], round),
                                    slab_operand(acc[u][h][3], round));
            }
        }
}

// Stages the band's Toeplitz rows (TF32-rounded) and every band's header.
template <typename TC>
__device__ __forceinline__ void stage_band(TC* toe, int4* hdr, const SlabArgs& a) {
    const TC* src = static_cast<const TC*>(a.toe);
    for (int i = threadIdx.x; i < a.n_rows * a.toe_ld; i += CTA_THREADS)
        toe[i] = SlabB<TC>::round(src[i]);
    for (int p = threadIdx.x; p < a.n_rows; p += CTA_THREADS) {
        const int* r = a.rows + 4 * p;
        hdr[p] = make_int4(r[0] * a.plane_ld + r[1] * a.ld, r[2], r[3], 0);
    }
}

// The staging is the last template argument, as in every kernel of the
// port (repro_torch/kernels/sass.py matches instantiations by it).
template <typename TIn, typename TC, bool FILL, int KS, int STAGE>
__global__ void __launch_bounds__(CTA_THREADS, SLAB_MIN_BLOCKS)
    slab_fold_kernel(const SlabArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int halo = a.t * a.R;
    const int p0 = a.TZ + 2 * halo, h0 = a.TM + 2 * halo, w0 = a.TN + 2 * halo;
    float* const region = reinterpret_cast<float*>(smem);
    TC* const toe = reinterpret_cast<TC*>(smem + slab_toe_offset(a));
    int4* const hdr = reinterpret_cast<int4*>(smem + slab_hdr_offset(a, sizeof(TC)));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const Tile3 tl = tile3(blockIdx.x, a.gx, a.gy);
    const int k0 = tl.bz * a.TZ, i0 = tl.by * a.TM, j0 = tl.bx * a.TN;
    const TIn* x = static_cast<const TIn*>(a.x);
    TIn* y = static_cast<TIn*>(a.y);
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, a.grid_elems);
        y = grid_at(y, blockIdx.z, a.grid_elems);
    }

    load_region3d<STAGE>(region, a.ld, a.plane_ld,
                         sink_slot<STAGE>(reinterpret_cast<float*>(toe),
                                          a.n_rows * a.toe_ld * (int)sizeof(TC) / 4),
                         x, a.Z, a.H, a.W, k0 - halo, i0 - halo, j0 - halo, p0, h0, w0, a.TZ,
                         a.TM);
    if constexpr (STAGE != STAGE_REGION) __syncthreads();  // the sink slots are the band's
    stage_band(toe, hdr, a);
    __syncthreads();
    const bool fill = FILL && (leaves_domain(a.mz, k0 - halo, p0, a.Z) ||
                               leaves_domain(a.my, i0 - halo, h0, a.H) ||
                               leaves_domain(a.mx, j0 - halo, w0, a.W));

    const int band_k = BAND_N + 2 * a.R;  // rows of one dense band
    int pin = p0, hin = h0, win = w0;
    for (int s = 0; s < a.t; ++s) {
        const int po = pin - 2 * a.R, ho = hin - 2 * a.R, wo = win - 2 * a.R;
        const int pairs = po * ho;
        const int ntiles = (pairs + MMA_TILE - 1) / MMA_TILE;
        if (fill) {
            const int depth = (a.t - s) * a.R;
            fill_boundary(region, a.plane_ld, a.ld, pin, hin, win, k0 - depth, i0 - depth,
                          j0 - depth, a.Z, a.H, a.W, depth, a.mz, a.my, a.mx);
        }
        if (s == 0) slab_round<TC>(region, a.plane_ld, a.ld, pin, hin, win);
        const bool round = std::is_same<TC, float>::value && s + 1 < a.t;
        for (int c0 = 0; c0 < wo; c0 += BAND_N) {
            const int kv = min(band_k, win - c0);
            const bool two = c0 + 8 < wo;
            for (int base = 0; base < ntiles; base += SLAB_PASS_TILES) {
                // The pass's n tiles: warp w takes w, w + 8, ..., TPW or
                // TPW - 1 of them, TPW = ceil(n / 8).
                const int n = min(SLAB_PASS_TILES, ntiles - base);
                const int mine = warp < n ? (n - warp + CTA_WARPS - 1) / CTA_WARPS : 0;
                auto pass = [&](auto slots) {
                    slab_pass<TC, KS, decltype(slots)::value>(
                        region, toe, hdr, a.n_rows, a.toe_ld, base + warp, mine, pairs, ho,
                        a.plane_ld, a.ld, c0, kv, wo, two, round, g, q);
                };
                switch ((n + CTA_WARPS - 1) / CTA_WARPS) {
                case 1: pass(std::integral_constant<int, 1>()); break;
                case 2: pass(std::integral_constant<int, 2>()); break;
                case 3: pass(std::integral_constant<int, 3>()); break;
                default: pass(std::integral_constant<int, SLAB_TILES_PER_WARP>());
                }
            }
        }
        __syncthreads();  // the step's sums are in place
        pin = po;
        hin = ho;
        win = wo;
    }

    store_tile3d(y, a.Z, a.H, a.W, k0, i0, j0, a.TZ, a.TM, a.TN, region, a.plane_ld, a.ld);
}

// The instantiation a launch in these types, fill, staging and band depth
// (small: no band runs past FoldKs<TC>::SMALL k-steps) takes, its launch
// attributes set on the current device (err: the outcome).
template <typename TIn, typename TC, int STAGE>
static auto slab_kernel(bool fill, bool small, cudaError_t& err) {
    constexpr int KS = FoldKs<TC>::SMALL, KL = SpMma<TC>::MAX_KS;
    auto* kernel = fill ? (small ? slab_fold_kernel<TIn, TC, true, KS, STAGE>
                                 : slab_fold_kernel<TIn, TC, true, KL, STAGE>)
                        : (small ? slab_fold_kernel<TIn, TC, false, KS, STAGE>
                                 : slab_fold_kernel<TIn, TC, false, KL, STAGE>);
    static std::atomic<bool> attributes_set[4][MAX_DEVICES];
    err = prepare_launch(kernel, attributes_set[2 * fill + small]);
    return kernel;
}

// k-steps of the launch's deepest band: its Toeplitz rows hold K * nk + 16.
template <typename TC>
static int slab_max_ks(const SlabArgs& a) {
    return (a.toe_ld - BAND_N) / SpMma<TC>::K;
}

template <typename TIn, typename TC, int STAGE>
static int slab_launch(const SlabArgs& a, int B, int smem_bytes, cudaStream_t stream) {
    const bool fill = a.mz != MODE_PERIODIC || a.my != MODE_PERIODIC || a.mx != MODE_PERIODIC;
    const int ks = slab_max_ks<TC>(a);
    if (ks < 1 || ks > SpMma<TC>::MAX_KS) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    auto* kernel = slab_kernel<TIn, TC, STAGE>(fill, ks <= FoldKs<TC>::SMALL, err);
    if (err != cudaSuccess) return (int)err;
    const long long ctas = grid3_ctas(a.Z, a.H, a.W, a.TZ, a.TM, a.TN);
    if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
    return for_each_chunk(B, [&](int b0, int nb) {
        SlabArgs c = a;
        c.x = grid_at(static_cast<const TIn*>(a.x), b0, a.grid_elems);
        c.y = grid_at(static_cast<TIn*>(a.y), b0, a.grid_elems);
        kernel<<<dim3((unsigned)ctas, 1, nb), CTA_THREADS, smem_bytes, stream>>>(c);
        return (int)cudaGetLastError();
    });
}

// Calls f(TIn*, TC*) with null pointers of the grid and compute types:
// dtype / compute 0 = float32 (TF32 MMA operands), 1 = bfloat16.
template <typename F>
static int slab_types(int dtype, int compute, F&& f) {
    using BF = __nv_bfloat16;
    if (dtype == 0 && compute == 0) return f((float*)nullptr, (float*)nullptr);
    if (dtype == 0 && compute == 1) return f((float*)nullptr, (BF*)nullptr);
    if (dtype == 1 && compute == 0) return f((BF*)nullptr, (float*)nullptr);
    if (dtype == 1 && compute == 1) return f((BF*)nullptr, (BF*)nullptr);
    return (int)cudaErrorInvalidValue;
}

// Checks a launch's arguments against the host's layout and launches it in
// its types and staging.
template <int STAGE>
static int slab_launch_types(SlabArgs a, int B, int dtype, int compute, int smem_bytes,
                             cudaStream_t stream) {
    const int halo = a.t * a.R;
    const int tc_bytes = compute == 0 ? 4 : 2;
    if (a.n_rows < 1 || a.t < 1 || a.R < 1 || a.TZ < 1 || a.TM < 1 || a.TN < 1 ||
        a.grid_elems != (size_t)a.Z * a.H * a.W || a.ld < a.TN + 2 * halo || a.ld % 2 != 0 ||
        a.plane_ld < (a.TM + 2 * halo) * a.ld || a.plane_ld % 2 != 0 || a.toe_ld % 8 != 0 ||
        smem_bytes < (long long)slab_smem_bytes(a, tc_bytes))
        return (int)cudaErrorInvalidValue;
    a.gx = (a.W + a.TN - 1) / a.TN;
    a.gy = (a.H + a.TM - 1) / a.TM;
    return slab_types(dtype, compute, [&](auto* in, auto* tc) {
        using TIn = std::remove_pointer_t<decltype(in)>;
        using TC = std::remove_pointer_t<decltype(tc)>;
        return slab_launch<TIn, TC, STAGE>(a, B, smem_bytes, stream);
    });
}

// CTAs of the instantiation (types, fill, STAGE, small band) that fit on
// one SM at once with smem_bytes of dynamic shared memory, as the runtime
// counts them (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus
// the cudaError_t of a failed query.
template <int STAGE>
static int slab_ctas_per_sm(int dtype, int compute, int fill, int smem_bytes) {
    return slab_types(dtype, compute, [&](auto* in, auto* tc) {
        using TIn = std::remove_pointer_t<decltype(in)>;
        using TC = std::remove_pointer_t<decltype(tc)>;
        cudaError_t err;
        auto* kernel = slab_kernel<TIn, TC, STAGE>(fill != 0, true, err);
        int n = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CTA_THREADS,
                                                                smem_bytes);
        return err == cudaSuccess ? n : -(int)err;
    });
}

// ---------------------------------------------------------------------------
// The cluster forms (cluster.cuh; the tile rule's third rung): a slab whose
// region and bands fit no one CTA's 227 KB -- the composed contraction at
// halos 12..16 (up to 1089 bands of Box-3D2R composed to radius 16), the
// reuse folds at h = 16 -- spread over the C CTAs of a cluster, which
// compute one tile together.  Both keep the one-CTA layout's strides
// (common.py::slab_fold_layout) in every CTA's share and run the one-CTA
// pass (slab_pass) on it.
// ---------------------------------------------------------------------------

// Stages bands [band0, band0 + n) of the launch (Toeplitz rows, TF32-
// rounded, and headers), their plane shift counted from plane dz0.
template <typename TC>
__device__ __forceinline__ void stage_bands(TC* toe, int4* hdr, const SlabArgs& a, int band0,
                                            int n, int dz0) {
    const TC* src = static_cast<const TC*>(a.toe) + (size_t)band0 * a.toe_ld;
    for (int i = threadIdx.x; i < n * a.toe_ld; i += CTA_THREADS) toe[i] = SlabB<TC>::round(src[i]);
    for (int p = threadIdx.x; p < n; p += CTA_THREADS) {
        const int* r = a.rows + 4 * (band0 + p);
        hdr[p] = make_int4((r[0] - dz0) * a.plane_ld + r[1] * a.ld, r[2], r[3], 0);
    }
}

// Stages region planes [q0, q0 + n) of a step-0 region whose plane 0 is
// global plane gz0 (rows h0 x cols w0 from global (r0, c0), modulo H and
// W) into dst, each out-of-domain plane of a non-periodic z axis (within
// depth o) from the in-domain plane the z fill copies (axis_source), or
// zero: the z fill of step 0, whose region is the grid as loaded.
// Returns the cells this thread loaded.
template <typename T>
__device__ __forceinline__ int stage_planes(float* dst, const SlabArgs& a, const T* x, int gz0,
                                            int q0, int n, int r0, int c0, int h0, int w0,
                                            int o, bool zmap) {
    if (!zmap)
        return load_rect3d(dst, a.ld, (size_t)a.plane_ld, x, a.Z, a.H, a.W, gz0 + q0, r0, c0, n,
                           h0, w0);
    int cells = 0;
    for (int p = 0; p < n; ++p) {
        const int g = gz0 + q0 + p, src = axis_source(g, a.Z, o, a.mz);
        float* pl = dst + (size_t)p * a.plane_ld;
        if (src == AXIS_ZERO) {
            for (int i = threadIdx.x; i < h0 * w0; i += CTA_THREADS)
                pl[(i / w0) * a.ld + i % w0] = 0.f;
        } else {
            cells += load_rect3d(pl, a.ld, (size_t)a.plane_ld, x, a.Z, a.H, a.W,
                                 src == AXIS_DEEP ? g : src, r0, c0, 1, h0, w0);
        }
    }
    return cells;
}

// One step's passes over the output pairs [0, pairs) of a region (this
// CTA's share) whose planes hold ho output rows: slab_fold_kernel's chunk
// and pass loop.
template <typename TC, int KS>
__device__ __forceinline__ void slab_step(float* region, const TC* toe, const int4* hdr,
                                          const SlabArgs& a, int n_rows, int pairs, int ho,
                                          int win, int wo, bool round) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int band_k = BAND_N + 2 * a.R;
    const int ntiles = (pairs + MMA_TILE - 1) / MMA_TILE;
    for (int c0 = 0; c0 < wo; c0 += BAND_N) {
        const int kv = min(band_k, win - c0);
        const bool two = c0 + 8 < wo;
        for (int base = 0; base < ntiles; base += SLAB_PASS_TILES) {
            const int n = min(SLAB_PASS_TILES, ntiles - base);
            const int mine = warp < n ? (n - warp + CTA_WARPS - 1) / CTA_WARPS : 0;
            auto pass = [&](auto slots) {
                slab_pass<TC, KS, decltype(slots)::value>(
                    region, toe, hdr, n_rows, a.toe_ld, base + warp, mine, pairs, ho, a.plane_ld,
                    a.ld, c0, kv, wo, two, round, g, q);
            };
            switch ((n + CTA_WARPS - 1) / CTA_WARPS) {
            case 1: pass(std::integral_constant<int, 1>()); break;
            case 2: pass(std::integral_constant<int, 2>()); break;
            case 3: pass(std::integral_constant<int, 3>()); break;
            default: pass(std::integral_constant<int, SLAB_TILES_PER_WARP>());
            }
        }
    }
    __syncthreads();
}

// The composed contraction (t = 1) split by the kernel's planes dz
// (common.py::slab_cluster, kind "dz"): rank k stages the region planes
// [lo[k], lo[k + 1] - 1 + TZ) its bands read, and the bands of dz in
// [lo[k], lo[k + 1)) (rows[k] on), folds every output pair over them into
// its share in place, as the one-CTA kernel folds all bands; then the
// ranks' partial sums are added in rank order through distributed shared
// memory, each rank adding and storing a slice of the tile.  Its sums are
// thus the one-CTA kernel's taken in C parts, each output within the
// plain version's limit (kernel_limit) as the one-CTA kernel's.
template <typename TIn, typename TC, bool FILL, int KS>
__global__ void __launch_bounds__(CTA_THREADS, 1)
    slab_fold_dz_kernel(const SlabArgs a, const ClusterSplit sp) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int rank = cluster_rank();
    const int halo = a.R;
    const int d0 = sp.lo[rank], planes = a.TZ + sp.lo[rank + 1] - d0 - 1;
    const int band0 = sp.rows[rank], n_rows = sp.rows[rank + 1] - band0;
    const int h0 = a.TM + 2 * halo, w0 = a.TN + 2 * halo;
    float* const region = reinterpret_cast<float*>(smem);
    const size_t toe_off = align128((size_t)planes * a.plane_ld * sizeof(float));
    TC* const toe = reinterpret_cast<TC*>(smem + toe_off);
    int4* const hdr = reinterpret_cast<int4*>(
        smem + toe_off + align128((size_t)n_rows * a.toe_ld * sizeof(TC)));
    const Tile3 tl = tile3(blockIdx.x / sp.ctas, a.gx, a.gy);
    const int k0 = tl.bz * a.TZ, i0 = tl.by * a.TM, j0 = tl.bx * a.TN;
    const TIn* x = static_cast<const TIn*>(a.x);
    TIn* y = static_cast<TIn*>(a.y);
    if (blockIdx.z != 0) {
        x = grid_at(x, blockIdx.z, a.grid_elems);
        y = grid_at(y, blockIdx.z, a.grid_elems);
    }
    const int loaded = stage_planes(region, a, x, k0 - halo, d0, planes, i0 - halo, j0 - halo, h0,
                                    w0, halo, FILL && a.mz != MODE_PERIODIC);
    stage_bands(toe, hdr, a, band0, n_rows, d0);
    __syncthreads();
    if (FILL)  // y and x on this share's planes; z came with the staging
        fill_boundary(region, a.plane_ld, a.ld, planes, h0, w0, 0, i0 - halo, j0 - halo, a.Z,
                      a.H, a.W, halo, MODE_PERIODIC, a.my, a.mx);
    slab_round<TC>(region, a.plane_ld, a.ld, planes, h0, w0);
    slab_step<TC, KS>(region, toe, hdr, a, n_rows, a.TZ * a.TM, a.TM, w0, a.TN, false);
    cluster_sync();  // every rank's partial sums are in place

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int pr = rank * CTA_WARPS + warp; pr < a.TZ * a.TM; pr += sp.ctas * CTA_WARPS) {
        const int p = pr / a.TM, i = pr - p * a.TM;
        if (k0 + p >= a.Z || i0 + i >= a.H) continue;
        TIn* dst = y + ((size_t)(k0 + p) * a.H + (i0 + i)) * (size_t)a.W + j0;
        const float* s = region + p * a.plane_ld + (size_t)i * a.ld;
        for (int j = lane; j < a.TN && j0 + j < a.W; j += 32) {
            float v = *peer(s + j, 0);
            for (int k = 1; k < sp.ctas; ++k) v += *peer(s + j, k);
            dst[j] = from_f32<TIn>(v);
        }
    }
    cluster_sync();  // no rank leaves while a peer reads its sums
    count_cluster_loads(loaded);
}

// The reuse folds (t > 1 steps) split by the region's planes
// (common.py::slab_cluster, kind "planes"): rank k owns region planes
// [lo[k], lo[k + 1]) and holds the 2R after them too, with every band.
// Before each step the owners fill their planes (z from the in-domain
// plane the fill copies, read from its owner; y and x in place; step 0's z
// with the staging), then each rank copies the 2R planes after its own
// from their owners, and folds the step's output pairs on its own planes
// in place, reading only its share.  A cluster barrier stands where the
// one-CTA kernel's CTA barrier does between steps, and around the copies,
// so no rank overwrites a plane a peer has yet to copy.  Each pair's sums
// are the one-CTA kernel's, so every output is its bit for bit.
template <typename TIn, typename TC, bool FILL, int KS>
__global__ void __launch_bounds__(CTA_THREADS, 1)
    slab_fold_planes_kernel(const SlabArgs a, const ClusterSplit sp) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int rank = cluster_rank();
    const int halo = a.t * a.R;
    const int p0 = a.TZ + 2 * halo, h0 = a.TM + 2 * halo, w0 = a.TN + 2 * halo;
    const int own0 = sp.lo[rank], own1 = sp.lo[rank + 1];
    const int held = min(own1 + 2 * a.R, p0) - own0;
    float* const region = reinterpret_cast<float*>(smem);
    const size_t toe_off = align128((size_t)held * a.plane_ld * sizeof(float));
    TC* const toe = reinterpret_cast<TC*>(smem + toe_off);
    int4* const hdr = reinterpret_cast<int4*>(
        smem + toe_off + align128((size_t)a.n_rows * a.toe_ld * sizeof(TC)));
    const Tile3 tl = tile3(blockIdx.x / sp.ctas, a.gx, a.gy);
    const int k0 = tl.bz * a.TZ, i0 = tl.by * a.TM, j0 = tl.bx * a.TN;
    const TIn* x = static_cast<const TIn*>(a.x);
    TIn* y = static_cast<TIn*>(a.y);
    if (blockIdx.z != 0) {
        x = grid_at(x, blockIdx.z, a.grid_elems);
        y = grid_at(y, blockIdx.z, a.grid_elems);
    }
    // Region plane q in the share of its owner.
    auto plane_at = [&](int q) {
        const int o = split_owner(sp, q);
        return (o == rank ? region : peer(region, o)) + (size_t)(q - sp.lo[o]) * a.plane_ld;
    };
    const bool zmap = FILL && a.mz != MODE_PERIODIC;
    const int loaded = stage_planes(region, a, x, k0 - halo, own0, own1 - own0, i0 - halo,
                                    j0 - halo, h0, w0, halo, zmap);
    stage_bands(toe, hdr, a, 0, a.n_rows, 0);
    __syncthreads();
    const bool fill = FILL && (leaves_domain(a.mz, k0 - halo, p0, a.Z) ||
                               leaves_domain(a.my, i0 - halo, h0, a.H) ||
                               leaves_domain(a.mx, j0 - halo, w0, a.W));

    int pin = p0, hin = h0, win = w0;
    for (int s = 0; s < a.t; ++s) {
        const int po = pin - 2 * a.R, ho = hin - 2 * a.R, wo = win - 2 * a.R;
        const int depth = (a.t - s) * a.R, gz = k0 - depth;
        const int mine = max(0, min(own1, pin) - own0);  // own planes of the step's input
        if (s > 0) cluster_sync();  // the step before has stored every pair
        if (fill) {
            if (s > 0 && leaves_domain(a.mz, gz, pin, a.Z)) {
                // z: each own plane out of the domain (within the depth)
                // from the in-domain plane the fill copies, or zero
                for (int p = own0; p < own0 + mine; ++p) {
                    const int src = axis_source(gz + p, a.Z, depth, a.mz);
                    if (src == gz + p || src == AXIS_DEEP) continue;
                    float* dst = region + (size_t)(p - own0) * a.plane_ld;
                    const float* from = src == AXIS_ZERO ? nullptr : plane_at(src - gz);
                    for (int i = threadIdx.x; i < hin * win; i += CTA_THREADS) {
                        const int off = (i / win) * a.ld + i % win;
                        dst[off] = from ? from[off] : 0.f;
                    }
                }
                cluster_sync();  // before the owners fill y and x in place
            }
            if (mine > 0)
                fill_boundary(region, a.plane_ld, a.ld, mine, hin, win, 0, i0 - depth,
                              j0 - depth, a.Z, a.H, a.W, depth, MODE_PERIODIC, a.my, a.mx);
        }
        if (s == 0) slab_round<TC>(region, a.plane_ld, a.ld, mine, hin, win);
        cluster_sync();  // every plane of the step's input is final
        for (int p = own1; p < min(own1 + 2 * a.R, pin); ++p) {
            float* dst = region + (size_t)(p - own0) * a.plane_ld;
            const float* from = plane_at(p);
            for (int i = threadIdx.x; i < hin * win; i += CTA_THREADS) {
                const int off = (i / win) * a.ld + i % win;
                dst[off] = from[off];
            }
        }
        cluster_sync();  // the copies are in before any rank folds in place
        const bool round = std::is_same<TC, float>::value && s + 1 < a.t;
        slab_step<TC, KS>(region, toe, hdr, a, a.n_rows, max(0, min(own1, po) - own0) * ho, ho,
                          win, wo, round);
        pin = po;
        hin = ho;
        win = wo;
    }
    store_tile3d(y, a.Z, a.H, a.W, k0 + own0, i0, j0, max(0, min(own1, a.TZ) - own0), a.TM, a.TN,
                 region, a.plane_ld, a.ld);
    count_cluster_loads(loaded);
}

// The k-steps a cluster form unrolls: the composed split MAX_KS (a
// composed kernel's bands run deep), the reuse split FoldKs<TC>::SMALL
// (the bands of radius <= 4 in TF32, any in bf16); must match
// repro_torch/kernels/common.py::slab_cluster.
template <typename TC, bool DZ>
__host__ __device__ constexpr int slab_cluster_ks() {
    return DZ ? SpMma<TC>::MAX_KS : FoldKs<TC>::SMALL;
}

// The cluster instantiation a launch in these types takes (dz: the
// composed split; planes: the reuse split), its launch attributes set: one
// each, the fill compiled in and gated by the modes at run time (a
// periodic grid skips it), each k-step run only where a band has it.
template <typename TIn, typename TC, bool DZ>
static auto slab_cluster_kernel(cudaError_t& err) {
    constexpr int KS = slab_cluster_ks<TC, DZ>();
    void (*kernel)(const SlabArgs, const ClusterSplit);
    if constexpr (DZ) kernel = slab_fold_dz_kernel<TIn, TC, true, KS>;
    else kernel = slab_fold_planes_kernel<TIn, TC, true, KS>;
    static std::atomic<bool> attributes_set[MAX_DEVICES];
    err = prepare_launch(kernel, attributes_set);
    return kernel;
}

// Checks a cluster launch's split against the host's layout (every rank's
// share within smem_bytes) and launches it in its types: DZ, the composed
// split (t = 1); else the reuse split (t > 1).
template <bool DZ>
static int slab_cluster_launch_types(SlabArgs a, const ClusterSplit& sp, int B, int dtype,
                                     int compute, int smem_bytes, cudaStream_t stream) {
    const int halo = a.t * a.R, p0 = a.TZ + 2 * halo;
    const int tc_bytes = compute == 0 ? 4 : 2;
    if (a.n_rows < 1 || a.t < 1 || a.R < 1 || a.TZ < 1 || a.TM < 1 || a.TN < 1 ||
        a.grid_elems != (size_t)a.Z * a.H * a.W || a.ld < a.TN + 2 * halo || a.ld % 2 != 0 ||
        a.plane_ld < (a.TM + 2 * halo) * a.ld || a.plane_ld % 2 != 0 || a.toe_ld % 8 != 0 ||
        (DZ ? a.t != 1 || !split_ok(sp, 2 * a.R + 1) || sp.rows[0] != 0 ||
                  sp.rows[sp.ctas] != a.n_rows
            : a.t < 2 || !split_ok(sp, p0)))
        return (int)cudaErrorInvalidValue;
    for (int k = 0; k < sp.ctas; ++k) {
        const int planes = DZ ? a.TZ + sp.lo[k + 1] - sp.lo[k] - 1
                              : min(sp.lo[k + 1] + 2 * a.R, p0) - sp.lo[k];
        const int bands = DZ ? sp.rows[k + 1] - sp.rows[k] : a.n_rows;
        if (bands < 0 || align128((size_t)planes * a.plane_ld * 4) +
                                 align128((size_t)bands * a.toe_ld * tc_bytes) +
                                 (size_t)bands * sizeof(int4) > (size_t)smem_bytes)
            return (int)cudaErrorInvalidValue;
    }
    a.gx = (a.W + a.TN - 1) / a.TN;
    a.gy = (a.H + a.TM - 1) / a.TM;
    return slab_types(dtype, compute, [&](auto* in, auto* tc) {
        using TIn = std::remove_pointer_t<decltype(in)>;
        using TC = std::remove_pointer_t<decltype(tc)>;
        const int ks = slab_max_ks<TC>(a);
        if (ks < 1 || ks > slab_cluster_ks<TC, DZ>()) return (int)cudaErrorInvalidValue;
        cudaError_t err;
        auto* kernel = slab_cluster_kernel<TIn, TC, DZ>(err);
        if (err != cudaSuccess) return (int)err;
        const long long ctas = grid3_ctas(a.Z, a.H, a.W, a.TZ, a.TM, a.TN);
        if (ctas < 1 || ctas * sp.ctas > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
        return for_each_chunk(B, [&](int b0, int nb) {
            SlabArgs c = a;
            c.x = grid_at(static_cast<const TIn*>(a.x), b0, a.grid_elems);
            c.y = grid_at(static_cast<TIn*>(a.y), b0, a.grid_elems);
            return launch_cluster(kernel, dim3((unsigned)(ctas * sp.ctas), 1, nb), sp.ctas,
                                  smem_bytes, stream, c, sp);
        });
    });
}
