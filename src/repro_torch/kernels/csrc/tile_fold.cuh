// The tile fold, the 2D banded kernels for Hopper (sm_90a): t steps of a
// 2D stencil with per-axis boundaries (periodic, zero, reflect,
// replicate), one (TM x TN) output tile per CTA, every product an mma.sync
// (TF32 m16n8k4 pairs for f32 operands, bf16 m16n8k16 for bf16 operands,
// sparse_mma.cuh) with f32 accumulators.  One body serves the dense banded
// operand (stencil_banded.cu, K3/K6 banded, and its K8 / K10 foil builds)
// and the compacted one (stencil_sparse.cu, K7 on 2D grids): band p of a
// step is the kernel row dy_p, its kept rows start at row lo_p and run
// nk_p k-steps (dense: lo = 0, nk = kpad / K for every band).  1D grids
// run it on the lifted (1, N) view only for comparison with the folded 1D
// kernels (line_fold.cuh), which equal it bit for bit.
//
// Replaces repro/kernels/stencil_matmul.py::stencil_matmul / _banded_step
// / _banded_steps and repro/kernels/stencil_sparse.py::
// stencil_sparse_matmul / _sparse_banded_step / _sparse_banded_steps on 2D
// grids, with the halo staging that repro/kernels/common.py::_launch
// (kinds subblocked / flat / coltiled) does for them on the TPU.  An
// output tile of a step is 16 rows of one 16-column chunk: sum_p A_p @
// B_p, A_p the 16 rows' input rows shifted by dy_p from column c + lo_p
// on, B_p the band.
//
// It is the 2D form of the slab fold (slab_fold.cuh), and shares its
// pieces: the Toeplitz band staging and headers (stage_band, SlabB), the A
// loader (slab_a), the rounding (slab_round, slab_operand), the launch
// arguments (SlabArgs, with Z = TZ = 1 and the z axis periodic) and the
// type dispatch.  What bounds it on an H100: bytes for the stencils of
// this repository (the region's read amplification is 1.27 at h = 4 on
// the 64 x 64 tile), if the CTA's steps in shared memory keep pace.  So
// each tile's (TM+2h) x (TN+2h) region is read from global memory once
// (load_region, common.cuh: h = t*R, modulo indices), all t steps run in
// shared memory in f32, both axes shrink by R per step, and the tile is
// written once, masked at the ragged edge.  The steps:
//   * no operand copy: each lane loads its A fragment elements straight
//     from the f32 region at the band's row shift and column, zeroing
//     every chunk column >= kv (past BAND_N + 2R or the row's valid
//     extent) so NaN * 0 never reaches a valid output, in the k-steps that
//     reach kv only.  TF32 operands are rounded once per cell (the step-0
//     region in place, every later step's input as the step before stores
//     it), bf16 ones at the load;
//   * the band once per CTA: each band's Toeplitz row and its header (row
//     shift dy*ld, lo, nk) staged in shared memory, TF32 B rounded there;
//   * passes across chunks: a step's tiles are ordered chunk-major, then
//     by 16-row tile, and grouped into passes of at most SLAB_PASS_TILES,
//     warp w taking tiles w, w + 8, ... (TPW = ceil(tiles / 8) slots per
//     warp, an instantiation of the pass per TPW).  A pass holds its sums
//     in registers, passes one CTA barrier, then stores them in place at
//     the tiles' own cells, columns [16c, 16c + 16) masked at the step's
//     width.  No later pass reads those cells: a later chunk reads from
//     its own first column on, and a later row tile of the same chunk
//     reads only rows at or after its own (dy >= 0).  On the main tile
//     (64 x 64, h = 4) steps 0-2 run 25 tiles, step 3 16, each step one
//     pass on all 8 warps;
//   * the region holds the step-0 region and no more (the last row tile
//     is clamped to the step's last row and masked at the store), its row
//     stride 4 mod 8 words (host: common.py::tile_fold_layout), so the 8
//     rows of an A fragment hit 8 bank quads;
//   * TILE_MIN_BLOCKS CTAs per SM (__launch_bounds__): the main tile's
//     region and band take 22,448 bytes, so registers set the limit.
//     Chosen by measurement on the H100 (8192^2, t = 4): 3 CTAs at 80
//     registers ran the reuse kernel in 1.32-1.34 ms, 2 at 99-101 in
//     1.52-1.57, 4 at 64 in 1.37-1.66; the t = 1 launches (matmul,
//     fused_matmul) ran faster at 4.
// The accumulation runs band p outer, k-steps inner, HMMA.1684 pairs for
// TF32, on the operand values of the wmma kernel before this fold, so the
// outputs equal it bit for bit.
//
// Each step first rebuilds the non-periodic axes' halo in the region
// (fill_boundary, common.cuh; compiled only into the FILL instantiation)
// and waits for it.  The same body built with STAGE_STRIP (K8
// whole-strip) or STAGE_NINE (K10, the seed's 9-tile kernel) is a traffic
// foil (stencil_banded.cu with -DREPRO_FOIL); its sink slots lie in the
// band's slots, which it stages only after a barrier.  A launch advances a
// batch of B grids, grid b on blockIdx.z (K11, common.cuh, grid_at /
// for_each_chunk).
#pragma once

#include "slab_fold.cuh"

#define TILE_MIN_BLOCKS 3

// Byte offsets of the band's Toeplitz rows and of its headers after the
// region of TM + 2h rows, and the bytes of all three.
__host__ __device__ __forceinline__ size_t tile_toe_offset(const SlabArgs& a) {
    return align128((size_t)(a.TM + 2 * a.t * a.R) * a.ld * sizeof(float));
}
__host__ __device__ __forceinline__ size_t tile_hdr_offset(const SlabArgs& a, int tc_bytes) {
    return tile_toe_offset(a) + align128((size_t)a.n_rows * a.toe_ld * tc_bytes);
}
static inline size_t tile_smem_bytes(const SlabArgs& a, int tc_bytes) {
    return tile_hdr_offset(a, tc_bytes) + (size_t)a.n_rows * sizeof(int4);
}

// One pass of a step: this warp's `mine` (TPW or TPW - 1) tiles tile0,
// tile0 + CTA_WARPS, ... of the step's chunk-major list (tile i is row
// tile i % nrt of chunk i / nrt), their sums over every band (each of at
// most KS k-steps, unrolled; KS = FoldKs<TC>::DEEP: any number, in
// unrolled pieces of MAX_KS), then (after the barrier every warp passes)
// their store at the tiles' own cells, columns below wo, TF32-rounded
// where `round`.  Each slot keeps its chunk's kv; the slots but the last
// load unmasked in a k-step whose columns all lie below every one of their
// kv, the last slot's loads are masked, to nothing where the warp has no
// such tile (its zero products are not stored).  A slot runs its chunk's
// second n8 half only where that half holds outputs.  Each slot's A
// fragment is loaded just before its products, so one fragment is live at
// a time: at the 80-register cap of TILE_MIN_BLOCKS = 3 the main
// instantiation spills 32 bytes where loading every slot's first spilled
// 152 (ptxas, sm_90a).
template <typename TC, int KS, int TPW>
__device__ __forceinline__ void tile_pass(float* region, const TC* toe, const int4* hdr,
                                          int n_rows, int toe_ld, int tile0, int mine, int nrt,
                                          int ho, int ld, int band_k, int win, int wo, bool round,
                                          int g, int q) {
    using S = SpMma<TC>;
    constexpr bool kDeep = KS > S::MAX_KS;
    constexpr int kPiece = kDeep ? S::MAX_KS : KS;  // k-steps unrolled at a time
    float acc[TPW][2][4];
    int off[TPW][2];  // rows g and g + 8 of each slot, at its chunk's column 0
    int kv[TPW];      // each slot's chunk columns that load
    unsigned two = 0;  // the slots whose chunk's second n8 half holds outputs
#pragma unroll
    for (int u = 0; u < TPW; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][h][e] = 0.f;
        const int tile = tile0 + min(u, max(mine - 1, 0)) * CTA_WARPS;
        const int c = tile / nrt;
        const int m = (tile - c * nrt) * MMA_TILE + g, c0 = c * BAND_N;
        off[u][0] = min(m, ho - 1) * ld + c0;
        off[u][1] = min(m + 8, ho - 1) * ld + c0;
        kv[u] = min(band_k, win - c0);
        if (c0 + 8 < wo) two |= 1u << u;
    }
    if (mine != TPW) kv[TPW - 1] = 0;
    int kv_full = band_k;  // the slots but the last load unmasked below it
#pragma unroll
    for (int u = 0; u < TPW - 1; ++u) kv_full = min(kv_full, kv[u]);
    // This lane's first A column: q in TF32, 2q in bf16.
    const int lq = std::is_same<TC, float>::value ? q : 2 * q;
    const TC* bt = toe + (BAND_N - 1) - g;
    for (int p = 0; p < n_rows; ++p, bt += toe_ld) {
        const int4 hd = hdr[p];  // row shift, lo, nk
        const float* r[TPW][2];  // the slots' rows at this lane's first column
#pragma unroll
        for (int u = 0; u < TPW; ++u) {
            r[u][0] = region + hd.x + hd.y + lq + off[u][0];
            r[u][1] = region + hd.x + hd.y + lq + off[u][1];
        }
        for (int k0 = 0; k0 < (kDeep ? hd.z : 1); k0 += kPiece)
#pragma unroll
            for (int j = 0; j < kPiece; ++j) {
                const int ks = k0 + j;
                if (ks >= hd.z) continue;
                const int k = ks * S::K;  // the k-step's first column past lo
                uint32_t b[2][2];
                SlabB<TC>::load(b[0], bt + k, q);
                SlabB<TC>::load(b[1], bt + k - 8, q);
                const bool full = hd.y + k + S::K <= kv_full;
#pragma unroll
                for (int u = 0; u < TPW; ++u) {
                    uint32_t af[4];
                    if (u < TPW - 1 && full)
                        slab_a<TC, false>(af, r[u][0], r[u][1], k, 0);
                    else
                        slab_a<TC, true>(af, r[u][0], r[u][1], k, kv[u] - hd.y - lq);
                    S::mma(acc[u][0], af, b[0]);
                    if (two >> u & 1u) S::mma(acc[u][1], af, b[1]);
                }
            }
    }
    __syncthreads();  // every tile of the pass has read its operands
#pragma unroll
    for (int u = 0; u < TPW; ++u)
        if (u < mine) {
            const int tile = tile0 + u * CTA_WARPS;
            const int c = tile / nrt;
            const int m = (tile - c * nrt) * MMA_TILE + g;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = 8 * h + 2 * q;
                if (c * BAND_N + col >= wo) continue;  // wo is even: both columns or neither
                if (m < ho)
                    *reinterpret_cast<float2*>(region + off[u][0] + col) =
                        make_float2(slab_operand(acc[u][h][0], round),
                                    slab_operand(acc[u][h][1], round));
                if (m + 8 < ho)
                    *reinterpret_cast<float2*>(region + off[u][1] + col) =
                        make_float2(slab_operand(acc[u][h][2], round),
                                    slab_operand(acc[u][h][3], round));
            }
        }
}

// The staging is the last template argument, as in every kernel of the
// port (repro_torch/kernels/sass.py matches instantiations by it).
template <typename TIn, typename TC, bool FILL, int KS, int STAGE>
__global__ void __launch_bounds__(CTA_THREADS, TILE_MIN_BLOCKS)
    tile_fold_kernel(const SlabArgs a) {
#ifdef REPRO_WORKSPACE
    // this CTA's slice (slab_fold.cuh's workspace form): the region, then
    // the band headers; the Toeplitz rows stay in device memory
    unsigned char* const smem = a.ws + (size_t)blockIdx.x * a.ws_bytes;
    const int halo = a.t * a.R;
    const int h0 = a.TM + 2 * halo, w0 = a.TN + 2 * halo;
    float* const region = reinterpret_cast<float*>(smem);
    TC* const toe = const_cast<TC*>(static_cast<const TC*>(a.toe));  // read only
    int4* const hdr = reinterpret_cast<int4*>(smem + tile_toe_offset(a));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const long long tiles = (long long)a.gx * a.gy;
    for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int tile = (int)(item % tiles);
    const int i0 = (tile / a.gx) * a.TM, j0 = (tile % a.gx) * a.TN;
    const TIn* x = grid_at(static_cast<const TIn*>(a.x), (unsigned long long)(item / tiles),
                           a.grid_elems);
    TIn* y = grid_at(static_cast<TIn*>(a.y), (unsigned long long)(item / tiles), a.grid_elems);
#else
    extern __shared__ __align__(128) unsigned char smem[];
    const int halo = a.t * a.R;
    const int h0 = a.TM + 2 * halo, w0 = a.TN + 2 * halo;
    float* const region = reinterpret_cast<float*>(smem);
    TC* const toe = reinterpret_cast<TC*>(smem + tile_toe_offset(a));
    int4* const hdr = reinterpret_cast<int4*>(smem + tile_hdr_offset(a, sizeof(TC)));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int i0 = blockIdx.y * a.TM, j0 = blockIdx.x * a.TN;
    const TIn* x = static_cast<const TIn*>(a.x);
    TIn* y = static_cast<TIn*>(a.y);
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, a.grid_elems);
        y = grid_at(y, blockIdx.z, a.grid_elems);
    }
#endif

    load_region<STAGE>(region, a.ld,
                       sink_slot<STAGE>(reinterpret_cast<float*>(toe),
                                        a.n_rows * a.toe_ld * (int)sizeof(TC) / 4),
                       x, a.H, a.W, i0 - halo, j0 - halo, h0, w0, a.TM, a.TN);
    if constexpr (STAGE != STAGE_REGION) __syncthreads();  // the sink slots are the band's
    stage_band(toe, hdr, a);
    __syncthreads();
    const bool fill = FILL && (leaves_domain(a.my, i0 - halo, h0, a.H) ||
                               leaves_domain(a.mx, j0 - halo, w0, a.W));

    const int band_k = BAND_N + 2 * a.R;  // rows of one dense band
    int hin = h0, win = w0;
    for (int s = 0; s < a.t; ++s) {
        const int ho = hin - 2 * a.R, wo = win - 2 * a.R;
        const int nrt = (ho + MMA_TILE - 1) / MMA_TILE;
        const int ntiles = nrt * ((wo + BAND_N - 1) / BAND_N);
        if (fill) {
            const int depth = (a.t - s) * a.R;
            fill_boundary(region, 0, a.ld, 1, hin, win, 0, i0 - depth, j0 - depth, 1, a.H, a.W,
                          depth, MODE_PERIODIC, a.my, a.mx);
        }
        if (s == 0) slab_round<TC>(region, 0, a.ld, 1, hin, win);
        const bool round = std::is_same<TC, float>::value && s + 1 < a.t;
        for (int base = 0; base < ntiles; base += SLAB_PASS_TILES) {
            // The pass's n tiles: warp w takes w, w + 8, ..., TPW or
            // TPW - 1 of them, TPW = ceil(n / 8).
            const int n = min(SLAB_PASS_TILES, ntiles - base);
            const int mine = warp < n ? (n - warp + CTA_WARPS - 1) / CTA_WARPS : 0;
            auto pass = [&](auto slots) {
                tile_pass<TC, KS, decltype(slots)::value>(region, toe, hdr, a.n_rows, a.toe_ld,
                                                          base + warp, mine, nrt, ho, a.ld,
                                                          band_k, win, wo, round, g, q);
            };
            switch ((n + CTA_WARPS - 1) / CTA_WARPS) {
            case 1: pass(std::integral_constant<int, 1>()); break;
            case 2: pass(std::integral_constant<int, 2>()); break;
            case 3: pass(std::integral_constant<int, 3>()); break;
            default: pass(std::integral_constant<int, SLAB_TILES_PER_WARP>());
            }
        }
        __syncthreads();  // the step's sums are in place
        hin = ho;
        win = wo;
    }

    store_tile(y, a.H, a.W, i0, j0, a.TM, a.TN, region, a.ld);
#ifdef REPRO_WORKSPACE
    __syncthreads();  // every thread is done with the slice before the next item
    }
#endif
}

// The instantiation a launch in these types, fill, staging and band depth
// (small: no band runs past FoldKs<TC>::SMALL k-steps) takes, its launch
// attributes set on the current device (err: the outcome).  The 9-tile
// foil stages periodic grids only, so it has no FILL instantiation.
template <typename TIn, typename TC, int STAGE>
static auto tile_kernel(bool fill, bool small, cudaError_t& err) {
    constexpr int KS = FoldKs<TC>::SMALL, KL = SpMma<TC>::MAX_KS;
    constexpr bool kFill = STAGE != STAGE_NINE;
    auto* kernel = fill ? (small ? tile_fold_kernel<TIn, TC, kFill, KS, STAGE>
                                 : tile_fold_kernel<TIn, TC, kFill, KL, STAGE>)
                        : (small ? tile_fold_kernel<TIn, TC, false, KS, STAGE>
                                 : tile_fold_kernel<TIn, TC, false, KL, STAGE>);
    static std::atomic<bool> attributes_set[4][MAX_DEVICES];
    err = prepare_launch(kernel, attributes_set[2 * fill + small]);
    return kernel;
}

// The instantiation of a launch whose deepest band runs past MAX_KS
// k-steps (FoldKs<TC>::DEEP), its launch attributes set.
template <typename TIn, typename TC, int STAGE>
static auto tile_kernel_deep(bool fill, cudaError_t& err) {
    constexpr int KD = FoldKs<TC>::DEEP;
    auto* kernel = fill ? tile_fold_kernel<TIn, TC, true, KD, STAGE>
                        : tile_fold_kernel<TIn, TC, false, KD, STAGE>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    err = prepare_launch(kernel, attributes_set[fill]);
    return kernel;
}

// DEEP: the launch may take bands past MAX_KS k-steps (the dense bands of
// the main and the foil builds); the compacted bands stay within MAX_KS.
template <typename TIn, typename TC, int STAGE, bool DEEP>
static int tile_launch(const SlabArgs& a, int B, int smem_bytes, cudaStream_t stream) {
    const bool fill = a.my != MODE_PERIODIC || a.mx != MODE_PERIODIC;
    if (STAGE == STAGE_NINE && fill) return (int)cudaErrorInvalidValue;  // periodic only
    const int ks = slab_max_ks<TC>(a);
    if (ks < 1 || (!DEEP && ks > SpMma<TC>::MAX_KS)) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    void (*kernel)(const SlabArgs);
    if constexpr (DEEP) {
        kernel = ks > SpMma<TC>::MAX_KS
                     ? tile_kernel_deep<TIn, TC, STAGE>(fill, err)
                     : tile_kernel<TIn, TC, STAGE>(fill, ks <= FoldKs<TC>::SMALL, err);
    } else {
        kernel = tile_kernel<TIn, TC, STAGE>(fill, ks <= FoldKs<TC>::SMALL, err);
    }
    if (err != cudaSuccess) return (int)err;
    return for_each_chunk(B, [&](int b0, int nb) {
        SlabArgs c = a;
        c.x = grid_at(static_cast<const TIn*>(a.x), b0, a.grid_elems);
        c.y = grid_at(static_cast<TIn*>(a.y), b0, a.grid_elems);
        dim3 grid((a.W + a.TN - 1) / a.TN, (a.H + a.TM - 1) / a.TM, nb);
        kernel<<<grid, CTA_THREADS, smem_bytes, stream>>>(c);
        return (int)cudaGetLastError();
    });
}

// A 2D launch's arguments: the grid (H x W, B grids of grid_elems = H * W
// cells), the tile, the steps, the layout of repro_torch/kernels/common.py::
// tile_fold_layout (ld, toe_ld, smem_bytes) and the bands (toe: n_rows
// Toeplitz rows, rows: n_rows x (dz = 0, dy, lo, nk) int32).
static inline SlabArgs tile_args(const void* x, void* y, const void* toe, const void* rows, int H,
                                 int W, int TM, int TN, int t, int R, int ld, int toe_ld,
                                 int n_rows, int mode_y, int mode_x, long long grid_elems) {
    SlabArgs a{};
    a.x = x;
    a.y = y;
    a.toe = toe;
    a.rows = static_cast<const int*>(rows);
    a.grid_elems = (size_t)grid_elems;
    a.Z = 1, a.H = H, a.W = W, a.TZ = 1, a.TM = TM, a.TN = TN, a.t = t, a.R = R;
    a.ld = ld, a.plane_ld = 0, a.toe_ld = toe_ld, a.n_rows = n_rows;
    a.mz = MODE_PERIODIC, a.my = mode_y, a.mx = mode_x;
    return a;
}

// Checks a launch's arguments against the host's layout and launches it in
// its types and staging (DEEP: as tile_launch).
template <int STAGE, bool DEEP = false>
static int tile_launch_types(const SlabArgs& a, int B, int dtype, int compute, int smem_bytes,
                             cudaStream_t stream) {
    const int halo = a.t * a.R;
    const int tc_bytes = compute == 0 ? 4 : 2;
    if (a.n_rows < 1 || a.t < 1 || a.R < 1 || a.TM < 1 || a.TN < 1 ||
        a.grid_elems != (size_t)a.H * a.W || a.ld < a.TN + 2 * halo || a.ld % 2 != 0 ||
        a.toe_ld % 8 != 0 || smem_bytes < (long long)tile_smem_bytes(a, tc_bytes))
        return (int)cudaErrorInvalidValue;
    return slab_types(dtype, compute, [&](auto* in, auto* tc) {
        using TIn = std::remove_pointer_t<decltype(in)>;
        using TC = std::remove_pointer_t<decltype(tc)>;
        return tile_launch<TIn, TC, STAGE, DEEP>(a, B, smem_bytes, stream);
    });
}

#ifdef REPRO_WORKSPACE
// A 2D workspace launch's arguments checked against the host's layout
// (its slice holds the region and the headers: common.py::
// fold_slice_bytes), launched in its types on ctas persistent CTAs, the
// tile fold with FoldKs<TC>::DEEP (any band depth, in pieces of MAX_KS).
static inline int tile_workspace_types(SlabArgs a, int B, int dtype, int compute, void* ws,
                                       long long slice_bytes, int ctas, cudaStream_t stream) {
    const int halo = a.t * a.R;
    if (a.n_rows < 1 || a.t < 1 || a.R < 1 || a.TM < 1 || a.TN < 1 ||
        a.grid_elems != (size_t)a.H * a.W || a.ld < a.TN + 2 * halo || a.ld % 2 != 0 ||
        a.toe_ld % 8 != 0 || ws == nullptr || slice_bytes % 128 != 0 ||
        slice_bytes < (long long)(tile_toe_offset(a) + (size_t)a.n_rows * sizeof(int4)))
        return (int)cudaErrorInvalidValue;
    a.gx = (a.W + a.TN - 1) / a.TN;
    a.gy = (a.H + a.TM - 1) / a.TM;
    a.ws = static_cast<unsigned char*>(ws);
    a.ws_bytes = (size_t)slice_bytes;
    const long long tiles = (long long)a.gx * a.gy;
    return slab_types(dtype, compute, [&](auto* in, auto* tc) {
        using TIn = std::remove_pointer_t<decltype(in)>;
        using TC = std::remove_pointer_t<decltype(tc)>;
        static std::atomic<bool> attributes_set[MAX_DEVICES];
        return workspace_launch(
            tile_fold_kernel<TIn, TC, true, FoldKs<TC>::DEEP, STAGE_REGION>, attributes_set, a,
            B, tiles, ctas, stream);
    });
}
#endif

// CTAs of the instantiation (types, fill, STAGE, small band) that fit on
// one SM at once with smem_bytes of dynamic shared memory, as the runtime
// counts them (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus
// the cudaError_t of a failed query.
template <int STAGE>
static int tile_ctas_per_sm(int dtype, int compute, int fill, int smem_bytes) {
    return slab_types(dtype, compute, [&](auto* in, auto* tc) {
        using TIn = std::remove_pointer_t<decltype(in)>;
        using TC = std::remove_pointer_t<decltype(tc)>;
        cudaError_t err;
        auto* kernel = tile_kernel<TIn, TC, STAGE>(fill != 0, true, err);
        int n = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CTA_THREADS,
                                                                smem_bytes);
        return err == cudaSuccess ? n : -(int)err;
    });
}
