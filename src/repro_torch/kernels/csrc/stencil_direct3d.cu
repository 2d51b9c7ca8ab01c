// Tap-sum stencil kernel for Hopper (sm_90a): t fused steps of a 3D
// stencil with per-axis boundaries (periodic, zero, reflect, replicate),
// one (TZ x TM x TN) output tile per CTA.
//
// Replaces repro/kernels/stencil_direct.py::stencil_direct / _stencil_steps
// on 3D grids, together with the slab substrate that
// repro/kernels/common.py::slab_substrate_call (kinds slab_subblocked /
// slab_coltiled, geometry slab_launch_geometry) builds for it on the TPU.
//
// What bounds it on an H100: bytes and operations about equally.  A step
// costs 2K flops per point (K <= 343 taps, 27 for Box-3D1R) against 8
// bytes moved for an f32 grid; at t = 4 Box-3D1R needs 0.43 ms of FMAs at
// 67 TFLOP/s for 0.32 ms of bytes at 3.35 TB/s on 512^3.  Each CTA reads
// its tile's (TZ+2h)(TM+2h)(TN+2h) region once (h = t*r), runs all t
// steps on chip and writes the tile once, masked at every ragged edge;
// the region's read amplification, (1+2h/TZ)(1+2h/TM)(1+2h/TN), 2.81x
// for the 16x16x32 tile at h = 4, is what the plan prices.  What the
// design does about the rest:
//   * the region streams through shared memory plane by plane instead of
//     being held whole.  Every fused step s has a ring of planes of the
//     step's input: step 0's ring holds 2r+1 planes, the slot being staged
//     and the slot staged ahead (RING0); each later step's holds 2r+1 and
//     the slot the step before writes (RING).  The last step stores its
//     plane straight to global memory and has no ring.  At the main tile
//     (r = 1, t = 4; planes of 24 x 40 floats) the rings take 65,568
//     bytes where the two whole region buffers took 185,696, so three CTAs
//     share an SM where one did.
//   * the steps run as a wavefront, one plane each per barrier interval:
//     in interval k the staging lands plane k of the region (cp.async,
//     issued DIRECT3D_AHEAD intervals before, stage_region of
//     tap_stage.cuh on that plane), step 0 computes its output plane
//     k - r, and step s the plane r + 1 behind step s - 1's, whose input
//     planes step s - 1 finished in an earlier interval.
//   * within a plane every cell stays in place, as in the 2D kernel: region
//     cell (i, j) is cell (i, lead + j) of every slot, lead = (-h) mod 4,
//     so the tile's first column sits on a 16-byte granule.  A thread
//     computes a patch of V rows x 4 columns of one step's output plane,
//     streaming the V + 2r rows of each of the 2r + 1 input planes
//     (direct_row) into V x 4 f32 sums.  Cells a patch computes outside
//     the step's output window feed no output the last step stores.
//   * the taps come in as a by-value argument (1,372 bytes at r <= 3),
//     read by the FMAs from the parameter bank.  Radii 4..7 take their
//     (2r+1)^3 taps in an argument of their own size: 13,500 bytes at r =
//     7, past the 4 KB that kernel parameters held before CUDA 12.1, so
//     this source needs a CUDA 12.1 toolkit and driver (32,764 bytes of
//     parameters).  Their patch (direct3d_patch_wide) loops over dz and dy
//     with dx unrolled, each output row reading its input row at (dz, dy),
//     so its code stays small; the sums keep the (dz, dy, dx) order.
//   * __launch_bounds__ bounds the registers so that DIRECT3D_MIN_BLOCKS
//     CTAs share an SM at r = 1 (shared memory allows 3 at the main tile,
//     4 at h = 1), DIRECT3D_MIN_BLOCKS_WIDE at r >= 2.
// Every output starts at 0.f and takes fmaf in ascending (dz, dy, dx)
// order, zero taps skipped, in f32, and rounds to the grid's type once, on
// store: the order of the kernel before the plane stream, so every output
// is that kernel's bit for bit.
//
// Boundaries (K6, the port of repro/kernels/common.py::apply_boundary_fills,
// compiled only into the FILL instantiation, which launches with a
// non-periodic axis, so a periodic launch runs the periodic code).  The
// JAX kernel fills z, then y, then x before each step (np.pad's
// sequential corners); here each axis is a map from a cell to the
// in-domain cell it copies (common.cuh::fill_axis's rule: the cells below
// the domain and those above it within the step's depth o = (t-s)r), and
// the three maps compose:
//   * y and x: every plane entering a step's ring (staged, or finished by
//     the step before) is filled on the step's window in one pass, each
//     cell out of the domain in y or x from the in-domain cell its two
//     maps give, or 0 under `zero` (fill_plane).  No cell is both read and
//     written.
//   * z: a step reading an input plane out of the z domain reads the plane
//     the map gives, under `zero` none (its taps add +0 to a sum that is
//     never -0, so skipping them changes no bit).  Steps before the last
//     compute only the planes inside the z domain, whose inputs lie within
//     r of them: the mirror of plane -k <= -1 is k <= r, of plane Z-1+k is
//     Z-1-k, both in the ring when the output that reads them is due.
//   * periodic z needs nothing: step 0 stages the wrapped planes.
// A tile may be shallower than its halo (8 deep at h = 8), so every map
// goes by global index.
//
// The same source built with -DREPRO_FOIL is the library of the
// whole-slab traffic foil (K8, replacing repro/kernels/common.py::_launch
// kind wholeslab via _assemble_foil): this kernel with the STAGE_STRIP
// staging, the 3 x 3 whole (z, y) neighbour tiles with the x-halo, 9 TZ TM
// (TN+2h) cells a CTA (common.py::staged_read_bytes).  Each region plane
// is staged from the three whole y tiles of that plane, the region's rows
// into the ring and the others into a sink; the foil's planes outside the
// region go to the sink before the stream starts.
//
// A launch advances a batch of B grids, grid b on blockIdx.z (K11,
// replacing repro/kernels/common.py::fold_batch mode vmap; common.cuh,
// grid_at / for_each_chunk); B = 1 is the unbatched call.
//
// Past one CTA (the rings of Box/Star-3D2R at t = 6..8, h = 12..16, need
// 237,408 to 452,384 bytes on the least tile, where the JAX slab
// substrate stages them in 8 MB of VMEM): the cluster form,
// stencil_direct3d_cluster_kernel, spreads the rings over a thread-block
// cluster of 2, 4 or 8 CTAs (cluster.cuh), each running a contiguous range
// of the fused steps on its own rings and storing its last step's output
// planes into the next CTA's first ring through distributed shared memory
// (radii 1 and 2, the JAX package's 3D stencils; built from this source
// with -DREPRO_CLUSTER into a library of its own, stencil_direct3d_cluster,
// so the main build does not grow).  What bounds it is what bounds the
// one-CTA kernel, the FMAs and the shared reads, now on C SMs a tile, one
// CTA each; the only new traffic is one plane per step boundary between
// CTAs, in the interval it is due.
//
// Past any cluster (radii 3..7, whose cluster form is not built, and the
// rings of whose steps pass a CTA, up to 17 MB on the 16 x 64 x 64 tile at
// r = 7, t = 8, where the JAX substrate stages them in VMEM): the
// workspace form, this kernel built with -DREPRO_WORKSPACE into a library
// of its own, stencil_direct3d_workspace (common.cuh): the rings in a
// device workspace, persistent CTAs walking the tiles, every output the
// one-CTA kernel's bit for bit.  It is bound by its rings' traffic through
// L1 and L2, which now hold what shared memory held.
#include "cluster.cuh"
#include "tap_stage.cuh"

// The radii the kernel takes, and the taps the host passes: the dense
// (2r+1)^3 of any of them, row-major, the rest zero (kernel_taps).
#define MAX_RADIUS3D 7
#define MAX_TAPS3D 3375  // (2*7+1)^3
// V, the rows of a thread's patch, the CTAs per SM __launch_bounds__ asks
// registers for (radius 1; radii 2 and 3), and the planes step 0's staging
// runs ahead of the plane it lands, each in a cp.async group of its own
// (must match repro_torch/kernels/common.py::DIRECT3D_AHEAD): chosen by
// timing V in {2, 4, 5, 8} x N in {2, 3, 4} at A = 4 and A in {2, 3, 4,
// 6} at V = 4, N = 3 on the H100 (512^3 Box-3D1R, fold_probe.py
// tapsum3d-sweep).  Every point with 3 CTAs per SM ran t = 4 in 3.47-3.83
// ms, and the time follows neither the FMAs (Star-3D1R, 7 taps, runs
// within 5% of Box's 27) nor the shared reads (a variant that kept the
// 2r+1 output planes' sums of a patch in registers, reading each row once
// instead of 2r+1 times, ran within 3%).  V = 4 at N = 4 (64 registers,
// no stack frame at r = 1) ran t = 4 in 3.54 ms and the four t = 1
// launches in 2.76 (N = 3: 3.60 and 3.15), since at h = 1 the rings take
// 27 KB and registers set the CTAs per SM.  At r = 2, N = 4 leaves 16
// bytes of stack frame and N = 3 8 in the fill-free instantiations, so r
// >= 2 asks for 2.  A = 2 ran within 1% of A = 4, and 6 lost a CTA per SM
// (4.35 ms).
#define DIRECT3D_ROWS 4
#define DIRECT3D_MIN_BLOCKS 4
#define DIRECT3D_MIN_BLOCKS_WIDE 2
#define DIRECT3D_AHEAD 2
// Floats before every slot and after the last: a patch's reads run up to
// 3 cells past its slot's rows.  Must match
// repro_torch/kernels/common.py::DIRECT3D_MARGIN.
#define DIRECT3D_MARGIN 4

// The arguments the workspace form adds: its workspace, the floats of one
// CTA's slice and the (tile, grid) items.
#ifdef REPRO_WORKSPACE
#define DIRECT3D_WORKSPACE_ARGS , float* ws, size_t ws_floats, long long items
#else
#define DIRECT3D_WORKSPACE_ARGS
#endif

// The host's taps: the (2r+1)^3 taps of radius r, (dz, dy, dx) row-major,
// zero where skipped and past them.
struct Taps3 {
    float w[MAX_TAPS3D];
};

// The ring layout (repro_torch/kernels/common.py::direct3d_layout): slots
// of rows x ld floats, DIRECT3D_MARGIN floats before each and after the
// last; step 0's ring first, then one ring per later step but the last.
template <int R>
struct Rings {
    static constexpr int RING0 = 2 * R + 1 + DIRECT3D_AHEAD;
    static constexpr int RING = 2 * R + 2;
    int plane_ld;  // floats from a slot to the next
    // Offset in floats of the slot of region plane q (>= 0) in step s's ring.
    __device__ __forceinline__ int slot(int s, int q) const {
        const int i = s == 0 ? q % RING0 : RING0 + (s - 1) * RING + q % RING;
        return DIRECT3D_MARGIN + i * plane_ld;
    }
};

static inline long long direct3d_smem_bytes(int R, int t, int rows, int ld) {
    const long long slots = (2 * R + 1 + DIRECT3D_AHEAD) + (long long)(t - 1) * (2 * R + 2);
    return (DIRECT3D_MARGIN + slots * ((long long)rows * ld + DIRECT3D_MARGIN)) * 4;
}

// The y and x fill of one plane on a step's window: buffer rows [r_lo,
// r_lo + nr), global rows from gy0; columns [c_lo, c_lo + nc), global
// columns from gx0; depth o.  Every cell out of the domain in y or x and
// not deeper than o on either takes the in-domain cell of its two maps,
// or 0 under `zero` on either.  Only in-domain cells are read and only
// out-of-domain ones written.
__device__ __noinline__ void fill_plane(float* pl, int ld, int r_lo, int nr, int c_lo, int nc,
                                        int gy0, int gx0, int H, int W, int o, int my, int mx) {
    if (!leaves_domain(my, gy0, nr, H) && !leaves_domain(mx, gx0, nc, W)) return;
    for (int idx = threadIdx.x; idx < nr * nc; idx += CTA_THREADS) {
        const int i = idx / nc, c = idx - i * nc;
        const int gi = gy0 + i, gj = gx0 + c;
        const int si = axis_source(gi, H, o, my), sj = axis_source(gj, W, o, mx);
        if ((si == gi && sj == gj) || si == AXIS_DEEP || sj == AXIS_DEEP) continue;
        pl[(r_lo + i) * ld + c_lo + c] = (si == AXIS_ZERO || sj == AXIS_ZERO)
                                             ? 0.f
                                             : pl[(r_lo + si - gy0) * ld + c_lo + sj - gx0];
    }
}

// The foil's staging of one plane: the nrows x cols window whose first
// cell is global (r0, c0) of plane xp, modulo (H, W); window row f is
// buffer row f - keep_lo of pl (column lead + c) when that lies in [0,
// keep_n), else goes to the sink.  Four loads in flight a thread.  Returns
// the cells this thread loaded.
template <typename T>
__device__ __forceinline__ int foil_plane(float* pl, int ld, int lead, volatile float* sink,
                                          const T* __restrict__ xp, int H, int W, int r0, int c0,
                                          int nrows, int cols, int keep_lo, int keep_n) {
    constexpr int U = 4;
    const int n = nrows * cols;
    int loaded = 0;
    for (int f0 = threadIdx.x; f0 < n; f0 += U * CTA_THREADS) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int f = min(f0 + u * CTA_THREADS, n - 1);
            const int q = f / cols, c = f - q * cols;
            v[u] = to_f32(xp[(size_t)wrap(r0 + q, H) * W + wrap(c0 + c, W)]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int f = f0 + u * CTA_THREADS;
            if (f >= n) break;
            const int q = f / cols, c = f - q * cols;
            if ((unsigned)(q - keep_lo) < (unsigned)keep_n)
                pl[(q - keep_lo) * ld + lead + c] = v[u];
            else
                *sink = v[u];
            ++loaded;
        }
    }
    return loaded;
}

// One patch of one step's output plane: sums at rows [row0, row0 + V) and
// columns [c, c + 4) from rows [row0 - R, row0 + V + R) (clamped to the
// last, r_last) of the 2R + 1 input planes at smem + po[dz]; po[dz] < 0:
// a plane the zero fill makes all 0, which adds nothing.
template <int R, int V, bool FILL, typename TAPS>
__device__ __forceinline__ void direct3d_patch(const float* smem, const int (&po)[2 * R + 1],
                                               int ld, int row0, int c, int r_last,
                                               const TAPS& taps, float (&acc)[V][4]) {
    constexpr int KW = 2 * R + 1;
#pragma unroll
    for (int o = 0; o < V; ++o)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[o][k] = 0.f;
#pragma unroll
    for (int dz = 0; dz < KW; ++dz) {
        if (FILL && po[dz] < 0) continue;
        const float* in = smem + po[dz];
#pragma unroll
        for (int q = 0; q < V + 2 * R; ++q) {
            float v[4 + 2 * R];
            direct_row<R>(in + min(row0 - R + q, r_last) * ld + c, v);
#pragma unroll
            for (int dy = 0; dy < KW; ++dy) {
                const int o = q - dy;  // the output row this input row is tap row dy of
                if (o < 0 || o >= V) continue;
#pragma unroll
                for (int dx = 0; dx < KW; ++dx) {
                    const float wv = taps.w[(dz * KW + dy) * KW + dx];
                    if (wv != 0.f) {
#pragma unroll
                        for (int k = 0; k < 4; ++k) acc[o][k] = fmaf(wv, v[k + dx], acc[o][k]);
                    }
                }
            }
        }
    }
}

// direct3d_patch for the wide radii (R >= 4): for each input plane dz and
// tap row dy in turn, each output row's input row at (dz, dy), its 2R + 1
// taps unrolled; every output takes its fmaf in ascending (dz, dy, dx).
template <int R, int V, bool FILL, typename TAPS>
__device__ __forceinline__ void direct3d_patch_wide(const float* smem,
                                                    const int (&po)[2 * R + 1], int ld, int row0,
                                                    int c, int r_last, const TAPS& taps,
                                                    float (&acc)[V][4]) {
    constexpr int KW = 2 * R + 1;
#pragma unroll
    for (int o = 0; o < V; ++o)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[o][k] = 0.f;
#pragma unroll 1
    for (int dz = 0; dz < KW; ++dz) {
        if (FILL && po[dz] < 0) continue;
        const float* in = smem + po[dz];
#pragma unroll 1
        for (int dy = 0; dy < KW; ++dy) {
            const float* w = taps.w + (dz * KW + dy) * KW;
#pragma unroll
            for (int o = 0; o < V; ++o) {
                float v[4 + 2 * R];
                direct_row<R>(in + min(row0 - R + o + dy, r_last) * ld + c, v);
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
    }
}

// Stores the 4 sums v to global row `row` at columns [gj, gj + 4), those
// below W, 4 cells a store where the destination is on 4 * sizeof(T).
template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ row, int gj, int W, const float (&v)[4]) {
    T* dst = row + gj;
    if (gj + 4 <= W && on_bytes(dst, 4 * sizeof(T))) {
        if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
            uint2 u;
            *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
            *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
            *reinterpret_cast<uint2*>(dst) = u;
        }
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (gj + u < W) dst[u] = from_f32<T>(v[u]);
    }
}

// One step's patches in one interval (stencil_direct3d_kernel::step_work).
struct StepWork {
    int q, r_lo, g_lo, G, n;
};

template <typename T, int R, bool FILL, int STAGE>
__global__ void __launch_bounds__(CTA_THREADS,
                                  R == 1 ? DIRECT3D_MIN_BLOCKS : DIRECT3D_MIN_BLOCKS_WIDE)
stencil_direct3d_kernel(const T* __restrict__ x, T* __restrict__ y, int Z, int H, int W, int TZ,
                        int TM, int TN, int t, int ld, int gx, int gy, int mz, int my, int mx,
                        const __grid_constant__ KernelTaps<tap_slots(R, 3)> taps,
                        size_t grid_elems DIRECT3D_WORKSPACE_ARGS) {
    static_assert(STAGE != STAGE_NINE, "the 9-tile foil stages 2D grids only");
    constexpr int V = DIRECT3D_ROWS, KW = 2 * R + 1;
#ifdef REPRO_WORKSPACE
    // this CTA's slice; item i is tile i % tiles of grid i / tiles
    float* const smem = ws + (size_t)blockIdx.x * ws_floats;
    const long long tiles = (long long)gx * gy * ((Z + TZ - 1) / TZ);
    const T* const x0 = x;
    T* const y0 = y;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    x = grid_at(x0, (unsigned long long)(item / tiles), grid_elems);
    y = grid_at(y0, (unsigned long long)(item / tiles), grid_elems);
#else
    extern __shared__ __align__(16) float smem[];
#endif
    const int halo = t * R;
    const int planes0 = TZ + 2 * halo, rows0 = TM + 2 * halo, cols0 = TN + 2 * halo;
    const int lead = (-halo) & 3;
    const Rings<R> rings{rows0 * ld + DIRECT3D_MARGIN};
#ifdef REPRO_WORKSPACE
    const Tile3 tl = tile3((int)(item % tiles), gx, gy);
#else
    const Tile3 tl = tile3(blockIdx.x, gx, gy);
#endif
    const int k0 = tl.bz * TZ, i0 = tl.by * TM, j0 = tl.bx * TN;
    const int z0 = k0 - halo;  // the global plane of region plane 0
#ifndef REPRO_WORKSPACE
    if (blockIdx.z != 0) {  // this CTA's grid of the batch (grid 0: x, y)
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }
#endif
    const size_t plane_cells = (size_t)H * W;
    const bool zmap = FILL && mz != MODE_PERIODIC;
    const bool fill_yx = FILL && (leaves_domain(my, i0 - halo, rows0, H) ||
                                  leaves_domain(mx, j0 - halo, cols0, W));
    volatile float* const sink = sink_slot<STAGE>(smem, DIRECT3D_MARGIN);
    int loaded = 0;  // the cells staged (the counting build)

    // Stages region plane q into step 0's ring (none past the region).
    auto stage = [&](int q) {
        if (q >= planes0) return;
        const T* xp = x + (size_t)wrap(z0 + q, Z) * plane_cells;
        float* pl = smem + rings.slot(0, q);
        if constexpr (STAGE == STAGE_REGION) {
            loaded += stage_region(pl, ld, xp, H, W, i0 - halo, j0 - halo - lead, rows0);
        } else {
            loaded += foil_plane(pl, ld, lead, sink, xp, H, W, i0 - TM, j0 - halo, 3 * TM, cols0,
                                 TM - halo, rows0);
        }
    };
    // Step s's work in interval k: its output plane q = k - (s+1)R - s, the
    // window's first row r_lo (its rows end at rows0 - r_lo) and column
    // group g_lo, G groups a row block, n patches (0 when the plane is not
    // the step's: before the wave reaches it, past its planes, or out of
    // the z domain of a non-periodic z axis, which only the map reads).
    auto step_work = [&](int s, int k) {
        StepWork w;
        w.q = k - (s + 1) * R - s;
        const int d = (t - 1 - s) * R;  // the step's outputs reach d past the tile
        int glo = k0 - d, ghi = min(k0 + TZ, Z) + d;
        if (zmap) glo = max(glo, 0), ghi = min(ghi, Z);
        w.r_lo = (s + 1) * R;
        const int c_lo = lead + w.r_lo, c_end = lead + cols0 - w.r_lo;
        w.g_lo = c_lo >> 2;
        w.G = ((c_end + 3) >> 2) - w.g_lo;
        const bool live = s < t && w.q >= glo - z0 && w.q < ghi - z0;
        w.n = live ? w.G * ((rows0 - 2 * w.r_lo + V - 1) / V) : 0;
        return w;
    };
    // Stores the rows [row0, row0 + V) below r_end of step s's output plane
    // q at columns [c, c + 4): into step s + 1's ring, or from the last
    // step to y, masked at the grid's edges.
    auto store_patch = [&](int s, int q, int row0, int c, int r_end, const float(&acc)[V][4]) {
        if (s < t - 1) {
            float* const out = smem + rings.slot(s + 1, q);
#pragma unroll
            for (int o = 0; o < V; ++o)
                if (row0 + o < r_end)
                    *reinterpret_cast<float4*>(out + (row0 + o) * ld + c) =
                        make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
        } else {
            T* const yplane = y + (size_t)(z0 + q) * plane_cells;
#pragma unroll
            for (int o = 0; o < V; ++o) {
                const int gi = i0 - halo + row0 + o;
                if (row0 + o < r_end && gi < H)
                    store4(yplane + (size_t)gi * W, j0 - halo + c - lead, W, acc[o]);
            }
        }
    };
    if constexpr (STAGE == STAGE_STRIP) {
        // the foil's planes outside the region: [k0 - TZ, k0 + 2 TZ) less it
        for (int p = -TZ; p < 2 * TZ; ++p) {
            if (p >= -halo && p < TZ + halo) continue;
            const T* xp = x + (size_t)wrap(k0 + p, Z) * plane_cells;
            loaded += foil_plane(smem, 0, 0, sink, xp, H, W, i0 - TM, j0 - halo, 3 * TM, cols0,
                                 0, 0);
        }
    }
#pragma unroll
    for (int a = 0; a < DIRECT3D_AHEAD; ++a) {
        stage(a);
        cp_async_commit();
    }

    // The intervals: step s's output plane in interval k is k - (s+1)R - s.
    const int K = planes0 + t - 1;
    for (int k = 0; k < K; ++k) {
        cp_async_wait<DIRECT3D_AHEAD - 1>();
        __syncthreads();
        if (fill_yx) {
            // the planes entering each ring: step 0's plane k, staged; step
            // s's input plane step s - 1 computed in the interval before
            for (int s = 0; s < t; ++s) {
                const int q = k - s * (R + 1);
                const int lo = s * R;  // the step's input window starts here
                if (s == 0 ? q < planes0 : step_work(s - 1, k - 1).n > 0)
                    fill_plane(smem + rings.slot(s, q), ld, lo, rows0 - 2 * lo, lead + lo,
                               cols0 - 2 * lo, i0 - halo + lo, j0 - halo + lo, H, W,
                               (t - s) * R, my, mx);
            }
            __syncthreads();
        }
        stage(k + DIRECT3D_AHEAD);
        cp_async_commit();

        // This interval's patches, every step's in one list: thread j takes
        // items j, j + CTA_THREADS, ..., so a warp calls the patch once per
        // round whichever steps its threads' items belong to.
        int total = 0;
        for (int s = 0; s < t; ++s) total += step_work(s, k).n;
        for (int f = threadIdx.x; f < total; f += CTA_THREADS) {
            int s = 0, i = f;
            StepWork sw = step_work(0, k);
            while (i >= sw.n) i -= sw.n, sw = step_work(++s, k);
            int po[KW];
#pragma unroll
            for (int dz = 0; dz < KW; ++dz) {
                int qi = sw.q - R + dz;
                if (zmap) {
                    const int g = axis_source(z0 + qi, Z, (t - s) * R, mz);
                    qi = g < 0 ? -1 : g - z0;  // in the domain, or AXIS_ZERO
                }
                po[dz] = qi < 0 ? -1 : rings.slot(s, qi);
            }
            const int b = i / sw.G;
            const int row0 = sw.r_lo + b * V, c = (sw.g_lo + i - b * sw.G) * 4;
            float acc[V][4];
            if constexpr (R <= 3)
                direct3d_patch<R, V, FILL>(smem, po, ld, row0, c, rows0 - 1, taps, acc);
            else
                direct3d_patch_wide<R, V, FILL>(smem, po, ld, row0, c, rows0 - 1, taps, acc);
            store_patch(s, sw.q, row0, c, rows0 - sw.r_lo, acc);
        }
    }
    count_cta_loads(loaded);  // each plane of the region once
#ifdef REPRO_WORKSPACE
    __syncthreads();  // every thread is done with the slice before the next item
    }
#endif
}

#ifdef REPRO_CLUSTER
// The cluster form (the tile rule's third rung: rings that fit no one
// CTA's 227 KB, Box/Star-3D2R past t = 5 on 16 x 16 tiles): the C CTAs of
// a cluster compute one tile, rank k running the fused steps [lo[k],
// lo[k + 1]) (common.py::direct3d_cluster) and holding their rings, rank 0
// step 0's, which it stages, each rank's rings one after another from its
// first step's.  The interval's patches, the per-plane fill, the z map and
// the tap order are the one-CTA kernel's; a step whose successor runs on
// another rank stores its output plane into that rank's ring through
// distributed shared memory, and a cluster barrier stands where the
// one-CTA kernel's CTA barrier does at the start of each interval, so a
// ring's plane lands in the interval before it is read, as there.  Every
// output is the one-CTA kernel's bit for bit.
template <typename T, int R, bool FILL>
__global__ void __launch_bounds__(CTA_THREADS, 1)
    stencil_direct3d_cluster_kernel(const T* __restrict__ x, T* __restrict__ y, int Z, int H,
                                    int W, int TZ, int TM, int TN, int t, int ld, int gx, int gy,
                                    int mz, int my, int mx,
                                    const __grid_constant__ KernelTaps<tap_slots(R, 3)> taps,
                                    size_t grid_elems, const ClusterSplit sp) {
    constexpr int V = DIRECT3D_ROWS, KW = 2 * R + 1;
    constexpr int RING0 = Rings<R>::RING0, RING = Rings<R>::RING;
    extern __shared__ __align__(16) float smem[];
    const int rank = cluster_rank();
    const int s_lo = sp.lo[rank], s_hi = sp.lo[rank + 1];
    const int halo = t * R;
    const int planes0 = TZ + 2 * halo, rows0 = TM + 2 * halo, cols0 = TN + 2 * halo;
    const int lead = (-halo) & 3;
    const int plane_ld = rows0 * ld + DIRECT3D_MARGIN;
    const Tile3 tl = tile3(blockIdx.x / sp.ctas, gx, gy);
    const int k0 = tl.bz * TZ, i0 = tl.by * TM, j0 = tl.bx * TN;
    const int z0 = k0 - halo;
    if (blockIdx.z != 0) {
        x = grid_at(x, blockIdx.z, grid_elems);
        y = grid_at(y, blockIdx.z, grid_elems);
    }
    const size_t plane_cells = (size_t)H * W;
    const bool zmap = FILL && mz != MODE_PERIODIC;
    const bool fill_yx = FILL && (leaves_domain(my, i0 - halo, rows0, H) ||
                                  leaves_domain(mx, j0 - halo, cols0, W));
    int loaded = 0;

    // The slot of region plane q in step s's ring, in the shared memory of
    // the rank that runs step s.
    auto slot = [&](int s, int q) {
        const int first = sp.lo[split_owner(sp, s)];
        const int i = first == 0 ? (s == 0 ? q % RING0 : RING0 + (s - 1) * RING + q % RING)
                                 : (s - first) * RING + q % RING;
        return DIRECT3D_MARGIN + i * plane_ld;
    };
    auto stage = [&](int q) {
        if (s_lo != 0 || q >= planes0) return;
        const T* xp = x + (size_t)wrap(z0 + q, Z) * plane_cells;
        loaded += stage_region(smem + slot(0, q), ld, xp, H, W, i0 - halo, j0 - halo - lead, rows0);
    };
    auto step_work = [&](int s, int k) {
        StepWork w;
        w.q = k - (s + 1) * R - s;
        const int d = (t - 1 - s) * R;
        int glo = k0 - d, ghi = min(k0 + TZ, Z) + d;
        if (zmap) glo = max(glo, 0), ghi = min(ghi, Z);
        w.r_lo = (s + 1) * R;
        const int c_lo = lead + w.r_lo, c_end = lead + cols0 - w.r_lo;
        w.g_lo = c_lo >> 2;
        w.G = ((c_end + 3) >> 2) - w.g_lo;
        const bool live = s < t && w.q >= glo - z0 && w.q < ghi - z0;
        w.n = live ? w.G * ((rows0 - 2 * w.r_lo + V - 1) / V) : 0;
        return w;
    };
    auto store_patch = [&](int s, int q, int row0, int c, int r_end, const float(&acc)[V][4]) {
        if (s < t - 1) {
            const int to = split_owner(sp, s + 1);
            float* const out = (to == rank ? smem : peer(smem, to)) + slot(s + 1, q);
#pragma unroll
            for (int o = 0; o < V; ++o)
                if (row0 + o < r_end)
                    *reinterpret_cast<float4*>(out + (row0 + o) * ld + c) =
                        make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
        } else {
            T* const yplane = y + (size_t)(z0 + q) * plane_cells;
#pragma unroll
            for (int o = 0; o < V; ++o) {
                const int gi = i0 - halo + row0 + o;
                if (row0 + o < r_end && gi < H)
                    store4(yplane + (size_t)gi * W, j0 - halo + c - lead, W, acc[o]);
            }
        }
    };
#pragma unroll
    for (int a = 0; a < DIRECT3D_AHEAD; ++a) {
        stage(a);
        cp_async_commit();
    }

    const int K = planes0 + t - 1;
    for (int k = 0; k < K; ++k) {
        cp_async_wait<DIRECT3D_AHEAD - 1>();
        cluster_sync();
        if (fill_yx) {
            for (int s = s_lo; s < s_hi; ++s) {
                const int q = k - s * (R + 1);
                const int lo = s * R;
                if (s == 0 ? q < planes0 : step_work(s - 1, k - 1).n > 0)
                    fill_plane(smem + slot(s, q), ld, lo, rows0 - 2 * lo, lead + lo,
                               cols0 - 2 * lo, i0 - halo + lo, j0 - halo + lo, H, W,
                               (t - s) * R, my, mx);
            }
            __syncthreads();
        }
        stage(k + DIRECT3D_AHEAD);
        cp_async_commit();

        int total = 0;
        for (int s = s_lo; s < s_hi; ++s) total += step_work(s, k).n;
        for (int f = threadIdx.x; f < total; f += CTA_THREADS) {
            int s = s_lo, i = f;
            StepWork sw = step_work(s, k);
            while (i >= sw.n) i -= sw.n, sw = step_work(++s, k);
            int po[KW];
#pragma unroll
            for (int dz = 0; dz < KW; ++dz) {
                int qi = sw.q - R + dz;
                if (zmap) {
                    const int g = axis_source(z0 + qi, Z, (t - s) * R, mz);
                    qi = g < 0 ? -1 : g - z0;
                }
                po[dz] = qi < 0 ? -1 : slot(s, qi);
            }
            const int b = i / sw.G;
            const int row0 = sw.r_lo + b * V, c = (sw.g_lo + i - b * sw.G) * 4;
            float acc[V][4];
            direct3d_patch<R, V, FILL>(smem, po, ld, row0, c, rows0 - 1, taps, acc);
            store_patch(s, sw.q, row0, c, rows0 - sw.r_lo, acc);
        }
    }
    cluster_sync();  // the last interval's stores into the peers' rings have landed
    count_cluster_loads(loaded);
}
#endif

// The instantiation a launch in this type, radius, fill and staging takes,
// its launch attributes set on the current device (err: the outcome).
template <typename T, int R, int STAGE>
static auto direct3d_kernel(bool fill, cudaError_t& err) {
    auto* kernel = fill ? stencil_direct3d_kernel<T, R, true, STAGE>
                        : stencil_direct3d_kernel<T, R, false, STAGE>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    err = prepare_launch(kernel, attributes_set[fill]);
    return kernel;
}

template <typename T, int R, int STAGE>
static int launch(const void* x, void* y, const Taps3* taps, int Z, int H, int W, int TZ, int TM,
                  int TN, int t, int ld, const int* modes, int B, long long grid_elems,
                  int smem_bytes, cudaStream_t stream) {
    const bool fill = modes[0] != MODE_PERIODIC || modes[1] != MODE_PERIODIC ||
                      modes[2] != MODE_PERIODIC;
    const int halo = t * R, lead = (-halo) & 3;
    if (TZ < 1 || TM < 1 || TN < 4 || TN % 4 != 0 || t < 1 || ld % 4 != 0 ||
        ld < lead + TN + 2 * halo || smem_bytes < direct3d_smem_bytes(R, t, TM + 2 * halo, ld))
        return (int)cudaErrorInvalidValue;
    cudaError_t err;
    auto* kernel = direct3d_kernel<T, R, STAGE>(fill, err);
    if (err != cudaSuccess) return (int)err;
    const long long ctas = grid3_ctas(Z, H, W, TZ, TM, TN);
    if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
    const int gx = (W + TN - 1) / TN, gy = (H + TM - 1) / TM;
    const auto kt = kernel_taps<R, 3>(taps->w);
    return for_each_chunk(B, [&](int b0, int nb) {
        kernel<<<dim3((unsigned)ctas, 1, nb), CTA_THREADS, smem_bytes, stream>>>(
            grid_at(static_cast<const T*>(x), b0, grid_elems),
            grid_at(static_cast<T*>(y), b0, grid_elems), Z, H, W, TZ, TM, TN, t, ld, gx, gy,
            modes[0], modes[1], modes[2], kt, (size_t)grid_elems);
        return (int)cudaGetLastError();
    });
}

template <typename T, int STAGE>
static int launch_r(const void* x, void* y, const Taps3* taps, int Z, int H, int W, int TZ,
                    int TM, int TN, int t, int r, int ld, const int* modes, int B,
                    long long grid_elems, int smem_bytes, cudaStream_t s) {
#define ARGS x, y, taps, Z, H, W, TZ, TM, TN, t, ld, modes, B, grid_elems, smem_bytes, s
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

#define ARGS x, y, taps, Z, H, W, TZ, TM, TN, t, r, ld, modes, B, grid_elems, smem_bytes, \
             static_cast<cudaStream_t>(stream)
#if defined(REPRO_WORKSPACE)
// The workspace form's instantiations (radii 1..7, one each per grid
// dtype, the fill compiled in and gated by the modes at run time, which
// on a periodic grid skips it) and launch: min(ctas, tiles x B) persistent
// CTAs, CTA c on the slice_bytes at ws + c * slice_bytes, which hold the
// rings of common.py::direct3d_layout.
template <typename T, int R>
static int launch_workspace3d(const void* x, void* y, const Taps3* taps, int Z, int H, int W,
                              int TZ, int TM, int TN, int t, int ld, const int* modes, void* ws,
                              long long slice_bytes, int ctas, int B, long long grid_elems,
                              cudaStream_t stream) {
    const int halo = t * R, lead = (-halo) & 3;
    if (TZ < 1 || TM < 1 || TN < 4 || TN % 4 != 0 || t < 1 || ld % 4 != 0 ||
        ld < lead + TN + 2 * halo || ws == nullptr || slice_bytes % 128 != 0 ||
        slice_bytes < direct3d_smem_bytes(R, t, TM + 2 * halo, ld) || B < 1)
        return (int)cudaErrorInvalidValue;
    auto* kernel = stencil_direct3d_kernel<T, R, true, STAGE_REGION>;
    static std::atomic<bool> attributes_set[MAX_DEVICES];
    cudaError_t err = prepare_workspace_launch(kernel, attributes_set);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = grid3_ctas(Z, H, W, TZ, TM, TN);
    const int grid = tiles < 1 ? 0 : workspace_grid(tiles * B, ctas);
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    const int gx = (W + TN - 1) / TN, gy = (H + TM - 1) / TM;
    kernel<<<grid, CTA_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), Z, H, W, TZ, TM, TN, t, ld, gx, gy, modes[0],
        modes[1], modes[2], kernel_taps<R, 3>(taps->w), (size_t)grid_elems,
        static_cast<float*>(ws), (size_t)(slice_bytes / 4), tiles * B);
    return (int)cudaGetLastError();
}

// stencil_direct3d_launch's arguments, then the workspace ws of ctas
// slices of slice_bytes each (common.py::WorkspaceLayout); smem_bytes must
// be 0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_direct3d_workspace_launch(const void* x, void* y, const Taps3* taps, int Z,
                                                 int H, int W, int TZ, int TM, int TN, int t,
                                                 int r, int ld, int dtype, int mode_z, int mode_y,
                                                 int mode_x, void* ws, long long slice_bytes,
                                                 int ctas, int B, long long grid_elems,
                                                 int smem_bytes, void* stream) {
    if (grid_elems != (long long)Z * H * W || smem_bytes != 0) return (int)cudaErrorInvalidValue;
    const int modes[3] = {mode_z, mode_y, mode_x};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WARGS x, y, taps, Z, H, W, TZ, TM, TN, t, ld, modes, ws, slice_bytes, ctas, B, grid_elems, s
    if (dtype == 0) {
        if (r == 1) return launch_workspace3d<float, 1>(WARGS);
        if (r == 2) return launch_workspace3d<float, 2>(WARGS);
        if (r == 3) return launch_workspace3d<float, 3>(WARGS);
        if (r == 4) return launch_workspace3d<float, 4>(WARGS);
        if (r == 5) return launch_workspace3d<float, 5>(WARGS);
        if (r == 6) return launch_workspace3d<float, 6>(WARGS);
        if (r == 7) return launch_workspace3d<float, 7>(WARGS);
    } else if (dtype == 1) {
        using BF = __nv_bfloat16;
        if (r == 1) return launch_workspace3d<BF, 1>(WARGS);
        if (r == 2) return launch_workspace3d<BF, 2>(WARGS);
        if (r == 3) return launch_workspace3d<BF, 3>(WARGS);
        if (r == 4) return launch_workspace3d<BF, 4>(WARGS);
        if (r == 5) return launch_workspace3d<BF, 5>(WARGS);
        if (r == 6) return launch_workspace3d<BF, 6>(WARGS);
        if (r == 7) return launch_workspace3d<BF, 7>(WARGS);
    }
#undef WARGS
    return (int)cudaErrorInvalidValue;
}
#elif defined(REPRO_CLUSTER)
// The cluster form's instantiations (radii 1..MAX_CLUSTER_RADIUS3D, one
// each per grid dtype: the fill compiled in and gated by the modes at run
// time, which on a periodic grid skips it, as the periodic instantiation
// of the one-CTA kernel does) and launch: ctas CTAs a tile, rank k running
// the steps [lo[k], lo[k + 1]); smem_bytes covers every rank's rings.
#define MAX_CLUSTER_RADIUS3D 2
template <typename T, int R>
static int launch_cluster3d(const void* x, void* y, const Taps3* taps, int Z, int H, int W,
                            int TZ, int TM, int TN, int t, int ld, const int* modes, int B,
                            long long grid_elems, int smem_bytes, const ClusterSplit& sp,
                            cudaStream_t stream) {
    const bool fill = modes[0] != MODE_PERIODIC || modes[1] != MODE_PERIODIC ||
                      modes[2] != MODE_PERIODIC;
    const int halo = t * R, lead = (-halo) & 3;
    if (TZ < 1 || TM < 1 || TN < 4 || TN % 4 != 0 || t < 1 || ld % 4 != 0 ||
        ld < lead + TN + 2 * halo || !split_ok(sp, t))
        return (int)cudaErrorInvalidValue;
    const long long plane_ld = (long long)(TM + 2 * halo) * ld + DIRECT3D_MARGIN;
    for (int k = 0; k < sp.ctas; ++k) {
        long long slots = 0;
        for (int s = sp.lo[k]; s < sp.lo[k + 1]; ++s) slots += s == 0 ? Rings<R>::RING0 : Rings<R>::RING;
        if ((DIRECT3D_MARGIN + slots * plane_ld) * 4 > smem_bytes) return (int)cudaErrorInvalidValue;
    }
    (void)fill;  // one instantiation, the fill gated by the modes at run time
    auto* kernel = stencil_direct3d_cluster_kernel<T, R, true>;
    static std::atomic<bool> attributes_set[MAX_DEVICES];
    cudaError_t err = prepare_launch(kernel, attributes_set);
    if (err != cudaSuccess) return (int)err;
    const long long ctas = grid3_ctas(Z, H, W, TZ, TM, TN);
    if (ctas < 1 || ctas * sp.ctas > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const int gx = (W + TN - 1) / TN, gy = (H + TM - 1) / TM;
    const auto kt = kernel_taps<R, 3>(taps->w);
    return for_each_chunk(B, [&](int b0, int nb) {
        return launch_cluster(kernel, dim3((unsigned)(ctas * sp.ctas), 1, nb), sp.ctas,
                              smem_bytes, stream, grid_at(static_cast<const T*>(x), b0, grid_elems),
                              grid_at(static_cast<T*>(y), b0, grid_elems), Z, H, W, TZ, TM, TN, t,
                              ld, gx, gy, modes[0], modes[1], modes[2], kt, (size_t)grid_elems,
                              sp);
    });
}

// stencil_direct3d_launch's arguments and the cluster: ctas (2, 4 or 8)
// and steps[0..ctas], rank k running the fused steps [steps[k], steps[k +
// 1]) (common.py::direct3d_cluster); r in 1..MAX_CLUSTER_RADIUS3D;
// smem_bytes the largest share.  Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_direct3d_cluster_launch(const void* x, void* y, const Taps3* taps, int Z,
                                               int H, int W, int TZ, int TM, int TN, int t,
                                               int r, int ld, int dtype, int mode_z, int mode_y,
                                               int mode_x, int ctas, const int* steps, int B,
                                               long long grid_elems, int smem_bytes,
                                               void* stream) {
    if (grid_elems != (long long)Z * H * W || ctas < 2 || ctas > MAX_CLUSTER)
        return (int)cudaErrorInvalidValue;
    const int modes[3] = {mode_z, mode_y, mode_x};
    const ClusterSplit sp = split_from(ctas, steps, nullptr);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CARGS x, y, taps, Z, H, W, TZ, TM, TN, t, ld, modes, B, grid_elems, smem_bytes, sp, s
    if (dtype == 0 && r == 1) return launch_cluster3d<float, 1>(CARGS);
    if (dtype == 0 && r == 2) return launch_cluster3d<float, 2>(CARGS);
    if (dtype == 1 && r == 1) return launch_cluster3d<__nv_bfloat16, 1>(CARGS);
    if (dtype == 1 && r == 2) return launch_cluster3d<__nv_bfloat16, 2>(CARGS);
#undef CARGS
    return (int)cudaErrorInvalidValue;
}
#elif !defined(REPRO_FOIL)
// taps: the dense (2r+1)^3 float32 weights, row-major, the rest zero.
// dtype: 0 = float32, 1 = bfloat16 (input and output); r in 1..7; ld and
// smem_bytes: the layout of repro_torch/kernels/common.py::direct3d_layout;
// mode_z, mode_y, mode_x: each axis's boundary code (MODE_*); x and y hold
// B grids of grid_elems = Z * H * W cells each (the batch, K11).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int stencil_direct3d_launch(const void* x, void* y, const Taps3* taps, int Z, int H,
                                       int W, int TZ, int TM, int TN, int t, int r, int ld,
                                       int dtype, int mode_z, int mode_y, int mode_x, int B,
                                       long long grid_elems, int smem_bytes, void* stream) {
    if (grid_elems != (long long)Z * H * W) return (int)cudaErrorInvalidValue;
    const int modes[3] = {mode_z, mode_y, mode_x};
    if (dtype == 0) return launch_r<float, STAGE_REGION>(ARGS);
    if (dtype == 1) return launch_r<__nv_bfloat16, STAGE_REGION>(ARGS);
    return (int)cudaErrorInvalidValue;
}

template <typename T>
static int ctas_per_sm(int r, bool fill, int smem_bytes, int& n) {
    cudaError_t err = cudaErrorInvalidValue;
    auto query = [&](auto* kernel) {
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CTA_THREADS,
                                                                smem_bytes);
    };
    if (r == 1) query(direct3d_kernel<T, 1, STAGE_REGION>(fill, err));
    if (r == 2) query(direct3d_kernel<T, 2, STAGE_REGION>(fill, err));
    if (r == 3) query(direct3d_kernel<T, 3, STAGE_REGION>(fill, err));
    return (int)err;
}

// CTAs of the instantiation a launch of this dtype, radius and fill takes
// that fit on one SM at once with smem_bytes of dynamic shared memory, as
// the runtime counts them (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the cudaError_t of a failed query.
extern "C" int stencil_direct3d_ctas_per_sm(int dtype, int r, int fill, int smem_bytes) {
    int n = 0, err = (int)cudaErrorInvalidValue;
    if (dtype == 0) err = ctas_per_sm<float>(r, fill != 0, smem_bytes, n);
    if (dtype == 1) err = ctas_per_sm<__nv_bfloat16>(r, fill != 0, smem_bytes, n);
    return err == 0 ? n : -err;
}
#else
// The whole-slab foil: stencil_direct3d_launch's arguments and the
// staging, stage = STAGE_STRIP (any boundary).
extern "C" int stencil_direct3d_foil_launch(const void* x, void* y, const Taps3* taps, int Z,
                                            int H, int W, int TZ, int TM, int TN, int t, int r,
                                            int ld, int dtype, int stage, int mode_z, int mode_y,
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
