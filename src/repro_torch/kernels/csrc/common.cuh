// Pieces the stencil kernels share: the periodic index wrap, dtype
// conversion, the halo-region load, the boundary fill, the tile store,
// the batch (K11) and the launch attributes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// Staging of a kernel's input region, a template parameter of every
// kernel (codes of repro_torch/kernels/common.py::STAGE_CODES).  A CTA
// computes its tile from the (TM+2h) x (TN+2h) region [x (TZ+2h)] around
// it.  STAGE_REGION reads that region once (load_rect / load_rect3d):
// every main-path launch.  The traffic foils read whole neighbour tiles
// and keep the region's cells of them (load_window / load_window3d), so
// they compute what STAGE_REGION computes, bit for bit, from more bytes
// (the JAX package's foils: repro/kernels/common.py::_assemble_foil,
// kinds wholestrip / wholeslab, and repro/kernels/legacy.py):
//   STAGE_STRIP, K8: 2D, the whole TM-row tiles above, at and below the
//     CTA's own, each with the x-halo: 3 TM (TN + 2h) cells; 3D, the 3 x 3
//     whole (z, y) tiles, each with the x-halo: 9 TZ TM (TN + 2h) cells;
//   STAGE_NINE, K9 / K10: 2D, the 9 whole TM x TN tiles around and at the
//     CTA's own: 9 TM TN cells.
// A foil's tiles are at least the halo deep on every staged axis (the
// wrappers check), so the windows cover the region.  The region's layout
// in shared memory is the same for every staging.
#define STAGE_REGION 0
#define STAGE_STRIP 1
#define STAGE_NINE 2

// The load-counting build (REPRO_COUNT_LOADS=1 at build time): a staging
// adds the cells it copies to its count n; every other build compiles the
// count away, so its code is the same instruction for instruction.
#ifdef REPRO_COUNT_LOADS
#define COUNT_CELLS(n, k) ((n) += (k))
#else
#define COUNT_CELLS(n, k) ((void)0)
#endif

// Loads the rows x cols region whose first cell is global (r0, c0), taken
// modulo (H, W), into dst (row stride ld) as f32.  A global load waits
// ~1 us, so each warp issues 8 rows x 4 column chunks of 32 before storing
// any: a thread keeps 32 loads in flight.  Returns the cells this thread
// loaded in the counting build, 0 in every other.
template <typename T>
__device__ __forceinline__ int load_rect(float* dst, int ld, const T* __restrict__ x, int H,
                                         int W, int r0, int c0, int rows, int cols) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int n = 0;
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
                    if (rb + u < rows && cb + lane + 32 * c < cols) {
                        dst[(rb + u) * ld + cb + lane + 32 * c] = v[u][c];
                        COUNT_CELLS(n, 1);
                    }
        }
    }
    return n;
}

// The 3D form of load_rect: the planes x rows x cols region whose first
// cell is global (p0, r0, c0), taken modulo (Z, H, W), into dst (plane
// stride plane_ld, row stride ld) as f32.  The (plane, row) pairs are
// walked as one flattened row index, 8 per warp at a time as in
// load_rect, and every global offset is 64-bit ((z*H + y)*W + x passes
// 2^31 at 2048 x 1024 x 1024).  Returns the cells this thread loaded in
// the counting build, 0 in every other.
template <typename T>
__device__ __forceinline__ int load_rect3d(float* dst, int ld, size_t plane_ld,
                                           const T* __restrict__ x, int Z, int H, int W,
                                           int p0, int r0, int c0, int planes, int rows,
                                           int cols) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nrows = planes * rows;
    int n = 0;
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
                    if (rb + u < nrows && cb + lane + 32 * c < cols) {
                        dst[doff[u] + 32 * c] = v[u][c];
                        COUNT_CELLS(n, 1);
                    }
        }
    }
    return n;
}

#ifdef REPRO_COUNT_LOADS
// The load-counting build (REPRO_COUNT_LOADS=1 at build time;
// chip_smoke.py): every CTA counts the grid cells its staging loads -- a
// foil's windows, the default kernels' region (the tap-sums' and the 1D
// kernels' in whole 16-byte granules; the persistent 1D kernels count
// each segment or CTA tile they stage) -- and a launch keeps the least and
// the most count over its CTAs.
__device__ unsigned int repro_cta_loads[2] = {0xffffffffu, 0u};

// Copies the least and the most count since the last call to out[0..1],
// and starts them afresh.
extern "C" int repro_load_counts(unsigned int* out) {
    const unsigned int fresh[2] = {0xffffffffu, 0u};
    cudaError_t err = cudaMemcpyFromSymbol(out, repro_cta_loads, sizeof(fresh));
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(repro_cta_loads, fresh, sizeof(fresh));
    return (int)err;
}
#endif

// Adds this thread's n loaded cells to its CTA's count, and the CTA's
// count to the launch's least and most: the counting build only.
__device__ __forceinline__ void count_cta_loads(int n) {
#ifdef REPRO_COUNT_LOADS
    __shared__ unsigned int cta;
    if (threadIdx.x == 0) cta = 0;
    __syncthreads();
    atomicAdd(&cta, (unsigned int)n);
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicMin(&repro_cta_loads[0], cta);
        atomicMax(&repro_cta_loads[1], cta);
    }
#endif
}

// A foil's window: loads the wrows x wcols window whose first cell is
// region cell (wr, wc), global (r0 + wr, c0 + wc), taken modulo (H, W),
// as f32, 8 rows x 4 column chunks of 32 per warp in flight as in
// load_rect.  A cell inside the rows x cols region goes to dst (row stride
// ld); a cell outside it goes to this thread's sink slot by a volatile
// shared-memory store, so the compiler keeps every load the foil
// requests: each loaded value is stored to shared memory once, as in the
// region load, and only the bytes differ.  Returns the cells this thread
// loaded.
template <typename T>
__device__ __forceinline__ int load_window(float* dst, int ld, volatile float* sink,
                                           const T* __restrict__ x, int H, int W, int r0, int c0,
                                           int rows, int cols, int wr, int wc, int wrows,
                                           int wcols) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int n = 0;
    for (int cb = 0; cb < wcols; cb += 128) {
        int gj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) gj[c] = wrap(c0 + wc + cb + lane + 32 * c, W);
        for (int rb = warp * 8; rb < wrows; rb += CTA_WARPS * 8) {
            float v[8][4];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const T* src = x + (size_t)wrap(r0 + wr + min(rb + u, wrows - 1), H) * W;
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    v[u][c] = (rb + u < wrows && cb + lane + 32 * c < wcols) ? to_f32(src[gj[c]]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (rb + u < wrows && cb + lane + 32 * c < wcols) {
                        const int q = wr + rb + u, k = wc + cb + lane + 32 * c;
                        if ((unsigned)q < (unsigned)rows && (unsigned)k < (unsigned)cols)
                            dst[q * ld + k] = v[u][c];
                        else
                            *sink = v[u][c];
                        ++n;
                    }
        }
    }
    return n;
}

// Loads the rows x cols region whose first cell is global (r0, c0), taken
// modulo (H, W), into dst (row stride ld) as f32, by the staging STAGE;
// the region is the TM x TN tile with its halo.  sink: the foils' slot.
template <int STAGE, typename T>
__device__ __forceinline__ void load_region(float* dst, int ld, volatile float* sink,
                                            const T* __restrict__ x, int H, int W, int r0,
                                            int c0, int rows, int cols, int TM, int TN) {
    if constexpr (STAGE == STAGE_REGION) {
        count_cta_loads(load_rect(dst, ld, x, H, W, r0, c0, rows, cols));
    } else {
        const int hy = (rows - TM) / 2, hx = (cols - TN) / 2;  // the halo
        int n = 0;
#pragma unroll 1
        for (int d = -1; d <= 1; ++d) {
            if constexpr (STAGE == STAGE_STRIP) {
                n += load_window(dst, ld, sink, x, H, W, r0, c0, rows, cols, hy + d * TM, 0, TM,
                                 cols);
            } else {
#pragma unroll 1
                for (int e = -1; e <= 1; ++e)
                    n += load_window(dst, ld, sink, x, H, W, r0, c0, rows, cols, hy + d * TM,
                                     hx + e * TN, TM, TN);
            }
        }
        count_cta_loads(n);
    }
}

// The 3D form of load_window: the wplanes x wrows x cols window whose first
// cell is region cell (wp, wr, 0), global (p0 + wp, r0 + wr, c0), taken
// modulo (Z, H, W), spanning the region's columns, walked as load_rect3d
// walks its region.  Cells inside the planes x rows x cols region go to
// dst (plane stride plane_ld, row stride ld), the others to the sink
// slot.  Returns the cells this thread loaded.
template <typename T>
__device__ __forceinline__ int load_window3d(float* dst, int ld, size_t plane_ld,
                                             volatile float* sink, const T* __restrict__ x, int Z,
                                             int H, int W, int p0, int r0, int c0, int planes,
                                             int rows, int cols, int wp, int wr, int wplanes,
                                             int wrows) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nrows = wplanes * wrows;
    int n = 0;
    for (int cb = 0; cb < cols; cb += 128) {
        int gj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) gj[c] = wrap(c0 + cb + lane + 32 * c, W);
        for (int rb = warp * 8; rb < nrows; rb += CTA_WARPS * 8) {
            float v[8][4];
            size_t doff[8];
            bool keep[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int fr = min(rb + u, nrows - 1);
                const int qp = fr / wrows;
                const int q = wp + qp, rr = wr + fr - qp * wrows;  // region plane, row
                keep[u] = (unsigned)q < (unsigned)planes && (unsigned)rr < (unsigned)rows;
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
                    if (rb + u < nrows && cb + lane + 32 * c < cols) {
                        if (keep[u])
                            dst[doff[u] + 32 * c] = v[u][c];
                        else
                            *sink = v[u][c];
                        ++n;
                    }
        }
    }
    return n;
}

// The 3D form of load_region: the planes x rows x cols region whose first
// cell is global (p0, r0, c0), the TZ x TM x TN tile with its halo, by the
// staging STAGE (STAGE_STRIP: the whole-slab foil).
template <int STAGE, typename T>
__device__ __forceinline__ void load_region3d(float* dst, int ld, size_t plane_ld,
                                              volatile float* sink, const T* __restrict__ x,
                                              int Z, int H, int W, int p0, int r0, int c0,
                                              int planes, int rows, int cols, int TZ, int TM) {
    static_assert(STAGE != STAGE_NINE, "the 9-tile foil stages 2D grids only");
    if constexpr (STAGE == STAGE_REGION) {
        count_cta_loads(
            load_rect3d(dst, ld, plane_ld, x, Z, H, W, p0, r0, c0, planes, rows, cols));
    } else {
        const int hz = (planes - TZ) / 2, hy = (rows - TM) / 2;  // the halo
        int n = 0;
#pragma unroll 1
        for (int dz = -1; dz <= 1; ++dz)
#pragma unroll 1
            for (int dy = -1; dy <= 1; ++dy)
                n += load_window3d(dst, ld, plane_ld, sink, x, Z, H, W, p0, r0, c0, planes, rows,
                                   cols, hz + dz * TZ, hy + dy * TM, TZ, TM);
        count_cta_loads(n);
    }
}

// A foil's sink slot for this thread: one float of a shared-memory buffer
// of n floats that nothing reads while the region loads.  The region
// staging gets none.
template <int STAGE>
__device__ __forceinline__ volatile float* sink_slot(float* buf, int n) {
    if constexpr (STAGE == STAGE_REGION) return nullptr;
    else return buf + (int)threadIdx.x % n;
}

// Boundary mode codes of the launch interface, one per grid axis; must
// match repro_torch/kernels/common.py::BOUNDARY_CODES.
#define MODE_PERIODIC 0
#define MODE_ZERO 1
#define MODE_REFLECT 2
#define MODE_REPLICATE 3

// One axis of the boundary fill.  The region's cell q along the axis
// (stride s_ax, extent n_ax) is global cell g0 + q of an axis of extent
// N; a and b are the other two axes, walked over their whole extents.
// Every cell below the domain (g < 0; the region never starts deeper
// than o) and every cell above it within depth o (N <= g <= N-1+o) is
// rewritten from the same line's in-domain cells: 0 for zero, cell 0 or
// N-1 for replicate, cell -g or 2(N-1)-g for reflect (np.pad "reflect",
// the edge cell excluded).  Sources are in-domain and targets are not,
// so no thread reads a cell another writes.  Cells deeper than o (past
// the domain edge inside a ragged tile) are left as they are: they feed
// only outputs the store masks, and their mirror could leave the region.
// The wrapper guarantees N >= o + 1 on reflect axes, so every mirror is
// in-domain and inside the region.  Zero writes 0, so a NaN or Inf the
// modulo load brought in never survives.
__device__ __noinline__ void fill_axis(float* buf, size_t s_ax, size_t s_a, size_t s_b,
                                       int n_ax, int n_a, int n_b, int g0, int N, int o,
                                       int mode) {
    const int lo = min(n_ax, max(0, -g0));         // region cells [0, lo) lie below
    const int hb = N - g0;                          // ... and [hb, he) above
    const int he = min(n_ax, N + o - g0);
    const int nf = lo + max(0, he - hb);
    const int total = nf * n_a * n_b;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int ib = idx % n_b;
        const int rest = idx / n_b;
        const int ia = rest % n_a;
        const int f = rest / n_a;
        const int q = f < lo ? f : hb + (f - lo);
        const int g = g0 + q;
        const size_t line = ia * s_a + ib * s_b;
        float v = 0.f;
        if (mode != MODE_ZERO) {
            const int gs = mode == MODE_REPLICATE ? (g < 0 ? 0 : N - 1)
                                                  : (g < 0 ? -g : 2 * (N - 1) - g);
            v = buf[line + (size_t)(gs - g0) * s_ax];
        }
        buf[line + (size_t)q * s_ax] = v;
    }
}

// An axis's map for the fill (the 3D tap-sum's z map and per-plane fill,
// the clusters' z fill): global cell g of an axis of extent N in
// `mode`, at depth o.  Returns the in-domain cell it copies (g itself in
// the domain or on a periodic axis), AXIS_ZERO under `zero` outside the
// domain, or AXIS_DEEP deeper than o above the domain (left as it is: it
// feeds only outputs the last step masks).
#define AXIS_ZERO INT_MIN
#define AXIS_DEEP (INT_MIN + 1)
__device__ __forceinline__ int axis_source(int g, int N, int o, int mode) {
    if (mode == MODE_PERIODIC || (g >= 0 && g < N)) return g;
    if (g >= N + o) return AXIS_DEEP;
    if (mode == MODE_ZERO) return AXIS_ZERO;
    if (mode == MODE_REPLICATE) return g < 0 ? 0 : N - 1;
    return g < 0 ? -g : 2 * (N - 1) - g;
}

// Whether a region of n cells from global cell g0 leaves an axis of extent
// N whose mode is non-periodic: the fill has work on that axis.
__device__ __forceinline__ bool leaves_domain(int mode, int g0, int n, int N) {
    return mode != MODE_PERIODIC && (g0 < 0 || g0 + n > N);
}

// The in-kernel boundary fill (K6, the port of repro/kernels/common.py::
// apply_boundary_fills), run on a kernel's f32 region before each fused
// step.  The region holds p x h x w cells (strides plane_ld, ld, 1) whose
// first cell is global (gz, gy, gx) of a Z x H x W grid; at step s of t,
// o = (t - s) * R and (gz, gy, gx) = (k0, i0, j0) - o in every kernel,
// because each step writes its output at the region's origin.  Each
// non-periodic axis fills in ascending order over the full current extent
// of the others, halos included, with a barrier after it: np.pad's
// sequential corner values, which the oracle shares.  The JAX kernels
// gate the fill on the first and last block of the grid (_edge_flags);
// here it is gated by global index, since a tile may be shallower than
// its halo, the 1D lift's tiles hold one row, and a ragged tile holds the
// domain edge inside it.  Periodic axes keep what the modulo load (or the
// previous step) put there.  The kernels compile the fill only into the
// instantiation they launch when some axis is non-periodic (a FILL
// template flag), so a periodic launch runs the periodic code.  Within a
// fill launch every branch is uniform over the CTA: a CTA whose step-0
// region stays inside the domain never calls the fill (its region only
// shrinks), and one that does skips each axis, and its barrier, that its
// region does not leave, so only edge CTAs pay.  Non-periodic axes are loaded
// with the same modulo index as periodic ones (the JAX package's
// _reflect_block only keeps Pallas's block-fetch dedup, and the port has
// no block ring): the step-0 fill overwrites every out-of-domain cell a
// step reads.  2D kernels pass p = 1, plane_ld = 0, Z = 1, mz = 0.
__device__ __forceinline__ void fill_boundary(float* buf, size_t plane_ld, int ld, int p, int h,
                                              int w, int gz, int gy, int gx, int Z, int H, int W,
                                              int o, int mz, int my, int mx) {
    if (leaves_domain(mz, gz, p, Z)) {
        fill_axis(buf, plane_ld, ld, 1, p, h, w, gz, Z, o, mz);
        __syncthreads();
    }
    if (leaves_domain(my, gy, h, H)) {
        fill_axis(buf, ld, plane_ld, 1, h, p, w, gy, H, o, my);
        __syncthreads();
    }
    if (leaves_domain(mx, gx, w, W)) {
        fill_axis(buf, 1, plane_ld, ld, w, p, h, gx, W, o, mx);
        __syncthreads();
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

// K11, the batch (replaces repro/kernels/common.py::fold_batch, mode
// vmap, where jax.vmap gives every pallas_call a batch grid dimension):
// one launch advances B grids of grid_elems cells each, stored one after
// another.  Grid b of a chunk is blockIdx.z: each CTA moves x and y to
// its grid once, at entry, by a 64-bit offset (grid_at), and the tile,
// the fill, the weights and the tile rule stay per grid.  The kernels
// move them only when blockIdx.z != 0: the unconditional form cost the
// 2D banded f32 kernel 17 registers (80 -> 97, one CTA per SM fewer) and
// others up to 16 (ptxas on sm_90a), the branch left each within a few
// registers of the unbatched kernel and some below it.  gridDim.z
// takes at most MAX_GRID_Z, so a C entry launches a larger batch in
// chunks of at most MAX_GRID_Z grids (for_each_chunk; the wrappers count
// them with repro_torch/kernels/common.py::batch_chunks).  Nothing a CTA
// does depends on B, so the batch is bound by what B grids' bytes cost.
#define MAX_GRID_Z 65535

// p moved b grids of grid_elems cells on, in 64-bit arithmetic.
template <typename T>
__host__ __device__ __forceinline__ T* grid_at(T* p, unsigned long long b, size_t grid_elems) {
    return p + (size_t)b * grid_elems;
}

// Calls launch_chunk(b0, nb) for each chunk [b0, b0 + nb) of the B
// grids, nb <= MAX_GRID_Z; returns the first error.
template <typename F>
static int for_each_chunk(int B, F&& launch_chunk) {
    if (B < 1) return (int)cudaErrorInvalidValue;
    for (int b0 = 0; b0 < B; b0 += MAX_GRID_Z) {
        const int err = launch_chunk(b0, B - b0 < MAX_GRID_Z ? B - b0 : MAX_GRID_Z);
        if (err != 0) return err;
    }
    return 0;
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

#ifdef REPRO_WORKSPACE
// The workspace forms (the same sources built with -DREPRO_WORKSPACE; the
// tile rule's fourth rung, repro_torch/kernels/common.py::WorkspaceLayout):
// a launch whose layout no CTA's 227 KB and no thread-block cluster hold
// runs the same kernel body with that layout in a device workspace.  The
// body's storage base is a generic pointer to this CTA's slice of it
// instead of dynamic shared memory; its arithmetic and its order are the
// one-CTA kernel's, so every output equals that kernel's bit for bit.
// Generic loads and stores reach device memory as they reach shared
// memory, and __syncthreads() orders a CTA's device-memory writes for its
// own threads as it orders its shared ones.  Staging that lands in shared
// memory only (cp.async) goes through registers.  The launch runs
// persistent CTAs, SMs x WORKSPACE_MIN_BLOCKS, all resident at once (every
// kernel's __launch_bounds__ minimum is at least WORKSPACE_MIN_BLOCKS, so
// its registers let that many share an SM with no dynamic shared memory),
// CTA c owning slice c and walking the (tile, grid) items c, c + gridDim.x,
// ..., a barrier between two items, so the workspace is ctas slices, not
// tiles.  What bounds the forms is the working set: each CTA's slice (a
// region past 227 KB, up to megabytes) streams through L1 and L2 instead
// of staying on chip, so they run with the largest L1 carveout.
#define WORKSPACE_MIN_BLOCKS 2

// The launch attributes of a workspace kernel on the current device (no
// dynamic shared memory: the largest L1 carveout), set once per kernel and
// device as prepare_launch sets its own.
template <typename K>
static cudaError_t prepare_workspace_launch(K* kernel, std::atomic<bool>* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxL1);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
    return err;
}

// The CTAs a workspace launch of `items` (tile, grid) items runs with
// `ctas` slices: the least of the two, or 0 where the arguments are wrong.
static inline int workspace_grid(long long items, int ctas) {
    if (items < 1 || ctas < 1) return 0;
    return (int)(items < ctas ? items : ctas);
}
#endif

extern "C" const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
