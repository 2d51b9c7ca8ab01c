// The folded 1D tap-sum for Hopper (sm_90a): t fused steps of a 1D
// stencil with a boundary mode at the line's two ends (periodic, zero,
// reflect, replicate), one contiguous segment of the line per CTA.
//
// Replaces repro/kernels/stencil_direct.py:139-146, the JAX package's 1D
// lift of stencil_direct / _stencil_steps (:49) over strip_substrate_call,
// which runs the line as a (1, N) grid.  The 2D kernel on that lifted view
// (stencil_direct.cu, kept for comparison) runs 16-row tiles whose rows
// all hold row 0: a CTA stages (16 + 2h) x (L + 2h) cells for L outputs,
// runs every step over the copies and stores one row.
//
// What bounds it on an H100: bytes.  A step costs 2K flops per point (K <=
// 15 taps, r <= 7) against the 8 bytes an f32 line moves once in and once out, far
// under the 67 TFLOP/s / 3.35 TB/s ridge of the CUDA cores.  So:
//   * a CTA's tile is one segment of S = DIRECT1D_TILES * L consecutive
//     outputs (L the lifted tile's width: a segment is 64 of the lift's
//     tiles), and it reads the window [p0 - h, p0 + S + h) once, h = t R:
//     HBM reads the line 1 + 2h / S times;
//   * the window is copied with cp.async in 16-byte granules from the
//     granule that holds its first cell (line_stage.cuh::line_shift, one
//     shift per grid), granules that cross a line end element by element,
//     modulo N; a bfloat16 line stays bfloat16 in shared memory and widens
//     to f32 on step 0's reads;
//   * the t steps run in shared memory with f32 intermediates, the window
//     shrinking by R per step, between two buffers (a float32 line's
//     staging buffer is the second one once step 0 has read it); each
//     thread computes 4 consecutive outputs from a 12-cell register window
//     that three 16-byte shared loads bring in (20 cells, five loads, at
//     radii 5..7; a warp's threads read
//     consecutive 16-byte words: no bank conflict) and stores them with
//     one 16-byte store;
//   * the CTAs are persistent (__launch_bounds__ with a minimum of CTAs per
//     SM) and walk the B * segments (grid, segment) pairs, each grid at a
//     64-bit offset (K11: one launch for the batch), staging the next pair
//     while they compute this one; the outputs leave through 16-byte
//     stores, masked at the line's end.
// The arithmetic is the lifted kernel's: acc = 0, then fmaf(w[dx],
// in[j + dx], acc) in ascending dx with the zero taps skipped (the middle
// row of lift_weights in stencil_direct.cu's row-major order), f32
// throughout, rounded to the line's dtype once, on store.  So every output
// equals the lifted kernel's bit for bit.
// Only segments whose window leaves the line are filled, before every step
// at depth (t - s) R, by line_stage.cuh::fill_line (common.cuh::fill_axis's
// rule), compiled into the FILL instantiation only, so the periodic build
// carries no fill code; reflect's mirror always lies in the window.
#include "line_stage.cuh"

#define DIRECT1D_THREADS 256
#define DIRECT1D_MIN_BLOCKS 4
#define DIRECT1D_TILES 64  // lifted tiles per segment: common.py LINE_ROWS
#define MAX_RADIUS 7
#define MAX_TAPS1D (2 * MAX_RADIUS + 1)
// Cells a buffer holds past the window: the granule shift and the
// register window's read past the last group of 4 outputs.
#define DIRECT1D_SLACK 16

// One launch's geometry and taps; the shared-memory sizes are the host's
// (repro_torch/kernels/common.py::direct1d_layout).
struct Direct1dArgs {
    const void* x;
    void* y;
    long long grid_elems;  // N: cells of one grid of the batch
    long long items;       // B * segs (grid, segment) pairs
    int N, S, t, mode;     // the line, the segment, the steps, MODE_*
    int segs;              // segments per grid: ceil(N / S)
    int stage_bytes;       // one staging buffer (16 bytes of it before cell 0)
    int work_bytes;        // one f32 step buffer (likewise)
    float w[MAX_TAPS1D];   // the 2R + 1 taps; zero where skipped
};

// Where a CTA's segment lies: grid b of the batch, first output p0, nv
// outputs in the line.
struct Segment {
    long long b;
    int p0, nv;
};
__device__ __forceinline__ Segment segment(const Direct1dArgs& a, long long item) {
    Segment sg;
    sg.b = item / a.segs;
    sg.p0 = (int)(item - sg.b * a.segs) * a.S;
    sg.nv = min(a.S, a.N - sg.p0);
    return sg;
}

// Four values at p (16-byte aligned for f32, 8-byte for bf16) as f32.
__device__ __forceinline__ void load4(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
}

// Issues the copies of a segment's window: `cells` cells of the line from
// global cell `base` (16-byte aligned in the input) to dst.  Returns the
// cells this thread copied in the counting build, 0 in every other.
template <typename TIn>
__device__ __forceinline__ int stage_window(TIn* dst, const TIn* xg, int N, int base,
                                            int cells) {
    constexpr int G = 16 / (int)sizeof(TIn);
    const int nb = (cells + G - 1) / G;
    int copied = 0;
    for (int f = threadIdx.x; f < nb; f += DIRECT1D_THREADS) {
        const int s0 = base + f * G;
        COUNT_CELLS(copied, G);
        if (s0 >= 0 && s0 <= N - G) {
            cp_async16(dst + f * G, xg + s0);
        } else {
#pragma unroll
            for (int e = 0; e < G; ++e) dst[f * G + e] = xg[wrap(s0 + e, N)];
        }
    }
    return copied;
}

// The fill of the window at depth o (its first cell global p0 - o, at
// win0), when it leaves the line: a branch uniform over the CTA.  At most
// 2o cells change, so one warp fills them.
template <typename T>
__device__ __forceinline__ void fill_window(T* win0, const Segment& sg, int o,
                                            const Direct1dArgs& a) {
    const int win = sg.nv + 2 * o;
    if (!leaves_domain(a.mode, sg.p0 - o, win, a.N)) return;
    if (threadIdx.x < 32) fill_line(win0, win, sg.p0 - o, a.N, o, a.mode, (int)threadIdx.x);
    __syncthreads();
}

// One step: the outputs at buffer cells [lo, hi) from src, into dst, in
// groups of 4 from lo rounded down to a multiple of 4.  Cell c's output
// reads src cells [c - R, c + R]; the group's window is [c - P, c + 4 + P),
// P = 4 for radii up to 4 (12 cells), 8 for radii 5..8 (20 cells: the
// buffers keep 16 bytes before cell 0, and lo >= R puts c - 8 at cell -4
// or later).
template <int R, typename TS>
__device__ __forceinline__ void direct1d_step(const TS* src, float* dst, int lo, int hi,
                                              const Direct1dArgs& a) {
    static_assert(R >= 1 && R <= 8, "the register window covers radii 1..8");
    constexpr int P = R <= 4 ? 4 : 8;
    for (int c = (lo & ~3) + 4 * (int)threadIdx.x; c < hi; c += 4 * DIRECT1D_THREADS) {
        float v[4 + 2 * P];
#pragma unroll
        for (int u = 0; u < 1 + P / 2; ++u) load4(src + c - P + 4 * u, v + 4 * u);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int dx = 0; dx <= 2 * R; ++dx) {
            const float wv = a.w[dx];
            if (wv != 0.f) {
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[k] = fmaf(wv, v[P + k + dx - R], acc[k]);
            }
        }
        *reinterpret_cast<float4*>(dst + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
}

// Stores the segment's nv outputs (f32 at res) to y at p0, rounded to T:
// 16-byte stores where both sides are aligned, masked at the line's end.
template <typename T>
__device__ __forceinline__ void store_segment(T* yg, const float* res, const Segment& sg) {
    constexpr int V = 16 / (int)sizeof(T);
    T* out = yg + sg.p0;
    if ((uintptr_t)out % 16 == 0 && (uintptr_t)res % 16 == 0) {
        for (int v = (int)threadIdx.x * V; v < sg.nv; v += DIRECT1D_THREADS * V) {
            if (v + V <= sg.nv) {
                const float4 lo = *reinterpret_cast<const float4*>(res + v);
                if constexpr (V == 4) {
                    *reinterpret_cast<float4*>(out + v) = lo;
                } else {
                    const float4 hi = *reinterpret_cast<const float4*>(res + v + 4);
                    const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
                    uint4 u;
                    uint32_t* words = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const __nv_bfloat162 pair =
                            __halves2bfloat162(from_f32<T>(f[2 * e]), from_f32<T>(f[2 * e + 1]));
                        words[e] = *reinterpret_cast<const uint32_t*>(&pair);
                    }
                    *reinterpret_cast<uint4*>(out + v) = u;
                }
            } else {
                for (int e = 0; v + e < sg.nv; ++e) out[v + e] = from_f32<T>(res[v + e]);
            }
        }
    } else {
        for (int v = threadIdx.x; v < sg.nv; v += DIRECT1D_THREADS) out[v] = from_f32<T>(res[v]);
    }
}

template <typename TIn, int R, bool FILL>
__global__ void __launch_bounds__(DIRECT1D_THREADS, DIRECT1D_MIN_BLOCKS)
stencil_direct1d_kernel(Direct1dArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    // Buffer cell c is global cell p0 - h - sh + c; each buffer keeps 16
    // bytes before cell 0 for the register window's first load.
    auto stage = [&](int k) {
        return reinterpret_cast<TIn*>(smem + (k & 1) * a.stage_bytes + 16);
    };
    float* const ping = reinterpret_cast<float*>(smem + 2 * a.stage_bytes + 16);
    const TIn* const x = static_cast<const TIn*>(a.x);
    const int h = a.t * R;
    auto issue = [&](int k, long long item) {
        const Segment sg = segment(a, item);
        const TIn* xg = grid_at(x, sg.b, (size_t)a.grid_elems);
        const int sh = line_shift(xg, h);
        count_cta_loads(stage_window(stage(k), xg, a.N, sg.p0 - h - sh, sh + sg.nv + 2 * h));
    };

    long long item = blockIdx.x;
    if (item < a.items) issue(0, item);
    cp_async_commit();
    for (int k = 0; item < a.items; ++k) {
        const long long next = item + gridDim.x;
        if (next < a.items) issue(k + 1, next);
        cp_async_commit();
        cp_async_wait<1>();  // this segment's copies have landed
        __syncthreads();
        const Segment sg = segment(a, item);
        const int sh = line_shift(grid_at(x, sg.b, (size_t)a.grid_elems), h);
        TIn* const in = stage(k);
        float* const pong = sizeof(TIn) == 4 ? reinterpret_cast<float*>(in)
                                             : ping + a.work_bytes / 4;
        if (FILL) fill_window(in + sh, sg, h, a);
        direct1d_step<R>(in, ping, sh + R, sh + 2 * h + sg.nv - R, a);
        __syncthreads();
        float* cur = ping;
        for (int s = 1; s < a.t; ++s) {
            const int o = (a.t - s) * R;  // the input window's depth
            if (FILL) fill_window(cur + sh + s * R, sg, o, a);
            float* const nxt = cur == ping ? pong : ping;
            direct1d_step<R>(cur, nxt, sh + (s + 1) * R, sh + h + sg.nv + o - R, a);
            __syncthreads();
            cur = nxt;
        }
        store_segment(grid_at(static_cast<TIn*>(a.y), sg.b, (size_t)a.grid_elems), cur + sh + h,
                      sg);
        __syncthreads();  // before the next issue overwrites this buffer
        item = next;
    }
    cp_async_wait<0>();
}

// Launches the instantiation of the line's dtype, radius and boundary on a
// persistent grid: as many CTAs as fit on the card at once (at most one
// per segment).
template <typename TIn, int R>
static int direct1d_launch(const Direct1dArgs& a, int smem_bytes, cudaStream_t stream) {
    const bool fill = a.mode != MODE_PERIODIC;
    auto* kernel = fill ? stencil_direct1d_kernel<TIn, R, true>
                        : stencil_direct1d_kernel<TIn, R, false>;
    static std::atomic<bool> attributes_set[2][MAX_DEVICES];
    cudaError_t err = prepare_launch(kernel, attributes_set[fill]);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DIRECT1D_THREADS,
                                                        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long ctas = a.items < (long long)per_sm * sms ? a.items : (long long)per_sm * sms;
    kernel<<<(unsigned)ctas, DIRECT1D_THREADS, smem_bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename TIn>
static int direct1d_launch_r(const Direct1dArgs& a, int r, int smem_bytes, cudaStream_t s) {
    if (r == 1) return direct1d_launch<TIn, 1>(a, smem_bytes, s);
    if (r == 2) return direct1d_launch<TIn, 2>(a, smem_bytes, s);
    if (r == 3) return direct1d_launch<TIn, 3>(a, smem_bytes, s);
    if (r == 4) return direct1d_launch<TIn, 4>(a, smem_bytes, s);
    if (r == 5) return direct1d_launch<TIn, 5>(a, smem_bytes, s);
    if (r == 6) return direct1d_launch<TIn, 6>(a, smem_bytes, s);
    if (r == 7) return direct1d_launch<TIn, 7>(a, smem_bytes, s);
    return (int)cudaErrorInvalidValue;
}

// x and y hold B lines of N = grid_elems cells each; taps the 2r + 1
// float32 taps (zero where skipped), r in 1..7; L the lifted tile's width
// (a segment is DIRECT1D_TILES of them); lds, ld, stage_bytes, work_bytes
// and smem_bytes the shared-memory layout of
// repro_torch/kernels/common.py::direct1d_layout; dtype: 0 = float32,
// 1 = bfloat16 (input and output); mode_x: the line's boundary code
// (MODE_*).  Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_direct1d_launch(const void* x, void* y, const float* taps, int N, int L,
                                       int t, int r, int lds, int ld, int stage_bytes,
                                       int work_bytes, int dtype, int mode_x, int B,
                                       long long grid_elems, int smem_bytes, void* stream) {
    const int in_bytes = dtype == 0 ? 4 : 2;
    if (B < 1 || N < 1 || grid_elems != N || L < 16 || L % 16 != 0 || t < 1 || r < 1 ||
        r > MAX_RADIUS || mode_x < MODE_PERIODIC || mode_x > MODE_REPLICATE ||
        (dtype != 0 && dtype != 1) || L > (1 << 20) / DIRECT1D_TILES || t * r > (1 << 20))
        return (int)cudaErrorInvalidValue;
    const int S = DIRECT1D_TILES * L;
    const int span = S + 2 * t * r + DIRECT1D_SLACK;
    if (lds < 16 / in_bytes + span || ld < 4 + span || stage_bytes < lds * in_bytes ||
        stage_bytes % 16 != 0 || work_bytes < ld * 4 || work_bytes % 16 != 0 ||
        (in_bytes == 4 && lds < ld) ||
        smem_bytes < 2 * stage_bytes + (in_bytes == 4 ? 1 : 2) * work_bytes)
        return (int)cudaErrorInvalidValue;
    Direct1dArgs a{};
    a.x = x;
    a.y = y;
    a.grid_elems = grid_elems;
    a.N = N;
    a.S = S;
    a.t = t;
    a.mode = mode_x;
    a.segs = (int)((N + (long long)S - 1) / S);
    a.items = (long long)B * a.segs;
    a.stage_bytes = stage_bytes;
    a.work_bytes = work_bytes;
    for (int i = 0; i < 2 * r + 1; ++i) a.w[i] = taps[i];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return direct1d_launch_r<float>(a, r, smem_bytes, s);
    return direct1d_launch_r<__nv_bfloat16>(a, r, smem_bytes, s);
}
