// Thread-block clusters for the 3D kernels whose layout fits no single
// CTA's 227 KB (the tile rule's third rung,
// repro_torch/kernels/common.py::resolve_tile_geom): the CTAs of a
// cluster of C (2, 4 or 8, the portable most) share one output tile, each
// holding a share of the tile's layout (common.py::ClusterLayout), and read
// and write each other's shares through distributed shared memory.  A
// cluster launch's grid is tiles x C along x, rank k of tile i at blockIdx.x
// = i * C + k; cluster_sync (barrier.cluster.arrive.release / wait.acquire)
// stands where a one-CTA kernel has __syncthreads between a write into a
// peer's share and its read.  A CTA passes one last cluster_sync before it
// exits whenever a peer may still reach into its share.
#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "common.cuh"

#define MAX_CLUSTER 8

// What each rank of a cluster owns (common.py::ClusterLayout): rank k the
// items [lo[k], lo[k + 1]) -- fused steps, kernel planes dz or region
// planes -- and, for a split by dz, the bands [rows[k], rows[k + 1]).
struct ClusterSplit {
    int ctas;
    int lo[MAX_CLUSTER + 1];
    int rows[MAX_CLUSTER + 1];
};

__device__ __forceinline__ int cluster_rank() {
    return (int)cooperative_groups::this_cluster().block_rank();
}

__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

// Rank `rank`'s address of the shared-memory location p of this CTA.
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
    return cooperative_groups::this_cluster().map_shared_rank(p, (unsigned)rank);
}

// The rank that owns item i.
__device__ __forceinline__ int split_owner(const ClusterSplit& sp, int i) {
    int k = 0;
    while (k + 1 < sp.ctas && i >= sp.lo[k + 1]) ++k;
    return k;
}

// The counting build's count of a cluster launch: the cells the cluster's
// CTAs staged, added in rank 0's counter and kept as one count per
// cluster (the staging of one tile, as a one-CTA launch counts it).
__device__ __forceinline__ void count_cluster_loads(int n) {
#ifdef REPRO_COUNT_LOADS
    __shared__ unsigned int cl;
    if (threadIdx.x == 0) cl = 0;
    cluster_sync();
    atomicAdd(peer(&cl, 0), (unsigned int)n);
    cluster_sync();
    if (cluster_rank() == 0 && threadIdx.x == 0) {
        atomicMin(&repro_cta_loads[0], cl);
        atomicMax(&repro_cta_loads[1], cl);
    }
#endif
}

// Checks a host split of n items over its cluster: 2..MAX_CLUSTER ranks,
// each owning at least one item, from 0 to n.
static inline bool split_ok(const ClusterSplit& sp, int n) {
    if (sp.ctas < 2 || sp.ctas > MAX_CLUSTER || sp.lo[0] != 0 || sp.lo[sp.ctas] != n) return false;
    for (int k = 0; k < sp.ctas; ++k)
        if (sp.lo[k + 1] <= sp.lo[k]) return false;
    return true;
}

// The split a C entry takes: ctas, then lo[0..ctas] and rows[0..ctas].
static inline ClusterSplit split_from(int ctas, const int* lo, const int* rows) {
    ClusterSplit sp{};
    sp.ctas = ctas;
    for (int k = 0; k <= ctas && k <= MAX_CLUSTER; ++k) {
        sp.lo[k] = lo[k];
        sp.rows[k] = rows ? rows[k] : 0;
    }
    return sp;
}

// Launches `kernel` as clusters of `ctas` CTAs along x on `grid` (whose x
// is a multiple of ctas) with smem bytes of dynamic shared memory each.
template <typename... Params, typename... Args>
static int launch_cluster(void (*kernel)(Params...), dim3 grid, int ctas, int smem,
                          cudaStream_t stream, Args&&... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(CTA_THREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
