// Constants every banded kernel shares: 16-row MMA tiles, 16-column band
// chunks (BAND_N), contraction depth padded to the MMA K step, at most
// MAX_KPAD in one unrolled piece (the 1D and 2D dense folds take deeper
// bands in pieces: FoldKs::DEEP, sparse_mma.cuh); and wmma's TF32 rounding
// (wmma::__float_to_tf32).
#pragma once

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

#define MMA_TILE 16
#define BAND_N 16
#define MAX_KPAD 64

__host__ __device__ __forceinline__ size_t align128(size_t n) { return (n + 127) & ~(size_t)127; }
