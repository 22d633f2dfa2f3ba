// conv_tile.cuh — the tile geometry of the int8 kernels E-H (through
// conv_tile_i8.cuh) and a staging helper for their float vectors. Kernels A
// and B keep their own tensor-core tilings (double_conv.cu, up_block.cu).
//
// A block owns one TH x TW output tile of one image. Its input is staged
// with a 2-pixel halo, the first conv runs on the (TH+2) x (TW+2) ring, and
// the second conv produces the tile.
#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace popcorn {

// The tile edge comes from the build (nn/cuda_lib.py::TILE): the dynamic
// int8 kernels take one activation scale per tile, and their plain versions
// cut the image into the same tiles.
#ifndef POPCORN_TILE
#error "build with -DPOPCORN_TILE=<tile edge> (nn/cuda_lib.py::NVCC_FLAGS)"
#endif
constexpr int TH = POPCORN_TILE;
constexpr int TW = POPCORN_TILE;
constexpr int NTHREADS = TH * TW;  // one thread per output pixel of conv2

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

template <class S>
__device__ __forceinline__ void copy_to_shared(float* dst, const S* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = load_as_float(src + i);
}

}  // namespace popcorn
