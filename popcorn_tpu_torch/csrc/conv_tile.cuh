// conv_tile.cuh — shared-memory tile helpers for kernel A (double_conv.cu)
// and, through conv_tile_i8.cuh, the int8 kernels E-H. Kernel B keeps its
// own tensor-core tiling (up_block.cu).
//
// Layout: activations are NHWC float32 or bf16 in device memory and
// float32 in shared memory (bf16 values convert exactly on load); conv
// weights are HWIO (3, 3, Cin, Cout), so the Cout values of one (tap,
// input channel) are contiguous and a warp reads them as float4
// broadcasts from shared memory.
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

// Stage a th x tw window of one NHWC image (C channels, float32 or bf16)
// whose top-left pixel is global (gy0, gx0) into `dst`, a float32 tile
// with CT channels per pixel, at channel offset c_off. Pixels outside the
// image read as zero: that is the SAME padding of the conv that consumes
// the tile.
template <int C, int CT, class S>
__device__ __forceinline__ void load_tile(float* dst, int c_off,
                                          const S* __restrict__ img, int H,
                                          int W, int gy0, int gx0, int th,
                                          int tw) {
  const int n = th * tw * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % C;
    const int p = i / C;
    const int tx = p % tw;
    const int ty = p / tw;
    const int gy = gy0 + ty;
    const int gx = gx0 + tx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = load_as_float(img + ((size_t)gy * W + gx) * C + c);
    dst[(ty * tw + tx) * CT + c_off + c] = v;
  }
}

template <class S>
__device__ __forceinline__ void copy_to_shared(float* dst, const S* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = load_as_float(src + i);
}

// acc[o] += sum over the 3x3 taps and CIN channels of in * w, for the
// output pixel (oy, ox) of a tile whose input is `in` (row width iw pixels,
// CIN channels per pixel, the output's top-left tap at in[0]).
template <int CIN, int COUT>
__device__ __forceinline__ void conv3x3_px(const float* in, int iw, int oy,
                                           int ox, const float* w,
                                           float (&acc)[COUT]) {
  static_assert(COUT % 4 == 0, "COUT must be a multiple of 4");
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float* ip = in + ((oy + ky) * iw + ox + kx) * CIN;
      const float4* wp =
          reinterpret_cast<const float4*>(w + (ky * 3 + kx) * CIN * COUT);
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        const float v = ip[c];
#pragma unroll
        for (int o4 = 0; o4 < COUT / 4; ++o4) {
          const float4 wv = wp[c * (COUT / 4) + o4];
          acc[4 * o4 + 0] = fmaf(v, wv.x, acc[4 * o4 + 0]);
          acc[4 * o4 + 1] = fmaf(v, wv.y, acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = fmaf(v, wv.z, acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = fmaf(v, wv.w, acc[4 * o4 + 3]);
        }
      }
    }
  }
}

// Shared-memory floats of the DoubleConv tail (y1 ring, both weights, the
// four affine vectors) for a conv1 input of CIN channels.
template <int CIN, int CM, int COUT>
__host__ __device__ constexpr int tail_floats() {
  return align4((TH + 2) * (TW + 2) * CM) + 9 * CIN * CM + 9 * CM * COUT +
         2 * align4(CM) + 2 * align4(COUT);
}

// The DoubleConv tail of kernel A, once `tile` holds the (TH+4) x (TW+4)
// x CIN staged input (zero outside the image):
//   y1 = relu(conv1(tile) * s1 + t1) on the (TH+2) x (TW+2) ring, set to 0
//        wherever the ring lies outside the image (it stands in for
//        conv2's zero padding; relu(t1) there would leak into the border),
//        rounded to the storage type T;
//   out = relu(conv2(y1) * s2 + t2) on the TH x TW tile, written NHWC in T.
// `tail` is the tail_floats<CIN, CM, COUT>() floats of shared memory after
// the tile; the weights (in T) and the float32 affine vectors are copied in
// here.
template <int CIN, int CM, int COUT, class T>
__device__ __forceinline__ void double_conv_tail(
    const float* tile, float* tail, const T* __restrict__ w1,
    const float* __restrict__ s1, const float* __restrict__ t1,
    const T* __restrict__ w2, const float* __restrict__ s2,
    const float* __restrict__ t2, T* __restrict__ out_img, int H, int W,
    int y0, int x0) {
  float* y1s = tail;
  float* w1s = y1s + align4((TH + 2) * (TW + 2) * CM);
  float* w2s = w1s + 9 * CIN * CM;
  float* s1s = w2s + 9 * CM * COUT;
  float* t1s = s1s + align4(CM);
  float* s2s = t1s + align4(CM);
  float* t2s = s2s + align4(COUT);
  copy_to_shared(w1s, w1, 9 * CIN * CM);
  copy_to_shared(w2s, w2, 9 * CM * COUT);
  copy_to_shared(s1s, s1, CM);
  copy_to_shared(t1s, t1, CM);
  copy_to_shared(s2s, s2, COUT);
  copy_to_shared(t2s, t2, COUT);
  __syncthreads();

  constexpr int RW = TW + 2;
  for (int p = threadIdx.x; p < (TH + 2) * RW; p += blockDim.x) {
    const int ry = p / RW;
    const int rx = p % RW;
    const int gy = y0 - 1 + ry;
    const int gx = x0 - 1 + rx;
    float* dst = y1s + p * CM;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float acc[CM];
#pragma unroll
      for (int o = 0; o < CM; ++o) acc[o] = 0.f;
      conv3x3_px<CIN, CM>(tile, TW + 4, ry, rx, w1s, acc);
#pragma unroll
      for (int o = 0; o < CM; ++o) dst[o] = round_to<T>(fmaxf(fmaf(acc[o], s1s[o], t1s[o]), 0.f));
    } else {
#pragma unroll
      for (int o = 0; o < CM; ++o) dst[o] = 0.f;
    }
  }
  __syncthreads();

  const int ty = threadIdx.x / TW;
  const int tx = threadIdx.x % TW;
  const int gy = y0 + ty;
  const int gx = x0 + tx;
  if (ty < TH && gy < H && gx < W) {
    float acc[COUT];
#pragma unroll
    for (int o = 0; o < COUT; ++o) acc[o] = 0.f;
    conv3x3_px<CM, COUT>(y1s, RW, ty, tx, w2s, acc);
    T* op = out_img + ((size_t)gy * W + gx) * COUT;
    auto y = [&](int o) { return fmaxf(fmaf(acc[o], s2s[o], t2s[o]), 0.f); };
#pragma unroll
    for (int o4 = 0; o4 < COUT / 4; ++o4)
      store4(op + 4 * o4, y(4 * o4), y(4 * o4 + 1), y(4 * o4 + 2), y(4 * o4 + 3));
  }
}

}  // namespace popcorn
