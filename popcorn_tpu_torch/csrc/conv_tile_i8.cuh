// conv_tile_i8.cuh — int8 tile helpers for the quantized UNet-block kernels
// (double_conv_qs.cu, up_block_qs.cu, double_conv_q.cu, up_block_q.cu).
//
// Tiles as in conv_tile.cuh: a block owns one TH x TW output tile, stages
// its input with a 2-pixel halo, computes y1 on the (TH+2) x (TW+2) ring
// and conv2 on the tile. An int8 tile holds P bytes a pixel, P a multiple
// of 4, so a pixel's channels read as P/4 int32 words of four codes;
// channels past the tensor's are zero. Weights arrive packed by the wrapper
// (nn/quant.py::pack_dp4a) as int32 words of four input channels, laid out
// (taps, channel groups, Cout), so one tap's words of one group are
// contiguous and read as int4 broadcasts. Four multiply-adds are one
// __dp4a into an int32 accumulator: exact, as a conv over at most 32
// channels sums at most 288 products of |code| <= 127.
//
// Dequantization and requantization round as the plain versions (and XLA
// in the JAX package) do: a product and a sum, each rounded on its own
// (__fmul_rn/__fadd_rn, so nvcc does not contract them into an FMA), then
// rintf, which rounds half to even as torch.round and jnp.round do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace popcorn {

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// Stage a th x tw window of one NHWC int8 image (C channels), top-left at
// global (gy0, gx0), into `dst` (P bytes a pixel) from byte c_off. Zero
// outside the image and in the channels [C, align4(C)).
template <int C, int P>
__device__ __forceinline__ void load_tile_i8(int8_t* dst, int c_off,
                                             const int8_t* __restrict__ img,
                                             int H, int W, int gy0, int gx0,
                                             int th, int tw) {
  constexpr int CA = align4(C);
  const int n = th * tw * CA;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % CA;
    const int p = i / CA;
    const int gy = gy0 + p / tw;
    const int gx = gx0 + p % tw;
    int8_t v = 0;
    if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = img[((size_t)gy * W + gx) * C + c];
    dst[p * P + c_off + c] = v;
  }
}

__device__ __forceinline__ void copy_words(int* dst, const int* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// acc * e + g, each step rounded on its own
__device__ __forceinline__ float affine(int acc, float e, float g) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), e), g);
}

// the int8 code of v: clip(round(v), lo, 127)
__device__ __forceinline__ int8_t code(float v, float lo) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), lo), 127.f);
}

// acc[o] += the 3x3 conv, at output pixel (oy, ox), of the G channel words
// that start at word `woff` of each pixel of `in` (pw words a pixel, a row
// iw pixels wide, the output's top-left tap at pixel 0) with the weights
// w, (9, G, COUT) words.
template <int G, int COUT>
__device__ __forceinline__ void conv3x3_i8(const int* in, int pw, int woff,
                                           int iw, int oy, int ox, const int* w,
                                           int (&acc)[COUT]) {
  static_assert(COUT % 4 == 0, "COUT must be a multiple of 4");
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int* ip = in + ((oy + ky) * iw + ox + kx) * pw + woff;
      const int4* wp = reinterpret_cast<const int4*>(w + (ky * 3 + kx) * G * COUT);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int a = ip[g];
#pragma unroll
        for (int o4 = 0; o4 < COUT / 4; ++o4) {
          const int4 wv = wp[g * (COUT / 4) + o4];
          acc[4 * o4 + 0] = __dp4a(a, wv.x, acc[4 * o4 + 0]);
          acc[4 * o4 + 1] = __dp4a(a, wv.y, acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = __dp4a(a, wv.z, acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = __dp4a(a, wv.w, acc[4 * o4 + 3]);
        }
      }
    }
  }
}

// The largest v over the block (v >= 0). Every thread calls it; `red`
// holds NTHREADS / 32 floats of shared memory. Its barriers also publish
// the shared-memory writes made before the call.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < NTHREADS / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

// Dynamic quantization of n staged floats into int8 codes: amax over the
// block (at least 1e-12), codes clip(round(v * (127/amax)), -127, 127)
// written to dst[(i / C) * P + i % C]. Returns the scale amax / 127.
template <int C, int P>
__device__ __forceinline__ float quantize_staged(const float* src, int n, float local_max,
                                                 int8_t* dst, float* red) {
  const float amax = fmaxf(block_max(local_max, red), 1e-12f);
  const float inv = __fdiv_rn(127.f, amax);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[(i / C) * P + i % C] = code(__fmul_rn(src[i], inv), -127.f);
  return __fdiv_rn(amax, 127.f);
}

// conv2 of the tile from the int8 y1 ring (CM channels) and its epilogue:
// out = relu(acc * e2 + g2) as float32 (FLOAT_OUT), or its code clipped at
// 0. `out_img` is this image's NHWC output; pixels past the image are not
// written.
template <int CM, int COUT, bool FLOAT_OUT>
__device__ __forceinline__ void conv2_static(const int8_t* y1q, const int* w2s,
                                             const float* e2s, const float* g2s,
                                             void* out_img, int H, int W, int y0,
                                             int x0) {
  const int ty = threadIdx.x / TW;
  const int tx = threadIdx.x % TW;
  const int gy = y0 + ty;
  const int gx = x0 + tx;
  if (ty >= TH || gy >= H || gx >= W) return;
  int acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = 0;
  conv3x3_i8<CM / 4, COUT>(reinterpret_cast<const int*>(y1q), CM / 4, 0, TW + 2,
                           ty, tx, w2s, acc);
  const size_t off = ((size_t)gy * W + gx) * COUT;
  if constexpr (FLOAT_OUT) {
    float4* op = reinterpret_cast<float4*>(static_cast<float*>(out_img) + off);
#pragma unroll
    for (int o4 = 0; o4 < COUT / 4; ++o4) {
      float4 v;
      v.x = fmaxf(affine(acc[4 * o4 + 0], e2s[4 * o4 + 0], g2s[4 * o4 + 0]), 0.f);
      v.y = fmaxf(affine(acc[4 * o4 + 1], e2s[4 * o4 + 1], g2s[4 * o4 + 1]), 0.f);
      v.z = fmaxf(affine(acc[4 * o4 + 2], e2s[4 * o4 + 2], g2s[4 * o4 + 2]), 0.f);
      v.w = fmaxf(affine(acc[4 * o4 + 3], e2s[4 * o4 + 3], g2s[4 * o4 + 3]), 0.f);
      op[o4] = v;
    }
  } else {
    char4* op = reinterpret_cast<char4*>(static_cast<int8_t*>(out_img) + off);
#pragma unroll
    for (int o4 = 0; o4 < COUT / 4; ++o4)
      op[o4] = make_char4(code(affine(acc[4 * o4 + 0], e2s[4 * o4 + 0], g2s[4 * o4 + 0]), 0.f),
                          code(affine(acc[4 * o4 + 1], e2s[4 * o4 + 1], g2s[4 * o4 + 1]), 0.f),
                          code(affine(acc[4 * o4 + 2], e2s[4 * o4 + 2], g2s[4 * o4 + 2]), 0.f),
                          code(affine(acc[4 * o4 + 3], e2s[4 * o4 + 3], g2s[4 * o4 + 3]), 0.f));
  }
}

// conv2 of a dynamic kernel: out = relu(acc * (d2 * sy) + t2), float32.
template <int CM, int COUT>
__device__ __forceinline__ void conv2_dynamic(const int8_t* y1q, const int* w2s,
                                              const float* d2s, const float* t2s,
                                              float sy, float* out_img, int H,
                                              int W, int y0, int x0) {
  const int ty = threadIdx.x / TW;
  const int tx = threadIdx.x % TW;
  const int gy = y0 + ty;
  const int gx = x0 + tx;
  if (ty >= TH || gy >= H || gx >= W) return;
  int acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = 0;
  conv3x3_i8<CM / 4, COUT>(reinterpret_cast<const int*>(y1q), CM / 4, 0, TW + 2,
                           ty, tx, w2s, acc);
  float4* op = reinterpret_cast<float4*>(out_img + ((size_t)gy * W + gx) * COUT);
#pragma unroll
  for (int o4 = 0; o4 < COUT / 4; ++o4) {
    float4 v;
    v.x = fmaxf(affine(acc[4 * o4 + 0], __fmul_rn(d2s[4 * o4 + 0], sy), t2s[4 * o4 + 0]), 0.f);
    v.y = fmaxf(affine(acc[4 * o4 + 1], __fmul_rn(d2s[4 * o4 + 1], sy), t2s[4 * o4 + 1]), 0.f);
    v.z = fmaxf(affine(acc[4 * o4 + 2], __fmul_rn(d2s[4 * o4 + 2], sy), t2s[4 * o4 + 2]), 0.f);
    v.w = fmaxf(affine(acc[4 * o4 + 3], __fmul_rn(d2s[4 * o4 + 3], sy), t2s[4 * o4 + 3]), 0.f);
    op[o4] = v;
  }
}

}  // namespace popcorn
