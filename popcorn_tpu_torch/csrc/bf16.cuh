// bf16.cuh — storage-type helpers of the float kernels' bf16 modes (A in
// double_conv.cu, B in up_block.cu, C in head.cu), and their bf16 MMA.
//
// The bf16 modes keep the JAX package's rounding: bf16 values in device
// memory, float32 arithmetic on them (a bf16 value converts to float32
// exactly, and a bf16 x bf16 product is exact in float32), and a rounding
// to nearest even (__float2bfloat16_rn, as XLA's and torch's casts) where
// the Pallas kernel stores an intermediate or its output in bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace popcorn {

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to the storage type T, as a float (the bf16 kernels keep
// their rounded intermediates in float32 shared memory or registers)
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two bf16 values as one 32-bit word, lo in the low half (the order of
// an mma fragment's pair and of memory)
__device__ __forceinline__ uint32_t bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return bf16x2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// two consecutive channels of a pixel in the storage type (8 or 4 bytes),
// aligned
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = bf16x2(a, b);
}

// d += a*b on the tensor cores, mma.sync m16n8k16 with bf16 operands and
// float32 accumulators (g = lane / 4, t = lane % 4; each register a pair
// of consecutive k, the lower k in the low half):
//   A (16x16): a0 (g, 2t..), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8):  b0 (k 2t.., n g), b1 (k 2t+8.., n g)
//   C (16x8):  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace popcorn
