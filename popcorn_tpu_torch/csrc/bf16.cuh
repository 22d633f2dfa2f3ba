// bf16.cuh — storage-type helpers of the float kernels' bf16 modes (A in
// double_conv.cu through conv_tile.cuh, B in up_block.cu, C in head.cu).
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

// consecutive channels of a pixel in the storage type: two (8 or 4
// bytes) or four (16 or 8 bytes), aligned
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = bf16x2(a, b);
}
__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(bf16x2(a, b), bf16x2(c, d));
}

}  // namespace popcorn
