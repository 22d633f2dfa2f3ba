// mma_tf32.cuh — float32-accurate products on Hopper's tensor cores for
// the float kernels' float32 modes (double_conv.cu, up_block.cu, head.cu,
// head_bwd.cu), and the cp.async staging they use.
//
// mma.sync.m16n8k8 with TF32 operands and float32 accumulators, in the
// split-precision "3xTF32" form: each operand a is split into
//   big = a rounded to its top 19 bits (a TF32 value, to nearest) and
//   small = a - big (exact in float32, of either sign; the tensor core
//   reads its top 19 bits, so it keeps about 10 more bits of a),
// and a*b is summed as small_a*big_b + big_a*small_b + big_a*big_b. The
// dropped small_a*small_b and the truncation of small leave about 2^-21 of
// |a*b|, without a bias: rounding big to nearest gives small either sign.
// The tensor core's own accumulation is not rounded to nearest, so a sum
// over many MMAs drifts: long sums are formed in fresh accumulators of a
// few dozen MMAs and then added on the CUDA cores.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16x8, row major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8x8, k x n):      b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C (16x8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace popcorn {

__device__ __forceinline__ void split_tf32(float a, uint32_t& big, uint32_t& small) {
  const uint32_t b = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  big = b;
  small = __float_as_uint(a - __uint_as_float(b));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a*b in the 3xTF32 form, from split fragments (ab/as: A's big and
// small parts; bb/bs: B's)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

// the same with the small terms in dx and the big one in db (d = dx + db
// at the end): two independent MMA chains instead of one
__device__ __forceinline__ void mma_3xtf32(float (&dx)[4], float (&db)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(dx, as, bb[0], bb[1]);
  mma_tf32(dx, ab, bs[0], bs[1]);
  mma_tf32(db, ab, bb[0], bb[1]);
}

// A(m0.., k0..k0+7) as split fragments, a_at(row, col) reading an element
template <class AF>
__device__ __forceinline__ void load_a(AF a_at, int m0, int k0, int g, int t,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split_tf32(a_at(m0 + g, k0 + t), ab[0], as[0]);
  split_tf32(a_at(m0 + g + 8, k0 + t), ab[1], as[1]);
  split_tf32(a_at(m0 + g, k0 + t + 4), ab[2], as[2]);
  split_tf32(a_at(m0 + g + 8, k0 + t + 4), ab[3], as[3]);
}

// B(k0..k0+7, n0..n0+7) as split fragments, b_at(k, n) reading an element
template <class BF>
__device__ __forceinline__ void load_b(BF b_at, int k0, int n0, int g, int t,
                                       uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  split_tf32(b_at(k0 + t, n0 + g), bb[0], bs[0]);
  split_tf32(b_at(k0 + t + 4, n0 + g), bb[1], bs[1]);
}

// d[j] += A(m0.., k0..k0+7) * B(k0..k0+7, n0 + 8j ..) for j < NT: one
// k-step of a 16 x 8NT warp tile
template <int NT, class AF, class BF>
__device__ __forceinline__ void mma_kstep(float (&d)[NT][4], AF a_at, BF b_at,
                                          int m0, int k0, int n0, int g, int t) {
  uint32_t ab[4], as[4];
  load_a(a_at, m0, k0, g, t, ab, as);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t bb[2], bs[2];
    load_b(b_at, k0, n0 + 8 * j, g, t, bb, bs);
    mma_3xtf32(d[j], ab, as, bb, bs);
  }
}

// BYTES (4, 8 or 16) from global to shared memory, asynchronously;
// `bytes` < BYTES reads that many and zero-fills the rest (0: all zeros,
// src unread)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace popcorn
