// int8_mma.cuh — the int8 implicit-GEMM core of the int8 kernels on
// Hopper's int8 tensor cores: the DoubleConvs E (double_conv_qs.cu) and G
// (double_conv_q.cu) and the Up blocks F (up_block_qs.cu) and H
// (up_block_q.cu), and the int8 numerics they share.
//
// Products run on mma.sync with s8 operands and s32 accumulators
// (g = lane / 4, t = lane % 4; a register holds four consecutive k):
//   m16n8k32: A (16x32) a0 (g, 4t..), a1 (g+8, 4t..), a2 (g, 16+4t..),
//             a3 (g+8, 16+4t..); B (32x8) b0 (k 4t.., n g), b1 (k 16+4t..)
//   m16n8k16: A (16x16) a0 (g, 4t..), a1 (g+8, 4t..); B b0 (k 4t.., n g)
//   C (16x8): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
// Integer sums are exact (a conv sums at most 9 * 32 * 127^2 < 2^23), so
// the codes equal those of the plain versions' float32 sums, in any order.
//
// Tiles ("planes") hold one tensor each, pixel-major, WPP 32-bit words (4
// int8 channels a word) a pixel, PW pixels a row. A K-group is four
// words; lane t reads word t of a group for its rows g and g+8, and a k32
// step takes two groups. A 3x3 conv packs its taps into K as kernel A does
// (double_conv.cu::kpos):
// - WPP = 4 (16 channels): a group is one tap (9 groups and a zero-weight
//   pad, 5 k-steps);
// - WPP = 2 (8 channels): a group is two taps of one row (dx 0, 1; then
//   dx 2 and a zero weight: 6 groups, 3 k-steps);
// - WPP = 1 (the inc's 2 or 4 input channels, the channels past 2 zero in
//   the plane and the weights): a group is one kernel row's three taps
//   and a zero-weight pad that repeats dx 0 (3 groups: one k32 step, then
//   the odd group on one m16n8k16 step).
// A group's 8 pixels x 4 words then lie in one stretch of a plane row, at
// most 8 + 2 pixels long: the 32 lanes hit distinct banks, and lanes
// that name the same word (neighbouring taps of neighbouring pixels, the
// pad) read it as one broadcast, without a swizzle. A conv's N is 8
// output channels an n-tile, one or two n-tiles sharing each A fragment.
// The weights arrive packed for __dp4a (nn/quant.py::pack_dp4a: words of
// four input channels, (taps, channel groups, Cout)) and are restaged
// once a block in fragment order, one 8-byte record a (n-tile, k-step,
// lane).
//
// Dequantization and requantization round as the plain versions (and XLA
// in the JAX package) do: a product and a sum, each rounded on its own
// (__fmul_rn/__fadd_rn, so nvcc does not contract them into an FMA), then
// a conversion to int that rounds half to even, as torch.round and
// jnp.round do.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "mma_tf32.cuh"

namespace popcorn {

// acc * e + g, each step rounded on its own
__device__ __forceinline__ float affine(int acc, float e, float g) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), e), g);
}

// the int8 code of v: clip(round(v), lo, 127), rounding half to even
// (the conversion saturates beyond the int range, which the clip covers)
__device__ __forceinline__ int8_t code(float v, float lo) {
  return (int8_t)min(max(__float2int_rn(v), (int)lo), 127);
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

namespace i8 {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// d += a*b, m16n8k32
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a*b, m16n8k16
__device__ __forceinline__ void mma_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// K-groups of a 3x3 conv over a plane of WPP words a pixel (pads
// included), and its k-steps: two groups a m16n8k32 step, and an odd last
// group alone on m16n8k16
template <int WPP>
__host__ __device__ constexpr int kgroups() {
  static_assert(WPP == 1 || WPP == 2 || WPP == 4, "planes of 4, 8 or 16 channels");
  return WPP == 4 ? 10 : WPP == 2 ? 6 : 3;
}
template <int WPP>
__host__ __device__ constexpr int ksteps() {
  return (kgroups<WPP>() + 1) / 2;
}

// Where lane t's word of K-group grp lies: the tap (dy, dx), the word of
// the pixel, and whether it is a real entry (a pad entry repeats a real
// word, which its zero weight cancels)
struct KSlot {
  int dy, dx, word;
  bool valid;
};
template <int WPP>
__device__ __forceinline__ KSlot kslot(int grp, int t) {
  if constexpr (WPP == 4) {  // one tap a group, then a pad group
    const int tap = grp < 9 ? grp : 0;
    return {tap / 3, tap % 3, t, grp < 9};
  } else if constexpr (WPP == 2) {  // taps dx 0, 1 of row grp; then dx 2 and a pad
    if (grp < 3) return {grp, t >> 1, t & 1, true};
    return {grp - 3, 2, t & 1, (t >> 1) == 0};
  } else {  // the three taps of row grp and a pad (it repeats dx 0)
    return {grp < 3 ? grp : 0, t < 3 ? t : 0, 0, grp < 3 && t < 3};
  }
}

// A 3x3 conv's packed words (9 taps, WPP groups, COUT outputs) in fragment
// order: record (n-tile j, k-step s, lane) holds the lane's words of
// groups 2s and 2s+1 for output channel 8j + lane / 4
template <int WPP, int COUT = 8>
__device__ __forceinline__ void stage_conv_weights(uint2* dst, const int* __restrict__ w) {
  constexpr int KS = ksteps<WPP>();
  for (int i = threadIdx.x; i < COUT / 8 * KS * 32; i += blockDim.x) {
    const int lane = i & 31, s = (i >> 5) % KS, t = lane & 3;
    const int n = 8 * ((i >> 5) / KS) + (lane >> 2);
    uint32_t v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const KSlot p = kslot<WPP>(2 * s + h, t);
      v[h] = p.valid ? (uint32_t)__ldg(w + ((p.dy * 3 + p.dx) * WPP + p.word) * COUT + n) : 0u;
    }
    dst[i] = make_uint2(v[0], v[1]);
  }
}

// The transposed conv's packed words (4 taps, C1/4 groups, CU) as k16
// fragments: record (n-tile j, lane) is the word of input channels 4t..
// for output column n = 8j + lane/4, which is tap n / CU, channel n % CU
template <int C1, int CU>
__device__ __forceinline__ void stage_tconv_weights(uint32_t* dst, const int* __restrict__ w) {
  constexpr int G = C1 / 4, NT = 4 * CU / 8;
  for (int i = threadIdx.x; i < NT * 32; i += blockDim.x) {
    const int lane = i & 31, n = 8 * (i >> 5) + (lane >> 2), t = lane & 3;
    dst[i] = t < G ? (uint32_t)__ldg(w + ((n / CU) * G + t) * CU + n % CU) : 0u;
  }
}

// acc[m][j] += the 3x3 conv of the plane (WPP words a pixel, PW pixels a
// row) for NM M tiles whose lane rows g and g+8 have their top-left tap at
// plane pixels lo[m] and hi[m], and NT n-tiles (8 output channels each)
// of the fragment-order weights wf
template <int WPP, int PW, int NM, int NT>
__device__ __forceinline__ void conv3x3(int (&acc)[NM][NT][4], const uint32_t* plane,
                                        const int (&lo)[NM], const int (&hi)[NM],
                                        const uint2* wf, int lane) {
  constexpr int KS = ksteps<WPP>(), NG = kgroups<WPP>();
  const int t = lane & 3;
  int off[2 * KS];
#pragma unroll
  for (int grp = 0; grp < 2 * KS; ++grp) {
    const KSlot p = kslot<WPP>(grp, t);
    off[grp] = (p.dy * PW + p.dx) * WPP + p.word;
  }
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint2 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = wf[(j * KS + s) * 32 + lane];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const uint32_t* pl = plane + lo[m] * WPP;
      const uint32_t* ph = plane + hi[m] * WPP;
      if (2 * s + 1 < NG) {
        const uint32_t a[4] = {pl[off[2 * s]], ph[off[2 * s]], pl[off[2 * s + 1]],
                               ph[off[2 * s + 1]]};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_k32(acc[m][j], a, b[j].x, b[j].y);
      } else {  // the odd last group
        const uint32_t a0 = pl[off[2 * s]], a1 = ph[off[2 * s]];
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_k16(acc[m][j], a0, a1, b[j].x);
      }
    }
  }
}

// acc[j] += the transposed conv's products for the coarse pixels lo (row
// g) and hi (row g+8) of a plane of C1/4 words a pixel: K = C1 (8 or 16,
// zero-padded to 16), N = 4 taps x CU in NT n-tiles
template <int C1, int NT>
__device__ __forceinline__ void tconv(int (&acc)[NT][4], const uint32_t* plane, int lo,
                                      int hi, const uint32_t* wtf, int lane) {
  constexpr int WC = C1 / 4;
  const int t = lane & 3;
  const uint32_t a0 = t < WC ? plane[lo * WC + t] : 0u;
  const uint32_t a1 = t < WC ? plane[hi * WC + t] : 0u;
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_k16(acc[j], a0, a1, wtf[j * 32 + lane]);
}

// a[k] for a k known only at run time, without indexing into local memory
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int k) {
  float v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (i == k) v = a[i];
  return v;
}

// four codes as one word, the first in the low byte
__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) | ((uint32_t)(uint8_t)c << 16) |
         ((uint32_t)(uint8_t)d << 24);
}

// two codes at byte p of shared memory (p even)
__device__ __forceinline__ void put2(int8_t* p, int8_t a, int8_t b) {
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)((uint8_t)a | ((uint32_t)(uint8_t)b << 8));
}

// two output channels in the output type: int8 codes (clipped at 0),
// float32 or bf16 values
__device__ __forceinline__ void put_out(int8_t* p, float a, float b) {
  put2(p, code(a, 0.f), code(b, 0.f));
}
__device__ __forceinline__ void put_out(float* p, float a, float b) { store2(p, a, b); }
__device__ __forceinline__ void put_out(__nv_bfloat16* p, float a, float b) { store2(p, a, b); }

// four consecutive elements of shared memory as floats (exact for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Stage n pixels of PB bytes (2, or a multiple of 4) into shared memory:
// pixel i from src(i), or zeros where src(i) is null. `vec`: every pixel
// is aligned to its pieces (16 bytes, or PB below 16), which then arrive
// by cp.async (the caller commits and waits; `any` is a global address
// that a zero-filled piece names and does not read); else word by word,
// from bytes. A 2-byte pixel (two int8 channels) becomes a word whose
// upper half is zero, by ordinary loads (cp.async copies 4 bytes at least).
template <int PB, class SRC>
__device__ __forceinline__ void stage_pixels(unsigned char* dst, int n, SRC src,
                                             const void* any, bool vec) {
  constexpr int PC = PB < 16 ? PB : 16, NP = PB / PC;
  if constexpr (PB == 2) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned char* s = src(i);
      uint32_t v = 0;
      if (s)
        v = vec ? (uint32_t)*reinterpret_cast<const uint16_t*>(s)
                : (uint32_t)s[0] | ((uint32_t)s[1] << 8);
      reinterpret_cast<uint32_t*>(dst)[i] = v;
    }
  } else if (vec) {
    for (int i = threadIdx.x; i < n * NP; i += blockDim.x) {
      const unsigned char* s = src(i / NP);
      cp_async<PC>(dst + i * PC, s ? s + (i % NP) * PC : any, s ? PC : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * (PB / 4); i += blockDim.x) {
      const unsigned char* s = src(i / (PB / 4));
      uint32_t v = 0;
      if (s) {
        s += (i % (PB / 4)) * 4;
        v = (uint32_t)s[0] | ((uint32_t)s[1] << 8) | ((uint32_t)s[2] << 16) |
            ((uint32_t)s[3] << 24);
      }
      reinterpret_cast<uint32_t*>(dst)[i] = v;
    }
  }
}

// The largest of each of NV values over the block, every thread calling
// with its own v. `red` holds WARPS * NV floats of shared memory used by
// no other call; the one barrier also publishes the writes made before.
template <int NV>
__device__ __forceinline__ void block_max(float (&v)[NV], float* red) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < NV; ++k) red[(threadIdx.x >> 5) * NV + k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    v[k] = red[k];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) v[k] = fmaxf(v[k], red[i * NV + k]);
  }
}

// Copy an OH x OW output region staged in shared memory (pixel-major, PB
// bytes a pixel) to this image's NHWC output at (y0, x0), clipped to the
// image: 16-byte stores, or 8-byte ones where a row of 8-byte pixels
// starts off 16-byte alignment
template <int PB>
__device__ __forceinline__ void copy_out(unsigned char* img, const unsigned char* st, int H,
                                         int W, int y0, int x0, int OH, int OW) {
  const int rb = min(OW, W - x0) * PB;  // bytes a row
  const int per = (rb + 15) / 16;
  for (int i = threadIdx.x; i < OH * per; i += blockDim.x) {
    const int r = i / per, k = i % per;
    if (y0 + r >= H) break;
    unsigned char* d = img + ((size_t)(y0 + r) * W + x0) * PB + 16 * k;
    const unsigned char* s = st + r * OW * PB + 16 * k;
    if (rb - 16 * k >= 16 && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
      if (rb - 16 * k >= 16)
        *reinterpret_cast<uint2*>(d + 8) = *reinterpret_cast<const uint2*>(s + 8);
    }
  }
}

}  // namespace i8
}  // namespace popcorn
