// up_block.cu — kernel B: one UNet Up block fused in one launch.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _up_block_kernel (public wrapper fused_up_block), on plain NHWC tensors:
//   up  = conv_transpose_2x2(x1) + bt, zero-padded to the skip's size
//         (nn/ops.py::pad_to_match: the pad ring gets no bt);
//   y1  = relu(conv3x3([skip | up]) * s1 + t1), zero outside the image;
//   out = relu(conv3x3(y1) * s2 + t2).
// The upsampled value at fine pixel (y, x) is
//   x1[(y-oy)/2, (x-ox)/2, :] @ Wt[:, (y-oy)%2, (x-ox)%2, :] + bt
// inside [oy, oy+2h) x [ox, ox+2w), and 0 outside, where
// oy = (H-2h)//2 and ox = (W-2w)//2.
//
// The storage type T is float or bf16. In bf16 the kernel rounds where
// _up_block_kernel does at cdt = bf16: x1, the skip and the weights are
// bf16, the transposed conv sums in float32 and its output is rounded to
// bf16 after the bias (pallas_conv.py:521), y1 is rounded to bf16, the
// output is bf16; the affines are float32. Every bf16 value is exact in
// TF32, so the bf16 mode runs the same MMAs with one TF32 pass a product
// (the split's small parts are zero) and float32 accumulators.
//
// What bounds it on the H100: the two convs' arithmetic, 9*(Cs+Cu)*Cm +
// 9*Cm*Cout multiply-adds a fine pixel (2,880 at up2, 1,728 at up1)
// against 4*(Cs + Cu/4 + Cout) bytes read and written; the unfused block
// would also write the upsampled map, the concatenation and y1 to device
// memory and read them back. The first design ran the convs as per-pixel
// FMA chains on the CUDA cores, each thread reading its pixel's channels
// from a pixel-major tile: a warp's loads fell into one bank (up to 32-way
// conflicts), and its 16x16 tile spent 27% more on the y1 ring and 56%
// more on the transposed conv's halo.
//
// Design. conv1 and conv2 are implicit GEMMs on the tensor cores,
// mma.sync.m16n8k8 in the 3xTF32 form (mma_tf32.cuh), float32-accurate:
// M = 16 pixels of a tile row, N = 8 = Cm = Cout, K = 8 channels a step,
// for each of the 9 taps. A block of 256 threads owns a TH x 30 output
// tile (TH = 14 at 32 conv1 channels, 28 at 16, so that two blocks fit on
// an SM); its y1 ring is (TH+2) x 32 (two M tiles a row) and its input
// tile (TH+4) x 34. The skip channels arrive by cp.async; the upsampled
// channels are computed beside them on the CUDA cores from the coarse
// input (64-256 multiply-adds a pixel), so no concatenation or upsampled
// map reaches device memory. Each pixel's channel vector is stored with
// its 4-channel groups XOR-permuted by the pixel index (``chan``): the 32
// lanes of an A fragment (8 pixels x 4 channels) then hit 32 distinct
// banks at 8, 16 and 32 channels a pixel. Each warp runs two rows at a
// time (four M tiles, eight independent MMA chains; conv1 at 32 channels
// one row) and splits each weight fragment once for all its tiles.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "mma_tf32.cuh"

namespace popcorn {

constexpr int UB_THREADS = 256;
constexpr int UB_TW = 30;  // output tile width
constexpr int UB_RW = 32;  // y1 ring width: two M tiles of 16
constexpr int UB_IW = 34;  // input tile width
constexpr int UB_CM = 8;   // Cm = Cout = N of the MMA

// output tile rows for CC conv1 input channels: two blocks an SM
template <int CC>
__host__ __device__ constexpr int ub_rows() {
  return CC == 32 ? 14 : 28;
}

// The float offset of channel ch of tile pixel pix, at C (8, 16 or 32)
// channels a pixel: groups of 4 channels XOR-permuted by the pixel bits
// that the pixel stride leaves out of the bank index, so 8 consecutive
// pixels x 4 channels fall into 32 distinct banks.
template <int C>
__device__ __forceinline__ int chan(int pix, int ch) {
  constexpr int SH = C == 32 ? 0 : (C == 16 ? 1 : 2);
  return pix * C + (ch ^ (((pix >> SH) & (C / 4 - 1)) << 2));
}

// d[m] += conv3x3 over C channels for the NM M tiles whose top-left tap
// is tile pixel base[m] (16 pixels along a row of RS pixels), with HWIO
// weights w (3, 3, C, 8): 9 taps x C/8 k-steps, each weight fragment
// split once for the NM tiles, and two accumulator chains a tile
// (mma_3xtf32's small and big terms; the caller adds them). EXACT: the
// operands are exact in TF32 (bf16 values), one MMA a product.
template <int C, int RS, int NM, bool EXACT>
__device__ __forceinline__ void conv3x3_mma(float (&d)[NM][2][4], const float* src,
                                            const int (&base)[NM], const float* w, int g,
                                            int t) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * RS + tap % 3;
    const float* wk = w + tap * C * UB_CM;
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 8) {
      auto b_at = [wk](int k, int n) { return wk[k * UB_CM + n]; };
      uint32_t bb[2], bs[2];
      if constexpr (EXACT) {
        bb[0] = __float_as_uint(b_at(k0 + t, g));
        bb[1] = __float_as_uint(b_at(k0 + t + 4, g));
      } else {
        load_b(b_at, k0, 0, g, t, bb, bs);
      }
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int p = base[m] + off;
        auto a_at = [src, p](int r, int c) { return src[chan<C>(p + r, c)]; };
        if constexpr (EXACT) {
          const uint32_t a[4] = {__float_as_uint(a_at(g, k0 + t)),
                                 __float_as_uint(a_at(g + 8, k0 + t)),
                                 __float_as_uint(a_at(g, k0 + t + 4)),
                                 __float_as_uint(a_at(g + 8, k0 + t + 4))};
          mma_tf32(d[m][1], a, bb[0], bb[1]);
        } else {
          uint32_t ab[4], as[4];
          load_a(a_at, 0, k0, g, t, ab, as);
          mma_3xtf32(d[m][0], d[m][1], ab, as, bb, bs);
        }
      }
    }
  }
}

template <int C1, int CS, int CU>
constexpr int up_block_smem_floats() {
  constexpr int CC = CS + CU, TH = ub_rows<CC>();
  return (TH + 4) * UB_IW * CC + (TH + 2) * UB_RW * UB_CM + 9 * CC * UB_CM +
         9 * UB_CM * UB_CM + C1 * 4 * CU + CU + 4 * UB_CM;
}

template <class T, int C1, int CS, int CU>
__global__ void __launch_bounds__(UB_THREADS, 2)
    up_block_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                    const T* __restrict__ wt, const float* __restrict__ bt,
                    const T* __restrict__ w1, const float* __restrict__ s1,
                    const float* __restrict__ t1, const T* __restrict__ w2,
                    const float* __restrict__ s2, const float* __restrict__ t2,
                    T* __restrict__ out, int H, int W, int h, int w, int oy,
                    int ox) {
  constexpr int CC = CS + CU, TH = ub_rows<CC>(), IH = TH + 4, RH = TH + 2;
  constexpr int CM = UB_CM, NW = UB_THREADS / 32;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(CS % 4 == 0 && CU % 4 == 0 && (CC == 16 || CC == 32),
                "conv1 takes 16 or 32 channels in groups of 4");
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                     // IH x IW x CC, [skip | up]
  float* ring = tile + IH * UB_IW * CC;   // RH x RW x CM, y1
  float* w1s = ring + RH * UB_RW * CM;    // (3, 3, CC, CM)
  float* w2s = w1s + 9 * CC * CM;         // (3, 3, CM, CM)
  float* wts = w2s + 9 * CM * CM;         // (C1, 2, 2, CU)
  float* bts = wts + C1 * 4 * CU;
  float* aff = bts + CU;                  // s1, t1, s2, t2
  const int b = blockIdx.z, tid = threadIdx.x;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * UB_TW;

  // the skip channels of the input tile (global origin y0-2, x0-2), zero
  // outside the image: the SAME padding of conv1. float32 arrives by
  // cp.async; bf16 is widened to float32 on the way
  const T* x2b = x2 + (size_t)b * H * W * CS;
  for (int i = tid; i < IH * UB_IW * (CS / 4); i += UB_THREADS) {
    const int pix = i / (CS / 4), c4 = i % (CS / 4);
    const int gy = y0 - 2 + pix / UB_IW, gx = x0 - 2 + pix % UB_IW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* src = x2b + ((size_t)gy * W + gx) * CS + 4 * c4;
    float* dst = tile + chan<CC>(pix, 4 * c4);
    if constexpr (BF16) {
      uint2 v = in ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0u, 0u);
      const __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&v.x);
      const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&v.y);
      *reinterpret_cast<float4*>(dst) = make_float4(__low2float(lo), __high2float(lo),
                                                    __low2float(hi), __high2float(hi));
    } else {
      cp_async<16>(dst, in ? src : x2b, in ? 16 : 0);
    }
  }
  cp_async_commit();
  for (int i = tid; i < 9 * CC * CM; i += UB_THREADS) w1s[i] = load_as_float(w1 + i);
  for (int i = tid; i < 9 * CM * CM; i += UB_THREADS) w2s[i] = load_as_float(w2 + i);
  for (int i = tid; i < C1 * 4 * CU; i += UB_THREADS) wts[i] = load_as_float(wt + i);
  if (tid < CU) bts[tid] = __ldg(bt + tid);
  if (tid < CM) {
    aff[tid] = __ldg(s1 + tid);
    aff[CM + tid] = __ldg(t1 + tid);
    aff[2 * CM + tid] = __ldg(s2 + tid);
    aff[3 * CM + tid] = __ldg(t2 + tid);
  }
  __syncthreads();

  // the upsampled channels beside them, from the coarse input: the sum,
  // then the bias, rounded to T (0 outside the upsampled region)
  const T* x1b = x1 + (size_t)b * h * w * C1;
  for (int pix = tid; pix < IH * UB_IW; pix += UB_THREADS) {
    const int gy = y0 - 2 + pix / UB_IW, gx = x0 - 2 + pix % UB_IW;
    const int uy = gy - oy, ux = gx - ox;
    float acc[CU];
#pragma unroll
    for (int o = 0; o < CU; ++o) acc[o] = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && uy >= 0 && uy < 2 * h && ux >= 0 &&
        ux < 2 * w) {
      const T* xp = x1b + ((size_t)(uy >> 1) * w + (ux >> 1)) * C1;
      const float4* wp =
          reinterpret_cast<const float4*>(wts + ((uy & 1) * 2 + (ux & 1)) * CU);
#pragma unroll 4
      for (int c = 0; c < C1; ++c) {
        const float v = load_as_float(xp + c);
        // Wt is (C1, 2, 2, CU): input channel c strides 4*CU floats
#pragma unroll
        for (int o4 = 0; o4 < CU / 4; ++o4) {
          const float4 wv = wp[c * CU + o4];
          acc[4 * o4 + 0] = fmaf(v, wv.x, acc[4 * o4 + 0]);
          acc[4 * o4 + 1] = fmaf(v, wv.y, acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = fmaf(v, wv.z, acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = fmaf(v, wv.w, acc[4 * o4 + 3]);
        }
      }
#pragma unroll
      for (int o = 0; o < CU; ++o) acc[o] = round_to<T>(acc[o] + bts[o]);
    }
#pragma unroll
    for (int o4 = 0; o4 < CU / 4; ++o4)
      *reinterpret_cast<float4*>(tile + chan<CC>(pix, CS + 4 * o4)) =
          make_float4(acc[4 * o4], acc[4 * o4 + 1], acc[4 * o4 + 2], acc[4 * o4 + 3]);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // conv1 on the ring (global origin y0-1, x0-1): a warp takes RPW ring
  // rows at a time, two M tiles each (one row at 32 channels, where two
  // would spill registers); y1 = 0 where the ring leaves the image
  constexpr int RPW = CC == 32 ? 1 : 2;
  static_assert(RH % RPW == 0 && TH % 2 == 0, "rows go to the warps in whole groups");
  for (int ry = RPW * warp; ry < RH; ry += RPW * NW) {
    float d[2 * RPW][2][4] = {};
    int base[2 * RPW];
#pragma unroll
    for (int m = 0; m < 2 * RPW; ++m) base[m] = (ry + m / 2) * UB_IW + 16 * (m % 2);
    conv3x3_mma<CC, UB_IW, 2 * RPW, BF16>(d, tile, base, w1s, g, t);
    const float sa = aff[2 * t], sb = aff[2 * t + 1];
    const float ta = aff[CM + 2 * t], tb = aff[CM + 2 * t + 1];
#pragma unroll
    for (int m = 0; m < 2 * RPW; ++m) {
      const int r = ry + m / 2, gy = y0 - 1 + r;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rx = 16 * (m % 2) + g + 8 * hh, gx = x0 - 1 + rx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float va = d[m][0][2 * hh] + d[m][1][2 * hh];
        const float vb = d[m][0][2 * hh + 1] + d[m][1][2 * hh + 1];
        *reinterpret_cast<float2*>(ring + chan<CM>(r * UB_RW + rx, 2 * t)) =
            make_float2(in ? round_to<T>(fmaxf(fmaf(va, sa, ta), 0.f)) : 0.f,
                        in ? round_to<T>(fmaxf(fmaf(vb, sb, tb), 0.f)) : 0.f);
      }
    }
  }
  __syncthreads();

  // conv2 on the output tile: a warp takes two rows at a time, each as two
  // M tiles at x 0 and 14 (the second stores x >= 16)
  const float sa = aff[2 * CM + 2 * t], sb = aff[2 * CM + 2 * t + 1];
  const float ta = aff[3 * CM + 2 * t], tb = aff[3 * CM + 2 * t + 1];
  for (int ty = 2 * warp; ty < TH; ty += 2 * NW) {
    if (y0 + ty >= H) break;
    float d[4][2][4] = {};
    const int base[4] = {ty * UB_RW, ty * UB_RW + 14, (ty + 1) * UB_RW,
                         (ty + 1) * UB_RW + 14};
    conv3x3_mma<CM, UB_RW, 4, BF16>(d, ring, base, w2s, g, t);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int gy = y0 + ty + m / 2;
      T* orow = out + ((size_t)b * H + gy) * W * CM;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int px = g + 8 * hh, gx = x0 + 14 * (m % 2) + px;
        const float va = d[m][0][2 * hh] + d[m][1][2 * hh];
        const float vb = d[m][0][2 * hh + 1] + d[m][1][2 * hh + 1];
        if ((m % 2 == 0 || px >= 2) && gy < H && gx < W)
          store2(orow + (size_t)gx * CM + 2 * t, fmaxf(fmaf(va, sa, ta), 0.f),
                 fmaxf(fmaf(vb, sb, tb), 0.f));
      }
    }
  }
}

template <class T, int C1, int CS, int CU>
int launch_up(const T* x1, const T* x2, const T* wt, const float* bt, const T* w1,
              const float* s1, const float* t1, const T* w2, const float* s2,
              const float* t2, T* out, int B, int H, int W, int h, int w, int oy, int ox,
              cudaStream_t stream) {
  constexpr int TH = ub_rows<CS + CU>();
  constexpr size_t smem = sizeof(float) * up_block_smem_floats<C1, CS, CU>();
  auto kern = up_block_kernel<T, C1, CS, CU>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + UB_TW - 1) / UB_TW, (H + TH - 1) / TH, B);
  kern<<<grid, UB_THREADS, smem, stream>>>(x1, x2, wt, bt, w1, s1, t1, w2, s2, t2, out, H,
                                           W, h, w, oy, ox);
  return (int)cudaGetLastError();
}

}  // namespace popcorn

namespace popcorn {

template <class T>
int launch_up_any(const T* x1, const T* x2, const T* wt, const float* bt, const T* w1,
                  const float* s1, const float* t1, const T* w2, const float* s2,
                  const float* t2, T* out, int B, int H, int W, int h, int w, int oy, int ox,
                  int c1, int cs, int cu, int cm, int cout, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(x2) % 16 != 0) return -1;
#define POPCORN_UP(A, S, U, M, O)                                                       \
  if (c1 == A && cs == S && cu == U && cm == M && cout == O)                            \
    return launch_up<T, A, S, U>(x1, x2, wt, bt, w1, s1, t1, w2, s2, t2, out, B, H, W, h, \
                                 w, oy, ox, st);
  POPCORN_UP(16, 16, 16, 8, 8)
  POPCORN_UP(8, 8, 8, 8, 8)
#undef POPCORN_UP
  return -1;
}

}  // namespace popcorn

// x2 16-byte aligned (the skip is staged by 16-byte copies). Returns a
// cudaError_t (0 on success), or -1 for a channel combination that has no
// instantiation or a misaligned skip.
extern "C" int popcorn_up_block_f32(const float* x1, const float* x2, const float* wt,
                                    const float* bt, const float* w1, const float* s1,
                                    const float* t1, const float* w2, const float* s2,
                                    const float* t2, float* out, int B, int H, int W, int h,
                                    int w, int oy, int ox, int c1, int cs, int cu, int cm,
                                    int cout, void* stream) {
  return popcorn::launch_up_any(x1, x2, wt, bt, w1, s1, t1, w2, s2, t2, out, B, H, W, h, w,
                                oy, ox, c1, cs, cu, cm, cout,
                                static_cast<cudaStream_t>(stream));
}

// The bf16 mode: bf16 inputs, weights and output; float32 tconv bias and
// affine vectors.
extern "C" int popcorn_up_block_bf16(const __nv_bfloat16* x1, const __nv_bfloat16* x2,
                                     const __nv_bfloat16* wt, const float* bt,
                                     const __nv_bfloat16* w1, const float* s1,
                                     const float* t1, const __nv_bfloat16* w2,
                                     const float* s2, const float* t2, __nv_bfloat16* out,
                                     int B, int H, int W, int h, int w, int oy, int ox,
                                     int c1, int cs, int cu, int cm, int cout, void* stream) {
  return popcorn::launch_up_any(x1, x2, wt, bt, w1, s1, t1, w2, s2, t2, out, B, H, W, h, w,
                                oy, ox, c1, cs, cu, cm, cout,
                                static_cast<cudaStream_t>(stream));
}
