// up_block_q.cu — kernel H: the dynamic-scale int8 (W8A8) Up block in one
// launch.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _up_block_kernel_q (fused_up_block with quantized=True), on unpacked
// NHWC tensors with float32 in and out. Per 16x16 output tile, with the
// 2-pixel halo and 0 outside the image:
//   x1q = the coarse input gathered at every fine pixel of the upsampled
//         region (0 elsewhere), quantized at its own scale s1x;
//   up  = tconv(x1q) * (dt[tap] * s1x) + tt there, 0 elsewhere (on
//         pad_to_match's ring too), quantized at its own scale su;
//   x2q = the skip tile quantized at its own scale s2x;
//   y1  = relu((conv3x3(x2q; wa) * (da * s2x) + conv3x3(upq; wb) *
//         (db * su)) + t1) on the ring, 0 outside the image, at scale sy;
//   out = relu(conv3x3(y1q) * (d2 * sy) + t2).
// Each scale is amax / 127 over its tile (the JAX package's _quantize_slab
// over a TPU slab); the plain version (nn/up_block.py::up_block_q_plain)
// cuts the image into the same tiles. The tconv's weight scales are per
// (tap, output channel), picked by the fine pixel's parity (see
// up_block_qs.cu).
//
// What bounds it on the H100: int8 operations, as kernel E; __dp4a on the
// CUDA cores, plus four block-wide max reductions.
//
// Design: kernel F's tiling with float staging: each quantized tensor is
// first written as float32 into one shared buffer while each thread keeps
// the max |v| of what it wrote, then reduced and coded into the int8
// tiles: [skip | up] per pixel for conv1, the coarse codes for the tconv,
// the y1 ring for conv2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile_i8.cuh"

namespace popcorn {

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C1, int CS, int CU, int CM, int COUT>
struct UpQLayout {
  static constexpr int P = CS + CU;
  static constexpr int NX = (TH + 4) * (TW + 4);
  static constexpr int NR = (TH + 2) * (TW + 2);
  static constexpr int F = align4(cmax(cmax(NX * CS, NX * C1), cmax(NX * CU, NR * CM)));
  static constexpr int XT = align16(NX * P);
  static constexpr int X1 = align16(NX * C1);
  static constexpr int YT = align16(NR * CM);
  static constexpr int WT = 4 * (C1 / 4) * CU;  // int32 words
  static constexpr int WA = 9 * (CS / 4) * CM;
  static constexpr int WB = 9 * (CU / 4) * CM;
  static constexpr int W2 = 9 * (CM / 4) * COUT;
  static constexpr int bytes = 4 * F + XT + X1 + YT + 4 * (WT + WA + WB + W2) +
                               4 * (5 * CU + 3 * CM + 2 * COUT) + 4 * (NTHREADS / 32);
};

template <int C1, int CS, int CU, int CM, int COUT>
__global__ void __launch_bounds__(NTHREADS)
    up_block_q_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                      const int* __restrict__ wt, const float* __restrict__ dt,
                      const float* __restrict__ tt, const int* __restrict__ wa,
                      const float* __restrict__ da, const int* __restrict__ wb,
                      const float* __restrict__ db, const float* __restrict__ t1,
                      const int* __restrict__ w2, const float* __restrict__ d2,
                      const float* __restrict__ t2, float* __restrict__ out, int H,
                      int W, int h, int w, int oy, int ox) {
  using L = UpQLayout<C1, CS, CU, CM, COUT>;
  static_assert(C1 % 4 == 0 && CS % 4 == 0 && CU % 4 == 0 && CM % 4 == 0 && COUT % 4 == 0,
                "channel counts must be multiples of 4");
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  int8_t* tile = reinterpret_cast<int8_t*>(stage + L::F);  // [skip | up] codes
  int8_t* x1q = tile + L::XT;
  int8_t* y1q = x1q + L::X1;
  int* wts = reinterpret_cast<int*>(y1q + L::YT);
  int* was = wts + L::WT;
  int* wbs = was + L::WA;
  int* w2s = wbs + L::WB;
  float* dts = reinterpret_cast<float*>(w2s + L::W2);  // (4 taps, CU)
  float* tts = dts + 4 * CU;
  float* das = tts + CU;
  float* dbs = das + CM;
  float* t1s = dbs + CM;
  float* d2s = t1s + CM;
  float* t2s = d2s + COUT;
  float* red = t2s + COUT;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  constexpr int XW = TW + 4;
  auto in_image = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };
  auto in_up = [&](int uy, int ux) { return uy >= 0 && uy < 2 * h && ux >= 0 && ux < 2 * w; };

  // the skip tile
  const float* x2b = x2 + (size_t)b * H * W * CS;
  float m = 0.f;
  for (int i = threadIdx.x; i < L::NX * CS; i += blockDim.x) {
    const int p = i / CS;
    const int gy = y0 - 2 + p / XW;
    const int gx = x0 - 2 + p % XW;
    const float v = in_image(gy, gx) ? __ldg(x2b + ((size_t)gy * W + gx) * CS + i % CS) : 0.f;
    stage[i] = v;
    m = fmaxf(m, fabsf(v));
  }
  copy_words(wts, wt, L::WT);
  copy_words(was, wa, L::WA);
  copy_words(wbs, wb, L::WB);
  copy_words(w2s, w2, L::W2);
  copy_to_shared(dts, dt, 4 * CU);
  copy_to_shared(tts, tt, CU);
  copy_to_shared(das, da, CM);
  copy_to_shared(dbs, db, CM);
  copy_to_shared(t1s, t1, CM);
  copy_to_shared(d2s, d2, COUT);
  copy_to_shared(t2s, t2, COUT);
  const float s2x = quantize_staged<CS, L::P>(stage, L::NX * CS, m, tile, red);
  __syncthreads();

  // the coarse input gathered at the fine pixels of the tile
  const float* x1b = x1 + (size_t)b * h * w * C1;
  m = 0.f;
  for (int i = threadIdx.x; i < L::NX * C1; i += blockDim.x) {
    const int p = i / C1;
    const int gy = y0 - 2 + p / XW;
    const int gx = x0 - 2 + p % XW;
    const int uy = gy - oy;
    const int ux = gx - ox;
    float v = 0.f;
    if (in_image(gy, gx) && in_up(uy, ux))
      v = __ldg(x1b + ((size_t)(uy >> 1) * w + (ux >> 1)) * C1 + i % C1);
    stage[i] = v;
    m = fmaxf(m, fabsf(v));
  }
  const float s1x = quantize_staged<C1, C1>(stage, L::NX * C1, m, x1q, red);
  __syncthreads();

  // the up tile, float
  m = 0.f;
  for (int p = threadIdx.x; p < L::NX; p += blockDim.x) {
    const int gy = y0 - 2 + p / XW;
    const int gx = x0 - 2 + p % XW;
    const int uy = gy - oy;
    const int ux = gx - ox;
    float* dst = stage + p * CU;
    if (in_image(gy, gx) && in_up(uy, ux)) {
      const int tap = (uy & 1) * 2 + (ux & 1);
      const int* xp = reinterpret_cast<const int*>(x1q + p * C1);
      const int4* wp = reinterpret_cast<const int4*>(wts + tap * (C1 / 4) * CU);
      int acc[CU];
#pragma unroll
      for (int o = 0; o < CU; ++o) acc[o] = 0;
#pragma unroll
      for (int g = 0; g < C1 / 4; ++g) {
        const int a = xp[g];
#pragma unroll
        for (int o4 = 0; o4 < CU / 4; ++o4) {
          const int4 wv = wp[g * (CU / 4) + o4];
          acc[4 * o4 + 0] = __dp4a(a, wv.x, acc[4 * o4 + 0]);
          acc[4 * o4 + 1] = __dp4a(a, wv.y, acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = __dp4a(a, wv.z, acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = __dp4a(a, wv.w, acc[4 * o4 + 3]);
        }
      }
#pragma unroll
      for (int o = 0; o < CU; ++o) {
        const float v = affine(acc[o], __fmul_rn(dts[tap * CU + o], s1x), tts[o]);
        dst[o] = v;
        m = fmaxf(m, fabsf(v));
      }
    } else {
#pragma unroll
      for (int o = 0; o < CU; ++o) dst[o] = 0.f;
    }
  }
  // codes into the up half of each pixel of the conv1 tile
  const float su = quantize_staged<CU, L::P>(stage, L::NX * CU, m, tile + CS, red);
  __syncthreads();

  // y1 on the ring, float
  constexpr int RW = TW + 2;
  m = 0.f;
  for (int p = threadIdx.x; p < L::NR; p += blockDim.x) {
    const int ry = p / RW;
    const int rx = p % RW;
    float* dst = stage + p * CM;
    if (in_image(y0 - 1 + ry, x0 - 1 + rx)) {
      int acc_a[CM], acc_b[CM];
#pragma unroll
      for (int o = 0; o < CM; ++o) acc_a[o] = acc_b[o] = 0;
      const int* t = reinterpret_cast<const int*>(tile);
      conv3x3_i8<CS / 4, CM>(t, L::P / 4, 0, TW + 4, ry, rx, was, acc_a);
      conv3x3_i8<CU / 4, CM>(t, L::P / 4, CS / 4, TW + 4, ry, rx, wbs, acc_b);
#pragma unroll
      for (int o = 0; o < CM; ++o) {
        const float v = __fadd_rn(
            __fadd_rn(__fmul_rn(__int2float_rn(acc_a[o]), __fmul_rn(das[o], s2x)),
                      __fmul_rn(__int2float_rn(acc_b[o]), __fmul_rn(dbs[o], su))),
            t1s[o]);
        dst[o] = fmaxf(v, 0.f);
        m = fmaxf(m, dst[o]);
      }
    } else {
#pragma unroll
      for (int o = 0; o < CM; ++o) dst[o] = 0.f;
    }
  }
  const float sy = quantize_staged<CM, CM>(stage, L::NR * CM, m, y1q, red);
  __syncthreads();

  conv2_dynamic<CM, COUT>(y1q, w2s, d2s, t2s, sy, out + (size_t)b * H * W * COUT, H, W,
                          y0, x0);
}

template <int C1, int CS, int CU, int CM, int COUT>
int launch_up_q(const float* x1, const float* x2, const int* wt, const float* dt,
                const float* tt, const int* wa, const float* da, const int* wb,
                const float* db, const float* t1, const int* w2, const float* d2,
                const float* t2, float* out, int B, int H, int W, int h, int w, int oy,
                int ox, cudaStream_t stream) {
  constexpr size_t smem = UpQLayout<C1, CS, CU, CM, COUT>::bytes;
  auto kern = up_block_q_kernel<C1, CS, CU, CM, COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(x1, x2, wt, dt, tt, wa, da, wb, db, t1, w2, d2,
                                         t2, out, H, W, h, w, oy, ox);
  return (int)cudaGetLastError();
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation. Weights packed as for kernel F.
extern "C" int popcorn_up_block_q(const float* x1, const float* x2, const int* wt,
                                  const float* dt, const float* tt, const int* wa,
                                  const float* da, const int* wb, const float* db,
                                  const float* t1, const int* w2, const float* d2,
                                  const float* t2, float* out, int B, int H, int W,
                                  int h, int w, int oy, int ox, int c1, int cs, int cu,
                                  int cm, int cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POPCORN_UPQ(A, S, U, M, O)                                                     \
  if (c1 == A && cs == S && cu == U && cm == M && cout == O)                           \
    return popcorn::launch_up_q<A, S, U, M, O>(x1, x2, wt, dt, tt, wa, da, wb, db, t1, \
                                               w2, d2, t2, out, B, H, W, h, w, oy, ox, \
                                               st);
  POPCORN_UPQ(16, 16, 16, 8, 8)
  POPCORN_UPQ(8, 8, 8, 8, 8)
#undef POPCORN_UPQ
  return -1;
}
