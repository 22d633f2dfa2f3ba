// up_block_qs.cu — kernel F: the static-scale int8 Up block in one launch.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _up_block_kernel_qs (public wrapper fused_up_block_qs), on unpacked NHWC
// tensors: int8 codes in (the coarse x1 at s_x1, the skip at s_x2), with
// the vectors the wrapper folds (nn/up_block.py::qs_args):
//   up  = clip(round(tconv(x1) * et[tap] + gt), -127, 127) inside the
//         upsampled region, 0 on pad_to_match's ring and outside the image
//         (the reference tconv has no ReLU, so the codes stay signed);
//   y1  = clip(round((conv3x3(skip; wa) * ea + conv3x3(up; wb) * eb) + g1),
//         0, 127), 0 outside the image;
//   out = conv2 requantized at 0, or float32 relu(acc * e2 + g2) for up1.
// The tconv's scales are per (tap, output channel): in the JAX package's
// packed layout each lifted tconv column holds one tap (packed.py::
// lift_tconv). The kernel picks them by the fine pixel's parity, as kernel
// B picks the tap's weights. conv1 keeps the skip and up parts apart, each
// with its own per-channel weight scales, as the JAX kernel's two-part
// lifted conv does.
//
// What bounds it on the H100: int8 operations, as kernel E; __dp4a on the
// CUDA cores.
//
// Design: kernel B's tiling (up_block.cu) on int8 codes. One block owns a
// 16x16 output tile; it stages the 20x20 skip tile and computes the 20x20
// up codes beside it in one shared tile, [skip | up] per pixel, so neither
// the upsampled map nor a concatenation reaches device memory; conv1 reads
// the two parts of each pixel separately; then kernel E's tail.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile_i8.cuh"

namespace popcorn {

template <int C1, int CS, int CU, int CM, int COUT>
struct UpQsLayout {
  static constexpr int P = CS + CU;
  static constexpr int XT = align16((TH + 4) * (TW + 4) * P);
  static constexpr int YT = align16((TH + 2) * (TW + 2) * CM);
  static constexpr int WT = 4 * (C1 / 4) * CU;  // int32 words
  static constexpr int WA = 9 * (CS / 4) * CM;
  static constexpr int WB = 9 * (CU / 4) * CM;
  static constexpr int W2 = 9 * (CM / 4) * COUT;
  static constexpr int bytes =
      XT + YT + 4 * (WT + WA + WB + W2) + 4 * (5 * CU + 3 * CM + 2 * COUT);
};

template <int C1, int CS, int CU, int CM, int COUT, bool FLOAT_OUT>
__global__ void __launch_bounds__(NTHREADS)
    up_block_qs_kernel(const int8_t* __restrict__ x1, const int8_t* __restrict__ x2,
                       const int* __restrict__ wt, const float* __restrict__ et,
                       const float* __restrict__ gt, const int* __restrict__ wa,
                       const float* __restrict__ ea, const int* __restrict__ wb,
                       const float* __restrict__ eb, const float* __restrict__ g1,
                       const int* __restrict__ w2, const float* __restrict__ e2,
                       const float* __restrict__ g2, void* __restrict__ out, int H,
                       int W, int h, int w, int oy, int ox) {
  using L = UpQsLayout<C1, CS, CU, CM, COUT>;
  static_assert(C1 % 4 == 0 && CS % 4 == 0 && CU % 4 == 0 && CM % 4 == 0 && COUT % 4 == 0,
                "channel counts must be multiples of 4");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* tile = reinterpret_cast<int8_t*>(smem);
  int8_t* y1 = tile + L::XT;
  int* wts = reinterpret_cast<int*>(y1 + L::YT);
  int* was = wts + L::WT;
  int* wbs = was + L::WA;
  int* w2s = wbs + L::WB;
  float* ets = reinterpret_cast<float*>(w2s + L::W2);  // (4 taps, CU)
  float* gts = ets + 4 * CU;
  float* eas = gts + CU;
  float* ebs = eas + CM;
  float* g1s = ebs + CM;
  float* e2s = g1s + CM;
  float* g2s = e2s + COUT;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  load_tile_i8<CS, L::P>(tile, 0, x2 + (size_t)b * H * W * CS, H, W, y0 - 2, x0 - 2,
                         TH + 4, TW + 4);
  copy_words(wts, wt, L::WT);
  copy_words(was, wa, L::WA);
  copy_words(wbs, wb, L::WB);
  copy_words(w2s, w2, L::W2);
  copy_to_shared(ets, et, 4 * CU);
  copy_to_shared(gts, gt, CU);
  copy_to_shared(eas, ea, CM);
  copy_to_shared(ebs, eb, CM);
  copy_to_shared(g1s, g1, CM);
  copy_to_shared(e2s, e2, COUT);
  copy_to_shared(g2s, g2, COUT);
  __syncthreads();

  // the up codes of the halo tile, from the coarse input's codes
  const int8_t* x1b = x1 + (size_t)b * h * w * C1;
  constexpr int XW = TW + 4;
  for (int p = threadIdx.x; p < (TH + 4) * XW; p += blockDim.x) {
    const int gy = y0 - 2 + p / XW;
    const int gx = x0 - 2 + p % XW;
    const int uy = gy - oy;
    const int ux = gx - ox;
    int8_t* dst = tile + p * L::P + CS;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && uy >= 0 && uy < 2 * h && ux >= 0 &&
        ux < 2 * w) {
      const int* xp = reinterpret_cast<const int*>(x1b + ((size_t)(uy >> 1) * w + (ux >> 1)) * C1);
      const int tap = (uy & 1) * 2 + (ux & 1);
      const int4* wp = reinterpret_cast<const int4*>(wts + tap * (C1 / 4) * CU);
      int acc[CU];
#pragma unroll
      for (int o = 0; o < CU; ++o) acc[o] = 0;
#pragma unroll
      for (int g = 0; g < C1 / 4; ++g) {
        const int a = __ldg(xp + g);
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
      for (int o = 0; o < CU; ++o) dst[o] = code(affine(acc[o], ets[tap * CU + o], gts[o]), -127.f);
    } else {
#pragma unroll
      for (int o = 0; o < CU; ++o) dst[o] = 0;
    }
  }
  __syncthreads();

  constexpr int RW = TW + 2;
  for (int p = threadIdx.x; p < (TH + 2) * RW; p += blockDim.x) {
    const int ry = p / RW;
    const int rx = p % RW;
    const int gy = y0 - 1 + ry;
    const int gx = x0 - 1 + rx;
    int8_t* dst = y1 + p * CM;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      int acc_a[CM], acc_b[CM];
#pragma unroll
      for (int o = 0; o < CM; ++o) acc_a[o] = acc_b[o] = 0;
      const int* t = reinterpret_cast<const int*>(tile);
      conv3x3_i8<CS / 4, CM>(t, L::P / 4, 0, TW + 4, ry, rx, was, acc_a);
      conv3x3_i8<CU / 4, CM>(t, L::P / 4, CS / 4, TW + 4, ry, rx, wbs, acc_b);
#pragma unroll
      for (int o = 0; o < CM; ++o) {
        const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc_a[o]), eas[o]),
                                  __fmul_rn(__int2float_rn(acc_b[o]), ebs[o]));
        dst[o] = code(__fadd_rn(v, g1s[o]), 0.f);
      }
    } else {
#pragma unroll
      for (int o = 0; o < CM; ++o) dst[o] = 0;
    }
  }
  __syncthreads();

  const size_t img = (size_t)b * H * W * COUT * (FLOAT_OUT ? sizeof(float) : 1);
  conv2_static<CM, COUT, FLOAT_OUT>(y1, w2s, e2s, g2s,
                                    static_cast<unsigned char*>(out) + img, H, W, y0, x0);
}

template <int C1, int CS, int CU, int CM, int COUT, bool FLOAT_OUT>
int launch_up_qs(const int8_t* x1, const int8_t* x2, const int* wt, const float* et,
                 const float* gt, const int* wa, const float* ea, const int* wb,
                 const float* eb, const float* g1, const int* w2, const float* e2,
                 const float* g2, void* out, int B, int H, int W, int h, int w, int oy,
                 int ox, cudaStream_t stream) {
  constexpr size_t smem = UpQsLayout<C1, CS, CU, CM, COUT>::bytes;
  auto kern = up_block_qs_kernel<C1, CS, CU, CM, COUT, FLOAT_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(x1, x2, wt, et, gt, wa, ea, wb, eb, g1, w2, e2,
                                         g2, out, H, W, h, w, oy, ox);
  return (int)cudaGetLastError();
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation. The tconv's codes are packed (4 taps, C1/4,
// Cu) int32 words, the convs' (9, Cin/4, Cout) (nn/quant.py::pack_dp4a).
extern "C" int popcorn_up_block_qs(const int8_t* x1, const int8_t* x2, const int* wt,
                                   const float* et, const float* gt, const int* wa,
                                   const float* ea, const int* wb, const float* eb,
                                   const float* g1, const int* w2, const float* e2,
                                   const float* g2, void* out, int B, int H, int W,
                                   int h, int w, int oy, int ox, int c1, int cs,
                                   int cu, int cm, int cout, int float_out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POPCORN_UPQS(A, S, U, M, O)                                                      \
  if (c1 == A && cs == S && cu == U && cm == M && cout == O)                             \
    return float_out                                                                     \
               ? popcorn::launch_up_qs<A, S, U, M, O, true>(x1, x2, wt, et, gt, wa, ea,  \
                                                            wb, eb, g1, w2, e2, g2, out, \
                                                            B, H, W, h, w, oy, ox, st)   \
               : popcorn::launch_up_qs<A, S, U, M, O, false>(x1, x2, wt, et, gt, wa, ea, \
                                                             wb, eb, g1, w2, e2, g2,     \
                                                             out, B, H, W, h, w, oy, ox, \
                                                             st);
  POPCORN_UPQS(16, 16, 16, 8, 8)
  POPCORN_UPQS(8, 8, 8, 8, 8)
#undef POPCORN_UPQS
  return -1;
}
