// double_conv_qs.cu — kernel E: the static-scale int8 DoubleConv in one launch.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _double_conv_kernel_qs (public wrapper fused_double_conv_qs), on plain
// NHWC tensors: int8 codes in at the calibrated scale s_x, int8 weights per
// output channel, int32 sums, and one requant pass per conv with the
// vectors the wrapper folds (nn/double_conv.py::qs_args):
//   y1  = clip(round(conv3x3(x) * e1 + g1), 0, 127), 0 outside the image;
//   out = clip(round(conv3x3(y1) * e2 + g2), 0, 127), or, as float32 for
//         the stream's last block, relu(conv3x3(y1) * e2 + g2).
//
// What bounds it on the H100: int8 operations. At 9*(Cin*Cm + Cm*Cout)
// multiply-adds a pixel against (Cin + Cout) bytes of input and output,
// it is far above the card's operations-per-byte balance even at the
// int8 tensor-core rate. This first kernel runs on the CUDA cores:
// __dp4a does four multiply-adds of int8 codes into an int32 accumulator.
// Tensor cores (int8 mma/wgmma) are later work.
//
// Design: the int8 kernels' tiling (conv_tile.cuh). One block of 256 threads owns
// a 16x16 output tile; it stages the 20x20 int8 input tile (channels
// padded to a multiple of 4, zero outside the image), both packed weights
// and the four requant vectors in shared memory, computes the y1 codes on
// the 18x18 ring into shared memory (0 outside the image: conv2's SAME
// padding), then conv2 and the epilogue. Only int8 codes cross device
// memory, unless the output is float.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile_i8.cuh"

namespace popcorn {

template <int CIN, int CM, int COUT>
struct QsLayout {
  static constexpr int P = align4(CIN);
  static constexpr int XT = align16((TH + 4) * (TW + 4) * P);
  static constexpr int YT = align16((TH + 2) * (TW + 2) * CM);
  static constexpr int W1 = 9 * (P / 4) * CM;  // int32 words
  static constexpr int W2 = 9 * (CM / 4) * COUT;
  static constexpr int bytes = XT + YT + 4 * (W1 + W2) + 4 * (2 * CM + 2 * COUT);
};

template <int CIN, int CM, int COUT, bool FLOAT_OUT>
__global__ void __launch_bounds__(NTHREADS)
    double_conv_qs_kernel(const int8_t* __restrict__ x, const int* __restrict__ w1,
                          const float* __restrict__ e1, const float* __restrict__ g1,
                          const int* __restrict__ w2, const float* __restrict__ e2,
                          const float* __restrict__ g2, void* __restrict__ out,
                          int H, int W) {
  using L = QsLayout<CIN, CM, COUT>;
  static_assert(CM % 4 == 0 && COUT % 4 == 0, "CM and COUT must be multiples of 4");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xt = reinterpret_cast<int8_t*>(smem);
  int8_t* y1 = xt + L::XT;
  int* w1s = reinterpret_cast<int*>(y1 + L::YT);
  int* w2s = w1s + L::W1;
  float* e1s = reinterpret_cast<float*>(w2s + L::W2);
  float* g1s = e1s + CM;
  float* e2s = g1s + CM;
  float* g2s = e2s + COUT;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  load_tile_i8<CIN, L::P>(xt, 0, x + (size_t)b * H * W * CIN, H, W, y0 - 2, x0 - 2,
                          TH + 4, TW + 4);
  copy_words(w1s, w1, L::W1);
  copy_words(w2s, w2, L::W2);
  copy_to_shared(e1s, e1, CM);
  copy_to_shared(g1s, g1, CM);
  copy_to_shared(e2s, e2, COUT);
  copy_to_shared(g2s, g2, COUT);
  __syncthreads();

  constexpr int RW = TW + 2;
  for (int p = threadIdx.x; p < (TH + 2) * RW; p += blockDim.x) {
    const int ry = p / RW;
    const int rx = p % RW;
    const int gy = y0 - 1 + ry;
    const int gx = x0 - 1 + rx;
    int8_t* dst = y1 + p * CM;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      int acc[CM];
#pragma unroll
      for (int o = 0; o < CM; ++o) acc[o] = 0;
      conv3x3_i8<L::P / 4, CM>(reinterpret_cast<const int*>(xt), L::P / 4, 0, TW + 4,
                               ry, rx, w1s, acc);
#pragma unroll
      for (int o = 0; o < CM; ++o) dst[o] = code(affine(acc[o], e1s[o], g1s[o]), 0.f);
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

template <int CIN, int CM, int COUT, bool FLOAT_OUT>
int launch_qs(const int8_t* x, const int* w1, const float* e1, const float* g1,
              const int* w2, const float* e2, const float* g2, void* out, int B,
              int H, int W, cudaStream_t stream) {
  constexpr size_t smem = QsLayout<CIN, CM, COUT>::bytes;
  auto kern = double_conv_qs_kernel<CIN, CM, COUT, FLOAT_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(x, w1, e1, g1, w2, e2, g2, out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation. Weights are packed (9, ceil(Cin/4), Cout)
// int32 words (nn/quant.py::pack_dp4a).
extern "C" int popcorn_double_conv_qs(const int8_t* x, const int* w1,
                                      const float* e1, const float* g1,
                                      const int* w2, const float* e2,
                                      const float* g2, void* out, int B, int H,
                                      int W, int cin, int cm, int cout,
                                      int float_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POPCORN_QS(CI, CMID, CO)                                                  \
  if (cin == CI && cm == CMID && cout == CO)                                      \
    return float_out ? popcorn::launch_qs<CI, CMID, CO, true>(                    \
                           x, w1, e1, g1, w2, e2, g2, out, B, H, W, st)           \
                     : popcorn::launch_qs<CI, CMID, CO, false>(                   \
                           x, w1, e1, g1, w2, e2, g2, out, B, H, W, st);
  POPCORN_QS(2, 8, 8)
  POPCORN_QS(4, 8, 8)
  POPCORN_QS(8, 16, 16)
  POPCORN_QS(16, 16, 16)
#undef POPCORN_QS
  return -1;
}
