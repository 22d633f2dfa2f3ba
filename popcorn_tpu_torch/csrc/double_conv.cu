// double_conv.cu — kernel A: one UNet DoubleConv block fused in one launch.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _double_conv_kernel (public wrapper fused_double_conv): it computes
//   relu((conv3x3(relu((conv3x3(x) + b1) * g1 + h1)) + b2) * g2 + h2)
// with bias and frozen BN folded into one (s, t) per conv beforehand
// (the wrapper folds them as pallas_conv.py::_fold_affine does), on plain
// NHWC tensors instead of the TPU's space-to-depth packed lanes.
//
// The storage type T is float or bf16. In bf16 the kernel rounds where
// _double_conv_kernel does at cdt = bf16: input and weights are bf16
// (converted to float32 on load, exactly), the sums and the affine are
// float32, y1 is rounded to bf16 in shared memory and the output is bf16.
// A bf16 x bf16 product is exact in float32, so the FMA chain matches an
// MXU (or tensor-core) product with float32 accumulation up to the order
// of the sums.
//
// What bounds it on the H100: arithmetic. A DoubleConv of the DDA UNet does
// 9*(Cin*Cm + Cm*Cout) multiply-adds per pixel (up to 4,608) against
// (Cin + Cout) * 4 bytes of input and output, far above the card's
// operations-per-byte balance even for FP32 CUDA cores. The unfused pair of
// convolutions would also write and re-read the Cm-channel intermediate.
//
// Design: one block of 256 threads owns a 16x16 output tile of one image.
// It stages the 20x20xCin input tile (zero outside the image) and both
// weight tensors in shared memory, computes the intermediate y1 on the
// 18x18 ring into shared memory (zeroed outside the image, the trap that
// pallas_conv.py::_edge_mask exists for), then conv2 and the epilogue, and
// writes the tile NHWC. The intermediate never reaches device memory. Each
// thread keeps the Cm (or Cout) accumulators of one pixel in registers and
// reads the weights as float4 broadcasts. FP32 FMA on CUDA cores; tensor
// cores (TF32/bf16 wgmma) are later work.
#include <cuda_runtime.h>

#include "conv_tile.cuh"

namespace popcorn {

template <int CIN, int CM, int COUT>
constexpr int double_conv_smem_floats() {
  return align4((TH + 4) * (TW + 4) * CIN) + tail_floats<CIN, CM, COUT>();
}

template <class T, int CIN, int CM, int COUT>
__global__ void __launch_bounds__(NTHREADS)
    double_conv_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                       const float* __restrict__ s1, const float* __restrict__ t1,
                       const T* __restrict__ w2, const float* __restrict__ s2,
                       const float* __restrict__ t2, T* __restrict__ out,
                       int H, int W) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  float* tile = smem;
  float* tail = smem + align4((TH + 4) * (TW + 4) * CIN);
  load_tile<CIN, CIN>(tile, 0, x + (size_t)b * H * W * CIN, H, W, y0 - 2,
                      x0 - 2, TH + 4, TW + 4);
  double_conv_tail<CIN, CM, COUT, T>(tile, tail, w1, s1, t1, w2, s2, t2,
                                  out + (size_t)b * H * W * COUT, H, W, y0, x0);
}

template <class T, int CIN, int CM, int COUT>
int launch(const T* x, const T* w1, const float* s1, const float* t1,
           const T* w2, const float* s2, const float* t2, T* out,
           int B, int H, int W, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * double_conv_smem_floats<CIN, CM, COUT>();
  auto kern = double_conv_kernel<T, CIN, CM, COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(x, w1, s1, t1, w2, s2, t2, out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace popcorn

namespace popcorn {

// the channel combinations of the DDA UNet's DoubleConvs
template <class T>
int launch_any(const T* x, const T* w1, const float* s1, const float* t1, const T* w2,
               const float* s2, const float* t2, T* out, int B, int H, int W, int cin,
               int cm, int cout, cudaStream_t st) {
#define POPCORN_DC(CI, CMID, CO)                                                   \
  if (cin == CI && cm == CMID && cout == CO)                                       \
    return launch<T, CI, CMID, CO>(x, w1, s1, t1, w2, s2, t2, out, B, H, W, st);
  POPCORN_DC(2, 8, 8)
  POPCORN_DC(4, 8, 8)
  POPCORN_DC(8, 16, 16)
  POPCORN_DC(16, 16, 16)
#undef POPCORN_DC
  return -1;
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation.
extern "C" int popcorn_double_conv_f32(const float* x, const float* w1,
                                       const float* s1, const float* t1,
                                       const float* w2, const float* s2,
                                       const float* t2, float* out, int B,
                                       int H, int W, int cin, int cm, int cout,
                                       void* stream) {
  return popcorn::launch_any(x, w1, s1, t1, w2, s2, t2, out, B, H, W, cin, cm, cout,
                             static_cast<cudaStream_t>(stream));
}

// The bf16 mode: bf16 input, weights and output, float32 affine vectors.
extern "C" int popcorn_double_conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                                        const float* s1, const float* t1,
                                        const __nv_bfloat16* w2, const float* s2,
                                        const float* t2, __nv_bfloat16* out, int B, int H,
                                        int W, int cin, int cm, int cout, void* stream) {
  return popcorn::launch_any(x, w1, s1, t1, w2, s2, t2, out, B, H, W, cin, cm, cout,
                             static_cast<cudaStream_t>(stream));
}
