// double_conv_q.cu — kernel G: the dynamic-scale int8 (W8A8) DoubleConv in
// one launch.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _double_conv_kernel_q (fused_double_conv with quantized=True), on plain
// NHWC tensors with float32 in and out:
//   xq  = the staged input tile quantized at its own scale sx
//         (amax / 127 over the tile and its halo: _quantize_slab);
//   y1  = relu(conv3x3(xq) * (d1 * sx) + t1) on the ring, 0 outside the
//         image, quantized at its own scale sy;
//   out = relu(conv3x3(y1q) * (d2 * sy) + t2),
// with int8 weights per output channel and d = weight scale * folded BN
// scale (nn/double_conv.py::q_args). The JAX package's slab is 8 TPU rows
// at the full width; here it is the kernel's tile, and the plain version
// (double_conv_q_plain) cuts the image into the same tiles.
//
// What bounds it on the H100: int8 operations, as kernel E (the float32
// input and output are 4 bytes a channel, still far below the balance).
// __dp4a on the CUDA cores; the two block-wide max reductions and the
// float staging are the extra work the static kernel does not do.
//
// Design: kernel E's tiling. The block stages the 20x20 float input tile
// in shared memory while each thread keeps the max |v| of what it loaded,
// reduces the tile's max, writes the int8 codes; the ring's float y1 goes
// into the same shared buffer, is reduced and quantized the same way.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile_i8.cuh"

namespace popcorn {

template <int CIN, int CM, int COUT>
struct QLayout {
  static constexpr int P = align4(CIN);
  static constexpr int NX = (TH + 4) * (TW + 4);
  static constexpr int NR = (TH + 2) * (TW + 2);
  // float staging of the input tile, then of the y1 ring
  static constexpr int F = align4(NX * CIN > NR * CM ? NX * CIN : NR * CM);
  static constexpr int XT = align16(NX * P);
  static constexpr int YT = align16(NR * CM);
  static constexpr int W1 = 9 * (P / 4) * CM;
  static constexpr int W2 = 9 * (CM / 4) * COUT;
  static constexpr int bytes =
      4 * F + XT + YT + 4 * (W1 + W2) + 4 * (2 * CM + 2 * COUT) + 4 * (NTHREADS / 32);
};

template <int CIN, int CM, int COUT>
__global__ void __launch_bounds__(NTHREADS)
    double_conv_q_kernel(const float* __restrict__ x, const int* __restrict__ w1,
                         const float* __restrict__ d1, const float* __restrict__ t1,
                         const int* __restrict__ w2, const float* __restrict__ d2,
                         const float* __restrict__ t2, float* __restrict__ out,
                         int H, int W) {
  using L = QLayout<CIN, CM, COUT>;
  static_assert(CM % 4 == 0 && COUT % 4 == 0, "CM and COUT must be multiples of 4");
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  int8_t* xq = reinterpret_cast<int8_t*>(stage + L::F);
  int8_t* y1q = xq + L::XT;
  int* w1s = reinterpret_cast<int*>(y1q + L::YT);
  int* w2s = w1s + L::W1;
  float* d1s = reinterpret_cast<float*>(w2s + L::W2);
  float* t1s = d1s + CM;
  float* d2s = t1s + CM;
  float* t2s = d2s + COUT;
  float* red = t2s + COUT;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const float* xb = x + (size_t)b * H * W * CIN;
  constexpr int XW = TW + 4;
  float m = 0.f;
  for (int i = threadIdx.x; i < L::NX * CIN; i += blockDim.x) {
    const int c = i % CIN;
    const int p = i / CIN;
    const int gy = y0 - 2 + p / XW;
    const int gx = x0 - 2 + p % XW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = __ldg(xb + ((size_t)gy * W + gx) * CIN + c);
    stage[i] = v;
    m = fmaxf(m, fabsf(v));
  }
  // channels [CIN, P) of the int8 tile stay zero
  if (L::P != CIN)
    for (int i = threadIdx.x; i < L::NX * L::P; i += blockDim.x) xq[i] = 0;
  copy_words(w1s, w1, L::W1);
  copy_words(w2s, w2, L::W2);
  copy_to_shared(d1s, d1, CM);
  copy_to_shared(t1s, t1, CM);
  copy_to_shared(d2s, d2, COUT);
  copy_to_shared(t2s, t2, COUT);
  const float sx = quantize_staged<CIN, L::P>(stage, L::NX * CIN, m, xq, red);
  __syncthreads();

  constexpr int RW = TW + 2;
  m = 0.f;
  for (int p = threadIdx.x; p < L::NR; p += blockDim.x) {
    const int ry = p / RW;
    const int rx = p % RW;
    const int gy = y0 - 1 + ry;
    const int gx = x0 - 1 + rx;
    float* dst = stage + p * CM;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      int acc[CM];
#pragma unroll
      for (int o = 0; o < CM; ++o) acc[o] = 0;
      conv3x3_i8<L::P / 4, CM>(reinterpret_cast<const int*>(xq), L::P / 4, 0, TW + 4,
                               ry, rx, w1s, acc);
#pragma unroll
      for (int o = 0; o < CM; ++o) {
        const float v = fmaxf(affine(acc[o], __fmul_rn(d1s[o], sx), t1s[o]), 0.f);
        dst[o] = v;
        m = fmaxf(m, v);
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

template <int CIN, int CM, int COUT>
int launch_q(const float* x, const int* w1, const float* d1, const float* t1,
             const int* w2, const float* d2, const float* t2, float* out, int B,
             int H, int W, cudaStream_t stream) {
  constexpr size_t smem = QLayout<CIN, CM, COUT>::bytes;
  auto kern = double_conv_q_kernel<CIN, CM, COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(x, w1, d1, t1, w2, d2, t2, out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation. Weights are packed (9, ceil(Cin/4), Cout)
// int32 words (nn/quant.py::pack_dp4a).
extern "C" int popcorn_double_conv_q(const float* x, const int* w1, const float* d1,
                                     const float* t1, const int* w2, const float* d2,
                                     const float* t2, float* out, int B, int H, int W,
                                     int cin, int cm, int cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POPCORN_Q(CI, CMID, CO)                                                 \
  if (cin == CI && cm == CMID && cout == CO)                                    \
    return popcorn::launch_q<CI, CMID, CO>(x, w1, d1, t1, w2, d2, t2, out, B, H, \
                                           W, st);
  POPCORN_Q(2, 8, 8)
  POPCORN_Q(4, 8, 8)
  POPCORN_Q(8, 16, 16)
  POPCORN_Q(16, 16, 16)
#undef POPCORN_Q
  return -1;
}
