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
// What bounds it on the H100: arithmetic, as for kernel A: conv1 over the
// Cs+Cu channels alone is 9*(Cs+Cu)*Cm multiply-adds per fine pixel. The
// unfused block would also write the upsampled map, the concatenation and
// the intermediate to device memory and read them back.
//
// Design: one block of 256 threads owns a 16x16 output tile. It stages the
// 20x20 skip tile and computes the 20x20 upsampled tile on the fly from the
// coarse input into the same shared-memory tile, channels [skip | up] side
// by side, so conv1 is a single Cs+Cu channel conv and no concatenation or
// upsampled map is ever written to device memory. The DoubleConv tail
// (conv_tile.cuh) then runs as in kernel A.
#include <cuda_runtime.h>

#include "conv_tile.cuh"

namespace popcorn {

template <int C1, int CS, int CU, int CM, int COUT>
constexpr int up_block_smem_floats() {
  return align4((TH + 4) * (TW + 4) * (CS + CU)) + align4(C1 * 4 * CU) +
         align4(CU) + tail_floats<CS + CU, CM, COUT>();
}

template <int C1, int CS, int CU, int CM, int COUT>
__global__ void __launch_bounds__(NTHREADS)
    up_block_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                    const float* __restrict__ wt, const float* __restrict__ bt,
                    const float* __restrict__ w1, const float* __restrict__ s1,
                    const float* __restrict__ t1, const float* __restrict__ w2,
                    const float* __restrict__ s2, const float* __restrict__ t2,
                    float* __restrict__ out, int H, int W, int h, int w,
                    int oy, int ox) {
  constexpr int CC = CS + CU;
  static_assert(CU % 4 == 0, "CU must be a multiple of 4");
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  float* tile = smem;
  float* wts = tile + align4((TH + 4) * (TW + 4) * CC);
  float* bts = wts + align4(C1 * 4 * CU);
  float* tail = bts + align4(CU);

  load_tile<CS, CC>(tile, 0, x2 + (size_t)b * H * W * CS, H, W, y0 - 2,
                    x0 - 2, TH + 4, TW + 4);
  copy_to_shared(wts, wt, C1 * 4 * CU);
  copy_to_shared(bts, bt, CU);
  __syncthreads();

  // upsampled channels of the halo tile, computed from the coarse input
  const float* x1b = x1 + (size_t)b * h * w * C1;
  constexpr int HW4 = TW + 4;
  for (int p = threadIdx.x; p < (TH + 4) * HW4; p += blockDim.x) {
    const int gy = y0 - 2 + p / HW4;
    const int gx = x0 - 2 + p % HW4;
    const int uy = gy - oy;
    const int ux = gx - ox;
    float* dst = tile + p * CC + CS;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && uy >= 0 && uy < 2 * h &&
        ux >= 0 && ux < 2 * w) {
      const float* xp = x1b + ((size_t)(uy >> 1) * w + (ux >> 1)) * C1;
      const float4* wp =
          reinterpret_cast<const float4*>(wts + ((uy & 1) * 2 + (ux & 1)) * CU);
      float acc[CU];
#pragma unroll
      for (int o = 0; o < CU; ++o) acc[o] = 0.f;
#pragma unroll
      for (int c = 0; c < C1; ++c) {
        const float v = __ldg(xp + c);
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
      for (int o = 0; o < CU; ++o) dst[o] = acc[o] + bts[o];
    } else {
#pragma unroll
      for (int o = 0; o < CU; ++o) dst[o] = 0.f;
    }
  }
  double_conv_tail<CC, CM, COUT>(tile, tail, w1, s1, t1, w2, s2, t2,
                                 out + (size_t)b * H * W * COUT, H, W, y0, x0);
}

template <int C1, int CS, int CU, int CM, int COUT>
int launch_up(const float* x1, const float* x2, const float* wt,
              const float* bt, const float* w1, const float* s1,
              const float* t1, const float* w2, const float* s2,
              const float* t2, float* out, int B, int H, int W, int h, int w,
              int oy, int ox, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * up_block_smem_floats<C1, CS, CU, CM, COUT>();
  auto kern = up_block_kernel<C1, CS, CU, CM, COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(x1, x2, wt, bt, w1, s1, t1, w2, s2,
                                         t2, out, H, W, h, w, oy, ox);
  return (int)cudaGetLastError();
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation.
extern "C" int popcorn_up_block_f32(const float* x1, const float* x2,
                                    const float* wt, const float* bt,
                                    const float* w1, const float* s1,
                                    const float* t1, const float* w2,
                                    const float* s2, const float* t2,
                                    float* out, int B, int H, int W, int h,
                                    int w, int oy, int ox, int c1, int cs,
                                    int cu, int cm, int cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POPCORN_UP(A, S, U, M, O)                                            \
  if (c1 == A && cs == S && cu == U && cm == M && cout == O)                 \
    return popcorn::launch_up<A, S, U, M, O>(x1, x2, wt, bt, w1, s1, t1, w2, \
                                             s2, t2, out, B, H, W, h, w, oy,  \
                                             ox, st);
  POPCORN_UP(16, 16, 16, 8, 8)
  POPCORN_UP(8, 8, 8, 8, 8)
#undef POPCORN_UP
  return -1;
}
