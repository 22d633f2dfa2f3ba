// double_conv_qs.cu — kernel E: the static-scale int8 DoubleConv in one
// launch, on Hopper's int8 tensor cores.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _double_conv_kernel_qs (public wrapper fused_double_conv_qs), on plain
// NHWC tensors: int8 codes in at the calibrated scale s_x, int8 weights per
// output channel, int32 sums, and one requant pass per conv with the
// vectors the wrapper folds (nn/double_conv.py::qs_args):
//   y1  = clip(round(conv3x3(x) * e1 + g1), 0, 127), 0 outside the image;
//   out = clip(round(conv3x3(y1) * e2 + g2), 0, 127), or, as float32 for
//         a stream's last block, relu(conv3x3(y1) * e2 + g2).
// The codes and the float32 output equal the plain version's bit for bit:
// the integer sums are exact and the epilogue rounds as it does.
//
// What bounds it on the H100: bytes. The inc reads 2048^2 x 2 (SAR) or x 4
// codes and writes 2048^2 x 8, 42 or 50 MB, 0.013-0.015 ms at 3.35 TB/s;
// its 720-864 multiply-adds a pixel are about 7 G operations, under 4 us
// at the int8 tensor rate.
//
// Design (the first design ran __dp4a on the CUDA cores from 16x16 tiles,
// one thread a pixel, with byte-wise staging), as kernel F's:
// - Products on the tensor cores (int8_mma.cuh): both convs are implicit
//   GEMMs on mma.sync m16n8k32, M = 16 pixels, N = 8 channels a tile (two
//   at 16 channels), K = 32 bytes: at 16 channels a k-step is two taps, at
//   8 four; conv1 of the inc's 2 or 4 channels (one word a pixel, the
//   channels past 2 zero) packs a kernel row's three taps and a pad into
//   a group: one k32 step and one k16 step.
// - Planes, not a swizzle: the input codes and y1 each have their own
//   plane of 4, 8 or 16 bytes a pixel, where a fragment's 8 pixels x 4
//   words fall into 32 banks as they are.
// - A 32x32 output region a block: its 36x36 input union is staged once
//   (1.27x the region) and the 34x34 y1 ring is 1.13x the region (16x16
//   tiles: 1.56x, 1.27x); M tiles run along the flattened ring, 1% of them
//   past its end.
// - cp.async staging of whole pixels, 16 bytes or the pixel a piece, while
//   the block restages its weights in fragment order; word loads for an
//   input off the pieces' alignment, 2-byte loads for the SAR inc.
// - The output leaves through a shared-memory stage as 16-byte stores.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "int8_mma.cuh"

namespace popcorn {

constexpr int E_R = 32;        // output region edge
constexpr int E_I = E_R + 4;   // input union edge
constexpr int E_Y = E_R + 2;   // y1 ring edge

template <int CIN, int CM, int COUT, class OT>
struct EGeom {
  static constexpr int P = CIN < 4 ? 4 : CIN;  // plane bytes a pixel
  static constexpr int WX = P / 4, WM = CM / 4;  // words a pixel
  static constexpr int PLANE = E_I * E_I * P;
  static constexpr int OUTST = E_R * E_R * COUT * (int)sizeof(OT);
  static constexpr int XQ = 0;  // the input plane, then the output stage
  static constexpr int RING = align16(PLANE > OUTST ? PLANE : OUTST);
  static constexpr int W1 = RING + align16(E_Y * E_Y * CM);
  static constexpr int W2 = W1 + CM / 8 * i8::ksteps<WX>() * 32 * 8;
  static constexpr int VEC = W2 + COUT / 8 * i8::ksteps<WM>() * 32 * 8;  // e1 g1 e2 g2
  static constexpr int BYTES = VEC + 4 * (2 * CM + 2 * COUT);
  static_assert((CIN == 2 || CIN % 4 == 0) && CIN <= 16 && CM % 8 == 0 && COUT % 8 == 0 &&
                    CM <= 16 && COUT <= 16,
                "channels: 2, 4, 8 or 16 in, 8 or 16 after");
};

// blocks an SM the registers must leave room for: six at 8 channels (40
// registers), four at 16 (64), both without spills
template <int CIN, int CM, int COUT, class OT>
__global__ void __launch_bounds__(i8::THREADS, CM == 8 ? 6 : 4)
    double_conv_qs_kernel(const int8_t* __restrict__ x, const int* __restrict__ w1,
                          const float* __restrict__ e1, const float* __restrict__ g1,
                          const int* __restrict__ w2, const float* __restrict__ e2,
                          const float* __restrict__ g2, OT* __restrict__ out, int H, int W,
                          int vec) {
  using G = EGeom<CIN, CM, COUT, OT>;
  constexpr int N1 = CM / 8, N2 = COUT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t* xq = reinterpret_cast<const uint32_t*>(smem + G::XQ);
  OT* ost = reinterpret_cast<OT*>(smem + G::XQ);  // the output stage, over the input plane
  int8_t* ring = reinterpret_cast<int8_t*>(smem + G::RING);
  uint2* w1f = reinterpret_cast<uint2*>(smem + G::W1);
  uint2* w2f = reinterpret_cast<uint2*>(smem + G::W2);
  float* e1s = reinterpret_cast<float*>(smem + G::VEC);
  float* g1s = e1s + CM;
  float* e2s = g1s + CM;
  float* g2s = e2s + COUT;

  const int b = blockIdx.z, tid = threadIdx.x;
  const int y0 = blockIdx.y * E_R, x0 = blockIdx.x * E_R;
  const int8_t* xb = x + (size_t)b * H * W * CIN;
  i8::stage_pixels<CIN>(
      smem + G::XQ, E_I * E_I,
      [&](int p) -> const unsigned char* {
        const int gy = y0 - 2 + p / E_I, gx = x0 - 2 + p % E_I;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) return nullptr;
        return reinterpret_cast<const unsigned char*>(xb + ((size_t)gy * W + gx) * CIN);
      },
      xb, vec != 0);
  cp_async_commit();
  i8::stage_conv_weights<G::WX, CM>(w1f, w1);
  i8::stage_conv_weights<G::WM, COUT>(w2f, w2);
  if (tid < CM) {
    e1s[tid] = __ldg(e1 + tid);
    g1s[tid] = __ldg(g1 + tid);
  }
  if (tid < COUT) {
    e2s[tid] = __ldg(e2 + tid);
    g2s[tid] = __ldg(g2 + tid);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // Blocks whose y1 ring lies inside the image skip the per-pixel edge
  // tests: all but the image's outer ring of blocks
  const bool inside = y0 >= 1 && x0 >= 1 && y0 + E_R + 1 <= H && x0 + E_R + 1 <= W;

  // conv1 on the ring (origin y0-1, x0-1), two M tiles at a time along the
  // flattened ring; y1 = 0 where the ring leaves the image
  constexpr int NR = E_Y * E_Y, MR = (NR + 15) / 16;
  auto conv1_phase = [&](auto all_in) {
    for (int m0 = 2 * warp; m0 < MR; m0 += 2 * i8::WARPS) {
      int lo[2], hi[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ql = min(16 * (m0 + k) + g, NR - 1), qh = min(16 * (m0 + k) + g + 8, NR - 1);
        lo[k] = (ql / E_Y) * E_I + ql % E_Y;
        hi[k] = (qh / E_Y) * E_I + qh % E_Y;
      }
      int acc[2][N1][4] = {};
      i8::conv3x3<G::WX, E_I, 2, N1>(acc, xq, lo, hi, w1f, lane);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = 16 * (m0 + k) + g + 8 * hh;
          if (q >= NR) continue;
          const int gy = y0 - 1 + q / E_Y, gx = x0 - 1 + q % E_Y;
          const bool in = decltype(all_in)::value || (gy >= 0 && gy < H && gx >= 0 && gx < W);
#pragma unroll
          for (int j = 0; j < N1; ++j) {
            const int n = 8 * j + 2 * t;
            const int8_t c0 = in ? code(affine(acc[k][j][2 * hh], e1s[n], g1s[n]), 0.f) : 0;
            const int8_t c1 = in ? code(affine(acc[k][j][2 * hh + 1], e1s[n + 1], g1s[n + 1]), 0.f)
                                 : 0;
            i8::put2(ring + q * CM + n, c0, c1);
          }
        }
      }
    }
  };
  if (inside)
    conv1_phase(std::true_type{});
  else
    conv1_phase(std::false_type{});
  __syncthreads();

  // conv2 on the region, two M tiles a row, into the output stage
  for (int m0 = 2 * warp; m0 < 2 * E_R; m0 += 2 * i8::WARPS) {
    const int ty = m0 / 2;
    const int lo[2] = {ty * E_Y + g, ty * E_Y + 16 + g};
    const int hi[2] = {lo[0] + 8, lo[1] + 8};
    int acc[2][N2][4] = {};
    i8::conv3x3<G::WM, E_Y, 2, N2>(acc, reinterpret_cast<const uint32_t*>(ring), lo, hi, w2f,
                                   lane);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tx = 16 * k + g + 8 * hh;
#pragma unroll
        for (int j = 0; j < N2; ++j) {
          const int n = 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = affine(acc[k][j][2 * hh + e], e2s[n + e], g2s[n + e]);
            if constexpr (!std::is_same<OT, int8_t>::value) v[e] = fmaxf(v[e], 0.f);
          }
          i8::put_out(ost + (ty * E_R + tx) * COUT + n, v[0], v[1]);
        }
      }
    }
  }
  __syncthreads();
  i8::copy_out<COUT * sizeof(OT)>(
      reinterpret_cast<unsigned char*>(out + (size_t)b * H * W * COUT), smem + G::XQ, H, W, y0,
      x0, E_R, E_R);
}

template <int CIN, int CM, int COUT, class OT>
int launch_qs(const int8_t* x, const int* w1, const float* e1, const float* g1, const int* w2,
              const float* e2, const float* g2, OT* out, int B, int H, int W,
              cudaStream_t stream) {
  constexpr int smem = EGeom<CIN, CM, COUT, OT>::BYTES;
  auto kern = double_conv_qs_kernel<CIN, CM, COUT, OT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // whole pixels by cp.async where each pixel is aligned to its pieces
  // (any view of a pixel-aligned tensor is, past its base)
  const int vec = reinterpret_cast<uintptr_t>(x) % (CIN < 16 ? CIN : 16) == 0;
  dim3 grid((W + E_R - 1) / E_R, (H + E_R - 1) / E_R, B);
  kern<<<grid, i8::THREADS, smem, stream>>>(x, w1, e1, g1, w2, e2, g2, out, H, W, vec);
  return (int)cudaGetLastError();
}

template <class OT>
int launch_qs_any(const int8_t* x, const int* w1, const float* e1, const float* g1,
                  const int* w2, const float* e2, const float* g2, OT* out, int B, int H, int W,
                  int cin, int cm, int cout, cudaStream_t st) {
#define POPCORN_QS(CI, CMID, CO)                   \
  if (cin == CI && cm == CMID && cout == CO)       \
    return launch_qs<CI, CMID, CO, OT>(x, w1, e1, g1, w2, e2, g2, out, B, H, W, st);
  POPCORN_QS(2, 8, 8)
  POPCORN_QS(4, 8, 8)
  POPCORN_QS(8, 16, 16)
  POPCORN_QS(16, 16, 16)
#undef POPCORN_QS
  return -1;
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation. Weights are packed (9, ceil(Cin/4), Cout)
// int32 words (nn/quant.py::pack_dp4a). float_out: float32 out, else int8
// codes.
extern "C" int popcorn_double_conv_qs(const int8_t* x, const int* w1, const float* e1,
                                      const float* g1, const int* w2, const float* e2,
                                      const float* g2, void* out, int B, int H, int W, int cin,
                                      int cm, int cout, int float_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (float_out)
    return popcorn::launch_qs_any(x, w1, e1, g1, w2, e2, g2, static_cast<float*>(out), B, H, W,
                                  cin, cm, cout, st);
  return popcorn::launch_qs_any(x, w1, e1, g1, w2, e2, g2, static_cast<int8_t*>(out), B, H, W,
                                cin, cm, cout, st);
}
