// up_block_qs.cu — kernel F: the static-scale int8 Up block in one launch,
// on Hopper's int8 tensor cores.
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
//   out = conv2 requantized at 0 (int8), or relu(acc * e2 + g2) as float32
//         or rounded to bf16 (up1, the stream's last block).
// The tconv's scales are per (tap, output channel): in the JAX package's
// packed layout each lifted tconv column holds one tap (packed.py::
// lift_tconv); the epilogue picks them by the tap of the accumulator's
// column. conv1 keeps the skip and up parts apart, each with its own
// per-channel weight scales, as the JAX kernel's two-part lifted conv does.
//
// What bounds it on the H100: bytes. up1 reads 1024^2 x 8 + 2048^2 x 8
// codes and writes 2048^2 x 8 float32 (bf16: half), about 176 MB (bf16
// 109 MB), 0.053 ms (0.033) at 3.35 TB/s; up2 reads and writes int8, 31 MB,
// 0.009 ms. Its 1,792 (up1) to 2,880 (up2) multiply-adds a fine pixel are
// about 15 G operations at up1, under 8 us at the int8 tensor rate.
//
// Design (the first design ran __dp4a on the CUDA cores from
// 16x16 tiles, one thread a pixel, with byte-wise staging):
// - Products on the tensor cores (int8_mma.cuh): conv1's two parts and
//   conv2 are implicit GEMMs on mma.sync m16n8k32, M = 16 pixels, N = 8
//   channels, K = 32 bytes: at 16 channels a k-step is two taps, at 8
//   (up1's parts, conv2) four, zero weights padding the last. The tconv
//   runs on m16n8k16 with M = 16 coarse pixels, N = the 4 taps x CU
//   output columns and K = C1 (8 at up1, zero-padded to 16); its epilogue
//   writes each accumulator to its fine pixel.
// - Planes, not a swizzle: the skip codes, the up codes, the coarse codes
//   and y1 each have their own plane of 8 or 16 bytes a pixel, where a
//   fragment's 8 pixels x 4 words fall into 32 banks as they are.
// - A 32x32 output region a block: its 36x36 input union is staged once,
//   so the halo costs 1.27x the region in staging and the tconv (16x16
//   tiles: 1.56x) and the 34x34 y1 ring 1.13x (1.27x); M tiles run along
//   the flattened ring, 1% of them past its end.
// - cp.async staging of whole pixels, 16 bytes (up2) or 8 (up1) a piece,
//   while the block restages its weights in fragment order; word loads
//   for an input off the pieces' alignment.
// - bf16 output in the kernel (the CLIs' default dtype), so the stream's
//   float features need no rounding pass; the output leaves through a
//   shared-memory stage as 16-byte stores.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "int8_mma.cuh"

namespace popcorn {

constexpr int QS_R = 32;           // output region edge
constexpr int QS_I = QS_R + 4;     // input union edge
constexpr int QS_Y = QS_R + 2;     // y1 ring edge
constexpr int QS_C = QS_I / 2 + 1;  // coarse window edge

template <int C1, int CS, int CU, class OT>
struct QsGeom {
  static constexpr int NT = 4 * CU / 8;  // tconv n-tiles
  static constexpr int WS = CS / 4, WU = CU / 4;
  static constexpr int PLANES = QS_I * QS_I * (CS + CU);
  static constexpr int OUTST = QS_R * QS_R * 8 * (int)sizeof(OT);
  static constexpr int SKIP = 0;
  static constexpr int UP = SKIP + QS_I * QS_I * CS;
  static constexpr int X1Q = align16(PLANES > OUTST ? PLANES : OUTST);
  static constexpr int RING = X1Q + align16(QS_C * QS_C * C1);
  static constexpr int WT = RING + QS_Y * QS_Y * 8;
  static constexpr int WA = WT + NT * 32 * 4;
  static constexpr int WB = WA + i8::ksteps<WS>() * 32 * 8;
  static constexpr int W2 = WB + i8::ksteps<WU>() * 32 * 8;
  static constexpr int VEC = W2 + i8::ksteps<2>() * 32 * 8;  // et gt ea eb g1 e2 g2
  static constexpr int BYTES = VEC + 4 * (5 * CU + 5 * 8);
  static_assert(C1 % 8 == 0 && CS % 8 == 0 && CU % 8 == 0 && C1 <= 16,
                "channels: 8 or 16 a tensor");
};

// blocks an SM the registers must leave room for: four at 8 channels (64
// registers), three at 16, where 64 would spill
template <int C1, int CS, int CU, class OT>
__global__ void __launch_bounds__(i8::THREADS, C1 == 8 ? 4 : 3)
    up_block_qs_kernel(const int8_t* __restrict__ x1, const int8_t* __restrict__ x2,
                       const int* __restrict__ wt, const float* __restrict__ et,
                       const float* __restrict__ gt, const int* __restrict__ wa,
                       const float* __restrict__ ea, const int* __restrict__ wb,
                       const float* __restrict__ eb, const float* __restrict__ g1,
                       const int* __restrict__ w2, const float* __restrict__ e2,
                       const float* __restrict__ g2, OT* __restrict__ out, int H, int W,
                       int h, int w, int oy, int ox, int vec1, int vec2) {
  using G = QsGeom<C1, CS, CU, OT>;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* skip = reinterpret_cast<int8_t*>(smem + G::SKIP);
  int8_t* upq = reinterpret_cast<int8_t*>(smem + G::UP);
  OT* ost = reinterpret_cast<OT*>(smem);  // the output stage, over both planes
  const uint32_t* x1q = reinterpret_cast<const uint32_t*>(smem + G::X1Q);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + G::RING);
  uint32_t* wtf = reinterpret_cast<uint32_t*>(smem + G::WT);
  uint2* waf = reinterpret_cast<uint2*>(smem + G::WA);
  uint2* wbf = reinterpret_cast<uint2*>(smem + G::WB);
  uint2* w2f = reinterpret_cast<uint2*>(smem + G::W2);
  float* ets = reinterpret_cast<float*>(smem + G::VEC);  // (4 taps, CU)
  float* gts = ets + 4 * CU;
  float* eas = gts + CU;
  float* ebs = eas + 8;
  float* g1s = ebs + 8;
  float* e2s = g1s + 8;
  float* g2s = e2s + 8;

  const int b = blockIdx.z, tid = threadIdx.x;
  const int y0 = blockIdx.y * QS_R, x0 = blockIdx.x * QS_R;
  // the coarse window: every coarse pixel whose 2x2 fine pixels meet the
  // input union (origin y0-2, x0-2), inside the coarse image or not
  const int cy0 = (y0 - 2 - oy) >> 1, cx0 = (x0 - 2 - ox) >> 1;

  const int8_t* x2b = x2 + (size_t)b * H * W * CS;
  const int8_t* x1b = x1 + (size_t)b * h * w * C1;
  i8::stage_pixels<CS>(
      smem + G::SKIP, QS_I * QS_I,
      [&](int p) -> const unsigned char* {
        const int gy = y0 - 2 + p / QS_I, gx = x0 - 2 + p % QS_I;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) return nullptr;
        return reinterpret_cast<const unsigned char*>(x2b + ((size_t)gy * W + gx) * CS);
      },
      x2b, vec2 != 0);
  i8::stage_pixels<C1>(
      smem + G::X1Q, QS_C * QS_C,
      [&](int p) -> const unsigned char* {
        const int cy = cy0 + p / QS_C, cx = cx0 + p % QS_C;
        if (cy < 0 || cy >= h || cx < 0 || cx >= w) return nullptr;
        return reinterpret_cast<const unsigned char*>(x1b + ((size_t)cy * w + cx) * C1);
      },
      x1b, vec1 != 0);
  cp_async_commit();
  i8::stage_tconv_weights<C1, CU>(wtf, wt);
  i8::stage_conv_weights<G::WS>(waf, wa);
  i8::stage_conv_weights<G::WU>(wbf, wb);
  i8::stage_conv_weights<2>(w2f, w2);
  for (int i = tid; i < 4 * CU; i += i8::THREADS) ets[i] = __ldg(et + i);
  if (tid < CU) gts[tid] = __ldg(gt + tid);
  if (tid < 8) {
    eas[tid] = __ldg(ea + tid);
    ebs[tid] = __ldg(eb + tid);
    g1s[tid] = __ldg(g1 + tid);
    e2s[tid] = __ldg(e2 + tid);
    g2s[tid] = __ldg(g2 + tid);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // Blocks whose input union lies inside the image (and, for the tconv,
  // inside the upsampled region) skip the per-pixel edge tests: all but
  // the image's outer ring of blocks
  const bool inside = y0 >= 2 && x0 >= 2 && y0 + QS_R + 2 <= H && x0 + QS_R + 2 <= W;
  const bool up_inside = inside && y0 - 2 >= oy && x0 - 2 >= ox && y0 + QS_R + 2 - oy <= 2 * h &&
                         x0 + QS_R + 2 - ox <= 2 * w;

  // the tconv on the coarse window, each accumulator coded into the up
  // plane at its fine pixel (every union pixel is one coarse pixel's tap)
  constexpr int NC = QS_C * QS_C, MT = (NC + 15) / 16;
  auto tconv_phase = [&](auto all_in) {
    for (int m = warp; m < MT; m += i8::WARPS) {
      int acc[G::NT][4] = {};
      i8::tconv<C1, G::NT>(acc, x1q, min(16 * m + g, NC - 1), min(16 * m + g + 8, NC - 1), wtf,
                           lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 16 * m + g + 8 * hh;
        if (q >= NC) continue;
        const int cy = cy0 + q / QS_C, cx = cx0 + q % QS_C;
        const bool coarse_in = decltype(all_in)::value || (cy >= 0 && cy < h && cx >= 0 && cx < w);
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          const int tap = j / (CU / 8), o = (8 * j) % CU + 2 * t;
          const int gy = 2 * cy + (tap >> 1) + oy, gx = 2 * cx + (tap & 1) + ox;
          const int ty = gy - (y0 - 2), tx = gx - (x0 - 2);
          if (ty < 0 || ty >= QS_I || tx < 0 || tx >= QS_I) continue;
          const bool in = decltype(all_in)::value ||
                          (coarse_in && gy >= 0 && gy < H && gx >= 0 && gx < W);
          const int8_t c0 =
              in ? code(affine(acc[j][2 * hh], ets[tap * CU + o], gts[o]), -127.f) : 0;
          const int8_t c1 =
              in ? code(affine(acc[j][2 * hh + 1], ets[tap * CU + o + 1], gts[o + 1]), -127.f) : 0;
          i8::put2(upq + (ty * QS_I + tx) * CU + o, c0, c1);
        }
      }
    }
  };
  if (up_inside)
    tconv_phase(std::true_type{});
  else
    tconv_phase(std::false_type{});
  __syncthreads();

  // conv1 on the ring (origin y0-1, x0-1), two M tiles at a time along the
  // flattened ring; y1 = 0 where the ring leaves the image
  constexpr int NR = QS_Y * QS_Y, MR = (NR + 15) / 16;
  auto conv1_phase = [&](auto all_in) {
    for (int m0 = 2 * warp; m0 < MR; m0 += 2 * i8::WARPS) {
      int lo[2], hi[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ql = min(16 * (m0 + k) + g, NR - 1), qh = min(16 * (m0 + k) + g + 8, NR - 1);
        lo[k] = (ql / QS_Y) * QS_I + ql % QS_Y;
        hi[k] = (qh / QS_Y) * QS_I + qh % QS_Y;
      }
      int acc_a[2][1][4] = {}, acc_b[2][1][4] = {};
      i8::conv3x3<G::WS, QS_I, 2, 1>(acc_a, reinterpret_cast<const uint32_t*>(skip), lo, hi, waf,
                                  lane);
      i8::conv3x3<G::WU, QS_I, 2, 1>(acc_b, reinterpret_cast<const uint32_t*>(upq), lo, hi, wbf,
                                  lane);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = 16 * (m0 + k) + g + 8 * hh;
          if (q >= NR) continue;
          const int gy = y0 - 1 + q / QS_Y, gx = x0 - 1 + q % QS_Y;
          const bool in = decltype(all_in)::value || (gy >= 0 && gy < H && gx >= 0 && gx < W);
          int8_t c[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 2 * t + e;
            const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc_a[k][0][2 * hh + e]), eas[n]),
                                      __fmul_rn(__int2float_rn(acc_b[k][0][2 * hh + e]), ebs[n]));
            c[e] = in ? code(__fadd_rn(v, g1s[n]), 0.f) : (int8_t)0;
          }
          i8::put2(ring + q * 8 + 2 * t, c[0], c[1]);
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
  for (int m0 = 2 * warp; m0 < 2 * QS_R; m0 += 2 * i8::WARPS) {
    const int ty = m0 / 2;
    const int lo[2] = {ty * QS_Y + g, ty * QS_Y + 16 + g};
    const int hi[2] = {lo[0] + 8, lo[1] + 8};
    int acc[2][1][4] = {};
    i8::conv3x3<2, QS_Y, 2, 1>(acc, reinterpret_cast<const uint32_t*>(ring), lo, hi, w2f, lane);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tx = 16 * k + g + 8 * hh, n = 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = affine(acc[k][0][2 * hh + e], e2s[n + e], g2s[n + e]);
          if constexpr (!std::is_same<OT, int8_t>::value) v[e] = fmaxf(v[e], 0.f);
        }
        i8::put_out(ost + (ty * QS_R + tx) * 8 + n, v[0], v[1]);
      }
    }
  }
  __syncthreads();
  i8::copy_out<8 * sizeof(OT)>(reinterpret_cast<unsigned char*>(out + (size_t)b * H * W * 8),
                               smem, H, W, y0, x0, QS_R, QS_R);
}

template <int C1, int CS, int CU, class OT>
int launch_up_qs(const int8_t* x1, const int8_t* x2, const int* wt, const float* et,
                 const float* gt, const int* wa, const float* ea, const int* wb,
                 const float* eb, const float* g1, const int* w2, const float* e2,
                 const float* g2, OT* out, int B, int H, int W, int h, int w, int oy, int ox,
                 cudaStream_t stream) {
  constexpr int smem = QsGeom<C1, CS, CU, OT>::BYTES;
  auto kern = up_block_qs_kernel<C1, CS, CU, OT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // whole pixels by cp.async where each pixel is aligned to its pieces
  // (any view of a pixel-aligned tensor is, past its base)
  const int vec1 = reinterpret_cast<uintptr_t>(x1) % (C1 < 16 ? C1 : 16) == 0;
  const int vec2 = reinterpret_cast<uintptr_t>(x2) % (CS < 16 ? CS : 16) == 0;
  dim3 grid((W + QS_R - 1) / QS_R, (H + QS_R - 1) / QS_R, B);
  kern<<<grid, i8::THREADS, smem, stream>>>(x1, x2, wt, et, gt, wa, ea, wb, eb, g1, w2, e2, g2,
                                            out, H, W, h, w, oy, ox, vec1, vec2);
  return (int)cudaGetLastError();
}

// the DDA UNet's two Up blocks, (C1, CS, CU) with CM = COUT = 8
template <class OT>
int launch_up_qs_any(const int8_t* x1, const int8_t* x2, const int* wt, const float* et,
                     const float* gt, const int* wa, const float* ea, const int* wb,
                     const float* eb, const float* g1, const int* w2, const float* e2,
                     const float* g2, OT* out, int B, int H, int W, int h, int w, int oy,
                     int ox, int c1, int cs, int cu, int cm, int cout, cudaStream_t st) {
  if (cm != 8 || cout != 8) return -1;
#define POPCORN_UPQS(A, S, U)                                                                \
  if (c1 == A && cs == S && cu == U)                                                         \
    return launch_up_qs<A, S, U, OT>(x1, x2, wt, et, gt, wa, ea, wb, eb, g1, w2, e2, g2, out, \
                                     B, H, W, h, w, oy, ox, st);
  POPCORN_UPQS(16, 16, 16)
  POPCORN_UPQS(8, 8, 8)
#undef POPCORN_UPQS
  return -1;
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation. The tconv's codes are packed (4 taps, C1/4,
// Cu) int32 words, the convs' (9, Cin/4, Cout) (nn/quant.py::pack_dp4a).
// float_out: float32 features out, else int8 codes.
extern "C" int popcorn_up_block_qs(const int8_t* x1, const int8_t* x2, const int* wt,
                                   const float* et, const float* gt, const int* wa,
                                   const float* ea, const int* wb, const float* eb,
                                   const float* g1, const int* w2, const float* e2,
                                   const float* g2, void* out, int B, int H, int W,
                                   int h, int w, int oy, int ox, int c1, int cs,
                                   int cu, int cm, int cout, int float_out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (float_out)
    return popcorn::launch_up_qs_any(x1, x2, wt, et, gt, wa, ea, wb, eb, g1, w2, e2, g2,
                                     static_cast<float*>(out), B, H, W, h, w, oy, ox, c1, cs,
                                     cu, cm, cout, st);
  return popcorn::launch_up_qs_any(x1, x2, wt, et, gt, wa, ea, wb, eb, g1, w2, e2, g2,
                                   static_cast<int8_t*>(out), B, H, W, h, w, oy, ox, c1, cs,
                                   cu, cm, cout, st);
}

// The bf16 mode: the float features rounded to bf16 in the kernel (to
// nearest even, as the stream's cast to its compute dtype).
extern "C" int popcorn_up_block_qs_bf16(const int8_t* x1, const int8_t* x2, const int* wt,
                                        const float* et, const float* gt, const int* wa,
                                        const float* ea, const int* wb, const float* eb,
                                        const float* g1, const int* w2, const float* e2,
                                        const float* g2, __nv_bfloat16* out, int B, int H,
                                        int W, int h, int w, int oy, int ox, int c1, int cs,
                                        int cu, int cm, int cout, void* stream) {
  return popcorn::launch_up_qs_any(x1, x2, wt, et, gt, wa, ea, wb, eb, g1, w2, e2, g2, out, B,
                                   H, W, h, w, oy, ox, c1, cs, cu, cm, cout,
                                   static_cast<cudaStream_t>(stream));
}
