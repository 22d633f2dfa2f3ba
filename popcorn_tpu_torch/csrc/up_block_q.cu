// up_block_q.cu — kernel H: the dynamic-scale int8 (W8A8) Up block in one
// launch, on Hopper's int8 tensor cores.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _up_block_kernel_q (fused_up_block with quantized=True), on unpacked
// NHWC tensors, float32 or bf16 in and out. Per 16x16 output tile
// (nn/cuda_lib.py::TILE), with the 2-pixel halo and 0 outside the image:
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
// (tap, output channel), picked by the tap of the accumulator's column. In
// bf16 a value widens to float32 exactly and the output is rounded to
// nearest even: what the plain version computes between its casts.
//
// What bounds it on the H100: bytes. up1 reads 1024^2 x 8 + 2048^2 x 8
// values and writes 2048^2 x 8, 302 MB in float32 (0.090 ms at 3.35
// TB/s) and 151 MB in bf16 (0.045 ms); up2 117 and 59 MB (0.035, 0.018
// ms). Its products, about 15 G int8 operations at up1, take under 8 us at
// the int8 tensor rate.
//
// Design (the first design ran __dp4a on the CUDA cores, one
// thread a pixel of a 16x16 tile, and wrote each of the four quantized
// tensors as float32 into shared memory before a two-barrier block max and
// a coding pass; the wrapper widened bf16 inputs and rounded the output in
// three more passes):
// - Products on the tensor cores (int8_mma.cuh), as kernel F: conv1's two
//   parts and conv2 on mma.sync m16n8k32 with taps packed into K, the
//   tconv on m16n8k16 with coarse pixels as M and the 4 taps x CU output
//   columns as N (C1 = 8 zero-padded to K = 16).
// - A block owns two tiles side by side (16 x 32 outputs). Their inputs'
//   union (20 x 36 skip pixels, 11 x 19 coarse ones) arrives once by
//   cp.async, in the tensors' own dtype (16-byte pieces; element loads
//   for an input off that alignment). Each tile's halo is then coded at
//   that tile's own scale into its own planes (skip, up, coarse codes, y1
//   ring, 8 or 16 bytes a pixel, conflict-free without a swizzle): halo
//   pixels that two tiles share get two codes, as in the plain version.
//   The work of a tile is its own: 20 x 20 up codes, an 18 x 18 ring.
// - Scales without a float stage: the up values and y1 stay in the
//   tensor cores' accumulator registers, turned into floats in place,
//   while the block takes each tile's max-abs (warp shuffles, one barrier
//   a reduction, all tiles of a tensor in one); then they are coded from
//   the registers. The raw inputs are read from their staged union.
// - bf16 in and out in the kernel (the CLIs' default dtype): the wrapper
//   passes bf16 tensors straight through. The output leaves through a
//   shared-memory stage as 16-byte stores.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "int8_mma.cuh"

#ifndef POPCORN_TILE
#error "build with -DPOPCORN_TILE=<tile edge> (nn/cuda_lib.py::NVCC_FLAGS)"
#endif

namespace popcorn {

// A tile is one M tile a row in conv2: the scale groups are 16x16
static_assert(POPCORN_TILE == 16, "kernel H's geometry takes 16x16 scale tiles");
constexpr int Q_T = 16;            // tile edge
constexpr int Q_NT = 2;            // tiles a block, side by side
constexpr int Q_I = Q_T + 4;       // a tile's input window edge
constexpr int Q_Y = Q_T + 2;       // a tile's y1 ring edge
constexpr int Q_C = Q_I / 2 + 1;   // a tile's coarse window edge
constexpr int Q_UW = Q_NT * Q_T + 4;     // union width
constexpr int Q_UC = Q_UW / 2 + 1;       // union coarse width

template <class T, int C1, int CS, int CU>
struct QGeom {
  static constexpr int NTN = 4 * CU / 8;  // tconv n-tiles
  static constexpr int WS = CS / 4, WU = CU / 4;
  static constexpr int RAW2 = Q_I * Q_UW * CS * (int)sizeof(T);
  static constexpr int OUTST = Q_T * Q_NT * Q_T * 8 * (int)sizeof(T);
  static constexpr int RAW1 = 0;  // raw coarse union
  static constexpr int STAGE = align16(Q_C * Q_UC * C1 * (int)sizeof(T));  // raw skip union
  static constexpr int SKIP = STAGE + align16(RAW2 > OUTST ? RAW2 : OUTST);
  static constexpr int UP = SKIP + Q_NT * Q_I * Q_I * CS;
  static constexpr int X1Q = UP + Q_NT * Q_I * Q_I * CU;
  static constexpr int RING = X1Q + align16(Q_NT * Q_C * Q_C * C1);
  static constexpr int WT = RING + Q_NT * Q_Y * Q_Y * 8;
  static constexpr int WA = WT + NTN * 32 * 4;
  static constexpr int WB = WA + i8::ksteps<WS>() * 32 * 8;
  static constexpr int W2 = WB + i8::ksteps<WU>() * 32 * 8;
  static constexpr int VEC = W2 + i8::ksteps<2>() * 32 * 8;  // dt tt da db t1 d2 t2
  static constexpr int RED = VEC + 4 * (5 * CU + 5 * 8);     // three reductions' partials
  static constexpr int BYTES = RED + 4 * i8::WARPS * (2 * Q_NT + Q_NT + Q_NT);
  static_assert(C1 % 8 == 0 && CS % 8 == 0 && CU % 8 == 0 && C1 <= 16,
                "channels: 8 or 16 a tensor");
  static_assert(RAW2 % 16 == 0 && X1Q % 16 == 0 && RING % 16 == 0, "layout");
};

// does fine pixel 2c + d + off, d in {0, 1}, fall in [lo, hi)?
__device__ __forceinline__ bool hits(int c, int off, int lo, int hi) {
  const int f = 2 * c + off;
  return (f >= lo && f < hi) || (f + 1 >= lo && f + 1 < hi);
}

// blocks an SM the registers must leave room for: three at 8 channels
// (80 registers), two at 16, whose tconv keeps 64 up values a thread
template <class T, int C1, int CS, int CU>
__global__ void __launch_bounds__(i8::THREADS, C1 == 8 ? 3 : 2)
    up_block_q_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                      const int* __restrict__ wt, const float* __restrict__ dt,
                      const float* __restrict__ tt, const int* __restrict__ wa,
                      const float* __restrict__ da, const int* __restrict__ wb,
                      const float* __restrict__ db, const float* __restrict__ t1,
                      const int* __restrict__ w2, const float* __restrict__ d2,
                      const float* __restrict__ t2, T* __restrict__ out, int H, int W, int h,
                      int w, int oy, int ox, int vec) {
  using G = QGeom<T, C1, CS, CU>;
  extern __shared__ __align__(16) unsigned char smem[];
  const T* raw1 = reinterpret_cast<const T*>(smem + G::RAW1);  // Q_C x Q_UC x C1
  const T* raw2 = reinterpret_cast<const T*>(smem + G::STAGE);  // Q_I x Q_UW x CS
  T* ost = reinterpret_cast<T*>(smem + G::STAGE);  // the output stage, over raw2
  int8_t* skip = reinterpret_cast<int8_t*>(smem + G::SKIP);  // per tile Q_I x Q_I x CS
  int8_t* upq = reinterpret_cast<int8_t*>(smem + G::UP);
  int8_t* x1q = reinterpret_cast<int8_t*>(smem + G::X1Q);    // per tile Q_C x Q_C x C1
  int8_t* ring = reinterpret_cast<int8_t*>(smem + G::RING);  // per tile Q_Y x Q_Y x 8
  uint32_t* wtf = reinterpret_cast<uint32_t*>(smem + G::WT);
  uint2* waf = reinterpret_cast<uint2*>(smem + G::WA);
  uint2* wbf = reinterpret_cast<uint2*>(smem + G::WB);
  uint2* w2f = reinterpret_cast<uint2*>(smem + G::W2);
  float* dts = reinterpret_cast<float*>(smem + G::VEC);  // (4 taps, CU)
  float* tts = dts + 4 * CU;
  float* das = tts + CU;
  float* dbs = das + 8;
  float* t1s = dbs + 8;
  float* d2s = t1s + 8;
  float* t2s = d2s + 8;
  float* red_in = reinterpret_cast<float*>(smem + G::RED);  // skip and coarse maxima
  float* red_up = red_in + i8::WARPS * 2 * Q_NT;
  float* red_y1 = red_up + i8::WARPS * Q_NT;

  const int b = blockIdx.z, tid = threadIdx.x;
  const int y0 = blockIdx.y * Q_T, x0 = blockIdx.x * (Q_NT * Q_T);
  const int cy0 = (y0 - 2 - oy) >> 1, cx0 = (x0 - 2 - ox) >> 1;  // the coarse union
  auto in_image = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };

  const T* x2b = x2 + (size_t)b * H * W * CS;
  const T* x1b = x1 + (size_t)b * h * w * C1;
  i8::stage_pixels<CS * (int)sizeof(T)>(
      smem + G::STAGE, Q_I * Q_UW,
      [&](int p) -> const unsigned char* {
        const int gy = y0 - 2 + p / Q_UW, gx = x0 - 2 + p % Q_UW;
        if (!in_image(gy, gx)) return nullptr;
        return reinterpret_cast<const unsigned char*>(x2b + ((size_t)gy * W + gx) * CS);
      },
      x2b, vec != 0);
  i8::stage_pixels<C1 * (int)sizeof(T)>(
      smem + G::RAW1, Q_C * Q_UC,
      [&](int p) -> const unsigned char* {
        const int cy = cy0 + p / Q_UC, cx = cx0 + p % Q_UC;
        if (cy < 0 || cy >= h || cx < 0 || cx >= w) return nullptr;
        return reinterpret_cast<const unsigned char*>(x1b + ((size_t)cy * w + cx) * C1);
      },
      x1b, vec != 0);
  cp_async_commit();
  i8::stage_tconv_weights<C1, CU>(wtf, wt);
  i8::stage_conv_weights<G::WS>(waf, wa);
  i8::stage_conv_weights<G::WU>(wbf, wb);
  i8::stage_conv_weights<2>(w2f, w2);
  for (int i = tid; i < 4 * CU; i += i8::THREADS) dts[i] = __ldg(dt + i);
  if (tid < CU) tts[tid] = __ldg(tt + tid);
  if (tid < 8) {
    das[tid] = __ldg(da + tid);
    dbs[tid] = __ldg(db + tid);
    t1s[tid] = __ldg(t1 + tid);
    d2s[tid] = __ldg(d2 + tid);
    t2s[tid] = __ldg(t2 + tid);
  }
  cp_async_wait<0>();
  __syncthreads();

  // each tile's max-abs of its skip window and of its gathered coarse
  // input (the coarse pixels with a fine pixel in the window, the image
  // and the upsampled region: the staged zeros cover the rest)
  float mx[2 * Q_NT];
#pragma unroll
  for (int k = 0; k < 2 * Q_NT; ++k) mx[k] = 0.f;
  for (int i = tid; i < Q_I * Q_UW * (CS / 4); i += i8::THREADS) {
    const int ux = (i / (CS / 4)) % Q_UW;
    const float m = i8::absmax4(i8::load4(raw2 + 4 * i));
#pragma unroll
    for (int k = 0; k < Q_NT; ++k)
      if (ux >= Q_T * k && ux < Q_T * k + Q_I) mx[k] = fmaxf(mx[k], m);
  }
  const int wy0 = max(y0 - 2, 0), wy1 = min(y0 + Q_T + 2, H);
  for (int i = tid; i < Q_C * Q_UC * (C1 / 4); i += i8::THREADS) {
    const int p = i / (C1 / 4), cy = cy0 + p / Q_UC, cx = cx0 + p % Q_UC;
    if (!hits(cy, oy, wy0, wy1)) continue;
    const float m = i8::absmax4(i8::load4(raw1 + 4 * i));
#pragma unroll
    for (int k = 0; k < Q_NT; ++k) {
      const int xa = x0 + Q_T * k - 2;
      if (hits(cx, ox, max(xa, 0), min(xa + Q_I, W))) mx[Q_NT + k] = fmaxf(mx[Q_NT + k], m);
    }
  }
  i8::block_max(mx, red_in);
  // the scales amax / 127 and, for coding, their inverses 127 / amax
  float s2x[Q_NT], s1x[Q_NT], inv2[Q_NT], inv1[Q_NT];
#pragma unroll
  for (int k = 0; k < Q_NT; ++k) {
    const float a2 = fmaxf(mx[k], 1e-12f), a1 = fmaxf(mx[Q_NT + k], 1e-12f);
    s2x[k] = __fdiv_rn(a2, 127.f);
    s1x[k] = __fdiv_rn(a1, 127.f);
    inv2[k] = __fdiv_rn(127.f, a2);
    inv1[k] = __fdiv_rn(127.f, a1);
  }

  // code each tile's windows at its scales, a word of four channels at a
  // time (neighbouring threads on neighbouring words)
  auto code4 = [](float4 v, float inv) {
    return i8::pack4(code(__fmul_rn(v.x, inv), -127.f), code(__fmul_rn(v.y, inv), -127.f),
                     code(__fmul_rn(v.z, inv), -127.f), code(__fmul_rn(v.w, inv), -127.f));
  };
#pragma unroll
  for (int k = 0; k < Q_NT; ++k) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(skip) + k * Q_I * Q_I * (CS / 4);
    for (int i = tid; i < Q_I * Q_I * (CS / 4); i += i8::THREADS) {
      const int p = i / (CS / 4), c4 = i % (CS / 4);
      dst[i] = code4(i8::load4(raw2 + ((p / Q_I) * Q_UW + Q_T * k + p % Q_I) * CS + 4 * c4),
                     inv2[k]);
    }
    dst = reinterpret_cast<uint32_t*>(x1q) + k * Q_C * Q_C * (C1 / 4);
    for (int i = tid; i < Q_C * Q_C * (C1 / 4); i += i8::THREADS) {
      const int p = i / (C1 / 4), c4 = i % (C1 / 4);
      dst[i] = code4(i8::load4(raw1 + ((p / Q_C) * Q_UC + (Q_T / 2) * k + p % Q_C) * C1 + 4 * c4),
                     inv1[k]);
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // Blocks whose input union lies inside the image (and, for the tconv,
  // inside the upsampled region) skip the per-pixel edge tests: all but
  // the image's outer ring of blocks
  const bool inside = y0 >= 2 && x0 >= 2 && y0 + Q_T + 2 <= H && x0 + Q_NT * Q_T + 2 <= W;
  const bool up_inside = inside && y0 - 2 >= oy && x0 - 2 >= ox &&
                         y0 + Q_T + 2 - oy <= 2 * h && x0 + Q_NT * Q_T + 2 - ox <= 2 * w;

  // the tconv of each tile's coarse window: a tile's 8 M tiles on 8 /
  // Q_NT warps, 2 each; the up values as floats in the accumulators, 0
  // where the window leaves the image or the upsampled region
  constexpr int NC = Q_C * Q_C, MPW = (NC + 15) / 16 / (i8::WARPS / Q_NT);
  static_assert(MPW * 16 * (i8::WARPS / Q_NT) >= NC, "the warps cover the coarse window");
  const int kt = warp / (i8::WARPS / Q_NT);  // this warp's tile
  const int mt0 = MPW * (warp % (i8::WARPS / Q_NT));
  float upv[MPW][G::NTN][4];
  float mu = 0.f;
  const float s1k = i8::pick(s1x, kt);
  auto tconv_phase = [&](auto all_in) {
    const int8_t* cplane = x1q + kt * NC * C1;
#pragma unroll
    for (int mm = 0; mm < MPW; ++mm) {
      const int m = mt0 + mm;
      int acc[G::NTN][4] = {};
      i8::tconv<C1, G::NTN>(acc, reinterpret_cast<const uint32_t*>(cplane),
                            min(16 * m + g, NC - 1), min(16 * m + g + 8, NC - 1), wtf, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 16 * m + g + 8 * hh;
        const int cy = cy0 + q / Q_C, cx = cx0 + (Q_T / 2) * kt + q % Q_C;
        const bool coarse_in =
            q < NC && (decltype(all_in)::value || (cy >= 0 && cy < h && cx >= 0 && cx < w));
#pragma unroll
        for (int j = 0; j < G::NTN; ++j) {
          const int tap = j / (CU / 8), o = (8 * j) % CU + 2 * t;
          const int gy = 2 * cy + (tap >> 1) + oy, gx = 2 * cx + (tap & 1) + ox;
          const bool in = coarse_in && (decltype(all_in)::value || in_image(gy, gx)) &&
                          gy >= y0 - 2 && gy < y0 + Q_T + 2 && gx >= x0 + Q_T * kt - 2 &&
                          gx < x0 + Q_T * kt + Q_T + 2;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v =
                in ? affine(acc[j][2 * hh + e], __fmul_rn(dts[tap * CU + o + e], s1k),
                            tts[o + e])
                   : 0.f;
            upv[mm][j][2 * hh + e] = v;
            mu = fmaxf(mu, fabsf(v));
          }
        }
      }
    }
  };
  if (up_inside)
    tconv_phase(std::true_type{});
  else
    tconv_phase(std::false_type{});
  // every tile's su (a warp's values are all of its tile's)
  float su[Q_NT];
#pragma unroll
  for (int k = 0; k < Q_NT; ++k) su[k] = k == kt ? mu : 0.f;
  i8::block_max(su, red_up);
#pragma unroll
  for (int k = 0; k < Q_NT; ++k) su[k] = fmaxf(su[k], 1e-12f);
  const float inv_u = __fdiv_rn(127.f, i8::pick(su, kt));
#pragma unroll
  for (int k = 0; k < Q_NT; ++k) su[k] = __fdiv_rn(su[k], 127.f);
  // the up codes into the tile's plane: every window pixel is one coarse
  // pixel's tap
  {
    int8_t* uplane = upq + kt * Q_I * Q_I * CU;
#pragma unroll
    for (int mm = 0; mm < MPW; ++mm) {
      const int m = mt0 + mm;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 16 * m + g + 8 * hh;
        if (q >= NC) continue;
        const int cy = cy0 + q / Q_C, cx = cx0 + (Q_T / 2) * kt + q % Q_C;
#pragma unroll
        for (int j = 0; j < G::NTN; ++j) {
          const int tap = j / (CU / 8), o = (8 * j) % CU + 2 * t;
          const int ty = 2 * cy + (tap >> 1) + oy - (y0 - 2);
          const int tx = 2 * cx + (tap & 1) + ox - (x0 + Q_T * kt - 2);
          if (ty < 0 || ty >= Q_I || tx < 0 || tx >= Q_I) continue;
          i8::put2(uplane + (ty * Q_I + tx) * CU + o,
                   code(__fmul_rn(upv[mm][j][2 * hh], inv_u), -127.f),
                   code(__fmul_rn(upv[mm][j][2 * hh + 1], inv_u), -127.f));
        }
      }
    }
  }
  __syncthreads();

  // conv1 on each tile's ring (origin y0-1, x0+16k-1), M tiles along the
  // flattened ring, two at a time; y1 as floats in registers until the
  // tiles' scales are known
  constexpr int NR = Q_Y * Q_Y, MR = (NR + 15) / 16, MB = Q_NT * MR;
  constexpr int MPR = (MB + i8::WARPS - 1) / i8::WARPS;  // M tiles a warp, at most
  static_assert(MPR % 2 == 0, "M tiles in pairs");
  float y1v[MPR][4];
  float my[Q_NT];
#pragma unroll
  for (int k = 0; k < Q_NT; ++k) my[k] = 0.f;
  auto conv1_phase = [&](auto all_in) {
#pragma unroll
    for (int i = 0; i < MPR; i += 2) {
      int lo[2], hi[2], kk[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int mb = min(warp + i8::WARPS * (i + s), MB - 1);
        const int m = mb % MR;
        kk[s] = mb / MR;
        const int ql = min(16 * m + g, NR - 1), qh = min(16 * m + g + 8, NR - 1);
        lo[s] = kk[s] * Q_I * Q_I + (ql / Q_Y) * Q_I + ql % Q_Y;
        hi[s] = kk[s] * Q_I * Q_I + (qh / Q_Y) * Q_I + qh % Q_Y;
      }
      int acc_a[2][1][4] = {}, acc_b[2][1][4] = {};
      i8::conv3x3<G::WS, Q_I, 2, 1>(acc_a, reinterpret_cast<const uint32_t*>(skip), lo, hi, waf,
                                 lane);
      i8::conv3x3<G::WU, Q_I, 2, 1>(acc_b, reinterpret_cast<const uint32_t*>(upq), lo, hi, wbf,
                                 lane);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int mb = warp + i8::WARPS * (i + s), m = mb % MR, k = kk[s];
        const float ea = i8::pick(s2x, k), eb = i8::pick(su, k);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = 16 * m + g + 8 * hh;
          const int gy = y0 - 1 + q / Q_Y, gx = x0 + Q_T * k - 1 + q % Q_Y;
          const bool in = mb < MB && q < NR && (decltype(all_in)::value || in_image(gy, gx));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 2 * t + e;
            const float v = __fadd_rn(
                __fadd_rn(__fmul_rn(__int2float_rn(acc_a[s][0][2 * hh + e]), __fmul_rn(das[n], ea)),
                          __fmul_rn(__int2float_rn(acc_b[s][0][2 * hh + e]), __fmul_rn(dbs[n], eb))),
                t1s[n]);
            const float y = in ? fmaxf(v, 0.f) : 0.f;
            y1v[i + s][2 * hh + e] = y;
#pragma unroll
            for (int kq = 0; kq < Q_NT; ++kq)
              if (kq == k) my[kq] = fmaxf(my[kq], y);
          }
        }
      }
    }
  };
  if (inside)
    conv1_phase(std::true_type{});
  else
    conv1_phase(std::false_type{});
  i8::block_max(my, red_y1);
  float sy[Q_NT];
#pragma unroll
  for (int k = 0; k < Q_NT; ++k) {
    const float a = fmaxf(my[k], 1e-12f);
    sy[k] = __fdiv_rn(a, 127.f);
    my[k] = __fdiv_rn(127.f, a);
  }
#pragma unroll
  for (int i = 0; i < MPR; ++i) {
    const int mb = warp + i8::WARPS * i;
    if (mb >= MB) continue;
    const int m = mb % MR, k = mb / MR;
    const float inv = i8::pick(my, k);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = 16 * m + g + 8 * hh;
      if (q >= NR) continue;
      i8::put2(ring + (k * NR + q) * 8 + 2 * t, code(__fmul_rn(y1v[i][2 * hh], inv), -127.f),
               code(__fmul_rn(y1v[i][2 * hh + 1], inv), -127.f));
    }
  }
  __syncthreads();

  // conv2: a tile row is one M tile; two at a time, into the output stage
  for (int m0 = 2 * warp; m0 < Q_NT * Q_T; m0 += 2 * i8::WARPS) {
    int lo[2], hi[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = (m0 + s) / Q_T, r = (m0 + s) % Q_T;
      lo[s] = k * NR + r * Q_Y + g;
      hi[s] = lo[s] + 8;
    }
    int acc[2][1][4] = {};
    i8::conv3x3<2, Q_Y, 2, 1>(acc, reinterpret_cast<const uint32_t*>(ring), lo, hi, w2f, lane);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = (m0 + s) / Q_T, r = (m0 + s) % Q_T;
      const float syk = i8::pick(sy, k);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = 2 * t, x = Q_T * k + g + 8 * hh;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = fmaxf(affine(acc[s][0][2 * hh + e], __fmul_rn(d2s[n + e], syk), t2s[n + e]), 0.f);
        store2(ost + (r * (Q_NT * Q_T) + x) * 8 + n, v[0], v[1]);
      }
    }
  }
  __syncthreads();
  i8::copy_out<8 * sizeof(T)>(reinterpret_cast<unsigned char*>(out + (size_t)b * H * W * 8),
                              smem + G::STAGE, H, W, y0, x0, Q_T, Q_NT * Q_T);
}

template <class T, int C1, int CS, int CU>
int launch_up_q(const T* x1, const T* x2, const int* wt, const float* dt, const float* tt,
                const int* wa, const float* da, const int* wb, const float* db,
                const float* t1, const int* w2, const float* d2, const float* t2, T* out,
                int B, int H, int W, int h, int w, int oy, int ox, cudaStream_t stream) {
  constexpr int smem = QGeom<T, C1, CS, CU>::BYTES;
  auto kern = up_block_q_kernel<T, C1, CS, CU>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte pieces by cp.async when both inputs are aligned to them (any
  // view of an aligned tensor is: a pixel is 16, 32 or 64 bytes)
  const int vec = (reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2)) % 16 == 0;
  const int ntx = (W + Q_T - 1) / Q_T;
  dim3 grid((ntx + Q_NT - 1) / Q_NT, (H + Q_T - 1) / Q_T, B);
  kern<<<grid, i8::THREADS, smem, stream>>>(x1, x2, wt, dt, tt, wa, da, wb, db, t1, w2, d2, t2,
                                            out, H, W, h, w, oy, ox, vec);
  return (int)cudaGetLastError();
}

// the DDA UNet's two Up blocks, (C1, CS, CU) with CM = COUT = 8
template <class T>
int launch_up_q_any(const T* x1, const T* x2, const int* wt, const float* dt, const float* tt,
                    const int* wa, const float* da, const int* wb, const float* db,
                    const float* t1, const int* w2, const float* d2, const float* t2, T* out,
                    int B, int H, int W, int h, int w, int oy, int ox, int c1, int cs, int cu,
                    int cm, int cout, cudaStream_t st) {
  if (cm != 8 || cout != 8) return -1;
#define POPCORN_UPQ(A, S, U)                                                                   \
  if (c1 == A && cs == S && cu == U)                                                           \
    return launch_up_q<T, A, S, U>(x1, x2, wt, dt, tt, wa, da, wb, db, t1, w2, d2, t2, out, B, \
                                   H, W, h, w, oy, ox, st);
  POPCORN_UPQ(16, 16, 16)
  POPCORN_UPQ(8, 8, 8)
#undef POPCORN_UPQ
  return -1;
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation. Weights packed as for kernel F; float32 I/O.
extern "C" int popcorn_up_block_q(const float* x1, const float* x2, const int* wt,
                                  const float* dt, const float* tt, const int* wa,
                                  const float* da, const int* wb, const float* db,
                                  const float* t1, const int* w2, const float* d2,
                                  const float* t2, float* out, int B, int H, int W,
                                  int h, int w, int oy, int ox, int c1, int cs, int cu,
                                  int cm, int cout, void* stream) {
  return popcorn::launch_up_q_any(x1, x2, wt, dt, tt, wa, da, wb, db, t1, w2, d2, t2, out, B, H,
                                  W, h, w, oy, ox, c1, cs, cu, cm, cout,
                                  static_cast<cudaStream_t>(stream));
}

// The bf16 mode: bf16 x1, x2 and output; float32 vectors.
extern "C" int popcorn_up_block_q_bf16(const __nv_bfloat16* x1, const __nv_bfloat16* x2,
                                       const int* wt, const float* dt, const float* tt,
                                       const int* wa, const float* da, const int* wb,
                                       const float* db, const float* t1, const int* w2,
                                       const float* d2, const float* t2, __nv_bfloat16* out,
                                       int B, int H, int W, int h, int w, int oy, int ox, int c1,
                                       int cs, int cu, int cm, int cout, void* stream) {
  return popcorn::launch_up_q_any(x1, x2, wt, dt, tt, wa, da, wb, db, t1, w2, d2, t2, out, B, H,
                                  W, h, w, oy, ox, c1, cs, cu, cm, cout,
                                  static_cast<cudaStream_t>(stream));
}
