// double_conv_q.cu — kernel G: the dynamic-scale int8 (W8A8) DoubleConv in
// one launch, on Hopper's int8 tensor cores.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _double_conv_kernel_q (fused_double_conv with quantized=True), on plain
// NHWC tensors, float32 or bf16 in and out. Per 16x16 output tile
// (nn/cuda_lib.py::TILE), with the 2-pixel halo and 0 outside the image:
//   xq  = the tile's 20x20 input window quantized at its own scale sx;
//   y1  = relu(conv3x3(xq) * (d1 * sx) + t1) on the 18x18 ring, 0 outside
//         the image, quantized at its own scale sy;
//   out = relu(conv3x3(y1q) * (d2 * sy) + t2),
// with int8 weights per output channel and d = weight scale * folded BN
// scale (nn/double_conv.py::q_args). Each scale is amax / 127 over its
// tile (the JAX package's _quantize_slab over a TPU slab); the plain
// version (double_conv_q_plain) cuts the image into the same tiles. In
// bf16 a value widens to float32 exactly and the output is rounded to
// nearest even: what the plain version computes between its casts.
//
// What bounds it on the H100: bytes. The inc reads 2048^2 x 2 (SAR) or x 4
// values and writes 2048^2 x 8, 168 or 201 MB in float32 (0.050 or 0.060
// ms at 3.35 TB/s) and half that in bf16; its products, about 7 G int8
// operations, take under 4 us at the int8 tensor rate.
//
// Design (the first design ran __dp4a on the CUDA cores, one thread a
// pixel of a 16x16 tile, and wrote the input tile and y1 as float32 into
// shared memory before a two-barrier block max and a coding pass; the
// wrapper widened bf16 inputs and rounded the output in two more passes),
// as kernel H's:
// - Products on the tensor cores (int8_mma.cuh), as kernel E: both convs
//   on mma.sync m16n8k32 with taps packed into K, one or two n-tiles of 8
//   channels, the inc's one-word pixels on a k32 and a k16 step.
// - A block owns two tiles side by side (16 x 32 outputs). Their input
//   union (20 x 36 pixels) arrives once by cp.async, in the tensor's own
//   dtype (16-byte pieces, or the pixel; element loads for an input off
//   that alignment). Each tile's window is then coded at that tile's own
//   scale into its own plane: halo pixels that two tiles share get two
//   codes, as in the plain version. conv1 and the y1 codes are per tile
//   too (an 18 x 18 ring each), since its codes depend on the tile's sx.
// - Scales without a float stage: y1 stays in the tensor cores'
//   accumulator registers, turned into floats in place, while the block
//   takes each tile's max (warp shuffles, one barrier a reduction, both
//   tiles in one); then it is coded from the registers. The inputs' maxima
//   are read from the staged union.
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

// A tile row is one M tile in conv2: the scale groups are 16x16
static_assert(POPCORN_TILE == 16, "kernel G's geometry takes 16x16 scale tiles");
constexpr int G_T = 16;             // tile edge
constexpr int G_NT = 2;             // tiles a block, side by side
constexpr int G_I = G_T + 4;        // a tile's input window edge
constexpr int G_Y = G_T + 2;        // a tile's y1 ring edge
constexpr int G_UW = G_NT * G_T + 4;  // union width

template <class T, int CIN, int CM, int COUT>
struct GGeom {
  static constexpr int P = CIN < 4 ? 4 : CIN;  // plane bytes a pixel
  static constexpr int WX = P / 4, WM = CM / 4;  // words a pixel
  static constexpr int RAW = G_I * G_UW * CIN * (int)sizeof(T);
  static constexpr int OUTST = G_T * G_NT * G_T * COUT * (int)sizeof(T);
  static constexpr int STAGE = 0;  // the raw union, then the output stage
  static constexpr int XQ = align16(RAW > OUTST ? RAW : OUTST);
  static constexpr int RING = XQ + align16(G_NT * G_I * G_I * P);
  static constexpr int W1 = RING + align16(G_NT * G_Y * G_Y * CM);
  static constexpr int W2 = W1 + CM / 8 * i8::ksteps<WX>() * 32 * 8;
  static constexpr int VEC = W2 + COUT / 8 * i8::ksteps<WM>() * 32 * 8;  // d1 t1 d2 t2
  static constexpr int RED = VEC + 4 * (2 * CM + 2 * COUT);  // two reductions' partials
  static constexpr int BYTES = RED + 4 * i8::WARPS * 2 * G_NT;
  static_assert((CIN == 2 || CIN % 4 == 0) && CIN <= 16 && CM % 8 == 0 && COUT % 8 == 0 &&
                    CM <= 16 && COUT <= 16,
                "channels: 2, 4, 8 or 16 in, 8 or 16 after");
};

// word c4 (channels 4 c4 ..) of a staged pixel as floats, the channels
// past CIN zero
template <int CIN, class T>
__device__ __forceinline__ float4 load_word(const T* px, int c4) {
  if constexpr (CIN >= 4) {
    return i8::load4(px + 4 * c4);
  } else if constexpr (std::is_same<T, float>::value) {
    const float2 v = *reinterpret_cast<const float2*>(px);
    return make_float4(v.x, v.y, 0.f, 0.f);
  } else {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(px);
    return make_float4(__low2float(v), __high2float(v), 0.f, 0.f);
  }
}

// blocks an SM the registers must leave room for: five at 8 channels (48
// registers); at 16, where y1 keeps 48 values a thread, three for down1
// (80 registers with a 64-byte spill, 10% faster than two blocks) and two
// for down2, whose 16-channel input would spill hundreds of bytes at three
template <class T, int CIN, int CM, int COUT>
__global__ void __launch_bounds__(i8::THREADS, CM == 8 ? 5 : CIN == 8 ? 3 : 2)
    double_conv_q_kernel(const T* __restrict__ x, const int* __restrict__ w1,
                         const float* __restrict__ d1, const float* __restrict__ t1,
                         const int* __restrict__ w2, const float* __restrict__ d2,
                         const float* __restrict__ t2, T* __restrict__ out, int H, int W,
                         int vec) {
  using G = GGeom<T, CIN, CM, COUT>;
  constexpr int N1 = CM / 8, N2 = COUT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const T* raw = reinterpret_cast<const T*>(smem + G::STAGE);  // G_I x G_UW x CIN
  T* ost = reinterpret_cast<T*>(smem + G::STAGE);  // the output stage, over raw
  int8_t* xq = reinterpret_cast<int8_t*>(smem + G::XQ);      // per tile G_I x G_I x P
  int8_t* ring = reinterpret_cast<int8_t*>(smem + G::RING);  // per tile G_Y x G_Y x CM
  uint2* w1f = reinterpret_cast<uint2*>(smem + G::W1);
  uint2* w2f = reinterpret_cast<uint2*>(smem + G::W2);
  float* d1s = reinterpret_cast<float*>(smem + G::VEC);
  float* t1s = d1s + CM;
  float* d2s = t1s + CM;
  float* t2s = d2s + COUT;
  float* red_x = reinterpret_cast<float*>(smem + G::RED);
  float* red_y = red_x + i8::WARPS * G_NT;

  const int b = blockIdx.z, tid = threadIdx.x;
  const int y0 = blockIdx.y * G_T, x0 = blockIdx.x * (G_NT * G_T);
  auto in_image = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };

  const T* xb = x + (size_t)b * H * W * CIN;
  i8::stage_pixels<CIN * (int)sizeof(T)>(
      smem + G::STAGE, G_I * G_UW,
      [&](int p) -> const unsigned char* {
        const int gy = y0 - 2 + p / G_UW, gx = x0 - 2 + p % G_UW;
        if (!in_image(gy, gx)) return nullptr;
        return reinterpret_cast<const unsigned char*>(xb + ((size_t)gy * W + gx) * CIN);
      },
      xb, vec != 0);
  cp_async_commit();
  i8::stage_conv_weights<G::WX, CM>(w1f, w1);
  i8::stage_conv_weights<G::WM, COUT>(w2f, w2);
  if (tid < CM) {
    d1s[tid] = __ldg(d1 + tid);
    t1s[tid] = __ldg(t1 + tid);
  }
  if (tid < COUT) {
    d2s[tid] = __ldg(d2 + tid);
    t2s[tid] = __ldg(t2 + tid);
  }
  cp_async_wait<0>();
  __syncthreads();

  // each tile's max-abs over its window (the staged zeros cover what lies
  // outside the image), a word of four channels at a time
  constexpr int WU = G::WX;  // words a pixel in the planes
  float mx[G_NT];
#pragma unroll
  for (int k = 0; k < G_NT; ++k) mx[k] = 0.f;
  for (int i = tid; i < G_I * G_UW * WU; i += i8::THREADS) {
    const int p = i / WU, ux = p % G_UW;
    const float m = i8::absmax4(load_word<CIN>(raw + p * CIN, i % WU));
#pragma unroll
    for (int k = 0; k < G_NT; ++k)
      if (ux >= G_T * k && ux < G_T * k + G_I) mx[k] = fmaxf(mx[k], m);
  }
  i8::block_max(mx, red_x);
  // the scales amax / 127 and, for coding, their inverses 127 / amax
  float sx[G_NT];
#pragma unroll
  for (int k = 0; k < G_NT; ++k) {
    const float a = fmaxf(mx[k], 1e-12f);
    sx[k] = __fdiv_rn(a, 127.f);
    mx[k] = __fdiv_rn(127.f, a);
  }

  // code each tile's window at its scale into its plane
#pragma unroll
  for (int k = 0; k < G_NT; ++k) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(xq) + k * G_I * G_I * WU;
    for (int i = tid; i < G_I * G_I * WU; i += i8::THREADS) {
      const int p = i / WU;
      const float4 v = load_word<CIN>(raw + ((p / G_I) * G_UW + G_T * k + p % G_I) * CIN, i % WU);
      const float inv = mx[k];
      const int8_t c0 = code(__fmul_rn(v.x, inv), -127.f), c1 = code(__fmul_rn(v.y, inv), -127.f);
      dst[i] = CIN < 4 ? i8::pack4(c0, c1, 0, 0)  // the pad channels stay zero
                       : i8::pack4(c0, c1, code(__fmul_rn(v.z, inv), -127.f),
                                   code(__fmul_rn(v.w, inv), -127.f));
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // Blocks whose rings lie inside the image skip the per-pixel edge tests:
  // all but the image's outer ring of blocks
  const bool inside = y0 >= 1 && x0 >= 1 && y0 + G_T + 1 <= H && x0 + G_NT * G_T + 1 <= W;

  // conv1 on each tile's ring (origin y0-1, x0+16k-1), M tiles along the
  // flattened ring, two at a time; y1 as floats in registers until the
  // tiles' scales are known
  constexpr int NR = G_Y * G_Y, MR = (NR + 15) / 16, MB = G_NT * MR;
  constexpr int MPR = (MB + i8::WARPS - 1) / i8::WARPS;  // M tiles a warp, at most
  static_assert(MPR % 2 == 0, "M tiles in pairs");
  float y1v[MPR][N1][4];
  float my[G_NT];
#pragma unroll
  for (int k = 0; k < G_NT; ++k) my[k] = 0.f;
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
        lo[s] = kk[s] * G_I * G_I + (ql / G_Y) * G_I + ql % G_Y;
        hi[s] = kk[s] * G_I * G_I + (qh / G_Y) * G_I + qh % G_Y;
      }
      int acc[2][N1][4] = {};
      i8::conv3x3<G::WX, G_I, 2, N1>(acc, reinterpret_cast<const uint32_t*>(xq), lo, hi, w1f,
                                     lane);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int mb = warp + i8::WARPS * (i + s), m = mb % MR, k = kk[s];
        const float sxk = i8::pick(sx, k);
        float e1[N1][2];
#pragma unroll
        for (int j = 0; j < N1; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) e1[j][e] = __fmul_rn(d1s[8 * j + 2 * t + e], sxk);
        float mt = 0.f;  // this M tile's max
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = 16 * m + g + 8 * hh;
          const int gy = y0 - 1 + q / G_Y, gx = x0 + G_T * k - 1 + q % G_Y;
          const bool in = mb < MB && q < NR && (decltype(all_in)::value || in_image(gy, gx));
#pragma unroll
          for (int j = 0; j < N1; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = affine(acc[s][j][2 * hh + e], e1[j][e], t1s[8 * j + 2 * t + e]);
              const float y = in ? fmaxf(v, 0.f) : 0.f;
              y1v[i + s][j][2 * hh + e] = y;
              mt = fmaxf(mt, y);
            }
          }
        }
#pragma unroll
        for (int kq = 0; kq < G_NT; ++kq)
          if (kq == k) my[kq] = fmaxf(my[kq], mt);
      }
    }
  };
  if (inside)
    conv1_phase(std::true_type{});
  else
    conv1_phase(std::false_type{});
  i8::block_max(my, red_y);
  float sy[G_NT];
#pragma unroll
  for (int k = 0; k < G_NT; ++k) {
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
#pragma unroll
      for (int j = 0; j < N1; ++j)
        i8::put2(ring + (k * NR + q) * CM + 8 * j + 2 * t,
                 code(__fmul_rn(y1v[i][j][2 * hh], inv), -127.f),
                 code(__fmul_rn(y1v[i][j][2 * hh + 1], inv), -127.f));
    }
  }
  __syncthreads();

  // conv2: a tile row is one M tile; two at a time, into the output stage
  for (int m0 = 2 * warp; m0 < G_NT * G_T; m0 += 2 * i8::WARPS) {
    int lo[2], hi[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = (m0 + s) / G_T, r = (m0 + s) % G_T;
      lo[s] = k * NR + r * G_Y + g;
      hi[s] = lo[s] + 8;
    }
    int acc[2][N2][4] = {};
    i8::conv3x3<G::WM, G_Y, 2, N2>(acc, reinterpret_cast<const uint32_t*>(ring), lo, hi, w2f,
                                   lane);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = (m0 + s) / G_T, r = (m0 + s) % G_T;
      const float syk = i8::pick(sy, k);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int xo = G_T * k + g + 8 * hh;
#pragma unroll
        for (int j = 0; j < N2; ++j) {
          const int n = 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = fmaxf(affine(acc[s][j][2 * hh + e], __fmul_rn(d2s[n + e], syk), t2s[n + e]),
                         0.f);
          store2(ost + (r * (G_NT * G_T) + xo) * COUT + n, v[0], v[1]);
        }
      }
    }
  }
  __syncthreads();
  i8::copy_out<COUT * sizeof(T)>(reinterpret_cast<unsigned char*>(out + (size_t)b * H * W * COUT),
                                 smem + G::STAGE, H, W, y0, x0, G_T, G_NT * G_T);
}

template <class T, int CIN, int CM, int COUT>
int launch_q(const T* x, const int* w1, const float* d1, const float* t1, const int* w2,
             const float* d2, const float* t2, T* out, int B, int H, int W,
             cudaStream_t stream) {
  constexpr int smem = GGeom<T, CIN, CM, COUT>::BYTES;
  auto kern = double_conv_q_kernel<T, CIN, CM, COUT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // whole pixels by cp.async where each pixel is aligned to its pieces
  // (any view of a pixel-aligned tensor is, past its base)
  constexpr int PB = CIN * (int)sizeof(T);
  const int vec = reinterpret_cast<uintptr_t>(x) % (PB < 16 ? PB : 16) == 0;
  const int ntx = (W + G_T - 1) / G_T;
  dim3 grid((ntx + G_NT - 1) / G_NT, (H + G_T - 1) / G_T, B);
  kern<<<grid, i8::THREADS, smem, stream>>>(x, w1, d1, t1, w2, d2, t2, out, H, W, vec);
  return (int)cudaGetLastError();
}

template <class T>
int launch_q_any(const T* x, const int* w1, const float* d1, const float* t1, const int* w2,
                 const float* d2, const float* t2, T* out, int B, int H, int W, int cin, int cm,
                 int cout, cudaStream_t st) {
#define POPCORN_Q(CI, CMID, CO)                  \
  if (cin == CI && cm == CMID && cout == CO)     \
    return launch_q<T, CI, CMID, CO>(x, w1, d1, t1, w2, d2, t2, out, B, H, W, st);
  POPCORN_Q(2, 8, 8)
  POPCORN_Q(4, 8, 8)
  POPCORN_Q(8, 16, 16)
  POPCORN_Q(16, 16, 16)
#undef POPCORN_Q
  return -1;
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for a channel combination
// that has no instantiation. Weights are packed (9, ceil(Cin/4), Cout)
// int32 words (nn/quant.py::pack_dp4a); float32 I/O.
extern "C" int popcorn_double_conv_q(const float* x, const int* w1, const float* d1,
                                     const float* t1, const int* w2, const float* d2,
                                     const float* t2, float* out, int B, int H, int W, int cin,
                                     int cm, int cout, void* stream) {
  return popcorn::launch_q_any(x, w1, d1, t1, w2, d2, t2, out, B, H, W, cin, cm, cout,
                               static_cast<cudaStream_t>(stream));
}

// The bf16 mode: bf16 x and output; float32 vectors.
extern "C" int popcorn_double_conv_q_bf16(const __nv_bfloat16* x, const int* w1,
                                          const float* d1, const float* t1, const int* w2,
                                          const float* d2, const float* t2, __nv_bfloat16* out,
                                          int B, int H, int W, int cin, int cm, int cout,
                                          void* stream) {
  return popcorn::launch_q_any(x, w1, d1, t1, w2, d2, t2, out, B, H, W, cin, cm, cout,
                               static_cast<cudaStream_t>(stream));
}
