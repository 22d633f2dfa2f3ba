// double_conv.cu — kernel A: one UNet DoubleConv block fused in one launch.
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_conv.py::
// _double_conv_kernel (public wrapper fused_double_conv): it computes
//   relu((conv3x3(relu((conv3x3(x) + b1) * g1 + h1)) + b2) * g2 + h2)
// with bias and frozen BN folded into one (s, t) per conv beforehand
// (the wrapper folds them as pallas_conv.py::_fold_affine does), on plain
// NHWC tensors instead of the TPU's space-to-depth packed lanes. y1 is
// zero outside the image (the trap that pallas_conv.py::_edge_mask exists
// for: it stands in for conv2's zero padding) and never reaches device
// memory.
//
// The storage type T is float or bf16. In bf16 the kernel rounds where
// _double_conv_kernel does at cdt = bf16: input and weights are bf16, the
// sums and the affine are float32, y1 is rounded to bf16 and the output is
// bf16. A bf16 x bf16 product is exact in float32, so a tensor-core
// product with float32 accumulation matches the MXU's up to the order of
// the sums.
//
// What bounds it on the H100: arithmetic. A DoubleConv of the DDA UNet does
// 9*(Cin*Cm + Cm*Cout) multiply-adds a pixel (up to 4,608) against
// (Cin + Cout) elements read and written. The first design ran each pixel
// as FMA chains on the CUDA cores, a thread a pixel, from float32
// pixel-major tiles: a warp's loads fell into 2-4 banks, the 18x18 ring
// kept 68 of 256 threads busy on its second pass, and the bf16 mode ran
// the same float32 chains (it was 2-9% slower than float32).
//
// Design. Both convs are implicit GEMMs on the tensor cores: M = 16
// pixels of a tile row, N = Cm or Cout (one or two n-tiles of 8), K =
// channels x taps. float32: mma.sync m16n8k8 TF32 in the 3xTF32 form of
// mma_tf32.cuh (big rounded to nearest), float32-accurate, with the small
// and the big terms in two accumulator chains (at most 36 MMAs a chain)
// added on the CUDA cores. bf16: m16n8k16 with float32 accumulators, one
// MMA a product. Shared memory holds the input tile and the y1 ring as
// 32-bit words, WPP words a pixel (one float, or two bf16 channels), so the
// bf16 mode stages and reads half the bytes. A block of 256 threads owns a
// TH x 30 output tile; its y1 ring is (TH+2) x 32 (two M tiles a row) and
// its input tile (TH+4) x 34; TH = 14 in float32 at 16 intermediate
// channels (two blocks an SM), else 30. Every warp takes the same number
// of ring rows.
//
// K runs in groups of four words; lane t of a quad reads word t of a
// group, so a group is one A register of 8 pixels (and of 8 more). At 8 or
// 16 words a pixel a group is 4 words of one tap, and each pixel's 4-word
// groups are XOR-permuted by the pixel (up_block.cu's chan), so the 32
// lanes hit 32 banks. At 1, 2 or 4 words a pixel the taps are packed into
// K instead (``kpos``): 4 / WPP taps of one tile row a group, padded with
// zero weights, so K = 24 or 40 (float32 at Cin 2, 4), 32, 48 or 80 (bf16
// at 2, 4, 8 channels) instead of a k-step a tap; a group's words then
// lie in one stretch of a row, conflict-free. The weights are staged once
// a block in fragment order: a lane's B fragment of one (k-step, n-tile)
// is one 16-byte load (float32: both words' TF32 big and small parts,
// split at staging) or 8-byte load (bf16 pairs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "mma_tf32.cuh"

namespace popcorn {

constexpr int DC_THREADS = 256;
constexpr int DC_WARPS = DC_THREADS / 32;
constexpr int DC_OW = 30;  // output tile width
constexpr int DC_RW = 32;  // y1 ring width: two M tiles of 16
constexpr int DC_IW = 34;  // input tile width

// a lane's B fragment of one (k-step, n-tile): {big0, big1, small0,
// small1} TF32 words (float32) or two bf16 pairs (bf16)
template <bool BF16>
using DcRec = typename std::conditional<BF16, uint2, uint4>::type;

// groups of 4 words in K for a tile of WPP words a pixel
__host__ __device__ constexpr int ngroups(int wpp) {
  return wpp >= 8 ? 9 * wpp / 4 : (wpp == 4 ? 10 : (wpp == 2 ? 6 : 4));
}

// The tile geometry and shared-memory layout (byte offsets) of one
// instantiation
template <class T, int CIN, int CM, int COUT>
struct DcGeom {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int EPW = BF16 ? 2 : 1;  // channels a 32-bit word
  static constexpr int WI = CIN / EPW;      // words a pixel: input tile
  static constexpr int WM = CM / EPW;       // and y1 ring
  static constexpr int TH = (!BF16 && CM == 16) ? 14 : 30;
  static constexpr int IH = TH + 4, RH = TH + 2;
  static constexpr int NT1 = CM / 8, NT2 = COUT / 8;
  static constexpr int KS1 = ngroups(WI) / 2, KS2 = ngroups(WM) / 2;
  // tile rows a warp takes at a time, two M tiles each: one at two
  // n-tiles in float32 (the accumulators of four would not fit)
  static constexpr int RPW1 = (!BF16 && NT1 == 2) ? 1 : 2;
  static constexpr int RPW2 = (!BF16 && NT2 == 2) ? 1 : 2;
  // blocks an SM the registers must leave room for: three in bf16, whose
  // blocks wait more on their staging than on their MMAs (at most 80
  // registers a thread)
  static constexpr int MIN_BLOCKS = BF16 ? 3 : 2;
  using Rec = DcRec<BF16>;
  static constexpr int W1 = 0;
  static constexpr int W2 = W1 + KS1 * NT1 * 32 * (int)sizeof(Rec);
  static constexpr int AFF = W2 + KS2 * NT2 * 32 * (int)sizeof(Rec);  // s1 t1 s2 t2
  static constexpr int TILE = AFF + 4 * (2 * CM + 2 * COUT);
  static constexpr int RING = TILE + 4 * IH * DC_IW * WI;
  static constexpr int BYTES = RING + 4 * RH * DC_RW * WM;
  static_assert(CIN % EPW == 0 && CM % 8 == 0 && COUT % 8 == 0, "channel counts");
  static_assert(RH % (RPW1 * DC_WARPS) == 0, "every warp takes the same ring rows");
  static_assert(TH % 2 == 0 && TILE % 16 == 0 && RING % 16 == 0, "layout");
  static_assert(BYTES <= 113 * 1024, "two blocks an SM");
};

// Where lane t's word of K-group grp lies: the tap (dy, dx), the word of
// the pixel, and whether it is a real entry (pad entries repeat a real
// word of the group, which the zero weight cancels).
struct KPos {
  int dy, dx, word;
  bool valid;
};
template <int WPP>
__device__ __forceinline__ KPos kpos(int grp, int t) {
  if constexpr (WPP >= 8) {  // 4 words of one tap
    constexpr int GPT = WPP / 4;
    const int tap = grp / GPT;
    return {tap / 3, tap % 3, 4 * (grp % GPT) + t, true};
  } else if constexpr (WPP == 4) {  // one tap a group, then a pad group
    const int tap = grp < 9 ? grp : 0;
    return {tap / 3, tap % 3, t, grp < 9};
  } else if constexpr (WPP == 2) {  // taps dx 0, 1 of row grp; then dx 2 and a pad
    if (grp < 3) return {grp, t >> 1, t & 1, true};
    return {grp - 3, 2, t & 1, (t >> 1) == 0};
  } else {  // the three taps of row grp and a pad; then a pad group
    if (grp < 3) return {grp, t < 3 ? t : 0, 0, t < 3};
    return {0, 0, 0, false};
  }
}

// The word offset of word `word` of tile pixel pix at WPP words a pixel:
// 4-word groups XOR-permuted by the pixel bits that the pixel stride
// leaves out of the bank index (at 8 and 16 words a pixel)
template <int WPP>
__device__ __forceinline__ int swz(int pix, int word) {
  if constexpr (WPP <= 4) {
    return pix * WPP + word;
  } else {
    constexpr int SH = WPP == 16 ? 1 : 2;
    return pix * WPP + (word ^ (((pix >> SH) & (WPP / 4 - 1)) << 2));
  }
}

// word k of the channels at p: one float, or two bf16 values
__device__ __forceinline__ uint32_t word_at(const float* p, int k) {
  return __float_as_uint(p[k]);
}
__device__ __forceinline__ uint32_t word_at(const __nv_bfloat16* p, int k) {
  return bf16x2(p[2 * k], p[2 * k + 1]);
}

// Stage the IH x 34 input window of one NHWC image (top-left at global
// (gy0, gx0), zero outside the image: conv1's SAME padding) as WPP words a
// pixel, in chunks of up to 4 words. `vec`: the image is aligned for the
// chunks, which then arrive by cp.async (all of a thread's in flight at
// once; the caller commits and waits); else word by word from its
// elements.
template <class T, int CIN, int WPP>
__device__ __forceinline__ void stage_input(uint32_t* tile, const T* __restrict__ img, int H,
                                            int W, int gy0, int gx0, int ih, bool vec) {
  constexpr int CHW = WPP < 4 ? WPP : 4, NCH = WPP / CHW;
  constexpr int EPW = CIN / WPP;
  for (int i = threadIdx.x; i < ih * DC_IW * NCH; i += DC_THREADS) {
    const int pix = i / NCH, c = i % NCH;
    const int gy = gy0 + pix / DC_IW, gx = gx0 + pix % DC_IW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* src = in ? img + ((size_t)gy * W + gx) * CIN + c * CHW * EPW : img;
    uint32_t* dst = tile + swz<WPP>(pix, c * CHW);
    if (vec) {
      cp_async<4 * CHW>(dst, src, in ? 4 * CHW : 0);
    } else {
#pragma unroll
      for (int k = 0; k < CHW; ++k) dst[k] = in ? word_at(src, k) : 0u;
    }
  }
}

// A (3, 3, C, N) HWIO weight into shared memory in fragment order for a
// source tile of WPP words a pixel: record (k-step s, n-tile j, lane) holds
// the lane's B fragment, groups 2s and 2s+1 of K at column 8j + lane/4
template <bool BF16, int WPP, int C, int N, class T>
__device__ __forceinline__ void stage_weights(DcRec<BF16>* dst, const T* __restrict__ w) {
  constexpr int NT = N / 8, KS = ngroups(WPP) / 2, EPW = BF16 ? 2 : 1;
  for (int i = threadIdx.x; i < KS * NT * 32; i += DC_THREADS) {
    const int lane = i & 31, j = (i >> 5) % NT, s = (i >> 5) / NT;
    const int n = 8 * j + (lane >> 2), t = lane & 3;
    float v[2][EPW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const KPos p = kpos<WPP>(2 * s + h, t);
#pragma unroll
      for (int e = 0; e < EPW; ++e)
        v[h][e] = p.valid ? to_float(w[((p.dy * 3 + p.dx) * C + p.word * EPW + e) * N + n]) : 0.f;
    }
    if constexpr (BF16) {
      dst[i] = make_uint2(bf16x2(v[0][0], v[0][1]), bf16x2(v[1][0], v[1][1]));
    } else {
      uint32_t b0, s0, b1, s1;
      split_tf32(v[0][0], b0, s0);
      split_tf32(v[1][0], b1, s1);
      dst[i] = make_uint4(b0, b1, s0, s1);
    }
  }
}

// d[m][j] += conv3x3 of the source tile (WPP words a pixel, RS pixels a
// row) for the NM M tiles whose top-left tap is tile pixel base[m] (16
// pixels along a row), over n-tile j of the fragment-order weights wf.
// float32: two chains a tile (mma_3xtf32's small and big terms; the
// caller adds them); bf16: one.
template <bool BF16, int WPP, int RS, int NM, int NT, class Rec>
__device__ __forceinline__ void conv3x3_mma(float (&d)[NM][NT][BF16 ? 1 : 2][4],
                                            const uint32_t* src, const int (&base)[NM],
                                            const Rec* wf, int lane) {
  constexpr int NG = ngroups(WPP);
  const int g = lane >> 2, t = lane & 3;
  // tap-packed K: the lane's word offset from a pixel, by group
  int off[WPP <= 4 ? NG : 1];
  if constexpr (WPP <= 4) {
#pragma unroll
    for (int grp = 0; grp < NG; ++grp) {
      const KPos p = kpos<WPP>(grp, t);
      off[grp] = (p.dy * RS + p.dx) * WPP + p.word;
    }
  }
  auto word = [&](int pix, int grp) -> uint32_t {
    if constexpr (WPP <= 4) {
      return src[pix * WPP + off[grp]];
    } else {
      const KPos p = kpos<WPP>(grp, t);
      return src[swz<WPP>(pix + p.dy * RS + p.dx, p.word)];
    }
  };
#pragma unroll
  for (int s = 0; s < NG / 2; ++s) {
    Rec b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = wf[(s * NT + j) * 32 + lane];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int p0 = base[m] + g;
      const uint32_t a[4] = {word(p0, 2 * s), word(p0 + 8, 2 * s), word(p0, 2 * s + 1),
                             word(p0 + 8, 2 * s + 1)};
      if constexpr (BF16) {
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(d[m][j][0], a, b[j].x, b[j].y);
      } else {
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ab[e], as[e]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t bb[2] = {b[j].x, b[j].y}, bs[2] = {b[j].z, b[j].w};
          mma_3xtf32(d[m][j][0], d[m][j][1], ab, as, bb, bs);
        }
      }
    }
  }
}

// the sum of an accumulator element's chains
template <int NC>
__device__ __forceinline__ float chains(const float (&d)[NC][4], int e) {
  return NC == 1 ? d[0][e] : d[0][e] + d[NC - 1][e];
}

template <class T, int CIN, int CM, int COUT>
__global__ void __launch_bounds__(DC_THREADS, (DcGeom<T, CIN, CM, COUT>::MIN_BLOCKS))
    double_conv_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                       const float* __restrict__ s1, const float* __restrict__ t1,
                       const T* __restrict__ w2, const float* __restrict__ s2,
                       const float* __restrict__ t2, T* __restrict__ out, int H, int W,
                       int vec) {
  using G = DcGeom<T, CIN, CM, COUT>;
  using Rec = typename G::Rec;
  constexpr int NC = G::BF16 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  Rec* w1f = reinterpret_cast<Rec*>(smem + G::W1);
  Rec* w2f = reinterpret_cast<Rec*>(smem + G::W2);
  float* aff = reinterpret_cast<float*>(smem + G::AFF);
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem + G::TILE);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + G::RING);
  const int b = blockIdx.z, tid = threadIdx.x;
  const int y0 = blockIdx.y * G::TH, x0 = blockIdx.x * DC_OW;

  stage_input<T, CIN, G::WI>(tile, x + (size_t)b * H * W * CIN, H, W, y0 - 2, x0 - 2, G::IH,
                             vec != 0);
  cp_async_commit();
  // the weights and affine vectors while the input tile is in flight
  stage_weights<G::BF16, G::WI, CIN, CM>(w1f, w1);
  stage_weights<G::BF16, G::WM, CM, COUT>(w2f, w2);
  for (int i = tid; i < CM; i += DC_THREADS) {
    aff[i] = __ldg(s1 + i);
    aff[CM + i] = __ldg(t1 + i);
  }
  for (int i = tid; i < COUT; i += DC_THREADS) {
    aff[2 * CM + i] = __ldg(s2 + i);
    aff[2 * CM + COUT + i] = __ldg(t2 + i);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // conv1 on the ring (global origin y0-1, x0-1): y1 = relu(acc*s1 + t1)
  // rounded to T, 0 where the ring leaves the image
  constexpr int R1 = G::RPW1, NM1 = 2 * R1;
  for (int ry = R1 * warp; ry < G::RH; ry += R1 * DC_WARPS) {
    float d[NM1][G::NT1][NC][4] = {};
    int base[NM1];
#pragma unroll
    for (int m = 0; m < NM1; ++m) base[m] = (ry + m / 2) * DC_IW + 16 * (m % 2);
    conv3x3_mma<G::BF16, G::WI, DC_IW, NM1, G::NT1>(d, tile, base, w1f, lane);
#pragma unroll
    for (int m = 0; m < NM1; ++m) {
      const int r = ry + m / 2, gy = y0 - 1 + r;
#pragma unroll
      for (int j = 0; j < G::NT1; ++j) {
        const int n = 8 * j + 2 * t;
        const float sa = aff[n], sb = aff[n + 1], ta = aff[CM + n], tb = aff[CM + n + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rx = 16 * (m % 2) + g + 8 * hh, gx = x0 - 1 + rx;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const float ya =
              in ? round_to<T>(fmaxf(fmaf(chains(d[m][j], 2 * hh), sa, ta), 0.f)) : 0.f;
          const float yb =
              in ? round_to<T>(fmaxf(fmaf(chains(d[m][j], 2 * hh + 1), sb, tb), 0.f)) : 0.f;
          const int q = r * DC_RW + rx;
          if constexpr (G::BF16) {
            ring[swz<G::WM>(q, n / 2)] = bf16x2(ya, yb);
          } else {
            *reinterpret_cast<float2*>(ring + swz<G::WM>(q, n)) = make_float2(ya, yb);
          }
        }
      }
    }
  }
  __syncthreads();

  // conv2 on the output tile: two M tiles a row, at x 0 and 14 (the
  // second stores x >= 16)
  constexpr int R2 = G::RPW2, NM2 = 2 * R2;
  const float* s2s = aff + 2 * CM;
  const float* t2s = s2s + COUT;
  for (int ty = R2 * warp; ty < G::TH; ty += R2 * DC_WARPS) {
    if (y0 + ty >= H) break;
    float d[NM2][G::NT2][NC][4] = {};
    int base[NM2];
#pragma unroll
    for (int m = 0; m < NM2; ++m) base[m] = (ty + m / 2) * DC_RW + 14 * (m % 2);
    conv3x3_mma<G::BF16, G::WM, DC_RW, NM2, G::NT2>(d, ring, base, w2f, lane);
#pragma unroll
    for (int m = 0; m < NM2; ++m) {
      const int gy = y0 + ty + m / 2;
      T* orow = out + ((size_t)b * H + gy) * W * COUT;
#pragma unroll
      for (int j = 0; j < G::NT2; ++j) {
        const int n = 8 * j + 2 * t;
        const float sa = s2s[n], sb = s2s[n + 1], ta = t2s[n], tb = t2s[n + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int px = g + 8 * hh, gx = x0 + 14 * (m % 2) + px;
          if ((m % 2 == 0 || px >= 2) && gy < H && gx < W)
            store2(orow + (size_t)gx * COUT + n,
                   fmaxf(fmaf(chains(d[m][j], 2 * hh), sa, ta), 0.f),
                   fmaxf(fmaf(chains(d[m][j], 2 * hh + 1), sb, tb), 0.f));
        }
      }
    }
  }
}

template <class T, int CIN, int CM, int COUT>
int launch(const T* x, const T* w1, const float* s1, const float* t1,
           const T* w2, const float* s2, const float* t2, T* out,
           int B, int H, int W, cudaStream_t stream) {
  using G = DcGeom<T, CIN, CM, COUT>;
  auto kern = double_conv_kernel<T, CIN, CM, COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  // a staging chunk is up to 16 bytes of a pixel: vector loads when the
  // image is aligned to it (any view of a pixel-aligned tensor is, past
  // its base)
  constexpr int CHUNK = 4 * (G::WI < 4 ? G::WI : 4);
  const int vec = reinterpret_cast<uintptr_t>(x) % CHUNK == 0;
  dim3 grid((W + DC_OW - 1) / DC_OW, (H + G::TH - 1) / G::TH, B);
  kern<<<grid, DC_THREADS, G::BYTES, stream>>>(x, w1, s1, t1, w2, s2, t2, out, H, W, vec);
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
