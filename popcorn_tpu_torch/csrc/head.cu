// head.cu — kernel C: the POPCORN head, a per-pixel MLP
// 16 -> 64 -> 64 -> 64 -> NOUT with ReLUs between the layers.
//
// Replaces the Pallas kernels popcorn_tpu/nn/pallas_head.py::_fwd_kernel
// (fused_head, 2-channel output, float32) and popcorn_tpu/nn/
// pallas_packed_head.py::_blockdiag_kernel, _blockdiag_kernel_cdt and
// _dense_kernel (fused_packed_head, channel 0 only, float32 or bf16). The
// packed kernels are TPU lane-fill layouts (space-to-depth lanes, kron
// block-diagonal weights) of one per-pixel function; here NOUT = 1
// computes that channel-0 output on unpacked features, and NOUT = 2 the
// two-channel fused_head output. Two modes:
//   float32: float32 in and out, float32 accuracy (3xTF32, below);
//   bf16 (NOUT = 1): _blockdiag_kernel_cdt's rounding: bf16 features and
//     weights, float32 biases and sums, h1..h3 rounded to bf16 after
//     bias and ReLU, the output rounded to bf16.
// Forward only: the backward (pallas_head.py::_bwd_kernel) is kernel D.
//
// What bounds it on the H100: arithmetic. The head does 9,280 (NOUT = 1)
// multiply-adds a pixel against 68 bytes read and written in float32 (34
// in bf16): 0.47 ms at 2048^2 for float32 accuracy on the tensor cores
// (three TF32 passes), 0.08 ms in bf16. The first design ran each pixel
// as FMA chains on the CUDA cores, one thread a pixel: every multiply-add
// read a weight from shared memory, and the SM's shared-memory load issue
// held it to 2.5x its FP32 bound.
//
// Design. The three 64-wide layers run on the tensor cores, mma.sync with
// float32 accumulators: m16n8k8 TF32 in the 3xTF32 form of mma_tf32.cuh
// (big rounded to nearest, as in kernel D) in float32 mode, about 27 MMAs
// a pixel; m16n8k16 bf16 in bf16 mode, 4.5 a pixel. Each warp owns a
// 16-pixel strip and computes whole layers for it (N = 64, eight n-tiles).
// Between layers the activations stay in registers: a layer's
// accumulator fragments, after bias and ReLU (and the bf16 rounding), are
// the next layer's A fragments, as in FlashAttention-2's P.V. The m16n8k16
// bf16 A layout matches the accumulator's directly; for m16n8k8 TF32 and
// for the first layer the reduction index k is permuted (``frag_k``), which
// a sum over k allows: the weights are staged in that order. A lane's
// input fragment is then the 4 channels 4t..4t+3 of its two pixels, one
// 16-byte (bf16: 8-byte) load each, conflict-free. The weights are staged once a block into
// shared memory in fragment order, pre-split into TF32 big/small parts
// (float32 mode) or as bf16 pairs, so each (k-step, n-tile) is one
// conflict-free 16- or 8-byte load a lane. A persistent grid (as many
// blocks as fit on the SMs) walks the strips with no block barrier after
// the staging; each warp's next strip of features arrives by cp.async
// into the second of its two shared-memory buffers while it computes the
// current one. Layer 4 (64 -> NOUT) runs on the
// CUDA cores from the layer-3 fragments, and a quad shuffle sums it. A
// ragged last strip reads zeros past N and writes only its valid pixels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "mma_tf32.cuh"

namespace popcorn {

constexpr int HC_IN = 16;
constexpr int HC_HID = 64;
constexpr int HC_NT = HC_HID / 8;  // n-tiles of 8 in a 64-wide layer
constexpr int HC_THREADS = 256;
constexpr int HC_WARPS = HC_THREADS / 32;
constexpr int HC_ROWS = 16;        // pixels a warp strip
constexpr int HC_W4_COLS = 2;      // w4 is (64, 2) whatever NOUT is

// k-steps over a K-deep layer: m16n8k8 (float32 mode) or m16n8k16 (bf16)
template <bool BF16>
__host__ __device__ constexpr int ksteps(int k) {
  return BF16 ? k / 16 : k / 8;
}

// one lane's B fragment of one (k-step, n-tile): {big0, big1, small0,
// small1} TF32 words (float32 mode) or two bf16 pairs (bf16 mode)
template <bool BF16>
using BRec = typename std::conditional<BF16, uint2, uint4>::type;
template <bool BF16>
using Elem = typename std::conditional<BF16, __nv_bfloat16, float>::type;

template <bool BF16>
__host__ __device__ constexpr int layer_records(int k) {
  return ksteps<BF16>(k) * HC_NT * 32;
}

// the floats of w4 and the biases b1..b3 (64 each) and b4 (2, padded to 4)
constexpr int HC_VEC_FLOATS = HC_HID * HC_W4_COLS + 3 * HC_HID + 4;
// a warp's two buffers of one strip's features
constexpr int HC_XBUF = 2 * HC_ROWS * HC_IN;

template <bool BF16>
constexpr size_t head_smem_bytes() {
  return sizeof(BRec<BF16>) * (layer_records<BF16>(HC_IN) + 2 * layer_records<BF16>(HC_HID)) +
         sizeof(float) * HC_VEC_FLOATS + sizeof(Elem<BF16>) * HC_WARPS * HC_XBUF;
}

// The input channel of a layer's weight that lane t's B fragment holds at
// k-step s, element r (r < 2 in float32 mode, r < 4 in bf16 mode). For
// the hidden layers in bf16 mode this is the natural order (the
// accumulator layout is the A layout); elsewhere k is permuted so that
// the A fragment is what the lane already holds: its input channels
// 4t..4t+3 (layer 1), or its accumulator columns 8s+2t, 8s+2t+1 (TF32).
template <bool BF16>
__device__ __forceinline__ int frag_k(int layer, int s, int t, int r) {
  if (layer == 0) return BF16 ? 4 * t + r : 4 * t + 2 * s + r;
  return BF16 ? 16 * s + 2 * t + (r & 1) + 8 * (r >> 1) : 8 * s + 2 * t + r;
}

// a (k, 64) weight into shared memory in fragment order
template <bool BF16>
__device__ __forceinline__ void stage_layer(BRec<BF16>* dst, const Elem<BF16>* __restrict__ w,
                                            int layer, int k) {
  for (int i = threadIdx.x; i < layer_records<BF16>(k); i += blockDim.x) {
    const int lane = i & 31, j = (i >> 5) % HC_NT, s = (i >> 5) / HC_NT;
    const int n = 8 * j + (lane >> 2), t = lane & 3;
    auto at = [&](int r) { return w[frag_k<BF16>(layer, s, t, r) * HC_HID + n]; };
    if constexpr (BF16) {
      dst[i] = make_uint2(bf16x2(at(0), at(1)), bf16x2(at(2), at(3)));
    } else {
      uint32_t b0, s0, b1, s1;
      split_tf32(at(0), b0, s0);
      split_tf32(at(1), b1, s1);
      dst[i] = make_uint4(b0, b1, s0, s1);
    }
  }
}

// d = the bias of each n-tile's columns 8j+2t, 8j+2t+1
__device__ __forceinline__ void init_bias(float (&d)[HC_NT][4], const float* bias, int t) {
#pragma unroll
  for (int j = 0; j < HC_NT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    d[j][0] = d[j][2] = b.x;
    d[j][1] = d[j][3] = b.y;
  }
}

// a strip's 16 pixels of features into a warp's shared-memory buffer by
// 16-byte cp.async, zero past N; one commit group
template <bool BF16>
__device__ __forceinline__ void prefetch_x(Elem<BF16>* buf, const Elem<BF16>* __restrict__ x,
                                           long long p0, long long n, int lane) {
  constexpr int PER_PX = HC_IN * (int)sizeof(Elem<BF16>) / 16;  // 16-byte chunks a pixel
#pragma unroll
  for (int c = lane; c < HC_ROWS * PER_PX; c += 32) {
    const int r = c / PER_PX, q = c % PER_PX;
    const bool ok = p0 + r < n;
    const float* src = reinterpret_cast<const float*>(ok ? x + (p0 + r) * HC_IN : x) + 4 * q;
    cp_async<16>(reinterpret_cast<float*>(buf + r * HC_IN) + 4 * q, src, ok ? 16 : 0);
  }
  cp_async_commit();
}

// the lane's features from a staged strip: channels 4t..4t+3 of pixels g
// (r0) and g+8 (r8), one 16-byte (bf16: 8-byte) load each
template <bool BF16>
struct XFrag {
  typename std::conditional<BF16, uint2, float4>::type r0, r8;
};

template <bool BF16>
__device__ __forceinline__ XFrag<BF16> read_x(const Elem<BF16>* buf, int g, int t) {
  using V = typename std::conditional<BF16, uint2, float4>::type;
  return {reinterpret_cast<const V*>(buf + g * HC_IN)[t],
          reinterpret_cast<const V*>(buf + (g + 8) * HC_IN)[t]};
}

// float32 mode: d += A(h) W for one 64-wide layer in the 3xTF32 form; the
// lane's A fragment at k-step s is its accumulator tile s (K permuted)
__device__ __forceinline__ void hidden_f32(float (&d)[HC_NT][4], const float (&h)[HC_NT][4],
                                           const uint4* __restrict__ w, int lane) {
#pragma unroll
  for (int s = 0; s < HC_NT; ++s) {
    uint32_t ab[4], as[4];
    split_tf32(h[s][0], ab[0], as[0]);  // (g, k 8s+2t)
    split_tf32(h[s][2], ab[1], as[1]);  // (g+8, k 8s+2t)
    split_tf32(h[s][1], ab[2], as[2]);  // (g, k 8s+2t+1)
    split_tf32(h[s][3], ab[3], as[3]);  // (g+8, k 8s+2t+1)
#pragma unroll
    for (int j = 0; j < HC_NT; ++j) {
      const uint4 b = w[(s * HC_NT + j) * 32 + lane];
      const uint32_t bb[2] = {b.x, b.y}, bs[2] = {b.z, b.w};
      mma_3xtf32(d[j], ab, as, bb, bs);
    }
  }
}

// bf16 mode: d += A W for one 64-wide layer, a[s] the packed A fragment
// of k-step s
__device__ __forceinline__ void hidden_bf16(float (&d)[HC_NT][4], const uint32_t (&a)[4][4],
                                            const uint2* __restrict__ w, int lane) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < HC_NT; ++j) {
      const uint2 b = w[(s * HC_NT + j) * 32 + lane];
      mma_bf16(d[j], a[s], b.x, b.y);
    }
}

// bf16 mode: relu(d) rounded to bf16, as the next layer's A fragments
// (k-step s covers n-tiles 2s and 2s+1)
__device__ __forceinline__ void pack_relu(uint32_t (&a)[4][4], const float (&d)[HC_NT][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = bf16x2(fmaxf(d[2 * s][0], 0.f), fmaxf(d[2 * s][1], 0.f));
    a[s][1] = bf16x2(fmaxf(d[2 * s][2], 0.f), fmaxf(d[2 * s][3], 0.f));
    a[s][2] = bf16x2(fmaxf(d[2 * s + 1][0], 0.f), fmaxf(d[2 * s + 1][1], 0.f));
    a[s][3] = bf16x2(fmaxf(d[2 * s + 1][2], 0.f), fmaxf(d[2 * s + 1][3], 0.f));
  }
}

template <bool BF16, int NOUT>
__global__ void __launch_bounds__(HC_THREADS, 2)
    head_kernel(const Elem<BF16>* __restrict__ x, const Elem<BF16>* __restrict__ w1,
                const float* __restrict__ b1, const Elem<BF16>* __restrict__ w2,
                const float* __restrict__ b2, const Elem<BF16>* __restrict__ w3,
                const float* __restrict__ b3, const Elem<BF16>* __restrict__ w4,
                const float* __restrict__ b4, Elem<BF16>* __restrict__ out, long long n) {
  using R = BRec<BF16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* r1 = reinterpret_cast<R*>(smem_raw);
  R* r2 = r1 + layer_records<BF16>(HC_IN);
  R* r3 = r2 + layer_records<BF16>(HC_HID);
  float* w4s = reinterpret_cast<float*>(r3 + layer_records<BF16>(HC_HID));
  float* bias = w4s + HC_HID * HC_W4_COLS;  // b1, b2, b3 (64 each), b4 (2)
  const int warp = threadIdx.x >> 5;
  Elem<BF16>* xbuf = reinterpret_cast<Elem<BF16>*>(w4s + HC_VEC_FLOATS) + warp * HC_XBUF;
  stage_layer<BF16>(r1, w1, 0, HC_IN);
  stage_layer<BF16>(r2, w2, 1, HC_HID);
  stage_layer<BF16>(r3, w3, 2, HC_HID);
  for (int i = threadIdx.x; i < HC_HID * HC_W4_COLS; i += blockDim.x) w4s[i] = to_float(w4[i]);
  for (int i = threadIdx.x; i < HC_HID; i += blockDim.x) {
    bias[i] = b1[i];
    bias[HC_HID + i] = b2[i];
    bias[2 * HC_HID + i] = b3[i];
  }
  if (threadIdx.x < HC_W4_COLS) bias[3 * HC_HID + threadIdx.x] = b4[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long nstrips = (n + HC_ROWS - 1) / HC_ROWS;
  const long long stride = (long long)gridDim.x * HC_WARPS;
  long long strip = (long long)blockIdx.x * HC_WARPS + warp;
  if (strip < nstrips) prefetch_x<BF16>(xbuf, x, strip * HC_ROWS, n, lane);
  for (int buf = 0; strip < nstrips; strip += stride, buf ^= 1) {
    const long long p0 = strip * HC_ROWS;
    // the next strip's features arrive while this one computes
    if (strip + stride < nstrips) {
      prefetch_x<BF16>(xbuf + (buf ^ 1) * HC_ROWS * HC_IN, x, (strip + stride) * HC_ROWS, n, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of this strip have landed
    const XFrag<BF16> cur = read_x<BF16>(xbuf + buf * HC_ROWS * HC_IN, g, t);
    __syncwarp();  // and been read before the next prefetch refills the buffer

    float d[HC_NT][4];
    float h[HC_NT][4];  // layer 3's activations, as layer 4 reads them
    init_bias(d, bias, t);
    if constexpr (BF16) {
      // layer 1: one k-step; k permuted to the lane's channels 4t..4t+3
      const uint32_t a[4] = {cur.r0.x, cur.r8.x, cur.r0.y, cur.r8.y};
#pragma unroll
      for (int j = 0; j < HC_NT; ++j) {
        const uint2 b = r1[j * 32 + lane];
        mma_bf16(d[j], a, b.x, b.y);
      }
      uint32_t act[4][4];
      pack_relu(act, d);
      init_bias(d, bias + HC_HID, t);
      hidden_bf16(d, act, r2, lane);
      pack_relu(act, d);
      init_bias(d, bias + 2 * HC_HID, t);
      hidden_bf16(d, act, r3, lane);
#pragma unroll
      for (int j = 0; j < HC_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[j][e] = round_to<__nv_bfloat16>(fmaxf(d[j][e], 0.f));
    } else {
      // layer 1: two k-steps; k-step s takes channels 4t+2s, 4t+2s+1
      const float c0[4] = {cur.r0.x, cur.r0.y, cur.r0.z, cur.r0.w};
      const float c8[4] = {cur.r8.x, cur.r8.y, cur.r8.z, cur.r8.w};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t ab[4], as[4];
        split_tf32(c0[2 * s], ab[0], as[0]);
        split_tf32(c8[2 * s], ab[1], as[1]);
        split_tf32(c0[2 * s + 1], ab[2], as[2]);
        split_tf32(c8[2 * s + 1], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < HC_NT; ++j) {
          const uint4 b = r1[(s * HC_NT + j) * 32 + lane];
          const uint32_t bb[2] = {b.x, b.y}, bs[2] = {b.z, b.w};
          mma_3xtf32(d[j], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int j = 0; j < HC_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[j][e] = fmaxf(d[j][e], 0.f);
      init_bias(d, bias + HC_HID, t);
      hidden_f32(d, h, r2, lane);
#pragma unroll
      for (int j = 0; j < HC_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[j][e] = fmaxf(d[j][e], 0.f);
      init_bias(d, bias + 2 * HC_HID, t);
      hidden_f32(d, h, r3, lane);
#pragma unroll
      for (int j = 0; j < HC_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[j][e] = fmaxf(d[j][e], 0.f);
    }

    // layer 4 on the CUDA cores: the lane's 16 columns 8j+2t(+1) of pixels
    // g (y0) and g+8 (y8), summed over the quad
    float y0[NOUT], y8[NOUT];
#pragma unroll
    for (int c = 0; c < NOUT; ++c) y0[c] = y8[c] = 0.f;
#pragma unroll
    for (int j = 0; j < HC_NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* wr = w4s + (8 * j + 2 * t + e) * HC_W4_COLS;
#pragma unroll
        for (int c = 0; c < NOUT; ++c) {
          y0[c] = fmaf(h[j][e], wr[c], y0[c]);
          y8[c] = fmaf(h[j][2 + e], wr[c], y8[c]);
        }
      }
#pragma unroll
    for (int c = 0; c < NOUT; ++c) {
      y0[c] += __shfl_xor_sync(0xffffffffu, y0[c], 1);
      y0[c] += __shfl_xor_sync(0xffffffffu, y0[c], 2);
      y8[c] += __shfl_xor_sync(0xffffffffu, y8[c], 1);
      y8[c] += __shfl_xor_sync(0xffffffffu, y8[c], 2);
    }
    // lane t = 0 writes pixel g, t = 1 pixel g + 8
    const long long p = p0 + g + 8 * t;
    if (t < 2 && p < n) {
#pragma unroll
      for (int c = 0; c < NOUT; ++c) {
        const float v = (t == 0 ? y0[c] : y8[c]) + bias[3 * HC_HID + c];
        if constexpr (BF16) out[p * NOUT + c] = __float2bfloat16_rn(v);
        else out[p * NOUT + c] = v;
      }
    }
  }
}

template <bool BF16, int NOUT>
int launch_head(const Elem<BF16>* x, const Elem<BF16>* w1, const float* b1,
                const Elem<BF16>* w2, const float* b2, const Elem<BF16>* w3, const float* b3,
                const Elem<BF16>* w4, const float* b4, Elem<BF16>* out, long long n,
                cudaStream_t stream) {
  constexpr size_t smem = head_smem_bytes<BF16>();
  auto kern = head_kernel<BF16, NOUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, HC_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  // the persistent grid: as many blocks as fit at once, fewer for a
  // small input (one strip a warp)
  const long long strips = (n + HC_ROWS - 1) / HC_ROWS;
  const long long want = (strips + HC_WARPS - 1) / HC_WARPS;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(want < cap ? want : cap);
  kern<<<grid, HC_THREADS, smem, stream>>>(x, w1, b1, w2, b2, w3, b3, w4, b4, out, n);
  return (int)cudaGetLastError();
}

}  // namespace popcorn

// x (n, 16), 16-byte aligned; weights (16,64), (64,64), (64,64), (64,2)
// and float32 biases. Returns a cudaError_t (0 on success), or -1 for an
// unsupported n_out or a misaligned x.
extern "C" int popcorn_head_f32(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* b2, const float* w3,
                                const float* b3, const float* w4, const float* b4, float* out,
                                long long n, int n_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return -1;
  if (n_out == 1)
    return popcorn::launch_head<false, 1>(x, w1, b1, w2, b2, w3, b3, w4, b4, out, n, st);
  if (n_out == 2)
    return popcorn::launch_head<false, 2>(x, w1, b1, w2, b2, w3, b3, w4, b4, out, n, st);
  return -1;
}

// The bf16 mode (channel 0 only): bf16 features, weights and output,
// float32 biases.
extern "C" int popcorn_head_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                                 const float* b1, const __nv_bfloat16* w2, const float* b2,
                                 const __nv_bfloat16* w3, const float* b3,
                                 const __nv_bfloat16* w4, const float* b4, __nv_bfloat16* out,
                                 long long n, int n_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (n_out != 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return -1;
  return popcorn::launch_head<true, 1>(x, w1, b1, w2, b2, w3, b3, w4, b4, out, n, st);
}
