// head_bwd.cu — kernel D: the backward of the POPCORN head, a per-pixel
// MLP 16 -> 64 -> 64 -> 64 -> 2 with ReLUs (kernel C is its forward).
//
// Replaces the Pallas kernel popcorn_tpu/nn/pallas_head.py::_bwd_kernel,
// the backward of fused_head's custom VJP. For every pixel of x (N,16)
// and the output cotangent g (N,2) it recomputes
//   h1 = relu(x W1 + b1), h2 = relu(h1 W2 + b2), h3 = relu(h2 W3 + b3)
// (the input is the only residual), propagates
//   g3 = (g W4^T) * [h3 > 0], g2 = (g3 W3^T) * [h2 > 0],
//   g1 = (g2 W2^T) * [h1 > 0], dx = g1 W1^T,
// and sums the weight gradients over all pixels:
//   dW4 = h3^T g, dW3 = h2^T g3, dW2 = h1^T g2, dW1 = x^T g1,
//   db_l = column sums of g, g3, g2, g1.
//
// What bounds it on the H100: arithmetic, about 55.8k FLOPs a pixel
// (recompute, propagation and weight gradients, a third each) against
// 136 bytes a pixel read and written (x, g, dx). On the CUDA cores the
// first design was held to about a quarter of the FP32 peak by shared-
// memory issue: every multiply-add read one operand from shared memory.
//
// Design. The nine 64-wide products (three forward, three propagations
// including dx, three weight gradients) run on the tensor cores as
// mma.sync.m16n8k8 in the 3xTF32 form (mma_tf32.cuh), float32-accurate.
// A persistent grid of two 256-thread blocks an SM walks 64-pixel tiles;
// x and g of the next tile arrive by cp.async into a second buffer while
// the current one is computed. Per tile, the weights and three 64x64
// activation buffers sit in shared memory: h1, h2, h3 are computed into
// them, then g3 overwrites h3, g2 overwrites h2 and g1 overwrites h1, each
// only after the weight gradient that still reads the old values. Each
// warp owns a 16x32 tile of every 64x64 product; the weight gradients'
// tiles (dW3, dW2 and a 16x8 tile of dW1) stay in its registers across
// all of the block's pixel tiles, each tile's sum formed in a fresh
// accumulator and then added on the CUDA cores. Every buffer is read both as A (row =
// pixel) and transposed (row = channel, in the weight gradients), so rows
// are 64 floats with the column XOR-swizzled by the row (``sw``): both
// fragment patterns then hit 32 distinct banks. The 64x2 pieces (g3, dW4,
// db4) and the bias column sums run on the CUDA cores. Determinism as in
// the first design: each block writes its partial row to a (blocks, 9538)
// buffer, and head_bwd_reduce sums the rows in block order, no atomics.
// A ragged last tile reads zeros past N (cp.async zero-fill): a zero g
// makes those pixels add nothing to any gradient, and their dx is not
// written.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace popcorn {

constexpr int BIN = 16;      // input channels
constexpr int BHID = 64;     // hidden units
constexpr int BOUT = 2;      // output channels
constexpr int BT = 256;      // threads a block: 8 warps
constexpr int TP = 64;       // pixels a tile
constexpr int XRS = 32;      // row stride of the x tile (16 used, swizzled)
constexpr int MAX_BLOCKS = 132 * 2;

// offsets of the flat gradient vector [dW1 db1 dW2 db2 dW3 db3 dW4 db4]
constexpr int OFF_W1 = 0;
constexpr int OFF_B1 = OFF_W1 + BIN * BHID;
constexpr int OFF_W2 = OFF_B1 + BHID;
constexpr int OFF_B2 = OFF_W2 + BHID * BHID;
constexpr int OFF_W3 = OFF_B2 + BHID;
constexpr int OFF_B3 = OFF_W3 + BHID * BHID;
constexpr int OFF_W4 = OFF_B3 + BHID;
constexpr int OFF_B4 = OFF_W4 + BHID * BOUT;
constexpr int NPART = OFF_B4 + BOUT;  // 9538

constexpr int smem_floats() {
  return BIN * BHID + 2 * BHID * BHID + BHID * BOUT + 3 * BHID +
         2 * TP * XRS + 2 * TP * BOUT + 3 * TP * BHID;
}

// The swizzled index of (row p, column f) in a buffer of RS-float rows.
// XOR-ing the column with (p%4)*8 + (p&4) sends the 32 lanes of an A
// fragment (rows g, columns t) and of a transposed one (rows t, columns g)
// to 32 distinct banks; it keeps groups of 4 columns together, so float2
// stores and 16-byte cp.async stay aligned.
template <int RS>
__device__ __forceinline__ int sw(int p, int f) {
  return p * RS + (f ^ (((p & 3) << 3) | (p & 4)));
}

// d = 0, or the bias of the warp tile's columns n0 + 8j + 2t (+1)
template <int NT>
__device__ __forceinline__ void init_acc(float (&d)[NT][4], const float* bias, int n0,
                                         int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float b0 = bias ? bias[n0 + 8 * j + 2 * t] : 0.f;
    const float b1 = bias ? bias[n0 + 8 * j + 2 * t + 1] : 0.f;
    d[j][0] = d[j][2] = b0;
    d[j][1] = d[j][3] = b1;
  }
}

// d += A(m0.., 0..K) B(0..K, n0..), K a multiple of 8
template <int K, int NT, class AF, class BF>
__device__ __forceinline__ void warp_gemm(float (&d)[NT][4], AF a_at, BF b_at, int m0,
                                          int n0, int g, int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) mma_kstep<NT>(d, a_at, b_at, m0, k0, n0, g, t);
}

// sum += A(m0.., 0..K) B(0..K, n0..) over one tile's pixels: formed in a
// fresh accumulator, then added on the CUDA cores (mma_tf32.cuh: the
// tensor core's accumulation would drift over a block's thousands of
// pixels)
template <int K, int NT, class AF, class BF>
__device__ __forceinline__ void warp_gemm_sum(float (&sum)[NT][4], AF a_at, BF b_at,
                                              int m0, int n0, int g, int t) {
  float d[NT][4];
  init_acc<NT>(d, nullptr, 0, 0);
  warp_gemm<K, NT>(d, a_at, b_at, m0, n0, g, t);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[j][e] += d[j][e];
}

// relu(d) into the 64-wide swizzled buffer at rows m0+g, m0+g+8
template <int NT>
__device__ __forceinline__ void store_relu(const float (&d)[NT][4], float* buf, int m0,
                                           int n0, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(buf + sw<BHID>(m0 + g, c)) =
        make_float2(fmaxf(d[j][0], 0.f), fmaxf(d[j][1], 0.f));
    *reinterpret_cast<float2*>(buf + sw<BHID>(m0 + g + 8, c)) =
        make_float2(fmaxf(d[j][2], 0.f), fmaxf(d[j][3], 0.f));
  }
}

// buf = d * [buf > 0]: the activation in buf becomes the gradient at its
// pre-activation (each element is read and written by the same thread)
template <int NT>
__device__ __forceinline__ void store_masked(const float (&d)[NT][4], float* buf, int m0,
                                             int n0, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* p = reinterpret_cast<float2*>(buf + sw<BHID>(m0 + g + 8 * h, c));
      const float2 a = *p;
      *p = make_float2(a.x > 0.f ? d[j][2 * h] : 0.f, a.y > 0.f ? d[j][2 * h + 1] : 0.f);
    }
  }
}

// the column sum of a 64-wide buffer over this thread's 16 pixels
__device__ __forceinline__ float col_sum(const float* buf, int u, int q) {
  float s = 0.f;
#pragma unroll 4
  for (int i = 0; i < TP / 4; ++i) s += buf[sw<BHID>(q * (TP / 4) + i, u)];
  return s;
}

__global__ void __launch_bounds__(BT, 2)
    head_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ w4, float* __restrict__ dx,
                    float* __restrict__ part, long long n) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                  // 16 x 64, swizzled
  float* w2s = w1s + BIN * BHID;      // 64 x 64, swizzled
  float* w3s = w2s + BHID * BHID;     // 64 x 64, swizzled
  float* w4s = w3s + BHID * BHID;     // 64 x 2
  float* b1s = w4s + BHID * BOUT;
  float* b2s = b1s + BHID;
  float* b3s = b2s + BHID;
  float* xs0 = b3s + BHID;            // two TP x XRS x tiles
  float* gs0 = xs0 + 2 * TP * XRS;    // two TP x 2 cotangent tiles
  float* A = gs0 + 2 * TP * BOUT;     // h1, then g1
  float* B = A + TP * BHID;           // h2, then g2
  float* C = B + TP * BHID;           // h3, then g3

  const int tid = threadIdx.x;
  for (int i = tid; i < BIN * BHID; i += BT) w1s[sw<BHID>(i / BHID, i % BHID)] = w1[i];
  for (int i = tid; i < BHID * BHID; i += BT) {
    w2s[sw<BHID>(i / BHID, i % BHID)] = w2[i];
    w3s[sw<BHID>(i / BHID, i % BHID)] = w3[i];
  }
  for (int i = tid; i < BHID * BOUT; i += BT) w4s[i] = w4[i];
  if (tid < BHID) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
    b3s[tid] = b3[tid];
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row / column
  const int mb = (warp & 3) * 16;           // the warp's 16 rows of a 64-row product
  const int nh = (warp >> 2) * 32;          // and its 32 columns of a 64-wide one
  const int u = tid & (BHID - 1);           // CUDA-core passes: column u,
  const int q = tid / BHID;                 // pixels q*16 .. q*16+15

  float dw3[4][4], dw2[4][4], dw1[1][4];
  init_acc<4>(dw3, nullptr, 0, 0);
  init_acc<4>(dw2, nullptr, 0, 0);
  init_acc<1>(dw1, nullptr, 0, 0);
  float db1 = 0.f, db2 = 0.f, db3 = 0.f, dw40 = 0.f, dw41 = 0.f, db4 = 0.f;

  const long long ntiles = (n + TP - 1) / TP;
  // x and g of a tile into buffer `buf`, zero past N
  auto prefetch = [&](long long tile, int buf) {
    const long long p0 = tile * TP;
    float* xd = xs0 + buf * TP * XRS;
    for (int c = tid; c < TP * (BIN / 4); c += BT) {
      const int p = c / (BIN / 4), k = c % (BIN / 4);
      const bool ok = p0 + p < n;
      cp_async<16>(xd + sw<XRS>(p, 4 * k), ok ? x + (p0 + p) * BIN + 4 * k : x, ok ? 16 : 0);
    }
    if (tid < TP * BOUT / 4) {  // 16 bytes = the cotangents of 2 pixels
      const long long p = p0 + 2 * tid;
      const int valid = p >= n ? 0 : (n - p >= 2 ? 2 : 1);
      cp_async<16>(gs0 + buf * TP * BOUT + 4 * tid, valid ? g + p * BOUT : g, valid * 8);
    }
    cp_async_commit();
  };

  int cur = 0;
  if ((long long)blockIdx.x < ntiles) prefetch(blockIdx.x, 0);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, cur ^= 1) {
    __syncthreads();  // the previous tile's readers are done
    if (tile + gridDim.x < ntiles) {
      prefetch(tile + gridDim.x, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's x and g have landed
    const float* xs = xs0 + cur * TP * XRS;
    const float* gs = gs0 + cur * TP * BOUT;
    const long long p0 = tile * TP;
    const int nv = (int)(n - p0 < TP ? n - p0 : TP);

    // operand readers: a 64-wide buffer as A (rows = pixels) or
    // transposed (rows = channels), a weight as B (k = its input) or
    // transposed (k = its output)
    auto rows = [](const float* buf) {
      return [buf](int r, int c) { return buf[sw<BHID>(r, c)]; };
    };
    auto cols = [](const float* buf) {
      return [buf](int r, int c) { return buf[sw<BHID>(c, r)]; };
    };

    // recompute the forward activations
    {
      float d[4][4];
      init_acc<4>(d, b1s, nh, tq);
      warp_gemm<BIN, 4>(d, [xs](int r, int c) { return xs[sw<XRS>(r, c)]; }, rows(w1s), mb,
                        nh, gq, tq);
      store_relu<4>(d, A, mb, nh, gq, tq);
    }
    __syncthreads();
    {
      float d[4][4];
      init_acc<4>(d, b2s, nh, tq);
      warp_gemm<BHID, 4>(d, rows(A), rows(w2s), mb, nh, gq, tq);
      store_relu<4>(d, B, mb, nh, gq, tq);
    }
    __syncthreads();
    {
      float d[4][4];
      init_acc<4>(d, b3s, nh, tq);
      warp_gemm<BHID, 4>(d, rows(B), rows(w3s), mb, nh, gq, tq);
      store_relu<4>(d, C, mb, nh, gq, tq);
    }
    __syncthreads();

    // CUDA cores: dW4 = h3^T g, db4, and g3 = (g W4^T) * [h3 > 0] in place
    // of h3, with db3
    {
      const float w40 = w4s[u * BOUT], w41 = w4s[u * BOUT + 1];
      float s0 = 0.f, s1 = 0.f, sb = 0.f, sg = 0.f;
#pragma unroll 4
      for (int i = 0; i < TP / 4; ++i) {
        const int p = q * (TP / 4) + i;
        const float g0 = gs[p * BOUT], g1 = gs[p * BOUT + 1];
        float* hp = C + sw<BHID>(p, u);
        const float h = *hp;
        s0 = fmaf(h, g0, s0);
        s1 = fmaf(h, g1, s1);
        const float v = h > 0.f ? fmaf(g0, w40, g1 * w41) : 0.f;
        *hp = v;
        sb += v;
        sg += u < BOUT ? gs[p * BOUT + u] : 0.f;
      }
      dw40 += s0;
      dw41 += s1;
      db3 += sb;
      db4 += sg;
    }
    __syncthreads();

    // dW3 = h2^T g3; g2 = (g3 W3^T) * [h2 > 0] in place of h2, written
    // once every warp has read h2
    {
      warp_gemm_sum<TP, 4>(dw3, cols(B), rows(C), mb, nh, gq, tq);
      float d[4][4];
      init_acc<4>(d, nullptr, 0, 0);
      warp_gemm<BHID, 4>(d, rows(C), cols(w3s), mb, nh, gq, tq);
      __syncthreads();
      store_masked<4>(d, B, mb, nh, gq, tq);
    }
    __syncthreads();

    // dW2 = h1^T g2, db2; g1 = (g2 W2^T) * [h1 > 0] in place of h1
    {
      warp_gemm_sum<TP, 4>(dw2, cols(A), rows(B), mb, nh, gq, tq);
      db2 += col_sum(B, u, q);
      float d[4][4];
      init_acc<4>(d, nullptr, 0, 0);
      warp_gemm<BHID, 4>(d, rows(B), cols(w2s), mb, nh, gq, tq);
      __syncthreads();
      store_masked<4>(d, A, mb, nh, gq, tq);
    }
    __syncthreads();

    // dW1 = x^T g1 (warp w: dW1 columns 8w..8w+7), db1, and dx = g1 W1^T
    // (warp w: pixels mb.., input channels 8*(w/4)..) for the valid pixels
    warp_gemm_sum<TP, 1>(dw1, [xs](int r, int c) { return xs[sw<XRS>(c, r)]; }, rows(A), 0,
                     8 * warp, gq, tq);
    db1 += col_sum(A, u, q);
    if (dx != nullptr) {
      float d[1][4];
      init_acc<1>(d, nullptr, 0, 0);
      const int n0 = (warp >> 2) * 8;
      warp_gemm<BHID, 1>(d, rows(A), cols(w1s), mb, n0, gq, tq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mb + gq + 8 * h;
        if (r < nv)
          *reinterpret_cast<float2*>(dx + (p0 + r) * BIN + n0 + 2 * tq) =
              make_float2(d[0][2 * h], d[0][2 * h + 1]);
      }
    }
  }

  // the block's partial: weight-gradient fragments straight from the
  // registers; the CUDA-core sums over the four pixel quarters q through
  // shared memory, added in q order
  float* mine = part + (long long)blockIdx.x * NPART;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = nh + 8 * j + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mb + gq + 8 * h;
      mine[OFF_W3 + r * BHID + c] = dw3[j][2 * h];
      mine[OFF_W3 + r * BHID + c + 1] = dw3[j][2 * h + 1];
      mine[OFF_W2 + r * BHID + c] = dw2[j][2 * h];
      mine[OFF_W2 + r * BHID + c + 1] = dw2[j][2 * h + 1];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gq + 8 * h, c = 8 * warp + 2 * tq;
    mine[OFF_W1 + r * BHID + c] = dw1[0][2 * h];
    mine[OFF_W1 + r * BHID + c + 1] = dw1[0][2 * h + 1];
  }
  __syncthreads();  // the activation buffers are free now
  constexpr int NRED = 6;
  float* red = A;  // [q][NRED][64]
  const float vals[NRED] = {db1, db2, db3, dw40, dw41, db4};
#pragma unroll
  for (int k = 0; k < NRED; ++k) red[(q * NRED + k) * BHID + u] = vals[k];
  __syncthreads();
  if (tid < BHID) {
    float s[NRED];
#pragma unroll
    for (int k = 0; k < NRED; ++k) {
      s[k] = 0.f;
      for (int qq = 0; qq < BT / BHID; ++qq) s[k] += red[(qq * NRED + k) * BHID + u];
    }
    mine[OFF_B1 + u] = s[0];
    mine[OFF_B2 + u] = s[1];
    mine[OFF_B3 + u] = s[2];
    mine[OFF_W4 + u * BOUT] = s[3];
    mine[OFF_W4 + u * BOUT + 1] = s[4];
    if (u < BOUT) mine[OFF_B4 + u] = s[5];
  }
}

// out[e] = sum over blocks b, in order, of part[b][e]
__global__ void head_bwd_reduce(const float* __restrict__ part, int nblocks,
                                float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NPART) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[(long long)b * NPART + e];
  out[e] = s;
}

}  // namespace popcorn

// x (n,16) and g (n,2) 16-byte aligned, weights as kernel C; dx (n,16) or
// null to skip it; part (nblocks, 9538) scratch, nblocks = min(ceil(n /
// TP), MAX_BLOCKS) (the caller allocates it: the kernel allocates
// nothing); grads (9538) the flat [dW1 db1 dW2 db2 dW3 db3 dW4 db4].
// Returns a cudaError_t (0 on success), -1 for arguments it does not take.
extern "C" int popcorn_head_bwd_f32(const float* x, const float* g,
                                    const float* w1, const float* b1,
                                    const float* w2, const float* b2,
                                    const float* w3, const float* b3,
                                    const float* w4, float* dx, float* part,
                                    float* grads, long long n, int nblocks,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0 || nblocks <= 0 || nblocks > popcorn::MAX_BLOCKS) return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) % 16 != 0) return -1;
  constexpr size_t smem = sizeof(float) * popcorn::smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      popcorn::head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  popcorn::head_bwd_kernel<<<nblocks, popcorn::BT, smem, st>>>(
      x, g, w1, b1, w2, b2, w3, b3, w4, dx, part, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  popcorn::head_bwd_reduce<<<(popcorn::NPART + threads - 1) / threads, threads,
                             0, st>>>(part, nblocks, grads);
  return (int)cudaGetLastError();
}
