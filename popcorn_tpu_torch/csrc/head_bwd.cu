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
// 136 bytes a pixel read and written (x, g, dx).
//
// Design. The TPU kernel adds each tile's dW into one output block
// because its grid runs in order; on the H100 blocks run in no order. Here
// each block walks a grid-stride sequence of 64-pixel tiles and keeps its
// own running dW/db in registers (every thread owns fixed entries of the
// weight matrices); at the end it writes that partial to one row of a
// (blocks, 9538) buffer, and a second small kernel sums the rows in block
// order. The result is the same bits on every run for a given N, with no
// atomics. Per tile, the weights (padded to a row stride of 65 floats, so
// reading a row or a column is free of bank conflicts) and three 64x64
// activation buffers sit in shared memory: h1, h2, h3 are computed into
// them, then g3 overwrites h3, g2 overwrites h2 and g1 overwrites h1, each
// only after the weight gradient that still needs the old values. Each
// thread owns one hidden unit and 16 of the tile's pixels in every layer
// product; the loops over 64 inputs stay rolled to keep ptxas quick. A
// ragged last tile reads zeros past N: a zero g makes those pixels add
// nothing to any gradient, and their dx is not written. FP32 FMA on CUDA
// cores; tensor cores and a fused single pass are later work.
#include <cuda_runtime.h>

namespace popcorn {

constexpr int BIN = 16;      // input channels
constexpr int BHID = 64;     // hidden units
constexpr int BOUT = 2;      // output channels
constexpr int BT = 256;      // threads a block
constexpr int TP = 64;       // pixels a tile
constexpr int WS = BHID + 1; // padded smem row stride of W1..W3
constexpr int ROWS = BT / BHID;        // 4 pixel rows per thread pass
constexpr int PPT = TP / ROWS;         // 16 pixels per thread per layer
constexpr int W1E = BIN * BHID / BT;   // 4 dW1 entries per thread
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
  return BIN * WS + 2 * BHID * WS + BHID * BOUT + 3 * BHID + 4 +
         TP * BIN + TP * BOUT + 3 * TP * BHID;
}

// out[p][u] = relu(b[u] + sum_k in[p][k] w[k][u]) for this thread's unit u
// and pixels r0 + ROWS*m; `in` has row stride K
template <int K>
__device__ __forceinline__ void layer_fwd(const float* in, const float* w,
                                          const float* b, float* out, int u,
                                          int r0) {
  float acc[PPT];
  const float bu = b[u];
#pragma unroll
  for (int m = 0; m < PPT; ++m) acc[m] = bu;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float wk = w[k * WS + u];
#pragma unroll
    for (int m = 0; m < PPT; ++m)
      acc[m] = fmaf(in[(r0 + ROWS * m) * K + k], wk, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < PPT; ++m)
    out[(r0 + ROWS * m) * BHID + u] = fmaxf(acc[m], 0.f);
}

// hg[p][u] = (sum_o gin[p][o] w[u][o]) * [hg[p][u] > 0]: the layer's
// activation in hg is replaced by the gradient at its pre-activation
__device__ __forceinline__ void layer_bwd(const float* gin, const float* w,
                                          float* hg, int u, int r0) {
  float acc[PPT];
#pragma unroll
  for (int m = 0; m < PPT; ++m) acc[m] = 0.f;
#pragma unroll 4
  for (int o = 0; o < BHID; ++o) {
    const float wo = w[u * WS + o];
#pragma unroll
    for (int m = 0; m < PPT; ++m)
      acc[m] = fmaf(gin[(r0 + ROWS * m) * BHID + o], wo, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < PPT; ++m) {
    const int i = (r0 + ROWS * m) * BHID + u;
    hg[i] = hg[i] > 0.f ? acc[m] : 0.f;
  }
}

// dW[r0 + ROWS*m][u] += sum_p act[p][r0 + ROWS*m] * gout[p][u] (act has
// row stride K, NE entries per thread) and, for the threads of row 0,
// db[u] += sum_p gout[p][u]. The tile's sum is formed first and then added
// to the running total, which keeps the float32 sums shallow.
template <int K, int NE>
__device__ __forceinline__ void weight_grad(const float* act, const float* gout,
                                            float (&dw)[NE], float& db, int u,
                                            int r0) {
  float s[NE];
  float sb = 0.f;
#pragma unroll
  for (int m = 0; m < NE; ++m) s[m] = 0.f;
#pragma unroll 2
  for (int p = 0; p < TP; ++p) {
    const float gv = gout[p * BHID + u];
#pragma unroll
    for (int m = 0; m < NE; ++m) s[m] = fmaf(act[p * K + r0 + ROWS * m], gv, s[m]);
    sb += gv;
  }
#pragma unroll
  for (int m = 0; m < NE; ++m) dw[m] += s[m];
  if (r0 == 0) db += sb;
}

__global__ void __launch_bounds__(BT, 2)
    head_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ w4, float* __restrict__ dx,
                    float* __restrict__ part, long long n) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;
  float* w2s = w1s + BIN * WS;
  float* w3s = w2s + BHID * WS;
  float* w4s = w3s + BHID * WS;
  float* b1s = w4s + BHID * BOUT;
  float* b2s = b1s + BHID;
  float* b3s = b2s + BHID;
  float* xs = b3s + BHID + 4;
  float* gs = xs + TP * BIN;
  float* A = gs + TP * BOUT;  // h1, then g1
  float* B = A + TP * BHID;   // h2, then g2
  float* C = B + TP * BHID;   // h3, then g3

  const int t = threadIdx.x;
  for (int i = t; i < BIN * BHID; i += BT) w1s[(i / BHID) * WS + i % BHID] = w1[i];
  for (int i = t; i < BHID * BHID; i += BT) {
    const int r = i / BHID, c = i % BHID;
    w2s[r * WS + c] = w2[i];
    w3s[r * WS + c] = w3[i];
  }
  for (int i = t; i < BHID * BOUT; i += BT) w4s[i] = w4[i];
  if (t < BHID) {
    b1s[t] = b1[t];
    b2s[t] = b2[t];
    b3s[t] = b3[t];
  }

  const int u = t % BHID;   // the hidden unit this thread owns
  const int r0 = t / BHID;  // its first pixel row (then every ROWS-th)
  float a1[W1E], a2[PPT], a3[PPT];
  float ab1 = 0.f, ab2 = 0.f, ab3 = 0.f, a4 = 0.f, ab4 = 0.f;
#pragma unroll
  for (int m = 0; m < W1E; ++m) a1[m] = 0.f;
#pragma unroll
  for (int m = 0; m < PPT; ++m) a2[m] = a3[m] = 0.f;

  const long long ntiles = (n + TP - 1) / TP;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * TP;
    const int nv = (int)(n - p0 < TP ? n - p0 : TP);
    __syncthreads();  // the previous tile's readers are done
    for (int i = t; i < TP * BIN; i += BT)
      xs[i] = i / BIN < nv ? x[p0 * BIN + i] : 0.f;
    for (int i = t; i < TP * BOUT; i += BT)
      gs[i] = i / BOUT < nv ? g[p0 * BOUT + i] : 0.f;
    __syncthreads();

    // recompute the forward activations
    layer_fwd<BIN>(xs, w1s, b1s, A, u, r0);
    __syncthreads();
    layer_fwd<BHID>(A, w2s, b2s, B, u, r0);
    __syncthreads();
    layer_fwd<BHID>(B, w3s, b3s, C, u, r0);
    __syncthreads();

    // dW4 = h3^T g, db4 = sum g
    if (t < BHID * BOUT) {
      const int i = t / BOUT, j = t % BOUT;
      float s = 0.f;
      for (int p = 0; p < TP; ++p) s = fmaf(C[p * BHID + i], gs[p * BOUT + j], s);
      a4 += s;
    }
    if (t < BOUT) {
      float s = 0.f;
      for (int p = 0; p < TP; ++p) s += gs[p * BOUT + t];
      ab4 += s;
    }
    __syncthreads();

    // g3 = (g W4^T) * [h3 > 0], in place of h3 (own elements only)
#pragma unroll
    for (int m = 0; m < PPT; ++m) {
      const int p = r0 + ROWS * m;
      const float v = fmaf(gs[p * BOUT], w4s[u * BOUT],
                           gs[p * BOUT + 1] * w4s[u * BOUT + 1]);
      const int i = p * BHID + u;
      C[i] = C[i] > 0.f ? v : 0.f;
    }
    __syncthreads();
    weight_grad<BHID, PPT>(B, C, a3, ab3, u, r0);  // dW3 = h2^T g3
    __syncthreads();
    layer_bwd(C, w3s, B, u, r0);                   // g2 in place of h2
    __syncthreads();
    weight_grad<BHID, PPT>(A, B, a2, ab2, u, r0);  // dW2 = h1^T g2
    __syncthreads();
    layer_bwd(B, w2s, A, u, r0);                   // g1 in place of h1
    __syncthreads();
    weight_grad<BIN, W1E>(xs, A, a1, ab1, u, r0);  // dW1 = x^T g1

    // dx = g1 W1^T for the tile's valid pixels
    if (dx != nullptr) {
      for (int i = t; i < nv * BIN; i += BT) {
        const int p = i / BIN, k = i % BIN;
        float s = 0.f;
#pragma unroll 8
        for (int j = 0; j < BHID; ++j) s = fmaf(A[p * BHID + j], w1s[k * WS + j], s);
        dx[p0 * BIN + i] = s;
      }
    }
  }

  float* mine = part + (long long)blockIdx.x * NPART;
#pragma unroll
  for (int m = 0; m < W1E; ++m) mine[OFF_W1 + (r0 + ROWS * m) * BHID + u] = a1[m];
#pragma unroll
  for (int m = 0; m < PPT; ++m) {
    mine[OFF_W2 + (r0 + ROWS * m) * BHID + u] = a2[m];
    mine[OFF_W3 + (r0 + ROWS * m) * BHID + u] = a3[m];
  }
  if (r0 == 0) {
    mine[OFF_B1 + u] = ab1;
    mine[OFF_B2 + u] = ab2;
    mine[OFF_B3 + u] = ab3;
  }
  if (t < BHID * BOUT) mine[OFF_W4 + t] = a4;
  if (t < BOUT) mine[OFF_B4 + t] = ab4;
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

// x (n,16), g (n,2), weights as kernel C; dx (n,16) or null to skip it;
// part (nblocks, 9538) scratch, nblocks = min(ceil(n / TP), MAX_BLOCKS)
// (the caller allocates it: the kernel allocates nothing); grads (9538)
// the flat [dW1 db1 dW2 db2 dW3 db3 dW4 db4]. Returns a cudaError_t (0 on
// success).
extern "C" int popcorn_head_bwd_f32(const float* x, const float* g,
                                    const float* w1, const float* b1,
                                    const float* w2, const float* b2,
                                    const float* w3, const float* b3,
                                    const float* w4, float* dx, float* part,
                                    float* grads, long long n, int nblocks,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0 || nblocks <= 0 || nblocks > popcorn::MAX_BLOCKS) return -1;
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
