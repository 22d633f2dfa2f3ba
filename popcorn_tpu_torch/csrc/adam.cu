// adam.cu — the train step's optimizer update: global-norm clipping, weight
// decay and Adam over every trainable leaf, in one call of two kernels.
//
// Replaces no TPU kernel: the JAX package leaves this update to XLA through
// optax (popcorn_tpu/train/state.py::make_optimizer). Its plain version is
// train/state.py::Optimizer.update_plain, the same chain in PyTorch ops,
// one small launch or more per leaf and per operation (about 900 for the
// member's 62 leaves), each issued from Python.
//
// The chain, in optax's order, on float32 throughout:
//   norm = sqrt(sum over all leaves of g^2)
//   g = g * clip / norm          where clip > 0 and norm >= clip
//   g = g + wd * p               where wd > 0 and the leaf decays
//   mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu
//   p = p + (mu / bc1) / (sqrt(nu / bc2) + eps) * (-lr)
// Every multiply, add, divide and square root is rounded on its own
// (__f*_rn), as the plain chain's separate PyTorch ops round them: no
// contraction into FMAs. Only the norm's sum runs in another order.
//
// What bounds it on the H100: bytes, 28 a parameter (p, g, mu, nu read,
// p, mu, nu written), and 4 more for the norm's read of g: 1.26 MB for the
// DDA member's 39,333 parameters, 0.38 us at 3.35 TB/s; 9.9 GB for a
// Prithvi-EO-2.0-300M member's 308 M, 2.9 ms. For the small member the
// host's issue of the plain chain's launches, not the card, is what it
// replaces.
//
// Design. A grid of blocks of GT threads, one a chunk of the concatenation
// of all leaves (the wrapper sizes the chunks: train/adam.py::chunk_for).
// The norm has to be known before any update; it is reduced in two
// fixed-order stages, no atomics, so the result is the same bits on every
// run and on every data-parallel rank: adam_norm_partial writes each
// chunk's sum of squares (each thread's elements in order, then a fixed
// tree over the block: warp shuffles, then one warp over the warp sums);
// adam_grid_step's every block sums the partials in the same fixed order
// before it updates its own chunk, so all blocks hold the same norm. Each
// thread finds its first leaf by a binary search of the table, then
// follows a cursor through it (its elements only move forward), and keeps
// AU elements' loads in flight before it uses any. The step reads the
// gradients again, from L2 where they still are. The gradient of a leaf
// may be a strided view (a conv weight's gradient is the permuted OIHW
// tensor): it is read through its strides. p, mu and nu are contiguous;
// the outputs are three flat buffers that the wrapper cuts into leaves at
// the offsets it chose (train/adam.py).
#include <cuda_runtime.h>

namespace popcorn {

constexpr int AU = 4;     // elements a thread has in flight
constexpr long long DECAY = 1;
constexpr long long STRIDED = 2;

// One row of the wrapper's leaf table (train/adam.py::TABLE_COLS).
struct AdamLeaf {
  const float* p;
  const float* g;
  const float* mu;
  const float* nu;
  long long start;       // its first element in the concatenation of all leaves
  long long n;           // elements
  long long out;         // its first element in the output buffers
  long long flags;       // DECAY, STRIDED
  long long size[4];     // its shape, right-aligned, leading 1s
  long long gstride[4];  // g's strides in elements over that shape
};
static_assert(sizeof(AdamLeaf) == 16 * sizeof(long long), "a table row is 16 int64s");

// The leaf that holds element e of the concatenation, and its pointers.
struct Cursor {
  const AdamLeaf* leaf;
  const float *p, *g, *mu, *nu;
  long long start, end;
  int out, flags;

  __device__ __forceinline__ void load(const AdamLeaf* l) {
    leaf = l;
    p = l->p;
    g = l->g;
    mu = l->mu;
    nu = l->nu;
    start = l->start;
    end = start + l->n;
    out = (int)l->out;
    flags = (int)l->flags;
  }
  __device__ __forceinline__ void seek(long long e) {
    while (e >= end) load(leaf + 1);
  }
  // element i (row-major over the leaf's shape) of the gradient; the
  // output buffers, and so every leaf, hold fewer than 2^31 elements (the
  // wrapper checks)
  __device__ __forceinline__ float grad(int i) const {
    if (!(flags & STRIDED)) return g[i];
    long long off = 0;
    int r = i;
#pragma unroll
    for (int d = 3; d > 0; --d) {
      const int s = (int)leaf->size[d];
      off += (long long)(r % s) * leaf->gstride[d];
      r /= s;
    }
    return g[off + (long long)r * leaf->gstride[0]];
  }
};

constexpr int GT = 512;  // threads a block

// the row of the leaf that holds element e: the last whose start is <= e
__device__ __forceinline__ int find_leaf(const AdamLeaf* leaves, int n_leaves, long long e) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].start <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// the sum of v over the block in a fixed order: each warp's tree, then one
// warp over the warp sums; every thread gets it
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  return warp_sums[0];
}

__global__ void __launch_bounds__(GT)
adam_norm_partial(const AdamLeaf* __restrict__ leaves, int n_leaves, long long total,
                  long long chunk, float* __restrict__ partial) {
  __shared__ float warp_sums[GT / 32];
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = c0 + chunk < total ? c0 + chunk : total;
  float acc = 0.f;
  Cursor c;
  c.load(leaves + find_leaf(leaves, n_leaves, c0 + threadIdx.x < c1 ? c0 + threadIdx.x : c0));
  for (long long base = c0; base < c1; base += (long long)GT * AU) {
    float v[AU];
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const long long e = base + (long long)u * GT + threadIdx.x;
      v[u] = 0.f;
      if (e < c1) {
        c.seek(e);
        v[u] = c.grad((int)(e - c.start));
      }
    }
#pragma unroll
    for (int u = 0; u < AU; ++u) acc = fmaf(v[u], v[u], acc);
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(GT)
adam_grid_step(const AdamLeaf* __restrict__ leaves, int n_leaves, long long total,
               long long chunk, const float* __restrict__ partial, float* __restrict__ p_out,
               float* __restrict__ mu_out, float* __restrict__ nu_out, float clip, float wd,
               float b1, float b2, float one_m_b1, float one_m_b2, float eps, float bc1,
               float bc2, float neg_lr) {
  __shared__ float warp_sums[GT / 32];
  float norm = 0.f;
  if (clip > 0.f) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += GT) acc += partial[i];
    norm = __fsqrt_rn(block_sum(acc, warp_sums));
  }
  const bool clipped = clip > 0.f && !(norm < clip);
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = c0 + chunk < total ? c0 + chunk : total;
  Cursor c;
  c.load(leaves + find_leaf(leaves, n_leaves, c0 + threadIdx.x < c1 ? c0 + threadIdx.x : c0));
  for (long long base = c0; base < c1; base += (long long)GT * AU) {
    float pv[AU], gv[AU], mv[AU], vv[AU];
    int o[AU];
    bool decay[AU];
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const long long e = base + (long long)u * GT + threadIdx.x;
      o[u] = -1;
      if (e < c1) {
        c.seek(e);
        const int i = (int)(e - c.start);
        pv[u] = c.p[i];
        gv[u] = c.grad(i);
        mv[u] = c.mu[i];
        vv[u] = c.nu[i];
        o[u] = c.out + i;
        decay[u] = (c.flags & DECAY) != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      if (o[u] < 0) continue;
      float t = gv[u];
      if (clipped) t = __fmul_rn(__fdiv_rn(t, norm), clip);
      if (wd > 0.f && decay[u]) t = __fadd_rn(t, __fmul_rn(wd, pv[u]));
      const float m = __fadd_rn(__fmul_rn(one_m_b1, t), __fmul_rn(b1, mv[u]));
      const float v = __fadd_rn(__fmul_rn(one_m_b2, __fmul_rn(t, t)), __fmul_rn(b2, vv[u]));
      const float step = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
      p_out[o[u]] = __fadd_rn(pv[u], __fmul_rn(step, neg_lr));
      mu_out[o[u]] = m;
      nu_out[o[u]] = v;
    }
  }
}

}  // namespace popcorn

// leaves: the device copy of the wrapper's table, n_leaves rows whose n sum
// to total; ceil(total / chunk) blocks, ``partial`` one float a block (left
// unread and unwritten where clip is 0). Returns a cudaError_t (0 on
// success); launches nothing for an empty table.
extern "C" int popcorn_adam(const popcorn::AdamLeaf* leaves, int n_leaves, long long total,
                            long long chunk, float* partial, float* p_out, float* mu_out,
                            float* nu_out, float clip, float wd, float b1, float b2,
                            float one_m_b1, float one_m_b2, float eps, float bc1, float bc2,
                            float neg_lr, void* stream) {
  if (n_leaves <= 0 || total <= 0 || chunk <= 0) return 0;
  const long long blocks = (total + chunk - 1) / chunk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clip > 0.f)
    popcorn::adam_norm_partial<<<(unsigned)blocks, popcorn::GT, 0, s>>>(leaves, n_leaves, total,
                                                                         chunk, partial);
  popcorn::adam_grid_step<<<(unsigned)blocks, popcorn::GT, 0, s>>>(
      leaves, n_leaves, total, chunk, partial, p_out, mu_out, nu_out, clip, wd, b1, b2, one_m_b1,
      one_m_b2, eps, bc1, bc2, neg_lr);
  return (int)cudaGetLastError();
}
