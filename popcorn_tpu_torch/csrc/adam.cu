// adam.cu — the train step's optimizer update: global-norm clipping, weight
// decay and Adam over every trainable leaf, in one launch.
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
// p, mu, nu written): 1.10 MB for the member's 39,333 parameters, 0.33 us at
// 3.35 TB/s. The host's issue of the plain chain's launches, not the
// card, is what it replaces.
//
// Design. One block of 1024 threads. The norm has to be known before any
// update, and a whole-grid barrier would need a cooperative launch or a
// second kernel; one block reduces it with a fixed-order tree (warp
// shuffles, then one warp over the warp sums), no atomics, so the result
// is the same bits on every run and on every data-parallel rank. Both
// passes walk the concatenation of all leaves with a stride of 1024: each
// thread follows a cursor through the leaf table (its elements only move
// forward), and keeps AU elements' loads in flight before it uses any.
// The second pass reads the gradients again, from L2. The gradient of a
// leaf may be a strided view (a conv weight's gradient is the permuted
// OIHW tensor): it is read through its strides. p, mu and nu are
// contiguous; the outputs are three flat buffers that the wrapper cuts into
// leaves at the offsets it chose (train/adam.py).
#include <cuda_runtime.h>

namespace popcorn {

constexpr int AT = 1024;  // threads: the one block
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

__global__ void __launch_bounds__(AT, 1)
adam_kernel(const AdamLeaf* __restrict__ leaves, long long total, float* __restrict__ p_out,
            float* __restrict__ mu_out, float* __restrict__ nu_out, float clip, float wd,
            float b1, float b2, float one_m_b1, float one_m_b2, float eps, float bc1, float bc2,
            float neg_lr) {
  __shared__ float warp_sums[AT / 32];
  __shared__ float s_norm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Cursor c;

  // 1. the global norm of the gradients
  float norm = 0.f;
  if (clip > 0.f) {
    float acc = 0.f;
    c.load(leaves);
    for (long long base = 0; base < total; base += (long long)AT * AU) {
      float v[AU];
#pragma unroll
      for (int u = 0; u < AU; ++u) {
        const long long e = base + (long long)u * AT + tid;
        v[u] = 0.f;
        if (e < total) {
          c.seek(e);
          v[u] = c.grad((int)(e - c.start));
        }
      }
#pragma unroll
      for (int u = 0; u < AU; ++u) acc = fmaf(v[u], v[u], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      acc = warp_sums[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
      if (lane == 0) s_norm = __fsqrt_rn(acc);
    }
    __syncthreads();
    norm = s_norm;
  }
  // torch.where(norm < clip, g, g / norm * clip): a NaN norm clips
  const bool clipped = clip > 0.f && !(norm < clip);

  // 2. clip, decay, moments and the step
  c.load(leaves);
  for (long long base = 0; base < total; base += (long long)AT * AU) {
    float pv[AU], gv[AU], mv[AU], vv[AU];
    int o[AU];
    bool decay[AU];
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const long long e = base + (long long)u * AT + tid;
      o[u] = -1;
      if (e < total) {
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
// to total. Returns a cudaError_t (0 on success); launches nothing for an
// empty table.
extern "C" int popcorn_adam(const popcorn::AdamLeaf* leaves, int n_leaves, long long total,
                            float* p_out, float* mu_out, float* nu_out, float clip, float wd,
                            float b1, float b2, float one_m_b1, float one_m_b2, float eps,
                            float bc1, float bc2, float neg_lr, void* stream) {
  if (n_leaves <= 0 || total <= 0) return 0;
  popcorn::adam_kernel<<<1, popcorn::AT, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, total, p_out, mu_out, nu_out, clip, wd, b1, b2, one_m_b1, one_m_b2, eps, bc1, bc2,
      neg_lr);
  return (int)cudaGetLastError();
}
