// head.cu — kernel C: the POPCORN head, a per-pixel MLP
// 16 -> 64 -> 64 -> 64 -> NOUT with ReLUs between the layers.
//
// Replaces the Pallas kernels popcorn_tpu/nn/pallas_head.py::_fwd_kernel
// (fused_head, 2-channel output) and popcorn_tpu/nn/pallas_packed_head.py::
// _blockdiag_kernel, _blockdiag_kernel_cdt and _dense_kernel
// (fused_packed_head, channel 0 only). The packed kernels are TPU lane-fill
// layouts (space-to-depth lanes, kron block-diagonal weights) of one
// per-pixel function; here NOUT = 1 computes that channel-0 output on
// unpacked features, and NOUT = 2 the two-channel fused_head output.
// Forward only: the backward (pallas_head.py::_bwd_kernel) belongs to the
// training path.
//
// What bounds it on the H100: arithmetic. The head does 9,344 (NOUT = 2)
// multiply-adds per pixel against 72 bytes read and written; the unfused
// chain of four matmuls would also write and re-read three 64-channel
// intermediates (768 bytes a pixel).
//
// Design: all weights and biases (about 37 KB) sit in shared memory and
// each thread evaluates whole pixels. The 64 accumulators of the layer
// being computed live in registers; the previous layer's activations live
// in a per-thread column of shared memory ([k][thread], so a warp's reads
// are conflict-free), which lets the loop over the 64 inputs stay rolled:
// a fully unrolled 64x64x3 chain with all activations in registers took
// ptxas minutes to compile. Weights are read as float4 broadcasts. A
// grid-stride loop over pixels lets a bounded grid amortise the weight
// staging; the ragged tail is masked, the input is not padded. FP32 FMA on
// CUDA cores; tensor cores are later work.
#include <cuda_runtime.h>

namespace popcorn {

constexpr int HEAD_IN = 16;
constexpr int HEAD_HID = 64;
constexpr int HEAD_THREADS = 256;
constexpr int HEAD_MAX_BLOCKS = 132 * 8;
constexpr int HEAD_W4_COLS = 2;  // w4 is (64, 2) whatever NOUT is

constexpr int head_smem_floats() {
  return HEAD_IN * HEAD_HID + 2 * HEAD_HID * HEAD_HID +
         HEAD_HID * HEAD_W4_COLS + 3 * HEAD_HID + 4 + HEAD_HID * HEAD_THREADS;
}

__device__ __forceinline__ void fma_row(float v, const float* wrow,
                                        float (&acc)[HEAD_HID]) {
  const float4* wr = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int o4 = 0; o4 < HEAD_HID / 4; ++o4) {
    const float4 wv = wr[o4];
    acc[4 * o4 + 0] = fmaf(v, wv.x, acc[4 * o4 + 0]);
    acc[4 * o4 + 1] = fmaf(v, wv.y, acc[4 * o4 + 1]);
    acc[4 * o4 + 2] = fmaf(v, wv.z, acc[4 * o4 + 2]);
    acc[4 * o4 + 3] = fmaf(v, wv.w, acc[4 * o4 + 3]);
  }
}

// acc = relu(bias + hcol @ w) for a (64, 64) weight, hcol this thread's
// shared-memory column of the previous layer (stride HEAD_THREADS)
__device__ __forceinline__ void hidden_layer(const float* hcol, const float* w,
                                             const float* bias,
                                             float (&acc)[HEAD_HID]) {
#pragma unroll
  for (int o = 0; o < HEAD_HID; ++o) acc[o] = bias[o];
#pragma unroll 4
  for (int k = 0; k < HEAD_HID; ++k)
    fma_row(hcol[k * HEAD_THREADS], w + k * HEAD_HID, acc);
#pragma unroll
  for (int o = 0; o < HEAD_HID; ++o) acc[o] = fmaxf(acc[o], 0.f);
}

__device__ __forceinline__ void store_column(float* hcol,
                                             const float (&acc)[HEAD_HID]) {
#pragma unroll
  for (int o = 0; o < HEAD_HID; ++o) hcol[o * HEAD_THREADS] = acc[o];
}

template <int NOUT>
__global__ void __launch_bounds__(HEAD_THREADS)
    head_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, const float* __restrict__ w4,
                const float* __restrict__ b4, float* __restrict__ out,
                long long n) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;
  float* w2s = w1s + HEAD_IN * HEAD_HID;
  float* w3s = w2s + HEAD_HID * HEAD_HID;
  float* w4s = w3s + HEAD_HID * HEAD_HID;
  float* b1s = w4s + HEAD_HID * HEAD_W4_COLS;
  float* b2s = b1s + HEAD_HID;
  float* b3s = b2s + HEAD_HID;
  float* b4s = b3s + HEAD_HID;
  float* hcol = b4s + 4 + threadIdx.x;  // this thread's activation column
  for (int i = threadIdx.x; i < HEAD_IN * HEAD_HID; i += blockDim.x) w1s[i] = w1[i];
  for (int i = threadIdx.x; i < HEAD_HID * HEAD_HID; i += blockDim.x) {
    w2s[i] = w2[i];
    w3s[i] = w3[i];
  }
  for (int i = threadIdx.x; i < HEAD_HID * HEAD_W4_COLS; i += blockDim.x) w4s[i] = w4[i];
  for (int i = threadIdx.x; i < HEAD_HID; i += blockDim.x) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
    b3s[i] = b3[i];
  }
  if (threadIdx.x < HEAD_W4_COLS) b4s[threadIdx.x] = b4[threadIdx.x];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc[HEAD_HID];
    // layer 1 from the 16 input channels, read as four float4
#pragma unroll
    for (int o = 0; o < HEAD_HID; ++o) acc[o] = b1s[o];
    const float4* xp = reinterpret_cast<const float4*>(x + i * HEAD_IN);
#pragma unroll
    for (int k4 = 0; k4 < HEAD_IN / 4; ++k4) {
      const float4 v = __ldg(xp + k4);
      fma_row(v.x, w1s + (4 * k4 + 0) * HEAD_HID, acc);
      fma_row(v.y, w1s + (4 * k4 + 1) * HEAD_HID, acc);
      fma_row(v.z, w1s + (4 * k4 + 2) * HEAD_HID, acc);
      fma_row(v.w, w1s + (4 * k4 + 3) * HEAD_HID, acc);
    }
#pragma unroll
    for (int o = 0; o < HEAD_HID; ++o) acc[o] = fmaxf(acc[o], 0.f);
    // layers 2 and 3 through the thread's shared-memory column (each
    // thread reads back only what it wrote: no barrier needed)
    store_column(hcol, acc);
    hidden_layer(hcol, w2s, b2s, acc);
    store_column(hcol, acc);
    hidden_layer(hcol, w3s, b3s, acc);
    // layer 4 straight from the registers
    float y[NOUT];
#pragma unroll
    for (int j = 0; j < NOUT; ++j) y[j] = b4s[j];
#pragma unroll
    for (int k = 0; k < HEAD_HID; ++k) {
#pragma unroll
      for (int j = 0; j < NOUT; ++j)
        y[j] = fmaf(acc[k], w4s[k * HEAD_W4_COLS + j], y[j]);
    }
#pragma unroll
    for (int j = 0; j < NOUT; ++j) out[i * NOUT + j] = y[j];
  }
}

}  // namespace popcorn

// Returns a cudaError_t (0 on success), or -1 for an unsupported n_out.
extern "C" int popcorn_head_f32(const float* x, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, const float* w3,
                                const float* b3, const float* w4,
                                const float* b4, float* out, long long n,
                                int n_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr size_t smem = sizeof(float) * popcorn::head_smem_floats();
  if (n == 0) return 0;
  // enough blocks to fill 132 SMs several times over, each staging the
  // weights once for many pixels of the grid-stride loop
  const long long want = (n + popcorn::HEAD_THREADS - 1) / popcorn::HEAD_THREADS;
  const int grid = (int)(want < popcorn::HEAD_MAX_BLOCKS ? want : popcorn::HEAD_MAX_BLOCKS);
  if (n_out == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        popcorn::head_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    popcorn::head_kernel<1><<<grid, popcorn::HEAD_THREADS, smem, st>>>(
        x, w1, b1, w2, b2, w3, b3, w4, b4, out, n);
  } else if (n_out == 2) {
    cudaError_t err = cudaFuncSetAttribute(
        popcorn::head_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    popcorn::head_kernel<2><<<grid, popcorn::HEAD_THREADS, smem, st>>>(
        x, w1, b1, w2, b2, w3, b3, w4, b4, out, n);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
