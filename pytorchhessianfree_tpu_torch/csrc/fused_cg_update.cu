// Fused CG iterate update for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ff5bf90:pytorchhessianfree_tpu/ops/pallas_kernels.py
// ::fused_cg_update (kernel body _fused_update_kernel), whose math still runs
// on every CG iteration of the JAX package at ops/cg.py:324-336.  In one pass
// over five [n] vectors and a scalar alpha it computes
//
//     x' = x + alpha p,   r' = r + alpha Ap,
//     m  = 0.5 (r' - b) . x',   rr = r' . r'.
//
// Bound: device-memory bandwidth.  Five vectors are read and two written, so
// at n = 11,175,936 in f32 one call moves about 313 MB; the eager PyTorch
// version of the same lines makes about 12 vector passes.  The arithmetic is
// a handful of flops per element.
//
// Design:
// - Pass 1 runs a FIXED grid (kBlocks x kThreads, independent of n) of
//   grid-stride loops that mask the ragged edge themselves (no padding
//   copies), write x' and r', and accumulate the two dot products per thread.
//   Each block tree-reduces them in shared memory and writes one (m, rr)
//   pair to scratch.  Pass 2 is one block that reduces the kBlocks pairs in
//   a fixed order.  No atomics: two runs give bitwise-equal m and rr.
// - x' and r' are formed with explicitly rounded multiply and add (no FMA
//   contraction), so they equal the plain PyTorch version's `x + alpha * p`
//   bit for bit.
// - alpha is read from device memory, so the caller never syncs to pass it.
// - Launches go on the caller's stream; nothing is allocated here.  Each
//   entry point returns cudaGetLastError() after its launches.
//
// This version is the simple, correct one.  Vector (16-byte) loads and a
// grid tuned to the card are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 264;  // 2 blocks on each of the H100's 132 SMs

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Sum of buf[0..kThreads) into buf[0], fixed pairing order.
template <typename T>
__device__ __forceinline__ void block_reduce(T* buf_m, T* buf_rr) {
  const int t = threadIdx.x;
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      buf_m[t] += buf_m[t + s];
      buf_rr[t] += buf_rr[t + s];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_pass(const T* __restrict__ x, const T* __restrict__ r,
            const T* __restrict__ p, const T* __restrict__ ap,
            const T* __restrict__ b, const T* __restrict__ alpha,
            T* __restrict__ x_out, T* __restrict__ r_out,
            T* __restrict__ partials, int64_t n) {
  __shared__ T s_m[kThreads];
  __shared__ T s_rr[kThreads];
  const T a = *alpha;
  T m_acc = 0;
  T rr_acc = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const T xn = add_rn(x[i], mul_rn(a, p[i]));
    const T rn = add_rn(r[i], mul_rn(a, ap[i]));
    x_out[i] = xn;
    r_out[i] = rn;
    m_acc += (rn - b[i]) * xn;
    rr_acc += rn * rn;
  }
  s_m[threadIdx.x] = m_acc;
  s_rr[threadIdx.x] = rr_acc;
  __syncthreads();
  block_reduce(s_m, s_rr);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s_m[0];
    partials[kBlocks + blockIdx.x] = s_rr[0];
  }
}

// One block: out[0] = 0.5 * sum of the m partials, out[1] = sum of the rr
// partials, both in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
final_pass(const T* __restrict__ partials, T* __restrict__ out) {
  __shared__ T s_m[kThreads];
  __shared__ T s_rr[kThreads];
  T m_acc = 0;
  T rr_acc = 0;
  for (int i = threadIdx.x; i < kBlocks; i += kThreads) {
    m_acc += partials[i];
    rr_acc += partials[kBlocks + i];
  }
  s_m[threadIdx.x] = m_acc;
  s_rr[threadIdx.x] = rr_acc;
  __syncthreads();
  block_reduce(s_m, s_rr);
  if (threadIdx.x == 0) {
    out[0] = T(0.5) * s_m[0];
    out[1] = s_rr[0];
  }
}

template <typename T>
int launch(const T* x, const T* r, const T* p, const T* ap, const T* b,
           const T* alpha, T* x_out, T* r_out, T* partials, T* out, int64_t n,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  update_pass<T><<<kBlocks, kThreads, 0, s>>>(x, r, p, ap, b, alpha, x_out,
                                              r_out, partials, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  final_pass<T><<<1, kThreads, 0, s>>>(partials, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of (m, rr) pairs pass 1 writes: the scratch holds 2 * this many
// elements.
int fused_cg_update_num_blocks() { return kBlocks; }

int fused_cg_update_f32(const float* x, const float* r, const float* p,
                        const float* ap, const float* b, const float* alpha,
                        float* x_out, float* r_out, float* partials,
                        float* out, int64_t n, int device, void* stream) {
  return launch<float>(x, r, p, ap, b, alpha, x_out, r_out, partials, out, n,
                       device, stream);
}

int fused_cg_update_f64(const double* x, const double* r, const double* p,
                        const double* ap, const double* b,
                        const double* alpha, double* x_out, double* r_out,
                        double* partials, double* out, int64_t n, int device,
                        void* stream) {
  return launch<double>(x, r, p, ap, b, alpha, x_out, r_out, partials, out, n,
                        device, stream);
}

}  // extern "C"
