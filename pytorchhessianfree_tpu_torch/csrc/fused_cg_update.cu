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
// Bound: device-memory bandwidth.  Five vectors are read and two written,
// 28 n bytes in f32 (313 MB at n = 11,175,936, 93 us at 3.35 TB/s); the
// arithmetic is a handful of flops per element.
//
// Design:
// - One launch per call.  Each block writes its (m, rr) partials to scratch,
//   then takes a ticket from an integer counter; the block that takes the
//   last ticket adds all blocks' partials in block order, writes (m, rr) and
//   resets the counter to 0 for the next launch (or the next replay of a
//   CUDA graph).  No float atomics: m and rr are bitwise reproducible for a
//   given n, grid and alignment, whatever block finishes last.
// - 16-byte loads and stores (float4 / double2), kUnroll vectors of each
//   operand issued per thread before it computes: Little's law asks ~18 KB
//   of loads in flight per SM to reach 3.35 TB/s at ~0.7 us of loaded
//   latency, and a round of one thread is up to 320 bytes, so the SM's
//   4 resident blocks of 256 threads (62-64 registers) can issue far more
//   than that.  The caller passes the split of
//   [0, n): a scalar head [0, head) up to the operands' common 16-byte
//   boundary (a view with a storage offset), nvec vectors, and a scalar tail
//   for a ragged n.  Operands with no common boundary give nvec = 0.
// - The grid is the card's resident capacity (SMs x the blocks per SM of
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor, fused_cg_update_config),
//   cut for a smaller n to a round of kUnroll vectors per thread, but at
//   least one block per SM while there is a vector per thread for it, so
//   that a small n costs one round trip to memory and no block is idle; the
//   caller computes it (ops/cg_update.py launch_geometry).  Grid-stride
//   loops cover any grid.  (Rounds with a bound on each of their kUnroll
//   vectors kept all twenty loads live: 115-136 registers, half the
//   resident blocks, and 80-83% of the bound at n = 1,387,520 against 85%
//   on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md.)
// - x' and r' are formed with explicitly rounded multiply and add (no FMA
//   contraction), so they equal the plain PyTorch version's `x + alpha * p`
//   bit for bit.
// - alpha is read from device memory, so the caller never syncs to pass it.
// - The launch goes on the caller's stream; nothing is allocated here.
//   The entry point takes its arguments packed in one buffer (one ctypes
//   argument costs the host less than sixteen) and returns
//   cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kWarps = kThreads / 32;
// scratch layout: the ticket, then 2 * grid partials from this byte offset
constexpr int kPartialsOffset = 16;

template <typename T>
union Pack;
template <>
union Pack<float> {
  float4 v;
  float e[4];
};
template <>
union Pack<double> {
  double2 v;
  double e[2];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// One element: writes x'[i], r'[i] and adds its terms to the two sums.
template <typename T>
__device__ __forceinline__ void update(T a, T x, T r, T p, T ap, T b,
                                       T& xn, T& rn, T& m, T& rr) {
  xn = add_rn(x, mul_rn(a, p));
  rn = add_rn(r, mul_rn(a, ap));
  m += (rn - b) * xn;
  rr += rn * rn;
}

template <typename T>
__device__ __forceinline__ void update_vec(
    T a, const Pack<T>& x, const Pack<T>& r, const Pack<T>& p,
    const Pack<T>& ap, const Pack<T>& b, Pack<T>& xn, Pack<T>& rn, T& m,
    T& rr) {
  constexpr int kWidth = sizeof(Pack<T>) / sizeof(T);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    update(a, x.e[k], r.e[k], p.e[k], ap.e[k], b.e[k], xn.e[k], rn.e[k], m,
           rr);
  }
}

// Sum of (m, rr) over the block, in a fixed order; the result is valid in
// thread 0.  Starts and ends with __syncthreads, so it can run twice.
template <typename T>
__device__ __forceinline__ void block_sum(T& m, T& rr) {
  __shared__ T s_m[kWarps];
  __shared__ T s_rr[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    m += __shfl_down_sync(0xffffffffu, m, s);
    rr += __shfl_down_sync(0xffffffffu, rr, s);
  }
  __syncthreads();
  if (lane == 0) {
    s_m[warp] = m;
    s_rr[warp] = rr;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = s_m[0];
    rr = s_rr[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      m += s_m[w];
      rr += s_rr[w];
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_cg_update_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const T* __restrict__ p, const T* __restrict__ ap,
                       const T* __restrict__ b, const T* __restrict__ alpha,
                       T* __restrict__ x_out, T* __restrict__ r_out,
                       unsigned char* __restrict__ scratch,
                       T* __restrict__ out, int64_t n, int64_t head,
                       int64_t nvec) {
  using V = Pack<T>;
  using Raw = decltype(V::v);
  constexpr int kWidth = sizeof(V) / sizeof(T);
  const T a = *alpha;
  T m = 0;
  T rr = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;

  // the vectors: elements [head, head + kWidth * nvec)
  const Raw* xv = reinterpret_cast<const Raw*>(x + head);
  const Raw* rv = reinterpret_cast<const Raw*>(r + head);
  const Raw* pv = reinterpret_cast<const Raw*>(p + head);
  const Raw* apv = reinterpret_cast<const Raw*>(ap + head);
  const Raw* bv = reinterpret_cast<const Raw*>(b + head);
  Raw* xov = reinterpret_cast<Raw*>(x_out + head);
  Raw* rov = reinterpret_cast<Raw*>(r_out + head);
  // whole rounds of kUnroll vectors a stride apart, loads before compute,
  // then the rest one vector at a time
  int64_t i = tid;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    V vx[kUnroll], vr[kUnroll], vp[kUnroll], vap[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * stride;
      vx[u].v = xv[j];
      vr[u].v = rv[j];
      vp[u].v = pv[j];
      vap[u].v = apv[j];
      vb[u].v = bv[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      V xn, rn;
      update_vec(a, vx[u], vr[u], vp[u], vap[u], vb[u], xn, rn, m, rr);
      xov[i + u * stride] = xn.v;
      rov[i + u * stride] = rn.v;
    }
  }
  for (; i < nvec; i += stride) {
    V vx, vr, vp, vap, vb, xn, rn;
    vx.v = xv[i];
    vr.v = rv[i];
    vp.v = pv[i];
    vap.v = apv[i];
    vb.v = bv[i];
    update_vec(a, vx, vr, vp, vap, vb, xn, rn, m, rr);
    xov[i] = xn.v;
    rov[i] = rn.v;
  }
  // the scalar head [0, head) and tail [head + kWidth * nvec, n)
  const int64_t tail = head + kWidth * nvec;
  for (int64_t j = tid; j < head + (n - tail); j += stride) {
    const int64_t e = j < head ? j : tail + (j - head);
    update(a, x[e], r[e], p[e], ap[e], b[e], x_out[e], r_out[e], m, rr);
  }

  // the block's partials, then the last block to finish sums them all
  __shared__ bool s_last;
  T* partials = reinterpret_cast<T*>(scratch + kPartialsOffset);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch);
  block_sum(m, rr);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = m;
    partials[gridDim.x + blockIdx.x] = rr;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  m = 0;
  rr = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    m += __ldcg(partials + j);
    rr += __ldcg(partials + gridDim.x + j);
  }
  block_sum(m, rr);
  if (threadIdx.x == 0) {
    out[0] = T(0.5) * m;
    out[1] = rr;
    *ticket = 0;
  }
}

// Runs fn on `device`, restoring the caller's current device after.
template <typename Fn>
int on_device(int device, Fn fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int res = fn();
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (res == 0 && err != cudaSuccess) res = static_cast<int>(err);
  }
  return res;
}

// The launch's arguments, as the wrapper packs them (16 int64 values).
struct Args {
  int64_t x, r, p, ap, b, alpha, x_out, r_out, scratch, out;
  int64_t n, head, nvec, grid, device, stream;
};

template <typename T>
int launch(const Args& g) {
  auto ptr = [](int64_t v) { return reinterpret_cast<T*>(v); };
  return on_device(static_cast<int>(g.device), [&]() {
    fused_cg_update_kernel<T>
        <<<static_cast<int>(g.grid), kThreads, 0,
           reinterpret_cast<cudaStream_t>(g.stream)>>>(
            ptr(g.x), ptr(g.r), ptr(g.p), ptr(g.ap), ptr(g.b), ptr(g.alpha),
            ptr(g.x_out), ptr(g.r_out),
            reinterpret_cast<unsigned char*>(g.scratch), ptr(g.out), g.n,
            g.head, g.nvec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// The launch constants and the card's capacity for the kernel of this
// element size (4: f32, 8: f64) on `device`: threads per block, vectors of
// each operand in flight per thread, the scratch's byte offset of the
// partials, the SM count and the resident blocks per SM.
int fused_cg_update_config(int itemsize, int device, int* threads,
                           int* unroll, int* partials_offset, int* sm_count,
                           int* blocks_per_sm) {
  *threads = kThreads;
  *unroll = kUnroll;
  *partials_offset = kPartialsOffset;
  return on_device(device, [&]() {
    cudaError_t err = cudaDeviceGetAttribute(
        sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = itemsize == 4
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, fused_cg_update_kernel<float>, kThreads, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, fused_cg_update_kernel<double>, kThreads,
                    0);
    return static_cast<int>(err);
  });
}

// One launch; `args` holds an Args (pointers as integers).  itemsize 4
// launches the f32 kernel, 8 the f64 one.
int fused_cg_update(const void* args, int itemsize) {
  const Args& g = *static_cast<const Args*>(args);
  return itemsize == 4 ? launch<float>(g) : launch<double>(g);
}

}  // extern "C"
