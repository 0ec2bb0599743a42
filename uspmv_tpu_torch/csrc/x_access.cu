// x-access probes for NVIDIA Hopper (sm_90a): loads of a flat float x
// through an int32 index, the access that every SpMV kernel of this package
// makes once per stored element.
//
// Replaces the TPU probe kernels of the JAX package's scripts/:
//   test_gather1d.py `test_shape` (:46) and `bench_gather` (:85): Mosaic's
//       one-dimensional in-tile gather, out[i,j] = src[idx[i,j], j] or
//       src[i, idx[i,j]], checked against take_along_axis and timed over a
//       grid of index tiles that share one src;
//   test_gather2d.py `run` (:55): the full-table gather
//       out = src.flat[idx mod size];
//   test_gather_tput.py `bench` (:66): acc += vals * gather(x_tile, idx)
//       over (512, 128) blocks, beside a "copy" mode that reads x in place.
// On the TPU those ask which index shapes the register-tile gather lowers for
// and how fast it is. On Hopper every gather is x.flat[idx], a global load
// through L1 and L2, so one kernel per question answers all three scripts
// (the wrapper, ops/x_access.py, turns a 2-D src and a dim into flat
// indices):
//   gather_store  out[e] = x[idx[e]]
//   gather_fma    partial[t] = sum_{k} v[e] * x[idx[e]],  e = t + k*T
//   copy_fma      partial[t] = sum_{k} v[e] * x[e],       e = t + k*T
// where T = gridDim.x * blockDim.x threads walk the elements with a grid
// stride, each summing its own in order of k in float (one FMA a step).
//
// What bounds it: bytes. The index and value streams are read once,
// coalesced (8 B per element for the FMA modes, idx + out for the store);
// x is read once if it stays in the 50 MB L2. A random gather from an x
// larger than L2 costs a 32 B sector of device memory per 4 B load, 8x the
// bytes the bound counts. The design keeps the two streams coalesced and
// the gather the only scattered access, so the time against the bound says
// what the scattered load costs at each x size and pattern; the grid-stride
// loop is unrolled so each thread keeps several gathers in flight. Making it
// faster is not the point: it measures.
//
// Launch rules: the caller's stream, no allocation, no synchronisation. Each
// entry point returns cudaGetLastError().

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_store_kernel(const float* __restrict__ x,
                    const int32_t* __restrict__ idx, float* __restrict__ out,
                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < n; e += stride) {
    out[e] = __ldg(x + __ldg(idx + e));
  }
}

// kGather: x[idx[e]] (gather_fma), else x[e] (copy_fma)
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
fma_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
           const float* __restrict__ v, float* __restrict__ partial,
           int64_t n) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t e = t; e < n; e += stride) {
    const float xe = kGather ? __ldg(x + __ldg(idx + e)) : __ldg(x + e);
    acc += __ldg(v + e) * xe;
  }
  partial[t] = acc;
}

}  // namespace

extern "C" {

// out[e] = x[idx[e]] for e < n; every idx[e] must lie in x.
int uspmv_x_gather_store(const void* x, const void* idx, void* out, int64_t n,
                         void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks =
      std::min<int64_t>((n + kThreads - 1) / kThreads, INT32_MAX);
  gather_store_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// partial[t] = sum of v[e] * x[idx[e]] over e = t, t + T, ... < n, for
// t < T = n_threads, a multiple of 256 (ops/x_access.fma_threads).
int uspmv_x_gather_fma(const void* x, const void* idx, const void* v,
                       void* partial, int64_t n, int n_threads,
                       void* stream) {
  fma_kernel<true><<<n_threads / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<const float*>(v), static_cast<float*>(partial), n);
  return static_cast<int>(cudaGetLastError());
}

// The same with x[e] read in place (x holds at least n elements).
int uspmv_x_copy_fma(const void* x, const void* v, void* partial, int64_t n,
                     int n_threads, void* stream) {
  fma_kernel<false><<<n_threads / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), nullptr, static_cast<const float*>(v),
      static_cast<float*>(partial), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
