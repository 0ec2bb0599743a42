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
// what the scattered load costs at each x size and pattern. The FMA modes'
// grid-stride loop is unrolled so each thread keeps several gathers in
// flight. The store mode moves the streams as 16 B per thread: a thread
// loads kStoreVecs int4 of indices (evict-first: read once), issues all
// their gathers, and writes float4s with a streaming store, in one trip
// (a grid of as many threads as the index stream needs, which the block
// scheduler balances to the end); a scalar head reaches the indices' 16 B
// alignment and a scalar tail takes what is left, so any contiguous int32
// view works. Making the probes fast is not their point, but the store
// mode is the yardstick of the gather floor (chip_smoke.py path G) and
// must not lose to index_select on the same indices.
//
// Launch rules: the caller's stream, no allocation, no synchronisation. Each
// entry point returns cudaGetLastError().

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// int4s of indices a thread of gather_store loads before its gathers
constexpr int kStoreVecs = 2;

// out[e] = x[idx[e]]. Elements [0, head) and the last (n - head) % 4 one at
// a time; the rest as int4 / float4, idx + head 16 B aligned, and
// kVecStore: out + head too.
template <bool kVecStore>
__global__ void __launch_bounds__(kThreads)
gather_store_kernel(const float* __restrict__ x,
                    const int32_t* __restrict__ idx, float* __restrict__ out,
                    int64_t n, int64_t head) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n4 = (n - head) / 4;
  const int4* __restrict__ idx4 = reinterpret_cast<const int4*>(idx + head);
  float* __restrict__ body = out + head;
  for (int64_t q0 = t; q0 < n4; q0 += kStoreVecs * stride) {
    int4 iv[kStoreVecs];
#pragma unroll
    for (int u = 0; u < kStoreVecs; ++u) {
      if (q0 + u * stride < n4) {
        iv[u] = __ldcs(idx4 + q0 + u * stride);
      }
    }
    float4 v[kStoreVecs];
#pragma unroll
    for (int u = 0; u < kStoreVecs; ++u) {
      if (q0 + u * stride < n4) {
        v[u] = make_float4(__ldg(x + iv[u].x), __ldg(x + iv[u].y),
                           __ldg(x + iv[u].z), __ldg(x + iv[u].w));
      }
    }
#pragma unroll
    for (int u = 0; u < kStoreVecs; ++u) {
      const int64_t q = q0 + u * stride;
      if (q < n4) {
        if (kVecStore) {
          __stcs(reinterpret_cast<float4*>(body) + q, v[u]);
        } else {
          __stcs(body + 4 * q, v[u].x);
          __stcs(body + 4 * q + 1, v[u].y);
          __stcs(body + 4 * q + 2, v[u].z);
          __stcs(body + 4 * q + 3, v[u].w);
        }
      }
    }
  }
  const int64_t e = t < head ? t : head + 4 * n4 + (t - head);
  if (t < head + (n - head - 4 * n4)) {
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

// out[e] = x[idx[e]] for e < n; every idx[e] must lie in x. idx and out
// need 4 B alignment only.
int uspmv_x_gather_store(const void* x, const void* idx, void* out, int64_t n,
                         void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const uintptr_t ia = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (ia % 4 != 0 || oa % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t head = std::min<int64_t>((16 - ia % 16) % 16 / 4, n);
  const bool vec_store = (oa + 4 * head) % 16 == 0;
  // one trip: kStoreVecs int4 per thread, and a thread per head or tail
  // element at least
  const int64_t per_block = static_cast<int64_t>(kStoreVecs) * kThreads;
  const int64_t needed =
      std::max<int64_t>((n - head) / 4, head + (n - head) % 4);
  const int64_t blocks = std::min<int64_t>(
      std::max<int64_t>((needed + per_block - 1) / per_block, 1),
      INT32_MAX);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float* op = static_cast<float*>(out);
  if (vec_store) {
    gather_store_kernel<true><<<static_cast<unsigned int>(blocks), kThreads,
                                0, s>>>(xf, ip, op, n, head);
  } else {
    gather_store_kernel<false><<<static_cast<unsigned int>(blocks), kThreads,
                                 0, s>>>(xf, ip, op, n, head);
  }
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
