// Halo exchange of the row-sharded SpMV for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA hot path `_exchange` of the JAX package
// (uspmv_tpu/parallel/distributed.py:917-944; XLA ops, not a Pallas
// kernel): per ring offset d, a jnp.take of the send indices out of each
// shard's x, a ppermute from shard r to shard (r + d) % R, and a
// .at[scatter].set into the receiver's halo region.
//
// In this package the R shards of one operator live on one device, each
// with its own halo-extended x of L elements, stacked into one buffer of
// R * L rows. Pack, permute and scatter then collapse into one copy, and the
// host flattens the plan into (source row, destination row) pairs of the
// stacked buffer (parallel/halo.exchange_rows):
//
//   x[dst[i]] = x[src[i]]   for i < n, every active offset and shard,
//
// the real lanes only (padding lanes of the JAX plan write a dump slot
// that nothing reads). Sources are local rows of their shard (< its padded
// local rows), destinations halo rows of another shard (>= its padded local
// rows), and every destination is written once: the copy is race-free in
// any order and bit-exact.
//
// Layouts, as the SpMV kernels take them: element (row, column c, vector v)
// of the stacked buffer lies at v * vstride + row * ld + c, c < ncols:
// one vector (ld 1, ncols 1), rowwise block vectors [R * L, bs] (ld bs,
// ncols bs), colwise [bs, R * L] (vstride R * L, one grid row per vector).
//
// What bounds it: bytes, and for the small halos of a stencil the launch.
// Each pair reads two int32 indices, one scattered x row and writes one
// scattered x row; a thread takes a pair and copies its ncols contiguous
// values, so neighbouring threads read neighbouring index words. x is read
// with ordinary loads: the kernel writes the same buffer (never the same
// rows), so the read-only path is not used.
//
// Launch rules: the caller's stream, no allocation, no synchronisation. Each
// entry point returns cudaGetLastError().

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_exchange_kernel(T* x, const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst, int64_t n, int64_t ld,
                     int ncols, int64_t vstride) {
  T* xv = x + static_cast<int64_t>(blockIdx.y) * vstride;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const T* from = xv + static_cast<int64_t>(__ldg(src + i)) * ld;
    T* to = xv + static_cast<int64_t>(__ldg(dst + i)) * ld;
    for (int c = 0; c < ncols; ++c) {
      to[c] = from[c];
    }
  }
}

template <typename T>
int launch(void* x, const void* src, const void* dst, int64_t n, int64_t ld,
           int ncols, int64_t vstride, int n_vec, void* stream) {
  if (n <= 0 || n_vec <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks =
      std::min<int64_t>((n + kThreads - 1) / kThreads, INT32_MAX);
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(n_vec));
  halo_exchange_kernel<T><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), n, ld, ncols, vstride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x[v * vstride + dst[i] * ld + c] = x[v * vstride + src[i] * ld + c] for
// i < n, c < ncols, v < n_vec (n >= 1). No src row may equal a dst row.
int uspmv_halo_exchange_f32(void* x, const void* src, const void* dst,
                            int64_t n, int64_t ld, int ncols,
                            int64_t vstride, int n_vec, void* stream) {
  return launch<float>(x, src, dst, n, ld, ncols, vstride, n_vec, stream);
}

int uspmv_halo_exchange_f64(void* x, const void* src, const void* dst,
                            int64_t n, int64_t ld, int ncols,
                            int64_t vstride, int n_vec, void* stream) {
  return launch<double>(x, src, dst, n, ld, ncols, vstride, n_vec, stream);
}

}  // extern "C"
