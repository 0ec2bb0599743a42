// Halo exchange of the row-sharded SpMV for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA hot path `_exchange` of the JAX package
// (uspmv_tpu/parallel/distributed.py:917-944; XLA ops, not a Pallas
// kernel): per ring offset d, a jnp.take of the send indices out of each
// shard's x, a ppermute from shard r to shard (r + d) % R, and a
// .at[scatter].set into the receiver's halo region.
//
// In this package the shards an operator holds in one process live on one
// device, each with its own halo-extended x of L elements, stacked into one
// buffer of R * L rows (R: the process's shards). Pack, permute and scatter then collapse into one copy, and the
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
// Across processes (one process per card, or several sharing one) a pair
// whose source and destination shards live in different processes cannot
// be one copy. Its rows go through a send buffer: the pack kernel gathers
// the rows a process sends, grouped by destination process, into a dense
// buffer of rows, the transfer (torch.distributed all_to_all_single) moves
// it, and the unpack kernel scatters the received rows, grouped by source
// process, into the halo rows. These answer the jnp.take pack and the
// .at[scatter].set of `_exchange` when its ppermute crosses a process:
//
//   pack:   buf[(i * n_vec + v) * ncols + c] = x[v * vstride + src[i] * ld + c]
//   unpack: x[v * vstride + dst[i] * ld + c] = buf[(i * n_vec + v) * ncols + c]
//
// so a buffer row holds every value of its x row, of every vector, and the
// transfer splits the buffer by rows. Both are bound by bytes and, at a
// stencil's halo sizes, by the launch; one thread takes a row as in the
// one-buffer copy. x and the buffer never alias, so the reads go through
// the read-only path.
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

// kPack: buffer row i takes x row rows[i]; else x row rows[i] takes buffer
// row i.
template <typename T, bool kPack>
__global__ void __launch_bounds__(kThreads)
halo_buffer_kernel(T* __restrict__ to_base, const T* __restrict__ from_base,
                   const int32_t* __restrict__ rows, int64_t n, int64_t ld,
                   int ncols, int64_t vstride) {
  const int64_t v = blockIdx.y;
  const int64_t n_vec = gridDim.y;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t xrow =
        v * vstride + static_cast<int64_t>(__ldg(rows + i)) * ld;
    const int64_t brow = (i * n_vec + v) * ncols;
    T* to = to_base + (kPack ? brow : xrow);
    const T* from = from_base + (kPack ? xrow : brow);
    for (int c = 0; c < ncols; ++c) {
      to[c] = __ldg(from + c);
    }
  }
}

dim3 grid_of(int64_t n, int n_vec) {
  const int64_t blocks =
      std::min<int64_t>((n + kThreads - 1) / kThreads, INT32_MAX);
  return dim3(static_cast<unsigned int>(blocks),
              static_cast<unsigned int>(n_vec));
}

template <typename T>
int launch(void* x, const void* src, const void* dst, int64_t n, int64_t ld,
           int ncols, int64_t vstride, int n_vec, void* stream) {
  if (n <= 0 || n_vec <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  halo_exchange_kernel<T><<<grid_of(n, n_vec), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), n, ld, ncols, vstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPack>
int launch_buffer(void* x, void* buf, const void* rows, int64_t n,
                  int64_t ld, int ncols, int64_t vstride, int n_vec,
                  void* stream) {
  if (n <= 0 || n_vec <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  T* to = static_cast<T*>(kPack ? buf : x);
  const T* from = static_cast<const T*>(kPack ? x : buf);
  halo_buffer_kernel<T, kPack><<<grid_of(n, n_vec), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      to, from, static_cast<const int32_t*>(rows), n, ld, ncols, vstride);
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

// buf[(i * n_vec + v) * ncols + c] = x[v * vstride + src[i] * ld + c] for
// i < n, c < ncols, v < n_vec (n >= 1); x and buf do not overlap.
int uspmv_halo_pack_f32(void* x, void* buf, const void* src, int64_t n,
                        int64_t ld, int ncols, int64_t vstride, int n_vec,
                        void* stream) {
  return launch_buffer<float, true>(x, buf, src, n, ld, ncols, vstride,
                                    n_vec, stream);
}

int uspmv_halo_pack_f64(void* x, void* buf, const void* src, int64_t n,
                        int64_t ld, int ncols, int64_t vstride, int n_vec,
                        void* stream) {
  return launch_buffer<double, true>(x, buf, src, n, ld, ncols, vstride,
                                     n_vec, stream);
}

// x[v * vstride + dst[i] * ld + c] = buf[(i * n_vec + v) * ncols + c] for
// i < n, c < ncols, v < n_vec (n >= 1); no dst row repeats.
int uspmv_halo_unpack_f32(void* x, void* buf, const void* dst, int64_t n,
                          int64_t ld, int ncols, int64_t vstride, int n_vec,
                          void* stream) {
  return launch_buffer<float, false>(x, buf, dst, n, ld, ncols, vstride,
                                     n_vec, stream);
}

int uspmv_halo_unpack_f64(void* x, void* buf, const void* dst, int64_t n,
                          int64_t ld, int ncols, int64_t vstride, int n_vec,
                          void* stream) {
  return launch_buffer<double, false>(x, buf, dst, n, ld, ncols, vstride,
                                      n_vec, stream);
}

}  // extern "C"
