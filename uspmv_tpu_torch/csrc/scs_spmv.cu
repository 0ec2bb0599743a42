// SELL-C-sigma SpMV, y = A x, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU lane-tile kernels `_kernel` and `_kernel_windowed` of
// uspmv_tpu/ops/pallas_scs.py (launched by `spmv_lane_tiles`). On the TPU
// those gather x through (8,128) register tiles from a VMEM window, and the
// windowed variant streams per-group x windows by DMA once x exceeds the
// VMEM budget. Here x is read through L2 and the read-only data path, so one
// kernel serves every x size and reads the SCS layout as it is: no lane
// tiles, no packer.
//
// What it computes, for permuted row r = c*C + i (0 <= r < n_rows_padded):
//   y[r] = sum_{j < chunk_lengths[c]} values[chunk_ptrs[c] + j*C + i]
//                                     * x[col_idxs[chunk_ptrs[c] + j*C + i]]
// in the value type T (float for sp, double for dp), summed in order of j,
// the order of the plain PyTorch version (ops/scs_spmv.py). Each step is
// `acc += v * x`, which the compiler contracts to an FMA, so results differ
// from the plain version in the last bits only.
//
// Padding elements hold value 0 at column 0 (formats/scs.py). Reading them
// is harmless unless x[0] is not finite (0 * inf = NaN); the plain version
// has the same semantics.
//
// Design: one thread per padded row. Elements are column-major within a
// chunk, so the threads of a chunk read consecutive values and col_idxs at
// each j and the loads coalesce for any C >= 32; C = 1 (CRS) is correct but
// uncoalesced. The kernel is bound by device-memory bytes: 8 B per stored
// element for sp (12 B for dp) plus x once through L2 and y once. Making it
// fast (a warp per chunk slice, vectorised loads, streaming cache hints) is
// later work.
//
// Launch rules: the caller's stream, no allocation, no synchronisation. Each
// entry point returns cudaGetLastError() so the caller can raise when a
// launch is refused.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
scs_spmv_kernel(int64_t n_rows_padded, int C,
                const int32_t* __restrict__ chunk_ptrs,
                const int32_t* __restrict__ chunk_lengths,
                const int32_t* __restrict__ col_idxs,
                const T* __restrict__ values,
                const T* __restrict__ x,
                T* __restrict__ y) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_rows_padded) {
    return;
  }
  const int64_t c = r / C;
  const int64_t i = r - c * C;
  const int32_t len = __ldg(chunk_lengths + c);
  const int64_t base = static_cast<int64_t>(__ldg(chunk_ptrs + c)) + i;
  T acc = T(0);
  for (int32_t j = 0; j < len; ++j) {
    const int64_t e = base + static_cast<int64_t>(j) * C;
    acc += __ldg(values + e) * __ldg(x + __ldg(col_idxs + e));
  }
  y[r] = acc;
}

template <typename T>
int launch_scs_spmv(int64_t n_rows_padded, int C, const void* chunk_ptrs,
                    const void* chunk_lengths, const void* col_idxs,
                    const void* values, const void* x, void* y,
                    void* stream) {
  if (n_rows_padded <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rows_padded + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scs_spmv_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      n_rows_padded, C, static_cast<const int32_t*>(chunk_ptrs),
      static_cast<const int32_t*>(chunk_lengths),
      static_cast<const int32_t*>(col_idxs), static_cast<const T*>(values),
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int uspmv_scs_spmv_f32(int64_t n_rows_padded, int C, const void* chunk_ptrs,
                       const void* chunk_lengths, const void* col_idxs,
                       const void* values, const void* x, void* y,
                       void* stream) {
  return launch_scs_spmv<float>(n_rows_padded, C, chunk_ptrs, chunk_lengths,
                                col_idxs, values, x, y, stream);
}

int uspmv_scs_spmv_f64(int64_t n_rows_padded, int C, const void* chunk_ptrs,
                       const void* chunk_lengths, const void* col_idxs,
                       const void* values, const void* x, void* y,
                       void* stream) {
  return launch_scs_spmv<double>(n_rows_padded, C, chunk_ptrs, chunk_lengths,
                                 col_idxs, values, x, y, stream);
}

const char* uspmv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
