// Padding-free SpMV / SpMMV over packed row groups, y (+)= A x, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU mixed-tile kernel of uspmv_tpu/ops/pallas_scs.py:
//   `_kernel_mixed`  (:1347, launched by `spmv_mixed_tiles`, :1408)
// On the TPU a mixed tile holds the elements of up to 8 row chunks, does one
// gather per tile and routes each product to its chunk's output block by a
// 3-bit selector with masked read-modify-writes, so that many short rows
// share one dense tile and the stream carries little padding. Here shared
// memory is the routing medium.
//
// What it computes. The matrix is the SELL-C-sigma matrix with its padding
// dropped: rows in the SCS's permuted order, row r's elements contiguous at
// row_ptr[r] .. row_ptr[r+1]-1 in the SCS's own order. Rows are cut into
// consecutive groups g = group_ptr[g] .. group_ptr[g+1]-1 of at most
// kThreads rows and kStageElems elements. For every row r and column v:
//   y[r][v] (+)= sum_k Tx(values[k]) * x[col_idxs[k]][v]
// as a rounded product followed by a sum in order of k: two roundings, not
// the FMA of scs_spmv.cu, so the result differs from that kernel in the
// last bits and agrees with the plain PyTorch version (ops/scs_packed.py)
// up to the order of its index_add_.
//
// Design: one block per row group. Phase a: the block's threads stride over
// the group's elements, coalesced whatever the row lengths, and write
// val * x[col] into shared memory. Phase b: thread t sums row t's products
// from shared memory and writes, or with `accumulate` adds into, y; a row
// with no elements writes 0. Bound by bytes: the value and an int32 column
// per nonzero and 4 B per row of pointers, no padding, x through L2, y once.
// Rowwise block vectors run one pass (a, b) per column inside the launch;
// the group's values and columns (<= 48 KB) are read again from L1/L2, so
// device memory sees them once. Colwise block vectors: gridDim.y = vectors.
// Phase b reads shared memory at a stride of the row length (bank conflicts
// when rows are a multiple of 32 long); a warp per row for long rows is
// later work.
//
// Launch rules: the caller's stream, static shared memory (kStageElems
// accumulator words: 16 KB for float, 32 KB for double), no allocation, no
// synchronisation; the entry point returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scs_row.cuh"

namespace {

using uspmv::kThreads;
using uspmv::widen;

constexpr int kStageElems = 4096;
constexpr int kMaxGridY = 65535;

struct PackedArgs {
  const int32_t* group_ptr;
  const int32_t* row_ptr;
  const int32_t* col_idxs;
  const void* values;
  const void* x;
  int64_t x_ld;
  int64_t x_vstride;
  void* y;
  int64_t y_ld;
  int64_t y_vstride;
  int ncols;
  int accumulate;
};

template <typename Tv, typename Tx>
__global__ void __launch_bounds__(kThreads)
scs_packed_kernel(const PackedArgs a) {
  __shared__ Tx stage[kStageElems];
  const Tv* __restrict__ values = static_cast<const Tv*>(a.values);
  const Tx* __restrict__ x = static_cast<const Tx*>(a.x) +
                             static_cast<int64_t>(blockIdx.y) * a.x_vstride;
  Tx* __restrict__ y =
      static_cast<Tx*>(a.y) + static_cast<int64_t>(blockIdx.y) * a.y_vstride;
  const int32_t row0 = __ldg(a.group_ptr + blockIdx.x);
  const int32_t row1 = __ldg(a.group_ptr + blockIdx.x + 1);
  const int32_t e0 = __ldg(a.row_ptr + row0);
  const int32_t e1 = __ldg(a.row_ptr + row1);
  const int32_t r = row0 + static_cast<int32_t>(threadIdx.x);
  const bool has_row = r < row1;
  int32_t begin = 0;
  int32_t end = 0;
  if (has_row) {
    begin = __ldg(a.row_ptr + r) - e0;
    end = __ldg(a.row_ptr + r + 1) - e0;
  }
  for (int v = 0; v < a.ncols; ++v) {
    for (int32_t k = e0 + static_cast<int32_t>(threadIdx.x); k < e1;
         k += kThreads) {
      const Tx val = static_cast<Tx>(widen(__ldg(values + k)));
      stage[k - e0] =
          val * __ldg(x + static_cast<int64_t>(__ldg(a.col_idxs + k)) *
                              a.x_ld + v);
    }
    __syncthreads();
    if (has_row) {
      Tx acc = Tx(0);
      for (int32_t k = begin; k < end; ++k) {
        acc += stage[k];
      }
      Tx* yr = y + static_cast<int64_t>(r) * a.y_ld + v;
      *yr = a.accumulate ? *yr + acc : acc;
    }
    __syncthreads();  // the next column's products overwrite the stage
  }
}

template <typename Tv, typename Tx>
int launch_packed(int64_t n_groups, const void* group_ptr,
                  const void* row_ptr, const void* col_idxs,
                  const void* values, const void* x, int64_t x_ld,
                  int64_t x_vstride, void* y, int64_t y_ld, int64_t y_vstride,
                  int ncols, int n_vec, int accumulate, void* stream) {
  if (n_groups <= 0 || n_vec <= 0 || ncols <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n_vec > kMaxGridY || n_groups > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PackedArgs a{static_cast<const int32_t*>(group_ptr),
                     static_cast<const int32_t*>(row_ptr),
                     static_cast<const int32_t*>(col_idxs),
                     values,
                     x,
                     x_ld,
                     x_vstride,
                     y,
                     y_ld,
                     y_vstride,
                     ncols,
                     accumulate};
  const dim3 grid(static_cast<unsigned int>(n_groups),
                  static_cast<unsigned int>(n_vec));
  scs_packed_kernel<Tv, Tx>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point: y (+)= A x for one precision stream. The row groups
// must hold at most kThreads (256) rows and kStageElems (4096) elements
// each; ops/device_format.build_device_packed sees to it.
#define USPMV_PACKED_ENTRY(name, Tv, Tx)                                      \
  int name(int64_t n_groups, const void* group_ptr, const void* row_ptr,      \
           const void* col_idxs, const void* values, const void* x,           \
           int64_t x_ld, int64_t x_vstride, void* y, int64_t y_ld,            \
           int64_t y_vstride, int ncols, int n_vec, int accumulate,           \
           void* stream) {                                                    \
    return launch_packed<Tv, Tx>(n_groups, group_ptr, row_ptr, col_idxs,      \
                                 values, x, x_ld, x_vstride, y, y_ld,         \
                                 y_vstride, ncols, n_vec, accumulate, stream); \
  }

extern "C" {

USPMV_PACKED_ENTRY(uspmv_scs_packed_f64_f64, double, double)
USPMV_PACKED_ENTRY(uspmv_scs_packed_f32_f32, float, float)
USPMV_PACKED_ENTRY(uspmv_scs_packed_bf16_f32, __nv_bfloat16, float)

}  // extern "C"
