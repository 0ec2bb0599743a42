// One row of a SELL-C-sigma product, shared by scs_spmv.cu (one SpMV per
// launch) and scs_solve.cu (k SpMVs in one launch). Both kernels take a
// row's sum from `scs_row_product`, so they perform the same operations in
// the same order and a fused solve equals k separate launches bit for bit.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uspmv {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;

// One precision stream's SCS arrays. They are never written by a kernel,
// so they are read through the read-only data path (__ldg).
struct ScsMatrix {
  int64_t n_rows_padded;
  int C;
  const int32_t* chunk_ptrs;
  const int32_t* chunk_lengths;
  const int32_t* col_idxs;
  const void* values;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// kReadOnlyX: x is not written during the launch, so it may be read
// through the read-only path too. A kernel that writes a vector and reads
// it again after a grid-wide barrier must pass false: a read-only load
// may return the line as it was before the other blocks wrote it.
template <typename Tx, bool kReadOnlyX>
__device__ __forceinline__ Tx load_x(const Tx* p) {
  if (kReadOnlyX) {
    return __ldg(p);
  }
  return *p;
}

// acc[v] = sum_{j < chunk_lengths[c]} Tx(values[e]) * x[col_idxs[e]*x_ld + v],
// e = chunk_ptrs[c] + j*C + i, for padded row r = c*C + i, summed in order
// of j as `acc += a * x` (contracted to an FMA). BS accumulators per
// thread; kFull: ncols == BS (no column guard).
template <typename Tv, typename Tx, int BS, bool kFull, bool kReadOnlyX>
__device__ __forceinline__ void scs_row_product(const ScsMatrix& m,
                                                const Tx* x, int64_t x_ld,
                                                int64_t r, int ncols,
                                                Tx (&acc)[BS]) {
  const Tv* __restrict__ values = static_cast<const Tv*>(m.values);
  const int C = m.C;
  const int64_t c = r / C;
  const int64_t i = r - c * C;
  const int32_t len = __ldg(m.chunk_lengths + c);
  const int64_t base = static_cast<int64_t>(__ldg(m.chunk_ptrs + c)) + i;
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    acc[v] = Tx(0);
  }
  for (int32_t j = 0; j < len; ++j) {
    const int64_t e = base + static_cast<int64_t>(j) * C;
    const Tx val = static_cast<Tx>(widen(__ldg(values + e)));
    const Tx* xr = x + static_cast<int64_t>(__ldg(m.col_idxs + e)) * x_ld;
#pragma unroll
    for (int v = 0; v < BS; ++v) {
      if (kFull || v < ncols) {
        acc[v] += val * load_x<Tx, kReadOnlyX>(xr + v);
      }
    }
  }
}

}  // namespace uspmv
