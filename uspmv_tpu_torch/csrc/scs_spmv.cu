// SELL-C-sigma SpMV / SpMMV, y (+)= A x, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU lane-tile kernels of uspmv_tpu/ops/pallas_scs.py:
//   `_kernel`                (:820,  launched by `spmv_lane_tiles`)
//   `_kernel_windowed`       (:1478, the same, x DMA'd in VMEM windows)
//   `_kernel_df64`           (:761,  launched by `_spmv_lane_tiles_df64`)
//   `_kernel_df64_windowed`  (:1579, the same, x DMA'd in VMEM windows)
// (`_kernel_solve`, :1898, k iterations in one launch, is answered by
// scs_solve.cu, which shares this kernel's row sum through scs_row.cuh.)
// On the TPU those gather x through (8,128) register tiles from a VMEM
// window; the windowed variants stream per-group x windows by DMA once x
// exceeds the VMEM budget; and the df64 pair emulates f64 with (hi, lo)
// float pairs because the TPU has no f64. Here x is read through L2 and the
// read-only data path, so one kernel serves every x size, and f64 is native:
// -dp_emu runs the (double, double) instantiation.
//
// What it computes, for permuted row r = c*C + i (0 <= r < n_rows_padded)
// and right-hand side v < ncols:
//   acc[v] = sum_{j < chunk_lengths[c]} Tx(values[e]) * x[col_idxs[e]][v],
//            e = chunk_ptrs[c] + j*C + i,
//   y[r][v] = acc[v]             (accumulate == 0)
//   y[r][v] = y[r][v] + acc[v]   (accumulate != 0: the adaptive-precision
//                                 sum y = y_p0 + y_p1 + ..., in the order of
//                                 the JAX operator's closure)
// summed in order of j in the accumulator type Tx. Each step is
// `acc += a * x`, which the compiler contracts to an FMA, so results differ
// from the plain PyTorch version (ops/scs_spmv.py) in the last bits only.
//
// The unit-value form (uspmv_scs_spmv_unit_f32) answers the `unit=True`
// variant of `_kernel` / `_kernel_windowed` (pallas_scs.py:858-868 and
// :1558-1566, built by `build_device_lane_tiles(unit_values=True)`): an
// all-ones matrix with no value stream, where the TPU marks padding by bit 15
// of the gather table and selects instead of multiplying. Here col_idxs is -1
// at padding slots and
//   acc[v] = sum_{j < chunk_lengths[c], col_idxs[e] >= 0} x[col_idxs[e]][v]
// summed in order of j in float, with the same grid, strides, block-vector
// layouts and accumulate flag as every other entry. It streams 4 B per
// stored element where sp streams 8, so its time against sp's says whether
// the kernel is bound by bytes or by loads in flight. It has its own row loop
// (scs_ones_row_sum), so scs_row.cuh, which the solve kernel shares, stays as
// it is.
//
// Instantiated (value type Tv, vector/accumulator type Tx) pairs:
//   (double, double)        dp, -dp_emu, the dp stream of ap[dp_*]
//   (float,  float)         sp
//   (bf16,   float)         hp and the hp stream of ap[sp_hp]
//   (float,  double)        the sp stream of ap[dp_sp] / ap[dp_sp_hp]
//   (bf16,   double)        the hp stream of ap[dp_hp] / ap[dp_sp_hp]
// bf16 values are widened with __bfloat162float. ap[dp_*] therefore
// accumulates every stream in double, as the C++ original does
// (ap_kernels.hpp:204). Deviation from the JAX package: under -dp_emu it
// sums the sp/hp partials in f32 against the hi part of x
// (uspmv_tpu/runtime/operator.py:1033-1038), so the two agree to ~1e-7
// relative there, and to ~1e-16 against its f64 XLA path.
//
// Block vectors:
//   * rowwise x[n_pad][bs] (x_ld = bs): one launch reads each matrix element
//     once for up to 8 columns (the bs loop of `_kernel`, pallas_scs.py:
//     873-876), with BS in {1, 2, 4, 8} accumulators per thread (3 and 5-7
//     columns run the next BS with a column guard); the wrapper runs
//     bs > 8 in passes of <= 8 columns. One vector with unit strides gets
//     its own instantiation, free of stride arithmetic. A template on BS
//     keeps the accumulators in registers and the matrix element in one
//     register for all columns, where a thread per (row, column) would load
//     each element bs times.
//   * colwise x[bs][n_pad]: gridDim.y = bs, one matrix pass per vector
//     (x_vstride / y_vstride = n_pad), as the JAX operator vmaps per vector.
//
// Design: one thread per padded row. Elements are column-major within a
// chunk, so the threads of a chunk read consecutive values and col_idxs at
// each j and the loads coalesce for any C >= 32; C = 1 (CRS) is correct but
// uncoalesced. The kernel is bound by device-memory bytes: per stored
// element 12 B for f64 values, 8 B for f32, 6 B for bf16 (value + int32
// column), plus x once through L2 and y once (twice when accumulating).
// Making it fast (a warp per chunk slice, vectorised loads, streaming cache
// hints, one fused launch over all precision streams) is later work.
//
// Launch rules: the caller's stream, no allocation, no synchronisation. Each
// entry point returns cudaGetLastError() so the caller can raise when a
// launch is refused.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scs_row.cuh"

namespace {

using uspmv::kMaxCols;
using uspmv::kThreads;
using uspmv::ScsMatrix;

constexpr int kMaxGridY = 65535;

// One launch: a precision stream's SCS arrays, x and y with their strides.
struct ScsArgs {
  ScsMatrix m;
  const void* x;
  int64_t x_ld;       // elements between the rows of x (bs rowwise, else 1)
  int64_t x_vstride;  // elements between colwise vectors (gridDim.y)
  void* y;
  int64_t y_ld;
  int64_t y_vstride;
  int ncols;  // rowwise columns of this launch, <= kMaxCols
  int accumulate;
};

// BS accumulators per thread; kFull: ncols == BS (no column guard);
// kUnit: one vector with unit strides (x_ld == y_ld == 1), the plain SpMV.
template <typename Tv, typename Tx, int BS, bool kFull, bool kUnit>
__global__ void __launch_bounds__(kThreads)
scs_spmv_kernel(const ScsArgs a) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.m.n_rows_padded) {
    return;
  }
  const Tx* __restrict__ x = static_cast<const Tx*>(a.x) +
                             static_cast<int64_t>(blockIdx.y) * a.x_vstride;
  Tx* __restrict__ y =
      static_cast<Tx*>(a.y) + static_cast<int64_t>(blockIdx.y) * a.y_vstride;
  const int64_t x_ld = kUnit ? 1 : a.x_ld;
  const int64_t y_ld = kUnit ? 1 : a.y_ld;
  Tx acc[BS];
  uspmv::scs_row_product<Tv, Tx, BS, kFull, true>(a.m, x, x_ld, r, a.ncols,
                                                  acc);
  Tx* yr = y + r * y_ld;
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    if (kFull || v < a.ncols) {
      yr[v] = a.accumulate ? yr[v] + acc[v] : acc[v];
    }
  }
}

// The row sum of an all-ones matrix: acc[v] = sum of x[col*x_ld + v] over
// the slots of row r whose column is >= 0 (-1 marks padding), in order of j.
template <int BS, bool kFull>
__device__ __forceinline__ void scs_ones_row_sum(const ScsMatrix& m,
                                                 const float* x, int64_t x_ld,
                                                 int64_t r, int ncols,
                                                 float (&acc)[BS]) {
  const int C = m.C;
  const int64_t c = r / C;
  const int64_t i = r - c * C;
  const int32_t len = __ldg(m.chunk_lengths + c);
  const int64_t base = static_cast<int64_t>(__ldg(m.chunk_ptrs + c)) + i;
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    acc[v] = 0.0f;
  }
  for (int32_t j = 0; j < len; ++j) {
    const int32_t col = __ldg(m.col_idxs + base + static_cast<int64_t>(j) * C);
    if (col >= 0) {
      const float* xr = x + static_cast<int64_t>(col) * x_ld;
#pragma unroll
      for (int v = 0; v < BS; ++v) {
        if (kFull || v < ncols) {
          acc[v] += __ldg(xr + v);
        }
      }
    }
  }
}

// The unit-value form of scs_spmv_kernel (float x and y; m.values unread).
// kOnesStride1: one vector with unit strides.
template <int BS, bool kFull, bool kOnesStride1>
__global__ void __launch_bounds__(kThreads)
scs_ones_kernel(const ScsArgs a) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.m.n_rows_padded) {
    return;
  }
  const float* __restrict__ x = static_cast<const float*>(a.x) +
                                static_cast<int64_t>(blockIdx.y) * a.x_vstride;
  float* __restrict__ y =
      static_cast<float*>(a.y) + static_cast<int64_t>(blockIdx.y) * a.y_vstride;
  const int64_t x_ld = kOnesStride1 ? 1 : a.x_ld;
  const int64_t y_ld = kOnesStride1 ? 1 : a.y_ld;
  float acc[BS];
  scs_ones_row_sum<BS, kFull>(a.m, x, x_ld, r, a.ncols, acc);
  float* yr = y + r * y_ld;
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    if (kFull || v < a.ncols) {
      yr[v] = a.accumulate ? yr[v] + acc[v] : acc[v];
    }
  }
}

// kOnes: the unit-value kernel (Tv and Tx are then float and unused)
template <typename Tv, typename Tx, bool kOnes, int BS, bool kFull,
          bool kUnit = false>
void launch_variant(const ScsArgs& a, dim3 grid, cudaStream_t stream) {
  if constexpr (kOnes) {
    scs_ones_kernel<BS, kFull, kUnit><<<grid, kThreads, 0, stream>>>(a);
  } else {
    scs_spmv_kernel<Tv, Tx, BS, kFull, kUnit>
        <<<grid, kThreads, 0, stream>>>(a);
  }
}

template <typename Tv, typename Tx, bool kOnes = false>
int launch_scs_spmv(int64_t n_rows_padded, int C, const void* chunk_ptrs,
                    const void* chunk_lengths, const void* col_idxs,
                    const void* values, const void* x, int64_t x_ld,
                    int64_t x_vstride, void* y, int64_t y_ld,
                    int64_t y_vstride, int ncols, int n_vec, int accumulate,
                    void* stream) {
  if (n_rows_padded <= 0 || n_vec <= 0 || ncols <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (C < 1 || ncols > kMaxCols || n_vec > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rows_padded + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScsArgs a{{n_rows_padded, C,
                   static_cast<const int32_t*>(chunk_ptrs),
                   static_cast<const int32_t*>(chunk_lengths),
                   static_cast<const int32_t*>(col_idxs), values},
                  x,
                  x_ld,
                  x_vstride,
                  y,
                  y_ld,
                  y_vstride,
                  ncols,
                  accumulate};
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(n_vec));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1:
      if (x_ld == 1 && y_ld == 1) {
        launch_variant<Tv, Tx, kOnes, 1, true, true>(a, grid, s);
      } else {
        launch_variant<Tv, Tx, kOnes, 1, true>(a, grid, s);
      }
      break;
    case 2:
      launch_variant<Tv, Tx, kOnes, 2, true>(a, grid, s);
      break;
    case 3:
      launch_variant<Tv, Tx, kOnes, 4, false>(a, grid, s);
      break;
    case 4:
      launch_variant<Tv, Tx, kOnes, 4, true>(a, grid, s);
      break;
    case 8:
      launch_variant<Tv, Tx, kOnes, 8, true>(a, grid, s);
      break;
    default:  // 5..7
      launch_variant<Tv, Tx, kOnes, 8, false>(a, grid, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point: y (+)= A x for one precision stream. x_ld / y_ld are
// the element strides between rows (bs for rowwise block vectors, else 1),
// x_vstride / y_vstride the strides between the n_vec vectors of a colwise
// block (gridDim.y), ncols <= 8 the rowwise columns of this pass.

int uspmv_scs_spmv_f64_f64(int64_t n_rows_padded, int C,
                           const void* chunk_ptrs, const void* chunk_lengths,
                           const void* col_idxs, const void* values,
                           const void* x, int64_t x_ld, int64_t x_vstride,
                           void* y, int64_t y_ld, int64_t y_vstride,
                           int ncols, int n_vec, int accumulate,
                           void* stream) {
  return launch_scs_spmv<double, double>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, col_idxs, values, x, x_ld,
      x_vstride, y, y_ld, y_vstride, ncols, n_vec, accumulate, stream);
}

int uspmv_scs_spmv_f32_f32(int64_t n_rows_padded, int C,
                           const void* chunk_ptrs, const void* chunk_lengths,
                           const void* col_idxs, const void* values,
                           const void* x, int64_t x_ld, int64_t x_vstride,
                           void* y, int64_t y_ld, int64_t y_vstride,
                           int ncols, int n_vec, int accumulate,
                           void* stream) {
  return launch_scs_spmv<float, float>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, col_idxs, values, x, x_ld,
      x_vstride, y, y_ld, y_vstride, ncols, n_vec, accumulate, stream);
}

int uspmv_scs_spmv_bf16_f32(int64_t n_rows_padded, int C,
                            const void* chunk_ptrs, const void* chunk_lengths,
                            const void* col_idxs, const void* values,
                            const void* x, int64_t x_ld, int64_t x_vstride,
                            void* y, int64_t y_ld, int64_t y_vstride,
                            int ncols, int n_vec, int accumulate,
                            void* stream) {
  return launch_scs_spmv<__nv_bfloat16, float>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, col_idxs, values, x, x_ld,
      x_vstride, y, y_ld, y_vstride, ncols, n_vec, accumulate, stream);
}

int uspmv_scs_spmv_f32_f64(int64_t n_rows_padded, int C,
                           const void* chunk_ptrs, const void* chunk_lengths,
                           const void* col_idxs, const void* values,
                           const void* x, int64_t x_ld, int64_t x_vstride,
                           void* y, int64_t y_ld, int64_t y_vstride,
                           int ncols, int n_vec, int accumulate,
                           void* stream) {
  return launch_scs_spmv<float, double>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, col_idxs, values, x, x_ld,
      x_vstride, y, y_ld, y_vstride, ncols, n_vec, accumulate, stream);
}

int uspmv_scs_spmv_bf16_f64(int64_t n_rows_padded, int C,
                            const void* chunk_ptrs, const void* chunk_lengths,
                            const void* col_idxs, const void* values,
                            const void* x, int64_t x_ld, int64_t x_vstride,
                            void* y, int64_t y_ld, int64_t y_vstride,
                            int ncols, int n_vec, int accumulate,
                            void* stream) {
  return launch_scs_spmv<__nv_bfloat16, double>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, col_idxs, values, x, x_ld,
      x_vstride, y, y_ld, y_vstride, ncols, n_vec, accumulate, stream);
}

// y (+)= A x for an all-ones matrix built with unit_values: the arguments
// of the entries above, float x and y; values is not read (may be null).
int uspmv_scs_spmv_unit_f32(int64_t n_rows_padded, int C,
                            const void* chunk_ptrs, const void* chunk_lengths,
                            const void* col_idxs, const void* values,
                            const void* x, int64_t x_ld, int64_t x_vstride,
                            void* y, int64_t y_ld, int64_t y_vstride,
                            int ncols, int n_vec, int accumulate,
                            void* stream) {
  return launch_scs_spmv<float, float, true>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, col_idxs, values, x, x_ld,
      x_vstride, y, y_ld, y_vstride, ncols, n_vec, accumulate, stream);
}

const char* uspmv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
