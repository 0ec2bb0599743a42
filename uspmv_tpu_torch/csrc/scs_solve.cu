// Fused solve: k iterations of y = A x; x <- y in ONE launch, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_solve` (uspmv_tpu/ops/pallas_scs.py:1898,
// launched by `solve_lane_tiles` :2002). There grid=(k, ns) sweeps the
// matrix k times while x and y ping-pong between the halves of a VMEM
// scratch buffer, and the iterations are ordered because a TPU grid runs
// in order on one core. On a GPU nothing orders the blocks of a grid, so
// this is a persistent cooperative kernel instead: a grid no larger than
// what is co-resident on the card, a grid-stride loop over the padded rows
// of the SCS layout, and a grid-wide barrier (cooperative groups) between
// iterations. The two ping-pong vectors live in global memory, where they
// stay in the 50 MB L2 for every size the one-launch form is meant for.
//
// What it computes, for it = 0 .. k-1:
//   src = (it == 0) ? x0 : buf[(it - 1) & 1];  buf[it & 1] = A src
// with each row's sum taken by `scs_row_product` (scs_row.cuh), the code
// scs_spmv.cu runs, so the result equals k launches of that kernel bit for
// bit. x0 is only read. After the launch A^k x0 is in buf[(k - 1) & 1] and
// A^(k-1) x0 in buf[k & 1] (k >= 2; for k == 1 it is x0 itself).
// Intermediate vectors stay in the accumulator type Tx (f32 under hp).
//
// Vector loads are ordinary loads through a pointer that is neither const
// nor __restrict__: iteration it + 1 reads what other blocks wrote in
// iteration it of the same launch, which the read-only path (__ldg,
// ld.global.nc) does not promise to see. The barrier's fence makes the
// writes visible to ordinary loads. Rowwise bs 4 in f32 reads a column's
// values by 16-byte ordinary loads where the rows of x0, buf0 and buf1 all
// lie on 16-byte boundaries, as scs_spmv.cu's rowwise form does with
// read-only ones; the FMAs are the same (bs 8, and bs 4 in f64, keep
// scalar loads: under the 48-register cap the 16-byte ones spilled). The
// matrix arrays are read as the SpMV kernel reads them (scs_row.cuh:
// evict-first, in batched trips).
//
// No thread returns before the last barrier: every thread of every block
// reaches every grid.sync(), rows or not.
//
// Instantiated (values, x): (double, double), (float, float), (bf16,
// float); one vector, or rowwise block vectors x[n_pad][bs] with bs <= 8
// (BS in {1, 2, 4, 8} accumulators per thread, as in scs_spmv.cu). k and bs
// are run-time arguments. One precision stream only: an adaptive-precision
// sum, colwise block vectors and bs > 8 go through k launches of the SpMV
// kernel (or a CUDA graph of them).
//
// Bound, per iteration: the matrix stream from device memory when it
// exceeds L2 (as one SpMV), else L2 and load latency plus the barrier. The
// grid is min(blocks the rows need, co-resident blocks), computed here for
// the instantiation being launched; a cooperative grid that does not fit
// is refused at launch, and the entry point returns that error.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scs_row.cuh"

namespace cg = cooperative_groups;

namespace {

using uspmv::kMaxCols;
using uspmv::kMinBlocksPerSm;
using uspmv::kThreads;
using uspmv::ScsMatrix;

struct SolveArgs {
  ScsMatrix m;
  const void* x0;  // the caller's x, read in iteration 0 only
  void* buf0;      // written by even iterations
  void* buf1;      // written by odd iterations
  int64_t ld;      // elements between the rows of a vector (bs, or 1)
  int ncols;       // rowwise columns, <= kMaxCols
  int k;           // iterations, >= 1
};

// kGroups: rows stop at their group's length (scs_row.cuh); kVecX: x0,
// buf0 and buf1 have their rows on 16-byte boundaries, read by 16-byte
// loads (plain loads: the buffers are written during the launch)
template <typename Tv, typename Tx, int BS, bool kFull, bool kUnit,
          bool kGroups, bool kVecX = false>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
scs_solve_kernel(const SolveArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t ld = kUnit ? 1 : a.ld;
  Tx* const buf0 = static_cast<Tx*>(a.buf0);
  Tx* const buf1 = static_cast<Tx*>(a.buf1);
  for (int it = 0; it < a.k; ++it) {
    Tx* dst = (it & 1) ? buf1 : buf0;
    const Tx* src = it == 0 ? static_cast<const Tx*>(a.x0)
                            : ((it & 1) ? buf0 : buf1);
    for (int64_t r = first; r < a.m.n_rows_padded; r += stride) {
      Tx acc[BS];
      uspmv::scs_row_product<Tv, Tx, BS, kFull, false, kGroups, false,
                             kVecX>(a.m, src, ld, r, a.ncols, acc);
      Tx* yr = dst + r * ld;
#pragma unroll
      for (int v = 0; v < BS; ++v) {
        if (kFull || v < a.ncols) {
          yr[v] = acc[v];
        }
      }
    }
    if (it + 1 < a.k) {
      grid.sync();
    }
  }
}

template <typename Tv, typename Tx, int BS, bool kFull, bool kUnit = false,
          bool kVecX = false>
cudaError_t launch_variant(SolveArgs a, int64_t blocks_needed,
                           cudaStream_t stream) {
  const void* kernel =
      a.m.group_length_bytes != 0
          ? reinterpret_cast<const void*>(
                &scs_solve_kernel<Tv, Tx, BS, kFull, kUnit, true, kVecX>)
          : reinterpret_cast<const void*>(
                &scs_solve_kernel<Tv, Tx, BS, kFull, kUnit, false, kVecX>);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return err;
  }
  int cooperative = 0;
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                               device);
  if (err != cudaSuccess) {
    return err;
  }
  if (!cooperative) {
    return cudaErrorNotSupported;
  }
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) {
    return err;
  }
  const int64_t resident = static_cast<int64_t>(per_sm) * n_sm;
  if (resident < 1) {
    return cudaErrorLaunchOutOfResources;
  }
  const int64_t blocks = blocks_needed < resident ? blocks_needed : resident;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned int>(blocks)), dim3(kThreads), params,
      0, stream);
}

template <typename Tv, typename Tx>
int launch_scs_solve(int64_t n_rows_padded, int C, const void* chunk_ptrs,
                     const void* chunk_lengths, const void* group_lengths,
                     int group_length_bytes, const void* col_idxs,
                     const void* values, const void* x0, void* buf0,
                     void* buf1, int64_t ld, int ncols, int k, void* stream) {
  if (n_rows_padded <= 0 || C < 1 || ncols < 1 || ncols > kMaxCols ||
      k < 1 || ld < ncols || group_length_bytes < 0 ||
      group_length_bytes == 3 || group_length_bytes > 4 ||
      (group_length_bytes != 0 && group_lengths == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SolveArgs a{{n_rows_padded, C,
                     static_cast<const int32_t*>(chunk_ptrs),
                     static_cast<const int32_t*>(chunk_lengths),
                     static_cast<const int32_t*>(col_idxs), values,
                     group_lengths, group_length_bytes},
                    x0, buf0, buf1, ld, ncols, k};
  const int64_t blocks = (n_rows_padded + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every vector the iterations read: 16-byte loads where all three allow
  const bool vec_x = uspmv::rows_16b_aligned<Tx>(x0, ld) &&
                     uspmv::rows_16b_aligned<Tx>(buf0, ld) &&
                     uspmv::rows_16b_aligned<Tx>(buf1, ld);
  cudaError_t err;
  switch (ncols) {
    case 1:
      if (ld == 1) {
        err = launch_variant<Tv, Tx, 1, true, true>(a, blocks, s);
      } else {
        err = launch_variant<Tv, Tx, 1, true>(a, blocks, s);
      }
      break;
    case 2:
      err = launch_variant<Tv, Tx, 2, true>(a, blocks, s);
      break;
    case 3:
      err = launch_variant<Tv, Tx, 4, false>(a, blocks, s);
      break;
    case 4:  // 16-byte loads of 4 doubles spilled (ptxas -v): scalar
      if constexpr (sizeof(Tx) == 4) {
        if (vec_x) {
          err = launch_variant<Tv, Tx, 4, true, false, true>(a, blocks, s);
          break;
        }
      }
      err = launch_variant<Tv, Tx, 4, true>(a, blocks, s);
      break;
    case 8:  // 16-byte loads spilled here (ptxas -v): scalar
      err = launch_variant<Tv, Tx, 8, true>(a, blocks, s);
      break;
    default:  // 5..7
      err = launch_variant<Tv, Tx, 8, false>(a, blocks, s);
      break;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset it, or the next launch would report it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point: k iterations for one precision stream, the arguments
// of the matrix as scs_spmv.cu's entries take them. x0, buf0 and
// buf1 are three distinct vectors of n_rows_padded rows, ld elements apart
// (bs for rowwise block vectors, else 1), ncols <= 8 columns wide.

int uspmv_scs_solve_f64_f64(int64_t n_rows_padded, int C,
                            const void* chunk_ptrs, const void* chunk_lengths,
                            const void* group_lengths, int group_length_bytes,
                            const void* col_idxs, const void* values,
                            const void* x0, void* buf0, void* buf1,
                            int64_t ld, int ncols, int k, void* stream) {
  return launch_scs_solve<double, double>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x0, buf0, buf1, ld, ncols, k,
      stream);
}

int uspmv_scs_solve_f32_f32(int64_t n_rows_padded, int C,
                            const void* chunk_ptrs, const void* chunk_lengths,
                            const void* group_lengths, int group_length_bytes,
                            const void* col_idxs, const void* values,
                            const void* x0, void* buf0, void* buf1,
                            int64_t ld, int ncols, int k, void* stream) {
  return launch_scs_solve<float, float>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x0, buf0, buf1, ld, ncols, k,
      stream);
}

int uspmv_scs_solve_bf16_f32(int64_t n_rows_padded, int C,
                             const void* chunk_ptrs,
                             const void* chunk_lengths,
                             const void* group_lengths,
                             int group_length_bytes, const void* col_idxs,
                             const void* values, const void* x0, void* buf0,
                             void* buf1, int64_t ld, int ncols, int k,
                             void* stream) {
  return launch_scs_solve<__nv_bfloat16, float>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x0, buf0, buf1, ld, ncols, k,
      stream);
}

}  // extern "C"
