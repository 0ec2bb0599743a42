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
//   acc[v] = sum_{j < L} Tx(values[e]) * x[col_idxs[e]][v],
//            e = chunk_ptrs[c] + j*C + i, L = the longest row of r's group
//            of kGroupRows rows (group_lengths, scs_row.cuh), or of r's
//            chunk (chunk_lengths[c]) where no group lengths are passed,
//   y[r][v] = acc[v]             (accumulate == 0)
//   y[r][v] = y[r][v] + acc[v]   (accumulate != 0: the adaptive-precision
//                                 sum y = y_p0 + y_p1 + ..., in the order of
//                                 the JAX operator's closure)
// summed in order of j in the accumulator type Tx. Each step is one FMA,
// acc = fma(a, x, acc), so results differ from the plain PyTorch version
// (ops/scs_spmv.py) in the last bits only. Padding slots below L add
// 0 * x[0], as the plain version's do; those past L are not read, so a
// non-finite x[0] leaves more rows finite than in the plain version.
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
// (scs_ones_row_sum), batched as scs_row.cuh's is, since the solve kernel,
// which shares scs_row.cuh, has no unit form. That loop walks each chunk to
// its longest row (chunk_lengths) as before: the group lengths of
// scs_row.cuh are not applied to it.
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
//   * colwise x[bs][n_pad] (x_vstride / y_vstride between the vectors,
//     n_pad or more for a view): the same, BS vectors per thread in place
//     of BS columns, so one launch reads each matrix element once for up
//     to 8 vectors; gridDim.y counts passes of 8 vectors (bs > 8). The JAX
//     operator runs one kernel per vector (jax.vmap) because a TPU kernel
//     keeps one right-hand side in VMEM; here a thread holds the vectors'
//     accumulators in registers as the rowwise form holds its columns.
//     Each vector's sum takes the FMAs of a launch for it alone, in the
//     same order, so y equals bs one-vector launches bit for bit.
//
// Design: one thread per padded row. Elements are column-major within a
// chunk, so the threads of a chunk read consecutive values and col_idxs at
// each j and the loads coalesce for any C >= 32; C = 1 (CRS) is correct but
// uncoalesced. Per stored element the kernel moves 12 B for f64 values, 8 B
// for f32, 6 B for bf16 (value + int32 column), plus x once through L2 and
// y once (twice when accumulating). A row's column must arrive before its
// x can be asked for, so a thread that walks a row element by element waits
// two round trips per element, and that latency, not the bytes, bounded
// the first design. The row loop (scs_row.cuh) therefore takes a row in
// trips of kBatchX / BS elements, all values and columns of a trip first,
// then all their x, then the FMAs in order of j; a row of Laplace3D's 7
// elements is two trips. On a padded stream each group of kGroupRows rows
// stops at its own longest row, so the sectors that hold only padding are
// not fetched (one byte or two of group length per 16 rows); a stream whose
// groups skip little (the headline) passes no lengths and stops at each
// chunk's, as the group lengths' load costs short rows more than it saves.
// The matrix stream is read evict-first (ld.global.cs) so that x stays in the 50 MB L2 while a 117 MB stream
// passes through it, and __launch_bounds__ keeps kMinBlocksPerSm blocks
// resident. The unit-value form batches its column loads the same way.
// What bounds it now is the bytes: on an NVIDIA H100 80GB HBM3 at 700 W
// the headline (Laplace3D-128, C=1024, sigma=1, sp) takes 0.0454 ms, 88% of
// its byte bound and 0.68 of cuSPARSE's time (chip_smoke.py; PERF.md).
// SpMMV with 8 rowwise columns stays at half its bound: a trip there is
// one element with 8 x loads; 8 colwise vectors are the same trip with the
// 8 loads in 8 vectors.
//
// Launch rules: the caller's stream, no allocation, no synchronisation. Each
// entry point returns cudaGetLastError() so the caller can raise when a
// launch is refused.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scs_row.cuh"

namespace {

using uspmv::kBatchX;
using uspmv::kMaxCols;
using uspmv::kMinBlocksPerSm;
using uspmv::kThreads;
using uspmv::load_stream;
using uspmv::ScsMatrix;

constexpr int kMaxGridY = 65535;

// One launch: a precision stream's SCS arrays, x and y with their strides.
struct ScsArgs {
  ScsMatrix m;
  const void* x;
  int64_t x_ld;       // elements between the rows of x (bs rowwise, else 1)
  int64_t x_vstride;  // elements between colwise vectors
  void* y;
  int64_t y_ld;
  int64_t y_vstride;
  int ncols;  // rowwise columns of this launch, <= kMaxCols
  int accumulate;
  int n_vec;  // colwise vectors of this launch
};

// BS accumulators per thread; kFull: ncols == BS (no column guard);
// kUnit: one vector with unit strides (x_ld == y_ld == 1), the plain SpMV;
// kGroups: each row stops at its group's length (group_length_bytes != 0),
// else at its chunk's; kColwise: the accumulators are those of BS colwise
// vectors, blockIdx.y * BS .. of n_vec (kFull: every pass holds BS);
// kVecX: rowwise rows of x on 16-byte boundaries, read by 16-byte loads.
template <typename Tv, typename Tx, int BS, bool kFull, bool kUnit,
          bool kGroups, bool kColwise = false, bool kVecX = false>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
scs_spmv_kernel(const ScsArgs a) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.m.n_rows_padded) {
    return;
  }
  if constexpr (kColwise) {
    const int v0 = static_cast<int>(blockIdx.y) * BS;
    const int nv = kFull ? BS : min(BS, a.n_vec - v0);
    const Tx* __restrict__ x =
        static_cast<const Tx*>(a.x) + static_cast<int64_t>(v0) * a.x_vstride;
    Tx* __restrict__ y =
        static_cast<Tx*>(a.y) + static_cast<int64_t>(v0) * a.y_vstride;
    Tx acc[BS];
    uspmv::scs_row_product<Tv, Tx, BS, kFull, true, kGroups, true>(
        a.m, x, 1, r, nv, acc, a.x_vstride);
    Tx* yr = y + r;
#pragma unroll
    for (int v = 0; v < BS; ++v) {
      if (kFull || v < nv) {
        *yr = a.accumulate ? *yr + acc[v] : acc[v];
      }
      yr += a.y_vstride;
    }
    return;
  }
  // gridDim.y is 1 here; the offset stays so that the one-vector and
  // rowwise kernels keep their instructions (PERF.md: parent against
  // change in cuobjdump, and their times in turns)
  const Tx* __restrict__ x = static_cast<const Tx*>(a.x) +
                             static_cast<int64_t>(blockIdx.y) * a.x_vstride;
  Tx* __restrict__ y =
      static_cast<Tx*>(a.y) + static_cast<int64_t>(blockIdx.y) * a.y_vstride;
  const int64_t x_ld = kUnit ? 1 : a.x_ld;
  const int64_t y_ld = kUnit ? 1 : a.y_ld;
  Tx acc[BS];
  uspmv::scs_row_product<Tv, Tx, BS, kFull, true, kGroups, false, kVecX>(
      a.m, x, x_ld, r, a.ncols, acc);
  Tx* yr = y + r * y_ld;
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    if (kFull || v < a.ncols) {
      yr[v] = a.accumulate ? yr[v] + acc[v] : acc[v];
    }
  }
}

// The row sum of an all-ones matrix: acc[v] = sum of x[col*x_ld + v] over
// the slots of row r whose column is >= 0 (-1 marks padding), in order of
// j, in trips of kBatchX / BS columns as scs_row_product takes them;
// kColwise: of x[col + v*x_vstride], BS colwise vectors.
template <int BS, bool kFull, bool kColwise = false>
__device__ __forceinline__ void scs_ones_row_sum(const ScsMatrix& m,
                                                 const float* x, int64_t x_ld,
                                                 int64_t r, int ncols,
                                                 float (&acc)[BS],
                                                 int64_t x_vstride = 0) {
  constexpr int K = BS < kBatchX ? kBatchX / BS : 1;
  const int C = m.C;
  const int64_t c = r / C;
  const int64_t i = r - c * C;
  const int32_t len = __ldg(m.chunk_lengths + c);
  const int32_t* cp = m.col_idxs + static_cast<int64_t>(
      __ldg(m.chunk_ptrs + c)) + i;
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    acc[v] = 0.0f;
  }
  for (int32_t j0 = 0; j0 < len; j0 += K) {
    int32_t col[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      col[k] = j0 + k < len ? load_stream(cp + static_cast<int64_t>(k) * C)
                            : -1;
    }
    float xv[K][BS];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (col[k] >= 0) {
        if constexpr (kColwise) {
          const float* xr = x + col[k];
#pragma unroll
          for (int v = 0; v < BS; ++v) {
            if (kFull || v < ncols) {
              xv[k][v] = __ldg(xr);
            }
            xr += x_vstride;
          }
        } else {
          const float* xr = x + static_cast<int64_t>(col[k]) * x_ld;
#pragma unroll
          for (int v = 0; v < BS; ++v) {
            if (kFull || v < ncols) {
              xv[k][v] = __ldg(xr + v);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (col[k] >= 0) {
#pragma unroll
        for (int v = 0; v < BS; ++v) {
          if (kFull || v < ncols) {
            acc[v] += xv[k][v];
          }
        }
      }
    }
    cp += static_cast<int64_t>(K) * C;
  }
}

// The unit-value form of scs_spmv_kernel (float x and y; m.values unread).
// kOnesStride1: one vector with unit strides; kColwise as there.
template <int BS, bool kFull, bool kOnesStride1, bool kColwise = false>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
scs_ones_kernel(const ScsArgs a) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.m.n_rows_padded) {
    return;
  }
  if constexpr (kColwise) {
    const int v0 = static_cast<int>(blockIdx.y) * BS;
    const int nv = kFull ? BS : min(BS, a.n_vec - v0);
    const float* __restrict__ x = static_cast<const float*>(a.x) +
                                  static_cast<int64_t>(v0) * a.x_vstride;
    float* __restrict__ y =
        static_cast<float*>(a.y) + static_cast<int64_t>(v0) * a.y_vstride;
    float acc[BS];
    scs_ones_row_sum<BS, kFull, true>(a.m, x, 1, r, nv, acc, a.x_vstride);
    float* yr = y + r;
#pragma unroll
    for (int v = 0; v < BS; ++v) {
      if (kFull || v < nv) {
        *yr = a.accumulate ? *yr + acc[v] : acc[v];
      }
      yr += a.y_vstride;
    }
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

// kOnes: the unit-value kernel (Tv and Tx are then float and unused; it
// has no kVecX form)
template <typename Tv, typename Tx, bool kOnes, int BS, bool kFull,
          bool kUnit = false, bool kColwise = false, bool kVecX = false>
void launch_variant(const ScsArgs& a, dim3 grid, cudaStream_t stream) {
  if constexpr (kOnes) {
    scs_ones_kernel<BS, kFull, kUnit, kColwise>
        <<<grid, kThreads, 0, stream>>>(a);
  } else if (a.m.group_length_bytes != 0) {
    scs_spmv_kernel<Tv, Tx, BS, kFull, kUnit, true, kColwise, kVecX>
        <<<grid, kThreads, 0, stream>>>(a);
  } else {
    scs_spmv_kernel<Tv, Tx, BS, kFull, kUnit, false, kColwise, kVecX>
        <<<grid, kThreads, 0, stream>>>(a);
  }
}

// Rowwise, BS 4 and 8 with every column: by 16-byte loads of x where its
// rows lie on 16-byte boundaries, else scalar. Not the unit-value kernel,
// nor 8 double columns: under the 48-register cap their four 16-byte loads
// spilled where the scalar form does not (ptxas -v on sm_90a).
template <typename Tv, typename Tx, bool kOnes, int BS>
void launch_rowwise_full(const ScsArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr bool kVec = !kOnes && BS * sizeof(Tx) <= 32;
  if (kVec && uspmv::rows_16b_aligned<Tx>(a.x, a.x_ld)) {
    launch_variant<Tv, Tx, kOnes, BS, true, false, false, kVec>(a, grid,
                                                                stream);
  } else {
    launch_variant<Tv, Tx, kOnes, BS, true>(a, grid, stream);
  }
}

// Colwise: BS vectors per thread, the accumulators of up to kMaxCols;
// n_vec > kMaxCols runs passes of kMaxCols (gridDim.y), the last one
// guarded unless kMaxCols divides n_vec.
template <typename Tv, typename Tx, bool kOnes>
void launch_colwise(const ScsArgs& a, int64_t blocks, cudaStream_t s) {
  const int passes = (a.n_vec + kMaxCols - 1) / kMaxCols;
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(passes));
  switch (a.n_vec) {
    case 2:
      launch_variant<Tv, Tx, kOnes, 2, true, false, true>(a, grid, s);
      break;
    case 3:
      launch_variant<Tv, Tx, kOnes, 4, false, false, true>(a, grid, s);
      break;
    case 4:
      launch_variant<Tv, Tx, kOnes, 4, true, false, true>(a, grid, s);
      break;
    default:  // 5 and more
      if (a.n_vec % kMaxCols == 0) {
        launch_variant<Tv, Tx, kOnes, kMaxCols, true, false, true>(a, grid,
                                                                   s);
      } else {
        launch_variant<Tv, Tx, kOnes, kMaxCols, false, false, true>(a, grid,
                                                                    s);
      }
      break;
  }
}

template <typename Tv, typename Tx, bool kOnes = false>
int launch_scs_spmv(int64_t n_rows_padded, int C, const void* chunk_ptrs,
                    const void* chunk_lengths, const void* group_lengths,
                    int group_length_bytes, const void* col_idxs,
                    const void* values, const void* x, int64_t x_ld,
                    int64_t x_vstride, void* y, int64_t y_ld,
                    int64_t y_vstride, int ncols, int n_vec, int accumulate,
                    void* stream) {
  if (n_rows_padded <= 0 || n_vec <= 0 || ncols <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  // several colwise vectors are one vector's columns each: unit row
  // strides, one column
  if (C < 1 || ncols > kMaxCols ||
      (static_cast<int64_t>(n_vec) + kMaxCols - 1) / kMaxCols > kMaxGridY ||
      (n_vec > 1 && (ncols != 1 || x_ld != 1 || y_ld != 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!kOnes && (group_length_bytes < 0 || group_length_bytes == 3 ||
                 group_length_bytes > 4 ||
                 (group_length_bytes != 0 && group_lengths == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rows_padded + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScsArgs a{{n_rows_padded, C,
                   static_cast<const int32_t*>(chunk_ptrs),
                   static_cast<const int32_t*>(chunk_lengths),
                   static_cast<const int32_t*>(col_idxs), values,
                   group_lengths, group_length_bytes},
                  x,
                  x_ld,
                  x_vstride,
                  y,
                  y_ld,
                  y_vstride,
                  ncols,
                  accumulate,
                  n_vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_vec > 1) {
    launch_colwise<Tv, Tx, kOnes>(a, blocks, s);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned int>(blocks), 1u);
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
      launch_rowwise_full<Tv, Tx, kOnes, 4>(a, grid, s);
      break;
    case 8:
      launch_rowwise_full<Tv, Tx, kOnes, 8>(a, grid, s);
      break;
    default:  // 5..7
      launch_variant<Tv, Tx, kOnes, 8, false>(a, grid, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of kThreads of one instantiation that stay resident on an SM, for
// a report of the launch: the one-vector kernel (BS 1, unit strides), or
// with colwise the kernel of 8 colwise vectors (BS 8, every pass full); the
// form with group lengths where groups != 0, else the chunk form
// (launch_variant's choice; the unit-value kernel has one form).
template <typename Tv, typename Tx, bool kOnes, bool kColwise>
cudaError_t occupancy(int* per_sm, int groups) {
  constexpr int BS = kColwise ? kMaxCols : 1;
  constexpr bool kUnit = !kColwise;
  if constexpr (kOnes) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, scs_ones_kernel<BS, true, kUnit, kColwise>, kThreads, 0);
  } else if (groups != 0) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, scs_spmv_kernel<Tv, Tx, BS, true, kUnit, true, kColwise>,
        kThreads, 0);
  } else {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, scs_spmv_kernel<Tv, Tx, BS, true, kUnit, false, kColwise>,
        kThreads, 0);
  }
}

template <typename Tv, typename Tx, bool kOnes = false>
int blocks_per_sm(int* per_sm, int groups, int colwise) {
  const cudaError_t err =
      colwise ? occupancy<Tv, Tx, kOnes, true>(per_sm, groups)
              : occupancy<Tv, Tx, kOnes, false>(per_sm, groups);
  if (err != cudaSuccess) {
    cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

#define USPMV_BLOCKS_PER_SM(name, ...)                             \
  int name##_blocks_per_sm(int* per_sm, int groups, int colwise) { \
    return blocks_per_sm<__VA_ARGS__>(per_sm, groups, colwise);    \
  }

extern "C" {

// <entry>_blocks_per_sm: resident blocks per SM of the entry's one-vector
// kernel, or with colwise != 0 of its kernel of 8 colwise vectors, with
// group lengths where groups != 0; the grid is ceil(n_rows_padded / 256)
// blocks by ceil(n_vec / 8) passes.
USPMV_BLOCKS_PER_SM(uspmv_scs_spmv_f64_f64, double, double)
USPMV_BLOCKS_PER_SM(uspmv_scs_spmv_f32_f32, float, float)
USPMV_BLOCKS_PER_SM(uspmv_scs_spmv_bf16_f32, __nv_bfloat16, float)
USPMV_BLOCKS_PER_SM(uspmv_scs_spmv_f32_f64, float, double)
USPMV_BLOCKS_PER_SM(uspmv_scs_spmv_bf16_f64, __nv_bfloat16, double)
USPMV_BLOCKS_PER_SM(uspmv_scs_spmv_unit_f32, float, float, true)

// Every entry point: y (+)= A x for one precision stream. group_lengths
// holds the longest row of each group of kGroupRows rows in
// group_length_bytes (1, 2 or 4) bytes each, or is not read
// (group_length_bytes 0: each chunk's length bounds the loop). x_ld / y_ld are
// the element strides between rows (bs for rowwise block vectors, else 1),
// x_vstride / y_vstride the strides between the n_vec vectors of a colwise
// block, ncols <= 8 the rowwise columns of this pass. n_vec > 1 takes
// x_ld == y_ld == 1 and ncols == 1, and reads the matrix once per 8
// vectors.

int uspmv_scs_spmv_f64_f64(int64_t n_rows_padded, int C,
                           const void* chunk_ptrs, const void* chunk_lengths,
                           const void* group_lengths, int group_length_bytes,
                           const void* col_idxs, const void* values,
                           const void* x, int64_t x_ld, int64_t x_vstride,
                           void* y, int64_t y_ld, int64_t y_vstride,
                           int ncols, int n_vec, int accumulate,
                           void* stream) {
  return launch_scs_spmv<double, double>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x, x_ld, x_vstride, y, y_ld,
      y_vstride, ncols, n_vec, accumulate, stream);
}

int uspmv_scs_spmv_f32_f32(int64_t n_rows_padded, int C,
                           const void* chunk_ptrs, const void* chunk_lengths,
                           const void* group_lengths, int group_length_bytes,
                           const void* col_idxs, const void* values,
                           const void* x, int64_t x_ld, int64_t x_vstride,
                           void* y, int64_t y_ld, int64_t y_vstride,
                           int ncols, int n_vec, int accumulate,
                           void* stream) {
  return launch_scs_spmv<float, float>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x, x_ld, x_vstride, y, y_ld,
      y_vstride, ncols, n_vec, accumulate, stream);
}

int uspmv_scs_spmv_bf16_f32(int64_t n_rows_padded, int C,
                            const void* chunk_ptrs, const void* chunk_lengths,
                            const void* group_lengths, int group_length_bytes,
                            const void* col_idxs, const void* values,
                            const void* x, int64_t x_ld, int64_t x_vstride,
                            void* y, int64_t y_ld, int64_t y_vstride,
                            int ncols, int n_vec, int accumulate,
                            void* stream) {
  return launch_scs_spmv<__nv_bfloat16, float>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x, x_ld, x_vstride, y, y_ld,
      y_vstride, ncols, n_vec, accumulate, stream);
}

int uspmv_scs_spmv_f32_f64(int64_t n_rows_padded, int C,
                           const void* chunk_ptrs, const void* chunk_lengths,
                           const void* group_lengths, int group_length_bytes,
                           const void* col_idxs, const void* values,
                           const void* x, int64_t x_ld, int64_t x_vstride,
                           void* y, int64_t y_ld, int64_t y_vstride,
                           int ncols, int n_vec, int accumulate,
                           void* stream) {
  return launch_scs_spmv<float, double>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x, x_ld, x_vstride, y, y_ld,
      y_vstride, ncols, n_vec, accumulate, stream);
}

int uspmv_scs_spmv_bf16_f64(int64_t n_rows_padded, int C,
                            const void* chunk_ptrs, const void* chunk_lengths,
                            const void* group_lengths, int group_length_bytes,
                            const void* col_idxs, const void* values,
                            const void* x, int64_t x_ld, int64_t x_vstride,
                            void* y, int64_t y_ld, int64_t y_vstride,
                            int ncols, int n_vec, int accumulate,
                            void* stream) {
  return launch_scs_spmv<__nv_bfloat16, double>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x, x_ld, x_vstride, y, y_ld,
      y_vstride, ncols, n_vec, accumulate, stream);
}

// y (+)= A x for an all-ones matrix built with unit_values: the arguments
// of the entries above, float x and y; values, group_lengths and
// group_length_bytes are not read (may be null and 0).
int uspmv_scs_spmv_unit_f32(int64_t n_rows_padded, int C,
                            const void* chunk_ptrs, const void* chunk_lengths,
                            const void* group_lengths, int group_length_bytes,
                            const void* col_idxs, const void* values,
                            const void* x, int64_t x_ld, int64_t x_vstride,
                            void* y, int64_t y_ld, int64_t y_vstride,
                            int ncols, int n_vec, int accumulate,
                            void* stream) {
  return launch_scs_spmv<float, float, true>(
      n_rows_padded, C, chunk_ptrs, chunk_lengths, group_lengths,
      group_length_bytes, col_idxs, values, x, x_ld, x_vstride, y, y_ld,
      y_vstride, ncols, n_vec, accumulate, stream);
}

const char* uspmv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
