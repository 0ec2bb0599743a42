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
// consecutive groups of at most kThreads rows and GROUP_MAX_ELEMS elements
// (ops/device_format.py); group g is the record groups[g] = (row0, row1, e0,
// e1): rows row0 .. row1-1, elements e0 .. e1-1. For every row r and
// column v:
//   y[r][v] (+)= sum_k Tx(values[k]) * x[col_idxs[k]][v]
// as a rounded product followed by a sum in order of k: two roundings, not
// the FMA of scs_spmv.cu, so the result differs from that kernel in the
// last bits and agrees with the plain PyTorch version (ops/scs_packed.py)
// up to the order of its index_add_.
//
// Design: a persistent grid, as many blocks as stay resident on the card,
// each taking groups g = blockIdx.x, + gridDim.x, ... Phase a: the block's
// threads stride over the group's elements, coalesced whatever the row
// lengths, and write val * x[col] into shared memory. Phase b: thread t sums
// row t's products from shared memory in order of k and writes, or with
// `accumulate` adds into, y; a row with no elements writes 0. Block
// vectors, rowwise columns and colwise vectors alike, run one pass (a, b)
// per column or vector inside the launch; the group's values and columns
// are read again from L1/L2, so device memory sees them once for all of
// them. (The JAX operator runs colwise vectors one kernel each, jax.vmap;
// here they share the group's reads.) Each column's products and sums are
// those of a launch for it alone, in the same order.
//
// What bounds it. The columns of the matrices this tier takes are
// scattered, so each x load is an L2 sector of its own: the floor is the
// random-gather rate (x_access.cu's gather probes), not the bytes. Below
// that, latency: a group's metadata, then its columns, then x. So the
// design (1) sizes the stage to the matrix (the largest group's elements,
// as dynamic shared memory), where a stage sized for GROUP_MAX_ELEMS took
// 32 KB of doubles a block and cost dp a wave of blocks; (2) reads a group
// as one 16 B record, and the next group's record while the current one
// is summed; (3) issues kPhaseABatch values and columns per thread before
// their x loads, predicated on the group's end. The matrix goes through
// the read-only path: the evict-first hint of the SELL kernel did not help
// here in a paired run. Phase b keeps a thread per row (a row is 5
// elements on average on the imbalanced matrices, at most 32 once split),
// with shared-memory bank conflicts where rows are a multiple of 32 long.
// On an NVIDIA H100 80GB HBM3 at 700 W the packed rows of
// RandomImbalanced-500k at C=1024 take 1.18 (sp) and 1.30 (dp) times the
// gather probe's time on the same columns, and dp runs in 0.75 of
// cuSPARSE's time on the same rows (chip_smoke.py path G; PERF.md).
//
// Launch rules: the caller's stream, stage_bytes of dynamic shared memory
// (at most 48 KB; the wrapper passes max_group_elems * sizeof(Tx)), no
// allocation, no synchronisation; the entry point returns the first error
// of the occupancy query or the launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scs_row.cuh"

namespace {

using uspmv::kThreads;
using uspmv::widen;

constexpr int kMaxVectors = 65535;  // ops/scs_spmv.MAX_VECTORS
constexpr int kMaxStageBytes = 48 * 1024;

// Elements per thread whose value and column phase a loads before their x.
// A group averages 5 per thread on the imbalanced matrices. For doubles 2
// beat 4 in a paired run on an H100 (PERF.md), and for floats 8 beat
// 4 and 16.
template <typename Tx>
constexpr int kPhaseABatch = sizeof(Tx) == 8 ? 2 : 8;

struct PackedArgs {
  const int4* groups;  // (row0, row1, e0, e1) per group
  int n_groups;
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
  int n_vec;  // colwise vectors
};

// kColwise: the passes are those of n_vec colwise vectors, x[col +
// v*x_vstride] (x_ld, y_ld and ncols 1), else of ncols rowwise columns.
template <typename Tv, typename Tx, bool kColwise>
__global__ void __launch_bounds__(kThreads)
scs_packed_kernel(const PackedArgs a) {
  constexpr int B = kPhaseABatch<Tx>;
  extern __shared__ __align__(16) unsigned char stage_raw[];
  Tx* stage = reinterpret_cast<Tx*>(stage_raw);
  const Tv* __restrict__ values = static_cast<const Tv*>(a.values);
  // gridDim.y is 1; the offsets stay so that the one-vector and rowwise
  // kernel keeps its instructions (PERF.md: parent against change in
  // cuobjdump, and its times in turns)
  const Tx* __restrict__ x = static_cast<const Tx*>(a.x) +
                             static_cast<int64_t>(blockIdx.y) * a.x_vstride;
  Tx* __restrict__ y =
      static_cast<Tx*>(a.y) + static_cast<int64_t>(blockIdx.y) * a.y_vstride;
  const int t = static_cast<int>(threadIdx.x);
  int g = static_cast<int>(blockIdx.x);
  if (g >= a.n_groups) {
    return;
  }
  int4 next = __ldg(a.groups + g);
  for (; g < a.n_groups; g += gridDim.x) {
    const int4 grp = next;  // (row0, row1, e0, e1)
    const int32_t r = grp.x + t;
    const bool has_row = r < grp.y;
    int32_t begin = 0;
    int32_t end = 0;
    if (has_row) {  // needed in phase b only: in flight during phase a
      begin = __ldg(a.row_ptr + r) - grp.z;
      end = __ldg(a.row_ptr + r + 1) - grp.z;
    }
    const int g_next = g + static_cast<int>(gridDim.x);
    const int n_pass = kColwise ? a.n_vec : a.ncols;
    for (int v = 0; v < n_pass; ++v) {
      const Tx* __restrict__ xs = x + static_cast<int64_t>(v) * a.x_vstride;
      for (int32_t k0 = grp.z + t; k0 < grp.w; k0 += B * kThreads) {
        Tv val[B];
        int32_t col[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int32_t k = k0 + b * kThreads;
          if (k < grp.w) {
            val[b] = __ldg(values + k);
            col[b] = __ldg(a.col_idxs + k);
          }
        }
        Tx xv[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if (k0 + b * kThreads < grp.w) {
            if constexpr (kColwise) {
              xv[b] = __ldg(xs + col[b]);
            } else {
              xv[b] = __ldg(x + static_cast<int64_t>(col[b]) * a.x_ld + v);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int32_t k = k0 + b * kThreads;
          if (k < grp.w) {
            stage[k - grp.z] = static_cast<Tx>(widen(val[b])) * xv[b];
          }
        }
      }
      __syncthreads();
      if (v + 1 == n_pass && g_next < a.n_groups) {
        next = __ldg(a.groups + g_next);  // arrives while phase b sums
      }
      if (has_row) {
        Tx acc = Tx(0);
        for (int32_t k = begin; k < end; ++k) {
          acc += stage[k];
        }
        Tx* yr = kColwise
                     ? y + static_cast<int64_t>(v) * a.y_vstride + r
                     : y + static_cast<int64_t>(r) * a.y_ld + v;
        *yr = a.accumulate ? *yr + acc : acc;
      }
      __syncthreads();  // the next pass or group overwrites the stage
    }
  }
}

// The persistent grid of one instantiation: blocks resident per SM at
// stage_bytes (per_sm), and the blocks of a launch (blocks): all resident
// blocks, at most one per group. n_vec > 1: the colwise instantiation.
template <typename Tv, typename Tx>
cudaError_t packed_grid(int64_t n_groups, int n_vec, int stage_bytes,
                        int* per_sm, int64_t* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  int n_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = n_vec > 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          per_sm, scs_packed_kernel<Tv, Tx, true>, kThreads,
                          stage_bytes)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          per_sm, scs_packed_kernel<Tv, Tx, false>, kThreads,
                          stage_bytes);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset it, or the next launch would report it
    return err;
  }
  if (*per_sm < 1) {
    return cudaErrorLaunchOutOfResources;
  }
  const int64_t b = static_cast<int64_t>(*per_sm) * n_sm;
  *blocks = b < n_groups ? b : n_groups;
  return cudaSuccess;
}

template <typename Tv, typename Tx>
int launch_packed(int64_t n_groups, const void* groups, const void* row_ptr,
                  const void* col_idxs, const void* values, const void* x,
                  int64_t x_ld, int64_t x_vstride, void* y, int64_t y_ld,
                  int64_t y_vstride, int ncols, int n_vec, int accumulate,
                  int stage_bytes, void* stream) {
  if (n_groups <= 0 || n_vec <= 0 || ncols <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n_vec > kMaxVectors || n_groups > INT32_MAX || stage_bytes < 0 ||
      (n_vec > 1 && (ncols != 1 || x_ld != 1 || y_ld != 1)) ||
      stage_bytes > kMaxStageBytes ||
      stage_bytes % static_cast<int>(sizeof(Tx)) != 0 ||
      reinterpret_cast<uintptr_t>(groups) % alignof(int4) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int per_sm = 0;
  int64_t blocks = 0;
  const cudaError_t err =
      packed_grid<Tv, Tx>(n_groups, n_vec, stage_bytes, &per_sm, &blocks);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const PackedArgs a{static_cast<const int4*>(groups),
                     static_cast<int>(n_groups),
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
                     accumulate,
                     n_vec};
  const dim3 grid(static_cast<unsigned int>(blocks), 1u);
  const size_t smem = static_cast<size_t>(stage_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_vec > 1) {
    scs_packed_kernel<Tv, Tx, true><<<grid, kThreads, smem, s>>>(a);
  } else {
    scs_packed_kernel<Tv, Tx, false><<<grid, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point: y (+)= A x for one precision stream. groups holds
// n_groups int4 records (row0, row1, e0, e1), 16-byte aligned; each group
// holds at most kThreads (256) rows and stage_bytes / sizeof(Tx) elements
// (ops/device_format.build_device_packed and ops/scs_packed.stage_bytes
// see to it).
#define USPMV_PACKED_ENTRY(name, Tv, Tx)                                     \
  int name(int64_t n_groups, const void* groups, const void* row_ptr,        \
           const void* col_idxs, const void* values, const void* x,          \
           int64_t x_ld, int64_t x_vstride, void* y, int64_t y_ld,           \
           int64_t y_vstride, int ncols, int n_vec, int accumulate,          \
           int stage_bytes, void* stream) {                                  \
    return launch_packed<Tv, Tx>(n_groups, groups, row_ptr, col_idxs,        \
                                 values, x, x_ld, x_vstride, y, y_ld,        \
                                 y_vstride, ncols, n_vec, accumulate,        \
                                 stage_bytes, stream);                       \
  }                                                                          \
  int name##_grid(int64_t n_groups, int n_vec, int stage_bytes, int* per_sm, \
                  int64_t* blocks) {                                         \
    return static_cast<int>(packed_grid<Tv, Tx>(n_groups, n_vec,             \
                                                stage_bytes, per_sm,         \
                                                blocks));                    \
  }

extern "C" {

// name: the launch; name_grid: the grid that launch would take (per_sm
// resident blocks per SM, blocks along x), for a report of the launch.
USPMV_PACKED_ENTRY(uspmv_scs_packed_f64_f64, double, double)
USPMV_PACKED_ENTRY(uspmv_scs_packed_f32_f32, float, float)
USPMV_PACKED_ENTRY(uspmv_scs_packed_bf16_f32, __nv_bfloat16, float)

}  // extern "C"
