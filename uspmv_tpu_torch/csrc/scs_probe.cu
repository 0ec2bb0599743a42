// Cost split of the SELL-C-sigma SpMV kernel for NVIDIA Hopper (sm_90a):
// variants of its row loop, each with one part of the work replaced, timed
// side by side on the same DeviceScs.
//
// Replaces the TPU probe kernel of the JAX package's
// scripts/pallas_tile_cost.py (`run`, :65; its `kernel`, :25), which times
// `_kernel` (uspmv_tpu/ops/pallas_scs.py:820) with the x window fixed
// (`fixed_w`: no meta read, no dynamic slice), the output slot fixed
// (`fixed_cl`), both, the gather replaced (`no_gather`), or all (`bare`).
// The Hopper kernel has no windows or output slots; its parts are the value
// and column stream, the x[col] gather through L1/L2 and the y store. Each
// variant computes a defined function, so it has a plain version
// (ops/scs_probe.py), for permuted row r = c*C + i, e = chunk_ptrs[c] +
// j*C + i, summed in order of j in float:
//   full      y[r] = sum_j val[e] * x[col[e]]: spmv_scs's own launch, the
//             entry uspmv_scs_spmv_f32_f32 of scs_spmv.cu (same arguments,
//             same kernel, same store), so it is the production kernel;
//   x_window  y[r] = sum_j val[e] * x[col[e] & (W-1)], W a power of two
//             <= 4,096: x stays in L1 (`fixed_w`);
//   no_store  the full sum, but y[r] is written, and the row counted, only
//             where the sum exceeds a run-time threshold (`fixed_cl`): -inf
//             stores every row, so the sums can be checked; +inf stores
//             none, and the compiler, which cannot know it, keeps the sum;
//   no_x      y[r] = sum_j val[e] * float(col[e]): no x load (`no_gather`);
//   bare      no_x and no_store together (`bare`);
//   x_row     y[r] = sum_j val[e] * x[r ^ (col[e] >> 31)], which is x[r]
//             (every column is >= 0): a coalesced load of the row's own x in
//             place of the gather, still behind the column load as the
//             gather is, so only the address pattern changes
//             (test_gather_tput.py's "copy"). A plain x[r] would let the
//             compiler drop the column stream.
// Every variant but full stores as the production kernel does, through its
// run-time accumulate select (always 0 here), so that it differs from full
// only in the part it replaces. The unit-value entry of scs_spmv.cu (no
// value stream) is timed beside them.
//
// What bounds it: the production kernel is bound by the loads a thread has
// in flight more than by its bytes (8 B per stored element of value and
// column plus x and y once), and which part holds it back is what these
// variants measure. So each variant runs the production row loop
// (scs_row.cuh's scs_row_product for one vector): the row in trips of
// kBatchX elements, values and columns first (evict-first), then the
// trip's x (or what replaces it), then the FMAs in order of j, under the
// same launch bounds, so that `full` minus a variant is the cost of one
// part of the production kernel. The variants walk each chunk to its
// longest row (chunk_lengths), the row loop as it stood when they were
// written; the production loop stops each group of kGroupRows rows at its
// own longest row where the stream takes group lengths. The headline
// takes none (its groups skip 0.45% of its slots), so there both read the
// same slots. They live in a source of their own so that the production
// kernel's code and ptxas report stay as they are. One
// thread per padded row, 256 threads a block, as in scs_spmv.cu.
//
// Launch rules: the caller's stream, no allocation, no synchronisation; the
// entry point returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "scs_row.cuh"

namespace {

using uspmv::kBatchX;
using uspmv::kMinBlocksPerSm;
using uspmv::kThreads;
using uspmv::load_stream;
using uspmv::ScsMatrix;

enum Variant : int {
  kFullSum = 0,
  kXWindow = 1,
  kNoStore = 2,
  kNoX = 3,
  kBare = 4,
  kXRow = 5,
};

template <int kVariant>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
scs_probe_kernel(const ScsMatrix m, const float* __restrict__ x,
                 int32_t x_mask, float store_above, int accumulate,
                 float* __restrict__ y, int* __restrict__ stored) {
  constexpr int K = kBatchX;  // scs_row_product's trip for one vector
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m.n_rows_padded) {
    return;
  }
  const int C = m.C;
  const int64_t c = r / C;
  const int64_t i = r - c * C;
  const int32_t len = __ldg(m.chunk_lengths + c);
  const int64_t base = static_cast<int64_t>(__ldg(m.chunk_ptrs + c)) + i;
  const float* vp = static_cast<const float*>(m.values) + base;
  const int32_t* cp = m.col_idxs + base;
  float acc = 0.0f;
  for (int32_t j0 = 0; j0 < len; j0 += K) {
    float val[K];
    int32_t col[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < len) {
        val[k] = load_stream(vp + static_cast<int64_t>(k) * C);
        col[k] = load_stream(cp + static_cast<int64_t>(k) * C);
      }
    }
    float g[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < len) {
        if constexpr (kVariant == kXWindow) {
          g[k] = __ldg(x + (col[k] & x_mask));
        } else if constexpr (kVariant == kNoX || kVariant == kBare) {
          g[k] = static_cast<float>(col[k]);
        } else if constexpr (kVariant == kXRow) {
          g[k] = __ldg(x + (r ^ static_cast<int64_t>(col[k] >> 31)));
        } else {  // kNoStore
          g[k] = __ldg(x + col[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < len) {
        acc = uspmv::fma_rn(val[k], g[k], acc);
      }
    }
    vp += static_cast<int64_t>(K) * C;
    cp += static_cast<int64_t>(K) * C;
  }
  if constexpr (kVariant == kNoStore || kVariant == kBare) {
    if (acc > store_above) {
      y[r] = accumulate ? y[r] + acc : acc;
      atomicAdd(stored, 1);
    }
  } else {
    y[r] = accumulate ? y[r] + acc : acc;
  }
}

template <int kVariant>
void launch(const ScsMatrix& m, const float* x, int32_t x_mask,
            float store_above, float* y, int* stored, unsigned int blocks,
            cudaStream_t s) {
  scs_probe_kernel<kVariant><<<blocks, kThreads, 0, s>>>(
      m, x, x_mask, store_above, 0, y, stored);
}

}  // namespace

extern "C" {

// The production entry point of scs_spmv.cu, which the full variant calls.
int uspmv_scs_spmv_f32_f32(int64_t n_rows_padded, int C,
                           const void* chunk_ptrs, const void* chunk_lengths,
                           const void* group_lengths, int group_length_bytes,
                           const void* col_idxs, const void* values,
                           const void* x, int64_t x_ld, int64_t x_vstride,
                           void* y, int64_t y_ld, int64_t y_vstride,
                           int ncols, int n_vec, int accumulate,
                           void* stream);

// One variant (0 full, 1 x_window, 2 no_store, 3 no_x, 4 bare, 5 x_row) on
// one f32 SELL-C-sigma stream and one f32 vector. x_mask = W - 1 for
// x_window; no_store and bare write y[r] and add one to *stored only where
// the row's sum exceeds store_above. group_lengths and group_length_bytes
// are read by full alone (the production kernel's arguments).
int uspmv_scs_probe(int variant, int64_t n_rows_padded, int C,
                    const void* chunk_ptrs, const void* chunk_lengths,
                    const void* group_lengths, int group_length_bytes,
                    const void* col_idxs, const void* values, const void* x,
                    int x_mask, float store_above, void* y, void* stored,
                    void* stream) {
  if (variant == kFullSum) {
    return uspmv_scs_spmv_f32_f32(n_rows_padded, C, chunk_ptrs,
                                  chunk_lengths, group_lengths,
                                  group_length_bytes, col_idxs, values, x, 1,
                                  0, y, 1, 0, 1, 1, 0, stream);
  }
  if (n_rows_padded <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks = (n_rows_padded + kThreads - 1) / kThreads;
  if (C < 1 || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScsMatrix m{n_rows_padded, C,
                    static_cast<const int32_t*>(chunk_ptrs),
                    static_cast<const int32_t*>(chunk_lengths),
                    static_cast<const int32_t*>(col_idxs), values,
                    nullptr, 0};
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  int* count = static_cast<int*>(stored);
  const unsigned int b = static_cast<unsigned int>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kXWindow:
      launch<kXWindow>(m, xf, x_mask, store_above, yf, count, b, s);
      break;
    case kNoStore:
      launch<kNoStore>(m, xf, x_mask, store_above, yf, count, b, s);
      break;
    case kNoX:
      launch<kNoX>(m, xf, x_mask, store_above, yf, count, b, s);
      break;
    case kBare:
      launch<kBare>(m, xf, x_mask, store_above, yf, count, b, s);
      break;
    case kXRow:
      launch<kXRow>(m, xf, x_mask, store_above, yf, count, b, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
