// One row of a SELL-C-sigma product, shared by scs_spmv.cu (one SpMV per
// launch) and scs_solve.cu (k SpMVs in one launch). Both kernels take a
// row's sum from `scs_row_product`, so they perform the same operations in
// the same order and a fused solve equals k separate launches bit for bit.
// The unit-value loop of scs_spmv.cu and the probes of scs_probe.cu keep
// their own loops, which walk each chunk to its longest row.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uspmv {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;
// Blocks of kThreads the row-sum kernels keep resident on an SM at least
// (__launch_bounds__): caps a thread at 48 registers. The loop below trades
// registers (loads in flight per thread) against resident threads; in a
// paired run on an H100 (PERF.md) 5 blocks beat 4 and 6.
constexpr int kMinBlocksPerSm = 5;
// x values one thread holds per trip of the row loop: a trip takes
// kBatchX / BS elements of the row (4 for one vector, 1 for bs >= 4). A
// trip of 8 needed 64 registers and lost to 4 on every (values, x) pair.
constexpr int kBatchX = 4;
// Rows of a group: the row loop of the rows c*C + g*kGroupRows .. (a group
// ends at its chunk's end) stops at the longest of them, not at the
// chunk's longest row. 16 rows are one 32-byte sector of bf16 values, two
// of f32 values or int32 columns. In a paired run on an H100
// (scripts/kernel_ab.py, PERF.md) 16 took 0.4-0.6% less time than 8, and
// 32 more, summed over the padded streams of paths E and G and
// Hubbard-13/6, though 8 read fewer slots (8 was 0.1-0.9% faster on E's
// f64 stream alone). A power of two; must equal GROUP_ROWS of
// ops/device_format.py.
constexpr int kGroupRows = 16;
static_assert((kGroupRows & (kGroupRows - 1)) == 0,
              "kGroupRows must be a power of two");

// One precision stream's SCS arrays. They are never written by a kernel.
struct ScsMatrix {
  int64_t n_rows_padded;
  int C;
  const int32_t* chunk_ptrs;
  const int32_t* chunk_lengths;  // read by the unit-value loop and probes
  const int32_t* col_idxs;
  const void* values;
  // the longest row of each group of kGroupRows rows (group_length), in
  // the narrowest of uint8, int16 and int32 that holds the longest chunk,
  // group_length_bytes = 1, 2 or 4 bytes each. 0: no table, the loop stops
  // at the chunk's length (kGroupRows does not divide C, or the groups
  // skip little, ops/device_format.GROUP_SKIP_PER_ROW; the kernels' kGroups
  // false)
  const void* group_lengths;
  int group_length_bytes;
};

// The longest row of padded row r's group, at r / kGroupRows (a table is
// passed only where kGroupRows divides C, so a group never crosses a
// chunk). The index needs neither r's chunk nor its slot in it, so the
// load leaves at once, beside the division r / C that the chunk pointer
// waits for. (An index c * ceil(C / kGroupRows) + i / kGroupRows, after
// that division, cost the headline 5-10% in a paired run on an H100:
// scripts/kernel_ab.py, PERF.md.) The width is one per launch, so the
// branch is uniform.
__device__ __forceinline__ int32_t group_length(const ScsMatrix& m,
                                                int64_t r) {
  const uint64_t g = static_cast<uint64_t>(r) / kGroupRows;
  switch (m.group_length_bytes) {
    case 1:
      return __ldg(static_cast<const uint8_t*>(m.group_lengths) + g);
    case 2:
      return __ldg(static_cast<const int16_t*>(m.group_lengths) + g);
    default:
      return __ldg(static_cast<const int32_t*>(m.group_lengths) + g);
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc + a * b rounded once: what `acc += a * b` contracts to.
__device__ __forceinline__ float fma_rn(float a, float b, float acc) {
  return __fmaf_rn(a, b, acc);
}
__device__ __forceinline__ double fma_rn(double a, double b, double acc) {
  return __fma_rn(a, b, acc);
}

// A value or column of the matrix stream, read once per SpMV: the load is
// marked evict-first (ld.global.cs), so the stream, larger than L2 at the
// sizes that matter, passes through it without pushing out x.
template <typename T>
__device__ __forceinline__ T load_stream(const T* p) {
  return __ldcs(p);
}

// kReadOnlyX: x is not written during the launch, so it may be read
// through the read-only path. A kernel that writes a vector and reads
// it again after a grid-wide barrier must pass false: a read-only load
// may return the line as it was before the other blocks wrote it.
template <typename Tx, bool kReadOnlyX>
__device__ __forceinline__ Tx load_x(const Tx* p) {
  if (kReadOnlyX) {
    return __ldg(p);
  }
  return *p;
}

// The BS contiguous values of x at p, 16-byte aligned, by 16-byte loads
// (BS * sizeof(Tx) a multiple of 16); read-only loads where kReadOnlyX.
template <int BS, bool kReadOnlyX>
__device__ __forceinline__ void load_x_row16(const float* p,
                                             float (&xv)[BS]) {
  static_assert(BS % 4 == 0, "16-byte loads of whole float rows");
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int u = 0; u < BS / 4; ++u) {
    float4 w;
    if constexpr (kReadOnlyX) {
      w = __ldg(q + u);
    } else {
      w = q[u];
    }
    xv[4 * u] = w.x;
    xv[4 * u + 1] = w.y;
    xv[4 * u + 2] = w.z;
    xv[4 * u + 3] = w.w;
  }
}
template <int BS, bool kReadOnlyX>
__device__ __forceinline__ void load_x_row16(const double* p,
                                             double (&xv)[BS]) {
  static_assert(BS % 2 == 0, "16-byte loads of whole double rows");
  const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int u = 0; u < BS / 2; ++u) {
    double2 w;
    if constexpr (kReadOnlyX) {
      w = __ldg(q + u);
    } else {
      w = q[u];
    }
    xv[2 * u] = w.x;
    xv[2 * u + 1] = w.y;
  }
}

// Whether the rows of a rowwise x (x_ld elements apart, from x) all start
// on 16-byte boundaries, so that load_x_row16 may read them.
template <typename Tx>
inline bool rows_16b_aligned(const void* x, int64_t x_ld) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         (x_ld * static_cast<int64_t>(sizeof(Tx))) % 16 == 0;
}

// acc[v] = sum_{j < L} Tx(values[e]) * x[col_idxs[e]*x_ld + v],
// e = chunk_ptrs[c] + j*C + i, for padded row r = c*C + i, summed in order
// of j as acc = fma(a, x, acc) from acc = 0, L the length of r's group
// (group_length) where kGroups, else of r's chunk. BS accumulators per
// thread; kFull: ncols == BS (no column guard). kColwise: the BS values
// of a column are those of BS colwise vectors, x[col_idxs[e] + v*x_vstride]
// (x_ld is then 1 and not read), so that one pass over the matrix serves
// them all; each vector's sum is the one a launch for it alone takes,
// bit for bit (the same FMAs in the same order). kGroups is a template
// argument, not a branch on group_length_bytes, so that a stream without
// group lengths runs the code it ran before them: with both forms in one
// kernel, at the 48-register cap, the chunk form cost the headline 2-3%
// in a paired run on an H100 (scripts/kernel_ab.py, PERF.md). kVecX
// (rowwise, kFull, BS * sizeof(Tx) a multiple of 16): the rows of x lie on
// 16-byte boundaries (rows_16b_aligned), and a column's BS values load as
// 16-byte vectors, where a warp's BS scalar loads each ask for a sector
// per thread; a trip of BS 4 then takes two elements (with one it took 7%
// longer than the scalar loads on the headline's matrix, with two 2% less,
// in a paired run on an H100: PERF.md). The FMAs and their order are
// those of the scalar loads.
//
// Why the group's length: a row's slots past its own count are padding
// (value 0, column 0 as the operator's column permutation renumbers it:
// "x[0]" below), and a chunk's rows are padded to its longest. The
// slots of rows r..r+G-1 at one j are contiguous, so a loop that stops
// each group at its longest row never asks for a sector that holds only
// padding. The sum is that of the loop to the chunk's length with the
// terms fma(0, x[0], acc) left out, which leave acc as it is for finite
// x[0] (acc starts at +0 and never becomes -0): y is bit-equal to that
// loop's. For a non-finite x[0] the rows of a group whose padding is no
// longer read stay finite where 0 * x[0] made them NaN.
//
// What bounds it: a row's loads depend on each other (column, then x), and
// a thread that walks them one element at a time waits a device-memory
// round trip and then an L2 round trip per element. So the loop takes the
// row in trips of K = kBatchX / BS elements: it issues the K values and
// columns, then the K * BS x loads, then the FMAs in order of j, with the
// last trip predicated. A trip costs one round trip of each kind, whatever
// the row's length and C, and the order of the sum, hence every bit of the
// result, is that of the element-by-element loop. With these loads in
// flight the one-vector kernels run near the device-memory rate (the
// numbers are in scs_spmv.cu and PERF.md).
template <typename Tv, typename Tx, int BS, bool kFull, bool kReadOnlyX,
          bool kGroups, bool kColwise = false, bool kVecX = false>
__device__ __forceinline__ void scs_row_product(const ScsMatrix& m,
                                                const Tx* x, int64_t x_ld,
                                                int64_t r, int ncols,
                                                Tx (&acc)[BS],
                                                int64_t x_vstride = 0) {
  static_assert(!kVecX || (kFull && !kColwise),
                "16-byte x loads take whole rowwise rows");
  constexpr int K = kVecX && BS == 4 ? 2 : BS < kBatchX ? kBatchX / BS : 1;
  const int C = m.C;
  const int32_t group_len = kGroups ? group_length(m, r) : 0;
  const int64_t c = r / C;
  const int64_t i = r - c * C;
  const int32_t len = kGroups ? group_len : __ldg(m.chunk_lengths + c);
  const int64_t base = static_cast<int64_t>(__ldg(m.chunk_ptrs + c)) + i;
  const Tv* vp = static_cast<const Tv*>(m.values) + base;
  const int32_t* cp = m.col_idxs + base;
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    acc[v] = Tx(0);
  }
  for (int32_t j0 = 0; j0 < len; j0 += K) {
    Tv val[K];
    int32_t col[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < len) {
        val[k] = load_stream(vp + static_cast<int64_t>(k) * C);
        col[k] = load_stream(cp + static_cast<int64_t>(k) * C);
      }
    }
    Tx xv[K][BS];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < len) {
        if constexpr (kColwise) {
          // one pointer stepped by the stride: no offset per vector held
          const Tx* xr = x + col[k];
#pragma unroll
          for (int v = 0; v < BS; ++v) {
            if (kFull || v < ncols) {
              xv[k][v] = load_x<Tx, kReadOnlyX>(xr);
            }
            xr += x_vstride;
          }
        } else if constexpr (kVecX) {
          load_x_row16<BS, kReadOnlyX>(
              x + static_cast<int64_t>(col[k]) * x_ld, xv[k]);
        } else {
          const Tx* xr = x + static_cast<int64_t>(col[k]) * x_ld;
#pragma unroll
          for (int v = 0; v < BS; ++v) {
            if (kFull || v < ncols) {
              xv[k][v] = load_x<Tx, kReadOnlyX>(xr + v);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < len) {
        const Tx a = static_cast<Tx>(widen(val[k]));
#pragma unroll
        for (int v = 0; v < BS; ++v) {
          if (kFull || v < ncols) {
            acc[v] = fma_rn(a, xv[k][v], acc[v]);
          }
        }
      }
    }
    vp += static_cast<int64_t>(K) * C;
    cp += static_cast<int64_t>(K) * C;
  }
}

}  // namespace uspmv
