// Heavy-row pieces: y[parent] += sum of the parent's virtual rows, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU product-tile kernels of uspmv_tpu/ops/pallas_scs.py:
//   `_kernel_products`    (:960,  launched by `spmv_product_tiles`, :985)
//   `_kernel_products_t`  (:1201, launched by `spmv_product_tiles_t`, :1271)
// and the fold behind them (uspmv_tpu/runtime/operator.py:1065-1097,
// uspmv_tpu/runtime/tstream.py). On the TPU those write p = val * x[col] in
// order into a padded (column block x row chunk) grid in HBM, or stage it in
// VMEM and write it transposed, so that a regular reduction can sum the
// products without an output read-modify-write; the virtual rows of split
// heavy rows are folded into their parents by prefix sums or a scatter. Here
// the products never reach device memory.
//
// What it computes. A piece p is a virtual row of at most `threshold`
// elements (formats/coo.split_heavy_rows), stored as a CSR stream;
// parent q owns the consecutive pieces parent_ptr[q] .. parent_ptr[q+1]-1
// and lives at permuted row parent_row[q], each row at most once. For
// vector v (gridDim.y):
//   A  partials[v][p] = sum_{k in piece p} Tx(values[k]) * x[col_idxs[k]]
//   B  y[parent_row[q]] += sum_{p in parent q} partials[v][p]
//
// Design. A: one warp per piece; lane l takes elements l, l+32, ... of the
// piece (coalesced), sums them in that order, and a fixed xor-shuffle tree
// adds the 32 lanes. B: one warp per parent, the same shape over its run of
// partials. A warp per whole row would walk a 10^5-element row in 3,300
// dependent trips; pieces spread it over as many warps. Every sum has one
// fixed order and no floating-point atomic is used, so the result is the
// same bits from run to run, which the solve paths (loop, CUDA graph) rely
// on. Bound by bytes: per element the value and an int32 column, per piece
// one partial written and read, x through L2. One thread per short parent
// would do for B; fusing A and B is later work.
//
// Block vectors: gridDim.y = number of vectors; x_ld / y_ld are the element
// strides between rows and x_vstride / y_vstride between vectors (rowwise
// x[n][bs]: ld = bs, vstride = 1; colwise x[bs][n]: ld = 1, vstride = n).
// The pieces are read once per vector.
//
// Launch rules: the caller's stream, A then B, no allocation (the partial
// sums live in a buffer the caller owns), no synchronisation; the entry
// point returns cudaGetLastError() so the caller can raise.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scs_row.cuh"

namespace {

using uspmv::kThreads;
using uspmv::widen;

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kMaxGridY = 65535;

struct PiecesArgs {
  int64_t n_pieces;
  const int32_t* piece_ptr;
  const int32_t* col_idxs;
  const void* values;
  int64_t n_parents;
  const int32_t* parent_ptr;
  const int32_t* parent_row;
  const void* x;
  int64_t x_ld;
  int64_t x_vstride;
  void* partials;  // [gridDim.y][n_pieces]
  void* y;
  int64_t y_ld;
  int64_t y_vstride;
};

// The 32 lanes' values added by a butterfly: the same tree in every run,
// and every lane ends with the sum.
template <typename Tx>
__device__ __forceinline__ Tx warp_sum(Tx v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <typename Tv, typename Tx>
__global__ void __launch_bounds__(kThreads)
pieces_partial_kernel(const PiecesArgs a) {
  const int lane = threadIdx.x % kWarp;
  const int64_t piece = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        threadIdx.x / kWarp;
  if (piece >= a.n_pieces) {  // the whole warp leaves together
    return;
  }
  const Tv* __restrict__ values = static_cast<const Tv*>(a.values);
  const Tx* __restrict__ x = static_cast<const Tx*>(a.x) +
                             static_cast<int64_t>(blockIdx.y) * a.x_vstride;
  const int32_t begin = __ldg(a.piece_ptr + piece);
  const int32_t end = __ldg(a.piece_ptr + piece + 1);
  Tx acc = Tx(0);
  for (int32_t k = begin + lane; k < end; k += kWarp) {
    const Tx val = static_cast<Tx>(widen(__ldg(values + k)));
    acc += val * __ldg(x + static_cast<int64_t>(__ldg(a.col_idxs + k)) *
                               a.x_ld);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    static_cast<Tx*>(a.partials)[static_cast<int64_t>(blockIdx.y) *
                                     a.n_pieces + piece] = acc;
  }
}

template <typename Tx>
__global__ void __launch_bounds__(kThreads)
pieces_fold_kernel(const PiecesArgs a) {
  const int lane = threadIdx.x % kWarp;
  const int64_t parent = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                         threadIdx.x / kWarp;
  if (parent >= a.n_parents) {
    return;
  }
  // written by the kernel before this one: ordinary loads
  const Tx* partials = static_cast<const Tx*>(a.partials) +
                       static_cast<int64_t>(blockIdx.y) * a.n_pieces;
  const int32_t begin = __ldg(a.parent_ptr + parent);
  const int32_t end = __ldg(a.parent_ptr + parent + 1);
  Tx acc = Tx(0);
  for (int32_t p = begin + lane; p < end; p += kWarp) {
    acc += partials[p];
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    Tx* yr = static_cast<Tx*>(a.y) +
             static_cast<int64_t>(blockIdx.y) * a.y_vstride +
             static_cast<int64_t>(__ldg(a.parent_row + parent)) * a.y_ld;
    *yr += acc;  // each parent row belongs to one warp of this launch
  }
}

template <typename Tv, typename Tx>
int launch_pieces(int64_t n_pieces, const void* piece_ptr,
                  const void* col_idxs, const void* values, int64_t n_parents,
                  const void* parent_ptr, const void* parent_row,
                  const void* x, int64_t x_ld, int64_t x_vstride,
                  void* partials, void* y, int64_t y_ld, int64_t y_vstride,
                  int n_vec, void* stream) {
  if (n_pieces <= 0 || n_parents <= 0 || n_vec <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks_a = (n_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t blocks_b = (n_parents + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (n_vec > kMaxGridY || blocks_a > INT32_MAX || n_parents > n_pieces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PiecesArgs a{n_pieces,
                     static_cast<const int32_t*>(piece_ptr),
                     static_cast<const int32_t*>(col_idxs),
                     values,
                     n_parents,
                     static_cast<const int32_t*>(parent_ptr),
                     static_cast<const int32_t*>(parent_row),
                     x,
                     x_ld,
                     x_vstride,
                     partials,
                     y,
                     y_ld,
                     y_vstride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int ny = static_cast<unsigned int>(n_vec);
  pieces_partial_kernel<Tv, Tx>
      <<<dim3(static_cast<unsigned int>(blocks_a), ny), kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  pieces_fold_kernel<Tx>
      <<<dim3(static_cast<unsigned int>(blocks_b), ny), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point: y[parent rows] += the pieces' products with x, for one
// precision stream and n_vec vectors; two kernels on `stream`.
#define USPMV_PIECES_ENTRY(name, Tv, Tx)                                     \
  int name(int64_t n_pieces, const void* piece_ptr, const void* col_idxs,    \
           const void* values, int64_t n_parents, const void* parent_ptr,    \
           const void* parent_row, const void* x, int64_t x_ld,              \
           int64_t x_vstride, void* partials, void* y, int64_t y_ld,         \
           int64_t y_vstride, int n_vec, void* stream) {                     \
    return launch_pieces<Tv, Tx>(n_pieces, piece_ptr, col_idxs, values,      \
                                 n_parents, parent_ptr, parent_row, x, x_ld, \
                                 x_vstride, partials, y, y_ld, y_vstride,    \
                                 n_vec, stream);                             \
  }

extern "C" {

USPMV_PIECES_ENTRY(uspmv_scs_pieces_f64_f64, double, double)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_f32_f32, float, float)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_bf16_f32, __nv_bfloat16, float)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_f32_f64, float, double)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_bf16_f64, __nv_bfloat16, double)

}  // extern "C"
