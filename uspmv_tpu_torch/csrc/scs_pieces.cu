// Heavy-row pieces: y[parent] += sum of the parent's virtual rows, in one
// kernel for NVIDIA Hopper (sm_90a).
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
// the products never reach device memory, and the sums of all but the
// long parents' pieces never do either.
//
// What it computes. A piece p is a virtual row of at most `threshold`
// elements (formats/coo.split_heavy_rows), stored as a CSR stream
// (piece_ptr); parent q owns the consecutive pieces parent_ptr[q] ..
// parent_ptr[q+1]-1 and lives at permuted row parent_row[q] of y, each row
// at most once. For vector v (gridDim.y):
//   s(p) = sum_{k in piece p} Tx(values[k]) * x[col_idxs[k]]
//   y[parent_row[q]] += sum_{p in parent q} s(p)
// Every sum has one fixed order: lane l of a warp takes a piece's elements
// l, l+32, ... (one FMA each, from 0), then an xor butterfly adds the 32
// lanes. A short parent (at most 8 pieces) sums its pieces as 0 + s_j in
// lane j, then the butterfly. A long parent does that for each run of 8
// pieces (a record), and sums its records' sums the same way, record k in
// lane k mod 32 in order of k. Every lane of a butterfly ends with the
// same bits (a + b = b + a), so the result does not depend on which warp
// or lane runs what: y is the same bits from run to run and after any
// graph replay, which the solve paths (loop, CUDA graph) rely on. No
// floating-point atomic is used.
//
// Work records (ops/device_format.piece_records), int4 (first piece, end
// piece, first parent, kind), at most kBatch (8) pieces each, one warp
// each:
//   kind -P: P consecutive parents of at most 8 pieces, whole; the warp
//     sums their pieces and folds each parent in registers, then writes
//     its row of y;
//   kind l >= 0: 8 pieces of a long parent l (more than 8 pieces); the
//     warp folds their sums into the record's sum, writes it to the
//     record's slot and counts the record on the parent's int32 counter;
//     the warp that counts the parent's last record reads the slots back,
//     folds them and writes y, then clears the slots and the counter, so
//     the next launch or graph replay starts clean. longs[l] = (first slot,
//     first piece, pieces, records).
// Long parents' records come first, the largest parent's first, so their
// folds run while the rest is summed.
//
// No fence. A __threadfence() costs more than the sums it guards (on sm_90
// it is MEMBAR.SC with an L1 invalidation; a release atomic is MEMBAR.ALL
// too), so a partial carries its own proof of arrival: a slot is 64-bit
// words (one for a float sum, two for a double), each 32 bits of the sum
// and a tag 1 above them, written by one store each, which is
// single-copy atomic. The counter is a relaxed atomicAdd. The warp that
// counts last knows every other record has stored its slots, though not
// that the stores are visible yet: it loads each slot through L2 until
// its tag reads 1, and so reads the sum that was stored with it.
//
// What bounds it: latency, then the random gather of x. A piece is the
// chain piece_ptr -> column -> x -> butterfly, and a warp that walks one
// piece (one element per lane at the automatic threshold of 32) has
// nothing to overlap with it. Here 8 pieces share a warp, 4 lanes each, so
// a thread issues 8 value and column loads, then 8 x loads; short parents
// are packed so that the 8 slots fill where most parents have 1-3 pieces;
// the next record's bounds and parents load while one is summed (a
// persistent grid, warps striding over the records). The call is one
// kernel, one node of a CUDA graph. The floor under it is the random
// gather of x at the pieces' columns (x_access.cu's probes, chip_smoke.py
// path G). Bytes moved per vector: the CSR stream, the parents' runs and
// rows, the records, and the long records' slots written, read and
// cleared once.
//
// Block vectors: gridDim.y = number of vectors; x_ld / y_ld are the element
// strides between rows and x_vstride / y_vstride between vectors (rowwise
// x[n][bs]: ld = bs, vstride = 1; colwise x[bs][n]: ld = 1, vstride = n).
// The pieces are read once per vector; slots and counters are per vector.
//
// Launch rules: the caller's stream, one kernel, no allocation (slots and
// counters live in buffers the caller owns, zero before the first launch
// and after each), no synchronisation; the entry point returns
// the first error of the occupancy query or the launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scs_row.cuh"

namespace {

using uspmv::fma_rn;
using uspmv::kThreads;
using uspmv::widen;

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kMaxGridY = 65535;
constexpr unsigned int kFull = 0xffffffffu;
// Pieces of a record (RECORD_PIECES of ops/device_format.py), summed side
// by side by groups of kGroup lanes, each thread kVirt loads in flight.
constexpr int kBatch = 8;
constexpr int kGroup = kWarp / kBatch;
constexpr int kVirt = kWarp / kGroup;
// Words of slots per lane the last-counting warp loads before it adds
// them: 16 float sums or 8 double sums (in a paired run on an H100, 16
// double sums held more registers and took longer).
constexpr int kFoldWords = 16;
using Word = unsigned long long;
constexpr Word kTag = Word{1} << 32;

struct PiecesArgs {
  const int4* records;  // (first piece, end piece, first parent, kind)
  int64_t n_records;
  const int4* longs;  // (first slot, first piece, pieces, records)
  int64_t n_long;
  const int32_t* piece_ptr;
  const int32_t* parent_ptr;
  const int32_t* parent_row;
  const int32_t* col_idxs;
  const void* values;
  const void* x;
  int64_t x_ld;
  int64_t x_vstride;
  Word* slots;  // [gridDim.y][n_slot_words]
  int64_t n_slot_words;
  int32_t* arrivals;  // [gridDim.y][n_long]
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
    v += __shfl_xor_sync(kFull, v, offset);
  }
  return v;
}

// The sums of the nb <= kBatch pieces whose bounds lanes 0 .. nb hold in
// `ptr` (piece_ptr of the first piece + lane): piece b's sum in lanes
// kGroup*b .. kGroup*b + kGroup-1, 0 for b >= nb.
//
// Lane q of group b plays the lanes v = q + kGroup*i (i < kVirt) of a warp
// that owns piece b alone: it takes the elements v, v + 32, ... in order,
// one FMA each. The butterfly over the 32 lanes v then runs its steps 16,
// 8, 4 inside each thread (v and v ^ offset are the same thread) and its
// steps 2, 1 by shuffles within the group: the same tree, so the same
// bits, as a warp per piece, with kVirt independent loads per thread.
template <typename Tv, typename Tx>
__device__ __forceinline__ Tx piece_sums(const PiecesArgs& a, int32_t ptr,
                                         int nb, int lane,
                                         const Tv* __restrict__ values,
                                         const Tx* __restrict__ x) {
  const int b = lane / kGroup;
  const int q = lane % kGroup;
  const int32_t begin = __shfl_sync(kFull, ptr, b);
  const int32_t end = __shfl_sync(kFull, ptr, b + 1);
  const int32_t len = b < nb ? end - begin : 0;
  Tx acc[kVirt];
#pragma unroll
  for (int i = 0; i < kVirt; ++i) {
    acc[i] = Tx(0);
  }
  for (int32_t t0 = q; t0 < len; t0 += kWarp) {
    Tv val[kVirt];
    int32_t col[kVirt];
#pragma unroll
    for (int i = 0; i < kVirt; ++i) {
      if (t0 + kGroup * i < len) {
        val[i] = __ldg(values + begin + t0 + kGroup * i);
        col[i] = __ldg(a.col_idxs + begin + t0 + kGroup * i);
      }
    }
    Tx xv[kVirt];
#pragma unroll
    for (int i = 0; i < kVirt; ++i) {
      if (t0 + kGroup * i < len) {
        xv[i] = __ldg(x + static_cast<int64_t>(col[i]) * a.x_ld);
      }
    }
#pragma unroll
    for (int i = 0; i < kVirt; ++i) {
      if (t0 + kGroup * i < len) {
        acc[i] = fma_rn(static_cast<Tx>(widen(val[i])), xv[i], acc[i]);
      }
    }
  }
#pragma unroll
  for (int d = kVirt / 2; d > 0; d >>= 1) {  // offsets 16, 8, 4
#pragma unroll
    for (int i = 0; i < d; ++i) {
      acc[i] += acc[i + d];
    }
  }
  Tx s = acc[0];
#pragma unroll
  for (int offset = kGroup / 2; offset > 0; offset >>= 1) {  // 2, 1
    s += __shfl_xor_sync(kFull, s, offset);
  }
  return s;
}

// A sum as the words of its slot: 32 bits each, the tag above them.
template <typename Tx>
struct Slot {
  static constexpr int kWords = static_cast<int>(sizeof(Tx)) / 4;
};

// A word of a slot, stored and loaded at the L2 (relaxed, gpu scope): a
// load in a loop is issued again every trip.
__device__ __forceinline__ void store_word(Word* w, Word v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(w), "l"(v)
               : "memory");
}
__device__ __forceinline__ Word load_word(const Word* w) {
  Word v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(w)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_slot(Word* w, float v) {
  store_word(w, kTag | __float_as_uint(v));
}
__device__ __forceinline__ void store_slot(Word* w, double v) {
  const Word bits = static_cast<Word>(__double_as_longlong(v));
  store_word(w, kTag | (bits & 0xffffffffu));
  store_word(w + 1, kTag | (bits >> 32));
}

__device__ __forceinline__ float slot_sum(const Word* w, float) {
  return __uint_as_float(static_cast<unsigned int>(w[0]));
}
__device__ __forceinline__ double slot_sum(const Word* w, double) {
  return __longlong_as_double(static_cast<long long>(
      (w[0] & 0xffffffffu) | ((w[1] & 0xffffffffu) << 32)));
}

// A long parent's record, once its sum is in `sum` (lane 0): it goes to the
// record's slot and the record is counted; the warp that counts the last
// record folds the parent from its slots in the order lane k: k, k + 32,
// ..., then the butterfly, writes y from `y_old` (lane 0) and clears the
// slots and the counter.
template <typename Tx>
__device__ __forceinline__ void long_record(const PiecesArgs& a, int4 rec,
                                            int32_t row, Tx sum, Tx y_old,
                                            int lane, Word* slots,
                                            int32_t* arrivals, Tx* y) {
  constexpr int kWords = Slot<Tx>::kWords;
  constexpr int kFold = kFoldWords / kWords;
  const int4 lng = __ldg(a.longs + rec.w);
  int last = 0;
  if (lane == 0) {
    store_slot(slots + kWords * (lng.x + (rec.x - lng.y) / kBatch), sum);
    last = atomicAdd(arrivals + rec.w, 1) == lng.w - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) {
    return;
  }
  Word* mine_all = slots + kWords * lng.x;
  Tx fold = Tx(0);
  for (int32_t j0 = lane; j0 < lng.w; j0 += kFold * kWarp) {
    // all kFold slots' loads in flight, then a word whose tag is not set
    // yet (its store still on its way) loaded again until it is
    Word w[kFold][kWords];
#pragma unroll
    for (int i = 0; i < kFold; ++i) {
      const int32_t j = j0 + i * kWarp;
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        w[i][k] = j < lng.w ? load_word(mine_all + kWords * j + k) : kTag;
      }
    }
#pragma unroll
    for (int i = 0; i < kFold; ++i) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        while (!(w[i][k] & kTag)) {
          w[i][k] = load_word(mine_all + kWords * (j0 + i * kWarp) + k);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kFold; ++i) {
      if (j0 + i * kWarp < lng.w) {
        fold += slot_sum(w[i], Tx(0));
      }
    }
  }
  fold = warp_sum(fold);
  for (int32_t w = lane; w < kWords * lng.w; w += kWarp) {
    mine_all[w] = 0;  // no other warp reads it until the next launch
  }
  if (lane == 0) {
    y[static_cast<int64_t>(row) * a.y_ld] = y_old + fold;
    arrivals[rec.w] = 0;
  }
}

// What a warp loads for a record before it sums it: lane <= n (the
// record's pieces) piece_ptr[first piece + lane]; lane <= P (its parents,
// 1 for a long record) parent_ptr[first parent + lane] and, lane < P,
// parent_row[first parent + lane].
struct RecordHead {
  int4 rec;
  int32_t ptr;
  int32_t pptr;
  int32_t row;
};

__device__ __forceinline__ RecordHead load_head(const PiecesArgs& a,
                                                int4 rec, int lane) {
  const int n_par = rec.w < 0 ? -rec.w : 1;
  RecordHead h{rec, 0, 0, 0};
  if (lane <= rec.y - rec.x) {
    h.ptr = __ldg(a.piece_ptr + rec.x + lane);
  }
  if (lane <= n_par) {
    h.pptr = __ldg(a.parent_ptr + rec.z + lane);
  }
  if (lane < n_par) {
    h.row = __ldg(a.parent_row + rec.z + lane);
  }
  return h;
}

// The sums s_start .. s_{start+m-1} (m <= 8) of a record's pieces (in the
// lanes of their groups, `s`) folded as lanes 0 .. m-1 of a warp holding
// 0 + s_j (the rest 0) would by the butterfly: the steps 16 and 8 add
// zeros, and what is left is the tree of the steps 4, 2, 1 over 8 values,
// which one thread computes from 8 shuffles.
template <typename Tx>
__device__ __forceinline__ Tx fold8(Tx s, int start, int m) {
  Tx r[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const Tx sj =
        __shfl_sync(kFull, s, min(start + j, kBatch - 1) * kGroup);
    r[j] = j < m ? Tx(0) + sj : Tx(0);
  }
#pragma unroll
  for (int d = kBatch / 2; d > 0; d >>= 1) {  // offsets 4, 2, 1
#pragma unroll
    for (int j = 0; j < d; ++j) {
      r[j] += r[j + d];
    }
  }
  return r[0];
}

// A record: its pieces' sums, then a long parent's record (long_record)
// or each short parent folded by lane p for parent p and written to y from
// `y_old` (lane p: y at that row as it was at the launch: only this warp
// writes it).
template <typename Tv, typename Tx>
__device__ __forceinline__ void sum_record(const PiecesArgs& a,
                                           const RecordHead& h, Tx y_old,
                                           int lane,
                                           const Tv* __restrict__ values,
                                           const Tx* __restrict__ x, Tx* y,
                                           Word* slots,
                                           int32_t* arrivals) {
  const int n = h.rec.y - h.rec.x;
  const Tx s = piece_sums<Tv, Tx>(a, h.ptr, n, lane, values, x);
  if (h.rec.w >= 0) {
    long_record<Tx>(a, h.rec, h.row, fold8(s, 0, n), y_old, lane, slots,
                    arrivals, y);
    return;
  }
  // lane p < P: parent p's sums are pieces start .. start + m - 1
  const int start = h.pptr - h.rec.x;
  const int m = __shfl_sync(kFull, h.pptr, lane + 1) - h.pptr;
  const Tx fold = fold8(s, start, m);
  if (lane < -h.rec.w) {
    y[static_cast<int64_t>(h.row) * a.y_ld] = y_old + fold;
  }
}

template <typename Tv, typename Tx>
__global__ void __launch_bounds__(kThreads)
scs_pieces_kernel(const PiecesArgs a) {
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const Tv* __restrict__ values = static_cast<const Tv*>(a.values);
  const Tx* __restrict__ x = static_cast<const Tx*>(a.x) +
                             static_cast<int64_t>(blockIdx.y) * a.x_vstride;
  Tx* y =
      static_cast<Tx*>(a.y) + static_cast<int64_t>(blockIdx.y) * a.y_vstride;
  Word* slots = a.slots + static_cast<int64_t>(blockIdx.y) * a.n_slot_words;
  int32_t* arrivals = a.arrivals + static_cast<int64_t>(blockIdx.y) * a.n_long;
  // a pipeline over the warp's records r, r + warps, ...: the record after
  // next and the next one's head load while one is summed
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
              threadIdx.x / kWarp;
  if (r >= a.n_records) {  // the whole warp leaves together
    return;
  }
  RecordHead h = load_head(a, __ldg(a.records + r), lane);
  int4 next = h.rec;
  if (r + warps < a.n_records) {
    next = __ldg(a.records + r + warps);
  }
  for (; r < a.n_records; r += warps) {
    Tx y_old = Tx(0);
    if (lane < (h.rec.w < 0 ? -h.rec.w : 1)) {
      y_old = y[static_cast<int64_t>(h.row) * a.y_ld];
    }
    RecordHead h_next = h;
    int4 after = next;
    if (r + warps < a.n_records) {
      h_next = load_head(a, next, lane);
      if (r + 2 * warps < a.n_records) {
        after = __ldg(a.records + r + 2 * warps);
      }
    }
    sum_record<Tv, Tx>(a, h, y_old, lane, values, x, y, slots, arrivals);
    h = h_next;
    next = after;
  }
}

// The persistent grid of one instantiation: blocks along x, all resident
// blocks shared among the n_vec vectors, at most one warp per record.
template <typename Tv, typename Tx>
cudaError_t pieces_grid(int64_t n_records, int n_vec, int64_t* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  int n_sm = 0;
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scs_pieces_kernel<Tv, Tx>, kThreads, 0);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset it, or the next launch would report it
    return err;
  }
  if (per_sm < 1) {
    return cudaErrorLaunchOutOfResources;
  }
  int64_t b = static_cast<int64_t>(per_sm) * n_sm / n_vec;
  const int64_t needed = (n_records + kWarpsPerBlock - 1) / kWarpsPerBlock;
  b = b < 1 ? 1 : b;
  *blocks = b < needed ? b : needed;
  return cudaSuccess;
}

template <typename Tv, typename Tx>
int launch_pieces(int64_t n_records, const void* records, int64_t n_long,
                  const void* longs, const void* piece_ptr,
                  const void* parent_ptr, const void* parent_row,
                  const void* col_idxs, const void* values, const void* x,
                  int64_t x_ld, int64_t x_vstride, void* slots,
                  int64_t n_slot_words, void* arrivals, void* y, int64_t y_ld,
                  int64_t y_vstride, int n_vec, void* stream) {
  if (n_records <= 0 || n_vec <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (n_vec > kMaxGridY || n_long < 0 || n_slot_words < 0 ||
      reinterpret_cast<uintptr_t>(records) % alignof(int4) != 0 ||
      reinterpret_cast<uintptr_t>(longs) % alignof(int4) != 0 ||
      reinterpret_cast<uintptr_t>(slots) % alignof(Word) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t blocks = 0;
  const cudaError_t err = pieces_grid<Tv, Tx>(n_records, n_vec, &blocks);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const PiecesArgs a{static_cast<const int4*>(records),
                     n_records,
                     static_cast<const int4*>(longs),
                     n_long,
                     static_cast<const int32_t*>(piece_ptr),
                     static_cast<const int32_t*>(parent_ptr),
                     static_cast<const int32_t*>(parent_row),
                     static_cast<const int32_t*>(col_idxs),
                     values,
                     x,
                     x_ld,
                     x_vstride,
                     static_cast<Word*>(slots),
                     n_slot_words,
                     static_cast<int32_t*>(arrivals),
                     y,
                     y_ld,
                     y_vstride};
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(n_vec));
  scs_pieces_kernel<Tv, Tx>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point: y[parent rows] += the pieces' products with x, for one
// precision stream and n_vec vectors; one kernel on `stream`. records and
// longs are 16-byte aligned int4 arrays; slots holds n_vec x n_slot_words
// zeros (sizeof(Tx) / 4 words per long parent's record), arrivals n_vec x
// n_long zeros, and the kernel leaves both so.
#define USPMV_PIECES_ENTRY(name, Tv, Tx)                                      \
  int name(int64_t n_records, const void* records, int64_t n_long,           \
           const void* longs, const void* piece_ptr, const void* parent_ptr, \
           const void* parent_row, const void* col_idxs, const void* values, \
           const void* x, int64_t x_ld, int64_t x_vstride, void* slots,      \
           int64_t n_slot_words, void* arrivals, void* y, int64_t y_ld,      \
           int64_t y_vstride, int n_vec, void* stream) {                     \
    return launch_pieces<Tv, Tx>(n_records, records, n_long, longs,          \
                                 piece_ptr, parent_ptr, parent_row,          \
                                 col_idxs, values, x, x_ld, x_vstride,       \
                                 slots, n_slot_words, arrivals, y, y_ld,     \
                                 y_vstride, n_vec, stream);                  \
  }

extern "C" {

USPMV_PIECES_ENTRY(uspmv_scs_pieces_f64_f64, double, double)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_f32_f32, float, float)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_bf16_f32, __nv_bfloat16, float)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_f32_f64, float, double)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_bf16_f64, __nv_bfloat16, double)

}  // extern "C"
