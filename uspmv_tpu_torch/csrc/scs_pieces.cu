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
// at most once. For each vector v:
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
// path G). Bytes moved per pass of up to 8 vectors: the CSR stream, the
// parents' runs and rows, the records and the long parents' counters; per
// vector: x, y and the long records' slots written, read and cleared
// once.
//
// Block vectors: gridDim.y counts passes of up to kMaxCols (8) vectors,
// pass p the vectors 8p .. 8p + 7 of n_vec; x_ld / y_ld are the element
// strides between rows and x_vstride / y_vstride between vectors (rowwise
// x[n][bs]: ld = bs, vstride = 1; colwise x[bs][n]: ld = 1, vstride = n,
// or more for a view). scs_pieces_block_kernel: a warp loads a record's
// heads, bounds, values and columns once for every vector of its pass and
// keeps them in registers, then sums its pieces in sweeps of 16 bytes of x
// per column (4 float or 2 double vectors), each vector's sums apart, so a
// pass reads the pieces once. Each vector's sums take the tree above:
// which physical thread plays which virtual lane does not change a bit, so
// each vector's y equals a one-vector launch's. What that costs is
// registers: a thread holds a sweep's sums per virtual lane where one
// vector holds one, so it walks its kVirt virtual lanes in pairs, in the
// order the in-thread butterfly steps 16, 8, 4 add them (lane_pair). In
// the rowwise layout a column's values are contiguous: where the rows of x
// lie on 16-byte boundaries a sweep loads them as one 16-byte vector
// (kVecX). Slots are per (vector, long record); the counters per (pass,
// long parent): a warp counts a record once for its pass, and the warp
// that counts last folds each vector. The sweep width, block size and
// register cap (BlockShape) were chosen in paired runs on an H100:
// narrower sweeps or 4 fewer warps an SM lost time, wider sweeps and a
// lower cap spilled (scripts/kernel_ab.py, PERF.md). The x gathers of a
// colwise block stay one sector per element and vector, so colwise gains
// the least.
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
using uspmv::kMaxCols;
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
  Word* slots;  // [n_vec][n_slot_words]
  int64_t n_slot_words;
  int32_t* arrivals;  // [gridDim.y][n_long]: per pass of kMaxCols vectors
  void* y;
  int64_t y_ld;
  int64_t y_vstride;
  int n_vec;
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

// One vector (n_vec 1).
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

// ---------------------------------------------------------- block vectors
//
// A grid row per pass of up to kMaxCols vectors, BS accumulators deep;
// kFullPass: the pass holds BS vectors (no vector guard), else nv <= BS;
// kVecX: rowwise rows of x on 16-byte boundaries, a column's values loaded
// as 16-byte vectors. A warp loads a record's heads, bounds, values and
// columns once, then sums its pieces for kSweepBytes of x per column at a
// time (4 float or 2 double vectors: a sweep) from those registers.

// x bytes per column that a sweep gathers: 4 float or 2 double vectors,
// one 16-byte load rowwise.
constexpr int kSweepBytes = 16;
// Threads per block of the block-vector kernels and the blocks they keep
// resident on an SM (__launch_bounds__): float values and x at most 128
// registers a thread (16 warps an SM), the other pairs at most 168 (12
// warps), where their sweeps need no local memory (bf16 values with float
// x spilled at 128: ptxas -v on sm_90a).
template <typename Tv, typename Tx>
struct BlockShape {
  static constexpr bool kF32 = sizeof(Tv) == 4 && sizeof(Tx) == 4;
  static constexpr int kThreads = kF32 ? 256 : 128;
  static constexpr int kMinBlocks = kF32 ? 2 : 3;
  static constexpr int kWarps = kThreads / kWarp;
};

template <typename Tx, int BS>
__host__ __device__ constexpr int sweep_vectors() {
  constexpr int kPerSweep = kSweepBytes / static_cast<int>(sizeof(Tx));
  return BS < kPerSweep ? BS : kPerSweep;
}

// What a lane of group b = lane / kGroup (piece b of the record; none at
// b >= nb) holds of its piece [begin, begin + len): lane q of the group,
// and the first element of each of its kVirt virtual lanes q + kGroup*i,
// where it exists.
template <typename Tv>
struct PieceLanes {
  int32_t begin;
  int32_t len;
  int q;
  Tv val[kVirt];
  int32_t col[kVirt];
};

template <typename Tv>
__device__ __forceinline__ void load_lanes(const PiecesArgs& a, int32_t ptr,
                                           int nb, int lane,
                                           const Tv* __restrict__ values,
                                           PieceLanes<Tv>& p) {
  const int b = lane / kGroup;
  p.q = lane % kGroup;
  p.begin = __shfl_sync(kFull, ptr, b);
  const int32_t end = __shfl_sync(kFull, ptr, b + 1);
  p.len = b < nb ? end - p.begin : 0;
#pragma unroll
  for (int i = 0; i < kVirt; ++i) {
    if (p.q + kGroup * i < p.len) {
      p.val[i] = __ldg(values + p.begin + p.q + kGroup * i);
      p.col[i] = __ldg(a.col_idxs + p.begin + p.q + kGroup * i);
    }
  }
}

// x at column `col` for BS vectors, into xv[v] (v < nv).
template <typename Tx, int BS, bool kFullPass, bool kVecX>
__device__ __forceinline__ void load_x_block(const PiecesArgs& a,
                                             const Tx* __restrict__ x,
                                             int32_t col, int nv,
                                             Tx (&xv)[BS]) {
  const Tx* xr = x + static_cast<int64_t>(col) * a.x_ld;
  if constexpr (kVecX && (BS * sizeof(Tx)) % 16 == 0) {
    uspmv::load_x_row16<BS, true>(xr, xv);
  } else {
#pragma unroll
    for (int v = 0; v < BS; ++v) {
      if (kFullPass || v < nv) {
        xv[v] = __ldg(xr);
      }
      xr += a.x_vstride;
    }
  }
}

// out[v] = L_I[v] + L_J[v], J = I + kVirt/2: the sums of the virtual lanes
// q + kGroup*I and q + kGroup*J for each of BS vectors, each as piece_sums
// takes it (its elements e, e + 32, ..., one FMA each from 0). Pieces
// longer than a warp load the lanes' further elements here.
template <typename Tv, typename Tx, int BS, bool kFullPass, bool kVecX,
          int I>
__device__ __forceinline__ void lane_pair(const PiecesArgs& a,
                                          const PieceLanes<Tv>& p,
                                          const Tv* __restrict__ values,
                                          const Tx* __restrict__ x, int nv,
                                          Tx (&out)[BS]) {
  constexpr int J = I + kVirt / 2;
  Tx ai[BS];
  Tx aj[BS];
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    ai[v] = Tx(0);
    aj[v] = Tx(0);
  }
  {
    const bool hi = p.q + kGroup * I < p.len;
    const bool hj = p.q + kGroup * J < p.len;
    Tx xi[BS];
    Tx xj[BS];
    if (hi) {
      load_x_block<Tx, BS, kFullPass, kVecX>(a, x, p.col[I], nv, xi);
    }
    if (hj) {
      load_x_block<Tx, BS, kFullPass, kVecX>(a, x, p.col[J], nv, xj);
    }
#pragma unroll
    for (int v = 0; v < BS; ++v) {
      if (kFullPass || v < nv) {
        if (hi) {
          ai[v] = fma_rn(static_cast<Tx>(widen(p.val[I])), xi[v], ai[v]);
        }
        if (hj) {
          aj[v] = fma_rn(static_cast<Tx>(widen(p.val[J])), xj[v], aj[v]);
        }
      }
    }
  }
#pragma unroll 1
  for (int32_t t0 = p.q + kWarp; t0 < p.len; t0 += kWarp) {
    const int32_t ei = t0 + kGroup * I;
    const int32_t ej = t0 + kGroup * J;
    Tv vi;
    Tv vj;
    int32_t ci;
    int32_t cj;
    if (ei < p.len) {
      vi = __ldg(values + p.begin + ei);
      ci = __ldg(a.col_idxs + p.begin + ei);
    }
    if (ej < p.len) {
      vj = __ldg(values + p.begin + ej);
      cj = __ldg(a.col_idxs + p.begin + ej);
    }
    Tx xi[BS];
    Tx xj[BS];
    if (ei < p.len) {
      load_x_block<Tx, BS, kFullPass, kVecX>(a, x, ci, nv, xi);
    }
    if (ej < p.len) {
      load_x_block<Tx, BS, kFullPass, kVecX>(a, x, cj, nv, xj);
    }
#pragma unroll
    for (int v = 0; v < BS; ++v) {
      if (kFullPass || v < nv) {
        if (ei < p.len) {
          ai[v] = fma_rn(static_cast<Tx>(widen(vi)), xi[v], ai[v]);
        }
        if (ej < p.len) {
          aj[v] = fma_rn(static_cast<Tx>(widen(vj)), xj[v], aj[v]);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    out[v] = ai[v] + aj[v];
  }
}

// piece_sums for BS vectors into s[v]: the in-thread steps 16, 8, 4 over
// the kVirt virtual lanes, ((L0 + L4) + (L2 + L6)) + ((L1 + L5) + (L3 +
// L7)), the same adds of the same values as piece_sums' acc[i] += acc[i +
// d], a pair of virtual lanes at a time; then the shuffles 2, 1 within the
// group.
template <typename Tv, typename Tx, int BS, bool kFullPass, bool kVecX>
__device__ __forceinline__ void block_piece_sums(
    const PiecesArgs& a, const PieceLanes<Tv>& p,
    const Tv* __restrict__ values, const Tx* __restrict__ x, int nv,
    Tx (&s)[BS]) {
  static_assert(kVirt == 8, "the pairs below are the tree of 8 lanes");
  Tx t[BS];
  Tx u[BS];
  lane_pair<Tv, Tx, BS, kFullPass, kVecX, 0>(a, p, values, x, nv, s);
  lane_pair<Tv, Tx, BS, kFullPass, kVecX, 2>(a, p, values, x, nv, t);
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    s[v] += t[v];
  }
  lane_pair<Tv, Tx, BS, kFullPass, kVecX, 1>(a, p, values, x, nv, u);
  lane_pair<Tv, Tx, BS, kFullPass, kVecX, 3>(a, p, values, x, nv, t);
#pragma unroll
  for (int v = 0; v < BS; ++v) {
    u[v] += t[v];
    s[v] += u[v];
  }
#pragma unroll
  for (int v = 0; v < BS; ++v) {
#pragma unroll
    for (int offset = kGroup / 2; offset > 0; offset >>= 1) {  // 2, 1
      s[v] += __shfl_xor_sync(kFull, s[v], offset);
    }
  }
}

// A long parent's record, once each of the pass's n vectors has stored
// its record sum in its slot: lane 0 counts the record once on the pass's
// counter; the warp that counts last folds each vector's slots as
// long_record does, adds the fold into y at the parent's row (no other
// warp writes it in this launch, so it still holds the launch's value)
// and clears them, then the counter.
template <typename Tx>
__device__ __forceinline__ void count_long_record(const PiecesArgs& a,
                                                  int4 rec, int4 lng,
                                                  int32_t row, int lane,
                                                  int n, Word* slots,
                                                  int32_t* arrivals, Tx* y) {
  constexpr int kWords = Slot<Tx>::kWords;
  constexpr int kFold = kFoldWords / kWords;
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(arrivals + rec.w, 1) == lng.w - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) {
    return;
  }
#pragma unroll 1
  for (int v = 0; v < n; ++v) {
    Word* mine_all = slots + v * a.n_slot_words + kWords * lng.x;
    Tx fold = Tx(0);
    for (int32_t j0 = lane; j0 < lng.w; j0 += kFold * kWarp) {
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
      Tx* yr = y + static_cast<int64_t>(row) * a.y_ld + v * a.y_vstride;
      *yr = *yr + fold;
    }
  }
  if (lane == 0) {
    arrivals[rec.w] = 0;
  }
}

// sum_record for the pass's nv vectors, in sweeps of S: a sweep sums the
// pieces for its vectors from the lanes' registers, then stores a long
// record's sums to their slots (lane u: vector u of the sweep) or adds
// each short parent's fold into y (lane p: parent p, y as it was at the
// launch: only this warp writes that row); after the last sweep a long
// record is counted once.
template <typename Tv, typename Tx, int BS, bool kFullPass, bool kVecX>
__device__ __forceinline__ void sum_record_block(
    const PiecesArgs& a, const RecordHead& h, int lane, int nv,
    const Tv* __restrict__ values, const Tx* __restrict__ x, Tx* y,
    Word* slots, int32_t* arrivals) {
  constexpr int S = sweep_vectors<Tx, BS>();
  static_assert(BS % S == 0, "whole sweeps");
  const int n = h.rec.y - h.rec.x;
  const bool is_long = h.rec.w >= 0;
  PieceLanes<Tv> p;
  load_lanes<Tv>(a, h.ptr, n, lane, values, p);
  // what a sweep needs besides the lanes is recomputed in it (the long
  // parent's entry reloaded), so that fewer registers live across sweeps
#pragma unroll 1
  for (int v0 = 0; v0 < BS; v0 += S) {
    if (!kFullPass && v0 >= nv) {
      break;
    }
    const int nw = kFullPass ? S : min(S, nv - v0);
    // short parents' rows of the sweep's vectors, loading while it sums
    const int n_par = is_long ? 0 : -h.rec.w;
    Tx* yr = y + static_cast<int64_t>(h.row) * a.y_ld +
             static_cast<int64_t>(v0) * a.y_vstride;
    Tx y_old[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      y_old[u] = Tx(0);
      if (lane < n_par && (kFullPass || u < nw)) {
        y_old[u] = yr[u * a.y_vstride];
      }
    }
    Tx s[S];
    block_piece_sums<Tv, Tx, S, kFullPass, kVecX>(
        a, p, values, x + static_cast<int64_t>(v0) * a.x_vstride, nw, s);
    if (is_long) {
      Tx mine = Tx(0);
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const Tx sum = fold8(s[u], 0, n);
        if (lane == u) {
          mine = sum;
        }
      }
      if (lane < nw) {
        const int4 lng = __ldg(a.longs + h.rec.w);
        store_slot(slots + (v0 + lane) * a.n_slot_words +
                       Slot<Tx>::kWords * (lng.x + (h.rec.x - lng.y) / kBatch),
                   mine);
      }
      continue;
    }
    // lane q < P folds parent q, pieces start .. start + m - 1
    const int start = h.pptr - h.rec.x;
    const int m = __shfl_sync(kFull, h.pptr, lane + 1) - h.pptr;
    Tx fold[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      fold[u] = fold8(s[u], start, m);
    }
    if (lane < n_par) {
#pragma unroll
      for (int u = 0; u < S; ++u) {
        if (kFullPass || u < nw) {
          yr[u * a.y_vstride] = y_old[u] + fold[u];
        }
      }
    }
  }
  if (is_long) {
    count_long_record<Tx>(a, h.rec, __ldg(a.longs + h.rec.w), h.row, lane,
                          kFullPass ? BS : nv, slots, arrivals, y);
  }
}

// The pass blockIdx.y (vectors v0 = 8 * blockIdx.y ..): the records r, r +
// warps, ... as scs_pieces_kernel walks them, the next one's head loading
// while one is summed (not the record after it: 4 more registers spilled
// the float BS 8 forms at 128).
template <typename Tv, typename Tx, int BS, bool kFullPass, bool kVecX>
__global__ void __launch_bounds__(BlockShape<Tv, Tx>::kThreads,
                                  BlockShape<Tv, Tx>::kMinBlocks)
scs_pieces_block_kernel(const PiecesArgs a) {
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int v0 = static_cast<int>(blockIdx.y) * kMaxCols;
  const int nv = kFullPass ? BS : min(BS, a.n_vec - v0);
  const Tv* __restrict__ values = static_cast<const Tv*>(a.values);
  const Tx* __restrict__ x =
      static_cast<const Tx*>(a.x) + static_cast<int64_t>(v0) * a.x_vstride;
  Tx* y = static_cast<Tx*>(a.y) + static_cast<int64_t>(v0) * a.y_vstride;
  Word* slots = a.slots + static_cast<int64_t>(v0) * a.n_slot_words;
  int32_t* arrivals =
      a.arrivals + static_cast<int64_t>(blockIdx.y) * a.n_long;
  constexpr int kWarps = BlockShape<Tv, Tx>::kWarps;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (r >= a.n_records) {
    return;
  }
  RecordHead h = load_head(a, __ldg(a.records + r), lane);
  for (; r < a.n_records; r += warps) {
    RecordHead h_next = h;
    if (r + warps < a.n_records) {
      h_next = load_head(a, __ldg(a.records + r + warps), lane);
    }
    sum_record_block<Tv, Tx, BS, kFullPass, kVecX>(a, h, lane, nv, values,
                                                   x, y, slots, arrivals);
    h = h_next;
  }
}

// The kernel of an instantiation (BS 1: the one-vector kernel) and its
// threads per block.
template <typename Tv, typename Tx, int BS>
constexpr int pieces_threads() {
  return BS == 1 ? kThreads : BlockShape<Tv, Tx>::kThreads;
}

template <typename Tv, typename Tx, int BS, bool kFullPass, bool kVecX>
constexpr auto pieces_kernel() {
  if constexpr (BS == 1) {
    return &scs_pieces_kernel<Tv, Tx>;
  } else {
    return &scs_pieces_block_kernel<Tv, Tx, BS, kFullPass, kVecX>;
  }
}

// The instantiation for n_vec vectors: 1, 4 (BS 4), 2, 3 and 5 and more
// (BS 8, passes of 8, the last guarded unless 8 divides n_vec: a guarded
// pass stops after its last sweep with a vector, so 2 vectors take one
// sweep as a form of their own would); op.run<BS, kFullPass, kVecX>().
template <typename Op>
cudaError_t with_variant(int n_vec, bool vec_x, const Op& op) {
  switch (n_vec) {
    case 1:
      return op.template run<1, true, false>();
    case 4:
      return vec_x ? op.template run<4, true, true>()
                   : op.template run<4, true, false>();
    default:
      if (n_vec % kMaxCols != 0) {
        return op.template run<kMaxCols, false, false>();
      }
      return vec_x ? op.template run<kMaxCols, true, true>()
                   : op.template run<kMaxCols, true, false>();
  }
}

// Resident blocks per SM of an instantiation; its threads per block into
// `threads` where given.
template <typename Tv, typename Tx>
struct Occupancy {
  int* per_sm;
  int* threads;
  template <int BS, bool kFullPass, bool kVecX>
  cudaError_t run() const {
    if (threads != nullptr) {
      *threads = pieces_threads<Tv, Tx, BS>();
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, pieces_kernel<Tv, Tx, BS, kFullPass, kVecX>(),
        pieces_threads<Tv, Tx, BS>(), 0);
  }
};

// The persistent grid of one instantiation: blocks along x, all resident
// blocks shared among the passes, at most one warp per record; one grid
// row per pass.
template <typename Tv, typename Tx>
struct Launch {
  const PiecesArgs* a;
  int passes;
  cudaStream_t stream;
  template <int BS, bool kFullPass, bool kVecX>
  cudaError_t run() const {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    int n_sm = 0;
    int per_sm = 0;
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err == cudaSuccess) {
      err = Occupancy<Tv, Tx>{&per_sm, nullptr}
                .template run<BS, kFullPass, kVecX>();
    }
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset it, or the next launch would report it
      return err;
    }
    if (per_sm < 1) {
      return cudaErrorLaunchOutOfResources;
    }
    constexpr int kWarps = pieces_threads<Tv, Tx, BS>() / kWarp;
    int64_t b = static_cast<int64_t>(per_sm) * n_sm / passes;
    const int64_t needed = (a->n_records + kWarps - 1) / kWarps;
    b = b < 1 ? 1 : b;
    b = b < needed ? b : needed;
    const dim3 grid(static_cast<unsigned int>(b),
                    static_cast<unsigned int>(passes));
    const auto kernel = pieces_kernel<Tv, Tx, BS, kFullPass, kVecX>();
    kernel<<<grid, pieces_threads<Tv, Tx, BS>(), 0, stream>>>(*a);
    return cudaGetLastError();
  }
};

// Whether a rowwise block (vstride 1) of n_vec > 1 vectors has its rows of
// x on 16-byte boundaries: base and x_ld * sizeof(Tx).
template <typename Tx>
bool rowwise_x16(const void* x, int64_t x_ld, int64_t x_vstride,
                 int n_vec) {
  return n_vec > 1 && x_vstride == 1 && uspmv::rows_16b_aligned<Tx>(x, x_ld);
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
  const int passes = (n_vec + kMaxCols - 1) / kMaxCols;
  if (passes > kMaxGridY || n_long < 0 || n_slot_words < 0 ||
      reinterpret_cast<uintptr_t>(records) % alignof(int4) != 0 ||
      reinterpret_cast<uintptr_t>(longs) % alignof(int4) != 0 ||
      reinterpret_cast<uintptr_t>(slots) % alignof(Word) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
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
                     y_vstride,
                     n_vec};
  return static_cast<int>(with_variant(
      n_vec, rowwise_x16<Tx>(x, x_ld, x_vstride, n_vec),
      Launch<Tv, Tx>{&a, passes, static_cast<cudaStream_t>(stream)}));
}

template <typename Tv, typename Tx>
int blocks_per_sm(int* per_sm, int* threads, int n_vec, int vec_x) {
  const cudaError_t err =
      with_variant(n_vec < 1 ? 1 : n_vec, vec_x != 0 && n_vec > 1,
                   Occupancy<Tv, Tx>{per_sm, threads});
  if (err != cudaSuccess) {
    cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// Every entry point: y[parent rows] += the pieces' products with x, for one
// precision stream and n_vec vectors; one kernel on `stream`. records and
// longs are 16-byte aligned int4 arrays; slots holds n_vec x n_slot_words
// zeros (sizeof(Tx) / 4 words per long parent's record), arrivals
// ceil(n_vec / 8) x n_long zeros (a row per pass of 8 vectors), and the
// kernel leaves both so.
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
  }                                                                           \
  int name##_blocks_per_sm(int* per_sm, int* threads, int n_vec,             \
                           int vec_x) {                                      \
    return blocks_per_sm<Tv, Tx>(per_sm, threads, n_vec, vec_x);             \
  }

extern "C" {

// <entry>_blocks_per_sm: resident blocks per SM of the instantiation the
// entry launches for n_vec vectors, with 16-byte x loads where vec_x != 0
// (a rowwise block whose rows lie on 16-byte boundaries), and its threads
// per block.
USPMV_PIECES_ENTRY(uspmv_scs_pieces_f64_f64, double, double)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_f32_f32, float, float)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_bf16_f32, __nv_bfloat16, float)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_f32_f64, float, double)
USPMV_PIECES_ENTRY(uspmv_scs_pieces_bf16_f64, __nv_bfloat16, double)

}  // extern "C"
