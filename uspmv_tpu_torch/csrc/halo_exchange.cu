// Halo exchange of the row-sharded SpMV for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA hot path `_exchange` of the JAX package
// (uspmv_tpu/parallel/distributed.py:917-944; XLA ops, not a Pallas
// kernel): per ring offset d, a jnp.take of the send indices out of each
// shard's x, a ppermute from shard r to shard (r + d) % R, and a
// .at[scatter].set into the receiver's halo region.
//
// In this package the shards an operator holds in one process live on one
// device, each with its own halo-extended x of L elements, stacked into one
// buffer of R * L rows (R: the process's shards). Pack, permute and scatter
// then collapse into one copy, and the host flattens the plan into (source
// row, destination row) pairs of the stacked buffer
// (parallel/halo.exchange_rows):
//
//   x[dst[i]] = x[src[i]]   for i < n, every active offset and shard,
//
// the real lanes only (padding lanes of the JAX plan write a dump slot
// that nothing reads). Sources are local rows of their shard (< its padded
// local rows), destinations halo rows of another shard (>= its padded local
// rows), and every destination is written once: the copy is race-free in
// any order and bit-exact.
//
// Across processes (one process per card, or several sharing one) a pair
// whose source and destination shards live in different processes cannot
// be one copy. Its rows go through a send buffer: the pack gathers the rows
// a process sends, grouped by destination process, into a dense buffer of
// rows, the transfer (torch.distributed all_to_all_single) moves it, and
// the unpack scatters the received rows, grouped by source process, into
// the halo rows. These answer the jnp.take pack and the .at[scatter].set of
// `_exchange` when its ppermute crosses a process:
//
//   pack:   buf[(i * n_vec + v) * ncols + c] = x[v * vstride + src[i] * ld + c]
//   unpack: x[v * vstride + dst[i] * ld + c] = buf[(i * n_vec + v) * ncols + c]
//
// so a buffer row holds every value of its x row, of every vector, and the
// transfer splits the buffer by rows.
//
// Layouts, as the SpMV kernels take them: element (row, column c, vector v)
// of the stacked buffer lies at v * vstride + row * ld + c, c < ncols:
// one vector (ld 1, ncols 1), rowwise block vectors [R * L, bs] (ld bs,
// ncols bs), colwise [bs, R * L] (vstride R * L, one grid row per vector).
//
// What bounds it: not bytes. The R=4 plan of Laplace3D-128 moves 98,304
// rows, about 1.6 MB, half a microsecond of HBM time; the rest of a launch
// is the launch itself and one chain of dependent loads (the index word,
// then the x row, then the store). So the three copies are one lean
// template, halo_copy_kernel<U, kSrcIndexed, kDstIndexed> (each side of a
// pair an x row taken by index or buffer row i: the exchange indexed ->
// indexed, the pack indexed -> buffer, the unpack buffer -> indexed):
// - thread i takes pair i, so the 32 lanes of a warp read 32 consecutive
//   index words and, for the runs of consecutive rows a halo plan holds,
//   neighbouring rows. On an H100 a thread of four pairs (consecutive or
//   32 apart, with a 16 B load of four index words) ran slower than this
//   at every plan size the sharded path uses: its longer code and fewer
//   blocks cost more than its loads in flight saved (PERF.md, section 6);
// - rows whose bytes are a multiple of 16 (rowwise bs 4 f32, bs 8 f32 or
//   f64), in 16 B aligned buffers, move as 16 B units (U = uint4); other
//   rows a value at a time;
// - the grid is at most one wave (SMs x resident blocks, asked once per
//   device and kept, not per launch), with a grid-stride loop beyond it
//   that loads the next pair's index words before the current pair's row;
// - a programmatic dependent launch (sm_90): the kernel may start while the
//   kernel before it on the stream finishes. It loads its first index
//   words before griddepcontrol.wait (the plan's index arrays are written
//   once, when the plan is built, never by a kernel in flight) and touches
//   x and the buffer only after it. It never triggers its dependents
//   early, so a following kernel reads the halo rows only once written.
// Loads: ordinary for all three. The exchange reads and writes x (never
// the same rows); the pack and unpack could read through the read-only
// path, since x and the buffer never alias, but such a load has to be a
// volatile asm to stay below the wait, and that measured slower on an H100
// than the ordinary load (PERF.md, section 6).
//
// Launch rules: the caller's stream, no allocation, no synchronisation. Each
// entry point returns the launch's CUDA error code (0 on success).

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowUnits = 4;  // units of a row held in registers at once
constexpr int kVectorBytes = 16;
constexpr int kMaxDevices = 64;
constexpr int kMaxGridY = 65535;

enum Kind : int { kExchange = 0, kPack = 1, kUnpack = 2 };

// One launch, in units (the bytes one load moves) of x and the buffer.
struct CopyArgs {
  const int32_t* src;  // x rows read (exchange, pack)
  const int32_t* dst;  // x rows written (exchange, unpack)
  int64_t n;           // pairs
  int64_t ld;          // units between x rows
  int64_t vstride;     // units between colwise vectors of x
  int row_units;       // units of one row
};

// The x rows of pair i (those its kind takes by index).
struct Pair {
  int32_t src;
  int32_t dst;
};

__device__ __forceinline__ void wait_for_prior_grids() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <bool kSrcIndexed, bool kDstIndexed>
__device__ __forceinline__ Pair fetch(const CopyArgs& a, int64_t i) {
  Pair r{0, 0};
  if (i < a.n) {
    if (kSrcIndexed) {
      r.src = __ldg(a.src + i);
    }
    if (kDstIndexed) {
      r.dst = __ldg(a.dst + i);
    }
  }
  return r;
}

// Row i's units of vector v: all loads of a slice of kRowUnits, then its
// stores.
template <typename U, bool kSrcIndexed, bool kDstIndexed>
__device__ __forceinline__ void copy_row(U* to, const U* from,
                                         const CopyArgs& a, Pair rows,
                                         int64_t i, int64_t v,
                                         int64_t n_vec) {
  const int64_t brow = (i * n_vec + v) * a.row_units;
  const U* f = from + (kSrcIndexed
                           ? v * a.vstride + static_cast<int64_t>(rows.src) * a.ld
                           : brow);
  U* t = to + (kDstIndexed
                   ? v * a.vstride + static_cast<int64_t>(rows.dst) * a.ld
                   : brow);
  for (int c0 = 0; c0 < a.row_units; c0 += kRowUnits) {
    U val[kRowUnits];
#pragma unroll
    for (int c = 0; c < kRowUnits; ++c) {
      if (c0 + c < a.row_units) {
        val[c] = f[c0 + c];
      }
    }
#pragma unroll
    for (int c = 0; c < kRowUnits; ++c) {
      if (c0 + c < a.row_units) {
        t[c0 + c] = val[c];
      }
    }
  }
}

template <typename U, bool kSrcIndexed, bool kDstIndexed>
__global__ void __launch_bounds__(kThreads)
halo_copy_kernel(U* to, const U* from, CopyArgs a) {
  const int64_t v = blockIdx.y;
  const int64_t n_vec = gridDim.y;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  Pair cur = fetch<kSrcIndexed, kDstIndexed>(a, i);
  wait_for_prior_grids();  // x and the buffer only after it
  for (; i < a.n; i += stride) {
    const Pair next = fetch<kSrcIndexed, kDstIndexed>(a, i + stride);
    copy_row<U, kSrcIndexed, kDstIndexed>(to, from, a, cur, i, v, n_vec);
    cur = next;
  }
}

// SMs and blocks of one instantiation resident per SM on the current
// device: asked once per device and kept.
template <typename U, bool kSrcIndexed, bool kDstIndexed>
cudaError_t resident(int* n_sm, int* per_sm) {
  static std::atomic<int> cached_sm[kMaxDevices];
  static std::atomic<int> cached_per_sm[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (device < kMaxDevices) {
    *n_sm = cached_sm[device].load(std::memory_order_relaxed);
    *per_sm = cached_per_sm[device].load(std::memory_order_relaxed);
    if (*n_sm > 0 && *per_sm > 0) {
      return cudaSuccess;
    }
  }
  err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, halo_copy_kernel<U, kSrcIndexed, kDstIndexed>, kThreads, 0);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset it, or the next launch would report it
    return err;
  }
  if (*per_sm < 1) {
    return cudaErrorLaunchOutOfResources;
  }
  if (device < kMaxDevices) {
    cached_sm[device].store(*n_sm, std::memory_order_relaxed);
    cached_per_sm[device].store(*per_sm, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// The geometry of a launch of a (and, with launch, the launch itself):
// out, when given, takes threads, unit bytes, units per row, grid x, grid
// y, SMs and blocks per SM.
template <typename U, bool kSrcIndexed, bool kDstIndexed>
int run(U* to, const U* from, const CopyArgs& a, int n_vec, bool launch,
        void* stream, int64_t* out) {
  int n_sm = 0;
  int per_sm = 0;
  cudaError_t err = resident<U, kSrcIndexed, kDstIndexed>(&n_sm, &per_sm);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  int64_t wave = static_cast<int64_t>(n_sm) * per_sm / n_vec;
  wave = wave < 1 ? 1 : wave;
  int64_t blocks = (a.n + kThreads - 1) / kThreads;
  blocks = blocks < wave ? blocks : wave;
  if (out != nullptr) {
    const int64_t geo[] = {kThreads, static_cast<int64_t>(sizeof(U)),
                           a.row_units, blocks, n_vec, n_sm, per_sm};
    for (int i = 0; i < 7; ++i) {
      out[i] = geo[i];
    }
  }
  if (!launch) {
    return static_cast<int>(cudaSuccess);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks),
                     static_cast<unsigned int>(n_vec));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, halo_copy_kernel<U, kSrcIndexed, kDstIndexed>,
                           to, from, a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename U>
int by_kind(int kind, void* x, void* buf, const CopyArgs& a, int n_vec,
            bool launch, void* stream, int64_t* out) {
  switch (kind) {
    case kExchange:
      return run<U, true, true>(static_cast<U*>(x), static_cast<const U*>(x),
                                a, n_vec, launch, stream, out);
    case kPack:
      return run<U, true, false>(static_cast<U*>(buf),
                                 static_cast<const U*>(x), a, n_vec, launch,
                                 stream, out);
    case kUnpack:
      return run<U, false, true>(static_cast<U*>(x),
                                 static_cast<const U*>(buf), a, n_vec, launch,
                                 stream, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVectorBytes == 0;
}

// rows: the exchange's src then dst; the pack's src; the unpack's dst.
// S: the unsigned integer of T's size, the unit of a row moved value by
// value.
template <typename T, typename S>
int dispatch(int kind, void* x, void* buf, const void* rows,
             const void* dst_rows, int64_t n, int64_t ld, int ncols,
             int64_t vstride, int n_vec, bool launch, void* stream,
             int64_t* out) {
  static_assert(sizeof(S) == sizeof(T), "a value is one unit");
  if (n <= 0 || n_vec <= 0 || n_vec > kMaxGridY || ncols <= 0 || ld <= 0 ||
      vstride < 0 || x == nullptr || rows == nullptr ||
      (kind == kExchange ? dst_rows == nullptr : buf == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t size = sizeof(T);
  const int64_t row_bytes = ncols * size;
  const bool vec = row_bytes % kVectorBytes == 0 &&
                   ld * size % kVectorBytes == 0 &&
                   (n_vec == 1 || vstride * size % kVectorBytes == 0) &&
                   aligned16(x) && (kind == kExchange || aligned16(buf));
  const int64_t unit = vec ? kVectorBytes : size;
  CopyArgs a{};
  a.src = kind == kUnpack ? nullptr : static_cast<const int32_t*>(rows);
  a.dst = kind == kExchange ? static_cast<const int32_t*>(dst_rows)
          : kind == kUnpack ? static_cast<const int32_t*>(rows)
                            : nullptr;
  a.n = n;
  a.ld = ld * size / unit;
  a.vstride = vstride * size / unit;
  a.row_units = static_cast<int>(row_bytes / unit);
  if (vec) {
    return by_kind<uint4>(kind, x, buf, a, n_vec, launch, stream, out);
  }
  return by_kind<S>(kind, x, buf, a, n_vec, launch, stream, out);
}

int launch_f32(int kind, void* x, void* buf, const void* rows,
               const void* dst_rows, int64_t n, int64_t ld, int ncols,
               int64_t vstride, int n_vec, void* stream) {
  return dispatch<float, unsigned int>(kind, x, buf, rows, dst_rows, n, ld,
                                       ncols, vstride, n_vec, true, stream,
                                       nullptr);
}

int launch_f64(int kind, void* x, void* buf, const void* rows,
               const void* dst_rows, int64_t n, int64_t ld, int ncols,
               int64_t vstride, int n_vec, void* stream) {
  return dispatch<double, unsigned long long>(kind, x, buf, rows, dst_rows,
                                              n, ld, ncols, vstride, n_vec,
                                              true, stream, nullptr);
}

}  // namespace

extern "C" {

// x[v * vstride + dst[i] * ld + c] = x[v * vstride + src[i] * ld + c] for
// i < n, c < ncols, v < n_vec (n >= 1). No src row may equal a dst row.
int uspmv_halo_exchange_f32(void* x, const void* src, const void* dst,
                            int64_t n, int64_t ld, int ncols,
                            int64_t vstride, int n_vec, void* stream) {
  return launch_f32(kExchange, x, nullptr, src, dst, n, ld, ncols, vstride,
                    n_vec, stream);
}

int uspmv_halo_exchange_f64(void* x, const void* src, const void* dst,
                            int64_t n, int64_t ld, int ncols,
                            int64_t vstride, int n_vec, void* stream) {
  return launch_f64(kExchange, x, nullptr, src, dst, n, ld, ncols, vstride,
                    n_vec, stream);
}

// buf[(i * n_vec + v) * ncols + c] = x[v * vstride + src[i] * ld + c] for
// i < n, c < ncols, v < n_vec (n >= 1); x and buf do not overlap.
int uspmv_halo_pack_f32(void* x, void* buf, const void* src, int64_t n,
                        int64_t ld, int ncols, int64_t vstride, int n_vec,
                        void* stream) {
  return launch_f32(kPack, x, buf, src, nullptr, n, ld, ncols, vstride,
                    n_vec, stream);
}

int uspmv_halo_pack_f64(void* x, void* buf, const void* src, int64_t n,
                        int64_t ld, int ncols, int64_t vstride, int n_vec,
                        void* stream) {
  return launch_f64(kPack, x, buf, src, nullptr, n, ld, ncols, vstride,
                    n_vec, stream);
}

// x[v * vstride + dst[i] * ld + c] = buf[(i * n_vec + v) * ncols + c] for
// i < n, c < ncols, v < n_vec (n >= 1); no dst row repeats.
int uspmv_halo_unpack_f32(void* x, void* buf, const void* dst, int64_t n,
                          int64_t ld, int ncols, int64_t vstride, int n_vec,
                          void* stream) {
  return launch_f32(kUnpack, x, buf, dst, nullptr, n, ld, ncols, vstride,
                    n_vec, stream);
}

int uspmv_halo_unpack_f64(void* x, void* buf, const void* dst, int64_t n,
                          int64_t ld, int ncols, int64_t vstride, int n_vec,
                          void* stream) {
  return launch_f64(kUnpack, x, buf, dst, nullptr, n, ld, ncols, vstride,
                    n_vec, stream);
}

// The geometry a launch of these arguments takes on the current device,
// without launching: kind 0 exchange (rows: src, dst_rows: dst), 1 pack
// (rows: src), 2 unpack (rows: dst); itemsize 4 or 8. out[7]: threads,
// unit bytes, units per row, grid x, grid y, SMs, blocks per SM.
int uspmv_halo_geometry(int kind, int itemsize, void* x, void* buf,
                        const void* rows, const void* dst_rows, int64_t n,
                        int64_t ld, int ncols, int64_t vstride, int n_vec,
                        int64_t* out) {
  if (itemsize == 4) {
    return dispatch<float, unsigned int>(kind, x, buf, rows, dst_rows, n, ld,
                                         ncols, vstride, n_vec, false,
                                         nullptr, out);
  }
  if (itemsize == 8) {
    return dispatch<double, unsigned long long>(kind, x, buf, rows, dst_rows,
                                                n, ld, ncols, vstride, n_vec,
                                                false, nullptr, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
