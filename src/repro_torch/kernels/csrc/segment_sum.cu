// Sorted GROUP BY SUM (K3) as one single-pass segmented scan with
// decoupled look-back, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/segment_sum.py
// (segment_sum_pallas / _segment_sum_kernel).  Over key-sorted
// (keys, values) of length n it writes
//     sums[i]  = total of the run of equal keys that ends at row i, if row i
//                is the LAST row of its run, else 0
//     valid[i] = row i is the last row of its run (the end of the array
//                always ends a run)
// The TPU kernel walks the blocks in grid order and carries the sum of a
// run that spans blocks in an SMEM scalar.  Here every block scans one tile
// of kTile rows and learns the carry that enters it from its predecessors'
// published states, in the same launch.
//
// Keys are int32 (run ids, or packed keys) or int64 (packed keys in the
// JAX package's x64 setting); values int32, float32, int64 or float64.
//
// Bound on an H100 (3.35 TB/s): the bytes the function must move, per row
// the key and the value read, the sum written and one valid byte: 13 bytes
// for int32 keys and values, 25 for int64 keys and 64-bit values.  The
// tile states add 12 bytes per kTile rows (20 for 64-bit values).
//
// What the design does about the faults of the three-pass version it
// replaces (tile scan, a one-block carry scan over all tiles, a fix-up):
//
//   1. One launch.  A block takes its tile from an atomic counter, so every
//      tile it waits on has started and the look-back cannot deadlock.  It
//      scans its tile to a segmented aggregate (sum since the tile's last
//      run start, or of the whole tile; flag = a run starts in the tile) and
//      publishes it with one release store.  A tile whose flag is set holds
//      its own carry-out, so it publishes "prefix" (P) at once; a tile with
//      no run start publishes "aggregate" (A), and its carry-out (P) once
//      its look-back ends.  The carry that enters a tile changes one row at
//      most: the run end before its first run start (in a tile with no run
//      start, its last row).  So every warp writes its rows at once, and
//      only the warp that holds that row (or, in a tile with no run start,
//      the last warp) walks back, 32 predecessors a step with acquire loads,
//      to the nearest P: for runs shorter than a tile, the previous tile.
//      Then it rewrites that row.  A call of more than one tile clears its
//      scratch (counter and statuses) with one cudaMemsetAsync first; a
//      call of one tile needs none.
//   2. 16-byte accesses.  Each of the 256 threads owns kItems consecutive
//      rows: keys and values load, and sums store, as 16-byte vectors of 4
//      rows of 4 bytes or 2 rows of 8, the kItems valid bytes as one word.
//      Neighbour keys come from the next lane by warp shuffles; lanes 0 and
//      31 load the one key before and after their warp's rows (a cache hit
//      but at the tile's edges).  A scalar path in the same kernel takes the
//      ragged last tile and base pointers that are not 16-byte aligned (a
//      view at a storage offset).
//   3. A lean host path: the wrapper allocates sums, valid and, above one
//      tile, one scratch tensor, whose length the C entry checks.
//
// A tile's state.  For 32-bit values it is one 64-bit word {status, value}
// (NarrowTiles), published with one release store.  A 64-bit value does not
// fit beside its status in one atomic word, so for 64-bit values each tile
// has a 32-bit status and two 64-bit values, its aggregate and its
// inclusive prefix (WideTiles): a tile stores the value first, then the
// status with release, and a reader acquire-loads the status, then reads
// the value that status names.  Each value is written once, before its
// status, so a reader never sees a value from a later publication.
//
// Fixed combine order.  No value is ever added atomically.  The look-back
// finds the nearest P, then folds the aggregates of the tiles after it in
// tile order, left to right, onto P's value.  A P published by a tile with
// no run start was folded the same way, so whichever P a walk stops at, the
// carry is the same left fold from the tile where the run started: float32
// and float64 results are bitwise the same from run to run.  int32 and
// int64 values add in uint32 and uint64, which wrap as the reference does;
// wrap-around addition is associative, so integer results equal the
// reference bit for bit.  Float sums are taken in another order than the
// reference's and differ in rounding.
//
// Chosen on an H100 by a sweep of these constants for int32 keys and
// values (PERF.md, section 6): 256 threads of 8 rows at 6 blocks per SM,
// against 4 or 16 rows, 128 or 512 threads, and no or 8 blocks per SM.
// Instances with a 64-bit key or value hold twice the registers for their
// rows and ask for 3 blocks per SM.  That default and three other instances
// (below) are what the kernel tuner measures per shape bucket.  Tried and
// dropped: a hand-over box per tile in which the carry and the row that
// needs it meet, written by whichever comes second, so that no warp waits
// on a predecessor.  It was slower on every case timed: the hand-over's
// acq_rel update drains the thread's row stores before it, where the
// look-back's release store comes before them.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The instances: rows per thread kItems (4, 8 or 16; a tile is kThreads *
// kItems rows) and the blocks the compiler must fit on one SM, kMinBlocks
// for 32-bit keys and values (6 caps a thread at 40 registers) and half as
// many, at least 1, for the instances with a 64-bit key or value, which hold
// twice the registers for their rows (3: 85 registers).  The default is
// (8, 6); the C entry takes the others the kernel tuner may pick
// (KernelConfig.seg_items, .seg_min_blocks in kernels/autotune.py).
template <int kMinBlocks, typename K, typename T>
constexpr int min_blocks() {
  return sizeof(K) + sizeof(T) == 8 ? kMinBlocks
                                    : (kMinBlocks / 2 > 0 ? kMinBlocks / 2 : 1);
}

// a tile's status; 0 = nothing published yet
constexpr uint32_t kAggregate = 1, kPrefix = 2;

template <typename T> struct Acc;
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<float> { using T = float; };
template <> struct Acc<long long> { using T = u64; };
template <> struct Acc<double> { using T = double; };

// the raw bits of a 4- or 8-byte value
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, u64>;

__device__ __forceinline__ uint32_t bits(uint32_t x) { return x; }
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ u64 bits(u64 x) { return x; }
__device__ __forceinline__ u64 bits(double x) {
  return (u64)__double_as_longlong(x);
}
template <typename A> __device__ __forceinline__ A from_bits(Bits<A> x);
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t x) {
  return (int32_t)x;
}
template <> __device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t x) {
  return x;
}
template <> __device__ __forceinline__ float from_bits<float>(uint32_t x) {
  return __uint_as_float(x);
}
template <> __device__ __forceinline__ long long from_bits<long long>(u64 x) {
  return (long long)x;
}
template <> __device__ __forceinline__ u64 from_bits<u64>(u64 x) { return x; }
template <> __device__ __forceinline__ double from_bits<double>(u64 x) {
  return __longlong_as_double((long long)x);
}

// R out[16 / sizeof(T)] from one 16-byte load at p (16-byte aligned), where
// R has T's width: the row's key (R = T) or its value's accumulator.
template <typename R, typename T>
__device__ __forceinline__ void load16(const T* p, R* out) {
  if constexpr (sizeof(T) == 4) {
    const int4 w = __ldg((const int4*)p);
    out[0] = from_bits<R>((uint32_t)w.x), out[1] = from_bits<R>((uint32_t)w.y);
    out[2] = from_bits<R>((uint32_t)w.z), out[3] = from_bits<R>((uint32_t)w.w);
  } else {
    const longlong2 w = __ldg((const longlong2*)p);
    out[0] = from_bits<R>((u64)w.x), out[1] = from_bits<R>((u64)w.y);
  }
}

// one 16-byte store of 16 / sizeof(A) accumulators at p (16-byte aligned)
template <typename T, typename A>
__device__ __forceinline__ void store16(T* p, const A* v) {
  if constexpr (sizeof(A) == 4) {
    *(uint4*)p = make_uint4(bits(v[0]), bits(v[1]), bits(v[2]), bits(v[3]));
  } else {
    *(ulonglong2*)p = make_ulonglong2(bits(v[0]), bits(v[1]));
  }
}

using State = cuda::atomic_ref<u64, cuda::thread_scope_device>;
using Word = cuda::atomic_ref<uint32_t, cuda::thread_scope_device>;
using Word64 = cuda::atomic_ref<u64, cuda::thread_scope_device>;

// Scratch layouts, in uint32 words (the C entry checks the length; only the
// counter and the states or statuses need clearing):
//   narrow (32-bit values): [0] tile counter, [1] unused, [2, 2 + 2*nt)
//     tile states (8-byte aligned), [2 + 2*nt, 2 + 3*nt) the aggregates of
//     tiles with no run start;
//   wide (64-bit values): [0] tile counter, [1] unused, [2, 2 + nt) tile
//     statuses, padded to an even word h, then [h, h + 2*nt) the tiles'
//     inclusive prefixes and [h + 2*nt, h + 4*nt) their aggregates, 64-bit.
__host__ __device__ long long wide_header(long long nt) {
  return (2 + nt + 1) & ~1ll;
}
long long scratch_words(long long nt, bool wide) {
  return wide ? wide_header(nt) + 4 * nt : 2 + 3 * nt;
}
long long cleared_words(long long nt, bool wide) {
  return wide ? 2 + nt : 2 + 2 * nt;
}

struct NarrowTiles {
  u64* states;
  uint32_t* aggs;
  __device__ NarrowTiles(uint32_t* scratch, long long nt)
      : states(scratch ? (u64*)(scratch + 2) : nullptr),
        aggs(scratch ? scratch + 2 + 2 * nt : nullptr) {}
  __device__ void publish(int tile, uint32_t status, uint32_t value) {
    State(states[tile]).store(((u64)status << 32) | value,
                              cuda::memory_order_release);
  }
  __device__ void publish_prefix(int tile, uint32_t value) {
    publish(tile, kPrefix, value);
  }
  __device__ void publish_aggregate(int tile, uint32_t value) {
    Word(aggs[tile]).store(value, cuda::memory_order_relaxed);
    publish(tile, kAggregate, value);
  }
  // tile p's status, acquired, and in `prefix` its value when that is P
  __device__ uint32_t status(int p, uint32_t& prefix) {
    const u64 s = State(states[p]).load(cuda::memory_order_acquire);
    prefix = (uint32_t)s;
    return (uint32_t)(s >> 32);
  }
  // the aggregate of tile p, whose status is at least A
  __device__ uint32_t aggregate(int p) {
    State(states[p]).load(cuda::memory_order_acquire);
    return Word(aggs[p]).load(cuda::memory_order_relaxed);
  }
};

struct WideTiles {
  uint32_t* statuses;
  u64* prefixes;
  u64* aggs;
  __device__ WideTiles(uint32_t* scratch, long long nt)
      : statuses(scratch ? scratch + 2 : nullptr),
        prefixes(scratch ? (u64*)(scratch + wide_header(nt)) : nullptr),
        aggs(scratch ? (u64*)(scratch + wide_header(nt)) + nt : nullptr) {}
  __device__ void publish_prefix(int tile, u64 value) {
    Word64(prefixes[tile]).store(value, cuda::memory_order_relaxed);
    Word(statuses[tile]).store(kPrefix, cuda::memory_order_release);
  }
  __device__ void publish_aggregate(int tile, u64 value) {
    Word64(aggs[tile]).store(value, cuda::memory_order_relaxed);
    Word(statuses[tile]).store(kAggregate, cuda::memory_order_release);
  }
  __device__ uint32_t status(int p, u64& prefix) {
    const uint32_t s = Word(statuses[p]).load(cuda::memory_order_acquire);
    prefix = s == kPrefix
                 ? Word64(prefixes[p]).load(cuda::memory_order_relaxed)
                 : 0;
    return s;
  }
  __device__ u64 aggregate(int p) {
    Word(statuses[p]).load(cuda::memory_order_acquire);
    return Word64(aggs[p]).load(cuda::memory_order_relaxed);
  }
};

template <typename A>
using Tiles = std::conditional_t<sizeof(A) == 4, NarrowTiles, WideTiles>;

template <typename A>
struct Seg {
  A sum;
  int flag;  // a run starts inside the span
};

// a is the span before b
template <typename A>
__device__ __forceinline__ Seg<A> combine(Seg<A> a, Seg<A> b) {
  return {b.flag ? b.sum : a.sum + b.sum, a.flag | b.flag};
}

// inclusive scan over the warp, lane order
template <typename A>
__device__ __forceinline__ Seg<A> warp_scan(Seg<A> s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const A os = __shfl_up_sync(kFull, s.sum, off);
    const int of = __shfl_up_sync(kFull, s.flag, off);
    if (lane >= off) s = combine(Seg<A>{os, of}, s);
  }
  return s;
}

// The carry that enters `tile` from the left: the sum of the run open at
// the end of tile - 1.  Run by all lanes of one warp; each returns it.
template <typename A>
__device__ A look_back(Tiles<A>& tiles, int tile, int lane) {
  // 1. the nearest predecessor q whose state is P: lane k reads tile w - k
  int q;
  Bits<A> pq;
  for (int w = tile - 1;; w -= 32) {
    const int p = w - lane;
    Bits<A> v;
    unsigned ready, prefix;
    do {
      // tile 0 always holds a run start, so the walk finds a P at p >= 0
      uint32_t status = kPrefix;
      v = 0;
      if (p >= 0) status = tiles.status(p, v);
      prefix = __ballot_sync(kFull, status == kPrefix);
      ready = __ballot_sync(kFull, status != 0);
      // wait only for the lanes up to the nearest P
    } while (~ready & (prefix ? (prefix ^ (prefix - 1)) : kFull));
    if (prefix) {
      const int k = __ffs(prefix) - 1;
      q = w - k;
      pq = __shfl_sync(kFull, v, k);
      break;
    }
  }
  // 2. fold the aggregates of tiles q+1 .. tile-1 onto P, in tile order
  A carry = from_bits<A>(pq);
  for (int w = q + 1; w < tile; w += 32) {
    const int p = w + lane;
    A v = A(0);
    if (p < tile) v = from_bits<A>(tiles.aggregate(p));  // status >= A
    const int m = min(32, tile - w);
    for (int i = 0; i < m; ++i) carry = carry + __shfl_sync(kFull, v, i);
  }
  return carry;
}

template <int kItems, int kMinBlocks, typename K, typename T>
__global__ void __launch_bounds__(kThreads, min_blocks<kMinBlocks, K, T>())
segment_scan(const K* __restrict__ keys, const T* __restrict__ vals,
             long long n, int aligned, T* __restrict__ sums,
             uint8_t* __restrict__ valid, uint32_t* __restrict__ scratch) {
  static_assert(kItems == 4 || kItems == 8 || kItems == 16,
                "a thread's valid bytes are one 4-, 8- or 16-byte store");
  constexpr int kTile = kThreads * kItems;
  using A = typename Acc<T>::T;
  __shared__ int s_tile;
  __shared__ A wsum[kWarps];
  __shared__ int wflag[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool multi = scratch != nullptr;
  if (t == 0) s_tile = multi ? (int)atomicAdd(scratch, 1u) : 0;
  __syncthreads();
  const int tile = s_tile;
  const long long nt = (n + kTile - 1) / kTile;
  Tiles<A> tiles(scratch, nt);

  const long long base = (long long)tile * kTile;
  const long long row0 = base + (long long)t * kItems;
  const bool vec = aligned && base + kTile <= n;

  K k[kItems];
  A v[kItems];
  if (vec) {
#pragma unroll
    for (int j = 0; j < kItems; j += 16 / sizeof(K))
      load16<K>(keys + row0 + j, k + j);
#pragma unroll
    for (int j = 0; j < kItems; j += 16 / sizeof(T))
      load16<A>(vals + row0 + j, v + j);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = row0 + j;
      k[j] = i < n ? keys[i] : K(0);
      v[j] = i < n ? (A)vals[i] : A(0);
    }
  }
  // the keys just before and just after this thread's rows
  K kprev = __shfl_up_sync(kFull, k[kItems - 1], 1);
  K knext = __shfl_down_sync(kFull, k[0], 1);
  if (lane == 0) kprev = row0 > 0 && row0 <= n ? keys[row0 - 1] : K(0);
  if (lane == 31) knext = row0 + kItems < n ? keys[row0 + kItems] : K(0);

  // run starts and run ends, and the scan of this thread's rows
  bool start[kItems], last[kItems];
  A incl[kItems];
  A run = A(0);
  int tflag = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = row0 + j;
    const bool in = i < n;
    start[j] = in && (i == 0 || k[j] != (j ? k[j - 1] : kprev));
    last[j] = in && (i == n - 1 ||
                     k[j] != (j + 1 < kItems ? k[j + 1] : knext));
    run = start[j] ? v[j] : run + v[j];
    tflag |= start[j];
    incl[j] = run;
  }

  // segmented exclusive scan of the thread aggregates over the block
  const Seg<A> winc = warp_scan(Seg<A>{run, tflag}, lane);
  const A xs = __shfl_up_sync(kFull, winc.sum, 1);
  const int xf = __shfl_up_sync(kFull, winc.flag, 1);
  Seg<A> prefix = lane == 0 ? Seg<A>{A(0), 0} : Seg<A>{xs, xf};
  if (lane == 31) {
    wsum[warp] = winc.sum;
    wflag[warp] = winc.flag;
  }
  __syncthreads();
  Seg<A> before{A(0), 0}, total{A(0), 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const Seg<A> ws{wsum[w], wflag[w]};
    if (w < warp) before = combine(before, ws);
    total = combine(total, ws);
  }
  prefix = combine(before, prefix);

  // Every row once, with the carry from the left left out: the one row
  // that needs it is the run end before the tile's first run start (or, in
  // a tile with no run start, its last row), if there is one.
  A out[kItems], fix_val = A(0);
  int fix = -1;
  bool seen = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    seen = seen || start[j];
    const A x = seen ? incl[j] : prefix.sum + incl[j];
    out[j] = last[j] ? x : A(0);
    if (last[j] && !seen && !prefix.flag) fix = j, fix_val = x;
  }
  if (multi && total.flag && t == 0) tiles.publish_prefix(tile, bits(total.sum));
  if (vec) {
    uint32_t vw[kItems / 4];
#pragma unroll
    for (int j = 0; j < kItems; j += 16 / sizeof(T))
      store16(sums + row0 + j, out + j);
#pragma unroll
    for (int j = 0; j < kItems; j += 4)
      vw[j / 4] = (uint32_t)last[j] | (uint32_t)last[j + 1] << 8 |
                  (uint32_t)last[j + 2] << 16 | (uint32_t)last[j + 3] << 24;
    if constexpr (kItems == 4) {
      *(uint32_t*)(valid + row0) = vw[0];
    } else if constexpr (kItems == 8) {
      *(uint2*)(valid + row0) = make_uint2(vw[0], vw[1]);
    } else {
      *(uint4*)(valid + row0) = make_uint4(vw[0], vw[1], vw[2], vw[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = row0 + j;
      if (i < n) {
        sums[i] = (T)out[j];
        valid[i] = last[j];
      }
    }
  }
  if (!multi) return;

  // One warp learns the carry: the warp that holds the row that needs it,
  // and in a tile with no run start that has a successor, the last warp,
  // which publishes the tile's aggregate first and its carry-out after.
  const bool pub = !total.flag && warp == kWarps - 1 && tile + 1 < nt;
  if (!__any_sync(kFull, fix >= 0) && !pub) return;
  if (pub && lane == 0) tiles.publish_aggregate(tile, bits(total.sum));
  const A carry = look_back<A>(tiles, tile, lane);
  if (pub && lane == 0) tiles.publish_prefix(tile, bits(carry + total.sum));
  if (fix >= 0) sums[row0 + fix] = (T)(carry + fix_val);
}

template <int kItems, int kMinBlocks, typename K, typename T>
int run(const void* keys, const void* vals, long long n, void* sums,
        void* valid, uint32_t* scratch, cudaStream_t stream) {
  constexpr int kTile = kThreads * kItems;
  const long long nt = (n + kTile - 1) / kTile;
  const int aligned =
      ((uintptr_t)keys | (uintptr_t)vals | (uintptr_t)sums) % 16 == 0 &&
      (uintptr_t)valid % kItems == 0;
  if (nt > 1) {
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, 4 * cleared_words(nt, sizeof(T) == 8), stream);
    if (err != cudaSuccess) return (int)err;
  }
  segment_scan<kItems, kMinBlocks, K, T><<<(unsigned)nt, kThreads, 0, stream>>>(
      (const K*)keys, (const T*)vals, n, aligned, (T*)sums, (uint8_t*)valid,
      nt > 1 ? scratch : nullptr);
  return (int)cudaGetLastError();
}

template <int I, int M, typename K>
int run_values(int vdtype, const void* keys, const void* vals, long long n,
               void* sums, void* valid, uint32_t* scratch,
               cudaStream_t stream) {
  switch (vdtype) {
    case 0: return run<I, M, K, int32_t>(keys, vals, n, sums, valid, scratch, stream);
    case 1: return run<I, M, K, float>(keys, vals, n, sums, valid, scratch, stream);
    case 2: return run<I, M, K, long long>(keys, vals, n, sums, valid, scratch, stream);
    default: return run<I, M, K, double>(keys, vals, n, sums, valid, scratch, stream);
  }
}

template <int I, int M>
int run_keys(int kdtype, int vdtype, const void* keys, const void* vals,
             long long n, void* sums, void* valid, uint32_t* scratch,
             cudaStream_t stream) {
  return kdtype == 0
      ? run_values<I, M, int32_t>(vdtype, keys, vals, n, sums, valid, scratch,
                                  stream)
      : run_values<I, M, long long>(vdtype, keys, vals, n, sums, valid,
                                    scratch, stream);
}

}  // namespace

// keys: sorted, kdtype 0 = int32, 1 = int64.  vals and sums: vdtype 0 =
// int32, 1 = float32, 2 = int64, 3 = float64.  valid: bool[n].  tile and
// min_blocks pick the instance: the caller's rows per tile, 256 * kItems,
// and kMinBlocks; the pairs (kItems, kMinBlocks) taken are (8, 6), the
// default, (4, 6), (16, 3) and (8, 4).  scratch: scratch_len uint32 words,
// at least scratch_words(ceil(n/tile), 64-bit values) when n > tile (the C
// entry clears what it needs), unused (may be null) when n <= tile.
// Launches nothing for n <= 0.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an instance, scratch, kdtype or vdtype it does
// not take.
extern "C" int repro_segment_sum(const void* keys, const void* vals,
                                 long long n, void* sums, void* valid,
                                 void* scratch, long long scratch_len,
                                 int tile, int min_blocks, int kdtype,
                                 int vdtype, void* stream) {
  const int items = tile / kThreads;
  const bool known = tile % kThreads == 0 &&
                     ((items == 8 && (min_blocks == 6 || min_blocks == 4)) ||
                      (items == 4 && min_blocks == 6) ||
                      (items == 16 && min_blocks == 3));
  if (!known || vdtype < 0 || vdtype > 3 || kdtype < 0 || kdtype > 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const long long nt = (n + tile - 1) / tile;
  if (nt > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (nt > 1 && (scratch == nullptr ||
                 scratch_len < scratch_words(nt, vdtype >= 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* w = (uint32_t*)scratch;
  switch (items * 100 + min_blocks) {
    case 406: return run_keys<4, 6>(kdtype, vdtype, keys, vals, n, sums, valid, w, s);
    case 804: return run_keys<8, 4>(kdtype, vdtype, keys, vals, n, sums, valid, w, s);
    case 1603: return run_keys<16, 3>(kdtype, vdtype, keys, vals, n, sums, valid, w, s);
    default: return run_keys<8, 6>(kdtype, vdtype, keys, vals, n, sums, valid, w, s);
  }
}
