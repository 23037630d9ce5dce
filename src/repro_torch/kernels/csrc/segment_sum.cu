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
// Bound on an H100 (3.35 TB/s): the bytes the function must move, 13 per
// row (keys and values read, sums written, 4 B each; valid written as one
// byte).  The tile states add 12 bytes per kTile rows.
//
// What the design does about the faults of the three-pass version it
// replaces (tile scan, a one-block carry scan over all tiles, a fix-up):
//
//   1. One launch.  A block takes its tile from an atomic counter, so every
//      tile it waits on has started and the look-back cannot deadlock.  It
//      scans its tile to a segmented aggregate (sum since the tile's last
//      run start, or of the whole tile; flag = a run starts in the tile) and
//      publishes it in a 64-bit state word {status, value} with one release
//      store.  A tile whose flag is set holds its own carry-out, so it
//      publishes "prefix" (P) at once; a tile with no run start publishes
//      "aggregate" (A), and its carry-out (P) once its look-back ends.  The
//      carry that enters a tile changes one row at most: the run end before
//      its first run start (in a tile with no run start, its last row).  So
//      every warp writes its rows at once, and only the warp that holds that
//      row (or, in a tile with no run start, the last warp) walks back, 32
//      predecessors a step with acquire loads, to the nearest P: for runs
//      shorter than a tile, the previous tile.  Then it rewrites that row.
//      A call of more than one tile clears its scratch (counter and states)
//      with one cudaMemsetAsync first; a call of one tile needs none.
//   2. 16-byte accesses.  Each of the 256 threads owns kItems consecutive
//      rows: keys and values load as int4 and sums store as int4, the
//      kItems valid bytes as one word.  Neighbour keys come from the next
//      lane by warp shuffles; lanes 0 and 31 load the one key before
//      and after their warp's rows (a cache hit but at the tile's edges).
//      A scalar path in the same kernel takes the ragged last tile and
//      base pointers that are not 16-byte aligned (a view at a storage
//      offset).
//   3. A lean host path: the wrapper allocates sums, valid and, above one
//      tile, one scratch tensor, whose length the C entry checks.
//
// Fixed combine order.  No value is ever added atomically.  The look-back
// finds the nearest P, then folds the aggregates of the tiles after it in
// tile order, left to right, onto P's value.  A P published by a tile with
// no run start was folded the same way, so whichever P a walk stops at, the
// carry is the same left fold from the tile where the run started: float32
// results are bitwise the same from run to run.  int32 values add in
// uint32, which wraps as the reference does; wrap-around addition is
// associative, so int32 results equal the reference bit for bit.  float32
// sums are taken in another order than the reference's and differ in
// rounding.
//
// Chosen on an H100 by a sweep of these constants (PERF.md, section 6):
// 256 threads of 8 rows at 6 blocks per SM, against 4 or 16 rows, 128 or
// 512 threads, and no or 8 blocks per SM.  Tried and dropped: a hand-over
// box per tile in which the carry and the row that needs it meet, written
// by whichever comes second, so that no warp waits on a predecessor.  It
// was slower on every case timed: the hand-over's acq_rel update drains
// the thread's row stores before it, where the look-back's release store
// comes before them.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // rows per thread: 4, 8 or 16
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
// blocks the compiler must fit on one SM: 6 caps a thread at 40 registers
constexpr int kMinBlocks = 6;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems == 4 || kItems == 8 || kItems == 16,
              "a thread's valid bytes are one 4-, 8- or 16-byte store");

// status in a tile state's high word; its low word holds the value's bits
constexpr uint32_t kAggregate = 1, kPrefix = 2;

template <typename T> struct Acc;
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<float> { using T = float; };

__device__ __forceinline__ uint32_t bits(uint32_t x) { return x; }
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
template <typename A> __device__ __forceinline__ A from_bits(uint32_t x);
template <> __device__ __forceinline__ uint32_t from_bits(uint32_t x) {
  return x;
}
template <> __device__ __forceinline__ float from_bits(uint32_t x) {
  return __uint_as_float(x);
}

using State = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
using Word = cuda::atomic_ref<uint32_t, cuda::thread_scope_device>;

// scratch layout, in uint32 words: [0] tile counter, [1] unused,
// [2, 2 + 2*nt) tile states (8-byte aligned), [2 + 2*nt, 2 + 3*nt) the
// aggregates of tiles with no run start.  Only counter and states need
// clearing.
long long scratch_words(long long nt) { return 2 + 3 * nt; }
long long cleared_words(long long nt) { return 2 + 2 * nt; }

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

__device__ __forceinline__ void publish(unsigned long long* states, int tile,
                                        uint32_t status, uint32_t value) {
  State(states[tile]).store(((unsigned long long)status << 32) | value,
                            cuda::memory_order_release);
}

// The carry that enters `tile` from the left: the sum of the run open at
// the end of tile - 1.  Run by all lanes of one warp; each returns it.
template <typename A>
__device__ A look_back(unsigned long long* states, uint32_t* aggs, int tile,
                       int lane) {
  // 1. the nearest predecessor q whose state is P: lane k reads tile w - k
  int q;
  uint32_t pq;
  for (int w = tile - 1;; w -= 32) {
    const int p = w - lane;
    unsigned long long s;
    unsigned ready, prefix;
    do {
      // tile 0 always holds a run start, so the walk finds a P at p >= 0
      s = p >= 0 ? State(states[p]).load(cuda::memory_order_acquire)
                 : (unsigned long long)kPrefix << 32;
      const uint32_t status = (uint32_t)(s >> 32);
      prefix = __ballot_sync(kFull, status == kPrefix);
      ready = __ballot_sync(kFull, status != 0);
      // wait only for the lanes up to the nearest P
    } while (~ready & (prefix ? (prefix ^ (prefix - 1)) : kFull));
    if (prefix) {
      const int k = __ffs(prefix) - 1;
      q = w - k;
      pq = __shfl_sync(kFull, (uint32_t)s, k);
      break;
    }
  }
  // 2. fold the aggregates of tiles q+1 .. tile-1 onto P, in tile order
  A carry = from_bits<A>(pq);
  for (int w = q + 1; w < tile; w += 32) {
    const int p = w + lane;
    A v = A(0);
    if (p < tile) {
      State(states[p]).load(cuda::memory_order_acquire);  // at least A
      v = from_bits<A>(Word(aggs[p]).load(cuda::memory_order_relaxed));
    }
    const int m = min(32, tile - w);
    for (int i = 0; i < m; ++i) carry = carry + __shfl_sync(kFull, v, i);
  }
  return carry;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_scan(const int32_t* __restrict__ keys, const T* __restrict__ vals,
             long long n, int aligned, T* __restrict__ sums,
             uint8_t* __restrict__ valid, uint32_t* __restrict__ scratch) {
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
  unsigned long long* states =
      multi ? (unsigned long long*)(scratch + 2) : nullptr;
  uint32_t* aggs = multi ? scratch + 2 + 2 * nt : nullptr;

  const long long base = (long long)tile * kTile;
  const long long row0 = base + (long long)t * kItems;
  const bool vec = aligned && base + kTile <= n;

  int32_t k[kItems];
  A v[kItems];
  if (vec) {
#pragma unroll
    for (int j = 0; j < kItems; j += 4) {
      const int4 kk = __ldg((const int4*)(keys + row0 + j));
      const int4 vv = __ldg((const int4*)(vals + row0 + j));
      k[j] = kk.x, k[j + 1] = kk.y, k[j + 2] = kk.z, k[j + 3] = kk.w;
      v[j] = from_bits<A>(vv.x), v[j + 1] = from_bits<A>(vv.y);
      v[j + 2] = from_bits<A>(vv.z), v[j + 3] = from_bits<A>(vv.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = row0 + j;
      k[j] = i < n ? keys[i] : 0;
      v[j] = i < n ? (A)vals[i] : A(0);
    }
  }
  // the keys just before and just after this thread's rows
  int32_t kprev = __shfl_up_sync(kFull, k[kItems - 1], 1);
  int32_t knext = __shfl_down_sync(kFull, k[0], 1);
  if (lane == 0) kprev = row0 > 0 && row0 <= n ? keys[row0 - 1] : 0;
  if (lane == 31) knext = row0 + kItems < n ? keys[row0 + kItems] : 0;

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
  if (multi && total.flag && t == 0)
    publish(states, tile, kPrefix, bits(total.sum));
  if (vec) {
    uint32_t vw[kItems / 4];
#pragma unroll
    for (int j = 0; j < kItems; j += 4) {
      *(uint4*)(sums + row0 + j) =
          make_uint4(bits(out[j]), bits(out[j + 1]), bits(out[j + 2]),
                     bits(out[j + 3]));
      vw[j / 4] = (uint32_t)last[j] | (uint32_t)last[j + 1] << 8 |
                  (uint32_t)last[j + 2] << 16 | (uint32_t)last[j + 3] << 24;
    }
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
  if (pub && lane == 0) {
    Word(aggs[tile]).store(bits(total.sum), cuda::memory_order_relaxed);
    publish(states, tile, kAggregate, bits(total.sum));
  }
  const A carry = look_back<A>(states, aggs, tile, lane);
  if (pub && lane == 0) publish(states, tile, kPrefix, bits(carry + total.sum));
  if (fix >= 0) sums[row0 + fix] = (T)(carry + fix_val);
}

template <typename T>
int run(const void* keys, const void* vals, long long n, void* sums,
        void* valid, uint32_t* scratch, cudaStream_t stream) {
  const long long nt = (n + kTile - 1) / kTile;
  const int aligned =
      ((uintptr_t)keys | (uintptr_t)vals | (uintptr_t)sums) % 16 == 0 &&
      (uintptr_t)valid % kItems == 0;
  if (nt > 1) {
    const cudaError_t err =
        cudaMemsetAsync(scratch, 0, 4 * cleared_words(nt), stream);
    if (err != cudaSuccess) return (int)err;
  }
  segment_scan<T><<<(unsigned)nt, kThreads, 0, stream>>>(
      (const int32_t*)keys, (const T*)vals, n, aligned, (T*)sums,
      (uint8_t*)valid, nt > 1 ? scratch : nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: int32[n], sorted.  vals and sums: vdtype 0 = int32, 1 = float32.
// valid: bool[n].  tile: the caller's rows per tile, which must be kTile.
// scratch: scratch_len uint32 words, at least 2 + 3*ceil(n/tile) when n >
// tile (the C entry clears what it needs), unused (may be null) when n <=
// tile.  Launches nothing for n <= 0.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile, scratch or vdtype it does not take.
extern "C" int repro_segment_sum(const void* keys, const void* vals,
                                 long long n, void* sums, void* valid,
                                 void* scratch, long long scratch_len,
                                 int tile, int vdtype, void* stream) {
  if (tile != kTile || (vdtype != 0 && vdtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const long long nt = (n + kTile - 1) / kTile;
  if (nt > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (nt > 1 && (scratch == nullptr || scratch_len < scratch_words(nt)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* w = (uint32_t*)scratch;
  if (vdtype == 0) return run<int32_t>(keys, vals, n, sums, valid, w, s);
  return run<float>(keys, vals, n, sums, valid, w, s);
}
