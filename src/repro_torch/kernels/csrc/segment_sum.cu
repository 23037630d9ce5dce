// Sorted GROUP BY SUM (K3) as a three-pass segmented scan, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/segment_sum.py
// (segment_sum_pallas / _segment_sum_kernel).  Over key-sorted
// (keys, values) of length n it writes
//     sums[i]  = total of the run of equal keys that ends at row i, if row i
//                is the LAST row of its run, else 0
//     valid[i] = row i is the last row of its run (the end of the array
//                always ends a run)
// The TPU kernel walks the blocks in grid order and carries the sum of a run
// that spans blocks in an SMEM scalar.  A CUDA grid runs its blocks in no
// order, so the carry becomes a pass of its own:
//
//   1. tile_scan: one block per 1024-row tile, staged through shared memory
//      with coalesced loads.  Each thread scans its 4 rows (restarting at run
//      starts), the block scans the 256 thread aggregates with warp shuffles
//      under the segmented operator (s1,f1)+(s2,f2) = (f2 ? s2 : s1+s2,
//      f1|f2), and writes sums and valid as if no run entered the tile from
//      the left.  It also writes the tile's aggregate (sum since its last run
//      start, or of the whole tile) and the offset of its first run start.
//   2. tile_carry: one block scans the tile aggregates in tile order into
//      the carry that enters each tile from the left.
//   3. fix_up: rows before a tile's first run start continue the carried
//      run, and only the last of them can be a run's last row, so one thread
//      per tile adds the carry to that one row if it is valid.
//
// int32 values add in uint32: wrap-around addition is associative, so the
// result equals the reference bit for bit whatever the order.  float32 sums
// are taken in another order than the reference's and differ in rounding.
//
// Bound on an H100 (3.35 TB/s): the bytes the function must move, 13*n
// (keys and values read, sums written, valid written as one byte); the tile
// aggregates add 12 bytes per 1024 rows.  The wrapper allocates them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kCarryThreads = 1024;

template <typename T> struct Acc;
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<float> { using T = float; };

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
    A os = __shfl_up_sync(0xffffffffu, s.sum, off);
    int of = __shfl_up_sync(0xffffffffu, s.flag, off);
    if (lane >= off) s = combine(Seg<A>{os, of}, s);
  }
  return s;
}

// exclusive scan of one Seg per thread over the block; the block total goes
// to *total.  wsum/wflag hold one entry per warp.
template <typename A, int kBlockWarps>
__device__ __forceinline__ Seg<A> block_exclusive(Seg<A> s, A* wsum, int* wflag,
                                                  Seg<A>* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg<A> incl = warp_scan(s, lane);
  A ps = __shfl_up_sync(0xffffffffu, incl.sum, 1);
  int pf = __shfl_up_sync(0xffffffffu, incl.flag, 1);
  Seg<A> excl = lane == 0 ? Seg<A>{A(0), 0} : Seg<A>{ps, pf};
  if (lane == 31) {
    wsum[warp] = incl.sum;
    wflag[warp] = incl.flag;
  }
  __syncthreads();
  Seg<A> before{A(0), 0};
  for (int w = 0; w < warp; ++w) before = combine(before, Seg<A>{wsum[w], wflag[w]});
  Seg<A> all{A(0), 0};
  for (int w = 0; w < kBlockWarps; ++w) all = combine(all, Seg<A>{wsum[w], wflag[w]});
  *total = all;
  __syncthreads();  // wsum/wflag may be reused after return
  return combine(before, excl);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_scan(const int32_t* __restrict__ keys, const T* __restrict__ vals,
          long long n, T* __restrict__ sums, bool* __restrict__ valid,
          typename Acc<T>::T* __restrict__ tile_agg,
          int32_t* __restrict__ tile_first) {
  using A = typename Acc<T>::T;
  __shared__ int32_t skeys[kTile + 2];  // skeys[j + 1] = keys[base + j]
  __shared__ A svals[kTile];
  __shared__ A wsum[kWarps];
  __shared__ int wflag[kWarps];
  __shared__ int first;

  const long long base = (long long)blockIdx.x * kTile;
  const int t = threadIdx.x;
  for (int j = t; j < kTile; j += kThreads) {
    const long long i = base + j;
    skeys[j + 1] = i < n ? keys[i] : 0;
    svals[j] = i < n ? (A)vals[i] : A(0);
  }
  if (t == 0) {
    skeys[0] = base > 0 ? keys[base - 1] : 0;
    first = kTile;
  }
  if (t == 1) skeys[kTile + 1] = base + kTile < n ? keys[base + kTile] : 0;
  __syncthreads();

  A incl[kItems];
  bool last[kItems];
  A run = A(0);
  int tflag = 0, tfirst = kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t * kItems + k;
    const long long i = base + j;
    const bool in = i < n;
    const bool start = in && (i == 0 || skeys[j] != skeys[j + 1]);
    last[k] = in && (i == n - 1 || skeys[j + 1] != skeys[j + 2]);
    if (start) {
      run = svals[j];
      if (!tflag) tfirst = j;
      tflag = 1;
    } else {
      run = run + svals[j];
    }
    incl[k] = run;
  }
  if (tflag) atomicMin(&first, tfirst);

  Seg<A> total;
  const Seg<A> prefix =
      block_exclusive<A, kWarps>(Seg<A>{run, tflag}, wsum, wflag, &total);
  bool started = false;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t * kItems + k;
    const long long i = base + j;
    started = started || (tflag && j >= tfirst);
    const A v = started ? incl[k] : prefix.sum + incl[k];
    if (i < n) {
      sums[i] = last[k] ? (T)v : T(0);
      valid[i] = last[k];
    }
  }
  __syncthreads();  // `first` is final
  if (t == 0) {
    tile_agg[blockIdx.x] = total.sum;
    tile_first[blockIdx.x] = first;
  }
}

// carry[b] = sum of the run that enters tile b from the left (exclusive
// segmented scan of the tile aggregates), for nt tiles, in one block.
template <typename A>
__global__ void __launch_bounds__(kCarryThreads)
tile_carry(const A* __restrict__ tile_agg, const int32_t* __restrict__ tile_first,
           long long nt, A* __restrict__ carry) {
  constexpr int kW = kCarryThreads / 32;
  __shared__ A wsum[kW];
  __shared__ int wflag[kW];
  Seg<A> running{A(0), 0};
  for (long long c = 0; c < nt; c += kCarryThreads) {
    const long long b = c + threadIdx.x;
    Seg<A> s{A(0), 0};
    if (b < nt) s = Seg<A>{tile_agg[b], tile_first[b] < kTile};
    Seg<A> total;
    const Seg<A> excl = block_exclusive<A, kW>(s, wsum, wflag, &total);
    if (b < nt) carry[b] = combine(running, excl).sum;
    running = combine(running, total);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fix_up(long long n, long long nt, const int32_t* __restrict__ tile_first,
       const typename Acc<T>::T* __restrict__ carry, T* __restrict__ sums,
       const bool* __restrict__ valid) {
  using A = typename Acc<T>::T;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nt || b == 0) return;  // row 0 always starts a run
  const int f = tile_first[b];
  if (f == 0) return;             // the tile starts with a run start
  const long long base = b * kTile;
  long long r;
  if (f < kTile) {
    r = base + f - 1;             // always the last row of the carried run
  } else {
    r = base + kTile < n ? base + kTile - 1 : n - 1;
  }
  if (valid[r]) sums[r] = (T)((A)sums[r] + carry[b]);
}

template <typename T>
int run(const void* keys, const void* vals, long long n, void* sums,
        void* valid, void* tile_agg, void* tile_first, void* carry,
        cudaStream_t stream) {
  using A = typename Acc<T>::T;
  if (n <= 0) return (int)cudaGetLastError();
  const long long nt = (n + kTile - 1) / kTile;
  if (nt > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  tile_scan<T><<<(unsigned)nt, kThreads, 0, stream>>>(
      (const int32_t*)keys, (const T*)vals, n, (T*)sums, (bool*)valid,
      (A*)tile_agg, (int32_t*)tile_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nt == 1) return (int)err;
  tile_carry<A><<<1, kCarryThreads, 0, stream>>>(
      (const A*)tile_agg, (const int32_t*)tile_first, nt, (A*)carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fix_up<T><<<(unsigned)((nt + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      n, nt, (const int32_t*)tile_first, (const A*)carry, (T*)sums,
      (const bool*)valid);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: int32[n], sorted.  vals and sums: vdtype 0 = int32, 1 = float32.
// valid: bool[n].  tile_agg and carry: ceil(n/tile) of the accumulator type
// (uint32 or float32), tile_first: ceil(n/tile) int32, tile = 1024 rows.
// Returns cudaGetLastError().
extern "C" int repro_segment_sum(const void* keys, const void* vals,
                                 long long n, void* sums, void* valid,
                                 void* tile_agg, void* tile_first, void* carry,
                                 int vdtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vdtype == 0)
    return run<int32_t>(keys, vals, n, sums, valid, tile_agg, tile_first, carry, s);
  if (vdtype == 1)
    return run<float>(keys, vals, n, sums, valid, tile_agg, tile_first, carry, s);
  return (int)cudaErrorInvalidValue;
}
