// FreqJoin (K2) and semi-join (K1) as one hash join, for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/freq_join.py
// (freq_join_pallas / _freq_join_kernel) and src/repro/kernels/semi_join.py
// (semi_join_pallas / _semi_join_kernel).  Both compute, for every parent
// row i,
//     mult_i = sum over child rows j with ck[j] == pk[i] of cf[j]   (sum)
//     mult_i = [some child row j has ck[j] == pk[i] and cf[j] > 0]   (any)
//     out_i  = pf[i] * mult_i
// The TPU kernels broadcast-compare every parent block with every child
// block, O(Np*Nc) compares, because a TPU has no fast scattered atomics.  At
// TPC-H SF10 sizes that is 10^13 compares for one edge.  A Hopper card has
// fast L2 atomics, so this is a hash join: O(Np + Nc) work.
//
// The table is an open-addressing hash table with linear probing over the
// keys of the build side, 2^ceil(log2(f*N)) slots for a build side of N
// rows, f >= 2 the host's slot factor (load factor <= 1/f, so every probe
// ends; f = 2 by default).  The host picks the path from the two lengths
// and its KernelConfig (kernels/autotune.py), which also sets the threads
// per block:
//
//   child side  (a child longer than the host's shared-path limit,
//       KernelConfig.shared_max_rows, and no longer than the parent):
//       contributing child rows (cf != 0 for sum, cf > 0 for any) claim
//       slots and, in sum mode, atomicAdd their frequency; parent rows
//       then probe their key.  Launches: fill, build, probe.
//   parent side (a parent shorter than such a child): parent keys claim
//       slots; child rows stream through and add their frequency (sum) or
//       set a flag (any) in the slot of their key, if it is there; parent
//       rows then read their slot.  Exact for both semirings and for
//       repeated parent keys.  Launches: fill, build, probe, gather.
//   shared      (a child within that limit, whatever the parent's length;
//       its table must fit kSharedBytes): one launch; every block builds
//       the child's table in shared memory and probes its stripe of
//       parent rows.
//
// Two layouts, one template over the slot's word W, chosen by the width of
// the frequencies:
//
//   narrow (int32 keys, int32/float32 frequencies): W = uint32, a slot is
//       one 8-byte word {uint32 key, uint32 or float value};
//   wide   (int32 or int64 keys, int64/float64 frequencies, the JAX
//       package's x64 setting): W = uint64, a slot is 16 bytes {uint64 key,
//       uint64 or double value}.  int32 keys (an edge with no join
//       variables) are sign-extended as they are read, so no wrapper pass
//       widens them.  int64 keys with 32-bit frequencies are refused.
//
// In any mode on the child side a slot is a bare key (presence is the
// answer).  The all-ones key marks an empty slot.  The one key with those
// bits, -1, never enters the table: it has a side slot at index `slots`,
// past the last table slot, which every kernel tests before hashing.  The
// empty test reads only the key, so no value, wrapped or not, can make an
// occupied slot look empty.  On the child side in any mode the side slot's
// word stays all-ones until a live child row with key -1 clears it.  A key
// is hashed in its full width (murmur3's fmix32 or fmix64) and compared in
// its full width, so keys equal in their low 32 bits (k and k + 2^32) are
// different keys in the wide layout.  The probe runs after the build's
// launch ends, so it reads keys and values plainly.
//
// The fill kernel clears the table with one 16-byte pattern before any
// build thread runs; the table lives only for the call (the wrapper
// allocates it with torch.empty).
//
// Integer frequencies accumulate and multiply in uint32 or uint64, which
// wrap exactly as the reference's int32 or int64 arithmetic does (signed
// overflow is undefined in C++); float sums use atomicAdd (float, or the
// native double atomicAdd of sm_60 and later), so their rounding order
// varies.
//
// Bound on an H100 (3.35 TB/s): the bytes the function must move, each
// child row's key and frequency read and each parent row's key and
// frequency read and output written: 8*Nc + 12*Np narrow, 16*Nc + 24*Np
// wide with int64 keys.  A table of the shorter side stays in the 50 MB L2
// at the main path's sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using u64 = unsigned long long;

constexpr uint32_t kAbsent = 0xFFFFFFFFu;  // lookup result: key not there
// Threads per block, a template parameter T of every kernel: 128, 256 (the
// default) or 512, picked by the host's `threads` argument.  The grid's
// caps hold the threads in flight constant: 132 * 32 blocks of 256 threads
// for a grid-strided pass, 132 * 8 of 256 for the shared path, whose every
// block builds the whole child table.
constexpr long long kMaxThreads = 132ll * 32 * 256;
constexpr long long kSharedMaxThreads = 132ll * 8 * 256;
constexpr long long kSharedBytes = 48 * 1024;  // a block's, without opt-in

enum Side { kChild = 0, kParent = 1, kShared = 2 };
enum Phase { kFill = 1, kBuild = 2, kProbe = 4, kGather = 8 };

template <typename F> struct Acc;
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<float> { using T = float; };
template <> struct Acc<long long> { using T = u64; };
template <> struct Acc<double> { using T = double; };

// the slot's word: a key, or a value's bits
template <typename F>
using Word = std::conditional_t<sizeof(F) == 4, uint32_t, u64>;

template <typename W>
__device__ __forceinline__ constexpr W empty_key() { return ~W(0); }

// A key as the table holds it: sign-extended to the word's width.
template <typename W, typename K>
__device__ __forceinline__ W as_key(K k) {
  return (W)(std::make_signed_t<W>)k;
}

// The home slot of a key (before the mask): murmur3's finalisers, so
// sequential keys spread over the whole table and, for 64-bit keys, every
// bit of the key reaches the low 32 bits that pick the slot.
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t mix(u64 x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  x ^= x >> 33;
  return (uint32_t)x;
}

__device__ __forceinline__ uint32_t times(uint32_t a, uint32_t b) { return a * b; }
__device__ __forceinline__ float times(float a, float b) { return a * b; }
__device__ __forceinline__ u64 times(u64 a, u64 b) { return a * b; }
__device__ __forceinline__ double times(double a, double b) { return a * b; }

__device__ __forceinline__ void add(uint32_t* p, uint32_t v) { atomicAdd(p, v); }
__device__ __forceinline__ void add(uint32_t* p, float v) {
  atomicAdd(reinterpret_cast<float*>(p), v);
}
__device__ __forceinline__ void add(u64* p, u64 v) { atomicAdd(p, v); }
__device__ __forceinline__ void add(u64* p, double v) {
  atomicAdd(reinterpret_cast<double*>(p), v);
}

template <typename A> __device__ __forceinline__ A from_bits(Word<A> b);
template <> __device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) {
  return b;
}
template <> __device__ __forceinline__ float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ u64 from_bits<u64>(u64 b) { return b; }
template <> __device__ __forceinline__ double from_bits<double>(u64 b) {
  return __longlong_as_double((long long)b);
}

// One load of a pair slot {key, value}: 8 bytes narrow, 16 bytes wide.
__device__ __forceinline__ void load_pair(const uint32_t* t, uint32_t h,
                                          uint32_t& key, uint32_t& val) {
  const u64 cur = reinterpret_cast<const u64*>(t)[h];
  key = (uint32_t)cur;
  val = (uint32_t)(cur >> 32);
}
__device__ __forceinline__ void load_pair(const u64* t, uint32_t h, u64& key,
                                          u64& val) {
  const ulonglong2 cur = reinterpret_cast<const ulonglong2*>(t)[h];
  key = cur.x;
  val = cur.y;
}

template <typename F, bool kAny>
__device__ __forceinline__ bool contributes(F f) {
  return kAny ? f > F(0) : f != F(0);
}

// Word index of slot h's key; its value, in the pair layout, follows it.
template <bool kPair, typename W>
__device__ __forceinline__ W* key_at(W* t, uint32_t h) {
  return kPair ? t + 2 * (size_t)h : t + h;
}

// The slot of key k (k != -1), claimed if it is not in the table yet.
template <bool kPair, typename W>
__device__ __forceinline__ uint32_t claim(W* t, uint32_t mask, W k) {
  uint32_t h = mix(k) & mask;
  while (true) {
    // a key changes once, from empty to its key, so a stale plain read can
    // only be "empty", and the CAS then returns the real content
    W cur = *key_at<kPair>(t, h);
    if (cur == empty_key<W>()) {
      cur = atomicCAS(key_at<kPair>(t, h), empty_key<W>(), k);
      if (cur == empty_key<W>()) return h;
    }
    if (cur == k) return h;
    h = (h + 1) & mask;
  }
}

// The slot of key k (k != -1), or kAbsent.  Called once the table is built.
template <bool kPair, typename W>
__device__ __forceinline__ uint32_t find(const W* t, uint32_t mask, W k) {
  uint32_t h = mix(k) & mask;
  while (true) {
    const W cur = *key_at<kPair>(const_cast<W*>(t), h);
    if (cur == k) return h;
    if (cur == empty_key<W>()) return kAbsent;
    h = (h + 1) & mask;
  }
}

// mult for key k from a built table, with the side slot at mask + 1.
// kPair: the value holds the sum (sum) or a 0/1 flag (any); else the table
// holds bare keys and presence is the answer (any only).  In the pair
// layout one load brings key and value together.
template <typename A, bool kAny, bool kPair, typename W>
__device__ __forceinline__ A lookup(const W* t, uint32_t mask, W k) {
  const uint32_t side = mask + 1;
  if (!kPair) {
    const bool there = k == empty_key<W>()
                           ? t[side] != empty_key<W>()
                           : find<false>(t, mask, k) != kAbsent;
    return there ? A(1) : A(0);
  }
  W bits = 0;
  if (k == empty_key<W>()) {
    bits = t[2 * (size_t)side + 1];
  } else {
    uint32_t h = mix(k) & mask;
    while (true) {
      W key, val;
      load_pair(t, h, key, val);
      if (key == k) {
        bits = val;
        break;
      }
      if (key == empty_key<W>()) break;
      h = (h + 1) & mask;
    }
  }
  if (kAny) return bits != 0 ? A(1) : A(0);
  return from_bits<A>(bits);
}

// Child side, one child row into the table: any mode keeps bare keys
// (pair layout off), sum mode adds the frequency into the slot's value.
template <typename F, bool kAny>
__device__ __forceinline__ void insert_child(Word<F>* t, uint32_t mask,
                                             Word<F> k, F f) {
  using A = typename Acc<F>::T;
  using W = Word<F>;
  if (!contributes<F, kAny>(f)) return;
  const uint32_t side = mask + 1;
  if (kAny) {
    if (k == empty_key<W>()) t[side] = 0;
    else claim<false>(t, mask, k);
    return;
  }
  const uint32_t h = k == empty_key<W>() ? side : claim<true>(t, mask, k);
  add(t + 2 * (size_t)h + 1, (A)f);
}

template <typename F, bool kAny, bool kPair>
__device__ __forceinline__ F parent_out(const Word<F>* t, uint32_t mask,
                                        Word<F> k, F pf) {
  using A = typename Acc<F>::T;
  return (F)times((A)pf, lookup<A, kAny, kPair>(t, mask, k));
}

#define GRID_STRIDE(i, n)                                                  \
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;     \
       i < (n); i += (long long)gridDim.x * blockDim.x)

template <int T>
__global__ void __launch_bounds__(T)
fill(uint4* __restrict__ t, long long n16, uint4 pattern) {
  GRID_STRIDE(i, n16) t[i] = pattern;
}

template <int T, typename K, typename F, bool kAny>
__global__ void __launch_bounds__(T)
build_child(const K* __restrict__ ck, const F* __restrict__ cf, long long nc,
            Word<F>* __restrict__ t, uint32_t mask) {
  GRID_STRIDE(j, nc)
      insert_child<F, kAny>(t, mask, as_key<Word<F>>(ck[j]), cf[j]);
}

// Child side's probe and parent side's gather: one parent row each.
template <int T, typename K, typename F, bool kAny, bool kPair>
__global__ void __launch_bounds__(T)
probe_parent(const K* __restrict__ pk, const F* __restrict__ pf, long long np,
             const Word<F>* __restrict__ t, uint32_t mask,
             F* __restrict__ out) {
  GRID_STRIDE(i, np)
      out[i] = parent_out<F, kAny, kPair>(t, mask, as_key<Word<F>>(pk[i]),
                                          pf[i]);
}

template <int T, typename K, typename W>
__global__ void __launch_bounds__(T)
build_parent(const K* __restrict__ pk, long long np, W* __restrict__ t,
             uint32_t mask) {
  GRID_STRIDE(i, np) {
    const W k = as_key<W>(pk[i]);
    if (k != empty_key<W>()) claim<true>(t, mask, k);
  }
}

template <int T, typename K, typename F, bool kAny>
__global__ void __launch_bounds__(T)
probe_child(const K* __restrict__ ck, const F* __restrict__ cf, long long nc,
            Word<F>* __restrict__ t, uint32_t mask) {
  using A = typename Acc<F>::T;
  using W = Word<F>;
  GRID_STRIDE(j, nc) {
    const F f = cf[j];
    const W k = as_key<W>(ck[j]);   // both loads in flight at once
    if (!contributes<F, kAny>(f)) continue;
    const uint32_t h = k == empty_key<W>() ? mask + 1 : find<true>(t, mask, k);
    if (h == kAbsent) continue;
    W* v = t + 2 * (size_t)h + 1;
    if (!kAny) add(v, (A)f);
    else if (*v == 0) *v = 1;   // a racing store writes the same 1
  }
}

// One launch: each block builds the whole child (its table fits
// kSharedBytes) in its shared memory, then probes a grid-strided stripe of
// parent rows.
template <int T, typename K, typename F, bool kAny>
__global__ void __launch_bounds__(T)
shared_join(const K* __restrict__ pk, const F* __restrict__ pf, long long np,
            const K* __restrict__ ck, const F* __restrict__ cf, long long nc,
            uint32_t mask, F* __restrict__ out) {
  using W = Word<F>;
  extern __shared__ __align__(16) uint32_t shared_table[];
  W* st = reinterpret_cast<W*>(shared_table);
  constexpr bool kPair = !kAny;
  const uint32_t words = (kPair ? 2u : 1u) * (mask + 2);
  for (uint32_t w = threadIdx.x; w < words; w += blockDim.x)
    st[w] = (kPair && (w & 1)) ? W(0) : empty_key<W>();
  __syncthreads();
  for (long long j = threadIdx.x; j < nc; j += blockDim.x)
    insert_child<F, kAny>(st, mask, as_key<W>(ck[j]), cf[j]);
  __syncthreads();
  GRID_STRIDE(i, np)
      out[i] = parent_out<F, kAny, kPair>(st, mask, as_key<W>(pk[i]), pf[i]);
}

template <int T>
int blocks_for(long long n, long long max_threads = kMaxThreads) {
  const long long cap = max_threads / T;
  long long b = (n + T - 1) / T;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

// uint32 words of the table: (slots + 1 for the side slot) slots of one or
// two (pair) words of 4 (narrow) or 8 (wide) bytes, rounded up to whole
// 16-byte fill stores.
long long table_words(long long slots, bool pair, bool wide) {
  const long long w = (pair ? 2 : 1) * (wide ? 2 : 1) * (slots + 1);
  return (w + 3) & ~3ll;
}

template <int T, typename K, typename F, bool kAny>
int run(const K* pk, const F* pf, long long np, const K* ck, const F* cf,
        long long nc, void* table, long long slots, F* out, int side,
        int phases, cudaStream_t s) {
  using W = Word<F>;
  constexpr bool kWide = sizeof(W) == 8;
  const uint32_t mask = (uint32_t)(slots - 1);
  W* t = (W*)table;
  if (side == kShared) {
    const size_t smem = 4 * (size_t)table_words(slots, !kAny, kWide);
    if (np > 0)
      shared_join<T, K, F, kAny><<<blocks_for<T>(np, kSharedMaxThreads), T,
                                   smem, s>>>(pk, pf, np, ck, cf, nc, mask,
                                              out);
    return (int)cudaGetLastError();
  }
  const bool pair = !kAny || side == kParent;
  if (phases & kFill) {
    const long long n16 = table_words(slots, pair, kWide) / 4;
    constexpr uint32_t e = 0xFFFFFFFFu;
    // narrow pairs: two slots {e, 0} a store; wide pairs: one {e e, 0 0}
    const uint4 pattern = !pair ? make_uint4(e, e, e, e)
                          : kWide ? make_uint4(e, e, 0u, 0u)
                                  : make_uint4(e, 0u, e, 0u);
    fill<T><<<blocks_for<T>(n16), T, 0, s>>>((uint4*)table, n16, pattern);
  }
  if (side == kChild) {
    if ((phases & kBuild) && nc > 0)
      build_child<T, K, F, kAny><<<blocks_for<T>(nc), T, 0, s>>>(ck, cf, nc,
                                                                  t, mask);
    if ((phases & kProbe) && np > 0)
      probe_parent<T, K, F, kAny, !kAny><<<blocks_for<T>(np), T, 0, s>>>(
          pk, pf, np, t, mask, out);
  } else {
    if ((phases & kBuild) && np > 0)
      build_parent<T, K, W><<<blocks_for<T>(np), T, 0, s>>>(pk, np, t, mask);
    if ((phases & kProbe) && nc > 0)
      probe_child<T, K, F, kAny><<<blocks_for<T>(nc), T, 0, s>>>(ck, cf, nc,
                                                                  t, mask);
    if ((phases & kGather) && np > 0)
      probe_parent<T, K, F, kAny, true><<<blocks_for<T>(np), T, 0, s>>>(
          pk, pf, np, t, mask, out);
  }
  return (int)cudaGetLastError();
}

template <int T, typename K, typename F>
int run_mode(int mode, const void* pk, const void* pf, long long np,
             const void* ck, const void* cf, long long nc, void* table,
             long long slots, void* out, int side, int phases,
             cudaStream_t s) {
  const K *kp = (const K*)pk, *kc = (const K*)ck;
  const F *fp = (const F*)pf, *fc = (const F*)cf;
  F* o = (F*)out;
  return mode == 1
      ? run<T, K, F, true>(kp, fp, np, kc, fc, nc, table, slots, o, side,
                           phases, s)
      : run<T, K, F, false>(kp, fp, np, kc, fc, nc, table, slots, o, side,
                            phases, s);
}

template <typename K, typename F>
int run_threads(int threads, int mode, const void* pk, const void* pf,
                long long np, const void* ck, const void* cf, long long nc,
                void* table, long long slots, void* out, int side, int phases,
                cudaStream_t s) {
  switch (threads) {
    case 128:
      return run_mode<128, K, F>(mode, pk, pf, np, ck, cf, nc, table, slots,
                                 out, side, phases, s);
    case 512:
      return run_mode<512, K, F>(mode, pk, pf, np, ck, cf, nc, table, slots,
                                 out, side, phases, s);
    default:
      return run_mode<256, K, F>(mode, pk, pf, np, ck, cf, nc, table, slots,
                                 out, side, phases, s);
  }
}

}  // namespace

// mode: 0 = sum (FreqJoin), 1 = any (semi-join).  kdtype: 0 = int32,
// 1 = int64; pk and ck share it.  fdtype: 0 = int32, 1 = float32,
// 2 = int64, 3 = float64; pf, cf and out share it.  int64 keys take only
// 64-bit frequencies.  side: 0 child, 1 parent, 2 shared.  slots: a power
// of two >= 2 and >= 2 * (rows of the build side); on the shared side the
// table (4 * table_words(slots, sum mode, wide) bytes, wide = 64-bit
// frequencies) must fit kSharedBytes.  table: the wrapper's scratch of
// table_len uint32 words, 16-byte aligned, at least table_words(slots,
// pair, wide), where pair = sum mode or the parent side (unused on the
// shared side).  A table or a shared table out of those bounds, or a
// dtype pair it does not take, is refused with cudaErrorInvalidValue.
// phases: a mask of 1 fill, 2 build, 4 probe, 8 gather (parent side), so
// that a caller can time the phases one by one; 15 runs the join.
// threads: threads per block of every launch, 128, 256 or 512 (others are
// refused).  Returns cudaGetLastError().
extern "C" int repro_hash_join(const void* pk, const void* pf, long long np,
                               const void* ck, const void* cf, long long nc,
                               void* table, long long table_len,
                               long long slots, void* out, int mode,
                               int kdtype, int fdtype, int side, int phases,
                               int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long build_rows = side == kParent ? np : nc;
  if (slots < 2 || (slots & (slots - 1)) != 0 || slots > (1ll << 31) ||
      slots < 2 * build_rows || side < kChild || side > kShared ||
      mode < 0 || mode > 1 || fdtype < 0 || fdtype > 3 || kdtype < 0 ||
      kdtype > 1 || (kdtype == 1 && fdtype < 2) ||
      (threads != 128 && threads != 256 && threads != 512))
    return (int)cudaErrorInvalidValue;
  const bool wide = fdtype >= 2;
  if (side == kShared
          ? 4 * table_words(slots, mode == 0, wide) > kSharedBytes
          : table_len < table_words(slots, mode == 0 || side == kParent, wide))
    return (int)cudaErrorInvalidValue;
#define REPRO_RUN(K, F)                                                    \
  run_threads<K, F>(threads, mode, pk, pf, np, ck, cf, nc, table, slots, out, \
                    side, phases, s)
  if (kdtype == 0) {
    switch (fdtype) {
      case 0: return REPRO_RUN(int32_t, int32_t);
      case 1: return REPRO_RUN(int32_t, float);
      case 2: return REPRO_RUN(int32_t, long long);
      default: return REPRO_RUN(int32_t, double);
    }
  }
  return fdtype == 2 ? REPRO_RUN(long long, long long)
                     : REPRO_RUN(long long, double);
#undef REPRO_RUN
}
