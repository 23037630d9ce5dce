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
// keys of the build side, 2^ceil(log2(2*N)) slots for a build side of N
// rows (load factor <= 1/2, so every probe ends).  The host picks the path
// from the two lengths:
//
//   child side  (a child longer than the host's shared-path limit,
//       SHARED_MAX_ROWS in freq_join.py, and no longer than the parent):
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
// A slot is one 8-byte word {uint32 key, uint32 or float value}, or in any
// mode on the child side a bare uint32 key (presence is the answer).  The
// key half 0xFFFFFFFF marks an empty slot.  The one int32 key with those
// bits, -1, never enters the table: it has a side slot at index `slots`,
// past the last table slot, which every kernel tests before hashing.  The
// empty test reads only the key half, so no value, wrapped or not, can make
// an occupied slot look empty.  On the child side in any mode the side
// slot's word stays all-ones until a live child row with key -1 clears it.
//
// The fill kernel clears the table with one 16-byte pattern before any
// build thread runs; the table lives only for the call (the wrapper
// allocates it with torch.empty).
//
// int32 frequencies accumulate and multiply in uint32, which wraps exactly
// as the reference's int32 arithmetic does (signed overflow is undefined in
// C++); float32 sums use atomicAdd, so their rounding order varies.
//
// Bound on an H100 (3.35 TB/s): the bytes the function must move,
// 8*Nc (ck, cf read) + 12*Np (pk, pf read, out written).  A table of the
// shorter side stays in the 50 MB L2 at the main path's sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;   // key half of an empty slot
constexpr uint32_t kAbsent = 0xFFFFFFFFu;  // lookup result: key not there
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;
constexpr long long kSharedMaxBlocks = 132 * 8;
constexpr long long kSharedBytes = 48 * 1024;  // a block's, without opt-in

enum Side { kChild = 0, kParent = 1, kShared = 2 };
enum Phase { kFill = 1, kBuild = 2, kProbe = 4, kGather = 8 };

template <typename F> struct Acc;
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<float> { using T = float; };

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  // murmur3 finaliser: sequential keys spread over the whole table
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t times(uint32_t a, uint32_t b) { return a * b; }
__device__ __forceinline__ float times(float a, float b) { return a * b; }

__device__ __forceinline__ void add(uint32_t* p, uint32_t v) { atomicAdd(p, v); }
__device__ __forceinline__ void add(uint32_t* p, float v) {
  atomicAdd(reinterpret_cast<float*>(p), v);
}

template <typename A> __device__ __forceinline__ A from_bits(uint32_t b);
template <> __device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) {
  return b;
}
template <> __device__ __forceinline__ float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}

template <typename F, bool kAny>
__device__ __forceinline__ bool contributes(F f) {
  return kAny ? f > F(0) : f != F(0);
}

// Word index of slot h's key; its value, in the pair layout, follows it.
template <bool kPair>
__device__ __forceinline__ uint32_t* key_at(uint32_t* t, uint32_t h) {
  return kPair ? t + 2 * (size_t)h : t + h;
}

// The slot of key k (k != -1), claimed if it is not in the table yet.
template <bool kPair>
__device__ __forceinline__ uint32_t claim(uint32_t* t, uint32_t mask,
                                          uint32_t k) {
  uint32_t h = mix32(k) & mask;
  while (true) {
    // a key half changes once, from empty to its key, so a stale plain
    // read can only be "empty", and the CAS then returns the real content
    uint32_t cur = *key_at<kPair>(t, h);
    if (cur == kEmpty) {
      cur = atomicCAS(key_at<kPair>(t, h), kEmpty, k);
      if (cur == kEmpty) return h;
    }
    if (cur == k) return h;
    h = (h + 1) & mask;
  }
}

// The slot of key k (k != -1), or kAbsent.  Called once the table is built.
template <bool kPair>
__device__ __forceinline__ uint32_t find(const uint32_t* t, uint32_t mask,
                                         uint32_t k) {
  uint32_t h = mix32(k) & mask;
  while (true) {
    const uint32_t cur = *key_at<kPair>(const_cast<uint32_t*>(t), h);
    if (cur == k) return h;
    if (cur == kEmpty) return kAbsent;
    h = (h + 1) & mask;
  }
}

// mult for key k from a built table, with the side slot at mask + 1.
// kPair: the value half holds the sum (sum) or a 0/1 flag (any); else the
// table holds bare keys and presence is the answer (any only).  In the pair
// layout one 8-byte load brings key and value together.
template <typename A, bool kAny, bool kPair>
__device__ __forceinline__ A lookup(const uint32_t* t, uint32_t mask,
                                    uint32_t k) {
  const uint32_t side = mask + 1;
  if (!kPair) {
    const bool there = k == kEmpty ? t[side] != kEmpty
                                   : find<false>(t, mask, k) != kAbsent;
    return there ? A(1) : A(0);
  }
  uint32_t bits = 0;
  if (k == kEmpty) {
    bits = t[2 * (size_t)side + 1];
  } else {
    const unsigned long long* w = reinterpret_cast<const unsigned long long*>(t);
    uint32_t h = mix32(k) & mask;
    while (true) {
      const unsigned long long cur = w[h];
      const uint32_t key = (uint32_t)cur;
      if (key == k) {
        bits = (uint32_t)(cur >> 32);
        break;
      }
      if (key == kEmpty) break;
      h = (h + 1) & mask;
    }
  }
  if (kAny) return bits != 0 ? A(1) : A(0);
  return from_bits<A>(bits);
}

// Child side, one child row into the table: any mode keeps bare keys
// (pair layout off), sum mode adds the frequency into the slot's value.
template <typename F, bool kAny>
__device__ __forceinline__ void insert_child(uint32_t* t, uint32_t mask,
                                             uint32_t k, F f) {
  using A = typename Acc<F>::T;
  if (!contributes<F, kAny>(f)) return;
  const uint32_t side = mask + 1;
  if (kAny) {
    if (k == kEmpty) t[side] = 0;
    else claim<false>(t, mask, k);
    return;
  }
  const uint32_t h = k == kEmpty ? side : claim<true>(t, mask, k);
  add(t + 2 * (size_t)h + 1, (A)f);
}

template <typename F, bool kAny, bool kPair>
__device__ __forceinline__ F parent_out(const uint32_t* t, uint32_t mask,
                                        uint32_t k, F pf) {
  using A = typename Acc<F>::T;
  return (F)times((A)pf, lookup<A, kAny, kPair>(t, mask, k));
}

#define GRID_STRIDE(i, n)                                                  \
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;     \
       i < (n); i += (long long)gridDim.x * blockDim.x)

__global__ void __launch_bounds__(kThreads)
fill(uint4* __restrict__ t, long long n16, uint4 pattern) {
  GRID_STRIDE(i, n16) t[i] = pattern;
}

template <typename F, bool kAny>
__global__ void __launch_bounds__(kThreads)
build_child(const int32_t* __restrict__ ck, const F* __restrict__ cf,
            long long nc, uint32_t* __restrict__ t, uint32_t mask) {
  GRID_STRIDE(j, nc) insert_child<F, kAny>(t, mask, (uint32_t)ck[j], cf[j]);
}

// Child side's probe and parent side's gather: one parent row each.
template <typename F, bool kAny, bool kPair>
__global__ void __launch_bounds__(kThreads)
probe_parent(const int32_t* __restrict__ pk, const F* __restrict__ pf,
             long long np, const uint32_t* __restrict__ t, uint32_t mask,
             F* __restrict__ out) {
  GRID_STRIDE(i, np)
      out[i] = parent_out<F, kAny, kPair>(t, mask, (uint32_t)pk[i], pf[i]);
}

__global__ void __launch_bounds__(kThreads)
build_parent(const int32_t* __restrict__ pk, long long np,
             uint32_t* __restrict__ t, uint32_t mask) {
  GRID_STRIDE(i, np) {
    const uint32_t k = (uint32_t)pk[i];
    if (k != kEmpty) claim<true>(t, mask, k);
  }
}

template <typename F, bool kAny>
__global__ void __launch_bounds__(kThreads)
probe_child(const int32_t* __restrict__ ck, const F* __restrict__ cf,
            long long nc, uint32_t* __restrict__ t, uint32_t mask) {
  using A = typename Acc<F>::T;
  GRID_STRIDE(j, nc) {
    const F f = cf[j];
    const uint32_t k = (uint32_t)ck[j];   // both loads in flight at once
    if (!contributes<F, kAny>(f)) continue;
    const uint32_t h = k == kEmpty ? mask + 1 : find<true>(t, mask, k);
    if (h == kAbsent) continue;
    uint32_t* v = t + 2 * (size_t)h + 1;
    if (!kAny) add(v, (A)f);
    else if (*v == 0) *v = 1;   // a racing store writes the same 1
  }
}

// One launch: each block builds the whole child (its table fits
// kSharedBytes) in its shared memory, then probes a grid-strided stripe of
// parent rows.
template <typename F, bool kAny>
__global__ void __launch_bounds__(kThreads)
shared_join(const int32_t* __restrict__ pk, const F* __restrict__ pf,
            long long np, const int32_t* __restrict__ ck,
            const F* __restrict__ cf, long long nc, uint32_t mask,
            F* __restrict__ out) {
  extern __shared__ uint32_t st[];
  constexpr bool kPair = !kAny;
  const uint32_t words = (kPair ? 2u : 1u) * (mask + 2);
  for (uint32_t w = threadIdx.x; w < words; w += blockDim.x)
    st[w] = (kPair && (w & 1)) ? 0u : kEmpty;
  __syncthreads();
  for (long long j = threadIdx.x; j < nc; j += blockDim.x)
    insert_child<F, kAny>(st, mask, (uint32_t)ck[j], cf[j]);
  __syncthreads();
  GRID_STRIDE(i, np)
      out[i] = parent_out<F, kAny, kPair>(st, mask, (uint32_t)pk[i], pf[i]);
}

int blocks_for(long long n, long long cap = kMaxBlocks) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

// uint32 words of the table: (slots + 1 for the side slot) slots of one or
// two words, rounded up to whole 16-byte fill stores.
long long table_words(long long slots, bool pair) {
  const long long w = (pair ? 2 : 1) * (slots + 1);
  return (w + 3) & ~3ll;
}

template <typename F, bool kAny>
int run(const int32_t* pk, const F* pf, long long np, const int32_t* ck,
        const F* cf, long long nc, uint32_t* t, long long slots, F* out,
        int side, int phases, cudaStream_t s) {
  const uint32_t mask = (uint32_t)(slots - 1);
  if (side == kShared) {
    const size_t smem = 4 * (size_t)table_words(slots, !kAny);
    if (np > 0)
      shared_join<F, kAny><<<blocks_for(np, kSharedMaxBlocks), kThreads,
                             smem, s>>>(pk, pf, np, ck, cf, nc, mask, out);
    return (int)cudaGetLastError();
  }
  const bool pair = !kAny || side == kParent;
  if (phases & kFill) {
    const long long n16 = table_words(slots, pair) / 4;
    const uint4 pattern = pair ? make_uint4(kEmpty, 0u, kEmpty, 0u)
                               : make_uint4(kEmpty, kEmpty, kEmpty, kEmpty);
    fill<<<blocks_for(n16), kThreads, 0, s>>>((uint4*)t, n16, pattern);
  }
  if (side == kChild) {
    if ((phases & kBuild) && nc > 0)
      build_child<F, kAny><<<blocks_for(nc), kThreads, 0, s>>>(ck, cf, nc, t,
                                                                mask);
    if ((phases & kProbe) && np > 0)
      probe_parent<F, kAny, !kAny><<<blocks_for(np), kThreads, 0, s>>>(
          pk, pf, np, t, mask, out);
  } else {
    if ((phases & kBuild) && np > 0)
      build_parent<<<blocks_for(np), kThreads, 0, s>>>(pk, np, t, mask);
    if ((phases & kProbe) && nc > 0)
      probe_child<F, kAny><<<blocks_for(nc), kThreads, 0, s>>>(ck, cf, nc, t,
                                                                mask);
    if ((phases & kGather) && np > 0)
      probe_parent<F, kAny, true><<<blocks_for(np), kThreads, 0, s>>>(
          pk, pf, np, t, mask, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 = sum (FreqJoin), 1 = any (semi-join).  fdtype: 0 = int32,
// 1 = float32; pf, cf and out share it.  side: 0 child, 1 parent, 2 shared.
// slots: a power of two >= 2 and >= 2 * (rows of the build side); on the
// shared side the table (4 * table_words(slots, sum mode) bytes) must fit
// kSharedBytes.  table: the wrapper's scratch of table_len uint32 words,
// 16-byte aligned, at least table_words(slots, pair), where pair = sum mode
// or the parent side (unused on the shared side).  A table or a shared
// table out of those bounds is refused with cudaErrorInvalidValue.
// phases: a mask of 1 fill, 2 build, 4 probe, 8 gather (parent side), so
// that a caller can time the phases one by one; 15 runs the join.
// Returns cudaGetLastError().
extern "C" int repro_hash_join(const void* pk, const void* pf, long long np,
                               const void* ck, const void* cf, long long nc,
                               void* table, long long table_len,
                               long long slots, void* out,
                               int mode, int fdtype, int side, int phases,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long build_rows = side == kParent ? np : nc;
  if (slots < 2 || (slots & (slots - 1)) != 0 || slots > (1ll << 31) ||
      slots < 2 * build_rows || side < kChild || side > kShared ||
      mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  if (side == kShared ? 4 * table_words(slots, mode == 0) > kSharedBytes
                      : table_len < table_words(slots, mode == 0 ||
                                                side == kParent))
    return (int)cudaErrorInvalidValue;
  const int32_t* k_p = (const int32_t*)pk;
  const int32_t* k_c = (const int32_t*)ck;
  uint32_t* t = (uint32_t*)table;
  if (fdtype == 0) {
    const int32_t *fp = (const int32_t*)pf, *fc = (const int32_t*)cf;
    int32_t* o = (int32_t*)out;
    return mode == 1
        ? run<int32_t, true>(k_p, fp, np, k_c, fc, nc, t, slots, o, side, phases, s)
        : run<int32_t, false>(k_p, fp, np, k_c, fc, nc, t, slots, o, side, phases, s);
  }
  if (fdtype == 1) {
    const float *fp = (const float*)pf, *fc = (const float*)cf;
    float* o = (float*)out;
    return mode == 1
        ? run<float, true>(k_p, fp, np, k_c, fc, nc, t, slots, o, side, phases, s)
        : run<float, false>(k_p, fp, np, k_c, fc, nc, t, slots, o, side, phases, s);
  }
  return (int)cudaErrorInvalidValue;
}
