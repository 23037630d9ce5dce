// FreqJoin (K2) and semi-join (K1) as one two-phase hash join, for sm_90a.
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
//   1. build: one thread per child row.  Rows that cannot contribute are
//      skipped (cf == 0 for sum, cf <= 0 for any).  The rest claim a slot of
//      an open-addressing table (linear probing, 2^ceil(log2(2*Nc)) slots, so
//      the load factor stays <= 1/2 and every probe ends) with atomicCAS,
//      and in sum mode atomicAdd their frequency into the slot's value.
//      Every int32 value is a key (hash-combined keys, int32 max for dead
//      rows), so no key value can mark an empty slot: slots are 64-bit,
//      hold the zero-extended key, and are empty when all bits are set.
//      In any mode the presence of a key is the answer, so no value array.
//   2. probe: one thread per parent row walks the probe sequence to its key
//      or to an empty slot and writes pf[i] * mult_i.
//
// int32 frequencies accumulate and multiply in uint32, which wraps exactly
// as the reference's int32 arithmetic does (signed overflow is undefined in
// C++); float32 sums use atomicAdd, so their rounding order varies.
//
// Bound on an H100 (3.35 TB/s): the bytes the function must move,
// 8*Nc (ck, cf read) + 12*Np (pk, pf read, out written).  The table is
// touched only at slots of contributing keys; at the slice's sizes those
// lines stay in the 50 MB L2.  The wrapper allocates and clears the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

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

template <typename F, bool kAny>
__global__ void __launch_bounds__(kThreads)
build(const int32_t* __restrict__ ck, const F* __restrict__ cf, long long nc,
      unsigned long long* __restrict__ slot_keys,
      typename Acc<F>::T* __restrict__ slot_vals, uint32_t mask) {
  using A = typename Acc<F>::T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nc;
       j += stride) {
    const F f = cf[j];
    if (kAny ? !(f > F(0)) : !(f != F(0))) continue;
    const uint32_t k = (uint32_t)ck[j];
    const unsigned long long key = k;
    uint32_t h = mix32(k) & mask;
    while (true) {
      // a slot changes once, from empty to its key, so a stale plain read
      // can only be "empty", and the CAS then returns the real content
      unsigned long long cur = slot_keys[h];
      if (cur == kEmpty) {
        cur = atomicCAS(&slot_keys[h], kEmpty, key);
        if (cur == kEmpty) break;
      }
      if (cur == key) break;
      h = (h + 1) & mask;
    }
    if (!kAny) atomicAdd(&slot_vals[h], (A)f);
  }
}

template <typename F, bool kAny>
__global__ void __launch_bounds__(kThreads)
probe(const int32_t* __restrict__ pk, const F* __restrict__ pf, long long np,
      const unsigned long long* __restrict__ slot_keys,
      const typename Acc<F>::T* __restrict__ slot_vals, uint32_t mask,
      F* __restrict__ out) {
  using A = typename Acc<F>::T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < np;
       i += stride) {
    const uint32_t k = (uint32_t)pk[i];
    const unsigned long long key = k;
    uint32_t h = mix32(k) & mask;
    A mult = A(0);
    while (true) {
      const unsigned long long cur = slot_keys[h];
      if (cur == key) {
        mult = kAny ? A(1) : slot_vals[h];
        break;
      }
      if (cur == kEmpty) break;
      h = (h + 1) & mask;
    }
    out[i] = (F)times((A)pf[i], mult);
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <typename F, bool kAny>
int run(const void* pk, const void* pf, long long np, const void* ck,
        const void* cf, long long nc, void* slot_keys, void* slot_vals,
        long long slots, void* out, cudaStream_t stream) {
  using A = typename Acc<F>::T;
  const uint32_t mask = (uint32_t)(slots - 1);
  if (nc > 0) {
    build<F, kAny><<<blocks_for(nc), kThreads, 0, stream>>>(
        (const int32_t*)ck, (const F*)cf, nc, (unsigned long long*)slot_keys,
        (A*)slot_vals, mask);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (np > 0) {
    probe<F, kAny><<<blocks_for(np), kThreads, 0, stream>>>(
        (const int32_t*)pk, (const F*)pf, np,
        (const unsigned long long*)slot_keys, (const A*)slot_vals, mask,
        (F*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 = sum (FreqJoin), 1 = any (semi-join).  fdtype: 0 = int32,
// 1 = float32; pf, cf and out share it.  slots is a power of two > nc;
// slot_keys holds `slots` all-ones uint64, slot_vals `slots` zeros of the
// accumulator type (unused in any mode).  Returns cudaGetLastError().
extern "C" int repro_hash_join(const void* pk, const void* pf, long long np,
                               const void* ck, const void* cf, long long nc,
                               void* slot_keys, void* slot_vals,
                               long long slots, void* out, int mode,
                               int fdtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (slots < 2 || (slots & (slots - 1)) != 0 || slots > (1ll << 32))
    return (int)cudaErrorInvalidValue;
  if (fdtype == 0) {
    return mode == 1
        ? run<int32_t, true>(pk, pf, np, ck, cf, nc, slot_keys, slot_vals, slots, out, s)
        : run<int32_t, false>(pk, pf, np, ck, cf, nc, slot_keys, slot_vals, slots, out, s);
  }
  if (fdtype == 1) {
    return mode == 1
        ? run<float, true>(pk, pf, np, ck, cf, nc, slot_keys, slot_vals, slots, out, s)
        : run<float, false>(pk, pf, np, ck, cf, nc, slot_keys, slot_vals, slots, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
