// Probe against a build side of at most 256 rows (K2).
//
// Replaces nds_tpu/engine/kernels.py `matmul_probe_join`, which forms the
// (probe x build) one-hot equality matrix and contracts it in float32 against
// the build iota (for ridx) and against ones (for the match count). It writes
// exactly what the f32 products give:
//   ridx = min(max(sum of the matching valid build indices, 0), n_build - 1)
//   hit  = pok && (number of matching valid build rows > 0)
// including their behavior where the build holds duplicate valid keys (the
// sum of their indices). The sums stay below 2^15, where the f32 dot is exact.
//
// What bounds it on an H100: bytes. A probe of 6,001,215 rows moves 6.0M x
// (key 4 or 8 + ok 1 + ridx 4 + hit 1) bytes, about 60-84 MB, which is 18-25
// us at 3.35 TB/s; the function needs one lookup a probe row, whatever
// implements it. The first version walked all n_build staged rows for every
// probe row (1.5G compares at n_build = 256). Here each block builds a table
// in shared memory from the build rows, once: the grid is sized to the
// blocks the SMs hold at once, and each block then strides over chunks of
// probe rows. The table is a hash table, open addressing with linear steps
// over 2^bits >= 4 x n_build slots (kernels.matmul_probe_slots mirrors the
// hash). A slot holds one distinct valid key, the sum of the indices of the
// valid build rows with that key and their count, 16 bytes read at once. A
// thread takes one build row and claims a slot by atomicCAS of its row, or
// adds to the slot of an earlier row with its key; int64 keys are hashed
// from both halves and compared on all 64 bits.
// The probe's I/O is K1's (lane_rows.cuh): 16 rows a lane, 16-byte vector
// loads of the keys, whole-group loads and stores of the flags and outputs,
// streaming cache hints, the head and tail one row a thread.
//
// The entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_rows.cuh"

namespace {

using lane_rows::kRows;
using lane_rows::Plan;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuild = 256;  // one build row a thread
constexpr int kMaxSlots = 4 * kMaxBuild;
constexpr unsigned kHashMul = 0x9E3779B1u;
constexpr unsigned kHashMix = 0x85EBCA6Bu;

template <typename K>
struct Slot;
template <>
struct alignas(16) Slot<int32_t> {
  int32_t key;
  int32_t sum;
  int32_t cnt;
  int32_t pad;
};
template <>
struct alignas(16) Slot<int64_t> {
  int64_t key;
  int32_t sum;
  int32_t cnt;
};

__device__ __forceinline__ unsigned hash_key(int32_t k) {
  return static_cast<unsigned>(k) * kHashMul;
}

__device__ __forceinline__ unsigned hash_key(int64_t k) {
  const unsigned long long u = static_cast<unsigned long long>(k);
  return (static_cast<unsigned>(u) ^
          (static_cast<unsigned>(u >> 32) * kHashMix)) * kHashMul;
}

// (sum, count) of the valid build rows whose key is k, from a table of
// 2^bits slots
template <typename K>
__device__ __forceinline__ int2 find(const Slot<K>* t, int bits, K k) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned h = hash_key(k) >> (32 - bits);; h = (h + 1) & mask) {
    const Slot<K> v = t[h];
    if (v.cnt == 0) return make_int2(0, 0);
    if (v.key == k) return make_int2(v.sum, v.cnt);
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    small_probe(const K* __restrict__ bkey, const uint8_t* __restrict__ bok,
                int nb, int bits, const K* __restrict__ pkey,
                const uint8_t* __restrict__ pok, Plan p,
                int32_t* __restrict__ ridx, uint8_t* __restrict__ hit) {
  __shared__ Slot<K> slots[kMaxSlots];
  __shared__ int owner[kMaxSlots];
  __shared__ K sk[kMaxBuild];
  const int S = 1 << bits;
  for (int j = threadIdx.x; j < S; j += kThreads) {
    slots[j] = Slot<K>{};
    owner[j] = 0;
  }
  __syncthreads();
  const int j = threadIdx.x;
  K kj = 0;
  if (j < nb) {
    kj = bkey[j];
    sk[j] = kj;
  }
  __syncthreads();
  if (j < nb && bok[j] != 0) {
    unsigned h = hash_key(kj) >> (32 - bits);
    for (;; h = (h + 1) & (S - 1)) {
      const int o = atomicCAS(&owner[h], 0, j + 1);
      if (o == 0 || sk[o - 1] == kj) break;
    }
    slots[h].key = kj;  // every row that adds to a slot has its key
    atomicAdd(&slots[h].sum, j);
    atomicAdd(&slots[h].cnt, 1);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(kThreads) +
                          threadIdx.x) >> 5;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long c = warp; c < p.chunks; c += nwarps) {
    constexpr int R = lane_rows::Groups<K>::R, G = lane_rows::Groups<K>::G;
    K k[kRows];
    unsigned fw[G];
    lane_rows::load_keys<K>(pkey, p, c, lane, k);
    lane_rows::load_flags<K>(pok, p, c, lane, fw);
    int32_t r[kRows];
    unsigned hw[G];
#pragma unroll
    for (int g = 0; g < G; ++g) hw[g] = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int2 sc = find(slots, bits, k[i]);
      r[i] = sc.x < 0 ? 0 : (sc.x > nb - 1 ? nb - 1 : sc.x);
      hw[i / R] |= static_cast<unsigned>(lane_rows::flag_of<K>(fw, i) &&
                                         sc.y > 0) << (8 * (i % R));
    }
    lane_rows::store_rows<K>(ridx, hit, p, c, lane, r, hw);
  }
  const long long rest = lane_rows::rest_rows(p);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < rest; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = lane_rows::rest_row(p, i);
    const int2 sc = find(slots, bits, pkey[row]);
    ridx[row] = sc.x < 0 ? 0 : (sc.x > nb - 1 ? nb - 1 : sc.x);
    hit[row] = (pok[row] && sc.y > 0) ? 1 : 0;
  }
}

// Slots of the hash table: 2^bits >= 4 x n_build, at least 16.
inline int slot_bits(int nb) {
  int bits = 4;
  while ((1 << bits) < 4 * nb) ++bits;
  return bits;
}

template <typename K>
int launch(const void* bkey, const void* bok, int nb, const void* pkey,
           const void* pok, long long np, void* ridx, void* hit,
           cudaStream_t s) {
  // blocks the SMs hold at once, so that each builds its table once
  static int per_sm = 0;
  long long cap = 0;
  const int e = lane_rows::resident_blocks(small_probe<K>, kThreads, per_sm,
                                           &cap);
  if (e != 0) return e;
  const Plan p = lane_rows::plan_rows<K>(pkey, np, pok, ridx, hit);
  long long g = (p.chunks + kWarps - 1) / kWarps;
  const long long r = (lane_rows::rest_rows(p) + kThreads - 1) / kThreads;
  if (g < r) g = r;
  if (g > cap) g = cap;
  if (g < 1) g = 1;
  small_probe<K><<<static_cast<unsigned>(g), kThreads, 0, s>>>(
      static_cast<const K*>(bkey), static_cast<const uint8_t*>(bok), nb,
      slot_bits(nb), static_cast<const K*>(pkey),
      static_cast<const uint8_t*>(pok), p, static_cast<int32_t*>(ridx),
      static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int nds_small_build_max() { return kMaxBuild; }

int nds_small_build_slot_bits(int nb) { return slot_bits(nb); }

// K2. ridx: int32[np]; hit: uint8[np]. nb must be in [1, 256].
int nds_matmul_probe_join(const void* bkey, const void* bok, int nb,
                          const void* pkey, const void* pok, long long np,
                          int key64, void* ridx, void* hit, void* stream) {
  if (nb < 1 || nb > kMaxBuild) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return key64 ? launch<int64_t>(bkey, bok, nb, pkey, pok, np, ridx, hit, s)
               : launch<int32_t>(bkey, bok, nb, pkey, pok, np, ridx, hit, s);
}

}  // extern "C"
