// Decoupled look-back, shared by seg_scan.cu and partitioned_join.cu.
//
// A single-pass scan over tiles (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016): each block takes
// its tile id from a counter, so that every tile before it has already
// been taken by a running block; it publishes its tile's aggregate, reads
// the words of the tiles before it until one holds an inclusive prefix,
// and publishes its own inclusive prefix. No pass over all tiles, and no
// block waits on one that is not running.
//
// The tile words live in a buffer the wrapper keeps across calls. Each
// launch tags its words with its own epoch, and a word of another epoch
// reads as "not yet published", so nothing is zeroed between calls. The
// tile counter is left at 0 by the block that takes the last id.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

using u64 = unsigned long long;

// word kinds: nothing yet, the tile's aggregate, its inclusive prefix
constexpr unsigned kNone = 0;
constexpr unsigned kAgg = 1;
constexpr unsigned kPrefix = 2;

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// A 16-byte word {status, value}, stored and loaded whole through L2 (as
// CUB's tile state does for 8-byte values), so that a reader sees the
// status and the value of one store.
__device__ __forceinline__ void st_pair(u64* p, u64 a, u64 b) {
  asm volatile("st.global.cg.v2.u64 [%0], {%1, %2};" :: "l"(p), "l"(a), "l"(b)
               : "memory");
}

__device__ __forceinline__ void ld_pair(const u64* p, u64& a, u64& b) {
  asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b) : "l"(p) : "memory");
}

// The next tile id. `last` is the value of the counter's last increment
// in this launch: the block that draws it leaves the counter at 0.
__device__ __forceinline__ long long take(u64* ctr, long long last) {
  const long long id = static_cast<long long>(atomicAdd(ctr, 1ULL));
  if (id == last) atomicExch(ctr, 0ULL);
  return id;
}

// ---- count words: [epoch (30 bits) | kind (2) | count (32)], one per
// (tile, bin), for the partition and the radix sort's digit offsets

__device__ __forceinline__ u64 count_word(unsigned epoch, unsigned kind,
                                          unsigned count) {
  return (static_cast<u64>(epoch) << 34) | (static_cast<u64>(kind) << 32) |
         count;
}

constexpr int kCountBatch = 16;

// Exclusive prefix of one bin's count over the tiles before `tile`, whose
// words sit at words[t * stride]. Walks back until a tile holds its
// inclusive prefix (tile 0 always does), reading kCountBatch tiles at a
// time so that their loads are in flight together.
__device__ __forceinline__ unsigned count_lookback(const u64* words,
                                                   long long tile,
                                                   long long stride,
                                                   unsigned epoch) {
  unsigned excl = 0;
  for (long long t = tile - 1;; t -= kCountBatch) {
    u64 w[kCountBatch];
#pragma unroll
    for (int j = 0; j < kCountBatch; ++j)
      w[j] = t - j >= 0 ? ld_relaxed(words + (t - j) * stride) : 0;
#pragma unroll
    for (int j = 0; j < kCountBatch; ++j) {
      while ((w[j] >> 34) != epoch || ((w[j] >> 32) & 3u) == kNone) {
        __nanosleep(32);
        w[j] = ld_relaxed(words + (t - j) * stride);
      }
      excl += static_cast<unsigned>(w[j]);
      if (((w[j] >> 32) & 3u) == kPrefix) return excl;
    }
  }
}

}  // namespace lookback
