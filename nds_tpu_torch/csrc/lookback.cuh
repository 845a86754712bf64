// Decoupled look-back, shared by seg_scan.cu, partitioned_join.cu and
// compact.cu.
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
// epoch lives on the card, in the counter word beside the tile counter:
// `ctr` holds the next tile id in its low 32 bits and the launch's epoch
// above them, so one atomicAdd hands a block both, and the block that
// draws the launch's last id leaves the counter at (epoch + 1, id 0) for
// the next launch on the stream. No launch takes an epoch from the host,
// so a CUDA graph that replays a launch gives each replay an epoch of its
// own. The words hold 30 (count words) or 29 (seg_scan.cu's state) bits
// of the epoch: the wrapper zeroes the words and sets the counter back to
// epoch 1 before the range runs out (kernels._lookback says how).

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

// One draw from the counter word: the tile id (`id`, the low 32 bits) and
// the launch's epoch (`epoch`, the bits above). `last` is the id of the
// launch's last draw: the block that draws it moves the counter on to the
// next epoch with id 0. Every other draw of the launch comes before it, so
// every block of a launch sees one epoch.
struct Draw {
  long long id;
  unsigned epoch;
};

__device__ __forceinline__ Draw take(u64* ctr, long long last) {
  const u64 v = atomicAdd(ctr, 1ULL);
  const Draw d{static_cast<long long>(v & 0xffffffffULL),
               static_cast<unsigned>(v >> 32)};
  if (d.id == last) atomicExch(ctr, static_cast<u64>(d.epoch + 1) << 32);
  return d;
}

// ---- count words: [epoch (30 bits) | kind (2) | count (32)], one per
// (tile, bin), for the partition and the radix sort's digit offsets and the
// compactor's offsets (one bin). The epoch is taken modulo 2^30 where it is
// stored and compared, so that a counter run past the range (the wrapper
// resets it before) reads and writes the same field rather than waiting on
// a word it can never match.

constexpr unsigned kCountEpochMask = (1u << 30) - 1;

__device__ __forceinline__ u64 count_word(unsigned epoch, unsigned kind,
                                          unsigned count) {
  return (static_cast<u64>(epoch & kCountEpochMask) << 34) |
         (static_cast<u64>(kind) << 32) | count;
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
  epoch &= kCountEpochMask;
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
