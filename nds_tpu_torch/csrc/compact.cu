// The result compactor (L1): the stable partition of the rows by presence.
//
// Replaces nds_tpu/engine/device_exec.py `_compactor` (`:947`, the lax.sort
// of (absent, iota) before a large result crosses to the host, and its
// count) and `_compact` (`:2617`, the same sort before a LIMIT whose child
// is not ordered). It writes perm, the ids of the present rows in row order
// and then those of the absent rows in row order (the stable sort's
// permutation), and the present rows' count, on the card.
//
// What bounds it on an H100: bytes. The function reads the mask (1 byte a
// row) and writes a 4-byte id a row, so the writes are four fifths of it
// (6,480,000 rows: 6.5 MB read, 25.9 MB written, 0.0097 ms at 3.35 TB/s).
// The first version took three launches, each waiting for the one before to
// drain (the tiles' counts, one block that walked every tile for their
// offsets, the scatter); it read the mask a byte a thread, and its scatter
// gave each thread 16 consecutive rows, so that one warp store wrote 32 ids
// about 16 elements apart, 32 sectors for 128 useful bytes.
//
// Two launches now, over tiles of 4,096 rows cut at the mask's 16-byte
// boundaries (tile t holds the rows whose address lies in the t-th 4,096
// bytes from the boundary at or below the first row):
//
// 1. compact_count: a block draws a span of 8 tiles from the counter word
//    (lookback.cuh), and each warp counts one tile's present rows with
//    16-byte loads, all in flight at once (a byte compare and a popcount).
//    The block publishes the span's count, takes the span's exclusive
//    offset by decoupled look-back and writes its tiles' offsets; the block
//    that draws the last span writes the total. Spans keep the look-back
//    chain short (198 at 6,480,000 rows, every block resident at once).
//    The mask stays in L2 for the second pass.
// 2. compact_write, launched as a programmatic dependent of the first
//    (dependent_launch.cuh), one block a tile: a warp loads its 512 rows of
//    the mask (16 bytes a lane), turns them into presence bits and counts
//    them before the block waits for the first pass. It ranks 32 rows at
//    once from one presence word (gathered by shuffles, as a ballot would
//    give it) and popcounts, and the block stages the tile's present ids
//    and its absent ids in shared memory, in row order, each run placed so
//    that its 16-byte boundaries fall where the output's do. Then it
//    writes each run as one stretch of coalesced stores, 16 bytes a store
//    inside it: the present run at the tile's offset, the absent run at
//    total + (rows before the tile) - offset.
//
// Measured on an H100 (PERF.md, L1): tiles of 8,192 rows lost to 4,096 at
// every timed call, and so did spans of 16 tiles with a write pass on a
// grid of resident blocks that took tile after tile.
//
// The look-back words are the "count" layout of kernels._lookback, one a
// span, kept across calls with the launch's epoch drawn on the card, so a
// CUDA graph replays the pair as it is.
//
// The entry point launches on the given stream, allocates nothing (the
// tiles' offsets and the look-back words are the caller's) and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "dependent_launch.cuh"
#include "lookback.cuh"

namespace {

using dependent_launch::allow_dependents;
using dependent_launch::await_prerequisites;
using dependent_launch::launch_after;
using lookback::u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kTile = kThreads * 16;       // rows a tile: 16 bytes a thread
constexpr int kWarpRows = kTile / kWarps;  // a warp's rows of a tile

// The 16 mask bytes at `f` (a multiple of 16) of the frame whose position
// f holds row f - F, with F the mask's address mod 16; the bytes outside
// rows [0, n) read 0. A whole vector is one load, streamed (`last`) or
// left in L2 for the second pass.
__device__ __forceinline__ uint4 mask16(const uint8_t* __restrict__ row,
                                        long long n, int F, long long f,
                                        bool last) {
  if (f >= F && f + 16 <= n + F) {
    const uint4* q = reinterpret_cast<const uint4*>(row + (f - F));
    return last ? __ldcs(q) : *q;
  }
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const long long r = f + b - F;
    if (r >= 0 && r < n)
      w[b >> 2] |= static_cast<unsigned>(row[r]) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned present16(uint4 v) {
  return (__popc(__vcmpne4(v.x, 0u)) + __popc(__vcmpne4(v.y, 0u)) +
          __popc(__vcmpne4(v.z, 0u)) + __popc(__vcmpne4(v.w, 0u))) >> 3;
}

// The lanes l of a warp with lo <= l < hi.
__device__ __forceinline__ unsigned lanes_in(long long lo, long long hi) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > 32 ? 32 : hi;
  if (hi <= lo) return 0;
  const unsigned upto = hi == 32 ? kFull : (1u << hi) - 1;
  return upto & ~((1u << lo) - 1);
}

// A span: the kWarps tiles that one block of compact_count counts, warp w
// the span's w-th tile.
__global__ void __launch_bounds__(kThreads)
    compact_count(const uint8_t* __restrict__ row, long long n, int F,
                  long long ntiles, long long nspans,
                  int32_t* __restrict__ offs, long long* __restrict__ count,
                  u64* words, u64* ctr) {
  constexpr int V = kTile / 16 / 32;  // a lane's 16-byte loads in its tile
  __shared__ long long s_span;
  __shared__ unsigned s_epoch;
  __shared__ unsigned s_c[kWarps];
  allow_dependents();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const lookback::Draw d = lookback::take(ctr, nspans - 1);
    s_span = d.id;
    s_epoch = d.epoch;
  }
  __syncthreads();
  const long long span = s_span;
  const unsigned epoch = s_epoch;
  const long long tile = span * kWarps + warp;
  uint4 v[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = mask16(row, n, F, tile * kTile + (j * 32 + lane) * 16LL, false);
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) c += present16(v[j]);
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) s_c[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sc = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sc += s_c[w];
    unsigned excl = 0;
    if (span == 0) {
      lookback::st_relaxed(words,
                           lookback::count_word(epoch, lookback::kPrefix, sc));
    } else {
      lookback::st_relaxed(words + span,
                           lookback::count_word(epoch, lookback::kAgg, sc));
      excl = lookback::count_lookback(words, span, 1, epoch);
      lookback::st_relaxed(words + span,
                           lookback::count_word(epoch, lookback::kPrefix,
                                                excl + sc));
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (span * kWarps + w < ntiles) offs[span * kWarps + w] = excl;
      excl += s_c[w];
    }
    if (span == nspans - 1) *count = excl;
  }
}

// s[start, start + len) to dst[start, start + len), dst 16-byte aligned:
// the whole groups of 4 as one 16-byte store each, the ends one id a thread.
__device__ __forceinline__ void write_run(const int32_t* __restrict__ s,
                                          int start, int len,
                                          int32_t* __restrict__ dst) {
  const int end = start + len;
  for (int q = (start >> 2) + threadIdx.x; q < (end + 3) >> 2;
       q += kThreads) {
    const int a = q * 4;
    if (a >= start && a + 4 <= end) {
      reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(s)[q];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (a + j >= start && a + j < end) dst[a + j] = s[a + j];
    }
  }
}

// The presence bits of 16 mask bytes, bit b for byte b.
__device__ __forceinline__ unsigned bits16(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // byte b's low bit to bit 24 + b: the products' bits never overlap
    const unsigned x = __vcmpne4(w[i], 0u) & 0x01010101u;
    m |= ((x * 0x01020408u) >> 24) << (4 * i);
  }
  return m;
}

// Warp w of a tile holds its rows at frame positions f0 + 512 w + [0,
// 512): lane l loads the 16 bytes at 512 w + 16 l. Step s of the warp is
// the 32 rows at f0 + 512 w + 32 s + lane: its presence word is lane 2s's
// 16 bits below lane 2s+1's, gathered by two shuffles into lane s and
// handed out by one more at the step.
__global__ void __launch_bounds__(kThreads)
    compact_write(const uint8_t* __restrict__ row, long long n, int F,
                  const int32_t* offs, const long long* count,
                  int32_t* __restrict__ perm) {
  __shared__ __align__(16) int32_t s_ids[kTile + 8];
  __shared__ unsigned s_wp[kWarps], s_wa[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long f0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long fw = f0 + static_cast<long long>(warp) * kWarpRows;
  const unsigned m = bits16(mask16(row, n, F, fw + 16 * lane, true));
  const unsigned lo = __shfl_sync(kFull, m, (2 * lane) & 31);
  const unsigned hi = __shfl_sync(kFull, m, (2 * lane + 1) & 31);
  const unsigned word = lo | (hi << 16);  // lane s < 16: step s's word
  const unsigned np = __reduce_add_sync(kFull, __popc(m));
  // the warp's rows: its frame positions inside [F, n + F)
  const long long vlo = fw > F ? fw : F;
  const long long vhi = fw + kWarpRows < n + F ? fw + kWarpRows : n + F;
  if (lane == 0) {
    s_wp[warp] = np;
    s_wa[warp] = static_cast<unsigned>(vhi > vlo ? vhi - vlo : 0) - np;
  }
  __syncthreads();
  unsigned wp = 0, wa = 0, tp = 0, ta = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      wp += s_wp[w];
      wa += s_wa[w];
    }
    tp += s_wp[w];
    ta += s_wa[w];
  }
  await_prerequisites();  // compact_count: the offsets and the total
  // written by compact_count while this grid ran: read through L2, after
  // the wait (not through the read-only path, which assumes data that no
  // grid writes while this one runs)
  const long long off = __ldcg(offs + blockIdx.x);
  const long long total = __ldcg(count);
  const long long r0 = f0 > F ? f0 - F : 0;  // the tile's first row
  const long long abs_at = total + r0 - off;  // its first absent row's place
  // each run starts in s_ids where its 16-byte boundaries fall on the
  // output's: sp = off and sa = abs_at modulo 4 elements of perm's alignment
  const unsigned long long ph = reinterpret_cast<uintptr_t>(perm) >> 2;
  const int sp = static_cast<int>((ph + off) & 3);
  int sa = sp + static_cast<int>(tp);
  sa += static_cast<int>((ph + abs_at - sa) & 3);
  unsigned at_p = sp + wp, at_a = sa + wa;
  const unsigned below = (1u << lane) - 1;
  const bool whole = fw >= F && fw + kWarpRows <= n + F;  // every lane a row
#pragma unroll
  for (int s = 0; s < kWarpRows / 32; ++s) {
    const unsigned p = __shfl_sync(kFull, word, s);
    const long long at = fw + 32 * s;
    const unsigned a = (whole ? kFull : lanes_in(F - at, n + F - at)) & ~p;
    const int32_t id = static_cast<int32_t>(at + lane - F);
    if ((p >> lane) & 1u)
      s_ids[at_p + __popc(p & below)] = id;
    else if ((a >> lane) & 1u)
      s_ids[at_a + __popc(a & below)] = id;
    at_p += __popc(p);
    at_a += __popc(a);
  }
  __syncthreads();
  write_run(s_ids, sp, static_cast<int>(tp), perm + (off - sp));
  write_run(s_ids, sa, static_cast<int>(ta), perm + (abs_at - sa));
}

}  // namespace

extern "C" {

// The rows of a tile. A call over n rows takes at most ceil((n + 15) /
// tile) tiles.
int nds_compact_tile() { return kTile; }

// row: bool[n], 1 <= n < 2^31 - 1; offs: int32 scratch of at most
// ceil((n + 15) / nds_compact_tile()) tiles; perm: int32[n]; count:
// int64[1]; words, ctr: the look-back words (the "count" layout, at least
// one a tile) and their counter word.
int nds_compact_perm(const void* row, long long n, void* offs, void* perm,
                     void* count, void* words, void* ctr, void* stream) {
  if (n < 1 || n >= (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(row);
  const int F = static_cast<int>(reinterpret_cast<uintptr_t>(r) & 15u);
  const long long ntiles = (n + F + kTile - 1) / kTile;
  const long long nspans = (ntiles + kWarps - 1) / kWarps;
  compact_count<<<static_cast<unsigned>(nspans), kThreads, 0, s>>>(
      r, n, F, ntiles, nspans, static_cast<int32_t*>(offs),
      static_cast<long long*>(count), static_cast<u64*>(words),
      static_cast<u64*>(ctr));
  const cudaError_t err = launch_after(
      compact_write, static_cast<unsigned>(ntiles), kThreads, s, r, n, F,
      static_cast<const int32_t*>(offs), static_cast<const long long*>(count),
      static_cast<int32_t*>(perm));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
