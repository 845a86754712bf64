// Segmented scans (K5, K7, and L2's group bounds and segment sums).
//
// Replaces nds_tpu/engine/kernels.py `seg_scan` (a (value, reset-flag)
// associative scan with op +, min or max), `seg_reduce_at_ends` (that scan
// gathered at each group's last sorted row, K5), `part_reduce_broadcast` (the
// scan read at each row's partition end, K7) and `last_of_group` (a reversed
// running min of the next change position, K7); and from
// nds_tpu/engine/device_exec.py the group ids after `_group_ids`' sort
// (`:2221-2230`, with its callers' clip to the group capacity and their
// searchsorted of the group starts: group_bounds), `_seg_sum`'s cumsum
// differences (`:2139`, K5 with op +) and the windows' `lax.cummax`
// (`:2464`, `:2485`, `:2487`: seg_scan with op max over one segment). One
// scan kernel serves all of them but group_bounds, and the prefix of match
// counts inside partitioned_join.cu's M:N join (K6) too.
//
// One pass with decoupled look-back (lookback.cuh): each block takes the next
// tile of 2048 rows and the launch's epoch from the counter word, loads the
// tile with 16-byte vector loads (the flags 8 bytes at a time), scans its 8
// rows per thread in registers, the threads of a warp with shuffles and the
// 8 warps through shared memory, publishes the tile's aggregate (value,
// any-reset flag), applies the in-tile prefix to its rows, and only then has
// warp 0 read the tiles before it, 32 at a time, until the segmented
// combination of the window holds a reset or an inclusive prefix (looking
// back later gives the tiles before it the time to publish their prefixes).
// A tile whose aggregate holds a reset publishes its inclusive prefix at
// once (it does not depend on the tiles before it), and a tile whose first
// row resets does not look back at all. The combiner is (a, b) -> (b.flag ?
// b.v : op(a.v, b.v), a.flag | b.flag). Each consumer's finishing step is
// folded into the tile's store:
//   seg_scan, the running max and K6's prefix: every row's value, with
//     vector stores;
//   K5: each group's value at its last row, out[g] = scan at
//     clip(starts2[g + 1] - 1, 0, n - 1). The tile stages its final values in
//     shared memory and writes the groups whose end lies in it, found by a
//     32-way search of the ends (non-decreasing, as starts2 is sorted); of
//     the groups that end at the last row (a fixed group capacity leaves
//     many empty ones there, up to n), the last tile writes the first and a
//     second launch of many blocks the rest, with its value (min, max) or 0
//     (a sum: as `_seg_sum`'s differences give a group with no rows);
//   last_of_group: the tiles walk the rows from the end, scanning the next
//     change position with min, and store clip(scan - 1, 0, n - 1);
//   part_reduce_broadcast: a row's partition end can lie in a later tile, so
//     the scan stores every row and a second kernel gathers at pend.
// min/max on floats propagate NaN, as jnp.minimum/maximum do. An integer sum
// wraps in two's complement, as the JAX scan's does; int32 counts stay int32.
// A float sum associates in this kernel's order (rows of a thread, threads of
// a warp, warps, tiles), not in lax.associative_scan's nor in the cumsum
// differences', so float sums agree to rounding, not bit for bit: the
// tolerance stated in the tests and the smoke (relative 1e-12 and 1e-9 of
// float64 values) holds.
//
// Where the segment flags come from: K5 compares neighbouring group ids, the
// window scans read a bool flag per row, K6's prefix restarts every `seg_len`
// rows (the running max: seg_len = n, one segment), and last_of_group has
// none (one segment, scanned from the end, over the values "next change
// position" computed from the change flags).
//
// group_bounds (the group ids after `_group_ids`' sort) has a kernel of its
// own beside scan_kernel, on the same tile state and look-back, with tiles
// of 4096 rows: see its note below.
//
// What bounds it on an H100: bytes. The function must read n values and n
// flags and write n values (G for K5); this kernel moves those and, per tile
// of 2048 rows, 16 bytes of tile state and the few words its look-back reads.
// part_reduce_broadcast moves n values more (the stored scan, read again at
// pend).
//
// The entry points launch on the given stream, allocate nothing (the caller
// passes every output and scratch buffer) and return cudaGetLastError(). The
// tile state (16 bytes a tile) and the counter word are the wrapper's, kept
// across calls; each launch draws its epoch from the counter word on the card.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <type_traits>

#include "lookback.cuh"

namespace {

using lookback::u64;

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kStateWords = 2;  // status and value (16 bytes)
constexpr unsigned kStateEpochMask = (1u << 29) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFillBlocks = 2048;

enum { kSum = 0, kMin = 1, kMax = 2 };

template <typename V>
__device__ __forceinline__ bool is_nan(V) { return false; }
template <>
__device__ __forceinline__ bool is_nan<float>(float v) { return v != v; }
template <>
__device__ __forceinline__ bool is_nan<double>(double v) { return v != v; }

template <typename V, int OP>
__device__ __forceinline__ V op(V a, V b) {
  if (OP == kSum) {
    if constexpr (std::is_integral<V>::value) {
      using U = typename std::make_unsigned<V>::type;
      return static_cast<V>(static_cast<U>(a) + static_cast<U>(b));
    } else {
      return a + b;
    }
  }
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  if (OP == kMax) return b > a ? b : a;
  return b < a ? b : a;
}

// (a, b) -> b in place
template <typename V, int OP>
__device__ __forceinline__ void combine(V av, bool af, V& bv, bool& bf) {
  if (!bf) bv = op<V, OP>(av, bv);
  bf = bf || af;
}

template <typename V>
__device__ __forceinline__ u64 bits_of(V v) {
  u64 b = 0;
  memcpy(&b, &v, sizeof(V));
  return b;
}

template <typename V>
__device__ __forceinline__ V of_bits(u64 b) {
  V v;
  memcpy(&v, &b, sizeof(V));
  return v;
}

// kItems elements at p (16-byte aligned) with 16-byte loads and stores
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[kItems]) {
  constexpr int kVec = kItems * sizeof(T) / 16;
  uint4 w[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) w[j] = reinterpret_cast<const uint4*>(p)[j];
  memcpy(v, w, sizeof(w));
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[kItems]) {
  constexpr int kVec = kItems * sizeof(T) / 16;
  uint4 w[kVec];
  memcpy(w, v, sizeof(w));
#pragma unroll
  for (int j = 0; j < kVec; ++j) reinterpret_cast<uint4*>(p)[j] = w[j];
}

// ---- tile state: a status (epoch << 35 | flag << 34 | kind << 32) and
// the tile's value. The status holds the epoch modulo 2^29 (see
// lookback.cuh for the range). A 4-byte value shares the status word (its bits in the
// low 32), published with one 8-byte store and read with one load; an
// 8-byte value sits beside it in one 16-byte word, stored and loaded whole.
// Either way a reader sees a status and the value stored with it, and no
// fence is needed; an inclusive prefix overwrites the aggregate.

template <typename V>
__device__ __forceinline__ void publish(u64* st, long long tile,
                                        unsigned epoch, unsigned kind, V v,
                                        bool f) {
  u64* s = st + kStateWords * tile;
  const u64 status = (static_cast<u64>(epoch & kStateEpochMask) << 35) |
                     (f ? 1ull << 34 : 0ull) | (static_cast<u64>(kind) << 32);
  if constexpr (sizeof(V) == 4) {
    uint32_t b;
    memcpy(&b, &v, sizeof(b));
    lookback::st_relaxed(s, status | b);
  } else {
    lookback::st_pair(s, status, bits_of(v));
  }
}

// one load of a tile's state: its status and value bits
template <typename V>
__device__ __forceinline__ void load_state(const u64* st, long long tile,
                                           u64& w, u64& b) {
  const u64* s = st + kStateWords * tile;
  if constexpr (sizeof(V) == 4) {
    w = lookback::ld_relaxed(s);
    b = w & 0xffffffffull;
  } else {
    lookback::ld_pair(s, w, b);
  }
}

__device__ __forceinline__ bool published(u64 w, unsigned epoch) {
  return (w >> 35) == (epoch & kStateEpochMask) &&
         ((w >> 32) & 3u) != lookback::kNone;
}

// a published tile's value; `stop` when it is an inclusive prefix or an
// aggregate that holds a reset (nothing before it matters then)
template <typename V>
__device__ __forceinline__ void decode_state(u64 w, u64 b, V& v, bool& stop) {
  if constexpr (sizeof(V) == 4) {
    const uint32_t b32 = static_cast<uint32_t>(b);
    memcpy(&v, &b32, sizeof(b32));
  } else {
    v = of_bits<V>(b);
  }
  stop = ((w >> 32) & 3u) == lookback::kPrefix || ((w >> 34) & 1u) != 0;
}

// warp shuffles of a value; int64_t goes through long long
template <typename V>
__device__ __forceinline__ V shfl_up(V v, int d) {
  if constexpr (std::is_same<V, int64_t>::value)
    return static_cast<V>(__shfl_up_sync(kFull, static_cast<long long>(v), d));
  else
    return __shfl_up_sync(kFull, v, d);
}

template <typename V>
__device__ __forceinline__ V shfl_from(V v, int lane) {
  if constexpr (std::is_same<V, int64_t>::value)
    return static_cast<V>(__shfl_sync(kFull, static_cast<long long>(v), lane));
  else
    return __shfl_sync(kFull, v, lane);
}

// inclusive segmented scan over the lanes of a warp
template <typename V, int OP>
__device__ __forceinline__ void warp_scan(V& v, bool& f, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V pv = shfl_up(v, d);
    const int pf = __shfl_up_sync(kFull, f ? 1 : 0, d);
    if (lane >= d) combine<V, OP>(pv, pf != 0, v, f);
  }
}

// warp 0: the scan value at the end of tile - 1 (tile > 0), from the
// tiles before it, 32 at a time
template <typename V, int OP>
__device__ V tile_prefix(const u64* st, long long tile, unsigned epoch,
                         int lane) {
  V acc{};
  bool have = false;
  for (long long end = tile - 1;; end -= 32) {
    const long long t = end - 31 + lane;
    V v{};
    bool f = true;  // lanes before tile 0 sit before its prefix
    if (t >= 0) {
      u64 w, b;
      load_state<V>(st, t, w, b);
      while (!published(w, epoch)) {
        __nanosleep(32);
        load_state<V>(st, t, w, b);
      }
      decode_state<V>(w, b, v, f);
    }
    warp_scan<V, OP>(v, f, lane);
    const V wv = shfl_from(v, 31);
    const bool wf = __shfl_sync(kFull, f ? 1 : 0, 31) != 0;
    acc = have ? op<V, OP>(wv, acc) : wv;
    have = true;
    if (wf) return acc;
  }
}

// first index in [lo, hi) where the monotone `pred` holds, else hi: a
// 32-way search by the lanes of one warp
template <typename P>
__device__ long long warp_first(long long lo, long long hi, P pred, int lane) {
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long i = lo + lane * step;
    const unsigned m = __ballot_sync(kFull, i >= hi || pred(i));
    if (m == 0) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(m) - 1;
      if (f == 0) return lo;
      hi = lo + f * step < hi ? lo + f * step : hi;
      lo += (f - 1) * step + 1;
    }
  }
  const long long i = lo + lane;
  const unsigned m = __ballot_sync(kFull, i < hi && pred(i));
  return m ? lo + __ffs(m) - 1 : hi;
}

// ---- sources of (value, reset flag) for the kItems scanned rows from base;
// rows past n are fresh segments that no written row reads. A source may
// hand its sink what it read besides (`Extra`).

struct NoExtra {};

// windows: values and one bool flag per row; with no flags, a segment
// every seg_len rows (K6's per-partition prefix, and one segment of all
// rows for the windows' running max)
template <typename V>
struct FlagSource {
  using Extra = NoExtra;
  const V* data;
  const uint8_t* flags;
  long long seg_len;
  bool vec;  // data 16-byte and flags 8-byte aligned
  __device__ void load(long long base, long long n, V (&v)[kItems],
                       bool (&f)[kItems], Extra&) const {
    if (vec && base + kItems <= n) {
      load_vec(data + base, v);
      if (flags != nullptr) {
        uint2 w[kItems / 8];
#pragma unroll
        for (int j = 0; j < kItems / 8; ++j)
          w[j] = reinterpret_cast<const uint2*>(flags + base)[j];
        uint8_t b[kItems];
        memcpy(b, w, sizeof(b));
#pragma unroll
        for (int k = 0; k < kItems; ++k) f[k] = b[k] != 0;
        return;
      }
#pragma unroll
      for (int k = 0; k < kItems; ++k) f[k] = false;
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const long long i = base + k;
        v[k] = i < n ? data[i] : V{};
        f[k] = i >= n || (flags != nullptr && flags[i] != 0);
      }
      if (flags != nullptr) return;
    }
    long long r = base % seg_len;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      f[k] = f[k] || r == 0;
      r = r + 1 == seg_len ? 0 : r + 1;
    }
  }
};

// K5: values, a segment at every change of the sorted group id
template <typename V>
struct GidSource {
  using Extra = NoExtra;
  const V* data;
  const int32_t* gid;
  bool vec;  // data and gid 16-byte aligned
  __device__ void load(long long base, long long n, V (&v)[kItems],
                       bool (&f)[kItems], Extra&) const {
    int32_t g[kItems];
    if (vec && base + kItems <= n) {
      load_vec(data + base, v);
      load_vec(gid + base, g);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const long long i = base + k;
        v[k] = i < n ? data[i] : V{};
        g[k] = i < n ? gid[i] : 0;
      }
    }
    int32_t prev = base > 0 && base <= n ? gid[base - 1] : 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k;
      f[k] = i == 0 || i >= n || g[k] != prev;
      prev = g[k];
    }
  }
};

// last_of_group: scanned row k is row i = n - 1 - k, whose value is the
// position of the next change after it (n where there is none)
struct NextChangeSource {
  using Extra = NoExtra;
  const uint8_t* change;
  __device__ void load(long long base, long long n, int32_t (&v)[kItems],
                       bool (&f)[kItems], Extra&) const {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = n - 1 - (base + k);
      v[k] = static_cast<int32_t>((i >= 0 && i + 1 < n && change[i + 1])
                                      ? i + 1 : n);
      f[k] = i < 0;
    }
  }
};

// ---- sinks: what a tile stores once its rows hold their final values

struct NoShared {};

template <typename V>
struct RowSink {
  using Shared = NoShared;
  V* out;
  bool vec;  // out 16-byte aligned
  __device__ void begin(Shared&, long long, long long, int) const {}
  template <typename E>
  __device__ void store(Shared&, long long r0, long long n,
                        const V (&v)[kItems], const E&) const {
    const long long base = r0 + threadIdx.x * kItems;
    if (vec && base + kItems <= n) {
      store_vec(out + base, v);
      return;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (base + k < n) out[base + k] = v[k];
  }
};

// K5: out[g] = scan at e(g) = clip(starts2[g + 1] - 1, 0, n - 1) (n - 1
// for the last group), for the groups whose end lies in this tile. For a
// sum, a group with no rows (starts2[g] > e(g): the empty groups past the
// last, whose start is n) writes 0. Of the groups that end at the last row,
// the last tile writes the first (g_tail) and leaves its index in `tail`;
// the rest, G - 1 - g_tail of them (the whole capacity past the last group,
// up to n), are ends_tail's, a launch of many blocks.
template <typename V, typename S, int OP>
struct EndsSink {
  struct Shared {
    V vals[kTile];
    long long g_lo, g_hi, g_tail;
  };
  const S* starts2;
  long long G;
  V* out;
  long long* tail;
  __device__ long long end_of(long long g, long long n) const {
    long long e = (g + 1 < G ? static_cast<long long>(starts2[g + 1]) : n) - 1;
    return e < 0 ? 0 : (e > n - 1 ? n - 1 : e);
  }
  // warps 0-2 find the tile's groups (and, in the last tile, the first
  // group that ends at the last row); read after the next barrier
  __device__ void begin(Shared& sh, long long r0, long long n, int lane) const {
    const int warp = threadIdx.x >> 5;
    if (warp > 2) return;
    const bool last = r0 + kTile >= n;
    long long r = r0;
    if (warp == 1) r = last ? n : r0 + kTile;
    if (warp == 2) r = last ? n - 1 : n;
    long long g = G;
    if (r < n)
      g = warp_first(0, G, [&](long long x) { return end_of(x, n) >= r; },
                     lane);
    if (lane == 0) (warp == 0 ? sh.g_lo : warp == 1 ? sh.g_hi : sh.g_tail) = g;
  }
  template <typename E>
  __device__ void store(Shared& sh, long long r0, long long n,
                        const V (&v)[kItems], const E&) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int k = 0; k < kItems; ++k) sh.vals[t * kItems + k] = v[k];
    __syncthreads();
    // the groups that end at the last row (a fixed group capacity leaves
    // a long suffix of empty ones) take its value without a load; for a
    // sum only the first of them can hold rows
    const long long g_hi = sh.g_hi;
    const long long g_tail = sh.g_tail < g_hi ? sh.g_tail : g_hi;
    constexpr int kBatch = 8;
    for (long long g0 = sh.g_lo + t; g0 < g_tail; g0 += kThreads * kBatch) {
      long long e[kBatch];
      bool empty[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long g = g0 + j * kThreads;
        e[j] = g < g_tail ? end_of(g, n) : r0;
        empty[j] = OP == kSum && g < g_tail &&
                   static_cast<long long>(starts2[g]) > e[j];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long g = g0 + j * kThreads;
        if (g < g_tail) out[g] = empty[j] ? V{} : sh.vals[e[j] - r0];
      }
    }
    if (g_tail < g_hi && t == 0) {
      const bool empty =
          OP == kSum && static_cast<long long>(starts2[g_tail]) > n - 1;
      out[g_tail] = empty ? V{} : sh.vals[n - 1 - r0];
      *tail = g_tail;
    }
  }
};

// last_of_group: row n - 1 - k gets clip(scan[k] - 1, 0, n - 1); a
// thread's rows are contiguous (in reverse), stored with 16-byte stores
// where they are aligned
struct LastSink {
  using Shared = NoShared;
  int32_t* out;
  bool vec;  // out 16-byte aligned and n a multiple of 4
  __device__ void begin(Shared&, long long, long long, int) const {}
  template <typename E>
  __device__ void store(Shared&, long long r0, long long n,
                        const int32_t (&v)[kItems], const E&) const {
    const long long base = r0 + threadIdx.x * kItems;
    int32_t w[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      long long x = static_cast<long long>(v[k]) - 1;
      x = x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
      w[kItems - 1 - k] = static_cast<int32_t>(x);
    }
    if (vec && base + kItems <= n) {
      store_vec(out + (n - base - kItems), w);
      return;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (base + k < n) out[n - 1 - (base + k)] = w[kItems - 1 - k];
  }
};

template <typename V, int OP, typename Src, typename Sink>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(Src src, Sink sink, long long n, long long ntiles, u64* st,
                u64* ctr) {
  __shared__ long long s_tile;
  __shared__ unsigned s_epoch;
  __shared__ V s_wv[kWarps];
  __shared__ bool s_wf[kWarps];
  __shared__ bool s_first;
  __shared__ V s_pre;
  __shared__ bool s_has;
  __shared__ typename Sink::Shared s_sink;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) {
    const lookback::Draw d = lookback::take(ctr, ntiles - 1);
    s_tile = d.id;
    s_epoch = d.epoch;
  }
  __syncthreads();
  const long long tile = s_tile;
  const unsigned epoch = s_epoch;
  const long long r0 = tile * kTile;
  V v[kItems];
  bool f[kItems];
  typename Src::Extra extra;
  src.load(r0 + t * kItems, n, v, f, extra);
  sink.begin(s_sink, r0, n, lane);
  if (t == 0) s_first = f[0];
#pragma unroll
  for (int k = 1; k < kItems; ++k) combine<V, OP>(v[k - 1], f[k - 1], v[k], f[k]);
  V tv = v[kItems - 1];
  bool tf = f[kItems - 1];
  warp_scan<V, OP>(tv, tf, lane);
  // this thread's exclusive prefix within its warp
  const V ev = shfl_up(tv, 1);
  const bool ef = __shfl_up_sync(kFull, tf ? 1 : 0, 1) != 0;
  if (lane == 31) {
    s_wv[warp] = tv;
    s_wf[warp] = tf;
  }
  __syncthreads();

  // the warps before this one, and the tile's aggregate
  V pv = s_wv[0];
  bool pf = s_wf[0];
  V av = s_wv[0];
  bool af = s_wf[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    V x = s_wv[w];
    bool xf = s_wf[w];
    if (w < warp) {
      V y = x;
      bool yf = xf;
      combine<V, OP>(pv, pf, y, yf);
      pv = y;
      pf = yf;
    }
    combine<V, OP>(av, af, x, xf);
    av = x;
    af = xf;
  }
  if (t == 0)
    publish(st, tile, epoch,
            (tile == 0 || af) ? lookback::kPrefix : lookback::kAgg, av, af);

  // the rows' values within the tile first: the scan of the rows before
  // each thread's first row in this tile, and whether it holds a reset
  bool h = warp > 0;
  V x = pv;
  bool xf = warp > 0 && pf;
  if (lane > 0) {
    x = (h && !ef) ? op<V, OP>(x, ev) : ev;
    xf = xf || ef;
    h = true;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (h && !f[k]) v[k] = op<V, OP>(x, v[k]);
    f[k] = f[k] || xf;
  }

  // then the tiles before this one, once its own work is done
  if (warp == 0) {
    V pre{};
    const bool has = tile > 0 && !s_first;
    if (has) {
      pre = tile_prefix<V, OP>(st, tile, epoch, lane);
      if (lane == 0 && !af)
        publish(st, tile, epoch, lookback::kPrefix, op<V, OP>(pre, av), false);
    }
    if (lane == 0) {
      s_pre = pre;
      s_has = has;
    }
  }
  __syncthreads();
  if (s_has) {
    const V pre = s_pre;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (!f[k]) v[k] = op<V, OP>(pre, v[k]);
  }
  sink.store(s_sink, r0, n, v, extra);
}

template <typename V, typename S>
__global__ void gather_at(const V* __restrict__ run, const S* __restrict__ at,
                          long long n, V* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long e = static_cast<long long>(at[i]);
    e = e < 0 ? 0 : (e > n - 1 ? n - 1 : e);
    out[i] = run[e];
  }
}

// K5's second launch: the groups after g_tail, the first group that ends at
// the last row, take its value (min, max) or 0 (a sum: they hold no row)
template <typename V>
__global__ void ends_tail(V* __restrict__ out, long long G,
                          const long long* __restrict__ tail, int sum) {
  const long long gt = *tail;
  const V v = sum ? V{} : out[gt];
  for (long long g = gt + 1 + blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < G; g += (long long)gridDim.x * blockDim.x)
    out[g] = v;
}

// ---- group_bounds (L2): a kernel of its own, on the scan's tile state.
//
// The keys are sorted and the presence bit is their top bit (a 32-bit key
// is biased by -2^31: its sign bit, flipped back here), so the present rows
// come first and every row after the first absent row is absent: it has no
// first flag, its group id is clip(ngroups - 1, 0, G - 1), and its key need
// not be read. A tile of kGTile rows reads its first key (one load, by one
// thread): where that row is absent the whole tile is, its count of first
// rows is 0, and it reads no other key; else it loads its keys (16-byte
// loads, 16 rows a thread) and the key before each thread's first row, and
// counts its first rows. The tile's count goes to the tile state with the
// same words and look-back as scan_kernel's (an int32 sum over one
// segment), and the count before each row gives its group id.
//
// starts2[g], the first row of group g (n past the last group; 0 for g = 0
// in every case: group 0, where there is one, starts at row 0, and with no
// group searchsorted gives 0), is written in the same pass. A group's first
// row lies at a row >= g, since every group before it holds a row, so tile
// t owns the slots [t * kGTile, (t + 1) * kGTile) of starts2 below G: it
// writes their defaults (n, or 0 at slot 0) before it publishes its count,
// and only the tile of a group's first row, tile t or a later one, writes
// the group's start, once its look-back is done. A start is stored after
// the default of its slot: the defaults go to memory before the tile's word
// (every thread's stores, a barrier, then a fence by the thread that
// publishes), and a tile reads, directly or through a later tile's
// inclusive prefix, the word of every tile before it before it stores a
// start (each lane of the look-back fences after its loads, the warp meets,
// the publishing lane fences again before it publishes the prefix, and the
// block meets at a barrier before the starts are stored). A tile that
// starts absent stores its presence bytes (0) and its group ids (one value)
// with 16-byte stores, neighbouring threads on neighbouring bytes; a
// present tile stores each thread's 16 rows with 16-byte stores, and each
// first row its start. The tile holding row n - 1 writes the group count.
//
// What bounds it on an H100: bytes. It must read the keys up to and
// including the first absent row and write n presence bytes, n int32 group
// ids, G int64 starts and the count. At L2's largest NDS call (187,920,000
// rows, 2,099 present, G = n) that is 2,443 MB, of which the starts are
// 1,503 MB. Reading every key through scan_kernel and writing the starts
// past the last group in a second launch, which could only start once the
// scan had finished, took 2.15 ms there on an H100 (1.24 and 0.92).
constexpr int kGItems = 16;
constexpr int kGTile = kThreads * kGItems;

template <typename K>
struct GroupArgs {
  const K* keys;
  K flip;  // undoes a 32-bit key's bias (INT32_MIN), else 0
  int pbit;
  long long n;
  long long G;
  long long ntiles;
  uint8_t* present;
  int32_t* gid;
  int64_t* starts2;
  long long* ngroups;
  bool vec;  // keys, present, gid and starts2 16-byte aligned
};

template <typename K>
__device__ __forceinline__ bool is_absent(K k, const GroupArgs<K>& a) {
  return (((k ^ a.flip) >> a.pbit) & 1) != 0;
}

// warp 0: the count of first rows before `tile` (tile > 0), from the tile
// words of the tiles before it, 32 at a time, back to the nearest that
// holds its inclusive prefix (tile 0 always does)
__device__ int32_t count_before(const u64* st, long long tile,
                                unsigned epoch, int lane) {
  uint32_t acc = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long t = end - 31 + lane;
    uint32_t v = 0;
    bool stop = t < 0;
    if (t >= 0) {
      u64 w, b;
      load_state<int32_t>(st, t, w, b);
      while (!published(w, epoch)) {
        __nanosleep(32);
        load_state<int32_t>(st, t, w, b);
      }
      v = static_cast<uint32_t>(b);
      stop = ((w >> 32) & 3u) == lookback::kPrefix;
    }
    const unsigned m = __ballot_sync(kFull, stop);
    // the lanes from the last that holds a prefix on
    const int from = m ? 31 - __clz(static_cast<int>(m)) : 0;
    acc += __reduce_add_sync(kFull, lane >= from ? v : 0u);
    if (m) return static_cast<int32_t>(acc);
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads, 6)
    group_bounds_kernel(GroupArgs<K> a, u64* st, u64* ctr) {
  __shared__ long long s_tile;
  __shared__ unsigned s_epoch;
  __shared__ bool s_absent;
  __shared__ int32_t s_warp[kWarps];
  __shared__ int32_t s_pre;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) {
    const lookback::Draw d = lookback::take(ctr, a.ntiles - 1);
    s_tile = d.id;
    s_epoch = d.epoch;
    s_absent = is_absent(a.keys[d.id * kGTile], a);
  }
  __syncthreads();
  const long long tile = s_tile;
  const unsigned epoch = s_epoch;
  const bool absent = s_absent;
  const long long n = a.n;
  const long long r0 = tile * kGTile;
  const long long base = r0 + static_cast<long long>(t) * kGItems;

  // this thread's present and first rows (bit k: row base + k)
  unsigned pres = 0, first = 0;
  if (!absent) {
    // a 16-byte load at a time, its keys taken at once
    constexpr int kPer = 16 / sizeof(K);
    const bool whole = a.vec && base + kGItems <= n;
    K prev = base > 0 && base <= n ? a.keys[base - 1] : K{};
#pragma unroll
    for (int j = 0; j < kGItems / kPer; ++j) {
      K kk[kPer];
      if (whole) {
        const uint4 w = reinterpret_cast<const uint4*>(a.keys + base)[j];
        memcpy(kk, &w, sizeof(w));
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const long long r = base + j * kPer + i;
          kk[i] = r < n ? a.keys[r] : K{};
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = j * kPer + i;
        const long long r = base + k;
        const bool pr = r < n && !is_absent(kk[i], a);
        pres |= pr ? 1u << k : 0u;
        first |= pr && (r == 0 || kk[i] != prev) ? 1u << k : 0u;
        prev = kk[i];
      }
    }
  }
  // the tile's count of first rows and the count before this thread's rows
  const int32_t mine = __popc(first);
  int32_t x = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;

  // the defaults of this tile's slots of starts2: n, and 0 at slot 0
  const long long s_hi = r0 + kGTile < a.G ? r0 + kGTile : a.G;
  if (r0 < s_hi) {
    constexpr int kPairs = kGTile / 2;  // two int64 slots a 16-byte store
    for (int j = t; j < kPairs; j += kThreads) {
      const long long s0 = r0 + 2 * j;
      const long long v0 = s0 == 0 ? 0 : n;
      if (a.vec && s0 + 1 < s_hi) {
        const longlong2 v = make_longlong2(v0, n);
        *reinterpret_cast<longlong2*>(a.starts2 + s0) = v;
      } else if (s0 < s_hi) {
        a.starts2[s0] = v0;
      }
    }
  }
  __syncthreads();
  int32_t before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    agg += s_warp[w];
  }
  before += x - mine;
  if (t == 0) {
    // the defaults reach memory before the tile's word
    __threadfence();
    publish(st, tile, epoch, tile == 0 ? lookback::kPrefix : lookback::kAgg,
            agg, false);
  }
  if (warp == 0) {
    int32_t pre = 0;
    if (tile > 0) {
      pre = count_before(st, tile, epoch, lane);
      // what the words read publish, before anything this tile stores
      __threadfence();
      __syncwarp();
      if (lane == 0) {
        __threadfence();
        publish(st, tile, epoch, lookback::kPrefix, pre + agg, false);
      }
    }
    if (lane == 0) s_pre = pre;
  }
  __syncthreads();
  const int32_t pre = s_pre;
  const long long last = n - 1;
  if (absent) {
    // every row absent: presence 0, one group id
    long long g = static_cast<long long>(pre) - 1;
    g = g < 0 ? 0 : (g > a.G - 1 ? a.G - 1 : g);
    const long long r1 = r0 + kGTile < n ? r0 + kGTile : n;
    for (int j = t; j < kGTile / 16; j += kThreads) {
      const long long i = r0 + 16 * j;
      if (a.vec && i + 16 <= r1)
        *reinterpret_cast<uint4*>(a.present + i) = make_uint4(0, 0, 0, 0);
      else
        for (long long k = i; k < r1 && k < i + 16; ++k) a.present[k] = 0;
    }
    const int32_t gv = static_cast<int32_t>(g);
    for (int j = t; j < kGTile / 4; j += kThreads) {
      const long long i = r0 + 4 * j;
      if (a.vec && i + 4 <= r1)
        *reinterpret_cast<int4*>(a.gid + i) = make_int4(gv, gv, gv, gv);
      else
        for (long long k = i; k < r1 && k < i + 4; ++k) a.gid[k] = gv;
    }
    if (t == 0 && r0 <= last && last < r0 + kGTile) *a.ngroups = pre;
    return;
  }
  // each thread's rows, 4 at a time: their group ids (16-byte stores),
  // their presence bytes (one 16-byte store), each first row's start
  int32_t c = pre + before;
  const bool whole = a.vec && base + kGItems <= n;
  uint32_t pw[kGItems / 4];
#pragma unroll
  for (int q = 0; q < kGItems / 4; ++q) {
    int32_t g4[4];
    uint32_t pb = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * q + i;
      const bool fi = (first >> k) & 1u;
      c += fi ? 1 : 0;
      const long long cc = static_cast<long long>(c) - 1;
      g4[i] = static_cast<int32_t>(cc < 0 ? 0 : (cc > a.G - 1 ? a.G - 1 : cc));
      pb |= ((pres >> k) & 1u) << (8 * i);
      if (fi && cc < a.G) a.starts2[cc] = base + k;
      if (base + k == last) *a.ngroups = c;
    }
    pw[q] = pb;
    if (whole) {
      *reinterpret_cast<int4*>(a.gid + base + 4 * q) =
          make_int4(g4[0], g4[1], g4[2], g4[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = base + 4 * q + i;
        if (r < n) {
          a.gid[r] = g4[i];
          a.present[r] = static_cast<uint8_t>((pb >> (8 * i)) & 1u);
        }
      }
    }
  }
  if (whole)
    *reinterpret_cast<uint4*>(a.present + base) =
        make_uint4(pw[0], pw[1], pw[2], pw[3]);
}

unsigned grid_for(long long m) {
  long long g = (m + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > 65535LL * 32) g = 65535LL * 32;
  return static_cast<unsigned>(g);
}

// blocks for a fill whose length only the card knows: enough to fill the
// card, each looping over its share
unsigned fill_grid(long long m) {
  const unsigned g = grid_for(m);
  return g < kFillBlocks ? g : kFillBlocks;
}

bool aligned(const void* p, uintptr_t a) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % a == 0;
}

struct State {
  u64* words;
  u64* ctr;
};

template <typename V, int OP, typename Src, typename Sink>
void launch(const Src& src, const Sink& sink, long long n, const State& s,
            cudaStream_t stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  scan_kernel<V, OP, Src, Sink><<<static_cast<unsigned>(ntiles), kThreads, 0,
                                  stream>>>(src, sink, n, ntiles, s.words,
                                            s.ctr);
}

// ---- entry bodies, one per (value type, op)

enum Mode { kEnds = 0, kRows = 1, kAtPend = 2 };

struct Args {
  const void* data;
  const void* gid;    // K5
  const void* flags;  // windows (nullptr: seg_len)
  long long seg_len;
  long long n;
  const void* at;     // K5 starts2 / part_reduce_broadcast pend
  int at64;
  long long G;        // K5 groups
  void* tail;         // K5's first group ending at the last row (int64)
  void* run;          // part_reduce_broadcast's stored scan
  void* out;
  State state;
};

template <typename V, int OP>
void run_mode(int mode, const Args& a, cudaStream_t s) {
  const V* data = static_cast<const V*>(a.data);
  V* out = static_cast<V*>(a.out);
  if (mode == kEnds) {
    GidSource<V> src{data, static_cast<const int32_t*>(a.gid),
                     aligned(a.data, 16) && aligned(a.gid, 16)};
    long long* tail = static_cast<long long*>(a.tail);
    if (a.at64)
      launch<V, OP>(src, EndsSink<V, int64_t, OP>{
                        static_cast<const int64_t*>(a.at), a.G, out, tail},
                    a.n, a.state, s);
    else
      launch<V, OP>(src, EndsSink<V, int32_t, OP>{
                        static_cast<const int32_t*>(a.at), a.G, out, tail},
                    a.n, a.state, s);
    ends_tail<V><<<fill_grid(a.G), kThreads, 0, s>>>(out, a.G, tail,
                                                     OP == kSum);
    return;
  }
  FlagSource<V> src{data, static_cast<const uint8_t*>(a.flags), a.seg_len,
                    aligned(a.data, 16) && aligned(a.flags, 8)};
  V* rows = mode == kRows ? out : static_cast<V*>(a.run);
  launch<V, OP>(src, RowSink<V>{rows, aligned(rows, 16)}, a.n, a.state, s);
  if (mode == kRows) return;
  if (a.at64)
    gather_at<V, int64_t><<<grid_for(a.n), kThreads, 0, s>>>(
        rows, static_cast<const int64_t*>(a.at), a.n, out);
  else
    gather_at<V, int32_t><<<grid_for(a.n), kThreads, 0, s>>>(
        rows, static_cast<const int32_t*>(a.at), a.n, out);
}

template <typename V>
int dispatch_op(int opc, int mode, const Args& a, cudaStream_t s) {
  switch (opc) {
    case kSum:
      run_mode<V, kSum>(mode, a, s);
      break;
    case kMin:
      run_mode<V, kMin>(mode, a, s);
      break;
    case kMax:
      run_mode<V, kMax>(mode, a, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int vtype, int opc, int mode, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vtype) {
    case 0:
      return dispatch_op<int32_t>(opc, mode, a, s);
    case 1:
      return dispatch_op<int64_t>(opc, mode, a, s);
    case 2:
      return dispatch_op<float>(opc, mode, a, s);
    case 3:
      return dispatch_op<double>(opc, mode, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

State state_of(void* words, void* ctr) {
  return State{static_cast<u64*>(words), static_cast<u64*>(ctr)};
}

}  // namespace

extern "C" {

int nds_seg_scan_tile() { return kTile; }

int nds_seg_scan_state_words() { return kStateWords; }

int nds_group_bounds_tile() { return kGTile; }

// Every entry takes the tile state `words` (int64[nds_seg_scan_state_words()
// * ceil(n / nds_seg_scan_tile())]) and the counter word `ctr` (int64[1]:
// the next launch's epoch << 32, its tile id 0; each launch draws one epoch
// from it, and no word of `words` may hold that epoch or a later one). n >= 1.

// K5. vtype: 0 int32, 1 int64, 2 float32, 3 float64. op: 0 sum, 1 min, 2
// max. gid: int32[n] sorted; starts2: int32 or int64 [G], non-decreasing
// (each group's first sorted row, n past the last group). out: V[G]; a sum
// writes 0 for a group with no rows. tail: int64[1] scratch. G >= 1. Two
// launches: the scan, then the groups after the first that ends at the last
// row.
int nds_seg_reduce_at_ends(const void* data, int vtype, int opc,
                           const void* gid, long long n, const void* starts2,
                           int starts64, long long G, void* out, void* tail,
                           void* words, void* ctr, void* stream) {
  if (n < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{data, gid, nullptr, 0, n, starts2, starts64, G, tail, nullptr, out,
         state_of(words, ctr)};
  return dispatch(vtype, opc, kEnds, a, stream);
}

// K7 seg_scan, per row. op: 0 sum, 1 min, 2 max. flags: bool[n], or null
// for a reset every seg_len rows (seg_len = n: one segment, the running
// max of the windows). out: V[n].
int nds_seg_scan(const void* data, int vtype, int opc, const void* flags,
                 long long seg_len, long long n, void* out, void* words,
                 void* ctr, void* stream) {
  if (n < 1 || (flags == nullptr && seg_len < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{data, nullptr, flags, seg_len, n, nullptr, 0, 0, nullptr, nullptr,
         out, state_of(words, ctr)};
  return dispatch(vtype, opc, kRows, a, stream);
}

// K7 part_reduce_broadcast: out[i] = scan at pend[i] (int32 or int64 [n]).
// part_start: bool[n]. run: V[n] scratch (the stored scan).
int nds_part_reduce_broadcast(const void* data, int vtype, int opc,
                              const void* part_start, long long n,
                              const void* pend, int pend64, void* out,
                              void* run, void* words, void* ctr,
                              void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{data, nullptr, part_start, 0, n, pend, pend64, 0, nullptr, run, out,
         state_of(words, ctr)};
  return dispatch(vtype, opc, kAtPend, a, stream);
}

// K7 last_of_group: change bool[n] -> out int32[n]. 1 <= n < 2^31 - 1.
int nds_last_of_group(const void* change, long long n, void* out, void* words,
                      void* ctr, void* stream) {
  if (n < 1 || n >= 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  launch<int32_t, kMin>(NextChangeSource{static_cast<const uint8_t*>(change)},
                        LastSink{static_cast<int32_t*>(out),
                                 aligned(out, 16) && n % 4 == 0},
                        n, state_of(words, ctr),
                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// L2 group_bounds. keys: the packed group keys, sorted, int32 or int64
// (key64) [n], the presence bit at pbit (set for absent rows); non-negative,
// except a 32-bit key (int32, pbit 31), which is biased by -2^31. present:
// bool[n]; gid: int32[n]; starts2: int64[G]; ngroups: int64[1]. words holds
// the tile state of ceil(n / nds_group_bounds_tile()) tiles.
// 1 <= n < 2^31 - 1, 1 <= G <= n. One launch.
int nds_group_bounds(const void* keys, int key64, int pbit, long long n,
                     long long G, void* present, void* gid, void* starts2,
                     void* ngroups, void* words, void* ctr, void* stream) {
  if (n < 1 || n >= 2147483647LL || G < 1 || G > n || pbit < 0 ||
      pbit > (key64 ? 62 : 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + kGTile - 1) / kGTile;
  const bool vec = aligned(keys, 16) && aligned(present, 16) &&
                   aligned(gid, 16) && aligned(starts2, 16);
  uint8_t* pr = static_cast<uint8_t*>(present);
  int32_t* gi = static_cast<int32_t*>(gid);
  int64_t* st2 = static_cast<int64_t*>(starts2);
  long long* ng = static_cast<long long*>(ngroups);
  const State state = state_of(words, ctr);
  if (key64)
    group_bounds_kernel<int64_t>
        <<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
            GroupArgs<int64_t>{static_cast<const int64_t*>(keys), 0, pbit, n,
                               G, ntiles, pr, gi, st2, ng, vec},
            state.words, state.ctr);
  else
    group_bounds_kernel<int32_t>
        <<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
            GroupArgs<int32_t>{static_cast<const int32_t*>(keys),
                               pbit == 31 ? INT32_MIN : 0, pbit, n, G, ntiles,
                               pr, gi, st2, ng, vec},
            state.words, state.ctr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
