// Segmented scans (K5 and K7).
//
// Replaces nds_tpu/engine/kernels.py `seg_scan` (a (value, reset-flag)
// associative scan with op +, min or max), `seg_reduce_at_ends` (that scan
// gathered at each group's last sorted row, K5), `part_reduce_broadcast` (the
// scan read at each row's partition end, K7) and `last_of_group` (a reversed
// running min of the next change position, K7). One scan implementation
// serves all of them, and the prefix of match counts inside
// partitioned_join.cu's M:N join (K6) too.
//
// Three passes, a true segmented scan whose carry crosses blocks:
//   1. scan_tiles: each block scans one tile of 1024 rows (4 per thread) in
//      registers and shared memory, writing the tile-local inclusive scan
//      value and a flag "a segment started between the tile start and this
//      row", and the tile's aggregate (value, any-flag).
//   2. scan_carries: one block scans the tile aggregates, giving the global
//      scan value at the end of every tile.
//   3. a finishing pass folds the previous tile's carry into every row read
//      where no segment started in its tile before it: per row in place
//      (seg_scan), at each row's partition end (part_reduce_broadcast), at
//      each group's end (seg_reduce_at_ends), or per row in reverse order with
//      the final minus-one and clip (last_of_group).
// The combiner is (a, b) -> (b.flag ? b.v : op(a.v, b.v), a.flag | b.flag).
// min/max on floats propagate NaN, as jnp.minimum/maximum do. An integer sum
// wraps in two's complement, as the JAX scan's does; int32 counts stay int32.
// A float sum associates in the tile order above, not in
// lax.associative_scan's, so float sums agree to rounding, not bit for bit.
//
// Where the segment flags come from: K5 compares neighbouring group ids, the
// window scans read a bool flag per row, K6's prefix restarts every `seg_len`
// rows, and last_of_group has none (one segment, scanned from the end, over
// the values "next change position" computed from the change flags).
//
// What bounds it on an H100: bytes. The function must read n values and n
// flags and write n values (or G for K5); the passes also write and re-read
// the n-row tile scan and one flag byte per row, so this simple version moves
// about twice the bytes it must. The reads and writes of passes 1 and 3 are
// coalesced except the gathers at pend, which follow the sorted partition
// ends and so hit few distinct lines; pass 2 touches only n / 1024 entries.
//
// The entry points launch on the given stream, allocate nothing (the caller
// passes every output and scratch buffer) and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;

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

template <typename V, int OP>
__device__ __forceinline__ void combine(V av, bool af, V& bv, bool& bf) {
  // (a, b) -> b in place
  if (!bf) bv = op<V, OP>(av, bv);
  bf = bf || af;
}

// inclusive segmented scan of (v, f) over the threads of one block
template <typename V, int OP, int N>
__device__ void block_scan(V& v, bool& f, V* sv, bool* sf) {
  const int t = threadIdx.x;
  sv[t] = v;
  sf[t] = f;
  __syncthreads();
  for (int d = 1; d < N; d <<= 1) {
    V pv = v;
    bool pf = false;
    const bool has = t >= d;
    if (has) {
      pv = sv[t - d];
      pf = sf[t - d];
    }
    __syncthreads();
    if (has) {
      combine<V, OP>(pv, pf, v, f);
      sv[t] = v;
      sf[t] = f;
    }
    __syncthreads();
  }
}

// ---- sources of (value, reset flag) per scanned row

// K5: values, a segment at every change of the sorted group id
template <typename V>
struct GidSource {
  const V* data;
  const int32_t* gid;
  __device__ void load(long long i, V& v, bool& f) const {
    v = data[i];
    f = (i == 0) || (gid[i] != gid[i - 1]);
  }
};

// windows: values and one bool flag per row; with no flags, a segment
// every seg_len rows (K6's per-partition prefix)
template <typename V>
struct FlagSource {
  const V* data;
  const uint8_t* flags;
  long long seg_len;
  __device__ void load(long long i, V& v, bool& f) const {
    v = data[i];
    f = flags != nullptr ? flags[i] != 0 : (i % seg_len) == 0;
  }
};

// last_of_group: scanned row k is row i = n - 1 - k, whose value is the
// position of the next change after it (n where there is none)
struct NextChangeSource {
  const uint8_t* change;
  long long n;
  __device__ void load(long long k, int32_t& v, bool& f) const {
    const long long i = n - 1 - k;
    v = static_cast<int32_t>((i + 1 < n && change[i + 1]) ? i + 1 : n);
    f = false;
  }
};

template <typename V, int OP, typename Src>
__global__ void scan_tiles(Src src, long long n, V* __restrict__ run,
                           uint8_t* __restrict__ fl, V* __restrict__ tile_v,
                           uint8_t* __restrict__ tile_f) {
  __shared__ V sv[kThreads];
  __shared__ bool sf[kThreads];
  const long long base = blockIdx.x * (long long)kTile + threadIdx.x * kItems;
  V v[kItems];
  bool f[kItems];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < n) {
      src.load(i, v[k], f[k]);
    } else {
      // past the end: a fresh segment that no written row reads
      src.load(n - 1, v[k], f[k]);
      f[k] = true;
    }
    if (k > 0) combine<V, OP>(v[k - 1], f[k - 1], v[k], f[k]);
  }
  // exclusive prefix over the threads before this one
  V tv = v[kItems - 1];
  bool tf = f[kItems - 1];
  block_scan<V, OP, kThreads>(tv, tf, sv, sf);
  const int t = threadIdx.x;
  if (t > 0) {
    const V pv = sv[t - 1];
    const bool pf = sf[t - 1];
    for (int k = 0; k < kItems; ++k) combine<V, OP>(pv, pf, v[k], f[k]);
  }
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < n) {
      run[i] = v[k];
      fl[i] = f[k] ? 1 : 0;
    }
  }
  if (t == kThreads - 1) {
    tile_v[blockIdx.x] = v[kItems - 1];
    tile_f[blockIdx.x] = f[kItems - 1] ? 1 : 0;
  }
}

// one block: carry[b] = global inclusive scan value at the end of tile b
template <typename V, int OP>
__global__ void scan_carries(const V* __restrict__ tile_v,
                             const uint8_t* __restrict__ tile_f,
                             long long ntiles, V* __restrict__ carry) {
  __shared__ V sv[kCarryThreads];
  __shared__ bool sf[kCarryThreads];
  const int t = threadIdx.x;
  const long long chunk = (ntiles + kCarryThreads - 1) / kCarryThreads;
  const long long b0 = t * chunk;
  const long long b1 = b0 + chunk < ntiles ? b0 + chunk : ntiles;
  // this thread's chunk aggregate. Empty chunks sit only at the tail,
  // after every real one, so the block scan below never combines one
  // into a real chunk's prefix and their value does not matter
  V acc = tile_v[0];
  bool af = false;
  for (long long b = b0; b < b1; ++b) {
    V bv = tile_v[b];
    bool bf = tile_f[b] != 0;
    if (b > b0) combine<V, OP>(acc, af, bv, bf);
    acc = bv;
    af = bf;
  }
  V tv = acc;
  bool tf = af;
  block_scan<V, OP, kCarryThreads>(tv, tf, sv, sf);
  bool have = t > 0;
  V pv = have ? sv[t - 1] : acc;
  bool pf = have ? sf[t - 1] : false;
  for (long long b = b0; b < b1; ++b) {
    V bv = tile_v[b];
    bool bf = tile_f[b] != 0;
    if (have) combine<V, OP>(pv, pf, bv, bf);
    carry[b] = bv;
    pv = bv;
    pf = bf;
    have = true;
  }
}

// the global scan value at scanned row e
template <typename V, int OP>
__device__ __forceinline__ V scan_at(const V* __restrict__ run,
                                     const uint8_t* __restrict__ fl,
                                     const V* __restrict__ carry, long long e) {
  V v = run[e];
  const long long b = e / kTile;
  if (b > 0 && !fl[e]) v = op<V, OP>(carry[b - 1], v);
  return v;
}

unsigned grid_for(long long m) {
  long long g = (m + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > 65535LL * 32) g = 65535LL * 32;
  return static_cast<unsigned>(g);
}

template <typename V, int OP>
__global__ void finish_rows(V* __restrict__ run, const uint8_t* __restrict__ fl,
                            const V* __restrict__ carry, long long n) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    const long long b = k / kTile;
    if (b > 0 && !fl[k]) run[k] = op<V, OP>(carry[b - 1], run[k]);
  }
}

template <typename V, int OP, typename S>
__global__ void gather_at(const V* __restrict__ run,
                          const uint8_t* __restrict__ fl,
                          const V* __restrict__ carry,
                          const S* __restrict__ at, long long n,
                          V* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long e = static_cast<long long>(at[i]);
    e = e < 0 ? 0 : (e > n - 1 ? n - 1 : e);
    out[i] = scan_at<V, OP>(run, fl, carry, e);
  }
}

template <typename V, int OP, typename S>
__global__ void gather_ends(const V* __restrict__ run,
                            const uint8_t* __restrict__ fl,
                            const V* __restrict__ carry,
                            const S* __restrict__ starts2, long long G,
                            long long n, V* __restrict__ out) {
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < G;
       g += (long long)gridDim.x * blockDim.x) {
    long long nxt = g + 1 < G ? static_cast<long long>(starts2[g + 1]) : n;
    long long e = nxt - 1;
    e = e < 0 ? 0 : (e > n - 1 ? n - 1 : e);
    out[g] = scan_at<V, OP>(run, fl, carry, e);
  }
}

// last_of_group: row i = n - 1 - k gets clip(scan[k] - 1, 0, n - 1)
__global__ void finish_last_of_group(const int32_t* __restrict__ run,
                                     const uint8_t* __restrict__ fl,
                                     const int32_t* __restrict__ carry,
                                     long long n, int32_t* __restrict__ out) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    long long v = static_cast<long long>(scan_at<int32_t, kMin>(run, fl, carry, k)) - 1;
    v = v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
    out[n - 1 - k] = static_cast<int32_t>(v);
  }
}

// passes 1 and 2
template <typename V, int OP, typename Src>
void scan_passes(const Src& src, long long n, V* run, uint8_t* fl, V* tile_v,
                 uint8_t* tile_f, V* carry, cudaStream_t s) {
  const long long ntiles = (n + kTile - 1) / kTile;
  scan_tiles<V, OP, Src><<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      src, n, run, fl, tile_v, tile_f);
  scan_carries<V, OP><<<1, kCarryThreads, 0, s>>>(tile_v, tile_f, ntiles,
                                                  carry);
}

// ---- entry bodies, one per (value type, op)

struct Args {
  const void* data;
  const void* gid;      // K5
  const void* flags;    // windows (nullptr: seg_len)
  long long seg_len;
  long long n;
  const void* at;       // K5 starts2 / part_reduce_broadcast pend
  int at64;
  long long G;          // K5 groups
  void* run;
  void* fl;
  void* tile_v;
  void* tile_f;
  void* carry;
  void* out;
};

enum Mode { kEnds = 0, kRows = 1, kAtPend = 2 };

template <typename V, int OP>
void run_mode(int mode, const Args& a, cudaStream_t s) {
  V* run = static_cast<V*>(a.run);
  uint8_t* fl = static_cast<uint8_t*>(a.fl);
  V* tile_v = static_cast<V*>(a.tile_v);
  uint8_t* tile_f = static_cast<uint8_t*>(a.tile_f);
  V* carry = static_cast<V*>(a.carry);
  V* out = static_cast<V*>(a.out);
  if (mode == kEnds) {
    GidSource<V> src{static_cast<const V*>(a.data),
                     static_cast<const int32_t*>(a.gid)};
    scan_passes<V, OP>(src, a.n, run, fl, tile_v, tile_f, carry, s);
    if (a.at64)
      gather_ends<V, OP, int64_t><<<grid_for(a.G), kThreads, 0, s>>>(
          run, fl, carry, static_cast<const int64_t*>(a.at), a.G, a.n, out);
    else
      gather_ends<V, OP, int32_t><<<grid_for(a.G), kThreads, 0, s>>>(
          run, fl, carry, static_cast<const int32_t*>(a.at), a.G, a.n, out);
    return;
  }
  FlagSource<V> src{static_cast<const V*>(a.data),
                    static_cast<const uint8_t*>(a.flags), a.seg_len};
  scan_passes<V, OP>(src, a.n, run, fl, tile_v, tile_f, carry, s);
  if (mode == kRows) {
    finish_rows<V, OP><<<grid_for(a.n), kThreads, 0, s>>>(run, fl, carry, a.n);
  } else if (a.at64) {
    gather_at<V, OP, int64_t><<<grid_for(a.n), kThreads, 0, s>>>(
        run, fl, carry, static_cast<const int64_t*>(a.at), a.n, out);
  } else {
    gather_at<V, OP, int32_t><<<grid_for(a.n), kThreads, 0, s>>>(
        run, fl, carry, static_cast<const int32_t*>(a.at), a.n, out);
  }
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

}  // namespace

extern "C" {

int nds_seg_scan_tile() { return kTile; }

// K5. vtype: 0 int32, 1 int64, 2 float32, 3 float64. gid: int32[n];
// starts2: int32 or int64 [G]. Scratch: run V[n], fl uint8[n],
// tile_v V[ntiles], tile_f uint8[ntiles], carry V[ntiles] with
// ntiles = ceil(n / nds_seg_scan_tile()). out: V[G]. n >= 1, G >= 1.
int nds_seg_reduce_at_ends(const void* data, int vtype, int is_max,
                           const void* gid, long long n, const void* starts2,
                           int starts64, long long G, void* run, void* fl,
                           void* tile_v, void* tile_f, void* carry, void* out,
                           void* stream) {
  if (n < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{data, gid, nullptr, 0, n, starts2, starts64, G,
         run, fl, tile_v, tile_f, carry, out};
  return dispatch(vtype, is_max ? kMax : kMin, kEnds, a, stream);
}

// K7 seg_scan, per row. op: 0 sum, 1 min, 2 max. flags: bool[n], or null
// for a reset every seg_len rows. out: V[n] (also the tile scan); fl
// uint8[n] and the tile buffers are scratch as above. n >= 1.
int nds_seg_scan(const void* data, int vtype, int opc, const void* flags,
                 long long seg_len, long long n, void* out, void* fl,
                 void* tile_v, void* tile_f, void* carry, void* stream) {
  if (n < 1 || (flags == nullptr && seg_len < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{data, nullptr, flags, seg_len, n, nullptr, 0, 0,
         out, fl, tile_v, tile_f, carry, out};
  return dispatch(vtype, opc, kRows, a, stream);
}

// K7 part_reduce_broadcast: out[i] = scan at pend[i] (int32 or int64 [n]).
// part_start: bool[n]. Scratch: run V[n], fl uint8[n], tile buffers.
int nds_part_reduce_broadcast(const void* data, int vtype, int opc,
                              const void* part_start, long long n,
                              const void* pend, int pend64, void* out,
                              void* run, void* fl, void* tile_v, void* tile_f,
                              void* carry, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{data, nullptr, part_start, 0, n, pend, pend64, 0,
         run, fl, tile_v, tile_f, carry, out};
  return dispatch(vtype, opc, kAtPend, a, stream);
}

// K7 last_of_group: change bool[n] -> out int32[n]. Scratch: run int32[n],
// fl uint8[n], tile_v int32[ntiles], tile_f uint8[ntiles], carry
// int32[ntiles]. 1 <= n < 2^31 - 1.
int nds_last_of_group(const void* change, long long n, void* out, void* run,
                      void* fl, void* tile_v, void* tile_f, void* carry,
                      void* stream) {
  if (n < 1 || n >= 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  NextChangeSource src{static_cast<const uint8_t*>(change), n};
  int32_t* r = static_cast<int32_t*>(run);
  uint8_t* f = static_cast<uint8_t*>(fl);
  int32_t* c = static_cast<int32_t*>(carry);
  scan_passes<int32_t, kMin>(src, n, r, f, static_cast<int32_t*>(tile_v),
                             static_cast<uint8_t*>(tile_f), c, s);
  finish_last_of_group<<<grid_for(n), kThreads, 0, s>>>(
      r, f, c, n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
