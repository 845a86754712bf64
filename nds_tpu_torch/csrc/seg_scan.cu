// Segmented min/max scan read at group ends (K5).
//
// Replaces nds_tpu/engine/kernels.py `seg_scan` (a (value, reset-flag)
// associative scan) and `seg_reduce_at_ends` (that scan gathered at each
// group's last sorted row). Segments start where the sorted group id changes
// (and at row 0). The output has one slot per entry of `starts2` (the first
// sorted row of each group, n past the last group): slot g reads the scan at
// clamp(starts2[g+1] - 1, 0, n - 1), with n standing in for starts2[G], so a
// padding slot past the last group reads the scan at row n - 1, exactly as
// the JAX version does.
//
// Three passes, a true segmented scan whose carry crosses blocks:
//   1. scan_tiles: each block scans one tile of 1024 rows (4 per thread) in
//      registers and shared memory, writing the tile-local inclusive scan
//      value and a flag "a segment started between the tile start and this
//      row", and the tile's aggregate (value, any-flag).
//   2. scan_carries: one block scans the tile aggregates, giving the global
//      scan value at the end of every tile.
//   3. gather_ends: each output slot reads its end row; if no segment started
//      in that row's tile before it, the previous tile's carry is combined in.
// The combiner is (a, b) -> (b.flag ? b.v : op(a.v, b.v), a.flag | b.flag).
// min/max on floats propagate NaN, as jnp.minimum/maximum do.
//
// What bounds it on an H100: bytes. At n = 6,001,215 with int64 values the
// function must read 6.0M x (8 + 4) bytes and write G values; the passes also
// write and re-read the n-row scan (values + one flag byte) once, so this
// simple version moves about twice the bytes it must. The reads and writes of
// passes 1 and 3 are coalesced; pass 2 touches only n / 1024 entries.
//
// The entry point launches on the given stream, allocates nothing (the caller
// passes run, flags, tile aggregates and carries as scratch) and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;

template <typename V>
__device__ __forceinline__ bool is_nan(V) { return false; }
template <>
__device__ __forceinline__ bool is_nan<float>(float v) { return v != v; }
template <>
__device__ __forceinline__ bool is_nan<double>(double v) { return v != v; }

template <typename V, bool IsMax>
__device__ __forceinline__ V op(V a, V b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  if (IsMax) return b > a ? b : a;
  return b < a ? b : a;
}

template <typename V, bool IsMax>
__device__ __forceinline__ void combine(V av, bool af, V& bv, bool& bf) {
  // (a, b) -> b in place
  if (!bf) bv = op<V, IsMax>(av, bv);
  bf = bf || af;
}

// inclusive segmented scan of (v, f) over the threads of one block
template <typename V, bool IsMax, int N>
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
      combine<V, IsMax>(pv, pf, v, f);
      sv[t] = v;
      sf[t] = f;
    }
    __syncthreads();
  }
}

template <typename V, bool IsMax>
__global__ void scan_tiles(const V* __restrict__ data,
                           const int32_t* __restrict__ gid, long long n,
                           V* __restrict__ run, uint8_t* __restrict__ fl,
                           V* __restrict__ tile_v, uint8_t* __restrict__ tile_f) {
  __shared__ V sv[kThreads];
  __shared__ bool sf[kThreads];
  const long long base = blockIdx.x * (long long)kTile + threadIdx.x * kItems;
  V v[kItems];
  bool f[kItems];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < n) {
      v[k] = data[i];
      f[k] = (i == 0) || (gid[i] != gid[i - 1]);
    } else {
      // past the end: a fresh segment that no written row reads
      v[k] = data[n - 1];
      f[k] = true;
    }
    if (k > 0) combine<V, IsMax>(v[k - 1], f[k - 1], v[k], f[k]);
  }
  // exclusive prefix over the threads before this one
  V tv = v[kItems - 1];
  bool tf = f[kItems - 1];
  block_scan<V, IsMax, kThreads>(tv, tf, sv, sf);
  const int t = threadIdx.x;
  if (t > 0) {
    const V pv = sv[t - 1];
    const bool pf = sf[t - 1];
    for (int k = 0; k < kItems; ++k) combine<V, IsMax>(pv, pf, v[k], f[k]);
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
template <typename V, bool IsMax>
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
    if (b > b0) combine<V, IsMax>(acc, af, bv, bf);
    acc = bv;
    af = bf;
  }
  V tv = acc;
  bool tf = af;
  block_scan<V, IsMax, kCarryThreads>(tv, tf, sv, sf);
  bool have = t > 0;
  V pv = have ? sv[t - 1] : acc;
  bool pf = have ? sf[t - 1] : false;
  for (long long b = b0; b < b1; ++b) {
    V bv = tile_v[b];
    bool bf = tile_f[b] != 0;
    if (have) combine<V, IsMax>(pv, pf, bv, bf);
    carry[b] = bv;
    pv = bv;
    pf = bf;
    have = true;
  }
}

template <typename V, bool IsMax, typename S>
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
    V v = run[e];
    const long long b = e / kTile;
    if (b > 0 && !fl[e]) v = op<V, IsMax>(carry[b - 1], v);
    out[g] = v;
  }
}

template <typename V, bool IsMax>
int run_t(const void* data, const void* gid, long long n, const void* starts2,
          int starts64, long long G, void* run, void* fl, void* tile_v,
          void* tile_f, void* carry, void* out, cudaStream_t s) {
  const long long ntiles = (n + kTile - 1) / kTile;
  scan_tiles<V, IsMax><<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      static_cast<const V*>(data), static_cast<const int32_t*>(gid), n,
      static_cast<V*>(run), static_cast<uint8_t*>(fl), static_cast<V*>(tile_v),
      static_cast<uint8_t*>(tile_f));
  scan_carries<V, IsMax><<<1, kCarryThreads, 0, s>>>(
      static_cast<const V*>(tile_v), static_cast<const uint8_t*>(tile_f),
      ntiles, static_cast<V*>(carry));
  long long gb = (G + kThreads - 1) / kThreads;
  if (gb < 1) gb = 1;
  if (gb > 65535LL * 32) gb = 65535LL * 32;
  if (starts64)
    gather_ends<V, IsMax, int64_t><<<static_cast<unsigned>(gb), kThreads, 0, s>>>(
        static_cast<const V*>(run), static_cast<const uint8_t*>(fl),
        static_cast<const V*>(carry), static_cast<const int64_t*>(starts2), G,
        n, static_cast<V*>(out));
  else
    gather_ends<V, IsMax, int32_t><<<static_cast<unsigned>(gb), kThreads, 0, s>>>(
        static_cast<const V*>(run), static_cast<const uint8_t*>(fl),
        static_cast<const V*>(carry), static_cast<const int32_t*>(starts2), G,
        n, static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int dispatch_op(int is_max, const void* data, const void* gid, long long n,
                const void* starts2, int starts64, long long G, void* run,
                void* fl, void* tile_v, void* tile_f, void* carry, void* out,
                cudaStream_t s) {
  if (is_max)
    return run_t<V, true>(data, gid, n, starts2, starts64, G, run, fl, tile_v,
                          tile_f, carry, out, s);
  return run_t<V, false>(data, gid, n, starts2, starts64, G, run, fl, tile_v,
                         tile_f, carry, out, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vtype) {
    case 0:
      return dispatch_op<int32_t>(is_max, data, gid, n, starts2, starts64, G,
                                  run, fl, tile_v, tile_f, carry, out, s);
    case 1:
      return dispatch_op<int64_t>(is_max, data, gid, n, starts2, starts64, G,
                                  run, fl, tile_v, tile_f, carry, out, s);
    case 2:
      return dispatch_op<float>(is_max, data, gid, n, starts2, starts64, G,
                                run, fl, tile_v, tile_f, carry, out, s);
    case 3:
      return dispatch_op<double>(is_max, data, gid, n, starts2, starts64, G,
                                 run, fl, tile_v, tile_f, carry, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
