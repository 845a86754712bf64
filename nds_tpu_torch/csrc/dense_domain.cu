// Dense direct-address kernels over a host-bounded key domain [lo, lo+dom).
//
// Replaces three functions of nds_tpu/engine/kernels.py:
//   direct_lookup_join  (K1)  unique-build equi-join: table[key-lo] = row
//   bitmask_semi        (K3)  EXISTS membership: table[key-lo] = 1
//   keyed_minmax_semi   (K4)  EXISTS with a `<>` residual: per-key min, max
//                             and presence tables, then [min,max] != [v,v]
//
// All three share one skeleton: a fill pass sets the table to its identity,
// one build pass scatters the valid build rows into it, and one probe pass
// gathers it, fused with the in-domain test and the hit mask. Invalid build
// rows and keys outside the domain are skipped in the kernel: nothing is ever
// written out of range (the JAX version routes them to slot `dom` and lets
// the scatter drop them).
//
// What bounds them on an H100: bytes. Each probe row reads its key and its ok
// flag and writes one or two outputs; each build row reads key, flag (and a
// value) and writes one table slot; the table itself is written once by the
// fill. At the NDS-H SF1 shapes (probe 6,001,215 rows, tables of at most
// 2^23 entries, so at most 32 MiB for int32 and 64 MiB for int64 min/max
// pairs) the table stays resident in the 50 MB L2 for the int32 and byte
// tables, so the probe's random gathers mostly hit L2 and the traffic to HBM
// is the streamed key/flag/output arrays. The design keeps every pass a
// single coalesced stream over its rows (one thread per row, grid-stride) so
// that the only non-sequential access is the table gather. The unique-build
// contract means at most one valid row per slot for K1, so its build is a
// plain store; K4 uses atomicMin/atomicMax on 32- or 64-bit signed values.
//
// Every entry point launches on the stream it is given, allocates nothing
// (the caller passes the table as scratch) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned grid_for(long long n) {
  long long g = (n + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > 65535LL * 32) g = 65535LL * 32;
  return static_cast<unsigned>(g);
}

template <typename T>
__global__ void fill_kernel(T* __restrict__ t, long long n, T v) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    t[i] = v;
}

__device__ __forceinline__ long long clamp_slot(long long pos, long long dom) {
  return pos < 0 ? 0 : (pos >= dom ? dom - 1 : pos);
}

// ------------------------------------------------------------------ K1

template <typename K>
__global__ void direct_build(const K* __restrict__ bkey,
                             const uint8_t* __restrict__ bok, long long nb,
                             long long lo, long long dom,
                             int32_t* __restrict__ tbl) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nb;
       i += (long long)gridDim.x * blockDim.x) {
    if (!bok[i]) continue;
    long long s = static_cast<long long>(bkey[i]) - lo;
    if (s < 0 || s >= dom) continue;
    tbl[s] = static_cast<int32_t>(i);
  }
}

template <typename K>
__global__ void direct_probe(const K* __restrict__ pkey,
                             const uint8_t* __restrict__ pok, long long np,
                             long long lo, long long dom,
                             const int32_t* __restrict__ tbl,
                             int32_t* __restrict__ ridx,
                             uint8_t* __restrict__ hit) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < np;
       i += (long long)gridDim.x * blockDim.x) {
    long long pos = static_cast<long long>(pkey[i]) - lo;
    bool inb = pos >= 0 && pos < dom;
    int32_t r = tbl[clamp_slot(pos, dom)];
    hit[i] = (pok[i] && inb && r >= 0) ? 1 : 0;
    ridx[i] = r < 0 ? 0 : r;
  }
}

// ------------------------------------------------------------------ K3

template <typename K>
__global__ void bitmask_build(const K* __restrict__ bkey,
                              const uint8_t* __restrict__ bok, long long nb,
                              long long lo, long long dom,
                              uint8_t* __restrict__ bm) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nb;
       i += (long long)gridDim.x * blockDim.x) {
    if (!bok[i]) continue;
    long long s = static_cast<long long>(bkey[i]) - lo;
    if (s < 0 || s >= dom) continue;
    bm[s] = 1;
  }
}

template <typename K>
__global__ void bitmask_probe(const K* __restrict__ pkey,
                              const uint8_t* __restrict__ pok, long long np,
                              long long lo, long long dom,
                              const uint8_t* __restrict__ bm,
                              uint8_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < np;
       i += (long long)gridDim.x * blockDim.x) {
    long long pos = static_cast<long long>(pkey[i]) - lo;
    bool inb = pos >= 0 && pos < dom;
    out[i] = (pok[i] && inb && bm[clamp_slot(pos, dom)]) ? 1 : 0;
  }
}

// ------------------------------------------------------------------ K4

__device__ __forceinline__ void atomic_min_v(int32_t* a, int32_t v) {
  atomicMin(reinterpret_cast<int*>(a), static_cast<int>(v));
}
__device__ __forceinline__ void atomic_max_v(int32_t* a, int32_t v) {
  atomicMax(reinterpret_cast<int*>(a), static_cast<int>(v));
}
__device__ __forceinline__ void atomic_min_v(int64_t* a, int64_t v) {
  atomicMin(reinterpret_cast<long long*>(a), static_cast<long long>(v));
}
__device__ __forceinline__ void atomic_max_v(int64_t* a, int64_t v) {
  atomicMax(reinterpret_cast<long long*>(a), static_cast<long long>(v));
}

template <typename K, typename V>
__global__ void minmax_build(const K* __restrict__ bkey,
                             const uint8_t* __restrict__ bok,
                             const V* __restrict__ bval, long long nb,
                             long long lo, long long dom, V* __restrict__ mn,
                             V* __restrict__ mx, uint8_t* __restrict__ present) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nb;
       i += (long long)gridDim.x * blockDim.x) {
    if (!bok[i]) continue;
    long long s = static_cast<long long>(bkey[i]) - lo;
    if (s < 0 || s >= dom) continue;
    V v = bval[i];
    atomic_min_v(mn + s, v);
    atomic_max_v(mx + s, v);
    present[s] = 1;
  }
}

template <typename K, typename V>
__global__ void minmax_probe(const K* __restrict__ pkey,
                             const uint8_t* __restrict__ pok,
                             const V* __restrict__ pval, long long np,
                             long long lo, long long dom,
                             const V* __restrict__ mn, const V* __restrict__ mx,
                             const uint8_t* __restrict__ present,
                             uint8_t* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < np;
       i += (long long)gridDim.x * blockDim.x) {
    long long pos = static_cast<long long>(pkey[i]) - lo;
    bool inb = pos >= 0 && pos < dom;
    long long at = clamp_slot(pos, dom);
    V v = pval[i];
    bool has_key = pok[i] && inb && present[at];
    bool differs = (mn[at] != v) || (mx[at] != v);
    out[i] = (has_key && differs) ? 1 : 0;
  }
}

template <typename K>
int direct_join_t(const void* bkey, const void* bok, long long nb,
                  const void* pkey, const void* pok, long long np,
                  long long lo, long long dom, void* tbl, void* ridx,
                  void* hit, cudaStream_t s) {
  fill_kernel<int32_t><<<grid_for(dom), kThreads, 0, s>>>(
      static_cast<int32_t*>(tbl), dom, -1);
  direct_build<K><<<grid_for(nb), kThreads, 0, s>>>(
      static_cast<const K*>(bkey), static_cast<const uint8_t*>(bok), nb, lo,
      dom, static_cast<int32_t*>(tbl));
  direct_probe<K><<<grid_for(np), kThreads, 0, s>>>(
      static_cast<const K*>(pkey), static_cast<const uint8_t*>(pok), np, lo,
      dom, static_cast<const int32_t*>(tbl), static_cast<int32_t*>(ridx),
      static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int bitmask_t(const void* bkey, const void* bok, long long nb,
              const void* pkey, const void* pok, long long np, long long lo,
              long long dom, void* bm, void* out, cudaStream_t s) {
  fill_kernel<uint8_t><<<grid_for(dom), kThreads, 0, s>>>(
      static_cast<uint8_t*>(bm), dom, 0);
  bitmask_build<K><<<grid_for(nb), kThreads, 0, s>>>(
      static_cast<const K*>(bkey), static_cast<const uint8_t*>(bok), nb, lo,
      dom, static_cast<uint8_t*>(bm));
  bitmask_probe<K><<<grid_for(np), kThreads, 0, s>>>(
      static_cast<const K*>(pkey), static_cast<const uint8_t*>(pok), np, lo,
      dom, static_cast<const uint8_t*>(bm), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename K, typename V>
int minmax_t(const void* bkey, const void* bok, const void* bval, long long nb,
             const void* pkey, const void* pok, const void* pval, long long np,
             long long lo, long long dom, void* mn, void* mx, void* present,
             void* out, V vmax, V vmin, cudaStream_t s) {
  fill_kernel<V><<<grid_for(dom), kThreads, 0, s>>>(static_cast<V*>(mn), dom,
                                                    vmax);
  fill_kernel<V><<<grid_for(dom), kThreads, 0, s>>>(static_cast<V*>(mx), dom,
                                                    vmin);
  fill_kernel<uint8_t><<<grid_for(dom), kThreads, 0, s>>>(
      static_cast<uint8_t*>(present), dom, 0);
  minmax_build<K, V><<<grid_for(nb), kThreads, 0, s>>>(
      static_cast<const K*>(bkey), static_cast<const uint8_t*>(bok),
      static_cast<const V*>(bval), nb, lo, dom, static_cast<V*>(mn),
      static_cast<V*>(mx), static_cast<uint8_t*>(present));
  minmax_probe<K, V><<<grid_for(np), kThreads, 0, s>>>(
      static_cast<const K*>(pkey), static_cast<const uint8_t*>(pok),
      static_cast<const V*>(pval), np, lo, dom, static_cast<const V*>(mn),
      static_cast<const V*>(mx), static_cast<const uint8_t*>(present),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1. tbl: int32[dom] scratch; ridx: int32[np]; hit: uint8[np].
int nds_direct_lookup_join(const void* bkey, const void* bok, long long nb,
                           const void* pkey, const void* pok, long long np,
                           int key64, long long lo, long long dom, void* tbl,
                           void* ridx, void* hit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return key64 ? direct_join_t<int64_t>(bkey, bok, nb, pkey, pok, np, lo, dom,
                                        tbl, ridx, hit, s)
               : direct_join_t<int32_t>(bkey, bok, nb, pkey, pok, np, lo, dom,
                                        tbl, ridx, hit, s);
}

// K3. bm: uint8[dom] scratch; out: uint8[np].
int nds_bitmask_semi(const void* bkey, const void* bok, long long nb,
                     const void* pkey, const void* pok, long long np,
                     int key64, long long lo, long long dom, void* bm,
                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return key64 ? bitmask_t<int64_t>(bkey, bok, nb, pkey, pok, np, lo, dom, bm,
                                    out, s)
               : bitmask_t<int32_t>(bkey, bok, nb, pkey, pok, np, lo, dom, bm,
                                    out, s);
}

// K4. mn, mx: value-typed [dom] scratch; present: uint8[dom] scratch;
// out: uint8[np].
int nds_keyed_minmax_semi(const void* bkey, const void* bok, const void* bval,
                          long long nb, const void* pkey, const void* pok,
                          const void* pval, long long np, int key64, int val64,
                          long long lo, long long dom, void* mn, void* mx,
                          void* present, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t i64max = INT64_MAX, i64min = INT64_MIN;
  const int32_t i32max = INT32_MAX, i32min = INT32_MIN;
  if (key64 && val64)
    return minmax_t<int64_t, int64_t>(bkey, bok, bval, nb, pkey, pok, pval, np,
                                      lo, dom, mn, mx, present, out, i64max,
                                      i64min, s);
  if (key64)
    return minmax_t<int64_t, int32_t>(bkey, bok, bval, nb, pkey, pok, pval, np,
                                      lo, dom, mn, mx, present, out, i32max,
                                      i32min, s);
  if (val64)
    return minmax_t<int32_t, int64_t>(bkey, bok, bval, nb, pkey, pok, pval, np,
                                      lo, dom, mn, mx, present, out, i64max,
                                      i64min, s);
  return minmax_t<int32_t, int32_t>(bkey, bok, bval, nb, pkey, pok, pval, np,
                                    lo, dom, mn, mx, present, out, i32max,
                                    i32min, s);
}

}  // extern "C"
