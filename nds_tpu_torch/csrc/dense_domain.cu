// Dense direct-address kernels over a host-bounded key domain [lo, lo+dom).
//
// Replaces three functions of nds_tpu/engine/kernels.py:
//   direct_lookup_join  (K1)  unique-build equi-join: table[key-lo] = row
//   bitmask_semi        (K3)  EXISTS membership: table[key-lo] = 1
//   keyed_minmax_semi   (K4)  EXISTS with a `<>` residual: table[key-lo] =
//                             {min, max} of the key's build values, then
//                             [min,max] != [v,v]
//
// All three share one skeleton: a fill pass sets the table to its identity,
// one build pass scatters the valid build rows into it, and one probe pass
// gathers it, fused with the in-domain test and the hit mask. Invalid build
// rows and keys outside the domain are skipped in the kernel: nothing is ever
// written out of range (the JAX version routes them to slot `dom` and lets
// the scatter drop them).
//
// What bounds them on an H100: bytes. Each probe row reads its key and its ok
// flag (K4: and its value) and writes one or two outputs; each build row
// reads key, flag (and a value) and writes one table slot; the table itself
// is written once by the fill. At the NDS-H SF1 shapes (probe 6,001,215 rows,
// tables of at most 2^23 entries) the table mostly stays in the 50 MB L2
// (K4's at NDS-H q21 is 1,500,000 slots of 8 bytes, 12 MB), so the probe's
// gathers mostly hit L2 and the traffic to HBM is the streamed arrays. Where the probe's keys fall at random over a table larger than L1
// (part <- lineitem), each gather moves a 32-byte sector from L2, and L2
// rather than HBM bounds it. The unique-build contract means at most one
// valid row per slot for K1, so its build is a plain store.
//
// The three take 16 rows a lane (lane_rows.cuh: 16-byte loads of the keys,
// whole-group loads and stores of the flags, values and outputs, streaming
// cache hints, the head and tail in the kernel); the probe issues a lane's
// 16 table gathers before it uses the first and loads its next chunk while
// it gathers; and the build and the probe are launched as programmatic
// dependents (dependent_launch.cuh), so that their launch and their first
// loads overlap the kernel before. The first versions took one row a thread
// with 1-byte loads and stores, one gather in flight a thread, and launches
// each waiting for the one before to drain. K1 and K3 are one template over
// what a slot holds (K1 the build row, int32; K3 a membership byte). The
// fill stays: a table kept across calls, its slots tagged with the call's
// epoch, needs 8-byte slots, whose bytes in the build and the probe cost
// more than the fill's 4 bytes a slot (measured on an H100: PERF.md's
// findings on K1).
//
// K3's build is its larger half where the build side is a plan's padded
// capacity (NDS SF1: 184,162,304 build rows, 4.6% of them valid, into a
// table of 71,939 bytes, probed by 719,384 rows). So K3's build loads a
// lane's flags first and no key vector whose rows are all invalid: it
// reads every flag and only the key sectors that hold a valid row (the key
// loads wait on the flags). Measured on an H100 (PERF.md, K3): at the NDS
// call this halves the build, and at NDS-H's calls it loses nothing; a
// build that read a slot and stored only into one that still read 0 lost
// at NDS-H's call and went.
//
// K4 keeps one table of {min, max} slots, 8 bytes for int32 values and 16
// for int64, filled with (iinfo.max, iinfo.min) in one 16-byte-store pass; a
// slot is present iff min <= max, so no presence table is filled, written or
// gathered, and the probe reads one slot a row where the first version read
// three tables. Its build is K3's (flags first, no key or value vector of
// invalid rows loaded) with atomicMin and atomicMax where K3 stores a byte,
// and it merges each run of one key among a lane's 16 rows in registers
// first: lineitem comes clustered by orderkey, about 4 rows an order, so a
// run of a lane's group costs one pair of atomics, where one row a thread
// had neighbouring threads serialize on one address. Its own build and
// probe sit beside dense_t rather than in it: a third streamed array (the
// values, whose groups are 8, 16 or 32 bytes beside 16 bytes of keys), the
// run merge and the value compare would each be a policy hook that K1 and
// K3 never take. At NDS-H q21 (6,002,850 x 6,002,850 int32 rows, 1,500,000
// slots) it moves 12 MB of fill, 54 MB of build input, 54 MB of probe input
// and 6 MB of output, and reads 48 MB of slots from L2. Measured on an H100
// (PERF.md, K4), the build takes about two thirds of that call, three times
// what its bytes take: its table stays in L2, and it makes a pair of atomics
// for each run of a key within a lane's group of 4 rows (1.75 runs a group
// on average). The probe is near the bound that counts its slot reads.
//
// Every entry point launches on the stream it is given, allocates nothing
// (the caller passes the table as scratch) and returns cudaGetLastError().

#include <cstdint>
#include <limits>
#include <cuda_runtime.h>

#include "dependent_launch.cuh"
#include "lane_rows.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clamp_slot(long long pos, long long dom) {
  return pos < 0 ? 0 : (pos >= dom ? dom - 1 : pos);
}

using dependent_launch::allow_dependents;
using dependent_launch::await_prerequisites;
using dependent_launch::launch_after;

// ------------------------------------------------------------- K1 and K3
//
// Three launches: the fill in 16-byte stores, then the build and the probe,
// each launched as a programmatic dependent of the kernel before it: it is
// scheduled while that kernel runs, loads its first keys and flags, and
// waits for it only before it touches the table. The build and the probe
// take 16 rows a lane through lane_rows.cuh, and the probe runs on a grid of
// the blocks the SMs hold at once: each warp loads its next chunk's keys and
// flags before it issues the current chunk's 16 gathers a lane, all of them
// through the read-only path before it uses the first.

using lane_rows::kRows;
using lane_rows::Plan;

constexpr int kWarps = kThreads / 32;

// What a table slot holds. K1: the build row of its key (int32; the fill's
// -1 for none), and the probe writes that row beside the hit. K3: whether a
// valid build row has its key (a byte; the fill's 0 for none), the probe
// writes the hit alone, and the build loads no key of an invalid vector
// (kSkip).
struct RowSlot {
  using T = int32_t;
  static constexpr bool kWritesRow = true;
  static constexpr bool kSkip = false;
  static constexpr T kNone = -1;
  __device__ static void set(T* t, long long row) {
    *t = static_cast<int32_t>(row);
  }
  __device__ static bool hit(T v) { return v >= 0; }
};

struct MemberSlot {
  using T = uint8_t;
  static constexpr bool kWritesRow = false;
  static constexpr bool kSkip = true;
  static constexpr T kNone = 0;
  __device__ static void set(T* t, long long) { *t = 1; }
  __device__ static bool hit(T v) { return v != 0; }
};

// Enough blocks for one chunk a warp, and for the rows taken one a thread.
inline long long chunk_blocks(const Plan& p) {
  long long b = (p.chunks + kWarps - 1) / kWarps;
  const long long r = (lane_rows::rest_rows(p) + kThreads - 1) / kThreads;
  if (b < r) b = r;
  if (b < 1) b = 1;
  return b;
}

inline unsigned chunk_grid(const Plan& p) {
  const long long b = chunk_blocks(p);
  return static_cast<unsigned>(b > 0x7fffffffLL ? 0x7fffffffLL : b);
}

// key - lo, wrapping as the plain version's int64 subtraction does
template <typename K>
__device__ __forceinline__ long long key_pos(K k, long long lo) {
  return static_cast<long long>(
      static_cast<unsigned long long>(static_cast<long long>(k)) -
      static_cast<unsigned long long>(lo));
}

// The tables' fill: every element of t[0, n) set to v, in 16-byte stores
// from the first 16-byte boundary on, the elements around them one a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fill_kernel(T* __restrict__ t, long long n, T v) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  allow_dependents();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = blockIdx.x * static_cast<long long>(kThreads) +
                          threadIdx.x;
  const unsigned mis =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(t) & 15u);
  long long head = mis ? (16 - mis) / static_cast<long long>(sizeof(T)) : 0;
  if (head > n) head = n;
  const long long nv = (n - head) / V;
  union {
    T e[V];
    int4 w;
  } u;
#pragma unroll
  for (int i = 0; i < V; ++i) u.e[i] = v;
  int4* tv = reinterpret_cast<int4*>(t + head);
  for (long long i = first; i < nv; i += stride) tv[i] = u.w;
  for (long long i = first; i < n - nv * V; i += stride)
    t[i < head ? i : i + nv * V] = v;
}

// Launches fill_kernel<T> on a grid of at most the blocks the SMs hold at
// once.
template <typename T>
int fill(T* t, long long n, T v, cudaStream_t s) {
  static int per_sm = 0;
  long long cap = 0;
  const int e = lane_rows::resident_blocks(fill_kernel<T>, kThreads, per_sm,
                                           &cap);
  if (e != 0) return e;
  long long g = (n / (16 / static_cast<long long>(sizeof(T))) + kThreads - 1) /
                kThreads;
  if (g > cap) g = cap;
  if (g < 1) g = 1;
  fill_kernel<T><<<static_cast<unsigned>(g), kThreads, 0, s>>>(t, n, v);
  return 0;
}

// One chunk a warp. With S::kSkip, a lane's flags come first and its key
// vectors whose rows are all invalid are not loaded, nor the key of an
// invalid head or tail row. (Measured on an H100, PERF.md: the order of
// the head and tail's loads sets the int32 build's registers, 40 with the
// flag first and 48 without, and each slot's calls ran faster with its
// own.)
template <typename K, typename S>
__global__ void __launch_bounds__(kThreads)
    direct_build(const K* __restrict__ bkey, const uint8_t* __restrict__ bok,
                 Plan p, long long lo, long long dom,
                 typename S::T* __restrict__ tbl) {
  constexpr int R = lane_rows::Groups<K>::R, G = lane_rows::Groups<K>::G;
  allow_dependents();
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(kThreads) +
                          threadIdx.x) >> 5;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  bool waited = false;
  for (long long c = warp; c < p.chunks; c += nwarps) {
    K k[kRows];
    unsigned fw[G];
    if constexpr (S::kSkip) {
      lane_rows::load_flags<K>(bok, p, c, lane, fw);
      lane_rows::load_flagged_keys<K>(bkey, p, c, lane, fw, k);
    } else {
      lane_rows::load_keys<K>(bkey, p, c, lane, k);
      lane_rows::load_flags<K>(bok, p, c, lane, fw);
    }
    if (!waited) {
      await_prerequisites();  // the fill
      waited = true;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long s = key_pos(k[i], lo);
      if (lane_rows::flag_of<K>(fw, i) && s >= 0 && s < dom)
        S::set(tbl + s, lane_rows::group_row<K>(p, c, i / R, lane) + i % R);
    }
  }
  if (!waited) await_prerequisites();
  const long long rest = lane_rows::rest_rows(p);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < rest; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = lane_rows::rest_row(p, i);
    if constexpr (S::kSkip) {
      if (!bok[row]) continue;
    }
    const long long s = key_pos(bkey[row], lo);
    if (bok[row] && s >= 0 && s < dom) S::set(tbl + s, row);
  }
}

// One chunk of the probe from its keys and flag words.
template <typename K, typename S>
__device__ __forceinline__ void probe_chunk(
    const K (&k)[kRows], const unsigned (&fw)[lane_rows::Groups<K>::G],
    const Plan& p, long long c, int lane, long long lo, long long dom,
    const typename S::T* __restrict__ tbl, int32_t* __restrict__ ridx,
    uint8_t* __restrict__ hit) {
  constexpr int R = lane_rows::Groups<K>::R, G = lane_rows::Groups<K>::G;
  typename S::T v[kRows];
  unsigned inb = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long pos = key_pos(k[i], lo);
    inb |= static_cast<unsigned>(pos >= 0 && pos < dom) << i;
    v[i] = __ldg(tbl + clamp_slot(pos, dom));
  }
  unsigned hw[G];
#pragma unroll
  for (int g = 0; g < G; ++g) hw[g] = 0;
  int32_t r[kRows];  // the rows of K1's slots, clamped to >= 0
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool h = lane_rows::flag_of<K>(fw, i) && ((inb >> i) & 1u) &&
                   S::hit(v[i]);
    hw[i / R] |= static_cast<unsigned>(h) << (8 * (i % R));
    if constexpr (S::kWritesRow) r[i] = v[i] < 0 ? 0 : v[i];
  }
  if constexpr (S::kWritesRow)
    lane_rows::store_rows<K>(ridx, hit, p, c, lane, r, hw);
  else
    lane_rows::store_hits<K>(hit, p, c, lane, hw);
}

// On a grid of the blocks the SMs hold at once, each warp loads its next
// chunk's keys and flags before it gathers for the current one (and its
// first before it waits for the build). ridx is written where the slot
// holds a row (K1) and is null for K3.
template <typename K, typename S>
__global__ void __launch_bounds__(kThreads)
    direct_probe(const K* __restrict__ pkey, const uint8_t* __restrict__ pok,
                 Plan p, long long lo, long long dom,
                 const typename S::T* __restrict__ tbl,
                 int32_t* __restrict__ ridx, uint8_t* __restrict__ hit) {
  constexpr int G = lane_rows::Groups<K>::G;
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(kThreads) +
                          threadIdx.x) >> 5;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  K k[kRows];
  unsigned fw[G];
  long long c = warp;
  if (c < p.chunks) {
    lane_rows::load_keys<K>(pkey, p, c, lane, k);
    lane_rows::load_flags<K>(pok, p, c, lane, fw);
  }
  await_prerequisites();  // the build
  while (c < p.chunks) {
    const long long next = c + nwarps;
    K kn[kRows];
    unsigned fn[G];
    if (next < p.chunks) {
      lane_rows::load_keys<K>(pkey, p, next, lane, kn);
      lane_rows::load_flags<K>(pok, p, next, lane, fn);
    }
    probe_chunk<K, S>(k, fw, p, c, lane, lo, dom, tbl, ridx, hit);
#pragma unroll
    for (int i = 0; i < kRows; ++i) k[i] = kn[i];
#pragma unroll
    for (int g = 0; g < G; ++g) fw[g] = fn[g];
    c = next;
  }
  const long long rest = lane_rows::rest_rows(p);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < rest; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = lane_rows::rest_row(p, i);
    const long long pos = key_pos(pkey[row], lo);
    const bool inb = pos >= 0 && pos < dom;
    const typename S::T x = __ldg(tbl + clamp_slot(pos, dom));
    hit[row] = (pok[row] && inb && S::hit(x)) ? 1 : 0;
    if constexpr (S::kWritesRow) ridx[row] = x < 0 ? 0 : x;
  }
}

// The fill, the build and the probe of K1 (RowSlot) or K3 (MemberSlot).
template <typename K, typename S>
int dense_t(const void* bkey, const void* bok, long long nb, const void* pkey,
            const void* pok, long long np, long long lo, long long dom,
            void* tbl, void* ridx, void* hit, cudaStream_t s) {
  using T = typename S::T;
  const Plan pb = lane_rows::plan_rows<K>(bkey, nb, bok, nullptr, nullptr);
  const Plan pp = lane_rows::plan_rows<K>(pkey, np, pok, ridx, hit);
  static int per_sm = 0;
  long long resident = 0;
  const int e = lane_rows::resident_blocks(direct_probe<K, S>, kThreads,
                                           per_sm, &resident);
  if (e != 0) return e;
  long long g = chunk_blocks(pp);
  if (g > resident) g = resident;
  T* t = static_cast<T*>(tbl);
  const int fe = fill<T>(t, dom, S::kNone, s);
  if (fe != 0) return fe;
  cudaError_t err = launch_after(
      direct_build<K, S>, chunk_grid(pb), kThreads, s,
      static_cast<const K*>(bkey), static_cast<const uint8_t*>(bok), pb, lo,
      dom, t);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_after(direct_probe<K, S>, static_cast<unsigned>(g), kThreads,
                     s, static_cast<const K*>(pkey),
                     static_cast<const uint8_t*>(pok), pp, lo, dom,
                     static_cast<const T*>(t), static_cast<int32_t*>(ridx),
                     static_cast<uint8_t*>(hit));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ K4
//
// K1's skeleton with one min/max slot a key: the fill, then the build and
// the probe as programmatic dependents, 16 rows a lane. K4 has its own build
// and probe on K1's helpers rather than a third slot policy of dense_t: it
// streams a third array (the values, int32 or int64 beside int32 or int64
// keys: lane_rows::load_values), its build merges runs of equal keys before
// its atomics, and its probe compares a value with the slot.

// A key's slot: the least and the greatest value of its valid build rows,
// side by side (8 or 16 bytes). The fill's (iinfo.max, iinfo.min) keeps
// min > max, so a slot is present iff min <= max: a build row that reaches
// it leaves min <= v <= max, whatever v is.
template <typename V>
struct alignas(2 * sizeof(V)) MinMax {
  V mn, mx;
};

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

// A slot read through L2 (ld.global.cg): the build that wrote it is a grid
// that ran beside this one until the wait, so never the read-only path.
__device__ __forceinline__ MinMax<int32_t> load_slot(
    const MinMax<int32_t>* t) {
  const int2 w = __ldcg(reinterpret_cast<const int2*>(t));
  return {w.x, w.y};
}
__device__ __forceinline__ MinMax<int64_t> load_slot(
    const MinMax<int64_t>* t) {
  const longlong2 w = __ldcg(reinterpret_cast<const longlong2*>(t));
  return {static_cast<int64_t>(w.x), static_cast<int64_t>(w.y)};
}

// Whether a present slot's [min, max] is not exactly [v, v].
template <typename V>
__device__ __forceinline__ bool differs(const MinMax<V>& m, V v) {
  return m.mn <= m.mx && (m.mn != v || m.mx != v);
}

// Merges [mn, mx] into a slot. (Measured on an H100, PERF.md: reading the
// slot first and skipping an atomic that cannot change it cost 17% at NDS-H
// q21's call.)
template <typename V>
__device__ __forceinline__ void merge(MinMax<V>* t, V mn, V mx) {
  atomic_min_v(&t->mn, mn);
  atomic_max_v(&t->mx, mx);
}

// One chunk a warp. A lane's flags come first, then only the key and value
// vectors that hold a valid row. The valid in-domain rows are taken in row
// order, and a run of one key among a lane's 16 rows is merged in registers
// and costs one atomicMin and one atomicMax.
template <typename K, typename V>
__global__ void __launch_bounds__(kThreads)
    minmax_build(const K* __restrict__ bkey, const uint8_t* __restrict__ bok,
                 const V* __restrict__ bval, Plan p, int vval, long long lo,
                 long long dom, MinMax<V>* __restrict__ tbl) {
  constexpr int G = lane_rows::Groups<K>::G;
  allow_dependents();
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(kThreads) +
                          threadIdx.x) >> 5;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  bool waited = false;
  for (long long c = warp; c < p.chunks; c += nwarps) {
    K k[kRows];
    V v[kRows];
    unsigned fw[G];
    lane_rows::load_flags<K>(bok, p, c, lane, fw);
    lane_rows::load_flagged_keys<K>(bkey, p, c, lane, fw, k);
    lane_rows::load_values<K, V, true>(bval, p, c, lane, vval, fw, v);
    if (!waited) {
      await_prerequisites();  // the fill
      waited = true;
    }
    bool has = false;
    long long at = 0;
    V mn = 0, mx = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long s = key_pos(k[i], lo);
      if (lane_rows::flag_of<K>(fw, i) && s >= 0 && s < dom) {
        if (has && s == at) {
          mn = v[i] < mn ? v[i] : mn;
          mx = v[i] > mx ? v[i] : mx;
        } else {
          if (has) merge(tbl + at, mn, mx);
          has = true;
          at = s;
          mn = mx = v[i];
        }
      }
    }
    if (has) merge(tbl + at, mn, mx);
  }
  if (!waited) await_prerequisites();
  const long long rest = lane_rows::rest_rows(p);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < rest; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = lane_rows::rest_row(p, i);
    if (!bok[row]) continue;
    const long long s = key_pos(bkey[row], lo);
    if (s >= 0 && s < dom) merge(tbl + s, bval[row], bval[row]);
  }
}

// One chunk of the probe from its keys and flag words: a lane's 16 slot
// gathers issued before its values are loaded and before the first is used.
template <typename K, typename V>
__device__ __forceinline__ void minmax_probe_chunk(
    const K (&k)[kRows], const unsigned (&fw)[lane_rows::Groups<K>::G],
    const Plan& p, long long c, int lane, int vval, long long lo,
    long long dom, const V* __restrict__ pval,
    const MinMax<V>* __restrict__ tbl, uint8_t* __restrict__ hit) {
  constexpr int R = lane_rows::Groups<K>::R, G = lane_rows::Groups<K>::G;
  MinMax<V> m[kRows];
  unsigned inb = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long pos = key_pos(k[i], lo);
    inb |= static_cast<unsigned>(pos >= 0 && pos < dom) << i;
    m[i] = load_slot(tbl + clamp_slot(pos, dom));
  }
  V v[kRows];
  lane_rows::load_values<K, V, false>(pval, p, c, lane, vval, fw, v);
  unsigned hw[G];
#pragma unroll
  for (int g = 0; g < G; ++g) hw[g] = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool h = lane_rows::flag_of<K>(fw, i) && ((inb >> i) & 1u) &&
                   differs(m[i], v[i]);
    hw[i / R] |= static_cast<unsigned>(h) << (8 * (i % R));
  }
  lane_rows::store_hits<K>(hit, p, c, lane, hw);
}

// On a grid of the blocks the SMs hold at once, as K1's probe: each warp
// loads its next chunk's keys and flags before it gathers for the current
// one, and its first before it waits for the build.
template <typename K, typename V>
__global__ void __launch_bounds__(kThreads)
    minmax_probe(const K* __restrict__ pkey, const uint8_t* __restrict__ pok,
                 const V* __restrict__ pval, Plan p, int vval, long long lo,
                 long long dom, const MinMax<V>* __restrict__ tbl,
                 uint8_t* __restrict__ hit) {
  constexpr int G = lane_rows::Groups<K>::G;
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(kThreads) +
                          threadIdx.x) >> 5;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  K k[kRows];
  unsigned fw[G];
  long long c = warp;
  if (c < p.chunks) {
    lane_rows::load_keys<K>(pkey, p, c, lane, k);
    lane_rows::load_flags<K>(pok, p, c, lane, fw);
  }
  await_prerequisites();  // the build
  while (c < p.chunks) {
    const long long next = c + nwarps;
    K kn[kRows];
    unsigned fn[G];
    if (next < p.chunks) {
      lane_rows::load_keys<K>(pkey, p, next, lane, kn);
      lane_rows::load_flags<K>(pok, p, next, lane, fn);
    }
    minmax_probe_chunk<K, V>(k, fw, p, c, lane, vval, lo, dom, pval, tbl,
                             hit);
#pragma unroll
    for (int i = 0; i < kRows; ++i) k[i] = kn[i];
#pragma unroll
    for (int g = 0; g < G; ++g) fw[g] = fn[g];
    c = next;
  }
  const long long rest = lane_rows::rest_rows(p);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < rest; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = lane_rows::rest_row(p, i);
    const long long pos = key_pos(pkey[row], lo);
    const bool inb = pos >= 0 && pos < dom;
    const MinMax<V> m = load_slot(tbl + clamp_slot(pos, dom));
    hit[row] = (pok[row] && inb && differs(m, pval[row])) ? 1 : 0;
  }
}

// The fill, the build and the probe of K4.
template <typename K, typename V>
int minmax_t(const void* bkey, const void* bok, const void* bval, long long nb,
             const void* pkey, const void* pok, const void* pval, long long np,
             long long lo, long long dom, void* tbl, void* out,
             cudaStream_t s) {
  using Slot = MinMax<V>;
  if (reinterpret_cast<uintptr_t>(tbl) % sizeof(Slot) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pb = lane_rows::plan_rows<K>(bkey, nb, bok, nullptr, nullptr);
  const Plan pp = lane_rows::plan_rows<K>(pkey, np, pok, nullptr, out);
  const int vb = lane_rows::values_aligned<K, V>(bval, pb);
  const int vp = lane_rows::values_aligned<K, V>(pval, pp);
  static int per_sm = 0;
  long long resident = 0;
  const int e = lane_rows::resident_blocks(minmax_probe<K, V>, kThreads,
                                           per_sm, &resident);
  if (e != 0) return e;
  long long g = chunk_blocks(pp);
  if (g > resident) g = resident;
  Slot* t = static_cast<Slot*>(tbl);
  Slot none;
  none.mn = std::numeric_limits<V>::max();
  none.mx = std::numeric_limits<V>::min();
  const int fe = fill<Slot>(t, dom, none, s);
  if (fe != 0) return fe;
  const K* bk = static_cast<const K*>(bkey);
  const uint8_t* bo = static_cast<const uint8_t*>(bok);
  const V* bv = static_cast<const V*>(bval);
  cudaError_t err = launch_after(minmax_build<K, V>, chunk_grid(pb),
                                 kThreads, s, bk, bo, bv, pb, vb, lo, dom, t);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_after(minmax_probe<K, V>, static_cast<unsigned>(g), kThreads,
                     s, static_cast<const K*>(pkey),
                     static_cast<const uint8_t*>(pok),
                     static_cast<const V*>(pval), pp, vp, lo, dom,
                     static_cast<const Slot*>(t), static_cast<uint8_t*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
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
  return key64 ? dense_t<int64_t, RowSlot>(bkey, bok, nb, pkey, pok, np, lo,
                                           dom, tbl, ridx, hit, s)
               : dense_t<int32_t, RowSlot>(bkey, bok, nb, pkey, pok, np, lo,
                                           dom, tbl, ridx, hit, s);
}

// K3. bm: uint8[dom] scratch; out: uint8[np].
int nds_bitmask_semi(const void* bkey, const void* bok, long long nb,
                     const void* pkey, const void* pok, long long np,
                     int key64, long long lo, long long dom, void* bm,
                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return key64 ? dense_t<int64_t, MemberSlot>(bkey, bok, nb, pkey, pok, np,
                                              lo, dom, bm, nullptr, out, s)
               : dense_t<int32_t, MemberSlot>(bkey, bok, nb, pkey, pok, np,
                                              lo, dom, bm, nullptr, out, s);
}

// K4. tbl: dom slots of {min, max} scratch (2 * dom values of the values'
// type, aligned to a slot); out: uint8[np].
int nds_keyed_minmax_semi(const void* bkey, const void* bok, const void* bval,
                          long long nb, const void* pkey, const void* pok,
                          const void* pval, long long np, int key64, int val64,
                          long long lo, long long dom, void* tbl, void* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key64 && val64)
    return minmax_t<int64_t, int64_t>(bkey, bok, bval, nb, pkey, pok, pval, np,
                                      lo, dom, tbl, out, s);
  if (key64)
    return minmax_t<int64_t, int32_t>(bkey, bok, bval, nb, pkey, pok, pval, np,
                                      lo, dom, tbl, out, s);
  if (val64)
    return minmax_t<int32_t, int64_t>(bkey, bok, bval, nb, pkey, pok, pval, np,
                                      lo, dom, tbl, out, s);
  return minmax_t<int32_t, int32_t>(bkey, bok, bval, nb, pkey, pok, pval, np,
                                    lo, dom, tbl, out, s);
}

}  // extern "C"
