// The sort-merge probe (L3) and every searchsorted of the executor.
//
// Replaces nds_tpu/engine/device_exec.py `_ss` (`:293`, jnp.searchsorted)
// and `_probe` (`:1785`): the sort-merge join's probe and match ranges
// (`:1927-1941`), the `<>` residual's ranges (`:2092`), the group starts
// (`:2404`, `:2221`) and the set operations' membership probe (`:2747`).
// Each query q[i] finds its place in a non-decreasing array ks of n keys,
// exactly as torch.searchsorted places it:
//
//   left:  the count of keys below q;
//   right: the count of keys at or below q;
//   both:  left and right in one pass (a match range);
//   probe: pos = left clamped to [0, n - 1], then hit = ks[pos] == q (and
//          pok[i] where given) and idx = order[pos] (where given): the
//          reference's _probe whole, without writing pos.
//
// What bounds it on an H100: bytes, in principle. Each query (and its pok)
// is read once and each output written once; ks is read into each block's
// index and again by the searches, from L2 (the largest NDS probe searches
// 144,067 int64 keys, 1.2 MB). In practice a binary search is latency: each
// step is a load that the next depends on. The design cuts the steps that
// go to L2 and keeps many searches in flight:
//
//   - a deep index in shared memory: each block stages 2^L - 1 evenly
//     spaced splitters of ks (ks[j * step]), up to 16,383 int64 or 32,767
//     int32 keys (128 KB, dynamic shared memory), in BFS (Eytzinger) order,
//     so that the first levels of the search read a few neighbouring words
//     (a broadcast, no bank conflict) where sorted splitters strided by a
//     power of two would put every lane of a level in one bank. A build of
//     at most 2^L - 1 keys is searched in shared memory alone. L is the
//     smaller of what holds ks whole and what the block's share of the
//     queries pays for (the index's staging costs 2^L loads a block). The
//     blocks are persistent (the grid is the number of SMs times the
//     occupancy at that shared-memory size), so each stages its index once;
//   - the index's search is branchless, L predicated steps of i = 2i +
//     (splitter before q); what remains, the keys between two splitters
//     (step - 1 of them: 8 at NDS's largest probe, 48 at NDS-H's), is
//     halved in ks with a fixed count of predicated steps until 8 keys
//     hold it, which are read together and counted: one round trip to L2
//     at NDS's largest probe, four at NDS-H's. Where the index holds ks
//     whole, a kernel without those steps (and their registers) runs;
//   - each thread carries Q = 4 queries (in blocks of 512 threads) through
//     the index and the final steps together, so that
//     their reads from L2 overlap; the probe issues its reads of ks[pos]
//     and order[pos] together (ks[pos] from the index where it holds ks
//     whole). The queries are read and the outputs written as vectors
//     where the arrays are 16-byte aligned; the last group of queries,
//     where m is no multiple of Q, and unaligned arrays take a scalar path
//     in the same kernel;
//   - where every thread of a warp holds Q equal queries (the runs of one
//     value that a plan's padding rows make), the warp searches one value
//     a thread: on such probes the search is bound by instructions, not
//     by L2.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// queries a thread carries, and threads a block (their registers allow 512)
constexpr int kQueries = 4;
constexpr int kThreads = 512;
// the shallowest index a block stages
constexpr int kMinLevels = 10;

constexpr int kLeft = 0;
constexpr int kRight = 1;
constexpr int kBoth = 2;
constexpr int kProbe = 3;

// the deepest index: 2^14 - 1 int64 or 2^15 - 1 int32 keys (128 KB)
template <typename K>
constexpr int max_levels() {
  return sizeof(K) == 8 ? 14 : 15;
}

template <typename K>
__device__ __forceinline__ K kmax() {
  if constexpr (sizeof(K) == 8)
    return INT64_MAX;
  else
    return INT32_MAX;
}

// Q values of T read or written as one vector (two for 32 bytes)
template <typename T, int Q>
struct alignas(Q * sizeof(T) >= 16 ? 16 : Q * sizeof(T)) Pack {
  T v[Q];
};

// the keys a search reads together at its end (64 bytes of int64, 32 of
// int32)
constexpr int kWindow = 8;

// whether x's place is after key k: k < x (left) or k <= x (right)
template <typename K, bool kAfterEqual>
__device__ __forceinline__ bool after(K k, K x) {
  return kAfterEqual ? !(x < k) : k < x;
}

// the places of the Q queries x in ks: the index e (BFS order, 2^levels -
// 1 nodes, node 1 the root; sorted splitter r at node (2^levels + r + 1) >>
// ffs(r + 1)) narrows each to the keys between two splitters, a search of
// ks with a fixed count of steps finishes it
template <typename K, bool kAfterEqual, bool kWhole, int Q>
__device__ __forceinline__ void place(const K* __restrict__ ks, long long n,
                                      long long step, int ns, int levels,
                                      const K* e, const K (&x)[Q],
                                      long long (&p)[Q]) {
  int i[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) i[j] = 1;
  for (int l = 0; l < levels; ++l) {
#pragma unroll
    for (int j = 0; j < Q; ++j)
      i[j] = 2 * i[j] + (after<K, kAfterEqual>(e[i[j]], x[j]) ? 1 : 0);
  }
  // a splitters lie before x's place (the padding nodes, iinfo.max, count
  // only for x = iinfo.max, and no more than the ns there are): ks[(a - 1)
  // * step] is before it and ks[a * step], where there is one, is not, so
  // the place is in [(a - 1) * step + 1, min(a * step, n)]
  long long hi[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    int a = i[j] - (1 << levels);
    a = a < ns ? a : ns;
    p[j] = a > 0 ? (a - 1) * step + 1 : 0;
    hi[j] = a > 0 ? (a * step < n ? a * step : n) : 0;
  }
  // an index that holds ks whole (step 1) has placed x; else finish in ks
  if constexpr (!kWhole) {
    // the answer lies in [p, p + len] and a key at or past hi is not
    // before it; the step counts are the same for every query. Halve the
    // range with dependent reads until kWindow keys hold it, then read
    // those together and count the ones before x
    long long len = step - 1;
    while (len > kWindow) {
      const long long half = len >> 1;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const long long at = p[j] + half;
        const bool in = at < hi[j];
        const K v = in ? ks[at] : x[j];
        p[j] = in && after<K, kAfterEqual>(v, x[j]) ? at : p[j];
      }
      len -= half;
    }
    if (len > 0) {
      K v[Q][kWindow];
      int lim[Q];  // the window's keys below hi
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const long long room = hi[j] - p[j];
        lim[j] = static_cast<int>(room < len ? room : len);
        const K* w = ks + p[j];
#pragma unroll
        for (int k = 0; k < kWindow; ++k)
          v[j][k] = k < lim[j] ? w[k] : x[j];
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        int before = 0;
#pragma unroll
        for (int k = 0; k < kWindow; ++k)
          before += k < lim[j] && after<K, kAfterEqual>(v[j][k], x[j]);
        p[j] += before;
      }
    }
  }
}

// the places of the mode: "left" (or "right") into pa, "both" into pa and pb
template <typename K, int MODE, bool kWhole, int Q>
__device__ __forceinline__ void places(const K* __restrict__ ks, long long n,
                                       long long step, int ns, int levels,
                                       const K* e, const K (&x)[Q],
                                       long long (&pa)[Q],
                                       long long (&pb)[Q]) {
  if constexpr (MODE == kRight)
    place<K, true, kWhole, Q>(ks, n, step, ns, levels, e, x, pa);
  else
    place<K, false, kWhole, Q>(ks, n, step, ns, levels, e, x, pa);
  if constexpr (MODE == kBoth)
    place<K, true, kWhole, Q>(ks, n, step, ns, levels, e, x, pb);
}

// the probe's outputs for the Q queries x at their left places pa: the key
// and the row at each clamped place, read together (the key from the index
// where it holds ks whole)
template <typename K, bool kWhole, int Q>
__device__ __forceinline__ void probe(
    const K* __restrict__ ks, long long n, long long step, int leaves,
    const K* e, const K (&x)[Q], const long long (&pa)[Q], bool whole,
    long long i0, long long m, const uint8_t* __restrict__ pok,
    const int32_t* __restrict__ order, int32_t* __restrict__ idx,
    uint8_t* __restrict__ hit) {
  K kv[Q];
  int32_t ov[Q];
  uint8_t ok[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const long long p = pa[j] < n ? pa[j] : n - 1;
    const int p1 = static_cast<int>(p) + 1;
    if constexpr (kWhole)
      kv[j] = e[(leaves + p1) >> __ffs(p1)];
    else
      kv[j] = ks[p];
    ov[j] = order != nullptr ? order[p] : 0;
  }
  if (pok == nullptr) {
#pragma unroll
    for (int j = 0; j < Q; ++j) ok[j] = 1;
  } else if (whole) {
    const Pack<uint8_t, Q> v = *reinterpret_cast<const Pack<uint8_t, Q>*>(
        pok + i0);
#pragma unroll
    for (int j = 0; j < Q; ++j) ok[j] = v.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < Q; ++j) ok[j] = pok[i0 + j < m ? i0 + j : m - 1];
  }
  if (whole) {
    Pack<uint8_t, Q> h;
#pragma unroll
    for (int j = 0; j < Q; ++j) h.v[j] = kv[j] == x[j] && ok[j] != 0;
    *reinterpret_cast<Pack<uint8_t, Q>*>(hit + i0) = h;
    if (order != nullptr) {
      Pack<int32_t, Q> o;
#pragma unroll
      for (int j = 0; j < Q; ++j) o.v[j] = ov[j];
      *reinterpret_cast<Pack<int32_t, Q>*>(idx + i0) = o;
    }
  } else {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if (i0 + j >= m) break;
      hit[i0 + j] = kv[j] == x[j] && ok[j] != 0;
      if (order != nullptr) idx[i0 + j] = ov[j];
    }
  }
}

template <typename K, int Q, int MODE, bool kWhole>
__global__ void __launch_bounds__(kThreads)
    search(const K* __restrict__ ks, long long n, const K* __restrict__ q,
           long long m, long long step, int ns, int levels, int vec,
           const uint8_t* __restrict__ pok, const int32_t* __restrict__ order,
           long long* __restrict__ pos_a, long long* __restrict__ pos_b,
           int32_t* __restrict__ idx, uint8_t* __restrict__ hit) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* e = reinterpret_cast<K*>(smem);
  const int leaves = 1 << levels;
  for (int r = threadIdx.x; r < leaves - 1; r += kThreads) {
    const int r1 = r + 1;
    e[(leaves + r1) >> __ffs(r1)] = r < ns ? ks[r * step] : kmax<K>();
  }
  __syncthreads();
  const long long groups = (m + Q - 1) / Q;
  for (long long g = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * kThreads) {
    const long long i0 = g * Q;
    const bool whole = vec && i0 + Q <= m;
    K x[Q];
    if (whole) {
      const Pack<K, Q> v = *reinterpret_cast<const Pack<K, Q>*>(q + i0);
#pragma unroll
      for (int j = 0; j < Q; ++j) x[j] = v.v[j];
    } else {
#pragma unroll
      for (int j = 0; j < Q; ++j) x[j] = q[i0 + j < m ? i0 + j : m - 1];
    }
    long long pa[Q], pb[Q];
    bool repeat = true;  // this thread's queries are one value
#pragma unroll
    for (int j = 1; j < Q; ++j) repeat = repeat && x[j] == x[0];
    if (__all_sync(__activemask(), repeat)) {
      // every thread of the warp searches one value (a run of equal
      // queries, as a plan's padding rows make): once
      const K x1[1] = {x[0]};
      long long a1[1], b1[1];
      places<K, MODE, kWhole, 1>(ks, n, step, ns, levels, e, x1, a1, b1);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        pa[j] = a1[0];
        pb[j] = b1[0];
      }
    } else {
      places<K, MODE, kWhole, Q>(ks, n, step, ns, levels, e, x, pa, pb);
    }
    if constexpr (MODE != kProbe) {
      if (whole) {
        Pack<long long, Q> va;
#pragma unroll
        for (int j = 0; j < Q; ++j) va.v[j] = pa[j];
        *reinterpret_cast<Pack<long long, Q>*>(pos_a + i0) = va;
        if constexpr (MODE == kBoth) {
#pragma unroll
          for (int j = 0; j < Q; ++j) va.v[j] = pb[j];
          *reinterpret_cast<Pack<long long, Q>*>(pos_b + i0) = va;
        }
      } else {
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          if (i0 + j >= m) break;
          pos_a[i0 + j] = pa[j];
          if constexpr (MODE == kBoth) pos_b[i0 + j] = pb[j];
        }
      }
    } else {
      probe<K, kWhole, Q>(ks, n, step, leaves, e, x, pa, whole, i0, m, pok,
                          order, idx, hit);
    }
  }
}

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename K, int Q, int MODE, bool kWhole>
int run(const void* ks, long long n, const void* q, long long m,
        long long step, int ns, int levels, const void* pok,
        const void* order, void* pos_a, void* pos_b, void* idx, void* hit,
        int sms, cudaStream_t s) {
  auto kern = search<K, Q, MODE, kWhole>;
  const size_t smem = sizeof(K) << levels;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  int per = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, kThreads, smem);
  const long long groups = (m + Q - 1) / Q;
  const long long want = (groups + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * (per > 0 ? per : 1);
  const unsigned grid = static_cast<unsigned>(want < most ? want : most);
  const int vec = aligned(q) && aligned(pok) && aligned(pos_a) &&
                  aligned(pos_b) && aligned(idx) && aligned(hit);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const K*>(ks), n, static_cast<const K*>(q), m, step, ns,
      levels, vec, static_cast<const uint8_t*>(pok),
      static_cast<const int32_t*>(order), static_cast<long long*>(pos_a),
      static_cast<long long*>(pos_b), static_cast<int32_t*>(idx),
      static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}

// the index's depth and step, then the kernel: one whose index holds ks
// whole searches shared memory alone (and keeps fewer registers)
template <typename K, int Q, int MODE>
int launch(const void* ks, long long n, const void* q, long long m,
           const void* pok, const void* order, void* pos_a, void* pos_b,
           void* idx, void* hit, cudaStream_t s) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int lmax = max_levels<K>();
  int need = 0;  // the depth that holds ks whole
  while (need < lmax && (1LL << need) - 1 < n) ++need;
  // no deeper than what a block's share of the queries pays for
  int paid = 0;
  while (paid < lmax && (1LL << (paid + 1)) <= m / sms) ++paid;
  paid = paid > kMinLevels ? paid : kMinLevels;
  const int levels = paid < need ? paid : need;
  const long long nodes = (1LL << levels) - 1;
  const long long step = n > nodes ? (n + nodes - 1) / nodes : 1;
  const int ns = static_cast<int>((n + step - 1) / step);
  if (step == 1)
    return run<K, Q, MODE, true>(ks, n, q, m, step, ns, levels, pok, order,
                                 pos_a, pos_b, idx, hit, sms, s);
  return run<K, Q, MODE, false>(ks, n, q, m, step, ns, levels, pok, order,
                                pos_a, pos_b, idx, hit, sms, s);
}

template <typename K>
int by_mode(int mode, const void* ks, long long n, const void* q,
            long long m, const void* pok, const void* order, void* pos_a,
            void* pos_b, void* idx, void* hit, cudaStream_t s) {
  switch (mode) {
    case kLeft:
      return launch<K, kQueries, kLeft>(ks, n, q, m, pok, order, pos_a,
                                        pos_b, idx, hit, s);
    case kRight:
      return launch<K, kQueries, kRight>(ks, n, q, m, pok, order, pos_a,
                                         pos_b, idx, hit, s);
    case kBoth:
      return launch<K, kQueries, kBoth>(ks, n, q, m, pok, order, pos_a,
                                        pos_b, idx, hit, s);
    default:
      return launch<K, kQueries, kProbe>(ks, n, q, m, pok, order, pos_a,
                                         pos_b, idx, hit, s);
  }
}

}  // namespace

extern "C" {

// the most keys a block's index holds: ks of at most this many is searched
// in shared memory alone (given queries enough to pay for the whole index)
int nds_search_index_keys(int key64) {
  return key64 ? (1 << max_levels<int64_t>()) - 1
               : (1 << max_levels<int32_t>()) - 1;
}

// ks: int32 (key64 = 0) or int64 [n], non-decreasing, 0 <= n (1 <= n for
// probe); q: the same type [m], 1 <= m; mode 0 left, 1 right (into pos_a,
// int64[m]), 2 both (pos_a, pos_b), 3 probe (hit bool[m]; idx int32[m]
// where order, int32[n], is given; pok bool[m] or null).
int nds_sorted_search(const void* ks, int key64, long long n, const void* q,
                      long long m, int mode, const void* pok,
                      const void* order, void* pos_a, void* pos_b, void* idx,
                      void* hit, void* stream) {
  if (n < 0 || m < 1 || mode < kLeft || mode > kProbe ||
      (mode == kProbe && (n < 1 || hit == nullptr ||
                          (order != nullptr && idx == nullptr))) ||
      (mode != kProbe && pos_a == nullptr) ||
      (mode == kBoth && pos_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return key64 ? by_mode<int64_t>(mode, ks, n, q, m, pok, order, pos_a,
                                  pos_b, idx, hit, s)
               : by_mode<int32_t>(mode, ks, n, q, m, pok, order, pos_a,
                                  pos_b, idx, hit, s);
}

}  // extern "C"
