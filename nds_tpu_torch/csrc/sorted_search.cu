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
// Design: each block stages up to 2048 evenly spaced splitters of ks in
// shared memory (ks[j * step], step = ceil(n / 2048)), binary-searches them,
// and finishes inside one step of ks in global memory: about
// log2(n / 2048) dependent reads, which hit L2 for the executor's builds
// (the largest NDS probe searches 144,067 int64 keys, 1.2 MB). A build of
// at most 2048 keys is searched in shared memory alone. Blocks are
// persistent over the queries, so each loads its splitters once; queries
// and outputs are read and written coalesced.
//
// What bounds it on an H100: bytes. Each query (and its pok) is read once
// and each output written once; ks is read once into the splitters' blocks
// and again by the searches, from L2.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSplit = 2048;
constexpr long long kMaxGrid = 4096;

constexpr int kLeft = 0;
constexpr int kRight = 1;
constexpr int kBoth = 2;
constexpr int kProbe = 3;

// whether x's place is after key k: k < x (left) or k <= x (right)
template <typename K, bool kAfterEqual>
__device__ __forceinline__ bool after(K k, K x) {
  return kAfterEqual ? !(x < k) : k < x;
}

// the place of x in ks: the splitters sp (ns of them, sp[j] = ks[j * step])
// narrow it to one step, a binary search of ks finishes it
template <typename K, bool kAfterEqual>
__device__ __forceinline__ long long place(const K* __restrict__ ks,
                                           long long n, long long step,
                                           const K* sp, int ns, K x) {
  int a = 0, b = ns;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (after<K, kAfterEqual>(sp[mid], x)) a = mid + 1; else b = mid;
  }
  if (a == 0) return 0;
  // ks[(a - 1) * step] is before x's place; ks[a * step], where there is
  // one, is not
  long long lo = (a - 1) * step + 1;
  long long hi = a * step < n ? a * step : n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (after<K, kAfterEqual>(ks[mid], x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    search(const K* __restrict__ ks, long long n, const K* __restrict__ q,
           long long m, int mode, const uint8_t* __restrict__ pok,
           const int32_t* __restrict__ order, long long* __restrict__ pos_a,
           long long* __restrict__ pos_b, int32_t* __restrict__ idx,
           uint8_t* __restrict__ hit) {
  __shared__ K sp[kSplit];
  const long long step = n > kSplit ? (n + kSplit - 1) / kSplit : 1;
  const int ns = static_cast<int>((n + step - 1) / step);
  for (int j = threadIdx.x; j < ns; j += kThreads) sp[j] = ks[j * step];
  __syncthreads();
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < m;
       i += (long long)gridDim.x * kThreads) {
    const K x = q[i];
    if (mode == kRight) {
      pos_a[i] = place<K, true>(ks, n, step, sp, ns, x);
      continue;
    }
    const long long left = place<K, false>(ks, n, step, sp, ns, x);
    if (mode == kLeft) {
      pos_a[i] = left;
    } else if (mode == kBoth) {
      pos_a[i] = left;
      pos_b[i] = place<K, true>(ks, n, step, sp, ns, x);
    } else {
      const long long p = left < n ? left : n - 1;
      hit[i] = ks[p] == x && (pok == nullptr || pok[i] != 0);
      if (order != nullptr) idx[i] = order[p];
    }
  }
}

}  // namespace

extern "C" {

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
  const long long blocks = (m + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < kMaxGrid ? blocks
                                                                : kMaxGrid);
  const uint8_t* po = static_cast<const uint8_t*>(pok);
  const int32_t* od = static_cast<const int32_t*>(order);
  long long* pa = static_cast<long long*>(pos_a);
  long long* pb = static_cast<long long*>(pos_b);
  int32_t* ix = static_cast<int32_t*>(idx);
  uint8_t* ht = static_cast<uint8_t*>(hit);
  if (key64)
    search<int64_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int64_t*>(ks), n, static_cast<const int64_t*>(q), m,
        mode, po, od, pa, pb, ix, ht);
  else
    search<int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(ks), n, static_cast<const int32_t*>(q), m,
        mode, po, od, pa, pb, ix, ht);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
