// Radix-partitioned M:N inner join (K6).
//
// Replaces nds_tpu/engine/kernels.py `partitioned_mn_join` with its helpers
// `_radix_scatter` and `_pids`. It computes what the JAX function computes,
// slot for slot, but not with its steps:
//
//   partition (one call per side): each valid row's partition is
//     pid = (uint32(key) * 2654435761u) >> (32 - log2r)   (0 when log2r = 0)
//     and its slot in the (nparts, cap) blocks is its stable rank among the
//     valid rows of its partition, the JAX version's cumsum over the one-hot.
//     Three kernels: a per-block histogram of the partitions, one block that
//     turns the block counts into exclusive offsets per partition (and sums
//     the rows a full partition drops), and a scatter that ranks each row by
//     its block's offset plus a block-local prefix count. No atomics decide a
//     slot, so the layout, and with it lidx and ridx, are bit-identical to the
//     JAX version's and to the plain PyTorch version's. Key blocks are filled
//     with iinfo(key).max, row-index blocks with 0, occupancy with false; a
//     row whose partition is full goes nowhere (JAX's dropped index).
//   build sort: the caller sorts the build block per partition with one
//     batched stable torch.sort, as the JAX version hands it to lax.sort.
//   ranges: one thread per probe slot binary-searches its partition's sorted
//     build keys for lo and hi and writes cnt = occupied ? hi - lo : 0 as
//     int64 (a skewed partition can exceed 2^31 pairs).
//   prefix: the caller runs seg_scan.cu's segmented scan, op +, int64,
//     restarting at every partition's first slot.
//   expand: one thread per output slot (p, s), s < kp = ceil(K / nparts),
//     binary-searches min(offs, kp + 1) for its probe slot rloc (clipped to
//     rcap - 1), then lpos = clip(lo[rloc] + s - offs[rloc - 1], 0, lcap - 1),
//     lidx = sorted build row at lpos, ridx = probe row at rloc,
//     present = s < min(total_p, kp); one thread sums the overflow,
//     sum_p max(total_p - kp, 0) plus both sides' dropped rows, in int64.
//
// What bounds it on an H100: bytes. The function must read both sides' keys
// and flags and write K output slots (two int32 and a bool each); the
// (nparts, cap) blocks are written and read again, the sort and the binary
// searches touch the build block log(cap) times, and the expansion's gathers
// are random. This first version does not fuse those passes: it is several
// times its bound, and a profile decides what to fuse.
//
// The entry points launch on the given stream, allocate nothing and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxParts = 32;
constexpr int kOffsetThreads = 1024;

unsigned grid_for(long long m) {
  long long g = (m + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > 65535LL * 32) g = 65535LL * 32;
  return static_cast<unsigned>(g);
}

template <typename K>
__device__ __forceinline__ int pid_of(K key, int log2r) {
  if (log2r == 0) return 0;
  const uint32_t u = static_cast<uint32_t>(key) * 2654435761u;
  return static_cast<int>(u >> (32 - log2r));
}

template <typename K>
__global__ void fill_blocks(K* __restrict__ keys, int32_t* __restrict__ gidx,
                            uint8_t* __restrict__ occ, long long m, K sent) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    keys[i] = sent;
    gidx[i] = 0;
    occ[i] = 0;
  }
}

// block_cnt[b * nparts + p] = valid rows of tile b in partition p
template <typename K>
__global__ void histogram(const K* __restrict__ key,
                          const uint8_t* __restrict__ ok, long long n,
                          int nparts, int log2r, int32_t* __restrict__ block_cnt) {
  __shared__ int cnt[kMaxParts];
  if (threadIdx.x < kMaxParts) cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long base = blockIdx.x * (long long)kTile + threadIdx.x * kItems;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < n && ok[i]) atomicAdd(&cnt[pid_of(key[i], log2r)], 1);
  }
  __syncthreads();
  if (threadIdx.x < nparts)
    block_cnt[blockIdx.x * (long long)nparts + threadIdx.x] = cnt[threadIdx.x];
}

// one block: block_cnt becomes exclusive offsets per partition over the
// tiles; over[side] = sum_p max(count_p - cap, 0)
__global__ void block_offsets(int32_t* __restrict__ block_cnt, long long nblocks,
                              int nparts, long long cap,
                              long long* __restrict__ over, int side) {
  __shared__ long long sv[kOffsetThreads];
  const int t = threadIdx.x;
  const long long chunk = (nblocks + kOffsetThreads - 1) / kOffsetThreads;
  const long long b0 = t * chunk;
  const long long b1 = b0 + chunk < nblocks ? b0 + chunk : nblocks;
  long long dropped = 0;
  for (int p = 0; p < nparts; ++p) {
    long long mine = 0;
    for (long long b = b0; b < b1; ++b) mine += block_cnt[b * nparts + p];
    // inclusive scan of the chunk sums over the block
    sv[t] = mine;
    __syncthreads();
    for (int d = 1; d < kOffsetThreads; d <<= 1) {
      const long long add = t >= d ? sv[t - d] : 0;
      __syncthreads();
      sv[t] += add;
      __syncthreads();
    }
    long long run = sv[t] - mine;
    const long long total = sv[kOffsetThreads - 1];
    for (long long b = b0; b < b1; ++b) {
      const long long c = block_cnt[b * nparts + p];
      block_cnt[b * nparts + p] = static_cast<int32_t>(run);
      run += c;
    }
    if (t == 0 && total > cap) dropped += total - cap;
    __syncthreads();
  }
  if (t == 0) over[side] = dropped;
}

// each valid row to slot p * cap + rank, rank = its stable rank in p
template <typename K>
__global__ void scatter_rows(const K* __restrict__ key,
                             const uint8_t* __restrict__ ok, long long n,
                             int nparts, int log2r, long long cap,
                             const int32_t* __restrict__ block_off,
                             K* __restrict__ keys, int32_t* __restrict__ gidx,
                             uint8_t* __restrict__ occ) {
  __shared__ int32_t prefix[kMaxParts][kThreads];
  __shared__ int32_t warp_tot[kThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long base = blockIdx.x * (long long)kTile + t * kItems;
  int pid[kItems];
  bool valid[kItems];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    valid[k] = i < n && ok[i];
    pid[k] = valid[k] ? pid_of(key[i], log2r) : 0;
  }
  // exclusive prefix over the threads of this block, per partition
  for (int p = 0; p < nparts; ++p) {
    int mine = 0;
    for (int k = 0; k < kItems; ++k) mine += (valid[k] && pid[k] == p) ? 1 : 0;
    int incl = mine;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_tot[w];
    prefix[p][t] = before + incl - mine;
    __syncthreads();
  }
  int seen[kItems];
  for (int k = 0; k < kItems; ++k) {
    seen[k] = 0;
    for (int j = 0; j < k; ++j) seen[k] += (valid[j] && pid[j] == pid[k]) ? 1 : 0;
  }
  for (int k = 0; k < kItems; ++k) {
    if (!valid[k]) continue;
    const int p = pid[k];
    const long long rank = static_cast<long long>(
                               block_off[blockIdx.x * (long long)nparts + p]) +
                           prefix[p][t] + seen[k];
    if (rank >= cap) continue;
    const long long dst = p * cap + rank;
    const long long i = base + k;
    keys[dst] = key[i];
    gidx[dst] = static_cast<int32_t>(i);
    occ[dst] = 1;
  }
}

template <typename K>
__device__ __forceinline__ long long first_not_less(const K* a, long long m, K q) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename K>
__device__ __forceinline__ long long first_greater(const K* a, long long m, K q) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename K>
__global__ void match_ranges(const K* __restrict__ ks, long long lcap,
                             const K* __restrict__ rk, const uint8_t* __restrict__ rok,
                             long long rcap, long long m,
                             int32_t* __restrict__ lo_i, long long* __restrict__ cnt) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < m;
       j += (long long)gridDim.x * blockDim.x) {
    const long long p = j / rcap;
    const K* a = ks + p * lcap;
    const K q = rk[j];
    const long long lo = first_not_less(a, lcap, q);
    const long long hi = first_greater(a, lcap, q);
    lo_i[j] = static_cast<int32_t>(lo);
    cnt[j] = rok[j] ? hi - lo : 0;
  }
}

__global__ void expand_slots(const long long* __restrict__ offs,
                             const int32_t* __restrict__ lo_i,
                             const int32_t* __restrict__ gs,
                             const int32_t* __restrict__ rg, long long nparts,
                             long long lcap, long long rcap, long long kp,
                             int32_t* __restrict__ lidx,
                             int32_t* __restrict__ ridx,
                             uint8_t* __restrict__ present) {
  const long long m = nparts * kp;
  const long long cl = kp + 1;
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < m;
       j += (long long)gridDim.x * blockDim.x) {
    const long long p = j / kp;
    const long long s = j - p * kp;
    const long long* o = offs + p * rcap;
    // rloc = searchsorted(min(offs, kp + 1), s, side="right")
    long long lo = 0, hi = rcap;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      const long long v = o[mid] < cl ? o[mid] : cl;
      if (v <= s) lo = mid + 1; else hi = mid;
    }
    const long long rloc = lo > rcap - 1 ? rcap - 1 : lo;
    long long prev = 0;
    if (rloc > 0) prev = o[rloc - 1] < cl ? o[rloc - 1] : cl;
    long long lpos = static_cast<long long>(lo_i[p * rcap + rloc]) + (s - prev);
    lpos = lpos < 0 ? 0 : (lpos > lcap - 1 ? lcap - 1 : lpos);
    lidx[j] = gs[p * lcap + lpos];
    ridx[j] = rg[p * rcap + rloc];
    const long long total = o[rcap - 1];
    present[j] = s < (total < kp ? total : kp) ? 1 : 0;
  }
}

__global__ void sum_overflow(const long long* __restrict__ offs, long long nparts,
                             long long rcap, long long kp,
                             const long long* __restrict__ over,
                             long long* __restrict__ overflow) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  long long acc = over[0] + over[1];
  for (long long p = 0; p < nparts; ++p) {
    const long long total = offs[p * rcap + rcap - 1];
    if (total > kp) acc += total - kp;
  }
  *overflow = acc;
}

template <typename K>
void partition_t(const void* key, const void* ok, long long n, int nparts,
                 int log2r, long long cap, void* keys, void* gidx, void* occ,
                 void* block_cnt, void* over, int side, K sent, cudaStream_t s) {
  const long long m = nparts * cap;
  const long long nblocks = (n + kTile - 1) / kTile;
  fill_blocks<K><<<grid_for(m), kThreads, 0, s>>>(
      static_cast<K*>(keys), static_cast<int32_t*>(gidx),
      static_cast<uint8_t*>(occ), m, sent);
  histogram<K><<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      static_cast<const K*>(key), static_cast<const uint8_t*>(ok), n, nparts,
      log2r, static_cast<int32_t*>(block_cnt));
  block_offsets<<<1, kOffsetThreads, 0, s>>>(
      static_cast<int32_t*>(block_cnt), nblocks, nparts, cap,
      static_cast<long long*>(over), side);
  scatter_rows<K><<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      static_cast<const K*>(key), static_cast<const uint8_t*>(ok), n, nparts,
      log2r, cap, static_cast<const int32_t*>(block_cnt), static_cast<K*>(keys),
      static_cast<int32_t*>(gidx), static_cast<uint8_t*>(occ));
}

}  // namespace

extern "C" {

int nds_pj_tile() { return kTile; }

// One side's partition blocks. key: int32 or int64 (key64) [n], ok: bool[n].
// keys: K[nparts * cap], gidx: int32[nparts * cap], occ: bool[nparts * cap],
// block_cnt: int32[ceil(n / nds_pj_tile()) * nparts] scratch, over: int64[2]
// (this side's dropped rows land in over[side]). n >= 1, nparts a power of
// two <= 32 with nparts == 1 << log2r.
int nds_pj_partition(const void* key, const void* ok, long long n, int key64,
                     int nparts, int log2r, long long cap, void* keys,
                     void* gidx, void* occ, void* block_cnt, void* over,
                     int side, void* stream) {
  if (n < 1 || cap < 1 || nparts < 1 || nparts > kMaxParts ||
      nparts != (1 << log2r) || side < 0 || side > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key64)
    partition_t<int64_t>(key, ok, n, nparts, log2r, cap, keys, gidx, occ,
                         block_cnt, over, side, INT64_MAX, s);
  else
    partition_t<int32_t>(key, ok, n, nparts, log2r, cap, keys, gidx, occ,
                         block_cnt, over, side, INT32_MAX, s);
  return static_cast<int>(cudaGetLastError());
}

// Match ranges of every probe slot. ks: sorted build keys K[nparts * lcap];
// rk: probe keys K[nparts * rcap], rok: bool[nparts * rcap]. lo_i:
// int32[nparts * rcap], cnt: int64[nparts * rcap].
int nds_pj_ranges(const void* ks, int key64, long long lcap, const void* rk,
                  const void* rok, long long rcap, int nparts, void* lo_i,
                  void* cnt, void* stream) {
  if (lcap < 1 || rcap < 1 || nparts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long m = nparts * rcap;
  if (key64)
    match_ranges<int64_t><<<grid_for(m), kThreads, 0, s>>>(
        static_cast<const int64_t*>(ks), lcap, static_cast<const int64_t*>(rk),
        static_cast<const uint8_t*>(rok), rcap, m, static_cast<int32_t*>(lo_i),
        static_cast<long long*>(cnt));
  else
    match_ranges<int32_t><<<grid_for(m), kThreads, 0, s>>>(
        static_cast<const int32_t*>(ks), lcap, static_cast<const int32_t*>(rk),
        static_cast<const uint8_t*>(rok), rcap, m, static_cast<int32_t*>(lo_i),
        static_cast<long long*>(cnt));
  return static_cast<int>(cudaGetLastError());
}

// Expansion into nparts * kp output slots. offs: per-partition inclusive
// prefix of cnt, int64[nparts * rcap]; lo_i: int32[nparts * rcap]; gs: build
// row of each sorted slot, int32[nparts * lcap]; rg: probe row of each slot,
// int32[nparts * rcap]; over: int64[2] from nds_pj_partition. lidx, ridx:
// int32[nparts * kp]; present: bool[nparts * kp]; overflow: int64[1].
int nds_pj_expand(const void* offs, const void* lo_i, const void* gs,
                  const void* rg, int nparts, long long lcap, long long rcap,
                  long long kp, const void* over, void* lidx, void* ridx,
                  void* present, void* overflow, void* stream) {
  if (lcap < 1 || rcap < 1 || kp < 1 || nparts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  expand_slots<<<grid_for(nparts * kp), kThreads, 0, s>>>(
      static_cast<const long long*>(offs), static_cast<const int32_t*>(lo_i),
      static_cast<const int32_t*>(gs), static_cast<const int32_t*>(rg), nparts,
      lcap, rcap, kp, static_cast<int32_t*>(lidx), static_cast<int32_t*>(ridx),
      static_cast<uint8_t*>(present));
  sum_overflow<<<1, 32, 0, s>>>(static_cast<const long long*>(offs), nparts,
                                rcap, kp, static_cast<const long long*>(over),
                                static_cast<long long*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
