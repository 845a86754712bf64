// Hash-partition exchange pack (L5).
//
// Replaces the part of nds_tpu/parallel/exchange.py that runs before each
// lax.all_to_all: `_mix64`, the destination of `exchange` and of both
// stages of `exchange_hierarchical`, and `exchange_by_dest`'s grouping,
// ranks, overflow count and scatter. The all_to_all itself is NCCL's
// (torch.distributed.all_to_all_single), called by the Python caller on
// the buffers written here. It computes what the JAX function computes,
// slot for slot, but not with its steps (a stable sort of (dest, iota), a
// searchsorted and a scatter per payload):
//
//   destination, per row, in uint64_t: the explicit int32 dest, or
//     g = splitmix64(uint64(int64(key))) % modulus, dest = (g / div) % n_dev;
//     the flat hash is (modulus, div) = (n_dev, 1), hierarchical stage 1
//     (hosts * lanes, lanes) and stage 2 (hosts * lanes, 1). A row that is
//     not ok (or whose dest is outside [0, n_dev)) goes nowhere: the JAX
//     version's sentinel dest n_dev.
//   slots with no sort: a per-tile histogram over the destinations, one
//     block that turns the tile counts into exclusive offsets in (dest,
//     tile) order, and a pack pass that ranks each row by its tile's offset
//     plus a block-local prefix count, as K6's radix partition does
//     (partitioned_join.cu). No atomic decides a slot, so every row's rank
//     is its stable rank among the live rows of its destination, the JAX
//     version's `iota - first_of_dest`.
//   overflow: sum over dests of max(count - bucket, 0), in int64: the rows
//     that are ok and rank >= bucket.
//   pack: a row of rank < bucket writes each payload element to slot
//     dest * bucket + rank, copied as 1, 2, 4 or 8 bytes of bits (floats
//     stay exact), and send_ok[slot] = 1. Then a fill pass writes zeros to
//     every slot that no row took, [min(count, bucket), bucket) of each
//     destination, so each output byte is written exactly once.
//
// What bounds it on an H100: bytes. The function must read the key (or
// dest), ok and every payload once and write n_dev * bucket slots of every
// payload and of send_ok. This first version reads the key and ok twice
// (histogram and pack) and, past kMaxPay payloads, once more per further
// group of payloads; the scattered stores land in n_dev runs that each
// advance in order, so they coalesce as the destinations allow.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxDest = 32;
constexpr int kOffsetThreads = 1024;
constexpr int kMaxPay = 16;

// payload columns of one pack or fill launch (passed by value)
struct Payloads {
  const void* src[kMaxPay];
  void* dst[kMaxPay];
  int size[kMaxPay];
  int count;
};

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// mode 0: explicit int32 dest; 1: int32 key; 2: int64 key. -1 = no dest.
__device__ __forceinline__ int dest_of(const void* key, const int32_t* dest,
                                       int mode, long long i,
                                       uint64_t modulus, uint64_t div,
                                       int n_dev) {
  int d;
  if (mode == 0) {
    d = dest[i];
  } else {
    const int64_t k = mode == 1
                          ? static_cast<int64_t>(static_cast<const int32_t*>(key)[i])
                          : static_cast<const int64_t*>(key)[i];
    const uint64_t g = mix64(static_cast<uint64_t>(k)) % modulus;
    d = static_cast<int>((g / div) % static_cast<uint64_t>(n_dev));
  }
  return (d >= 0 && d < n_dev) ? d : -1;
}

// block_cnt[b * n_dev + d] = live rows of tile b bound for d
__global__ void histogram(const void* key, const int32_t* dest, int mode,
                          const uint8_t* __restrict__ ok, long long n,
                          uint64_t modulus, uint64_t div, int n_dev,
                          int32_t* __restrict__ block_cnt) {
  __shared__ int cnt[kMaxDest];
  if (threadIdx.x < kMaxDest) cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long base = blockIdx.x * (long long)kTile + threadIdx.x * kItems;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < n && ok[i]) {
      const int d = dest_of(key, dest, mode, i, modulus, div, n_dev);
      if (d >= 0) atomicAdd(&cnt[d], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < n_dev)
    block_cnt[blockIdx.x * (long long)n_dev + threadIdx.x] = cnt[threadIdx.x];
}

// one block: block_cnt becomes exclusive offsets per dest over the tiles;
// fill_from[d] = min(count_d, bucket); overflow = sum_d max(count_d - bucket, 0)
__global__ void block_offsets(int32_t* __restrict__ block_cnt, long long nblocks,
                              int n_dev, long long bucket,
                              long long* __restrict__ fill_from,
                              long long* __restrict__ overflow) {
  __shared__ long long sv[kOffsetThreads];
  const int t = threadIdx.x;
  const long long chunk = (nblocks + kOffsetThreads - 1) / kOffsetThreads;
  const long long b0 = t * chunk;
  const long long b1 = b0 + chunk < nblocks ? b0 + chunk : nblocks;
  long long over = 0;
  for (int d = 0; d < n_dev; ++d) {
    long long mine = 0;
    for (long long b = b0; b < b1; ++b) mine += block_cnt[b * n_dev + d];
    sv[t] = mine;
    __syncthreads();
    for (int s = 1; s < kOffsetThreads; s <<= 1) {
      const long long add = t >= s ? sv[t - s] : 0;
      __syncthreads();
      sv[t] += add;
      __syncthreads();
    }
    long long run = sv[t] - mine;
    const long long total = sv[kOffsetThreads - 1];
    for (long long b = b0; b < b1; ++b) {
      const long long c = block_cnt[b * n_dev + d];
      block_cnt[b * n_dev + d] = static_cast<int32_t>(run);
      run += c;
    }
    if (t == 0) {
      fill_from[d] = total < bucket ? total : bucket;
      if (total > bucket) over += total - bucket;
    }
    __syncthreads();
  }
  if (t == 0) *overflow = over;
}

__device__ __forceinline__ void copy_elem(const void* src, void* dst, int size,
                                          long long i, long long slot) {
  switch (size) {
    case 1:
      static_cast<uint8_t*>(dst)[slot] = static_cast<const uint8_t*>(src)[i];
      break;
    case 2:
      static_cast<uint16_t*>(dst)[slot] = static_cast<const uint16_t*>(src)[i];
      break;
    case 4:
      static_cast<uint32_t*>(dst)[slot] = static_cast<const uint32_t*>(src)[i];
      break;
    default:
      static_cast<uint64_t*>(dst)[slot] = static_cast<const uint64_t*>(src)[i];
      break;
  }
}

__device__ __forceinline__ void zero_elem(void* dst, int size, long long slot) {
  switch (size) {
    case 1: static_cast<uint8_t*>(dst)[slot] = 0; break;
    case 2: static_cast<uint16_t*>(dst)[slot] = 0; break;
    case 4: static_cast<uint32_t*>(dst)[slot] = 0; break;
    default: static_cast<uint64_t*>(dst)[slot] = 0; break;
  }
}

// each live row of rank < bucket to slot d * bucket + rank
__global__ void pack(const void* key, const int32_t* dest, int mode,
                     const uint8_t* __restrict__ ok, long long n,
                     uint64_t modulus, uint64_t div, int n_dev,
                     long long bucket, const int32_t* __restrict__ block_off,
                     Payloads pay, uint8_t* __restrict__ send_ok) {
  __shared__ int32_t prefix[kMaxDest][kThreads];
  __shared__ int32_t warp_tot[kThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long base = blockIdx.x * (long long)kTile + t * kItems;
  int dst[kItems];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    dst[k] = (i < n && ok[i]) ? dest_of(key, dest, mode, i, modulus, div, n_dev)
                              : -1;
  }
  // exclusive prefix over the threads of this block, per destination
  for (int d = 0; d < n_dev; ++d) {
    int mine = 0;
    for (int k = 0; k < kItems; ++k) mine += dst[k] == d ? 1 : 0;
    int incl = mine;
    for (int s = 1; s < 32; s <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += up;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_tot[w];
    prefix[d][t] = before + incl - mine;
    __syncthreads();
  }
  for (int k = 0; k < kItems; ++k) {
    const int d = dst[k];
    if (d < 0) continue;
    int seen = 0;
    for (int j = 0; j < k; ++j) seen += dst[j] == d ? 1 : 0;
    const long long rank =
        static_cast<long long>(block_off[blockIdx.x * (long long)n_dev + d]) +
        prefix[d][t] + seen;
    if (rank >= bucket) continue;
    const long long slot = d * bucket + rank;
    const long long i = base + k;
    if (send_ok != nullptr) send_ok[slot] = 1;
    for (int p = 0; p < pay.count; ++p)
      copy_elem(pay.src[p], pay.dst[p], pay.size[p], i, slot);
  }
}

// zeros in [fill_from[d], bucket) of destination d = blockIdx.y
__global__ void fill_tail(const long long* __restrict__ fill_from,
                          long long bucket, Payloads pay,
                          uint8_t* __restrict__ send_ok) {
  const long long d = blockIdx.y;
  for (long long s = fill_from[d] + blockIdx.x * (long long)blockDim.x +
                     threadIdx.x;
       s < bucket; s += (long long)gridDim.x * blockDim.x) {
    const long long slot = d * bucket + s;
    if (send_ok != nullptr) send_ok[slot] = 0;
    for (int p = 0; p < pay.count; ++p) zero_elem(pay.dst[p], pay.size[p], slot);
  }
}

Payloads group_of(int first, int n_pay, const void* const* src,
                  void* const* dst, const int* sizes) {
  Payloads pay{};
  const int end = first + kMaxPay < n_pay ? first + kMaxPay : n_pay;
  for (int p = first; p < end; ++p) {
    pay.src[p - first] = src[p];
    pay.dst[p - first] = dst[p];
    pay.size[p - first] = sizes[p];
  }
  pay.count = end - first;
  return pay;
}

}  // namespace

extern "C" int nds_exchange_tile() { return kTile; }

extern "C" int nds_exchange_max_dest() { return kMaxDest; }

// key: int32 or int64 keys (mode 1 or 2), or null; dest: int32 dests
// (mode 0), or null. src, dst and sizes are host arrays of n_pay entries.
// block_cnt: int32[nblocks * n_dev] scratch (nblocks = ceil(n / tile), at
// least 1); fill_from: int64[n_dev] scratch; overflow: one int64.
extern "C" int nds_exchange_pack(const void* key, const void* dest, int mode,
                                 const void* ok, long long n,
                                 long long modulus, long long div, int n_dev,
                                 long long bucket, int n_pay,
                                 const void* const* src, void* const* dst,
                                 const int* sizes, void* send_ok,
                                 void* block_cnt, void* fill_from,
                                 void* overflow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nblocks = n > 0 ? (n + kTile - 1) / kTile : 1;
  const auto* dest_i = static_cast<const int32_t*>(dest);
  const auto* ok_u = static_cast<const uint8_t*>(ok);
  auto* cnt = static_cast<int32_t*>(block_cnt);
  auto* fill = static_cast<long long*>(fill_from);
  const uint64_t mod_u = static_cast<uint64_t>(modulus);
  const uint64_t div_u = static_cast<uint64_t>(div);
  histogram<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      key, dest_i, mode, ok_u, n, mod_u, div_u, n_dev, cnt);
  block_offsets<<<1, kOffsetThreads, 0, s>>>(
      cnt, nblocks, n_dev, bucket, fill, static_cast<long long*>(overflow));
  long long gx = (bucket + kThreads - 1) / kThreads;
  if (gx > 4096) gx = 4096;
  if (gx < 1) gx = 1;
  const dim3 fill_grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_dev));
  int first = 0;
  do {
    const Payloads pay = group_of(first, n_pay, src, dst, sizes);
    // send_ok rides with the first group of payloads
    auto* ok_out = first == 0 ? static_cast<uint8_t*>(send_ok) : nullptr;
    pack<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
        key, dest_i, mode, ok_u, n, mod_u, div_u, n_dev, bucket, cnt, pay,
        ok_out);
    fill_tail<<<fill_grid, kThreads, 0, s>>>(fill, bucket, pay, ok_out);
    first += kMaxPay;
  } while (first < n_pay);
  return static_cast<int>(cudaGetLastError());
}
