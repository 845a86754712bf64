// The result compactor (L1): the stable partition of the rows by presence.
//
// Replaces nds_tpu/engine/device_exec.py `_compactor` (`:947`, the lax.sort
// of (absent, iota) before a large result crosses to the host, and its
// count) and `_compact` (`:2617`, the same sort before a LIMIT whose child
// is not ordered). It writes perm, the ids of the present rows in row order
// and then those of the absent rows in row order (the stable sort's
// permutation), and the present rows' count, on the card.
//
// Three launches: (1) one block per tile of 4096 rows counts its present
// rows; (2) one block turns the tiles' counts into exclusive offsets and
// the total (each thread sums a run of tiles, one block-wide scan of the
// runs, each thread writes its run's offsets); (3) one block per tile stages
// its mask bytes in shared memory, gives each thread 16 consecutive rows,
// scans the threads' present counts across the block, and writes each row's
// id at its place among the present rows (the tile's offset, the threads
// before it, the rows before it in the thread) or, past the total, among
// the absent rows. No tile waits on another and nothing is kept between
// calls, so the kernel needs no look-back state, and a CUDA graph replays
// it as it is.
//
// What bounds it on an H100: bytes: the function reads the mask (1 byte a
// row) and writes 4-byte ids; the kernel reads the mask twice.
//
// The entry point launches on the given stream, allocates nothing (the
// tiles' counts are the caller's scratch) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

// exclusive sum of v over the block; total: the block's sum
__device__ __forceinline__ long long block_excl(long long v, long long* s_w,
                                                long long& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_w[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? s_w[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_w[lane] = w;
  }
  __syncthreads();
  total = s_w[kWarps - 1];
  const long long out = (warp > 0 ? s_w[warp - 1] : 0) + x - v;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
    tile_counts(const uint8_t* __restrict__ row, long long n,
                int32_t* __restrict__ cnt) {
  __shared__ long long s_w[kWarps];
  const long long base = blockIdx.x * (long long)kTile;
  long long c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    c += i < n && row[i] != 0;
  }
  long long total;
  block_excl(c, s_w, total);
  if (threadIdx.x == 0) cnt[blockIdx.x] = static_cast<int32_t>(total);
}

// one block: the tiles' counts become their exclusive offsets in place
__global__ void __launch_bounds__(kThreads)
    tile_offsets(int32_t* __restrict__ cnt, long long ntiles,
                 long long* __restrict__ count) {
  __shared__ long long s_w[kWarps];
  const long long per = (ntiles + kThreads - 1) / kThreads;
  const long long a = threadIdx.x * per;
  const long long b = a + per < ntiles ? a + per : ntiles;
  long long s = 0;
  for (long long i = a; i < b; ++i) s += cnt[i];
  long long total;
  long long e = block_excl(s, s_w, total);
  for (long long i = a; i < b; ++i) {
    const int32_t c = cnt[i];
    cnt[i] = static_cast<int32_t>(e);
    e += c;
  }
  if (threadIdx.x == 0) *count = total;
}

__global__ void __launch_bounds__(kThreads)
    scatter_ids(const uint8_t* __restrict__ row, long long n,
                const int32_t* __restrict__ offs,
                const long long* __restrict__ count,
                int32_t* __restrict__ perm) {
  __shared__ uint8_t s_row[kTile];
  __shared__ long long s_w[kWarps];
  const int t = threadIdx.x;
  const long long base = blockIdx.x * (long long)kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + t;
    s_row[k * kThreads + t] = i < n ? row[i] : 0;
  }
  __syncthreads();
  const long long rows = n - base < kTile ? n - base : kTile;
  const int first = t * kItems;
  long long p = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) p += first + k < rows && s_row[first + k];
  long long total;
  const long long pe = block_excl(p, s_w, total);
  const long long tile_present = offs[blockIdx.x];
  long long at_p = tile_present + pe;
  // absent rows before this thread's: those of the tiles before, and those
  // of this tile's threads before it
  long long at_a = *count + (base - tile_present) +
                   ((first < rows ? first : rows) - pe);
  for (int k = 0; k < kItems; ++k) {
    if (first + k >= rows) break;
    const int32_t id = static_cast<int32_t>(base + first + k);
    if (s_row[first + k]) perm[at_p++] = id; else perm[at_a++] = id;
  }
}

}  // namespace

extern "C" {

int nds_compact_tile() { return kTile; }

// row: bool[n], 1 <= n < 2^31 - 1; cnt: int32 scratch of
// ceil(n / nds_compact_tile()) tiles; perm: int32[n]; count: int64[1].
int nds_compact_perm(const void* row, long long n, void* cnt, void* perm,
                     void* count, void* stream) {
  if (n < 1 || n >= (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + kTile - 1) / kTile;
  const uint8_t* r = static_cast<const uint8_t*>(row);
  int32_t* c = static_cast<int32_t*>(cnt);
  long long* total = static_cast<long long*>(count);
  tile_counts<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(r, n, c);
  tile_offsets<<<1, kThreads, 0, s>>>(c, ntiles, total);
  scatter_ids<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      r, n, c, total, static_cast<int32_t*>(perm));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
