// Probe against a build side of at most 256 rows (K2).
//
// Replaces nds_tpu/engine/kernels.py `matmul_probe_join`, which forms the
// (probe x build) one-hot equality matrix and contracts it in float32 against
// the build iota (for ridx) and against ones (for the match count). Here each
// block stages the build keys and ok flags in shared memory once, and each
// thread takes one probe row at a time and walks the staged build. It writes
// exactly what the f32 products give:
//   ridx = min(max(sum of matching build indices, 0), n_build - 1)
//   hit  = pok && (number of matches > 0)
// including their behavior if the build ever held duplicate keys (the sum of
// indices). The sums stay far below 2^24, where the f32 dot is exact.
//
// What bounds it on an H100: bytes at the shapes of the main path. A probe of
// 6,001,215 rows moves 6.0M x (key 4 or 8 + ok 1 + ridx 4 + hit 1) bytes, about
// 60-84 MB, which is 18-25 us at 3.35 TB/s; the compares are n_build per row
// out of shared memory (a broadcast read, every lane on the same address).
// At n_build = 256 that compare loop, not HBM, is what this simple first
// version spends its time on; the grid is capped so that each block amortizes
// its staging over many rows.
//
// The entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuild = 256;

template <typename K>
__global__ void small_probe(const K* __restrict__ bkey,
                            const uint8_t* __restrict__ bok, int nb,
                            const K* __restrict__ pkey,
                            const uint8_t* __restrict__ pok, long long np,
                            int32_t* __restrict__ ridx,
                            uint8_t* __restrict__ hit) {
  __shared__ K sk[kMaxBuild];
  __shared__ uint8_t so[kMaxBuild];
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    sk[j] = bkey[j];
    so[j] = bok[j];
  }
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < np;
       i += (long long)gridDim.x * blockDim.x) {
    const K k = pkey[i];
    int sum = 0;
    int cnt = 0;
    for (int j = 0; j < nb; ++j) {
      if (so[j] && sk[j] == k) {
        sum += j;
        ++cnt;
      }
    }
    ridx[i] = sum < 0 ? 0 : (sum > nb - 1 ? nb - 1 : sum);
    hit[i] = (pok[i] && cnt > 0) ? 1 : 0;
  }
}

inline unsigned grid_for(long long n) {
  long long g = (n + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  // 132 SMs x 8 resident blocks: each block stages the build once and
  // then strides over many probe rows
  if (g > 132 * 8) g = 132 * 8;
  return static_cast<unsigned>(g);
}

}  // namespace

extern "C" {

int nds_small_build_max() { return kMaxBuild; }

// K2. ridx: int32[np]; hit: uint8[np]. nb must be in [1, 256].
int nds_matmul_probe_join(const void* bkey, const void* bok, int nb,
                          const void* pkey, const void* pok, long long np,
                          int key64, void* ridx, void* hit, void* stream) {
  if (nb < 1 || nb > kMaxBuild) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key64)
    small_probe<int64_t><<<grid_for(np), kThreads, 0, s>>>(
        static_cast<const int64_t*>(bkey), static_cast<const uint8_t*>(bok), nb,
        static_cast<const int64_t*>(pkey), static_cast<const uint8_t*>(pok), np,
        static_cast<int32_t*>(ridx), static_cast<uint8_t*>(hit));
  else
    small_probe<int32_t><<<grid_for(np), kThreads, 0, s>>>(
        static_cast<const int32_t*>(bkey), static_cast<const uint8_t*>(bok), nb,
        static_cast<const int32_t*>(pkey), static_cast<const uint8_t*>(pok), np,
        static_cast<int32_t*>(ridx), static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
