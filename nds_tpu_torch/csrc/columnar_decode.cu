// Decode of the compressed columnar store: bitpack (K8) and RLE (K9).
//
// Replaces nds_tpu/columnar/device.py: `_unpack_words` and `unpack_mask` with
// the bitpack branch of `decode` (K8), and the RLE branch of `decode` (K9).
// The host encoder (nds_tpu_torch/columnar/encodings.py, byte-identical to
// the reference's) writes:
//   bitpack: int32 words holding 32/bits fields of `bits` bits each, low
//            field first, each field the value minus the bias `lo`; bits = 32
//            stores (value - lo) as one int32 per row; bits = 1 with lo = 0 is
//            a packed validity mask. The last word's unused fields are zeros.
//   rle:     the run values (int32 or int64) and int32 run starts, starts[0]
//            = 0, taken from the live prefix of the column; the decoded length
//            `n` may pass the last run (a padded scan view), and the last run
//            then reaches n, as the reference's cumsum carries its last run id
//            over the pad.
//
// K8 computes exactly what the JAX code computes: the field of row i is
// (word[i / per] >> ((i % per) * bits)) & (2^bits - 1), read with an unsigned
// shift (the JAX version masks its arithmetic shift's sign bits off, which
// gives the same field). Where lo and lo + 2^bits fit int32 the bias is added
// in int32 (the reference's native-width path; the sum cannot overflow
// there), else in int64; bits = 32 is a sign-extending widen plus the bias in
// int64. The result is cast to the column's type (int32 or int64), modulo
// 2^32 where an int64 sum narrows, as XLA's convert does; a mask field becomes
// a bool. One thread per output row: a warp's 32 rows read one to a few words
// (the same cache line) and write 32 neighbouring outputs, so every store is
// coalesced.
//
// K9 searches by row rather than expanding by run. Run lengths are skewed
// (l_orderkey has about 4 rows a run, a sorted date column thousands), so one
// block or warp per run would leave most threads idle on short runs and
// serialize long ones, while a search by row gives every block the same tile
// of rows whatever the runs. Each block takes a tile of kTile rows, finds the
// runs that overlap it with two binary searches over the starts, stages those
// starts (at most kTile of them) in shared memory, and each thread then finds
// the last start <= its row in that short list and gathers the run's value.
// No atomics, no scratch in device memory, and no value depends on an order of
// execution.
//
// What bounds both on an H100: bytes. K8 at 6,001,215 rows writes 24 MB
// (int32) or 48 MB (int64) from 0.75-24 MB of words: 8-22 us at 3.35 TB/s.
// K9 reads the runs (12 bytes each for int64 values) and writes n values;
// l_orderkey at SF1, 1.5M runs into 6.0M int64 rows, is about 66 MB, 20 us.
// The arithmetic per row is a few integer operations.
//
// The entry points launch on the given stream, allocate nothing and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // rows per block of the RLE decode

// out kinds of nds_bitpack_decode
constexpr int kOutI32 = 0;
constexpr int kOutI64 = 1;
constexpr int kOutBool = 2;

template <typename T>
__device__ __forceinline__ T narrow(long long v);

template <>
__device__ __forceinline__ int32_t narrow<int32_t>(long long v) {
  // modulo 2^32, two's complement (XLA's int64 -> int32 convert)
  return static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<unsigned long long>(v)));
}

template <>
__device__ __forceinline__ int64_t narrow<int64_t>(long long v) {
  return static_cast<int64_t>(v);
}

template <>
__device__ __forceinline__ uint8_t narrow<uint8_t>(long long v) {
  return v != 0 ? 1 : 0;
}

// One thread per output row. log2bits in 0..5 (bits 1..32); kWide adds the
// bias in int64, else in int32.
template <typename T, bool kWide>
__global__ void bitpack_decode(const int32_t* __restrict__ words, long long n,
                               int log2bits, long long lo,
                               T* __restrict__ out) {
  const int bits = 1 << log2bits;
  const int per_log = 5 - log2bits;  // log2(32 / bits)
  const uint32_t mask =
      bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long v;
    if (bits == 32) {
      // biased downcast: the stored int32 widens with its sign
      v = static_cast<long long>(words[i]) + lo;
    } else {
      const uint32_t w = static_cast<uint32_t>(words[i >> per_log]);
      const int shift =
          static_cast<int>(i & ((1LL << per_log) - 1)) << log2bits;
      const uint32_t field = (w >> shift) & mask;
      if (kWide) {
        v = static_cast<long long>(field) + lo;
      } else {
        // lo and lo + 2^bits fit int32: the int32 sum cannot overflow
        v = static_cast<long long>(static_cast<int32_t>(field) +
                                   static_cast<int32_t>(lo));
      }
    }
    out[i] = narrow<T>(v);
  }
}

inline unsigned grid_for(long long n) {
  long long g = (n + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  // grid-stride beyond 132 SMs x 16 blocks
  if (g > 132 * 16) g = 132 * 16;
  return static_cast<unsigned>(g);
}

template <typename T>
int launch_bitpack(const void* words, long long n, int log2bits, long long lo,
                   int wide, void* out, cudaStream_t s) {
  const int32_t* w = static_cast<const int32_t*>(words);
  T* o = static_cast<T*>(out);
  if (wide)
    bitpack_decode<T, true><<<grid_for(n), kThreads, 0, s>>>(w, n, log2bits,
                                                             lo, o);
  else
    bitpack_decode<T, false><<<grid_for(n), kThreads, 0, s>>>(w, n, log2bits,
                                                              lo, o);
  return static_cast<int>(cudaGetLastError());
}

// First index in [lo, hi) whose start is > x (hi if none).
__device__ __forceinline__ int first_greater(const int32_t* starts, int lo,
                                           int hi, long long x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(starts[mid]) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void rle_decode(const T* __restrict__ values,
                           const int32_t* __restrict__ starts, int runs,
                           long long n, T* __restrict__ out) {
  __shared__ int32_t s_starts[kTile];
  __shared__ int s_first, s_count;
  const long long tile0 = blockIdx.x * (long long)kTile;
  if (tile0 >= n) return;
  const long long tile1 = tile0 + kTile < n ? tile0 + kTile : n;
  if (threadIdx.x == 0) {
    // the run holding the tile's first row, and the runs starting inside
    // the tile: at most kTile starts in all
    int first = first_greater(starts, 0, runs, tile0) - 1;
    if (first < 0) first = 0;
    // strictly increasing starts: at most kTile - 1 runs start after
    // tile0 and before tile1
    const int hi = runs - first > kTile ? first + kTile : runs;
    const int last = first_greater(starts, first, hi, tile1 - 1) - 1;
    int count = (last < first ? first : last) - first + 1;
    s_first = first;
    s_count = count > kTile ? kTile : count;
  }
  __syncthreads();
  const int first = s_first;
  const int count = s_count;
  for (int j = threadIdx.x; j < count; j += blockDim.x)
    s_starts[j] = starts[first + j];
  __syncthreads();
  for (long long i = tile0 + threadIdx.x; i < tile1; i += blockDim.x) {
    int r = first_greater(s_starts, 0, count, i) - 1;
    if (r < 0) r = 0;  // only where starts[0] > 0, outside the contract
    out[i] = values[first + r];
  }
}

}  // namespace

extern "C" {

// K8. words: int32; out: int32, int64 or bool (uint8) of n rows, out_kind
// 0, 1 or 2. log2bits in [0, 5]; wide = 1 adds the bias in int64.
int nds_bitpack_decode(const void* words, long long n, int log2bits,
                       long long lo, int wide, int out_kind, void* out,
                       void* stream) {
  if (log2bits < 0 || log2bits > 5 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log2bits == 5) wide = 1;
  switch (out_kind) {
    case kOutI32:
      return launch_bitpack<int32_t>(words, n, log2bits, lo, wide, out, s);
    case kOutI64:
      return launch_bitpack<int64_t>(words, n, log2bits, lo, wide, out, s);
    case kOutBool:
      return launch_bitpack<uint8_t>(words, n, log2bits, lo, wide, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9. values: int32 (val64 = 0) or int64 (val64 = 1) of `runs`; starts: int32
// of `runs`, strictly increasing from 0; out: n values of the values' type.
int nds_rle_decode(const void* values, const void* starts, int runs,
                   long long n, int val64, void* out, void* stream) {
  if (runs < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* st = static_cast<const int32_t*>(starts);
  if (val64)
    rle_decode<int64_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int64_t*>(values), st, runs, n,
        static_cast<int64_t*>(out));
  else
    rle_decode<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(values), st, runs, n,
        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
