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
// K9 works by row rather than by run. Run lengths are skewed (l_orderkey
// has about 4 rows a run, a sorted date column thousands), so one block or
// warp per run would leave most threads idle on short runs and serialize
// long ones, while tiles of rows give every block the same output whatever
// the runs. A block takes a tile of 32 KB of output (8,192 int32 or 4,096
// int64 rows).
// One warp finds the run that holds the tile's first row and another the
// one that holds its last, each by a 32-ary search over the global starts (a
// ballot over 32 samples a step: 2 dependent steps at 653 runs, 5 at 1.5M,
// where a binary search run by one thread took 10-21). The runs between
// them, at most a tile of them (one start a row), have their values staged
// in shared memory and their starts set as bits of a tile-wide row mask; a
// warp counts the mask's words into a prefix; then each row's run is the
// prefix of its word plus a popcount of the word up to the row: two shared
// loads and no search, however many runs the tile holds. Each thread writes
// 16 bytes at a time (4 int32 or 2 int64 rows), a warp's 32 vectors side by
// side, with one streaming store; the rows after the tile's last whole
// vector one a thread. No atomics in device memory, no scratch, and no value
// depends on an order of execution.
//
// What bounds both on an H100: bytes. K8 at 6,001,215 rows writes 24 MB
// (int32) or 48 MB (int64) from 0.75-24 MB of words: 8-22 us at 3.35 TB/s.
// K9 reads the runs (12 bytes each for int64 values) and writes n values;
// l_orderkey at SF1, 1.5M runs into 6.0M int64 rows, is about 66 MB, 20 us;
// the largest columnar call (653 int32 runs into 11.7M rows) writes 47 MB,
// 14 us. The arithmetic per row is a few integer operations. What else holds
// K9 is the tile's two searches: dependent loads from L2 before the first
// store, hidden by the other blocks an SM holds (6 at 34 KB of shared
// memory), and shared-memory traffic of about two loads a row where a tile
// holds many short runs.
//
// The entry points launch on the given stream, allocate nothing and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// K9. The last run whose start is <= x, found by one warp: each step tests
// 32 samples of `starts` spread over the interval left, one a lane, and a
// ballot keeps the one between the last sample <= x and the next, so the
// interval shrinks 32-fold a step (2 steps at 653 runs, 5 at 1.5M). starts[0]
// = 0 <= x; a starts[0] > x, outside the contract, gives run 0.
__device__ __forceinline__ int warp_last_le(const int32_t* __restrict__ starts,
                                            int runs, long long x, int lane) {
  long long lo = 0, hi = runs;  // the run sought is in [lo, hi)
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) >> 5;
    const long long at = lo + lane * step;
    const bool le = at < hi && static_cast<long long>(__ldg(starts + at)) <= x;
    const unsigned b = __ballot_sync(0xffffffffu, le);
    const long long last = b ? 31 - __clz(b) : 0;
    lo += last * step;
    hi = lo + step < hi ? lo + step : hi;
  }
  return static_cast<int>(lo);
}

// The run of row q of a tile, relative to the tile's first run: the starts
// inside the tile up to q, a bit a row in `mark` (bit q & 31 of word q >> 5),
// counted as the words' prefix `pre` plus the bits of q's word up to q.
__device__ __forceinline__ int run_of(const unsigned* mark, const int* pre,
                                      int q) {
  const unsigned upto = 0xffffffffu >> (31 - (q & 31));
  return pre[q >> 5] + __popc(mark[q >> 5] & upto);
}

// One block a tile of kTile rows. Warps 0 and 1 find the runs that hold the
// tile's first and last rows (warp_last_le); the runs between them, at most
// kTile, have their values staged in shared memory and their starts set as
// bits of a tile-wide row mask; warp 0 counts the mask's words into their
// prefix; then each thread takes 16 bytes of output at a time (4 int32 or 2
// int64 rows, a warp's 32 vectors side by side), finds each row's run from
// the mask in two shared loads and a popcount, and writes the vector with
// one streaming store. The rows after the tile's last whole vector are
// written one a thread. `out` is 16-byte aligned (the caller checks) and
// tiles start at multiples of kTile rows, so every vector store is aligned.
template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads)
    rle_decode(const T* __restrict__ values,
               const int32_t* __restrict__ starts, int runs, long long n,
               T* __restrict__ out) {
  constexpr int R = 16 / static_cast<int>(sizeof(T));  // rows a vector
  constexpr int W = kTile / 32;                         // mask words
  constexpr int PW = W / 32;                            // words a lane counts
  __shared__ T s_val[kTile];
  __shared__ unsigned s_mark[W];
  __shared__ int s_pre[W];
  __shared__ int s_run[2];
  const long long t0 = blockIdx.x * static_cast<long long>(kTile);
  const int len = n - t0 < kTile ? static_cast<int>(n - t0) : kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = threadIdx.x; w < W; w += kThreads) s_mark[w] = 0;
  if (warp < 2) {
    const int r = warp_last_le(starts, runs, t0 + (warp ? len - 1 : 0), lane);
    if (lane == 0) s_run[warp] = r;
  }
  __syncthreads();
  const int first = s_run[0];
  int count = s_run[1] - first + 1;  // strictly increasing starts: <= len
  if (count > kTile) count = kTile;
  for (int j = threadIdx.x; j < count; j += kThreads) {
    s_val[j] = values[first + j];
    // a start of the tile, in (t0, t0 + len) under the contract
    const long long q = starts[first + j] - t0;
    if (j > 0 && q > 0 && q < len)
      atomicOr(s_mark + (q >> 5), 1u << (q & 31));
  }
  __syncthreads();
  if (warp == 0) {
    int c[PW];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      c[i] = __popc(s_mark[lane * PW + i]);
      sum += c[i];
    }
    int inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    int run = inc - sum;
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      s_pre[lane * PW + i] = run;
      run += c[i];
    }
  }
  __syncthreads();
  T* o = out + t0;
  const int nvec = len / R;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const int q = v * R;  // a vector's rows share one mask word
    const unsigned word = s_mark[q >> 5];
    const int base = s_pre[q >> 5];
    T e[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const unsigned upto = 0xffffffffu >> (31 - ((q + t) & 31));
      e[t] = s_val[base + __popc(word & upto)];
    }
    if constexpr (R == 4)
      __stcs(reinterpret_cast<int4*>(o + q), make_int4(e[0], e[1], e[2], e[3]));
    else
      __stcs(reinterpret_cast<longlong2*>(o + q),
             make_longlong2(e[0], e[1]));
  }
  for (int q = nvec * R + threadIdx.x; q < len; q += kThreads)
    o[q] = s_val[run_of(s_mark, s_pre, q)];
}

// A tile of 32 KB of output: 8,192 int32 rows or 4,096 int64 (measured on
// an H100, PERF.md: int32 tiles of 4,096 rows were 2-4% slower).
template <typename T>
int launch_rle(const void* values, const int32_t* st, int runs, long long n,
               void* out, cudaStream_t s) {
  constexpr int kTile = 32768 / static_cast<int>(sizeof(T));
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  rle_decode<T, kTile><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(values), st, runs, n, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
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
// of `runs`, strictly increasing from 0; out: n values of the values' type,
// 16-byte aligned.
int nds_rle_decode(const void* values, const void* starts, int runs,
                   long long n, int val64, void* out, void* stream) {
  if (runs < 1 || n < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* st = static_cast<const int32_t*>(starts);
  if (val64) return launch_rle<int64_t>(values, st, runs, n, out, s);
  return launch_rle<int32_t>(values, st, runs, n, out, s);
}

}  // extern "C"
