// Decode of the compressed columnar store: bitpack and the mask unpack (K8),
// and RLE (K9).
//
// Replaces nds_tpu/columnar/device.py: `_unpack_words` with the bitpack
// branch of `decode` and `unpack_mask` (K8), and the RLE branch of `decode`
// (K9).
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
// 2^32 where an int64 sum narrows, as XLA's convert does. One thread per
// output row: a warp's 32 rows read one to a few words (the same cache line)
// and write 32 neighbouring outputs, so every store is coalesced.
//
// The mask unpack (bits = 1, a bool a row) is a kernel of its own. Run as
// the decode above, a thread stored one byte, so a warp's store instruction
// moved 32 bytes and the card issued 16 times the store instructions that
// 16-byte vectors need for the same bytes (0.8 TB/s where the 4- and 8-byte
// outputs reach 2.1-2.2). Here a thread writes 16 rows at a time, half a
// word's bits turned into 16 bytes of 0 or 1 in registers (a multiply and a
// mask a nibble: (x * 0x00204081) & 0x01010101 puts bit k of x at bit 8k),
// with one streaming store; lane l's vector is half l & 1 of word l / 2 of
// the warp's 16, so one warp store covers 512 contiguous bytes (a lane's own
// run of 32 bytes would make each store touch half sectors). A warp takes 64
// words (2,048 rows) in four such stores, a block of 8 warps 512 words (16 KB
// of output), sized to the rows with 32-bit offsets inside its tile. Where
// the words are 16-byte aligned, 16 lanes read the warp's 64 words with one
// 16-byte load each and pass them on by shuffles; words sliced at another
// 4-byte offset are read one a lane. The rows after the last whole vector
// (fewer than 16) are written one a thread by the last block; nothing is
// written at or past n.
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
// What bounds all three on an H100: bytes. K8 at 6,001,215 rows writes 24 MB
// (int32) or 48 MB (int64) from 0.75-24 MB of words: 8-22 us at 3.35 TB/s;
// the mask unpack at its largest columnar call (367,032 words into 11,745,000
// rows) reads 1.5 MB and writes 11.7 MB, 4 us.
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

// The mask unpack. 16 bits (the low half of `h`) as 16 bytes of 0 or 1, row
// 0 in the lowest byte: bit k of a nibble x lands at bit 8k of
// x * 0x00204081 (x, x << 7, x << 14 and x << 21 do not overlap).
__device__ __forceinline__ int4 bits_to_bytes(uint32_t h) {
  constexpr uint32_t kSpread = 0x00204081u, kOnes = 0x01010101u;
  return make_int4(static_cast<int>(((h & 0xFu) * kSpread) & kOnes),
                   static_cast<int>((((h >> 4) & 0xFu) * kSpread) & kOnes),
                   static_cast<int>((((h >> 8) & 0xFu) * kSpread) & kOnes),
                   static_cast<int>((((h >> 12) & 0xFu) * kSpread) & kOnes));
}

constexpr int kMaskWarpWords = 64;                            // 4 stores
constexpr int kMaskTileWords = kMaskWarpWords * kThreads / 32;  // 512

// One block a tile of kMaskTileWords words (32 rows each); warp w takes the
// tile's words [64w, 64w + 64) in four stores of 16 words (512 rows, 512
// bytes), lane l the half l & 1 of word l / 2 of each. kVecLoad: `words` is
// 16-byte aligned, and lanes 0-15 load the warp's 64 words as 16-byte
// vectors that the stores take by shuffles; else each lane loads its word.
// `out` is 16-byte aligned (the caller checks). The last block writes the
// rows after the last whole 16-row vector, one a thread.
template <bool kVecLoad>
__global__ void __launch_bounds__(kThreads)
    unpack_mask(const int32_t* __restrict__ words, long long n,
                uint8_t* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w_base = blockIdx.x * static_cast<long long>(kMaskTileWords);
  // the tile's words that hold rows < n, and its whole 16-row vectors
  const long long words_left = ((n + 31) >> 5) - w_base;
  const long long vecs_left = (n >> 4) - 2 * w_base;
  const int nwords = words_left < kMaskTileWords
                         ? static_cast<int>(words_left) : kMaskTileWords;
  const int nvecs = vecs_left < 2 * kMaskTileWords
                        ? static_cast<int>(vecs_left) : 2 * kMaskTileWords;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words) + w_base;
  int4* o = reinterpret_cast<int4*>(out + w_base * 32);
  const int w0 = warp * kMaskWarpWords;
  uint4 q = make_uint4(0, 0, 0, 0);
  if (kVecLoad && lane < kMaskWarpWords / 4) {
    const int at = w0 + 4 * lane;
    if (at + 4 <= nwords) {
      q = __ldg(reinterpret_cast<const uint4*>(w + at));
    } else {
      if (at < nwords) q.x = __ldg(w + at);
      if (at + 1 < nwords) q.y = __ldg(w + at + 1);
      if (at + 2 < nwords) q.z = __ldg(w + at + 2);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaskWarpWords / 16; ++j) {
    const int wi = w0 + 16 * j + (lane >> 1);  // the lane's word in the tile
    uint32_t word;
    if (kVecLoad) {
      // word wi is component (lane >> 1) & 3 of lane 4j + (lane >> 3)'s q
      const int src = 4 * j + (lane >> 3);
      const uint32_t x = __shfl_sync(0xffffffffu, q.x, src);
      const uint32_t y = __shfl_sync(0xffffffffu, q.y, src);
      const uint32_t z = __shfl_sync(0xffffffffu, q.z, src);
      const uint32_t u = __shfl_sync(0xffffffffu, q.w, src);
      const int c = (lane >> 1) & 3;
      word = c == 0 ? x : c == 1 ? y : c == 2 ? z : u;
    } else {
      word = wi < nwords ? __ldg(w + wi) : 0u;
    }
    const int v = 2 * wi + (lane & 1);  // the lane's vector in the tile
    if (v < nvecs) __stcs(o + v, bits_to_bytes(word >> ((lane & 1) * 16)));
  }
  if (blockIdx.x == gridDim.x - 1) {
    const long long r = (n & ~15LL) + threadIdx.x;
    if (r < n)
      out[r] = static_cast<uint8_t>(
          (static_cast<uint32_t>(__ldg(words + (r >> 5))) >> (r & 31)) & 1u);
  }
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

// K8. words: int32; out: int32 or int64 of n rows, out_kind 0 or 1.
// log2bits in [0, 5]; wide = 1 adds the bias in int64.
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The mask unpack. words: int32, at least (n + 31) / 32 of them, at any
// 4-byte offset; out: n bools (uint8, 0 or 1), 16-byte aligned.
int nds_unpack_mask(const void* words, long long n, void* out, void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks =
      ((n + 31) / 32 + kMaskTileWords - 1) / kMaskTileWords;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* w = static_cast<const int32_t*>(words);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (reinterpret_cast<uintptr_t>(words) % 16 == 0)
    unpack_mask<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        w, n, o);
  else
    unpack_mask<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        w, n, o);
  return static_cast<int>(cudaGetLastError());
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
