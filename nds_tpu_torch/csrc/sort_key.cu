// The executor's multi-key sorts as packed 32-bit words, with each word's
// digit counts.
//
// Replaces the multi-operand lax.sort of nds_tpu/engine/device_exec.py in
// `_run_sort` (`:2611`), `_window_col` (`:2456`), `_count_distinct_grouped`
// (`:2396`), `_agg_global`'s count-distinct (`:2255`), the `<>` residual
// (`:2091`) and `_group_ids` (`:2220`) where its keys do not pack into one
// word (group_key.cu packs those that do). The executor decides on the host
// (device_exec.py `_sort_layout`, from bounds) how the order-preserving bits
// of the sort's operands, the most significant first, taken as one string,
// are cut into words of at most 32 bits; an operand may straddle two words
// (or three), and each word holds the piece of it that falls inside. This
// kernel writes one word for every row and counts the word's 8-bit digits;
// the radix sort of partitioned_join.cu (`partition_sort`, over one
// partition) orders the words from the least significant up, each stably
// with the row ids as its payload, which gives lax.sort's stable
// permutation exactly, and takes the counts in place of its own histogram
// pass.
//
// Per operand the kernel reads its value at row perm[i] (the permutation of
// the words sorted so far, so that the word lands in the order the next sort
// reads it; the first word reads row i), fills it with 0 where its validity
// or, where asked, the row mask is false, takes a bool as 1 - value where
// asked (a presence or NULLS LAST rank) and negates a descending key, in
// that order, as the reference builds its operands. Then by its mode it
// becomes the operand's order-preserving bits:
//
//   span:  value - lo, where [lo, lo + 2^w) holds every value the operand
//          can take on any slot (the host's bounds, w < 64);
//   int:   the full 32- or 64-bit value, its sign bit flipped;
//   float: lax.sort's comparator order: -0.0 as +0.0 and every NaN as one
//          NaN above +inf, then the IEEE bits made order-preserving
//          (a negative's bits inverted, a positive's sign bit set).
//
// The word takes bits [shift, shift + width) of them, and the pieces are
// laid out from the word's top bit down. A word is an int32; one of exactly
// 32 bits is biased by -2^31 (its top bit flipped), which the radix sort's
// signed order keeps. The digit counts are those partition_sort's plan
// reads for one partition of int32 keys: hist[d * 256 + digit] for digits
// d = 0..3 of the word's order-preserving unsigned bits (the word with its
// sign bit flipped).
//
// What bounds it on an H100: bytes. It reads each operand's values and masks
// once and writes the word once (the counts are 4 KB): each thread packs
// kItems rows at a time, their loads issued together, every piece in
// registers (a fixed loop over at most kMaxFields pieces, unrolled so that
// they are read from the kernel's parameters). After the first word the
// reads gather through perm, a 32-byte sector per row and operand where the
// permutation scatters neighbours. The counts cost no pass over the word:
// each warp adds its rows' digits into a histogram of its own in shared
// memory (a digit that one value holds over the warp's rows is one add, over
// one thread's kItems rows one add, else one add per row: no vote over the
// lanes' digits on the common path, and few adds where a digit's values
// repeat), and each block adds its non-zero bins to the counts once; a digit
// above the word's bits takes one value, which one thread adds for every
// row.
//
// The entry point launches on the given stream, allocates nothing (the
// counts are the caller's, zeroed) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kMaxFields = 16;
constexpr int kDigits = 256;
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xffffffffu;

// value types, modes and flags: kernels.py passes the same numbers
constexpr int kI32 = 0;
constexpr int kI64 = 1;
constexpr int kBool = 2;
constexpr int kF32 = 3;
constexpr int kF64 = 4;
constexpr int kSpan = 0;
constexpr int kInt = 1;
constexpr int kFloat = 2;
constexpr int kUseRow = 1;
constexpr int kInvert = 2;
constexpr int kNegate = 4;

constexpr unsigned long long kNaN64 = 0x7ff8000000000000ull;
constexpr unsigned kNaN32 = 0x7fc00000u;

struct Field {
  const void* arr;       // the operand's values
  const uint8_t* valid;  // bool: filled with 0 where false; or null
  long long lo;          // span: the low end of the values' range
  int type;              // kI32 .. kF64
  int mode;              // kSpan, kInt, kFloat
  int width;             // bits of the operand this word takes
  int shift;             // bits of the operand below them
  int flags;             // kUseRow | kInvert | kNegate
};

struct Word {
  int nf;
  int bits;
  unsigned flip;  // 2^31 for a 32-bit word, else 0
  Field f[kMaxFields];
};

// the operand's order-preserving bits at row r
__device__ __forceinline__ unsigned long long field_bits(const Field& f,
                                                         long long r,
                                                         bool present) {
  bool ok = (f.flags & kUseRow) ? present : true;
  if (f.valid != nullptr) ok = ok && f.valid[r] != 0;
  if (f.mode == kFloat) {
    if (f.type == kF64) {
      double x = ok ? static_cast<const double*>(f.arr)[r] : 0.0;
      if (f.flags & kNegate) x = -x;
      const unsigned long long b =
          x == 0.0 ? 0ull
                   : (isnan(x) ? kNaN64
                               : static_cast<unsigned long long>(
                                     __double_as_longlong(x)));
      return (b >> 63) ? ~b : (b | (1ull << 63));
    }
    float x = ok ? static_cast<const float*>(f.arr)[r] : 0.0f;
    if (f.flags & kNegate) x = -x;
    const unsigned b = x == 0.0f ? 0u : (isnan(x) ? kNaN32 : __float_as_uint(x));
    return (b >> 31) ? static_cast<unsigned>(~b) : (b | 0x80000000u);
  }
  long long v = 0;
  if (ok) {
    if (f.type == kI32)
      v = static_cast<const int32_t*>(f.arr)[r];
    else if (f.type == kI64)
      v = static_cast<const int64_t*>(f.arr)[r];
    else
      v = static_cast<const uint8_t*>(f.arr)[r] != 0;
  }
  if (f.flags & kInvert) v = 1 - v;
  // two's complement negation, which wraps at the type's minimum as the
  // reference's does (a full-width field keeps only its low bits)
  if (f.flags & kNegate)
    v = static_cast<long long>(0ull - static_cast<unsigned long long>(v));
  if (f.mode == kSpan) return static_cast<unsigned long long>(v - f.lo);
  if (f.type == kI32) return static_cast<uint32_t>(v) ^ 0x80000000u;
  return static_cast<unsigned long long>(v) ^ (1ull << 63);
}

// the piece of the operand this word takes
__device__ __forceinline__ unsigned piece(const Field& f, long long r,
                                          bool present) {
  const unsigned long long b = field_bits(f, r, present) >> f.shift;
  return static_cast<unsigned>(b) &
         (f.width == 32 ? kFull : ((1u << f.width) - 1u));
}

__global__ void __launch_bounds__(kThreads)
    pack_words(const uint8_t* __restrict__ row,
               const int32_t* __restrict__ perm, long long n, Word w,
               int32_t* __restrict__ out, unsigned* __restrict__ hist) {
  // one histogram per warp, so that only a warp's own lanes share bins
  __shared__ unsigned sh[kWarps][kPasses][kDigits];
  const int t = threadIdx.x;
  const int lane = t & 31;
  for (int i = t; i < kWarps * kPasses * kDigits; i += kThreads)
    (&sh[0][0][0])[i] = 0;
  // digits at and above nd take one value: that of 0 in the word's
  // order-preserving bits, the sign bit flipped (only a 32-bit word has
  // none such)
  const int nd = (w.bits + 7) / 8;
  if (blockIdx.x == 0 && t == 0)
    for (int d = nd; d < kPasses; ++d)
      atomicAdd(&hist[d * kDigits + ((0x80000000u >> (8 * d)) & 0xffu)],
                static_cast<unsigned>(n));
  __syncthreads();
  const unsigned to_u = w.flip ^ 0x80000000u;
  constexpr long long kTile = static_cast<long long>(kThreads) * kItems;
  for (long long base = blockIdx.x * kTile; base < n;
       base += static_cast<long long>(gridDim.x) * kTile) {
    long long r[kItems];
    bool present[kItems];
    unsigned key[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k * kThreads + t;
      r[k] = i < n ? (perm != nullptr ? perm[i] : i) : 0;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      present[k] = row != nullptr && base + k * kThreads + t < n &&
                   row[r[k]] != 0;
      key[k] = 0;
    }
    int pos = w.bits;
#pragma unroll
    for (int j = 0; j < kMaxFields; ++j) {
      if (j >= w.nf) break;
      pos -= w.f[j].width;
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        key[k] |= piece(w.f[j], r[k], present[k]) << pos;
    }
    int valid = 0;  // this thread's rows in the tile: a prefix of kItems
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k * kThreads + t;
      if (i < n) {
        out[i] = static_cast<int32_t>(key[k] ^ w.flip);
        ++valid;
      }
    }
    // the digit counts, into this warp's own histogram: a digit that one
    // value holds over the warp's rows is one add, over this thread's rows
    // one add per thread, else one per row
    unsigned (*wh)[kDigits] = sh[t >> 5];
    for (int d = 0; d < nd; ++d) {
      int dg[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        dg[k] = static_cast<int>(((key[k] ^ to_u) >> (8 * d)) & 0xffu);
      bool same = true;
#pragma unroll
      for (int k = 1; k < kItems; ++k)
        same = same && (k >= valid || dg[k] == dg[0]);
      const int d0 = __shfl_sync(kFull, dg[0], 0);
      if (__all_sync(kFull, valid == 0 || (same && dg[0] == d0))) {
        const unsigned rows = __reduce_add_sync(kFull, valid);
        if (lane == 0 && rows) atomicAdd(&wh[d][d0], rows);
      } else if (same) {
        if (valid) atomicAdd(&wh[d][dg[0]], static_cast<unsigned>(valid));
      } else {
#pragma unroll
        for (int k = 0; k < kItems; ++k)
          if (k < valid) atomicAdd(&wh[d][dg[k]], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = t; i < nd * kDigits; i += kThreads) {
    unsigned c = 0;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) c += (&sh[wp][0][0])[i];
    if (c) atomicAdd(&hist[i], c);
  }
}

}  // namespace

extern "C" {

int nds_sort_max_fields() { return kMaxFields; }

// row: bool[n] (or null where no field fills by it); perm: int32[n], a
// permutation of [0, n), or null; 1 <= n; nf pieces (1 <= nf <=
// nds_sort_max_fields()), the most significant first, each of one operand
// with its values arrs[j] (types[j]: 0 int32, 1 int64, 2 bool, 3 float32,
// 4 float64), its validity valids[j] (bool[n] or null), los[j], modes[j]
// (0 span, 1 int, 2 float), flags[j] (1 fill where the row mask is false,
// 2 invert a bool, 4 negate), and the piece: widths[j] bits (1 to 32) above
// shifts[j] bits of the operand's order-preserving bits; the widths add up
// to bits (1 <= bits <= 32). out: int32[n]. hist: int32[4 * 256] of zeros,
// the digit counts added. A span field's values minus its lo must lie in
// [0, 2^63): the caller's bounds promise it.
int nds_pack_sort_key(const void* row, const void* perm, long long n, int nf,
                      const void* const* arrs, const void* const* valids,
                      const long long* los, const int* types,
                      const int* modes, const int* widths, const int* shifts,
                      const int* flags, int bits, void* out, void* hist,
                      void* stream) {
  if (n < 1 || nf < 1 || nf > kMaxFields || bits < 1 || bits > 32 ||
      hist == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Word w{};
  w.nf = nf;
  w.bits = bits;
  w.flip = bits == 32 ? 0x80000000u : 0u;
  int used = 0;
  for (int j = 0; j < nf; ++j) {
    const int t = types[j], m = modes[j], wd = widths[j], sh = shifts[j],
              fl = flags[j];
    bool ok = arrs[j] != nullptr && t >= kI32 && t <= kF64 && wd >= 1 &&
              wd <= 32 && sh >= 0 &&
              (fl & ~(kUseRow | kInvert | kNegate)) == 0 &&
              (!(fl & kUseRow) || row != nullptr) &&
              (!(fl & kInvert) || t == kBool);
    const int top = sh + wd;  // the operand's bits the piece reaches
    if (m == kSpan)
      ok = ok && t <= kBool && top <= 63;
    else if (m == kInt)
      ok = ok && ((t == kI32 && top <= 32) || (t == kI64 && top <= 64));
    else if (m == kFloat)
      ok = ok && ((t == kF32 && top <= 32) || (t == kF64 && top <= 64));
    else
      ok = false;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    w.f[j] = Field{arrs[j], static_cast<const uint8_t*>(valids[j]), los[j], t,
                   m, wd, sh, fl};
    used += wd;
  }
  if (used != bits) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks to fill the card, few enough that their adds to the
  // counts stay few
  const long long tiles = (n + kThreads * kItems - 1) / (kThreads * kItems);
  const long long most = static_cast<long long>(sms) * 8;
  const unsigned grid = static_cast<unsigned>(tiles < most ? tiles : most);
  pack_words<<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(row), static_cast<const int32_t*>(perm), n,
      w, static_cast<int32_t*>(out), static_cast<unsigned*>(hist));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
