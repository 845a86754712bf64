// The executor's multi-key sorts as packed words.
//
// Replaces the multi-operand lax.sort of nds_tpu/engine/device_exec.py in
// `_run_sort` (`:2611`), `_window_col` (`:2456`), `_count_distinct_grouped`
// (`:2396`), `_agg_global`'s count-distinct (`:2255`), the `<>` residual
// (`:2091`) and `_group_ids` (`:2220`) where its keys do not pack into one
// word (group_key.cu packs those that do). The executor decides on the host
// (device_exec.py `_sort_layout`, from bounds) how the sort's operands, the
// most significant first, split into words of at most 64 bits, no operand
// straddling two. This kernel writes one word for every row; the radix sort
// of partitioned_join.cu (`partition_sort`, over one partition) orders the
// words from the least significant up, each stably with the row ids as its
// payload, which gives lax.sort's stable permutation exactly.
//
// Per operand the kernel reads its value at row perm[i] (the permutation of
// the words sorted so far, so that the word lands in the order the next sort
// reads it; the first word reads row i), fills it with 0 where its validity
// or, where asked, the row mask is false, takes a bool as 1 - value where
// asked (a presence or NULLS LAST rank) and negates a descending key, in
// that order, as the reference builds its operands. Then by its mode:
//
//   span:  value - lo in `width` bits, where [lo, lo + 2^width) holds every
//          value the operand can take on any slot (the host's bounds);
//   int:   the full 32- or 64-bit value, its sign bit flipped;
//   float: lax.sort's comparator order: -0.0 as +0.0 and every NaN as one
//          NaN above +inf, then the IEEE bits made order-preserving
//          (a negative's bits inverted, a positive's sign bit set).
//
// The fields are laid out from the word's top bit down. A word of up to 32
// bits is an int32, of more an int64; one of exactly 32 or 64 bits is
// biased by -2^31 or -2^63 (its top bit flipped), which the radix sort's
// signed order keeps.
//
// What bounds it on an H100: bytes. It reads each operand's values and masks
// once and writes the word once: one thread per row, every field in
// registers (a fixed loop over at most kMaxFields fields, unrolled so that
// the fields are read from the kernel's parameters). After the first word
// the reads gather through perm, a 32-byte sector per row and operand where
// the permutation scatters neighbours.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 16;
constexpr unsigned kMaxBlocks = 65535u * 32u;

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
  int width;             // bits the field takes
  int flags;             // kUseRow | kInvert | kNegate
};

struct Word {
  int nf;
  int bits;
  unsigned long long flip;  // 2^31 for a 32-bit word, 2^63 for 64, else 0
  Field f[kMaxFields];
};

// the field's bits, below 2^width, for the operand at row r
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
  if (f.width == 32) return static_cast<uint32_t>(v) ^ 0x80000000u;
  return static_cast<unsigned long long>(v) ^ (1ull << 63);
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    pack_words(const uint8_t* __restrict__ row,
               const int32_t* __restrict__ perm, long long n, Word w,
               K* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = perm != nullptr ? perm[i] : i;
    const bool present = row != nullptr && row[r] != 0;
    unsigned long long key = 0;
    int shift = w.bits;
#pragma unroll
    for (int j = 0; j < kMaxFields; ++j) {
      if (j >= w.nf) break;
      shift -= w.f[j].width;
      key |= field_bits(w.f[j], r, present) << shift;
    }
    out[i] = static_cast<K>(key ^ w.flip);
  }
}

}  // namespace

extern "C" {

int nds_sort_max_fields() { return kMaxFields; }

// row: bool[n] (or null where no field fills by it); perm: int32[n], a
// permutation of [0, n), or null; 1 <= n; nf fields (1 <= nf <=
// nds_sort_max_fields()), the most significant first, each with its values
// arrs[j] (types[j]: 0 int32, 1 int64, 2 bool, 3 float32, 4 float64), its
// validity valids[j] (bool[n] or null), los[j], modes[j] (0 span, 1 int,
// 2 float), widths[j] and flags[j] (1 fill where the row mask is false, 2
// invert a bool, 4 negate); the widths add up to bits (1 <= bits <= 64).
// out: int32[n] for bits <= 32, else int64[n]. A span field's values minus
// its lo must lie in [0, 2^width): the caller's bounds promise it.
int nds_pack_sort_key(const void* row, const void* perm, long long n, int nf,
                      const void* const* arrs, const void* const* valids,
                      const long long* los, const int* types,
                      const int* modes, const int* widths, const int* flags,
                      int bits, void* out, void* stream) {
  if (n < 1 || nf < 1 || nf > kMaxFields || bits < 1 || bits > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  Word w{};
  w.nf = nf;
  w.bits = bits;
  w.flip = bits == 32 ? 1ull << 31 : (bits == 64 ? 1ull << 63 : 0ull);
  int used = 0;
  for (int j = 0; j < nf; ++j) {
    const int t = types[j], m = modes[j], wd = widths[j], fl = flags[j];
    bool ok = arrs[j] != nullptr && t >= kI32 && t <= kF64 && wd >= 1 &&
              (fl & ~(kUseRow | kInvert | kNegate)) == 0 &&
              (!(fl & kUseRow) || row != nullptr) &&
              (!(fl & kInvert) || t == kBool);
    if (m == kSpan)
      ok = ok && t <= kBool && wd <= 63;
    else if (m == kInt)
      ok = ok && ((t == kI32 && wd == 32) || (t == kI64 && wd == 64));
    else if (m == kFloat)
      ok = ok && ((t == kF32 && wd == 32) || (t == kF64 && wd == 64));
    else
      ok = false;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    w.f[j] = Field{arrs[j], static_cast<const uint8_t*>(valids[j]), los[j], t,
                   m, wd, fl};
    used += wd;
  }
  if (used != bits) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(
      blocks < kMaxBlocks ? blocks : kMaxBlocks);
  const uint8_t* r = static_cast<const uint8_t*>(row);
  const int32_t* p = static_cast<const int32_t*>(perm);
  if (bits > 32)
    pack_words<int64_t><<<grid, kThreads, 0, s>>>(
        r, p, n, w, static_cast<int64_t*>(out));
  else
    pack_words<int32_t><<<grid, kThreads, 0, s>>>(
        r, p, n, w, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
