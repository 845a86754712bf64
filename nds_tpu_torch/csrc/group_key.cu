// The group-by's packed key (L2), and the counts of its 8-bit digits.
//
// Replaces the prelude of nds_tpu/engine/device_exec.py `_group_ids`
// (`:2207-2218`): the operands of its multi-operand lax.sort, presence
// (0 where the row is present), then per key its validity (0 where valid)
// and its value filled with 0 where the row is not present or the key is
// NULL. Where the keys' bounds allow (a host decision, device_exec.py
// `_pack_layout`), those operands pack into one non-negative integer in the
// same order of significance, so that partitioned_join.cu's radix sort of
// that one key, stable, gives lax.sort's permutation exactly:
//
//   key = absent << (bits - 1)
//       | for each key, from the most significant: NULL << s_v,
//         (filled value - lo) << s_k
//
// where lo is the low end of the key's filled values (at most 0, since the
// fill is 0) and each field takes the bits its span needs. A bool packs as
// 0/1, a dictionary code as itself. A key of up to 32 bits is stored as
// int32, so the sort moves 4 bytes a key and makes 4 passes: one of exactly
// 32 bits is biased by -2^31 (its top bit flipped), which the radix sort's
// order of int32, signed, keeps. Beside the key the kernel writes the
// counts that partition_sort's plan reads for one partition, hist[d * 256 +
// digit] for each 8-bit digit d of the key's order-preserving unsigned bits
// (its sign bit flipped; 4 digits for an int32 key, 8 for an int64 one), so
// the sort launches no histogram pass of its own. A 32-bit key's bias is
// the flip of its sign bit, so its order-preserving bits are the packed
// bits themselves; every other key is non-negative, and its bits are the
// packed bits with the sign bit set.
//
// What bounds it on an H100: bytes. It must read the row mask and each
// validity once, a key's value only where the row is present and the key
// valid (elsewhere the fill hides it), and write the key once (the counts
// are 4 or 8 KB). A plan's static capacity pads the rows: at L2's largest
// NDS call 2,099 of 187,920,000 rows are present, so the row mask and the
// key are nearly all of the bytes. One row a thread, loading one byte at a
// time, let load instructions, not bytes, set the pace (31% of the card's
// 3.35 TB/s there on an H100). So a warp takes 512 rows at a
// time, 16 a lane, in groups of the keys one 16-byte store holds (4 int32
// or 2 int64 keys), the 32 lanes' groups side by side, so that each load
// and store of a group by the warp covers contiguous bytes: the row mask
// and each validity come in with one 4-byte (2-byte) load a group, a
// field's values only where a row is present and valid (a group whose rows
// all are in one load, else one predicated load a row; a field whose 16
// rows of a lane are all filled is one constant, with no load and one
// branch), and the keys go out with one 16-byte store a group. (A lane
// owning 16 consecutive rows, 64 bytes of keys, made every store of the
// warp touch 32 half sectors: 0.52 ms against 0.37 at that call on an
// H100.) Where
// the row mask is not 16-byte aligned, a head chunk ends at its first
// 16-byte boundary; it and the tail past the last whole chunk, and any
// array that is not 16-byte aligned there (a contiguous slice may start
// anywhere), take one load or store a row. The grid is persistent (as many
// blocks as fit on the card), each warp walking its chunks by a grid
// stride, every field of a row in registers (a fixed loop over at most
// kMaxFields fields, unrolled so that the fields are read from the
// kernel's parameters, not from local memory). The counts cost no pass
// over the key, as in sort_key.cu: each warp adds its rows' digits into a
// histogram of its own in shared memory, and each block adds its non-zero
// bins to the counts once; a digit above the key's bits takes one value,
// which one thread adds for every row. A chunk whose live rows all hold one
// key (the padding: absent rows, their fields filled) is one add a digit
// for the warp; else a digit that one value holds over the warp's rows is
// one add, over a lane's 16 rows one add, else one add a row.
//
// The entry point launches on the given stream, allocates nothing (the
// counts are the caller's, zeroed) and returns cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;  // rows a lane takes at a time
constexpr int kChunk = 32 * kRows;  // rows a warp takes at a time
constexpr int kMaxFields = 16;
constexpr int kDigits = 256;
constexpr unsigned kFull = 0xffffffffu;

// per key type: the key's unsigned bits, the threads of a block (8 digit
// passes of int64 keys take twice the histogram of int32's 4, so half the
// warps keep a block at 32 KB of shared memory), the digit passes, and the
// rows of a group (the keys one 16-byte store holds)
template <typename K>
struct Shape;
template <>
struct Shape<int32_t> {
  using U = uint32_t;
  static constexpr int kThreads = 256;
  static constexpr int kPasses = 4;
  static constexpr int kGroup = 4;
};
template <>
struct Shape<int64_t> {
  using U = unsigned long long;
  static constexpr int kThreads = 128;
  static constexpr int kPasses = 8;
  static constexpr int kGroup = 2;
};

struct Field {
  const void* arr;       // int32, int64 or bool values, or null (no bits)
  const uint8_t* valid;  // bool validity, or null
  long long lo;          // low end of the filled values' span (<= 0)
  int type;              // 0 int32, 1 int64, 2 bool
  int width;             // value bits (0: the value takes none)
  bool arr_vec;          // values 16-byte aligned at row `head`
  bool valid_vec;        // validity 16-byte aligned at row `head`
};

struct Layout {
  int nf;
  int bits;  // presence included; the presence bit is bits - 1
  unsigned long long flip;   // 2^31 for a 32-bit key in int32, else 0
  unsigned long long order;  // packed key ^ order: order-preserving bits
  long long head;            // rows before the row mask's 16-byte boundary
  bool out_vec;              // the keys 16-byte aligned at row `head`
  Field f[kMaxFields];
};

// a lane's k-th row within its warp's chunk: groups of VW rows, group j of
// the 32 lanes side by side, so that one load or store of a group by the
// warp covers contiguous bytes
template <int VW>
__device__ __forceinline__ int row_of(int lane, int k) {
  return (k / VW) * 32 * VW + lane * VW + k % VW;
}

// VW values of type T at p, with one load (p aligned to its size)
template <typename T, int VW>
__device__ __forceinline__ void load_group(const T* p, T (&x)[VW]) {
  constexpr int kBytes = VW * sizeof(T);
  if constexpr (kBytes >= 16) {
    uint4 w[kBytes / 16];
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      w[i] = reinterpret_cast<const uint4*>(p)[i];
    memcpy(x, w, kBytes);
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    memcpy(x, &w, kBytes);
  } else if constexpr (kBytes == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    memcpy(x, &w, kBytes);
  } else {
    const uint16_t w = *reinterpret_cast<const uint16_t*>(p);
    memcpy(x, &w, kBytes);
  }
}

// a lane's 16 bools of a chunk at p as a 16-bit mask (bit k: its k-th row
// holds a non-zero byte): one load a group where `vec`, else one load a
// live row
template <int VW>
__device__ __forceinline__ unsigned mask_rows(const uint8_t* p, int lane,
                                              unsigned live, bool vec) {
  unsigned m = 0;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kRows / VW; ++j) {
      uint8_t b[VW];
      load_group<uint8_t, VW>(p + j * 32 * VW + lane * VW, b);
      uint32_t x = 0;
      memcpy(&x, b, VW);
      // the top bit of each non-zero byte, then the four gathered into
      // bits 21-24 by one multiply (the partial products never overlap)
      const uint32_t nz = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) &
                          0x80808080u;
      m |= (((nz >> 7) * 0x00204081u) >> 21 & ((1u << VW) - 1)) << (j * VW);
    }
    return m;
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    if ((live >> k) & 1u && p[row_of<VW>(lane, k)] != 0) m |= 1u << k;
  return m;
}

// a lane's 16 values of a chunk at p, widened: one load a group whose rows
// are all in `ok` where `vec`, else one load a row of `ok` (the others 0)
template <typename T, int VW>
__device__ __forceinline__ void values_rows(const T* p, int lane,
                                            unsigned ok, bool vec,
                                            long long (&v)[kRows]) {
  constexpr unsigned kAll = (1u << VW) - 1;
#pragma unroll
  for (int j = 0; j < kRows / VW; ++j) {
    const T* q = p + j * 32 * VW + lane * VW;
    const unsigned okj = (ok >> (j * VW)) & kAll;
    if (vec && okj == kAll) {
      T x[VW];
      load_group<T, VW>(q, x);
#pragma unroll
      for (int i = 0; i < VW; ++i) v[j * VW + i] = static_cast<long long>(x[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VW; ++i)
        v[j * VW + i] = (okj >> i) & 1u ? static_cast<long long>(q[i]) : 0;
    }
  }
}

template <typename K>
__global__ void __launch_bounds__(Shape<K>::kThreads)
    pack_keys(const uint8_t* __restrict__ row, long long n, Layout a,
              K* __restrict__ out, unsigned* __restrict__ hist) {
  using U = typename Shape<K>::U;
  constexpr int kThreads = Shape<K>::kThreads;
  constexpr int kPasses = Shape<K>::kPasses;
  constexpr int VW = Shape<K>::kGroup;
  constexpr int kWarps = kThreads / 32;
  // one histogram per warp, so that only a warp's own lanes share bins
  __shared__ unsigned sh[kWarps][kPasses][kDigits];
  const int t = threadIdx.x;
  const int lane = t & 31;
  for (int i = t; i < kWarps * kPasses * kDigits; i += kThreads)
    (&sh[0][0][0])[i] = 0;
  // digits at and above nd take one value, that of the order bits
  const int nd = (a.bits + 7) / 8;
  if (blockIdx.x == 0 && t == 0)
    for (int d = nd; d < kPasses; ++d)
      atomicAdd(&hist[d * kDigits + ((a.order >> (8 * d)) & 0xffu)],
                static_cast<unsigned>(n));
  __syncthreads();
  unsigned (*wh)[kDigits] = sh[t >> 5];
  // chunks of kChunk rows from the row mask's 16-byte boundary `head` on;
  // chunk -1, where head > 0, ends there (its rows below 0 are not live)
  const long long c_lo = a.head > 0 ? -1 : 0;
  const long long c_end = (n - a.head + kChunk - 1) / kChunk;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long c = c_lo + blockIdx.x * static_cast<long long>(kWarps) +
                     (t >> 5);
       c < c_end; c += warps) {
    const long long base = a.head + c * kChunk;
    const bool whole = base >= 0 && base + kChunk <= n;
    unsigned live = 0xffffu;
    if (!whole) {
      live = 0;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const long long r = base + row_of<VW>(lane, k);
        live |= r >= 0 && r < n ? 1u << k : 0u;
      }
    }
    const unsigned pres = mask_rows<VW>(row + base, lane, live, whole);
    U key[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      key[k] = (pres >> k) & 1u ? U{0}
                                : static_cast<U>(1ull << (a.bits - 1));
    int shift = a.bits - 1;
#pragma unroll
    for (int j = 0; j < kMaxFields; ++j) {
      if (j >= a.nf) break;
      const Field& f = a.f[j];
      unsigned ok = pres;
      if (f.valid != nullptr) {
        const unsigned vm =
            mask_rows<VW>(f.valid + base, lane, live, whole && f.valid_vec);
        ok &= vm;
        shift -= 1;
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          key[k] |= (vm >> k) & 1u ? U{0} : static_cast<U>(U{1} << shift);
      }
      if (f.width == 0) continue;
      shift -= f.width;
      if (ok == 0) {
        // every row filled: one value
        const U fill = static_cast<U>(
            static_cast<unsigned long long>(-f.lo) << shift);
#pragma unroll
        for (int k = 0; k < kRows; ++k) key[k] |= fill;
        continue;
      }
      const bool vec = whole && f.arr_vec;
      long long v[kRows];
      if (f.type == 0) {
        values_rows<int32_t, VW>(static_cast<const int32_t*>(f.arr) + base,
                                 lane, ok, vec, v);
      } else if (f.type == 1) {
        values_rows<int64_t, VW>(static_cast<const int64_t*>(f.arr) + base,
                                 lane, ok, vec, v);
      } else {
        values_rows<uint8_t, VW>(static_cast<const uint8_t*>(f.arr) + base,
                                 lane, ok, vec, v);
#pragma unroll
        for (int k = 0; k < kRows; ++k) v[k] = v[k] != 0;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        key[k] |= static_cast<U>(static_cast<unsigned long long>(
                                     ((ok >> k) & 1u ? v[k] : 0) - f.lo)
                                 << shift);
    }
    // the keys, biased where they take 32 bits: one 16-byte store a group
    K w[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) w[k] = static_cast<K>(key[k] ^ a.flip);
    if (whole && a.out_vec) {
#pragma unroll
      for (int j = 0; j < kRows / VW; ++j) {
        uint4 q;
        memcpy(&q, w + j * VW, sizeof(q));
        *reinterpret_cast<uint4*>(out + base + j * 32 * VW + lane * VW) = q;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if ((live >> k) & 1u) out[base + row_of<VW>(lane, k)] = w[k];
    }
    // the digit counts, into this warp's own histogram: a key that one
    // value holds over the warp's live rows is one add a digit; else a
    // digit that one value holds over the warp's rows is one add, over this
    // lane's rows one add, else one add a row
    const unsigned rows = static_cast<unsigned>(__popc(live));
    U ref = 0;  // this lane's first live key
#pragma unroll
    for (int k = kRows - 1; k >= 0; --k)
      if ((live >> k) & 1u) ref = key[k];
    bool one = true;
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      one = one && (!((live >> k) & 1u) || key[k] == ref);
    // the first lane with a live row leads (lane 0 but in a cut chunk)
    const int lead = __ffs(__ballot_sync(kFull, live != 0)) - 1;
    const U r0 = __shfl_sync(kFull, ref, lead);
    if (__all_sync(kFull, live == 0 || (one && ref == r0))) {
      const unsigned all = __reduce_add_sync(kFull, rows);
      if (lane == lead)
        for (int d = 0; d < nd; ++d)
          atomicAdd(&wh[d][((r0 ^ static_cast<U>(a.order)) >> (8 * d)) &
                           0xffu],
                    all);
      continue;
    }
    for (int d = 0; d < nd; ++d) {
      int dg[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        dg[k] = static_cast<int>(((key[k] ^ static_cast<U>(a.order)) >>
                                  (8 * d)) & 0xffu);
      const int dref = static_cast<int>(
          ((ref ^ static_cast<U>(a.order)) >> (8 * d)) & 0xffu);
      bool same = true;
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        same = same && (!((live >> k) & 1u) || dg[k] == dref);
      const int d0 = __shfl_sync(kFull, dref, lead);
      if (__all_sync(kFull, live == 0 || (same && dref == d0))) {
        const unsigned all = __reduce_add_sync(kFull, rows);
        if (lane == lead) atomicAdd(&wh[d][d0], all);
      } else if (same) {
        if (rows) atomicAdd(&wh[d][dref], rows);
      } else {
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          if ((live >> k) & 1u) atomicAdd(&wh[d][dg[k]], 1u);
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

bool aligned_at(const void* p, long long row, int size) {
  return (reinterpret_cast<uintptr_t>(p) + static_cast<uintptr_t>(row) * size)
             % 16 == 0;
}

template <typename K>
int launch(const uint8_t* row, long long n, const Layout& a, void* out,
           void* hist, cudaStream_t s) {
  constexpr int kThreads = Shape<K>::kThreads;
  // the card's blocks at once, asked once (a later call may be captured
  // in a graph)
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_keys<K>,
                                                  kThreads, 0);
  }
  // as many blocks as the card holds at once, no more than the rows need
  const long long chunks =
      (a.head > 0 ? 1 : 0) + (n - a.head + kChunk - 1) / kChunk;
  const long long need = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  const long long most =
      static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < most ? need : most);
  pack_keys<K><<<grid, kThreads, 0, s>>>(row, n, a, static_cast<K*>(out),
                                         static_cast<unsigned*>(hist));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int nds_pack_max_fields() { return kMaxFields; }

// row: bool[n], 1 <= n; nf fields (nf <= nds_pack_max_fields()), the most
// significant first, each with its values arrs[j] (types[j]: 0 int32, 1
// int64, 2 bool; null where widths[j] is 0), its validity valids[j] (bool[n]
// or null: no validity bit), los[j] and widths[j]; bits <= 32 with key64 = 0
// (out int32[n]) or <= 63 (out int64[n]), and the fields' bits plus the
// presence bit equal to bits. A 32-bit key (key64 = 0, bits = 32) is written
// biased by -2^31. hist: int32[4 * 256] (int32 keys) or [8 * 256] (int64) of
// zeros, the counts of the key's order-preserving digits added.
int nds_pack_group_key(const void* row, long long n, int nf,
                       const void* const* arrs, const void* const* valids,
                       const long long* los, const int* types,
                       const int* widths, int bits, int key64, void* out,
                       void* hist, void* stream) {
  if (n < 1 || nf < 0 || nf > kMaxFields || bits < 1 ||
      bits > (key64 ? 63 : 32) || hist == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout a{};
  a.nf = nf;
  a.bits = bits;
  a.flip = !key64 && bits == 32 ? 1ull << 31 : 0ull;
  a.order = a.flip ^ (key64 ? 1ull << 63 : 1ull << 31);
  const long long head = static_cast<long long>(
      (16 - reinterpret_cast<uintptr_t>(row) % 16) % 16);
  a.head = head < n ? head : n;
  const int ks = key64 ? 8 : 4;
  a.out_vec = aligned_at(out, a.head, ks);
  int used = 1;
  for (int j = 0; j < nf; ++j) {
    if (types[j] < 0 || types[j] > 2 || widths[j] < 0 ||
        (widths[j] > 0 && arrs[j] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const int size = types[j] == 0 ? 4 : (types[j] == 1 ? 8 : 1);
    a.f[j] = Field{arrs[j], static_cast<const uint8_t*>(valids[j]), los[j],
                   types[j], widths[j],
                   arrs[j] != nullptr && aligned_at(arrs[j], a.head, size),
                   valids[j] != nullptr && aligned_at(valids[j], a.head, 1)};
    used += widths[j] + (valids[j] != nullptr ? 1 : 0);
  }
  if (used != bits) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(row);
  return key64 ? launch<int64_t>(r, n, a, out, hist, s)
               : launch<int32_t>(r, n, a, out, hist, s);
}

}  // extern "C"
