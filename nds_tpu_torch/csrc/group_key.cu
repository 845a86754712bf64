// The group-by's packed key (L2).
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
// order of int32, signed, keeps.
//
// What bounds it on an H100: bytes. It reads the row mask, each key's
// values and validity once and writes the key once: one thread per row,
// neighbouring threads on neighbouring rows, every field of a row in
// registers (a fixed loop over at most kMaxFields fields, unrolled so that
// the fields are read from the kernel's parameters, not from local memory).
// The torch version it replaces (the plain version, kernels.py) runs four to
// six elementwise passes per key over the whole column.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 16;
constexpr unsigned kMaxBlocks = 65535u * 32u;

struct Field {
  const void* arr;       // int32, int64 or bool values, or null (no bits)
  const uint8_t* valid;  // bool validity, or null
  long long lo;          // low end of the filled values' span (<= 0)
  int type;              // 0 int32, 1 int64, 2 bool
  int width;             // value bits (0: the value takes none)
};

struct Layout {
  int nf;
  int bits;  // presence included; the presence bit is bits - 1
  unsigned long long flip;  // 2^31 for a 32-bit key in int32, else 0
  Field f[kMaxFields];
};

template <typename K>
__global__ void __launch_bounds__(kThreads)
    pack_keys(const uint8_t* __restrict__ row, long long n, Layout a,
              K* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const bool present = row[i] != 0;
    unsigned long long key = present ? 0ull : 1ull << (a.bits - 1);
    int shift = a.bits - 1;
#pragma unroll
    for (int j = 0; j < kMaxFields; ++j) {
      if (j >= a.nf) break;
      const Field& f = a.f[j];
      bool ok = present;
      if (f.valid != nullptr) {
        const bool v = f.valid[i] != 0;
        ok = ok && v;
        shift -= 1;
        key |= v ? 0ull : 1ull << shift;
      }
      if (f.width > 0) {
        shift -= f.width;
        long long v = 0;
        if (ok) {
          if (f.type == 0)
            v = static_cast<const int32_t*>(f.arr)[i];
          else if (f.type == 1)
            v = static_cast<const int64_t*>(f.arr)[i];
          else
            v = static_cast<const uint8_t*>(f.arr)[i] != 0;
        }
        key |= static_cast<unsigned long long>(v - f.lo) << shift;
      }
    }
    out[i] = static_cast<K>(key ^ a.flip);
  }
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
// biased by -2^31.
int nds_pack_group_key(const void* row, long long n, int nf,
                       const void* const* arrs, const void* const* valids,
                       const long long* los, const int* types,
                       const int* widths, int bits, int key64, void* out,
                       void* stream) {
  if (n < 1 || nf < 0 || nf > kMaxFields || bits < 1 ||
      bits > (key64 ? 63 : 32))
    return static_cast<int>(cudaErrorInvalidValue);
  Layout a{};
  a.nf = nf;
  a.bits = bits;
  a.flip = !key64 && bits == 32 ? 1ull << 31 : 0ull;
  int used = 1;
  for (int j = 0; j < nf; ++j) {
    if (types[j] < 0 || types[j] > 2 || widths[j] < 0 ||
        (widths[j] > 0 && arrs[j] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    a.f[j] = Field{arrs[j], static_cast<const uint8_t*>(valids[j]), los[j],
                   types[j], widths[j]};
    used += widths[j] + (valids[j] != nullptr ? 1 : 0);
  }
  if (used != bits) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(
      blocks < kMaxBlocks ? blocks : kMaxBlocks);
  const uint8_t* r = static_cast<const uint8_t*>(row);
  if (key64)
    pack_keys<int64_t><<<grid, kThreads, 0, s>>>(r, n, a,
                                                 static_cast<int64_t*>(out));
  else
    pack_keys<int32_t><<<grid, kThreads, 0, s>>>(r, n, a,
                                                 static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
