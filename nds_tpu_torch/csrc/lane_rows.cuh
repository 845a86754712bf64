// Sixteen rows a lane: the streamed I/O of the gather joins (K1's, K3's and
// K4's builds and probes in dense_domain.cu, K2's probe in
// small_build_probe.cu), and the size of their grids of resident blocks.
//
// A warp takes a chunk of 512 rows. Its keys are read as 16-byte vectors,
// lane l taking vectors l, l + 32, l + 64, ... of the chunk, so that every
// warp load reads 512 contiguous bytes. A vector holds R = 16 / sizeof(key)
// rows (4 int32 or 2 int64 keys), and a lane's 16 rows are G = 16 / R groups
// of R rows each. The row flags and the outputs of a group (R bytes, R
// int32) are read and written whole, one load or store a group, side by side
// with the other lanes' groups (a warp store of a lane's 64 contiguous bytes
// would touch 32 half sectors at once). The keys set the alignment: the rows
// before their first 16-byte boundary and the rows after the last whole
// chunk are taken one a thread (`rest_row`), and an array whose pointer does
// not share the keys' alignment at the chunk's start is read or written one
// element at a time (the executor hands in contiguous views that keep a
// storage offset). Streamed arrays are read and written with the streaming
// cache hints (ld.global.cs / st.global.cs), so that they do not evict the
// joins' tables from L2.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lane_rows {

constexpr int kRows = 16;           // rows a lane takes
constexpr int kChunk = 32 * kRows;  // rows a warp takes at once

template <typename K>
struct Groups {
  static constexpr int R = 16 / static_cast<int>(sizeof(K));  // rows a vector
  static constexpr int G = kRows / R;                          // groups a lane
};

// Rows before the keys' first 16-byte boundary (at most n).
template <typename K>
inline long long head_rows(const void* keys, long long n) {
  const unsigned mis =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(keys) & 15u);
  const long long h = mis ? (16 - mis) / static_cast<long long>(sizeof(K)) : 0;
  return h < n ? h : n;
}

// Whether element `row` of an array of `esize`-byte elements at `p` lies on
// a `bytes` boundary.
inline bool aligned_at(const void* p, long long row, int esize, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) + static_cast<uintptr_t>(row * esize))
             % static_cast<uintptr_t>(bytes) == 0;
}

// The layout of one launch over n rows: `head` rows, then `chunks` whole
// chunks, then the tail; which arrays take whole-group loads and stores.
struct Plan {
  long long n;
  long long head;
  long long chunks;
  int vflags;   // the flags, R bytes a group
  int vridx;    // the int32 output, R a group
  int vhit;     // the byte output, R a group
};

template <typename K>
inline Plan plan_rows(const void* keys, long long n, const void* flags,
                      const void* ridx, const void* hit) {
  constexpr int R = Groups<K>::R;
  Plan p;
  p.n = n;
  p.head = head_rows<K>(keys, n);
  p.chunks = (n - p.head) / kChunk;
  p.vflags = flags != nullptr && aligned_at(flags, p.head, 1, R);
  p.vridx = ridx != nullptr && aligned_at(ridx, p.head, 4, 4 * R);
  p.vhit = hit != nullptr && aligned_at(hit, p.head, 1, R);
  return p;
}

// The blocks of `threads` threads of `kernel` that the card's SMs hold at
// once, in *blocks; `per_sm` caches the count for one SM (a static of the
// caller's, one for each kernel). Returns a cudaError_t.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, int& per_sm,
                           long long* blocks) {
  cudaError_t e = cudaSuccess;
  if (per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      0);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(e);
}

// Rows taken one a thread: the head and the tail.
__host__ __device__ inline long long rest_rows(const Plan& p) {
  return p.n - p.chunks * kChunk;
}

__device__ __forceinline__ long long rest_row(const Plan& p, long long i) {
  return i < p.head ? i : i + p.chunks * kChunk;
}

// The first row of group g of lane `lane` in chunk c.
template <typename K>
__device__ __forceinline__ long long group_row(const Plan& p, long long c,
                                               int g, int lane) {
  return p.head + c * kChunk +
         static_cast<long long>(g * 32 + lane) * Groups<K>::R;
}

template <typename K>
__device__ __forceinline__ void load_keys(const K* __restrict__ keys,
                                          const Plan& p, long long c, int lane,
                                          K (&k)[kRows]) {
  constexpr int R = Groups<K>::R, G = Groups<K>::G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const K* q = keys + group_row<K>(p, c, g, lane);
    if constexpr (R == 4) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(q));
      k[g * 4 + 0] = v.x;
      k[g * 4 + 1] = v.y;
      k[g * 4 + 2] = v.z;
      k[g * 4 + 3] = v.w;
    } else {
      const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(q));
      k[g * 2 + 0] = v.x;
      k[g * 2 + 1] = v.y;
    }
  }
}

// load_keys, but a group whose flags are all 0 (`fw[g]`, as load_flags
// gives them) loads no keys: its rows are taken as 0. A warp then reads only
// the key sectors that hold a flagged row.
template <typename K>
__device__ __forceinline__ void load_flagged_keys(
    const K* __restrict__ keys, const Plan& p, long long c, int lane,
    const unsigned (&fw)[Groups<K>::G], K (&k)[kRows]) {
  constexpr int R = Groups<K>::R, G = Groups<K>::G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const K* q = keys + group_row<K>(p, c, g, lane);
    if constexpr (R == 4) {
      int4 v = make_int4(0, 0, 0, 0);
      if (fw[g] != 0) v = __ldcs(reinterpret_cast<const int4*>(q));
      k[g * 4 + 0] = v.x;
      k[g * 4 + 1] = v.y;
      k[g * 4 + 2] = v.z;
      k[g * 4 + 3] = v.w;
    } else {
      longlong2 v = make_longlong2(0, 0);
      if (fw[g] != 0) v = __ldcs(reinterpret_cast<const longlong2*>(q));
      k[g * 2 + 0] = v.x;
      k[g * 2 + 1] = v.y;
    }
  }
}

// The flags of a lane's rows, one word a group: byte t of word g is row t of
// group g.
template <typename K>
__device__ __forceinline__ void load_flags(const uint8_t* __restrict__ flags,
                                           const Plan& p, long long c,
                                           int lane,
                                           unsigned (&w)[Groups<K>::G]) {
  constexpr int R = Groups<K>::R, G = Groups<K>::G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint8_t* q = flags + group_row<K>(p, c, g, lane);
    if (p.vflags) {
      if constexpr (R == 4)
        w[g] = __ldcs(reinterpret_cast<const unsigned*>(q));
      else
        w[g] = __ldcs(reinterpret_cast<const unsigned short*>(q));
    } else {
      unsigned x = 0;
#pragma unroll
      for (int t = 0; t < R; ++t)
        x |= static_cast<unsigned>(__ldcs(q + t)) << (8 * t);
      w[g] = x;
    }
  }
}

// Whether row i of a lane's 16 is set in its flag words.
template <typename K>
__device__ __forceinline__ bool flag_of(const unsigned (&w)[Groups<K>::G],
                                        int i) {
  constexpr int R = Groups<K>::R;
  return ((w[i / R] >> (8 * (i % R))) & 0xffu) != 0;
}

// Writes the byte outputs of the group at `row`, packed as the flags are
// (one word).
template <typename K>
__device__ __forceinline__ void store_hit_group(uint8_t* __restrict__ hit,
                                                const Plan& p, long long row,
                                                unsigned hw) {
  constexpr int R = Groups<K>::R;
  if (p.vhit) {
    if constexpr (R == 4)
      __stcs(reinterpret_cast<unsigned*>(hit + row), hw);
    else
      __stcs(reinterpret_cast<unsigned short*>(hit + row),
             static_cast<unsigned short>(hw));
  } else {
#pragma unroll
    for (int t = 0; t < R; ++t)
      __stcs(hit + row + t, static_cast<uint8_t>(hw >> (8 * t)));
  }
}

// Writes a lane's 16 byte outputs, one word a group.
template <typename K>
__device__ __forceinline__ void store_hits(uint8_t* __restrict__ hit,
                                           const Plan& p, long long c,
                                           int lane,
                                           const unsigned (&hw)[Groups<K>::G]) {
#pragma unroll
  for (int g = 0; g < Groups<K>::G; ++g)
    store_hit_group<K>(hit, p, group_row<K>(p, c, g, lane), hw[g]);
}

// Whether a streamed array of V beside the keys K takes whole-group loads:
// a group's R values are R * sizeof(V) bytes (8, 16 or 32), read as one
// 8-byte or one or two 16-byte loads where the array is aligned to that at
// the plan's first chunk row.
template <typename K, typename V>
inline int values_aligned(const void* vals, const Plan& p) {
  constexpr int B = Groups<K>::R * static_cast<int>(sizeof(V));
  return vals != nullptr &&
         aligned_at(vals, p.head, static_cast<int>(sizeof(V)),
                    B < 16 ? B : 16);
}

// One int32 or int64 element, streamed.
template <typename V>
__device__ __forceinline__ V ldcs_one(const V* q) {
  if constexpr (sizeof(V) == 4)
    return static_cast<V>(__ldcs(reinterpret_cast<const int*>(q)));
  else
    return static_cast<V>(__ldcs(reinterpret_cast<const long long*>(q)));
}

// The values (int32 or int64) of a lane's 16 rows, beside its keys: a
// group's whole where `vec` (values_aligned), else one at a time. With
// kSkip, a group whose flags are all 0 (`fw[g]`) loads none: its values are
// taken as 0.
template <typename K, typename V, bool kSkip>
__device__ __forceinline__ void load_values(
    const V* __restrict__ vals, const Plan& p, long long c, int lane, int vec,
    const unsigned (&fw)[Groups<K>::G], V (&v)[kRows]) {
  constexpr int R = Groups<K>::R, G = Groups<K>::G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (kSkip && fw[g] == 0) {
#pragma unroll
      for (int t = 0; t < R; ++t) v[g * R + t] = 0;
      continue;
    }
    const V* q = vals + group_row<K>(p, c, g, lane);
    if (!vec) {
#pragma unroll
      for (int t = 0; t < R; ++t) v[g * R + t] = ldcs_one(q + t);
    } else if constexpr (sizeof(V) == 4 && R == 4) {
      const int4 w = __ldcs(reinterpret_cast<const int4*>(q));
      v[g * 4 + 0] = w.x;
      v[g * 4 + 1] = w.y;
      v[g * 4 + 2] = w.z;
      v[g * 4 + 3] = w.w;
    } else if constexpr (sizeof(V) == 4) {
      const int2 w = __ldcs(reinterpret_cast<const int2*>(q));
      v[g * 2 + 0] = w.x;
      v[g * 2 + 1] = w.y;
    } else {
#pragma unroll
      for (int h = 0; h < R / 2; ++h) {
        const longlong2 w = __ldcs(reinterpret_cast<const longlong2*>(q) + h);
        v[g * R + 2 * h] = w.x;
        v[g * R + 2 * h + 1] = w.y;
      }
    }
  }
}

// Writes a lane's 16 int32 outputs and its 16 byte outputs, a group's
// beside each other.
template <typename K>
__device__ __forceinline__ void store_rows(int32_t* __restrict__ ridx,
                                           uint8_t* __restrict__ hit,
                                           const Plan& p, long long c,
                                           int lane,
                                           const int32_t (&r)[kRows],
                                           const unsigned (&hw)[Groups<K>::G]) {
  constexpr int R = Groups<K>::R, G = Groups<K>::G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long row = group_row<K>(p, c, g, lane);
    if (p.vridx) {
      if constexpr (R == 4)
        __stcs(reinterpret_cast<int4*>(ridx + row),
               make_int4(r[g * 4], r[g * 4 + 1], r[g * 4 + 2], r[g * 4 + 3]));
      else
        __stcs(reinterpret_cast<int2*>(ridx + row),
               make_int2(r[g * 2], r[g * 2 + 1]));
    } else {
#pragma unroll
      for (int t = 0; t < R; ++t) __stcs(ridx + row + t, r[g * R + t]);
    }
    store_hit_group<K>(hit, p, row, hw[g]);
  }
}

}  // namespace lane_rows
