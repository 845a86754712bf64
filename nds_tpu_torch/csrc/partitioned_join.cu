// Radix-partitioned M:N inner join (K6), and the radix sort that K6's build
// and the group-by (L2) share.
//
// Replaces nds_tpu/engine/kernels.py `partitioned_mn_join` with its helpers
// `_radix_scatter` and `_pids`, and the batched `lax.sort` of its build
// block. It computes what the JAX function computes, slot for slot, but not
// with its steps:
//
//   partition (one launch per side): each valid row's partition is
//     pid = (uint32(key) * 2654435761u) >> (32 - log2r)   (0 when log2r = 0)
//     and its slot in the (nparts, cap) blocks is its stable rank among the
//     valid rows of its partition, the JAX version's cumsum over the one-hot.
//     One pass with decoupled look-back (lookback.cuh) over tiles of 3072
//     rows: the tile's loads are issued together, each warp ranks its rows
//     per partition with __match_any_sync, the tile publishes its counts,
//     stages its rows in shared memory in slot order, and only then reads
//     its offset per partition from the tiles before it (by then they have
//     mostly published theirs) and writes the rows out in runs. No atomic decides a slot,
//     so the layout is bit-identical to the JAX version's. Only occupied
//     slots are written: the occupied slots of a partition are the prefix
//     [0, count_p), and the last tile writes count_p = min(rows_p, cap) per
//     partition and the rows dropped by a full partition.
//   build sort (partition_sort): a stable LSD radix sort of each build
//     partition's occupied (key, row) pairs by the key's order-preserving
//     unsigned bits, 8 bits a pass, the row id as payload, so that it gives
//     the JAX version's sorted (keys, rows) block directly. One histogram
//     pass counts every digit of every pass per partition (or the caller
//     hands in those counts, as the multi-key sorts' pack takes them in
//     sort_key.cu, and the pass is not launched); a plan kernel
//     turns the counts into digit offsets and marks a pass whose digit takes
//     one value across a partition's rows, which that partition skips (the
//     device decides, the host reads nothing). Each remaining pass is a
//     onesweep pass: persistent blocks take tiles from a counter, rank each
//     tile's rows per digit in shared memory, publish the tile's digit
//     counts, stage the tile in digit order, then read the digit offsets of
//     the tiles before them by decoupled look-back and scatter stably. The first pass reads
//     the partition block, which no pass writes; the passes then alternate
//     between a scratch block and the output so that the last lands in the
//     output. A finishing kernel writes each partition's tail
//     [count_p, cap) as (iinfo(key).max, row 0), which is where the stable
//     sort of the whole block puts the unoccupied slots (a valid key equal to
//     iinfo(key).max sorts before them, as in the JAX version), and copies a
//     partition that no pass moved. The same sort, over one partition of all
//     rows with their ids as payload, is the group-by's sort (L2,
//     nds_tpu/engine/device_exec.py `_group_ids`' lax.sort at `:2220`): the
//     executor packs presence, validity and the keys into one non-negative
//     key where their bounds allow, so that the passes above its top bit
//     hold one digit value and are skipped.
//   ranges: one thread per probe slot searches its partition's sorted build
//     keys (the occupied prefix; a probe key equal to iinfo(key).max also
//     matches every unoccupied slot, as the JAX version's searchsorted over
//     the sentinel-filled block does) for lo, gallops from lo for hi and
//     writes cnt = hi - lo as int64 (0 past the probe partition's count).
//   prefix: the caller runs seg_scan.cu's segmented scan, op +, int64,
//     restarting at every partition's first slot.
//   expand: a block per tile of 2048 output slots of one partition. Two
//     warps find the probe slots of its first and last present slot by a
//     32-way search of the offsets; that stretch of the offsets and of lo is
//     staged in shared memory, where each slot finds its probe slot rloc.
//     Then lpos = clip(lo[rloc] + s - offs[rloc - 1], 0, lcap - 1), lidx =
//     sorted build row at lpos, ridx = probe row at rloc, present = s <
//     min(total_p, kp). The slots past a partition's total are what the JAX
//     version writes there: rloc = rcap - 1, lpos clipped, present false.
//     Consecutive slots write consecutive words, and one probe's matches read
//     a contiguous run of the sorted rows. Block (0, 0) sums the overflow,
//     sum_p max(total_p - kp, 0) plus both sides' dropped rows, in int64.
//
// What bounds it on an H100: bytes. The function must read both sides' keys
// and flags and write K output slots (two int32 and a bool each). The
// partition reads each side once and writes its valid rows once; the sort
// reads the build's valid rows once for the histogram and reads and writes
// them once per pass that moves them (about 3 for keys of 17-24 bits), plus
// the unoccupied tail once; the expansion writes the K slots and reads the
// sorted rows in runs. The ranges' binary searches are random reads, one
// per probe row and level.
//
// The entry points launch on the given stream, allocate nothing (the tile
// words and the counter word of the look-back are the wrapper's, kept
// across calls; each launch draws a new epoch from the counter word on the
// card, lookback.cuh) and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using lookback::u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParts = 32;
constexpr int kPartItems = 12;
constexpr int kPartTile = kThreads * kPartItems;
constexpr int kDigits = 256;
constexpr int kHistRows = 8192;
constexpr int kFinishRows = 1024;
constexpr int kExpandItems = 8;
constexpr int kExpandTile = kThreads * kExpandItems;
constexpr int kStage = 4096;
constexpr unsigned kFull = 0xffffffffu;

// rows a tile of the sort holds: 12 a thread for int32 keys, 8 for int64
template <typename K>
constexpr int sort_items() { return sizeof(K) == 4 ? 12 : 8; }

unsigned grid_for(long long m) {
  long long g = (m + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > 65535LL * 32) g = 65535LL * 32;
  return static_cast<unsigned>(g);
}

template <typename K>
__device__ __forceinline__ int pid_of(K key, int log2r) {
  if (log2r == 0) return 0;
  const uint32_t u = static_cast<uint32_t>(key) * 2654435761u;
  return static_cast<int>(u >> (32 - log2r));
}

// digit d (8 bits) of the key's order-preserving unsigned bits
template <typename K>
__device__ __forceinline__ int digit_of(K key, int d) {
  if constexpr (sizeof(K) == 4) {
    const uint32_t u = static_cast<uint32_t>(key) ^ 0x80000000u;
    return static_cast<int>((u >> (8 * d)) & 0xffu);
  } else {
    const uint64_t u = static_cast<uint64_t>(key) ^ 0x8000000000000000ull;
    return static_cast<int>((u >> (8 * d)) & 0xffu);
  }
}

// This lane's stable rank among the lanes of its warp with the same bin,
// plus the warp's running count of that bin in `wcnt`, which it then
// advances. A bin >= NB is not counted.
template <int NB>
__device__ __forceinline__ int warp_rank(int bin, int* wcnt, int lane) {
  const unsigned peers = __match_any_sync(kFull, bin);
  const int before = __popc(peers & ((1u << lane) - 1u));
  const int rank = bin < NB ? wcnt[bin] + before : 0;
  __syncwarp();
  if (bin < NB && before == 0) wcnt[bin] += __popc(peers);
  __syncwarp();
  return rank;
}

// exclusive prefix of c over the block's 256 threads; `s_w` holds 8 words;
// ends in a barrier
__device__ __forceinline__ unsigned block_excl(unsigned c, unsigned* s_w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_w[warp] = incl;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += s_w[w];
  __syncthreads();
  return before + incl - c;
}

// first index in [lo, hi) where the monotone `pred` holds, else hi: a
// 32-way search by the lanes of one warp
template <typename P>
__device__ long long warp_first(long long lo, long long hi, P pred, int lane) {
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long i = lo + lane * step;
    const unsigned m = __ballot_sync(kFull, i >= hi || pred(i));
    if (m == 0) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(m) - 1;
      if (f == 0) return lo;
      hi = lo + f * step < hi ? lo + f * step : hi;
      lo += (f - 1) * step + 1;
    }
  }
  const long long i = lo + lane;
  const unsigned m = __ballot_sync(kFull, i < hi && pred(i));
  return m ? lo + __ffs(m) - 1 : hi;
}

// ------------------------------------------------------------ partition

// tile words: ntiles x kMaxParts
template <typename K>
__global__ void __launch_bounds__(kThreads)
    partition_rows(const K* __restrict__ key, const uint8_t* __restrict__ ok,
                   long long n, long long ntiles, int nparts, int log2r,
                   long long cap, K* __restrict__ keys,
                   int32_t* __restrict__ gidx, int32_t* __restrict__ count,
                   long long* __restrict__ over, u64* words, u64* ctr) {
  __shared__ K s_key[kPartTile];
  __shared__ int32_t s_row[kPartTile];
  __shared__ int s_wcnt[kWarps][kMaxParts];
  __shared__ unsigned s_texcl[kMaxParts];
  __shared__ unsigned s_base[kMaxParts];
  __shared__ int s_valid;
  __shared__ long long s_tile;
  __shared__ unsigned s_epoch;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) {
    const lookback::Draw d = lookback::take(ctr, ntiles - 1);
    s_tile = d.id;
    s_epoch = d.epoch;
  }
  if (t < kWarps * kMaxParts) (&s_wcnt[0][0])[t] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const unsigned epoch = s_epoch;
  const long long r0 = tile * kPartTile;

  // tile order = (warp, item, lane) = row order; every load is issued
  // before the first rank, so that they are in flight together
  K k_[kPartItems];
  uint8_t ok_[kPartItems];
  int b_[kPartItems];
  int rank[kPartItems];
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    const long long i = r0 + warp * (32 * kPartItems) + k * 32 + lane;
    ok_[k] = i < n ? ok[i] : 0;
    k_[k] = i < n ? key[i] : K{};
  }
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    b_[k] = ok_[k] ? pid_of(k_[k], log2r) : kMaxParts;
    rank[k] = warp_rank<kMaxParts>(b_[k], s_wcnt[warp], lane);
  }
  __syncthreads();

  // lane p of warp 0: partition p's count in this tile and its offsets
  // over the warps, published before the tile's local work; the look-back
  // waits until that work is done
  unsigned tc = 0;
  if (warp == 0) {
    if (lane < nparts) {
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_wcnt[w][lane];
        s_wcnt[w][lane] = static_cast<int>(tc);
        tc += c;
      }
      lookback::st_relaxed(words + tile * kMaxParts + lane,
                           lookback::count_word(
                               epoch, tile == 0 ? lookback::kPrefix
                                                : lookback::kAgg, tc));
    }
    // tile-local offsets over the partitions
    unsigned incl = tc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    s_texcl[lane] = incl - tc;
    if (lane == 31) s_valid = static_cast<int>(incl);
  }
  __syncthreads();

  // stage the tile in slot order
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    if (b_[k] >= kMaxParts) continue;
    const int lp = s_texcl[b_[k]] + s_wcnt[warp][b_[k]] + rank[k];
    s_key[lp] = k_[k];
    s_row[lp] = static_cast<int32_t>(r0 + warp * (32 * kPartItems) + k * 32 + lane);
  }
  if (warp == 0) {
    // partition p's offset over the tiles before this one
    unsigned excl = 0;
    if (lane < nparts && tile > 0) {
      excl = lookback::count_lookback(words + lane, tile, kMaxParts, epoch);
      lookback::st_relaxed(words + tile * kMaxParts + lane,
                           lookback::count_word(epoch, lookback::kPrefix,
                                                excl + tc));
    }
    if (lane < kMaxParts) s_base[lane] = excl;
    if (tile == ntiles - 1) {
      // the last tile knows every partition's rows, and the dropped ones
      const long long rows = static_cast<long long>(excl) + tc;
      if (lane < nparts) count[lane] = static_cast<int32_t>(rows < cap ? rows : cap);
      long long drop = lane < nparts && rows > cap ? rows - cap : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) drop += __shfl_down_sync(kFull, drop, o);
      if (lane == 0) *over = drop;
    }
  }
  __syncthreads();

  // write the tile out in runs
  for (int i = t; i < s_valid; i += kThreads) {
    const K kk = s_key[i];
    const int p = pid_of(kk, log2r);
    const long long r = static_cast<long long>(s_base[p]) + (i - s_texcl[p]);
    if (r >= cap) continue;
    keys[p * cap + r] = kk;
    gidx[p * cap + r] = s_row[i];
  }
}

// ------------------------------------------------------------ build sort

// hist[p][d][digit] += rows of partition p's occupied prefix
template <typename K>
__global__ void __launch_bounds__(kThreads)
    digit_hist(const K* __restrict__ keys, long long cap,
               const int32_t* __restrict__ count, unsigned* __restrict__ hist) {
  constexpr int kPasses = sizeof(K);
  __shared__ unsigned sh[kPasses][kDigits];
  const int p = blockIdx.y;
  const long long r0 = blockIdx.x * (long long)kHistRows;
  const long long cn = count[p];
  if (r0 >= cn) return;
  const int t = threadIdx.x;
  for (int i = t; i < kPasses * kDigits; i += kThreads) (&sh[0][0])[i] = 0;
  __syncthreads();
  const K* a = keys + p * cap;
  constexpr int kBatch = 8;  // rows a thread loads before counting them
  for (int j0 = 0; j0 < kHistRows / kThreads; j0 += kBatch) {
    K kk[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long r = r0 + (j0 + j) * kThreads + t;
      kk[j] = r < cn ? a[r] : K{};
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool valid = r0 + (j0 + j) * kThreads + t < cn;
#pragma unroll
      for (int d = 0; d < kPasses; ++d) {
        const int dg = valid ? digit_of(kk[j], d) : kDigits;
        const unsigned peers = __match_any_sync(kFull, dg);
        if (valid && (peers & ((1u << (t & 31)) - 1u)) == 0)
          atomicAdd(&sh[d][dg], static_cast<unsigned>(__popc(peers)));
      }
    }
  }
  __syncthreads();
  for (int i = t; i < kPasses * kDigits; i += kThreads)
    if ((&sh[0][0])[i]) atomicAdd(&hist[p * kPasses * kDigits + i], (&sh[0][0])[i]);
}

// one block per partition: exclusive digit offsets of every pass, and
// info[p][d] = moves | ordinal among the passes that move << 4 | how many
// passes move << 8; a pass moves nothing where one digit holds every row
__global__ void __launch_bounds__(kThreads)
    digit_plan(const unsigned* __restrict__ hist,
               const int32_t* __restrict__ count, int npasses,
               unsigned* __restrict__ dbase, int32_t* __restrict__ info) {
  __shared__ unsigned s_w[kWarps];
  __shared__ int s_moves[8];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned cn = static_cast<unsigned>(count[p]);
  for (int d = 0; d < npasses; ++d) {
    const long long at = (static_cast<long long>(p) * npasses + d) * kDigits + t;
    const unsigned c = hist[at];
    dbase[at] = block_excl(c, s_w);
    const int one = __syncthreads_or(c == cn);
    if (t == 0) s_moves[d] = one ? 0 : 1;
  }
  __syncthreads();
  if (t < npasses) {
    int j = 0, m = 0;
    for (int d = 0; d < npasses; ++d) {
      j += d < t ? s_moves[d] : 0;
      m += s_moves[d];
    }
    info[p * npasses + t] = s_moves[t] | (j << 4) | (m << 8);
  }
}

// one onesweep pass (digit d) over the partitions it moves; tile words:
// flat tile id x kDigits
template <typename K, int I>
__global__ void __launch_bounds__(kThreads)
    sort_pass(int d, int nparts, long long cap,
              const int32_t* __restrict__ count,
              const int32_t* __restrict__ info,
              const unsigned* __restrict__ dbase, const K* kP,
              const int32_t* gP, K* kT,
              int32_t* gT, K* kO, int32_t* gO, u64* words, u64* ctr) {
  constexpr int kPasses = sizeof(K);
  constexpr int kTile = kThreads * I;
  __shared__ K s_key[kTile];
  __shared__ int32_t s_g[kTile];
  __shared__ int s_wcnt[kWarps][kDigits];
  __shared__ unsigned s_texcl[kDigits];
  __shared__ unsigned s_dst[kDigits];
  __shared__ unsigned s_w[kWarps];
  __shared__ long long s_end[kMaxParts];
  __shared__ long long s_total;
  __shared__ long long s_id;
  __shared__ unsigned s_epoch;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (warp == 0) {
    // the flat tile ids of each partition this pass moves
    long long nt = 0;
    if (lane < nparts && (info[lane * kPasses + d] & 1))
      nt = (static_cast<long long>(count[lane]) + kTile - 1) / kTile;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, nt, o);
      if (lane >= o) nt += y;
    }
    if (lane < kMaxParts) s_end[lane] = nt;
    if (lane == 31) s_total = nt;
  }
  __syncthreads();
  const long long total = s_total;
  // every block draws until its id is past the last tile, so the launch
  // draws total + gridDim.x ids, all of one epoch
  while (true) {
    if (t == 0) {
      const lookback::Draw dr = lookback::take(ctr, total + gridDim.x - 1);
      s_id = dr.id;
      s_epoch = dr.epoch;
    }
    for (int i = t; i < kWarps * kDigits; i += kThreads) (&s_wcnt[0][0])[i] = 0;
    __syncthreads();
    const long long id = s_id;
    const unsigned epoch = s_epoch;
    if (id >= total) break;
    int p = 0;
    while (s_end[p] <= id) ++p;
    const long long first = p > 0 ? s_end[p - 1] : 0;
    const long long tile = id - first;
    const int inf = info[p * kPasses + d];
    const int j = (inf >> 4) & 15;
    const int m = (inf >> 8) & 15;
    // the passes alternate between the output and the scratch block so
    // that the last lands in the output; the first reads the partitions
    const bool src_t = ((m - j) & 1) != 0;
    const bool dst_t = ((m - 1 - j) & 1) != 0;
    const K* sk = j == 0 ? kP : (src_t ? kT : kO);
    const int32_t* sg = j == 0 ? gP : (src_t ? gT : gO);
    K* dk = dst_t ? kT : kO;
    int32_t* dg = dst_t ? gT : gO;
    const long long off = p * cap;
    const long long r0 = tile * kTile;
    const long long left = count[p] - r0;
    const int cnt = left < kTile ? static_cast<int>(left) : kTile;

    K k_[I];
    int32_t g_[I];
    int dg_[I];
    int rank[I];
    // every load is issued before the first rank
#pragma unroll
    for (int k = 0; k < I; ++k) {
      const int local = warp * (32 * I) + k * 32 + lane;
      const bool valid = local < cnt;
      k_[k] = valid ? sk[off + r0 + local] : K{};
      g_[k] = valid ? sg[off + r0 + local] : 0;
      dg_[k] = valid ? kDigits - 1 : kDigits;
    }
#pragma unroll
    for (int k = 0; k < I; ++k) {
      if (dg_[k] < kDigits) dg_[k] = digit_of(k_[k], d);
      rank[k] = warp_rank<kDigits>(dg_[k], s_wcnt[warp], lane);
    }
    __syncthreads();

    // thread t: digit t's count in this tile and its offsets over the
    // warps; the count is published before the tile's local work, and the
    // look-back waits until that work is done, so that the tiles before it
    // have had the time to publish their prefixes
    unsigned tc = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_wcnt[w][t];
      s_wcnt[w][t] = static_cast<int>(tc);
      tc += c;
    }
    u64* tw = words + first * kDigits + t;
    lookback::st_relaxed(tw + tile * kDigits,
                         lookback::count_word(
                             epoch, tile == 0 ? lookback::kPrefix
                                              : lookback::kAgg, tc));
    s_texcl[t] = block_excl(tc, s_w);
    __syncthreads();

    // stage the tile in digit order
#pragma unroll
    for (int k = 0; k < I; ++k) {
      if (dg_[k] >= kDigits) continue;
      const int lp = s_texcl[dg_[k]] + s_wcnt[warp][dg_[k]] + rank[k];
      s_key[lp] = k_[k];
      s_g[lp] = g_[k];
    }
    // digit t's offset over the tiles before this one
    unsigned excl = 0;
    if (tile > 0) {
      excl = lookback::count_lookback(tw, tile, kDigits, epoch);
      lookback::st_relaxed(tw + tile * kDigits,
                           lookback::count_word(epoch, lookback::kPrefix,
                                                excl + tc));
    }
    s_dst[t] = dbase[(static_cast<long long>(p) * kPasses + d) * kDigits + t] + excl;
    __syncthreads();

    // write the tile out in runs
    for (int i = t; i < cnt; i += kThreads) {
      const K kk = s_key[i];
      const int x = digit_of(kk, d);
      const long long pos = off + s_dst[x] + (i - s_texcl[x]);
      dk[pos] = kk;
      dg[pos] = s_g[i];
    }
    __syncthreads();
  }
}

// the unoccupied tail of every partition as (iinfo(key).max, 0), and the
// occupied prefix of a partition that no pass moved
template <typename K>
__global__ void __launch_bounds__(kThreads)
    sort_finish(const K* __restrict__ kP, const int32_t* __restrict__ gP,
                K* __restrict__ kO, int32_t* __restrict__ gO, long long cap,
                const int32_t* __restrict__ count,
                const int32_t* __restrict__ info, K sent) {
  constexpr int kPasses = sizeof(K);
  const int p = blockIdx.y;
  const long long r0 = blockIdx.x * (long long)kFinishRows;
  const long long cn = count[p];
  const int moved = (info[p * kPasses] >> 8) & 15;
  if (moved > 0 && r0 + kFinishRows <= cn) return;
  const long long r1 = r0 + kFinishRows < cap ? r0 + kFinishRows : cap;
  for (long long r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const long long at = p * cap + r;
    if (r >= cn) {
      kO[at] = sent;
      gO[at] = 0;
    } else if (moved == 0) {
      kO[at] = kP[at];
      gO[at] = gP[at];
    }
  }
}

// ----------------------------------------------------------- ranges

template <typename K>
__device__ __forceinline__ long long first_not_less(const K* a, long long m,
                                                    K q) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in [lo, m) whose key is greater than q (a[lo - 1] < q or lo
// == 0), galloping from lo: one match range costs about log2 of its length
template <typename K>
__device__ __forceinline__ long long first_greater_from(const K* a,
                                                        long long lo,
                                                        long long m, K q) {
  long long hi = m;
  for (long long step = 1;; step <<= 1) {
    const long long at = lo + step - 1;
    if (at >= m) break;
    if (a[at] > q) {
      hi = at;
      break;
    }
    lo = at + 1;
  }
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename K>
__global__ void match_ranges(const K* __restrict__ ks, long long lcap,
                             const K* __restrict__ rk, long long rcap,
                             long long m, const int32_t* __restrict__ lcount,
                             const int32_t* __restrict__ rcount, K sent,
                             int32_t* __restrict__ lo_i,
                             long long* __restrict__ cnt) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < m;
       j += (long long)gridDim.x * blockDim.x) {
    const long long p = j / rcap;
    const long long jj = j - p * rcap;
    const bool occ = jj < rcount[p];
    cnt[j] = 0;
    // lo of an unoccupied slot is read only at the partition's last slot
    if (!occ && jj != rcap - 1) continue;
    const K* a = ks + p * lcap;
    const long long ln = lcount[p];
    const K q = occ ? rk[j] : sent;
    const long long lo = first_not_less(a, ln, q);
    lo_i[j] = static_cast<int32_t>(lo);
    if (occ) cnt[j] = (q == sent ? lcap : first_greater_from(a, lo, ln, q)) - lo;
  }
}

// ----------------------------------------------------------- expansion

__global__ void __launch_bounds__(kThreads)
    expand_slots(const long long* __restrict__ offs,
                 const int32_t* __restrict__ lo_i,
                 const int32_t* __restrict__ gs, const int32_t* __restrict__ rg,
                 int nparts, long long lcap, long long rcap, long long kp,
                 const int32_t* __restrict__ rcount,
                 const long long* __restrict__ over,
                 int32_t* __restrict__ lidx, int32_t* __restrict__ ridx,
                 uint8_t* __restrict__ present,
                 long long* __restrict__ overflow) {
  __shared__ int32_t s_off[kStage + 1];
  __shared__ int32_t s_lo[kStage];
  __shared__ long long s_r[2];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long p = blockIdx.y;
  const long long s0 = blockIdx.x * (long long)kExpandTile;
  const long long s1 = s0 + kExpandTile < kp ? s0 + kExpandTile : kp;
  const long long cl = kp + 1;
  const long long* o = offs + p * rcap;
  const int32_t* lo_p = lo_i + p * rcap;
  const int32_t* g = gs + p * lcap;
  const long long total = o[rcap - 1];
  const long long lim = total < kp ? total : kp;
  const long long rn = rcount[p];
  const long long e = s1 < lim ? s1 : lim;  // present slots: [s0, e)
  if (blockIdx.x == 0 && p == 0 && t == 0) {
    long long acc = over[0] + over[1];
    for (int q = 0; q < nparts; ++q) {
      const long long tq = offs[q * rcap + rcap - 1];
      if (tq > kp) acc += tq - kp;
    }
    *overflow = acc;
  }
  long long r0 = 0, L = 0;
  bool staged = false;
  if (s0 < e) {
    if (warp < 2) {
      const long long s = warp == 0 ? s0 : e - 1;
      const long long r =
          warp_first(0, rn, [&](long long j) { return o[j] > s; }, lane);
      if (lane == 0) s_r[warp] = r;
    }
    __syncthreads();
    r0 = s_r[0];
    L = s_r[1] - r0 + 1;  // the present slots' rloc lie in [r0, r0 + L)
    staged = L <= kStage;
    if (staged) {
      // s_off[i] = min(offs[r0 - 1 + i], kp + 1), offs[-1] = 0
      for (long long i = t; i <= L; i += kThreads) {
        const long long j = r0 - 1 + i;
        const long long v = j < 0 ? 0 : (o[j] < cl ? o[j] : cl);
        s_off[i] = static_cast<int32_t>(v);
        if (i < L) s_lo[i] = lo_p[r0 + i];
      }
      __syncthreads();
    }
  }
  // every slot past the total maps to the partition's last probe slot
  const long long tail_prev = rcap > 1 ? (o[rcap - 2] < cl ? o[rcap - 2] : cl) : 0;
  const long long tail_lo = lo_p[rcap - 1];
  const int32_t tail_r = rcap - 1 < rn ? rg[p * rcap + rcap - 1] : 0;
  const long long ob = p * kp;
#pragma unroll
  for (int k = 0; k < kExpandItems; ++k) {
    const long long s = s0 + k * kThreads + t;
    if (s >= s1) break;
    long long prev, lo;
    int32_t r;
    uint8_t pr = 0;
    if (s < e) {
      long long rloc;
      if (staged) {
        int a = 1, b = static_cast<int>(L);
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (s_off[mid] > s) b = mid; else a = mid + 1;
        }
        rloc = r0 - 1 + a;
        prev = s_off[a - 1];
        lo = s_lo[a - 1];
      } else {
        long long a = r0, b = r0 + L - 1;
        while (a < b) {
          const long long mid = (a + b) >> 1;
          if (o[mid] > s) b = mid; else a = mid + 1;
        }
        rloc = a;
        prev = rloc > 0 ? (o[rloc - 1] < cl ? o[rloc - 1] : cl) : 0;
        lo = lo_p[rloc];
      }
      r = rg[p * rcap + rloc];
      pr = 1;
    } else {
      prev = tail_prev;
      lo = tail_lo;
      r = tail_r;
    }
    long long lpos = lo + (s - prev);
    lpos = lpos < 0 ? 0 : (lpos > lcap - 1 ? lcap - 1 : lpos);
    lidx[ob + s] = g[lpos];
    ridx[ob + s] = r;
    present[ob + s] = pr;
  }
}

template <typename K>
void sort_t(const void* kP, const void* gP, void* kT, void* gT, void* kO, void* gO,
            int nparts, long long cap, const int32_t* count, unsigned* hist,
            bool counted, unsigned* dbase, int32_t* info, u64* words, u64* ctr,
            K sent, cudaStream_t s) {
  constexpr int kPasses = sizeof(K);
  constexpr int I = sort_items<K>();
  const unsigned hx = static_cast<unsigned>((cap + kHistRows - 1) / kHistRows);
  if (!counted)
    digit_hist<K><<<dim3(hx, nparts), kThreads, 0, s>>>(
        static_cast<const K*>(kP), cap, count, hist);
  digit_plan<<<nparts, kThreads, 0, s>>>(hist, count, kPasses, dbase, info);
  int dev = 0, sms = 1, per = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, sort_pass<K, I>,
                                                kThreads, 0);
  const unsigned grid = static_cast<unsigned>(sms * (per > 0 ? per : 1));
  for (int d = 0; d < kPasses; ++d)
    sort_pass<K, I><<<grid, kThreads, 0, s>>>(
        d, nparts, cap, count, info, dbase, static_cast<const K*>(kP),
        static_cast<const int32_t*>(gP), static_cast<K*>(kT),
        static_cast<int32_t*>(gT), static_cast<K*>(kO),
        static_cast<int32_t*>(gO), words, ctr);
  const unsigned fx = static_cast<unsigned>((cap + kFinishRows - 1) / kFinishRows);
  sort_finish<K><<<dim3(fx, nparts), kThreads, 0, s>>>(
      static_cast<const K*>(kP), static_cast<const int32_t*>(gP),
      static_cast<K*>(kO), static_cast<int32_t*>(gO), cap, count, info, sent);
}

}  // namespace

extern "C" {

int nds_pj_partition_tile() { return kPartTile; }
int nds_pj_sort_tile(int key64) {
  return kThreads * (key64 ? sort_items<int64_t>() : sort_items<int32_t>());
}
int nds_pj_max_parts() { return kMaxParts; }

// The look-back entries take the tile words `words` (int64) and the counter
// word `ctr` (int64[1]: the next launch's epoch << 32, its tile id 0). Each
// launch draws one epoch from it (the sort one per pass), and no word of
// `words` may hold an epoch that a launch draws.

// One side's partition blocks. key: int32 or int64 (key64) [n], ok: bool[n],
// 1 <= n < 2^31. keys: K[nparts * cap], gidx: int32[nparts * cap]: the
// occupied prefix of each partition is written, the rest left as it was.
// count: int32[nparts], the occupied slots per partition; over: int64, the
// rows dropped by full partitions. words: ceil(n / nds_pj_partition_tile())
// * nds_pj_max_parts(). nparts a power of two <= nds_pj_max_parts() with
// nparts == 1 << log2r.
int nds_pj_partition(const void* key, const void* ok, long long n, int key64,
                     int nparts, int log2r, long long cap, void* keys,
                     void* gidx, void* count, void* over, void* words,
                     void* ctr, void* stream) {
  if (n < 1 || n >= (1LL << 31) || cap < 1 || nparts < 1 ||
      nparts > kMaxParts || nparts != (1 << log2r))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + kPartTile - 1) / kPartTile;
  if (key64)
    partition_rows<int64_t><<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
        static_cast<const int64_t*>(key), static_cast<const uint8_t*>(ok), n,
        ntiles, nparts, log2r, cap, static_cast<int64_t*>(keys),
        static_cast<int32_t*>(gidx), static_cast<int32_t*>(count),
        static_cast<long long*>(over), static_cast<u64*>(words),
        static_cast<u64*>(ctr));
  else
    partition_rows<int32_t><<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
        static_cast<const int32_t*>(key), static_cast<const uint8_t*>(ok), n,
        ntiles, nparts, log2r, cap, static_cast<int32_t*>(keys),
        static_cast<int32_t*>(gidx), static_cast<int32_t*>(count),
        static_cast<long long*>(over), static_cast<u64*>(words),
        static_cast<u64*>(ctr));
  return static_cast<int>(cudaGetLastError());
}

// The build sort. keys, gidx: K and int32 [nparts * cap] partition blocks
// whose first count[p] slots of partition p are occupied (only read);
// tkeys, tgidx: scratch of the same shapes; okeys, ogidx: the sorted
// blocks. hist: int32[nparts * P * 256] (P = 8 passes for int64 keys, 4
// for int32): with counted = 0, zeros, and the sort counts the digits of
// each partition's occupied prefix into it; with counted = 1, those counts
// as the caller took them, hist[(p * P + d) * 256 + digit] for digit d of
// the keys' order-preserving unsigned bits (sort_key.cu's pack writes them
// for one partition), and the sort reads them as they are. dbase:
// int32[nparts * 8 * 256] and info: int32[nparts * 8], scratch. words:
// nparts * ceil(cap / nds_pj_sort_tile(key64)) * 256. Eight (int64 keys)
// or four (int32) passes, each drawing an epoch.
int nds_pj_sort(const void* keys, const void* gidx, void* tkeys, void* tgidx, void* okeys,
                void* ogidx, int key64, int nparts, long long cap,
                const void* count, void* hist, int counted, void* dbase,
                void* info, void* words, void* ctr, void* stream) {
  if (cap < 1 || nparts < 1 || nparts > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* cnt = static_cast<const int32_t*>(count);
  unsigned* h = static_cast<unsigned*>(hist);
  unsigned* b = static_cast<unsigned*>(dbase);
  int32_t* inf = static_cast<int32_t*>(info);
  u64* w = static_cast<u64*>(words);
  u64* c = static_cast<u64*>(ctr);
  if (key64)
    sort_t<int64_t>(keys, gidx, tkeys, tgidx, okeys, ogidx, nparts, cap, cnt,
                    h, counted != 0, b, inf, w, c, INT64_MAX, s);
  else
    sort_t<int32_t>(keys, gidx, tkeys, tgidx, okeys, ogidx, nparts, cap, cnt,
                    h, counted != 0, b, inf, w, c, INT32_MAX, s);
  return static_cast<int>(cudaGetLastError());
}

// Match ranges of every probe slot. ks: sorted build keys K[nparts * lcap];
// rk: probe partition keys K[nparts * rcap]; lcount, rcount: int32[nparts],
// each side's occupied slots. lo_i: int32[nparts * rcap] (written at the
// occupied slots and each partition's last), cnt: int64[nparts * rcap].
int nds_pj_ranges(const void* ks, int key64, long long lcap, const void* rk,
                  long long rcap, int nparts, const void* lcount,
                  const void* rcount, void* lo_i, void* cnt, void* stream) {
  if (lcap < 1 || rcap < 1 || nparts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long m = nparts * rcap;
  const int32_t* lc = static_cast<const int32_t*>(lcount);
  const int32_t* rc = static_cast<const int32_t*>(rcount);
  if (key64)
    match_ranges<int64_t><<<grid_for(m), kThreads, 0, s>>>(
        static_cast<const int64_t*>(ks), lcap, static_cast<const int64_t*>(rk),
        rcap, m, lc, rc, INT64_MAX, static_cast<int32_t*>(lo_i),
        static_cast<long long*>(cnt));
  else
    match_ranges<int32_t><<<grid_for(m), kThreads, 0, s>>>(
        static_cast<const int32_t*>(ks), lcap, static_cast<const int32_t*>(rk),
        rcap, m, lc, rc, INT32_MAX, static_cast<int32_t*>(lo_i),
        static_cast<long long*>(cnt));
  return static_cast<int>(cudaGetLastError());
}

// Expansion into nparts * kp output slots. offs: per-partition inclusive
// prefix of cnt, int64[nparts * rcap]; lo_i from nds_pj_ranges; gs: build
// row of each sorted slot, int32[nparts * lcap]; rg: probe row of each
// partition slot, int32[nparts * rcap]; rcount: int32[nparts]; over:
// int64[2], both sides' dropped rows. lidx, ridx: int32[nparts * kp];
// present: bool[nparts * kp]; overflow: int64[1]. kp + 1 < 2^31.
int nds_pj_expand(const void* offs, const void* lo_i, const void* gs,
                  const void* rg, int nparts, long long lcap, long long rcap,
                  long long kp, const void* rcount, const void* over,
                  void* lidx, void* ridx, void* present, void* overflow,
                  void* stream) {
  if (lcap < 1 || rcap < 1 || kp < 1 || kp + 1 >= (1LL << 31) || nparts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gx = static_cast<unsigned>((kp + kExpandTile - 1) / kExpandTile);
  expand_slots<<<dim3(gx, nparts), kThreads, 0, s>>>(
      static_cast<const long long*>(offs), static_cast<const int32_t*>(lo_i),
      static_cast<const int32_t*>(gs), static_cast<const int32_t*>(rg), nparts,
      lcap, rcap, kp, static_cast<const int32_t*>(rcount),
      static_cast<const long long*>(over), static_cast<int32_t*>(lidx),
      static_cast<int32_t*>(ridx), static_cast<uint8_t*>(present),
      static_cast<long long*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
