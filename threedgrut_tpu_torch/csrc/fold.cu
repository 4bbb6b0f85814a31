// Kernel D: fold per-pair record gradients into the per-particle table.
//
// Replaces threedgrut_tpu/ops/pallas/fold.py:_fold_wide_kernel (reached
// through fold_sorted_intervals_wide from render/gut.py:_grf_bwd) and
// fold.py:_fold_kernel, together with _grf_bwd's un-permute gather and its
// rank -> particle map. Depth rank r owns the pre-tile-sort pair slots
// [excl[r], min(excl[r] + counts[r], limit)); pre-sort slot s sits at
// tile-sorted position inv_perm[s]. The TPU kernel encodes ranks as f32
// labels and segment-sums with an equality-mask matmul on the MXU,
// because XLA lowers a scatter-add to a scalar loop; on Hopper a gather is
// cheap, and the fold is a gather of 64 B (or 256 B) rows by inv_perm and
// a sum per rank.
//
// Bound on this card: memory. At an 800x800 view's ~0.7M pairs and 100k
// particles the bytes are ~45 MB (tens of microseconds at HBM rate), but
// each slot costs two dependent loads (inv_perm[s], then its row), so the
// gather's latency decides how close it comes. Measured on the H100
// (PERF.md §6): the walk that takes one slot per half-warp keeps about one
// row of the warp in flight; loading the indices 32 at a time alone does
// not help (the row loads are the latency); a whole warp per rank wastes
// most of its lanes on runs of 7-20 slots (0.043 ms at 3DGUT against 0.027
// for 8 lanes a rank); a block barrier to split long runs over the block's
// warps cost more (0.065) than the runs it splits, of which these views
// have few (the longest 90 slots at 800x800, 225 rolling, 312 on the grid
// trace). So this design:
//
// - A group of kSub lanes takes a rank (8 for 16-wide rows, 16 for 64-wide,
//   32 where runs are long: the wrapper picks it from the mean run). The
//   group loads kSub of the run's slot indices in one coalesced load,
//   hands them out by shuffle, and issues the row loads of a batch before
//   adding any of them: a 16-wide row is four lanes of float4, so an
//   8-lane group reads two rows an instruction and a warp eight. The next
//   batch's indices are loaded while this batch's rows are in flight.
//   Each lane keeps a float4 partial; a fixed xor tree over the group's
//   row groups ends the sum.
// - A run longer than four batches of its group is folded afterwards by
//   the whole warp (32 lanes, eight 16-wide rows an instruction), the
//   warp's long runs one after another in rank order.
// - A slot whose tile-sorted position is >= *n_valid (the tile cull's
//   sentinel sorts culled pairs past tile_start[-1]; kernel C's wrapper
//   leaves their rows zero) is not read.
// - inv_perm comes from the caller where it has it (the grid trace's pair
//   sort), else from fold_invert_launch: one kernel for the three PyTorch
//   ops (cast, arange, index_put) of the inverse.
//
// The shared-segment mode (fold_segment_launch; the TPU's kernel 7, which
// trace()'s brute force takes): kernel C writes tile t's gradient of
// segment slot j to row t P + j. The segment is in rank order (its
// permutation is the identity), so slot s sums the rows t P + s of every
// tile t, and one warp instruction reads eight neighbouring rows of one
// tile (512 B); the block's warps take
// contiguous ranges of the tiles and their sums are added in warp order.
// The column sums [P, W] then fold by rank as above. Nothing the size of
// the tiles' rows is built besides them.
//
// Determinism: no atomics. Every particle row is written exactly once (the
// ranks are a permutation of the capacity rows; a rank with no slots,
// e.g. an invalid or inactive particle, writes zeros) and each row's sum
// is taken in one fixed order, so the gradient is bitwise the same run to
// run. The order differs from a sequential sum's, within fp32 rounding.
//
// The shared-segment mode takes the runs as consecutive from slot 0 (excl
// the exclusive scan of counts), as trace's fold and the plain version
// have them: the last rank's run ends the slots it sums.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The sum over a group of kSub lanes (a whole warp at 32; ``mask`` the
// group's lanes) of the rows of pre-sort slots [s0, s1): the row of slot
// s is inv_perm[s] (s itself where inv_perm is null), skipped where it is
// >= n_valid. Slot b + k of a batch goes to row group k % kGroups. The
// group's lanes < kLanes return the sum of their float4 column.
template <int kWidth, int kSub>
__device__ float4 group_fold(const float4* __restrict__ rows,
                             const int32_t* __restrict__ inv_perm, int s0,
                             int s1, int n_valid, int sl, unsigned mask) {
  constexpr int kLanes = kWidth / 4;
  static_assert(kWidth == 16 || kWidth == 64, "fold widths: 16 and 64");
  static_assert(kSub >= kLanes && kSub <= 32, "a group holds a row");
  constexpr int kGroups = kSub / kLanes;  // rows a load instruction reads
  constexpr int kLoads = kSub / kGroups;  // per batch of kSub slots
  constexpr int kChunk = kLoads < 8 ? kLoads : 8;  // loads in flight
  const int q = sl % kLanes;
  const int g = sl / kLanes;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  auto index = [&](int s) {
    if (s >= s1) return -1;
    return inv_perm ? __ldg(inv_perm + s) : s;
  };
  int next = index(s0 + sl);
  for (int b = s0; b < s1; b += kSub) {
    const int cur = next;
    next = index(b + kSub + sl);  // in flight with this batch's rows
#pragma unroll
    for (int c0 = 0; c0 < kLoads; c0 += kChunk) {
      float4 v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int row =
            __shfl_sync(mask, cur, (c0 + i) * kGroups + g, kSub);
        v[i] = (row >= 0 && row < n_valid)
                   ? __ldg(rows + static_cast<int64_t>(row) * kLanes + q)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) add4(acc, v[i]);
    }
  }
#pragma unroll
  for (int m = kSub / 2; m >= kLanes; m >>= 1) {  // over the row groups
    add4(acc, make_float4(__shfl_xor_sync(mask, acc.x, m, kSub),
                          __shfl_xor_sync(mask, acc.y, m, kSub),
                          __shfl_xor_sync(mask, acc.z, m, kSub),
                          __shfl_xor_sync(mask, acc.w, m, kSub)));
  }
  return acc;
}

// A group of kSub lanes per rank, 32 / kSub ranks a warp; a run longer
// than kShort slots is folded afterwards by the whole warp.
template <int kWidth, int kSub>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ d_records,   // [*, kWidth] rows
            const int32_t* __restrict__ inv_perm,  // [P] pre slot -> row
            const int32_t* __restrict__ order,     // [N] rank -> particle
            const int32_t* __restrict__ excl,      // [N] first slot per rank
            const int32_t* __restrict__ counts,    // [N] slots per rank
            int n_ranks, int limit,
            const int32_t* __restrict__ n_valid_ptr,  // rows read, or null
            float* __restrict__ d_table) {         // [N, kWidth]
  constexpr int kLanes = kWidth / 4;
  constexpr int kShort = kSub < 32 ? 4 * kSub : INT_MAX;
  const float4* rows = reinterpret_cast<const float4*>(d_records);
  float4* out = reinterpret_cast<float4*>(d_table);
  const int lane = threadIdx.x & 31;
  const int sub = lane / kSub;
  const int sl = lane % kSub;
  const unsigned mask =
      kSub == 32 ? kFull : ((1u << kSub) - 1u) << (sub * kSub);
  const int r = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / kSub) +
                sub;
  const int n_valid = n_valid_ptr ? __ldg(n_valid_ptr) : INT_MAX;
  int s0 = 0, s1 = 0, dst = 0;
  if (r < n_ranks) {
    s0 = __ldg(excl + r);
    s1 = max(min(s0 + max(__ldg(counts + r), 0), limit), s0);
    dst = __ldg(order + r);
  }
  const bool is_long = s1 - s0 > kShort;
  if (!is_long) {
    const float4 sum =
        group_fold<kWidth, kSub>(rows, inv_perm, s0, s1, n_valid, sl, mask);
    if (r < n_ranks && sl < kLanes) {
      out[static_cast<int64_t>(dst) * kLanes + sl] = sum;
    }
  }
  if constexpr (kSub < 32) {
    // the long runs of the warp's ranks, one after another, in rank order
    unsigned longs = __ballot_sync(kFull, is_long && sl == 0);
    while (longs) {
      const int leader = __ffs(longs) - 1;
      longs &= longs - 1u;
      const int a = __shfl_sync(kFull, s0, leader);
      const int b = __shfl_sync(kFull, s1, leader);
      const int d = __shfl_sync(kFull, dst, leader);
      const float4 sum =
          group_fold<kWidth, 32>(rows, inv_perm, a, b, n_valid, lane, kFull);
      if (lane < kLanes) out[static_cast<int64_t>(d) * kLanes + lane] = sum;
    }
  }
}

// The shared segment's column sums: cols[s] = sum over tiles t of
// rows[t P + s] for the slots s the runs cover. A block takes
// kGroups slots; warp w sums the tiles [w T / 8, (w + 1) T / 8) with
// kChunk loads in flight; the warps' sums are added in warp order.
template <int kWidth>
__global__ void __launch_bounds__(kThreads)
segment_cols_kernel(const float* __restrict__ d_records,   // [T P, kWidth]
                    const int32_t* __restrict__ excl,
                    const int32_t* __restrict__ counts,
                    int n_ranks, int limit, int n_tiles, int n_slots,
                    float* __restrict__ cols) {            // [P, kWidth]
  constexpr int kLanes = kWidth / 4;
  constexpr int kGroups = 32 / kLanes;
  __shared__ float4 s_part[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = lane % kLanes;
  const int slot = blockIdx.x * kGroups + lane / kLanes;
  // the runs end where the last rank's ends (consecutive runs)
  const int end = min(__ldg(excl + n_ranks - 1) +
                          max(__ldg(counts + n_ranks - 1), 0), limit);
  if (blockIdx.x * kGroups >= end) return;  // the whole block
  const bool live = slot < end;
  const int64_t col = live ? slot : 0;
  const float4* rows = reinterpret_cast<const float4*>(d_records);
  const int t0 = static_cast<int>(static_cast<int64_t>(n_tiles) * warp /
                                  kWarps);
  const int t1 = static_cast<int>(static_cast<int64_t>(n_tiles) *
                                  (warp + 1) / kWarps);
  constexpr int kIn = 8;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = t0; t < t1; t += kIn) {
    float4 v[kIn];
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      v[i] = (live && t + i < t1)
                 ? __ldg(rows + ((t + i) * static_cast<int64_t>(n_slots) +
                                 col) * kLanes + q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kIn; ++i) add4(acc, v[i]);
  }
  s_part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && live) {
    float4 sum = s_part[0][lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) add4(sum, s_part[k][lane]);
    reinterpret_cast<float4*>(cols)[static_cast<int64_t>(slot) * kLanes +
                                    q] = sum;
  }
}

__global__ void invert_kernel(const int32_t* __restrict__ perm, int n,
                              int32_t* __restrict__ inv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) inv[perm[i]] = i;
}

template <int kWidth, int kSub>
void launch_sub(const float* rows, const int32_t* inv_perm,
                const int32_t* order, const int32_t* excl,
                const int32_t* counts, int n_ranks, int limit,
                const int32_t* n_valid, float* d_table, cudaStream_t st) {
  constexpr int kRanks = kWarps * (32 / kSub);  // a block's ranks
  fold_kernel<kWidth, kSub><<<(n_ranks + kRanks - 1) / kRanks, kThreads, 0,
                              st>>>(rows, inv_perm, order, excl, counts,
                                    n_ranks, limit, n_valid, d_table);
}

// lanes per rank: 8 or 32 (16-wide rows), 16 or 32 (64-wide); false for
// another
template <int kWidth>
bool launch_fold(int lanes, const float* rows, const int32_t* inv_perm,
                 const int32_t* order, const int32_t* excl,
                 const int32_t* counts, int n_ranks, int limit,
                 const int32_t* n_valid, float* d_table, cudaStream_t st) {
  switch (lanes) {
    case 8:
      if constexpr (kWidth == 16) {
        launch_sub<kWidth, 8>(rows, inv_perm, order, excl, counts, n_ranks,
                              limit, n_valid, d_table, st);
        return true;
      }
      return false;
    case 16:
      if constexpr (kWidth == 64) {
        launch_sub<kWidth, 16>(rows, inv_perm, order, excl, counts, n_ranks,
                               limit, n_valid, d_table, st);
        return true;
      }
      return false;
    case 32:
      launch_sub<kWidth, 32>(rows, inv_perm, order, excl, counts, n_ranks,
                             limit, n_valid, d_table, st);
      return true;
    default:
      return false;
  }
}

template <int kWidth>
void launch_segment(const float* d_records, const int32_t* order,
                    const int32_t* excl,
                    const int32_t* counts, int n_ranks, int limit,
                    int n_tiles, int n_slots, float* cols, float* d_table,
                    cudaStream_t st) {
  constexpr int kGroups = 32 / (kWidth / 4);
  const int blocks = (n_slots + kGroups - 1) / kGroups;
  segment_cols_kernel<kWidth><<<blocks, kThreads, 0, st>>>(
      d_records, excl, counts, n_ranks, limit, n_tiles, n_slots, cols);
  // the column sums sit at their slots: the fold reads them in slot order
  launch_fold<kWidth>(kWidth / 4 > 8 ? kWidth / 4 : 8, cols, nullptr, order,
                      excl, counts, n_ranks, limit, nullptr, d_table, st);
}

}  // namespace

// width: the record width, 16 (the RGB records) or 64 (NHT); lanes: the
// lanes a rank takes (8 or 32 at width 16, 16 or 32 at 64). n_valid: a device
// int, the rows below it are read (null: all).
extern "C" int fold_launch(const float* d_records, const int32_t* inv_perm,
                           const int32_t* order, const int32_t* excl,
                           const int32_t* counts, int n_ranks, int limit,
                           int width, int lanes, const int32_t* n_valid,
                           float* d_table, void* stream) {
  if (n_ranks > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const bool ok =
        width == 16 ? launch_fold<16>(lanes, d_records, inv_perm, order,
                                      excl, counts, n_ranks, limit, n_valid,
                                      d_table, st)
        : width == 64 ? launch_fold<64>(lanes, d_records, inv_perm, order,
                                        excl, counts, n_ranks, limit,
                                        n_valid, d_table, st)
                      : false;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// inv[perm[i]] = i for i < n.
extern "C" int fold_invert_launch(const int32_t* perm, int n, int32_t* inv,
                                  void* stream) {
  if (n > 0) {
    invert_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(perm, n, inv);
  }
  return static_cast<int>(cudaGetLastError());
}

// The shared-segment fold: d_records [n_tiles * n_slots, width], the
// segment's fold in rank order (order, excl, counts [n_ranks], limit <=
// n_slots); cols [n_slots, width] is scratch.
extern "C" int fold_segment_launch(const float* d_records,
                                   const int32_t* order, const int32_t* excl,
                                   const int32_t* counts, int n_ranks,
                                   int limit, int n_tiles, int n_slots,
                                   int width, float* cols, float* d_table,
                                   void* stream) {
  if (width != 16 && width != 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ranks > 0 && n_slots > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    if (width == 16) {
      launch_segment<16>(d_records, order, excl, counts, n_ranks, limit,
                         n_tiles, n_slots, cols, d_table, st);
    } else {
      launch_segment<64>(d_records, order, excl, counts, n_ranks, limit,
                         n_tiles, n_slots, cols, d_table, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
