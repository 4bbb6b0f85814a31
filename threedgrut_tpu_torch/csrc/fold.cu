// Kernel D: fold per-pair record gradients into the per-particle table.
//
// Replaces threedgrut_tpu/ops/pallas/fold.py:_fold_wide_kernel (reached
// through fold_sorted_intervals_wide from render/gut.py:_grf_bwd) together
// with _grf_bwd's un-permute gather and its rank -> particle map. Depth
// rank r owns the pre-tile-sort pair slots [excl[r], min(excl[r] +
// counts[r], limit)); pre-sort slot s sits at tile-sorted position
// inv_perm[s]. The TPU kernel encodes ranks as f32 labels and segment-sums
// with an equality-mask matmul on the MXU, because XLA lowers a
// scatter-add to a scalar loop; on Hopper a gather is cheap, so this
// kernel gives each rank one warp: the two half-warps stride over the
// rank's slots (lane l reads field l % 16 of every other slot, 64 B rows,
// coalesced per half-warp), gathering d_records[inv_perm[s]] (the
// un-permute is fused), then one shuffle adds the two halves and lanes
// 0-15 write the 16 fields of row order[r] of d_table.
//
// Determinism: no atomics. Every particle row is written exactly once (the
// ranks are a permutation of the capacity rows; a rank with no slots,
// e.g. an invalid or inactive particle, writes zeros) and each row's sum
// is taken in one fixed order, so the gradient is bitwise the same run to
// run.
//
// Bound on this card: memory. It reads each pair's 64 B gradient row once
// through the inv_perm gather (a pair run of one particle is scattered
// over its tiles' segments, so the reads are 64 B random accesses) and
// writes 64 B per particle; at ~0.6M pairs and 100k particles that is
// ~45 MB, tens of microseconds at HBM rate. Long slot runs (a large splat
// owns ~100 slots) serialise on one warp; the design accepts that.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRec = gut::kRec;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ d_records,   // [P, 16] tile-sorted
            const int32_t* __restrict__ inv_perm,  // [P] pre slot -> sorted
            const int32_t* __restrict__ order,     // [N] rank -> particle
            const int32_t* __restrict__ excl,      // [N] first slot per rank
            const int32_t* __restrict__ counts,    // [N] slots per rank
            int n_ranks, int limit,
            float* __restrict__ d_table) {         // [N, 16]
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_ranks) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int f = lane & (kRec - 1);
  const int half = lane >> 4;
  const int s0 = excl[r];
  const int s1 = min(s0 + max(counts[r], 0), limit);
  float acc = 0.f;
  for (int s = s0 + half; s < s1; s += 2) {
    acc += d_records[static_cast<int64_t>(inv_perm[s]) * kRec + f];
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  if (half == 0) {
    d_table[static_cast<int64_t>(order[r]) * kRec + f] = acc;
  }
}

}  // namespace

extern "C" int fold_launch(const float* d_records, const int32_t* inv_perm,
                           const int32_t* order, const int32_t* excl,
                           const int32_t* counts, int n_ranks, int limit,
                           float* d_table, void* stream) {
  if (n_ranks > 0) {
    const int blocks = (n_ranks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    fold_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        d_records, inv_perm, order, excl, counts, n_ranks, limit, d_table);
  }
  return static_cast<int>(cudaGetLastError());
}
