// Kernel G: broadcast rows onto their sorted, disjoint slot intervals.
//
// Replaces threedgrut_tpu/ops/pallas/expand.py:_expand_kernel (reached
// through expand_sorted_rows from ops/binning.py:_tile_interval_expand).
// out[l] = rows[k] for the source k whose interval [starts[k], ends[k])
// holds slot l, and 0 where no interval does. The TPU kernel forms it as
// an interval-mask matmul on the MXU (each output lane column selects one
// source row), because XLA lowers gathers to scalar loops; on Hopper a
// gather is cheap. With starts and ends both non-decreasing, slot l's
// only candidate is the last k with starts[k] <= l, covering l when
// l < ends[k].
//
// Bound on this card: memory. It reads the K x D rows and the two K-long
// bound arrays once and writes length x D floats. Design: a block of 256
// threads takes kSpan consecutive slots, so one search serves a block:
//   1. two warps find the block's sources, [k_lo, k_hi): the last k whose
//      start is at or before the first slot, and the first whose start
//      is past the last slot, each by a 32-way search of starts (32
//      probes a round, ~log32 K dependent loads: 4 at 100k rows, 3 at
//      2,500);
//   2. their starts and ends are staged in shared memory, and each slot
//      finds its source there by a binary search (a block spanned by more
//      than kStage sources, a run of empty intervals, searches starts in
//      [k_lo, k_hi) in global memory instead);
//   3. copy_rows.cuh writes the block's rows as contiguous runs, float4s
//      at widths that are multiples of 4 (the pair expansion's 16), with
//      no division per element (the tile expansion's width 3).
// The two shapes the JAX package gives it, ~100k short intervals (1-100
// slots) and ~2,500 long ones (hundreds of slots), take the same path:
// the first comes within ~1.3x of its bytes, the second, a few MB, is
// set by the launch and the search's dependent loads (PERF.md §6).
//
// Exact: values are copied, never combined, so ids carried as floats pass
// through bit for bit, as the TPU kernel's HIGHEST-precision select does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "copy_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 1024;   // slots a block
constexpr int kStage = 1024;  // sources a block stages in shared memory

// the first k in [0, n) with a[k] > x (n if none), by one warp: each round
// probes 32 evenly spaced keys and keeps the step between the last probe
// at or below x and the first above it
__device__ int warp_upper_bound(const int32_t* __restrict__ a, int n,
                                int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // a[k] <= x below lo, a[k] > x from hi on
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int probe = min(lo + (lane + 1) * step, hi) - 1;
    const unsigned above = __ballot_sync(0xffffffffu, a[probe] > x);
    if (above == 0u) return hi;  // a[hi - 1] <= x
    const int f = __ffs(above) - 1;
    hi = min(lo + (f + 1) * step, hi) - 1;
    lo = f == 0 ? lo : lo + f * step;
  }
  const bool above = lo + lane < hi && a[lo + lane] > x;
  const unsigned m = __ballot_sync(0xffffffffu, above);
  return m ? lo + __ffs(m) - 1 : hi;
}

// the last index i in [lo, hi) with a[i] <= x, or lo - 1
__device__ __forceinline__ int last_at_or_below(const int32_t* a, int lo,
                                                int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const float* __restrict__ rows,      // [K, D]
                   const int32_t* __restrict__ starts,  // [K]
                   const int32_t* __restrict__ ends,    // [K]
                   int n_src, int width, int length, bool vec,
                   float* __restrict__ out) {           // [length, D]
  __shared__ int32_t s_start[kStage];
  __shared__ int32_t s_end[kStage];
  __shared__ int src[kSpan];
  __shared__ int range[2];
  const int b0 = blockIdx.x * kSpan;
  const int n_slots = min(kSpan, length - b0);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int x = warp == 0 ? b0 : b0 + n_slots - 1;
    const int k = warp_upper_bound(starts, n_src, x);
    if ((threadIdx.x & 31) == 0) range[warp] = warp == 0 ? max(k - 1, 0) : k;
  }
  __syncthreads();
  const int k_lo = range[0];
  const int n_stage = range[1] - k_lo;
  const bool staged = n_stage <= kStage;
  if (staged) {
    for (int i = threadIdx.x; i < n_stage; i += kThreads) {
      s_start[i] = starts[k_lo + i];
      s_end[i] = ends[k_lo + i];
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_slots; s += kThreads) {
    const int l = b0 + s;
    int k;
    if (staged) {
      k = last_at_or_below(s_start, 0, n_stage, l);
      k = k >= 0 && l < s_end[k] ? k_lo + k : -1;
    } else {
      k = last_at_or_below(starts, k_lo, k_lo + n_stage, l);
      k = k >= k_lo && l < ends[k] ? k : -1;
    }
    src[s] = k;
  }
  __syncthreads();
  copy_rows<kThreads>(rows, src, n_slots, width, vec,
                      out + static_cast<int64_t>(b0) * width);
}

}  // namespace

extern "C" int expand_rows_launch(const float* rows, const int32_t* starts,
                                  const int32_t* ends, int n_src, int width,
                                  int length, float* out, void* stream) {
  if (!copy_rows_width_ok(width, kSpan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (length > 0) {
    const int blocks = (length + kSpan - 1) / kSpan;
    expand_rows_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rows, starts, ends, n_src, width, length,
        copy_rows_vec(rows, out, width), out);
  }
  return static_cast<int>(cudaGetLastError());
}
