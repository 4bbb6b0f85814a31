// Kernel G: broadcast rows onto their sorted, disjoint slot intervals.
//
// Replaces threedgrut_tpu/ops/pallas/expand.py:_expand_kernel (reached
// through expand_sorted_rows from ops/binning.py:_tile_interval_expand).
// out[l] = rows[k] for the source k whose interval [starts[k], ends[k])
// holds slot l, and 0 where no interval does. The TPU kernel forms it as
// an interval-mask matmul on the MXU (each output lane column selects one
// source row), because XLA lowers gathers to scalar loops; on Hopper a
// gather is cheap, so each output slot finds its source by a binary
// search of starts: the last k with starts[k] <= l (with starts and ends
// both non-decreasing, no other interval can hold l), covered when
// l < ends[k]. One thread per slot balances the two shapes the JAX
// package gives it, ~100k short intervals (the pair expansion: 1-100
// slots each) and ~2,500 long ones (the tile intervals: hundreds of
// slots); a thread per source row would leave one thread with a whole
// tile's slots.
//
// Layout: a warp takes 32 consecutive slots. Each lane searches its slot's
// source, then the warp writes the 32 x D output floats as contiguous
// 128-byte runs, each lane taking the source of element e from the lane
// that searched slot e / D by a shuffle.
//
// Exact: values are copied, never combined, so ids carried as floats pass
// through bit for bit, as the TPU kernel's HIGHEST-precision select does.
//
// Bound on this card: memory. It reads the K x D rows and the two K-long
// bound arrays once and writes length x D floats; the ~17 steps of each
// binary search hit L2 (starts is at most a few hundred KB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const float* __restrict__ rows,      // [K, D]
                   const int32_t* __restrict__ starts,  // [K]
                   const int32_t* __restrict__ ends,    // [K]
                   int n_src, int width, int length,
                   float* __restrict__ out) {           // [length, D]
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  if (base >= length) return;  // the whole warp leaves together
  const int64_t l = base + lane;
  int src = -1;
  if (l < length) {
    int lo = 0, hi = n_src;  // first k with starts[k] > l
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (starts[mid] <= l) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    src = lo - 1;
    if (src >= 0 && l >= ends[src]) src = -1;
  }
  const int64_t rest = length - base;
  const int n_slots = rest < 32 ? static_cast<int>(rest) : 32;
  const int n_elems = n_slots * width;
  float* dst = out + base * width;
  // every lane runs every round, so the shuffle sees the full warp
  for (int e0 = 0; e0 < n_elems; e0 += 32) {
    const int e = e0 + lane;
    const int slot = min(e / width, 31);
    const int k = __shfl_sync(0xffffffffu, src, slot);
    if (e < n_elems) {
      const int c = e - slot * width;
      dst[e] = k >= 0 ? rows[static_cast<int64_t>(k) * width + c] : 0.f;
    }
  }
}

}  // namespace

extern "C" int expand_rows_launch(const float* rows, const int32_t* starts,
                                  const int32_t* ends, int n_src, int width,
                                  int length, float* out, void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (length > 0) {
    const int64_t warps = (static_cast<int64_t>(length) + 31) / 32;
    const int64_t blocks = (warps + kWarps - 1) / kWarps;
    expand_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rows, starts, ends, n_src, width, length, out);
  }
  return static_cast<int>(cudaGetLastError());
}
