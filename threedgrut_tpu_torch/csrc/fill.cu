// Kernel H: segmented forward fill.
//
// Replaces threedgrut_tpu/ops/pallas/fill.py:_fill_kernel (reached through
// forward_fill and segmented_fill_rows). Every slot l takes the values of
// the last marked slot at or before it, and zeros before the first mark.
// The TPU kernel scans slabs of 8192 lanes with a Hillis-Steele "keep last
// marked" pass and threads its carry from one slab to the next in VMEM,
// which works only because the TPU grid runs in order. Here no block
// waits for another and none depends on the order blocks run in:
//   1. each span of kSpan slots gets its aggregate, the last marked
//      position in it (or -1): fill_aggregate_kernel reads the marks a
//      warp a span, 16 bytes a load (an atomicMax a row on its span's
//      aggregate, in the scatter, took 4x as long: ~100 rows share one);
//   2. fill_write_kernel, a block a span: its carry, the last marked
//      position before it, is the largest aggregate before it: the one
//      of the span before where set (positions grow with the span, so
//      the nearest set aggregate is the largest), else read 256 at a
//      time backwards until one is set; a block max-scan of its
//      own marks gives each slot's source row, staged in shared memory;
//      then copy_rows.cuh writes the span's rows as contiguous runs
//      (float4s where the width is a multiple of 4), with 32-bit index
//      math inside the block and 64 bits only for the block's base and
//      each gathered row's.
// Two modes: forward_fill marks slots with a bool array and a slot's
// source row is the slot itself; segmented_fill_rows first scatters row
// indices into an int array `sel` (-1 = unmarked; where two rows share a
// slot, atomicMax keeps the larger row index, the last in input order,
// whatever the order the threads run in) and a slot's source row is
// sel[l]. Values are copied, never combined: the result equals the plain
// cummax-and-gather version bit for bit.
//
// Bound on this card: memory. It reads the marks (1 or 4 bytes a slot;
// twice, the second time from L2) and each marked row once, and writes
// length x D floats; the aggregates are 4 bytes a span. forward_fill
// comes within ~1.5x of its bytes; segmented_fill_rows adds the memset
// of sel, the scatter and the check's read-back (PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "copy_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                     // consecutive slots a thread
constexpr int kSpan = kThreads * kItems;      // slots a block (and span)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// inclusive max-scan over the block's threads; returns the exclusive value
// (the max of the threads before this one, or -1)
__device__ __forceinline__ int block_exclusive_max(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = max(incl, up);
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = -1;
  for (int w = 0; w < warp; ++w) before = max(before, warp_tot[w]);
  const int excl_in_warp = __shfl_up_sync(0xffffffffu, incl, 1);
  return max(before, lane > 0 ? excl_in_warp : -1);
}

// the largest aggregate of the spans before span b (-1 for none), read
// kThreads at a time backwards from b - 1 until one is set; red is
// kWarps ints of shared memory, free again on return
__device__ int block_carry(const int32_t* __restrict__ agg, int b,
                           int* red) {
  int carry = -1;
  for (int hi = b; hi > 0; hi -= kThreads) {
    const int j = hi - 1 - static_cast<int>(threadIdx.x);
    const int v = warp_max(j >= 0 ? agg[j] : -1);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) carry = max(carry, red[w]);
    __syncthreads();
    if (carry >= 0) break;  // the same in every thread
  }
  return carry;
}

// pos[i] = l0 + i if slot l0 + i is marked, else -1 (slots past length
// unmarked); `words`: marked is 4-byte aligned
template <bool kSel>
__device__ __forceinline__ void load_marks(const uint8_t* __restrict__ marked,
                                           const int32_t* __restrict__ sel,
                                           int l0, int length, bool words,
                                           int (&pos)[kItems]) {
  if (l0 + kItems <= length && (kSel || words)) {
    if (kSel) {  // sel is the wrapper's own 16-byte aligned workspace
      const int4 v = *reinterpret_cast<const int4*>(sel + l0);
      pos[0] = v.x >= 0 ? l0 : -1;
      pos[1] = v.y >= 0 ? l0 + 1 : -1;
      pos[2] = v.z >= 0 ? l0 + 2 : -1;
      pos[3] = v.w >= 0 ? l0 + 3 : -1;
    } else {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(marked + l0);
      for (int i = 0; i < kItems; ++i) {
        pos[i] = ((v >> (8 * i)) & 0xffu) != 0u ? l0 + i : -1;
      }
    }
    return;
  }
  for (int i = 0; i < kItems; ++i) {
    const int l = l0 + i;
    bool m = false;
    if (l < length) m = kSel ? sel[l] >= 0 : marked[l] != 0;
    pos[i] = m ? l : -1;
  }
}

// agg[b] = the last marked position of span b, or -1: a warp a span,
// 16 bytes a load (16 bool marks, 4 of sel), every load of a lane in
// flight at once; `quads`: the marks are 16-byte aligned
template <bool kSel>
__global__ void __launch_bounds__(kThreads)
fill_aggregate_kernel(const uint8_t* __restrict__ marked,
                      const int32_t* __restrict__ sel, int length,
                      int spans, bool quads, int32_t* __restrict__ agg) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= spans) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int b0 = b * kSpan;
  int last = -1;
  if ((kSel || quads) && b0 + kSpan <= length) {
    constexpr int kPer = 16 / (kSel ? 4 : 1);   // marks a load
    constexpr int kLoads = kSpan / kPer / 32;   // loads a lane
    const uint4* q = kSel ? reinterpret_cast<const uint4*>(sel + b0)
                          : reinterpret_cast<const uint4*>(marked + b0);
    uint4 v[kLoads];
    for (int h = 0; h < kLoads; ++h) v[h] = q[lane + 32 * h];
    for (int h = 0; h < kLoads; ++h) {  // positions grow with h and j
      const uint32_t w[4] = {v[h].x, v[h].y, v[h].z, v[h].w};
      const int base = b0 + kPer * (lane + 32 * h);
      for (int j = 0; j < 4; ++j) {
        if (kSel) {
          if (static_cast<int32_t>(w[j]) >= 0) last = base + j;
        } else if (w[j]) {
          last = base + 4 * j + (31 - __clz(w[j])) / 8;
        }
      }
    }
  } else {
    const int n = min(kSpan, length - b0);
    for (int i = lane; i < n; i += 32) {
      if (kSel ? sel[b0 + i] >= 0 : marked[b0 + i] != 0) last = b0 + i;
    }
  }
  last = warp_max(last);
  if (lane == 0) agg[b] = last;
}

// 8 blocks an SM (at most 32 registers a thread), so that 2^20 slots
// take one wave
template <bool kSel>
__global__ void __launch_bounds__(kThreads, 8)
fill_write_kernel(const float* __restrict__ vals,       // [rows, D]
                  const uint8_t* __restrict__ marked,   // [length] or null
                  const int32_t* __restrict__ sel,      // [length] or null
                  const int32_t* __restrict__ agg,      // [spans]
                  int length, int width, bool words, bool vec,
                  float* __restrict__ out) {            // [length, D]
  __shared__ int warp_tot[kWarps];
  __shared__ int src_row[kSpan];
  const int b0 = blockIdx.x * kSpan;
  // thread t scans slots b0 + t kItems .. + kItems - 1; its marks are
  // loaded before the carry so that the two loads overlap
  int pos[kItems];
  load_marks<kSel>(marked, sel, b0 + threadIdx.x * kItems, length, words,
                   pos);
  // the span before holds the carry, unless it holds no mark
  const int b = blockIdx.x;
  int carry = b > 0 ? agg[b - 1] : -1;
  if (carry < 0 && b > 1) carry = block_carry(agg, b - 1, warp_tot);
  int run = -1;
  for (int i = 0; i < kItems; ++i) {
    run = max(run, pos[i]);
    pos[i] = run;
  }
  const int before = max(carry, block_exclusive_max(run, warp_tot));
  for (int i = 0; i < kItems; ++i) {
    const int p = max(before, pos[i]);
    int row = -1;
    if (p >= 0) row = kSel ? sel[p] : p;
    src_row[threadIdx.x * kItems + i] = row;
  }
  __syncthreads();
  copy_rows<kThreads>(vals, src_row, min(kSpan, length - b0), width, vec,
                      out + static_cast<int64_t>(b0) * width);
}

// sel[s] = the last row naming slot s; *neg = -1 - the least negative
// slot (stays -1 where there is none: the wrapper's check, read after
// the launch)
__global__ void fill_scatter_kernel(const int32_t* __restrict__ slots,
                                    int n_rows, int length,
                                    int32_t* __restrict__ sel,
                                    int32_t* __restrict__ neg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int s = slots[i];
  if (s < 0) {
    atomicMax(neg, -1 - s);
  } else if (s < length) {
    atomicMax(sel + s, i);
  }
}

int n_spans(int length) { return (length + kSpan - 1) / kSpan; }

}  // namespace

// forward_fill: vals [length, width], marked [length] (bytes, 0 or 1);
// agg [n_agg >= the spans of length] is workspace.
extern "C" int fill_launch(const float* vals, const uint8_t* marked,
                           int length, int width, int32_t* agg, int n_agg,
                           float* out, void* stream) {
  if (!copy_rows_width_ok(width, kSpan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (length <= 0) return static_cast<int>(cudaGetLastError());
  const int spans = n_spans(length);
  if (n_agg < spans) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool words = reinterpret_cast<uintptr_t>(marked) % 4 == 0;
  fill_aggregate_kernel<false><<<(spans + kWarps - 1) / kWarps, kThreads, 0,
                                  st>>>(
      marked, nullptr, length, spans,
      reinterpret_cast<uintptr_t>(marked) % 16 == 0, agg);
  fill_write_kernel<false><<<spans, kThreads, 0, st>>>(
      vals, marked, nullptr, agg, length, width, words,
      copy_rows_vec(vals, out, width), out);
  return static_cast<int>(cudaGetLastError());
}

// segmented_fill_rows: row_vals [n_rows, width] at row_slots [n_rows]
// (slots >= length dropped); ws [n_ws >= length + the spans of length +
// 1], 16-byte aligned, is workspace: sel, the aggregates, and last the
// negative-slot check (-1 - the least negative slot, or -1). Negative
// slots are dropped too; the wrapper raises for them.
extern "C" int fill_rows_launch(const float* row_vals,
                                const int32_t* row_slots, int n_rows,
                                int length, int width, int32_t* ws,
                                int64_t n_ws, float* out, void* stream) {
  if (!copy_rows_width_ok(width, kSpan) || length < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int spans = n_spans(length);
  const int64_t n_need = static_cast<int64_t>(length) + spans + 1;
  if (n_ws < n_need || reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  int32_t* sel = ws;
  int32_t* agg = ws + length;
  cudaError_t err = cudaMemsetAsync(
      ws, 0xff, sizeof(int32_t) * static_cast<size_t>(n_need), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0) {
    fill_scatter_kernel<<<(n_rows + kThreads - 1) / kThreads, kThreads, 0,
                          st>>>(row_slots, n_rows, length, sel,
                                ws + n_need - 1);
  }
  if (length > 0) {
    fill_aggregate_kernel<true><<<(spans + kWarps - 1) / kWarps, kThreads, 0,
                                  st>>>(
        nullptr, sel, length, spans, true, agg);
    fill_write_kernel<true><<<spans, kThreads, 0, st>>>(
        row_vals, nullptr, sel, agg, length, width, false,
        copy_rows_vec(row_vals, out, width), out);
  }
  return static_cast<int>(cudaGetLastError());
}
