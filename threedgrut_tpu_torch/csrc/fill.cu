// Kernel H: segmented forward fill.
//
// Replaces threedgrut_tpu/ops/pallas/fill.py:_fill_kernel (reached through
// forward_fill and segmented_fill_rows). Every slot l takes the values of
// the last marked slot at or before it, and zeros before the first mark.
// The TPU kernel scans slabs of 8192 lanes with a Hillis-Steele "keep last
// marked" pass and threads its carry from one slab to the next in VMEM,
// which works only because the TPU grid runs in order. Here the carry is
// an explicit pass, never block order:
//   1. fill_aggregate_kernel: each block of 1,024 slots writes the last
//      marked position in it (or -1);
//   2. fill_carry_kernel: one block scans those aggregates into each
//      block's carry, the last marked position before it (a max-scan);
//   3. fill_write_kernel: each block scans its own slots again, takes the
//      carry, and writes every slot's source row, D floats a slot, the
//      block's output written as contiguous runs.
// Two modes: forward_fill marks slots with a bool array and a slot's
// source row is the slot itself; segmented_fill_rows first scatters row
// indices into an int array `sel` (-1 = unmarked; where two rows share a
// slot, atomicMax keeps the larger row index, the last in input order,
// whatever the order the threads run in) and a slot's source row is
// sel[l]. Values are copied, never combined: the result equals the plain
// cummax-and-gather version bit for bit.
//
// Bound on this card: memory. It reads the marks (1 or 4 bytes a slot)
// twice and the source rows once, and writes length x D floats; the
// aggregates are 4 bytes per 1,024 slots.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                     // consecutive slots a thread
constexpr int kSpan = kThreads * kItems;      // slots a block
constexpr int kWarps = kThreads / 32;

// the position l if slot l is marked, else -1
template <bool kSel>
__device__ __forceinline__ int mark_pos(const uint8_t* marked,
                                        const int32_t* sel, int64_t l) {
  if (kSel) return sel[l] >= 0 ? static_cast<int>(l) : -1;
  return marked[l] ? static_cast<int>(l) : -1;
}

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

template <bool kSel>
__global__ void __launch_bounds__(kThreads)
fill_aggregate_kernel(const uint8_t* __restrict__ marked,
                      const int32_t* __restrict__ sel, int length,
                      int32_t* __restrict__ agg) {
  __shared__ int warp_tot[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSpan;
  int last = -1;
  for (int i = 0; i < kItems; ++i) {
    const int64_t l = base + i * kThreads + threadIdx.x;  // coalesced
    if (l < length) last = max(last, mark_pos<kSel>(marked, sel, l));
  }
  last = warp_max(last);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = -1;
    for (int w = 0; w < kWarps; ++w) m = max(m, warp_tot[w]);
    agg[blockIdx.x] = m;
  }
}

// one block: carry[b] = max(agg[0 .. b - 1]), -1 for none
__global__ void __launch_bounds__(kThreads)
fill_carry_kernel(const int32_t* __restrict__ agg, int n_blocks,
                  int32_t* __restrict__ carry) {
  __shared__ int warp_tot[kWarps];
  int run = -1;
  for (int b0 = 0; b0 < n_blocks; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    const int v = b < n_blocks ? agg[b] : -1;
    const int excl = block_exclusive_max(v, warp_tot);
    if (b < n_blocks) carry[b] = max(run, excl);
    __syncthreads();
    // the round's total: the last thread's inclusive value
    if (threadIdx.x == kThreads - 1) warp_tot[0] = max(excl, v);
    __syncthreads();
    run = max(run, warp_tot[0]);
    __syncthreads();
  }
}

template <bool kSel>
__global__ void __launch_bounds__(kThreads)
fill_write_kernel(const float* __restrict__ vals,       // [rows, D]
                  const uint8_t* __restrict__ marked,   // [length] or null
                  const int32_t* __restrict__ sel,      // [length] or null
                  const int32_t* __restrict__ carry,    // [n_blocks]
                  int length, int width,
                  float* __restrict__ out) {            // [length, D]
  __shared__ int warp_tot[kWarps];
  __shared__ int src_row[kSpan];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSpan;
  // thread t scans slots base + t kItems .. + kItems - 1
  int pos[kItems];
  int run = -1;
  for (int i = 0; i < kItems; ++i) {
    const int64_t l = base + threadIdx.x * kItems + i;
    if (l < length) run = max(run, mark_pos<kSel>(marked, sel, l));
    pos[i] = run;
  }
  const int before = max(carry[blockIdx.x],
                         block_exclusive_max(run, warp_tot));
  for (int i = 0; i < kItems; ++i) {
    const int p = max(before, pos[i]);
    int row = -1;
    if (p >= 0) row = kSel ? sel[p] : p;
    src_row[threadIdx.x * kItems + i] = row;
  }
  __syncthreads();
  const int64_t rest = length - base;
  const int n_slots = rest < kSpan ? static_cast<int>(rest) : kSpan;
  const int64_t n_elems = static_cast<int64_t>(n_slots) * width;
  float* dst = out + base * width;
  for (int64_t e = threadIdx.x; e < n_elems; e += kThreads) {
    const int slot = static_cast<int>(e / width);
    const int c = static_cast<int>(e - static_cast<int64_t>(slot) * width);
    const int row = src_row[slot];
    dst[e] = row >= 0 ? vals[static_cast<int64_t>(row) * width + c] : 0.f;
  }
}

__global__ void fill_scatter_kernel(const int32_t* __restrict__ slots,
                                    int n_rows, int length,
                                    int32_t* __restrict__ sel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int s = slots[i];
  if (s >= 0 && s < length) atomicMax(sel + s, i);
}

template <bool kSel>
int run_fill(const float* vals, const uint8_t* marked, const int32_t* sel,
             int length, int width, int32_t* agg, int32_t* carry,
             float* out, cudaStream_t st) {
  const int n_blocks = (length + kSpan - 1) / kSpan;
  fill_aggregate_kernel<kSel><<<n_blocks, kThreads, 0, st>>>(
      marked, sel, length, agg);
  fill_carry_kernel<<<1, kThreads, 0, st>>>(agg, n_blocks, carry);
  fill_write_kernel<kSel><<<n_blocks, kThreads, 0, st>>>(
      vals, marked, sel, carry, length, width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of blocks (the length of the agg and carry workspaces) of a
// fill over `length` slots.
extern "C" int fill_blocks(int length) { return (length + kSpan - 1) / kSpan; }

// forward_fill: vals [length, width], marked [length] (bytes, 0 or 1).
extern "C" int fill_launch(const float* vals, const uint8_t* marked,
                           int length, int width, int32_t* agg,
                           int32_t* carry, float* out, void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (length <= 0) return static_cast<int>(cudaGetLastError());
  return run_fill<false>(vals, marked, nullptr, length, width, agg, carry,
                         out, static_cast<cudaStream_t>(stream));
}

// segmented_fill_rows: row_vals [n_rows, width] at row_slots [n_rows]
// (slots outside [0, length) dropped); sel [length] is workspace.
extern "C" int fill_rows_launch(const float* row_vals,
                                const int32_t* row_slots, int n_rows,
                                int length, int width, int32_t* sel,
                                int32_t* agg, int32_t* carry, float* out,
                                void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (length <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(sel, 0xff, sizeof(int32_t) * length, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0) {
    fill_scatter_kernel<<<(n_rows + kThreads - 1) / kThreads, kThreads, 0,
                          st>>>(row_slots, n_rows, length, sel);
  }
  return run_fill<true>(row_vals, nullptr, sel, length, width, agg, carry,
                        out, st);
}
