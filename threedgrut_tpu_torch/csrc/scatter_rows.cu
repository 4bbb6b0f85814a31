// Kernel F: accumulate per-pair record rows into a per-particle table.
//
// Replaces threedgrut_tpu/ops/pallas/scatter.py:_scatter_kernel (reached
// through scatter_accumulate_rows from raster.py:_rasterize_table_bwd).
// The TPU kernel walks the pairs in order and adds each one's row into a
// table held in VMEM, packed 8 particles to a 128-lane row; its
// read-modify-write is race-free only because the TPU grid runs one step
// after another. CUDA blocks run at once, so this kernel takes the pairs
// in a stable order by particle id (set-up: one torch.sort of the ids,
// which keeps pair order within each id, and the run boundaries
// row_start[r] .. row_start[r + 1] of every table row) and gives each
// table row a half-warp: lane f < R sums field f of the row's pairs,
// d_rows[perm[j]][f] for j in its run, one after another, and writes it.
//
// Determinism: no atomics. Each table row is written once (a row with no
// pairs writes zeros) and each field's sum is taken in pair order, one
// fp32 add at a time: the order of the TPU's sequential loop, so the
// result equals a sequential fp32 accumulation in pair order bit for bit,
// run after run.
//
// Bound on this card: memory. The kernel reads each pair's R floats once
// through the perm gather (the rows of one particle lie wherever its
// tiles' pairs lie: 4R-byte random reads) and the sorted order, and
// writes the table once; at ~0.7M pairs x 16 and 100k rows that is ~50
// MB, ~15 us at HBM rate. Long runs (a large splat owns ~100 pairs)
// serialise on one half-warp; the loop issues four rows' loads before it
// adds them, in order, to keep more reads in flight.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 16;  // R <= 16
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ d_rows,     // [P, R]
                    const int32_t* __restrict__ perm,     // [P] id order
                    const int32_t* __restrict__ row_start,  // [n_rows + 1]
                    int n_rows, int width,
                    float* __restrict__ out) {            // [n_rows, R]
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  if (r >= n_rows) return;  // the whole half-warp leaves together
  const int f = threadIdx.x % kLanesPerRow;
  const int s1 = row_start[r + 1];
  int j = row_start[r];
  float acc = 0.f;
  if (f < width) {
    for (; j + 4 <= s1; j += 4) {
      const float v0 = d_rows[static_cast<int64_t>(perm[j]) * width + f];
      const float v1 = d_rows[static_cast<int64_t>(perm[j + 1]) * width + f];
      const float v2 = d_rows[static_cast<int64_t>(perm[j + 2]) * width + f];
      const float v3 = d_rows[static_cast<int64_t>(perm[j + 3]) * width + f];
      acc += v0;
      acc += v1;
      acc += v2;
      acc += v3;
    }
    for (; j < s1; ++j) {
      acc += d_rows[static_cast<int64_t>(perm[j]) * width + f];
    }
    out[static_cast<int64_t>(r) * width + f] = acc;
  }
}

}  // namespace

// width: the record width R, 1..16.
extern "C" int scatter_rows_launch(const float* d_rows, const int32_t* perm,
                                   const int32_t* row_start, int n_rows,
                                   int width, float* out, void* stream) {
  if (width < 1 || width > kLanesPerRow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0) {
    const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
    scatter_rows_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        d_rows, perm, row_start, n_rows, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
