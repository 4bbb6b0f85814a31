// Kernel F: accumulate per-pair record rows into a per-particle table,
// with its set-up: a counting sort of the pairs by id.
//
// Replaces threedgrut_tpu/ops/pallas/scatter.py:_scatter_kernel (reached
// through scatter_accumulate_rows from raster.py:_rasterize_table_bwd).
// The TPU kernel walks the pairs in order and adds each one's row into a
// table held in VMEM, packed 8 particles to a 128-lane row; its
// read-modify-write is race-free only because the TPU grid runs one step
// after another. CUDA blocks run at once, so the pairs are first grouped
// by particle id, and each table row then gets a half-warp that adds its
// run of pairs in pair order.
//
// Set-up (ops/cuda/scatter.py:id_runs), three launches and no library
// sort: the table has < 2^17 rows (100,096 at 800x800), so a counting
// sort fits.
//   1. id_count: an integer histogram of the ids; each pair keeps the
//      value its atomicAdd returned, its rank in its row's run (the
//      counts are the same every run, the ranks are not). Ids outside
//      [0, n_rows) are dropped here and never placed.
//   2. id_scan: row_start, the exclusive prefix sum of the counts
//      (n_rows + 1 entries), one block of 1,024 threads a tile of 4,096
//      counters; each block first sums every counter before its tile
//      itself, which under 2^17 rows is cheaper than a second pass.
//   3. id_place: perm[row_start[id] + rank] = j, no atomics.
// Each run then holds its row's pairs in the order the atomics ran, which
// for the 800x800 view's pairs is not pair order in most rows
// (chip_smoke.py phase 37 prints the share). The
// kernel puts each run back in ascending pair order before it sums it:
// a half-warp holds a run of up to 128 in registers, one index a lane in
// each of 1-8 registers, checks whether it is already in order (a shuffle
// and a vote) and otherwise sorts it with a bitonic network of ascending
// merges (shuffles for xor distances under 16, register swaps above); a
// longer run is sorted in place in perm by the same network over global
// memory, every merge ascending, so the missing elements past the run's
// end act as +infinity and are never touched. The pair indices of a run
// are distinct, so the sorted order is unique.
//
// Why not a stable set-up, which would leave every run in pair order and
// need no sort here: a stable LSD counting sort (two passes of 9 and 8
// bits over chunks of 2,048 pairs, each a histogram, a scan and a
// placement ranked by __match_any_sync; 7 launches) took 0.083 ms on the
// view's pairs against this set-up's 0.048-0.052, and 0.117 ms of device
// time with F's kernel against this design's 0.082 (H100 80GB HBM3, 700
// W; scripts/compare_tree_torch.py, both trees in one call). Sorting the
// runs costs the kernel ~0.006 ms.
//
// Why the result is bitwise the sequential order: after the sort, lane f
// < R of a row's half-warp adds field f of the run's rows one at a time,
// in ascending pair index, starting from 0 - the same fp32 additions in
// the same order as JAX's loop over the pairs (and as numpy's sequential
// np.add.at), whatever order the atomics placed them in. No float
// atomics: each table row is written once (a row with no pairs writes
// zeros), run after run.
//
// Bound on this card: memory, ~53 MB for 0.7M pairs x 16 onto 100k rows
// (0.016 ms at HBM rate). What it costs instead (chip_smoke.py phase 37,
// H100 80GB HBM3, 700 W, the view's 691,175 x 16 rows): the set-up's
// atomics and scattered writes (phase 37 prints its three kernels'
// device time) and, in the kernel, the latency of each run's dependent
// gathers (four loads issued before their four adds) and the sorting.
// The earlier design's stable torch.sort made F with its set-up 0.168 ms
// beside 0.040 ms for the kernel alone.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 16;  // R <= 16
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;
constexpr int kScanThreads = 1024;
constexpr int kScanTile = 4 * kScanThreads;   // counters per scan block
constexpr int kRegisterRun = 128;   // the longest run sorted in registers

__global__ void __launch_bounds__(kThreads)
id_count_kernel(const int32_t* __restrict__ ids, int64_t n_pairs, int n_rows,
                int32_t* __restrict__ count, int32_t* __restrict__ rank) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n_pairs) return;
  const int id = ids[j];
  if (id >= 0 && id < n_rows) rank[j] = atomicAdd(&count[id], 1);
}

// The sum of v over the block (kScanThreads threads), in every thread.
__device__ __forceinline__ int block_sum(int v, int32_t* s_warp) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if (lane == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = s_warp[lane];   // kScanThreads / 32 == 32 warp sums
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) {
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  __syncthreads();        // s_warp free again
  return t;
}

// row_start[r] = sum of count[0..r) for the kScanTile counters of tile
// blockIdx.x, and row_start[n_rows] in the last tile. Each block first
// sums every counter before its tile itself (under 2^17 rows the last of
// at most 32 tiles reads ~0.4 MB: no second pass over tile sums), then
// scans its own tile: four counters a thread, a warp scan of the thread
// sums, a scan of the 32 warp sums.
__global__ void __launch_bounds__(kScanThreads)
id_scan_kernel(const int32_t* __restrict__ count, int n_rows,
               int32_t* __restrict__ row_start) {
  constexpr int kWarps = kScanThreads / 32;
  static_assert(kWarps == 32, "one warp scans the warp sums");
  __shared__ int32_t s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kScanTile;
  int before = 0;
#pragma unroll 4
  for (int i = 4 * threadIdx.x; i < t0; i += kScanTile) {
    const int4 c = *reinterpret_cast<const int4*>(count + i);
    before += c.x + c.y + c.z + c.w;
  }
  before = block_sum(before, s_warp);
  const int i0 = t0 + 4 * threadIdx.x;
  int v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = i0 + q < n_rows ? count[i0 + q] : 0;
  const int local = v[0] + v[1] + v[2] + v[3];
  int incl = local;   // inclusive scan of the thread sums in the warp
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    s_warp[lane] = w;   // inclusive over the warps
  }
  __syncthreads();
  int run = before + (warp > 0 ? s_warp[warp - 1] : 0) + incl - local;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (i0 + q < n_rows) row_start[i0 + q] = run;
    run += v[q];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    row_start[n_rows] = before + s_warp[kWarps - 1];
  }
}

__global__ void __launch_bounds__(kThreads)
id_place_kernel(const int32_t* __restrict__ ids, int64_t n_pairs, int n_rows,
                const int32_t* __restrict__ row_start,
                const int32_t* __restrict__ rank,
                int32_t* __restrict__ perm) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n_pairs) return;
  const int id = ids[j];
  if (id < 0 || id >= n_rows) return;
  perm[row_start[id] + rank[j]] = static_cast<int32_t>(j);
}

// Sort run[0, n) ascending in place (shared or global memory); the
// half-warp of mask ``mask`` calls it with its lane l = 0..15. Bitonic,
// every merge ascending: the first step of the merge of blocks of size k
// compares i with its mirror i ^ (k - 1), the later steps i with i ^ d.
// A partner past the end holds +infinity and is already in place.
__device__ void sort_run_in_place(int32_t* run, int n, int l,
                                  unsigned mask) {
  for (int k = 2; k / 2 < n; k *= 2) {
    for (int d = k / 2; d >= 1; d /= 2) {
      const int flip = d == k / 2 ? k - 1 : d;
      for (int i = l; i < n; i += kLanesPerRow) {
        const int partner = i ^ flip;
        if (partner > i && partner < n) {
          const int a = run[i], b = run[partner];
          if (a > b) {
            run[i] = b;
            run[partner] = a;
          }
        }
      }
      __syncwarp(mask);   // this step's swaps are seen by the next
    }
  }
}

// The sum over a run of n <= 16 kK pairs, for the half-warp of mask
// ``mask``; lane l reads field l (l < width) and returns its sum. The
// run's pair indices ride kK registers a lane (element e = 16 q + l in
// key[q] of lane l) through the bitonic network of ascending merges over
// the smallest power of two span >= n: xor distances under 16 are
// shuffles, the others swap registers within the lane (the mirror step
// of a merge wider than 16 does both). Then the rows are added in the
// sorted order, four loads issued before their four adds.
template <int kK>
__device__ __forceinline__ float sum_run(const float* __restrict__ d_rows,
                                         const int32_t* run, int n, int width,
                                         int l, unsigned mask) {
  int key[kK];
#pragma unroll
  for (int q = 0; q < kK; ++q) {
    key[q] = 16 * q + l < n ? run[16 * q + l] : INT32_MAX;
  }
  // the placement's atomics mostly follow pair order: a run already in
  // order skips the network
  bool ordered = true;
#pragma unroll
  for (int q = 0; q < kK; ++q) {
    const int down = __shfl_down_sync(mask, key[q], 1, kLanesPerRow);
    const int head = q + 1 < kK
        ? __shfl_sync(mask, key[q + 1 < kK ? q + 1 : q], 0, kLanesPerRow)
        : INT32_MAX;
    ordered &= key[q] <= (l < kLanesPerRow - 1 ? down : head);
  }
  ordered = __all_sync(mask, ordered);
  int span = ordered ? 1 : 2;
  while (span > 1 && span < n) span *= 2;
#pragma unroll
  for (int k = 2; k <= 16 * kK; k *= 2) {
    if (k > span) break;
#pragma unroll
    for (int d = k / 2; d >= 1; d /= 2) {
      if (d == k / 2 && k > 16) {
        // mirror across registers: e ^ (k - 1) is lane l ^ 15 of
        // register q ^ (k / 16 - 1)
        const int qm = k / 16 - 1;
        int other[kK];
#pragma unroll
        for (int q = 0; q < kK; ++q) {
          other[q] = __shfl_xor_sync(mask, key[q ^ qm], 15, kLanesPerRow);
        }
#pragma unroll
        for (int q = 0; q < kK; ++q) {
          const bool low = ((16 * q) & (k / 2)) == 0;
          key[q] = low ? min(key[q], other[q]) : max(key[q], other[q]);
        }
      } else if (d >= 16) {
        const int qd = d / 16;
#pragma unroll
        for (int q = 0; q < kK; ++q) {
          if ((q & qd) == 0) {
            const int a = key[q], b = key[q | qd];
            key[q] = min(a, b);
            key[q | qd] = max(a, b);
          }
        }
      } else {
        const int flip = d == k / 2 ? k - 1 : d;
#pragma unroll
        for (int q = 0; q < kK; ++q) {
          const int other = __shfl_xor_sync(mask, key[q], flip, kLanesPerRow);
          // the lower element of the pair keeps the smaller key
          key[q] = (l ^ flip) > l ? min(key[q], other) : max(key[q], other);
        }
      }
    }
  }
  // the rows added in the sorted order, four loads issued before their
  // four adds
  const bool field = l < width;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kK; ++q) {
    const int cnt = min(kLanesPerRow, n - 16 * q);
    if (cnt <= 0) break;
    int t = 0;
    for (; t + 4 <= cnt; t += 4) {
      const int j0 = __shfl_sync(mask, key[q], t, kLanesPerRow);
      const int j1 = __shfl_sync(mask, key[q], t + 1, kLanesPerRow);
      const int j2 = __shfl_sync(mask, key[q], t + 2, kLanesPerRow);
      const int j3 = __shfl_sync(mask, key[q], t + 3, kLanesPerRow);
      if (field) {
        const float v0 = d_rows[static_cast<int64_t>(j0) * width + l];
        const float v1 = d_rows[static_cast<int64_t>(j1) * width + l];
        const float v2 = d_rows[static_cast<int64_t>(j2) * width + l];
        const float v3 = d_rows[static_cast<int64_t>(j3) * width + l];
        acc += v0;
        acc += v1;
        acc += v2;
        acc += v3;
      }
    }
    for (; t < cnt; ++t) {
      const int j = __shfl_sync(mask, key[q], t, kLanesPerRow);
      if (field) acc += d_rows[static_cast<int64_t>(j) * width + l];
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ d_rows,     // [P, R]
                    int32_t* __restrict__ perm,            // [P] by id
                    const int32_t* __restrict__ row_start,  // [n_rows + 1]
                    int n_rows, int width,
                    float* __restrict__ out) {            // [n_rows, R]
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  if (r >= n_rows) return;  // the whole half-warp leaves together
  const int f = threadIdx.x % kLanesPerRow;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
  const int s0 = row_start[r];
  const int n = row_start[r + 1] - s0;
  int32_t* run = perm + s0;
  float acc = 0.f;
  if (n <= 16) {
    acc = sum_run<1>(d_rows, run, n, width, f, mask);
  } else if (n <= 32) {
    acc = sum_run<2>(d_rows, run, n, width, f, mask);
  } else if (n <= 64) {
    acc = sum_run<4>(d_rows, run, n, width, f, mask);
  } else if (n <= kRegisterRun) {
    acc = sum_run<kRegisterRun / 16>(d_rows, run, n, width, f, mask);
  } else {
    // longer than the registers hold: sorted in place in perm
    sort_run_in_place(run, n, f, mask);
    if (f < width) {
      int t = 0;
      for (; t + 4 <= n; t += 4) {
        const float v0 = d_rows[static_cast<int64_t>(run[t]) * width + f];
        const float v1 =
            d_rows[static_cast<int64_t>(run[t + 1]) * width + f];
        const float v2 =
            d_rows[static_cast<int64_t>(run[t + 2]) * width + f];
        const float v3 =
            d_rows[static_cast<int64_t>(run[t + 3]) * width + f];
        acc += v0;
        acc += v1;
        acc += v2;
        acc += v3;
      }
      for (; t < n; ++t) {
        acc += d_rows[static_cast<int64_t>(run[t]) * width + f];
      }
    }
  }
  if (f < width) out[static_cast<int64_t>(r) * width + f] = acc;
}

}  // namespace

// Kernel F's set-up: count [n_rows] must hold zeros, rank [n_pairs] is
// scratch; on return perm [n_pairs] holds each row's pairs in the run
// row_start[r] .. row_start[r + 1] (any order within it).
extern "C" int id_runs_launch(const int32_t* ids, int64_t n_pairs,
                              int n_rows, int32_t* count, int32_t* rank,
                              int32_t* perm, int32_t* row_start,
                              void* stream) {
  if (n_rows < 0 || n_pairs < 0 || n_pairs > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((n_pairs + kThreads - 1) / kThreads);
  if (blocks > 0) {
    id_count_kernel<<<blocks, kThreads, 0, s>>>(ids, n_pairs, n_rows, count,
                                                 rank);
  }
  const unsigned tiles =
      static_cast<unsigned>(n_rows / kScanTile + 1);  // row_start[n_rows] too
  id_scan_kernel<<<tiles, kScanThreads, 0, s>>>(count, n_rows, row_start);
  if (blocks > 0) {
    id_place_kernel<<<blocks, kThreads, 0, s>>>(ids, n_pairs, n_rows,
                                                row_start, rank, perm);
  }
  return static_cast<int>(cudaGetLastError());
}

// width: the record width R, 1..16. perm is reordered within each run.
extern "C" int scatter_rows_launch(const float* d_rows, int32_t* perm,
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

// Registers, local (spill and stack) bytes, static shared bytes and
// dynamic shared bytes (none) of the library's kernels, in the order
// id_count, id_scan, id_place, scatter_rows: out[4 i + 0..3]. Returns the
// first error.
extern "C" int scatter_rows_attributes(int* out) {
  const void* fns[] = {reinterpret_cast<const void*>(id_count_kernel),
                       reinterpret_cast<const void*>(id_scan_kernel),
                       reinterpret_cast<const void*>(id_place_kernel),
                       reinterpret_cast<const void*>(scatter_rows_kernel)};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[4 * i + 0] = a.numRegs;
    out[4 * i + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * i + 2] = static_cast<int>(a.sharedSizeBytes);
    out[4 * i + 3] = 0;
  }
  return 0;
}
