// Kernel A: tile-pair expansion, decode and per-tile conic cull.
//
// Replaces threedgrut_tpu/ops/pallas/expand.py:_bin_decode_kernel (reached
// through expand_decode_pairs). The TPU kernel materialises per-pair
// values with an interval-mask matmul on the MXU because XLA lowers
// gathers and scatters to scalar loops; on Hopper a plain store is cheap.
// Depth rank k owns the pair slots [excl[k], excl[k] + counts[k]),
// clamped to the buffer length; the runs are consecutive from slot 0.
//
// Bound on this card: memory. Each slot costs two 4-byte stores and about
// 40 flops of cull math; a view at 800x800 writes ~0.7M slots (~6 MB), a
// few microseconds of HBM time. A thread per particle writing its own
// run (the reference's expandTileProjections shape) leaves the stores of
// a warp in 32 separate runs, and a large splat (hundreds of slots) holds
// its warp for as many serial stores. So a block takes a chunk of kRanks
// consecutive ranks: its first threads stage one rank each (its run and
// its row) in shared memory, then the block's kThreads threads walk the
// chunk's slot range, which is contiguous, one slot each, finding the
// slot's rank by a binary search of the staged run starts. Neighbouring
// threads store to neighbouring slots, and a long run is spread over the
// whole block. Small chunks keep many blocks in flight: on the H100 a
// chunk of 128 ranks for 128 threads took 0.0185 ms at 800x800, 32 ranks
// 0.0091, 16 or 64 no less (PERF.md §6).
//
// Numerics: the cull follows the fp32 operation order of expand.py:113-146
// (== threedgrut_tpu_torch/ops/ut.py:tile_min_power_response) and is built
// with -fmad=false, so its integer outputs equal the plain PyTorch version
// bit for bit. The tile rank is decoded with integer division, which
// equals the TPU kernel's floor(rank / width) for every rank < 2^24.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kTileX = 16.0f;
constexpr float kTileY = 16.0f;
constexpr int kRowDim = 9;  // lo_x, lo_y, width, conic a b c, cx, cy, max_power

__device__ __forceinline__ float sign_or_tile(float moff, float tile) {
  // where(moff == 0, tile, sign(moff) * tile)
  if (moff == 0.0f) return tile;
  return (moff > 0.0f ? 1.0f : -1.0f) * tile;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// Minimum conic power over tile (tx, ty); 0 when the mean is inside it
// (gutProjector.cuh:49-78).
__device__ float tile_min_power(float tx, float ty, float a, float b, float c,
                                float cx, float cy) {
  const float tmin_x = kTileX * tx;
  const float tmin_y = kTileY * ty;
  const float tmax_x = tmin_x + kTileX;
  const float tmax_y = tmin_y + kTileY;
  const float moff_x = tmin_x - cx;
  const float moff_y = tmin_y - cy;
  const float la_x = moff_x > 0.0f ? 1.0f : 0.0f;
  const float la_y = moff_y > 0.0f ? 1.0f : 0.0f;
  const float beyond_x = la_x + (cx > tmax_x ? 1.0f : 0.0f);
  const float beyond_y = la_y + (cy > tmax_y ? 1.0f : 0.0f);
  const bool outside = (beyond_x + beyond_y) > 0.0f;
  const float px = tmax_x * (1.0f - la_x) + tmin_x * la_x;
  const float py = tmax_y * (1.0f - la_y) + tmin_y * la_y;
  const float dx = sign_or_tile(moff_x, kTileX);
  const float dy = sign_or_tile(moff_y, kTileY);
  const float diff_x = cx - px;
  const float diff_y = cy - py;
  const float rcp_x = 1.0f / (kTileX * kTileX * a);
  const float rcp_y = 1.0f / (kTileY * kTileY * c);
  const float ox = beyond_y * clip01((dx * a * diff_x + dx * b * diff_y) * rcp_x);
  const float oy = beyond_x * clip01((dy * b * diff_x + dy * c * diff_y) * rcp_y);
  const float ddx = cx - (px + ox * dx);
  const float ddy = cy - (py + oy * dy);
  const float power = 0.5f * (a * ddx * ddx + c * ddy * ddy) + b * ddx * ddy;
  return outside ? power : 0.0f;
}

constexpr int kRanks = 32;     // ranks per block
constexpr int kThreads = 128;  // threads per block

__global__ void __launch_bounds__(kThreads)
bin_decode_kernel(const float* __restrict__ rows,        // [N, 9], particle order
                  const int32_t* __restrict__ order,     // [N] depth rank -> particle
                  const int32_t* __restrict__ excl,      // [N] first slot, depth order
                  const int32_t* __restrict__ counts,    // [N] slot count, depth order
                  int n, int limit, int grid_x, int num_tiles,
                  int tile_culling,
                  int32_t* __restrict__ pair_tile,       // [limit]
                  int32_t* __restrict__ pair_particle) { // [limit]
  __shared__ int s_start[kRanks];
  __shared__ int s_particle[kRanks];
  __shared__ int3 s_box[kRanks];      // lo_x, lo_y, width
  __shared__ float s_conic[kRanks][6];  // a, b, c, cx, cy, max_power
  const int k0 = blockIdx.x * kRanks;
  const int n_chunk = min(kRanks, n - k0);
  const int j = threadIdx.x;
  if (j < n_chunk) {
    const int k = k0 + j;
    const int i = order[k];
    const float* r = rows + static_cast<int64_t>(i) * kRowDim;
    s_start[j] = min(excl[k], limit);
    s_particle[j] = i;
    s_box[j] = make_int3(static_cast<int>(r[0]), static_cast<int>(r[1]),
                         max(static_cast<int>(r[2]), 1));
#pragma unroll
    for (int c = 0; c < 6; ++c) s_conic[j][c] = r[3 + c];
  }
  __syncthreads();
  const int last = k0 + n_chunk - 1;
  const int slot0 = s_start[0];
  const int slot1 = min(excl[last] + max(counts[last], 0), limit);
  int owner = 0;  // the slots' ranks rise with the slot
  for (int s = slot0 + j; s < slot1; s += kThreads) {
    // the last staged rank whose run starts at or before s: with
    // consecutive runs it owns s (a rank with no slots starts where the
    // next one does)
    int lo = owner, hi = n_chunk - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_start[mid] <= s) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    owner = lo;
    const int rank = s - s_start[owner];
    const int3 box = s_box[owner];
    const int tx = box.x + rank % box.z;
    const int ty = box.y + rank / box.z;
    bool keep = true;
    if (tile_culling) {
      const float* cn = s_conic[owner];
      keep = tile_min_power(static_cast<float>(tx), static_cast<float>(ty),
                            cn[0], cn[1], cn[2], cn[3], cn[4]) < cn[5];
    }
    pair_tile[s] = keep ? ty * grid_x + tx : num_tiles;
    pair_particle[s] = s_particle[owner];
  }
}

}  // namespace

extern "C" int bin_decode_launch(const float* rows, const int32_t* order,
                                 const int32_t* excl, const int32_t* counts,
                                 int n, int limit, int grid_x, int num_tiles,
                                 int tile_culling, int32_t* pair_tile,
                                 int32_t* pair_particle, void* stream) {
  if (n > 0) {
    const int blocks = (n + kRanks - 1) / kRanks;
    bin_decode_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        rows, order, excl, counts, n, limit, grid_x, num_tiles, tile_culling,
        pair_tile, pair_particle);
  }
  return static_cast<int>(cudaGetLastError());
}
