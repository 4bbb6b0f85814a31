// Kernel A: tile-pair expansion, decode and per-tile conic cull.
//
// Replaces threedgrut_tpu/ops/pallas/expand.py:_bin_decode_kernel (reached
// through expand_decode_pairs). The TPU kernel materialises per-pair
// values with an interval-mask matmul on the MXU because XLA lowers
// gathers and scatters to scalar loops; on Hopper a plain store is cheap,
// so this kernel takes the reference's expandTileProjections shape: one
// thread per depth-sorted particle writes its own pair slots
// [excl, excl + count), clamped to the buffer length.
//
// Bound on this card: memory. Each slot costs one 8-byte store and about
// 40 flops of cull math; a view at 800x800 writes ~0.7M slots (~6 MB), a
// few microseconds of HBM time, so the launch and the per-particle
// imbalance (a large splat owns up to ~100 slots) dominate. Threads of one
// warp write separate slot runs, so stores coalesce only partly; the
// design accepts that for a first kernel.
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

__global__ void __launch_bounds__(256)
bin_decode_kernel(const float* __restrict__ rows,        // [N, 9], particle order
                  const int32_t* __restrict__ order,     // [N] depth rank -> particle
                  const int32_t* __restrict__ excl,      // [N] first slot, depth order
                  const int32_t* __restrict__ counts,    // [N] slot count, depth order
                  int n, int limit, int grid_x, int num_tiles,
                  int tile_culling,
                  int32_t* __restrict__ pair_tile,       // [limit]
                  int32_t* __restrict__ pair_particle) { // [limit]
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int cnt = counts[k];
  const int start = excl[k];
  if (cnt <= 0 || start >= limit) return;
  const int end = min(start + cnt, limit);
  const int i = order[k];
  const float* r = rows + static_cast<int64_t>(i) * kRowDim;
  const int lo_x = static_cast<int>(r[0]);
  const int lo_y = static_cast<int>(r[1]);
  const int width = max(static_cast<int>(r[2]), 1);
  const float a = r[3], b = r[4], c = r[5];
  const float cx = r[6], cy = r[7], max_power = r[8];
  for (int s = start; s < end; ++s) {
    const int rank = s - start;
    const int tx = lo_x + rank % width;
    const int ty = lo_y + rank / width;
    bool keep = true;
    if (tile_culling) {
      keep = tile_min_power(static_cast<float>(tx), static_cast<float>(ty),
                            a, b, c, cx, cy) < max_power;
    }
    pair_tile[s] = keep ? ty * grid_x + tx : num_tiles;
    pair_particle[s] = i;
  }
}

}  // namespace

extern "C" int bin_decode_launch(const float* rows, const int32_t* order,
                                 const int32_t* excl, const int32_t* counts,
                                 int n, int limit, int grid_x, int num_tiles,
                                 int tile_culling, int32_t* pair_tile,
                                 int32_t* pair_particle, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    bin_decode_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        rows, order, excl, counts, n, limit, grid_x, num_tiles, tile_culling,
        pair_tile, pair_particle);
  }
  return static_cast<int>(cudaGetLastError());
}
