// Kernel B: forward compositing of one 16x16 tile's depth-ordered pairs.
//
// Replaces threedgrut_tpu/ops/pallas/raster.py:_fwd_strip_kernel (reached
// through rasterize_tiles -> _pallas_forward) in its serving mode:
// shared ray origin, constant per-particle RGB, unsorted global-Z order,
// exact kill, kernel degree 2. The TPU kernel evaluates [256 pixels x 128
// candidates] register tiles with matmuls and a log-space prefix scan for
// transmittance; this kernel takes the reference renderer's shape instead
// (gutKBufferRenderer.cuh, K = 0): one 256-thread block per tile, one
// thread per pixel, a sequential front-to-back walk per pixel with the
// transmittance carried in a register.
//
// Pair batches: the block walks [tile_start[t], tile_start[t+1]) in
// batches of 256 pairs. Each thread stages one pair's 16-float record into
// shared memory, gathering it from the per-particle table through
// pair_particle (fusing render/gut.py's table[idx] gather: no [P, 16]
// records array exists). Every thread then reads the same staged record at
// the same time, a shared-memory broadcast.
//
// Bound on this card: the per-(pixel, pair) arithmetic (~40 flops and one
// expf) and the latency of the one dependent gather per batch; device
// memory traffic is small (64 B per pair and block, 24 B per pixel out).
// Dead pixels drop out of the walk, and the block leaves once every pixel
// of the tile is dead (__syncthreads_count), as the reference does.
//
// Numerics: fp32 throughout, expf (no fast math). Acceptance uses the
// squared-distance threshold of raster.py:_sq_accept_threshold, so the
// accept decision matches the TPU kernel's form.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;  // pixels per tile == threads per block
constexpr int kBatch = 256;            // pairs staged per batch
constexpr int kRec = 16;               // a(3) M(9) density(1) rgb(3)
constexpr int kStaged = kRec + 1;      // + squared-distance threshold

struct RasterParams {
  int width, height, grid_x;
  float min_transmittance, max_alpha;
  float sq_thr_response;  // ln(min_response) / s
  float log_min_alpha;    // ln(min_alpha)
  float gg_scale;         // s = -0.5 for degree 2
};

__global__ void __launch_bounds__(kBlock)
raster_fwd_kernel(const float* __restrict__ table,        // [C, 16]
                  const int32_t* __restrict__ pair_particle,  // [P]
                  const int32_t* __restrict__ tile_start,     // [T + 1]
                  const float* __restrict__ ray_d,        // [H, W, 3]
                  const float* __restrict__ ray_tmin,     // [H, W]
                  const float* __restrict__ ray_tmax,     // [H, W]
                  RasterParams p,
                  float* __restrict__ out_feat,           // [H, W, 3]
                  float* __restrict__ out_opacity,        // [H, W]
                  float* __restrict__ out_depth,          // [H, W]
                  float* __restrict__ out_hits) {         // [H, W]
  __shared__ float s_rec[kStaged][kBatch];

  const int tile = blockIdx.x;
  const int px = (tile % p.grid_x) * kTile + threadIdx.x % kTile;
  const int py = (tile / p.grid_x) * kTile + threadIdx.x / kTile;
  const bool inside = px < p.width && py < p.height;
  const int64_t pix = static_cast<int64_t>(py) * p.width + px;

  float dx = 0.f, dy = 0.f, dz = 0.f, tmin = 0.f, tmax = -1.f;
  if (inside) {
    dx = ray_d[3 * pix + 0];
    dy = ray_d[3 * pix + 1];
    dz = ray_d[3 * pix + 2];
    tmin = ray_tmin[pix];
    tmax = ray_tmax[pix];
  }
  bool alive = inside;
  float trans = 1.f, f0 = 0.f, f1 = 0.f, f2 = 0.f, depth = 0.f, hits = 0.f;

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  for (int base = start; base < end; base += kBatch) {
    // all pixels of the tile dead (or off-image): the block is done
    if (__syncthreads_count(alive) == 0) break;
    const int idx = base + threadIdx.x;
    if (idx < end) {
      const float4* row = reinterpret_cast<const float4*>(
          table + static_cast<int64_t>(pair_particle[idx]) * kRec);
      const float4 v0 = row[0], v1 = row[1], v2 = row[2], v3 = row[3];
      const float vals[kRec] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                                v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};
#pragma unroll
      for (int f = 0; f < kRec; ++f) s_rec[f][threadIdx.x] = vals[f];
      // resp > min_response and resp * density > min_alpha  <=>
      // sq < min(ln(min_response), ln(min_alpha) - ln(density)) / s
      s_rec[kRec][threadIdx.x] = fminf(
          p.sq_thr_response,
          (p.log_min_alpha - logf(fmaxf(v3.x, 1e-30f))) / p.gg_scale);
    }
    __syncthreads();
    const int nb = min(kBatch, end - base);
    for (int j = 0; alive && j < nb; ++j) {
      const float ax = s_rec[0][j], ay = s_rec[1][j], az = s_rec[2][j];
      const float bx = s_rec[3][j] * dx + s_rec[4][j] * dy + s_rec[5][j] * dz;
      const float by = s_rec[6][j] * dx + s_rec[7][j] * dy + s_rec[8][j] * dz;
      const float bz = s_rec[9][j] * dx + s_rec[10][j] * dy + s_rec[11][j] * dz;
      const float cx = ay * bz - az * by;
      const float cy = az * bx - ax * bz;
      const float cz = ax * by - ay * bx;
      const float inv_m = 1.0f / fmaxf(bx * bx + by * by + bz * bz, 1e-30f);
      const float sq = (cx * cx + cy * cy + cz * cz) * inv_m;
      if (!(sq < s_rec[kRec][j])) continue;
      const float hit_t = -(ax * bx + ay * by + az * bz) * inv_m;
      if (!(hit_t > tmin && hit_t < tmax)) continue;
      const float alpha =
          fminf(p.max_alpha, expf(p.gg_scale * sq) * s_rec[12][j]);
      const float w = alpha * trans;
      f0 += w * s_rec[13][j];
      f1 += w * s_rec[14][j];
      f2 += w * s_rec[15][j];
      depth += w * hit_t;
      hits += w > 0.f ? 1.f : 0.f;
      trans *= 1.0f - alpha;
      // exact kill: the ray stops once T drops below the threshold
      if (trans < p.min_transmittance) alive = false;
    }
    __syncthreads();
  }
  if (inside) {
    out_feat[3 * pix + 0] = f0;
    out_feat[3 * pix + 1] = f1;
    out_feat[3 * pix + 2] = f2;
    out_opacity[pix] = 1.0f - trans;
    out_depth[pix] = depth;
    out_hits[pix] = hits;
  }
}

}  // namespace

extern "C" int raster_fwd_launch(
    const float* table, const int32_t* pair_particle,
    const int32_t* tile_start, const float* ray_d, const float* ray_tmin,
    const float* ray_tmax, int width, int height, int grid_x, int num_tiles,
    float min_transmittance, float max_alpha, float sq_thr_response,
    float log_min_alpha, float gg_scale, float* out_feat, float* out_opacity,
    float* out_depth, float* out_hits, void* stream) {
  RasterParams p{width, height, grid_x, min_transmittance, max_alpha,
                 sq_thr_response, log_min_alpha, gg_scale};
  if (num_tiles > 0) {
    raster_fwd_kernel<<<num_tiles, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        table, pair_particle, tile_start, ray_d, ray_tmin, ray_tmax, p,
        out_feat, out_opacity, out_depth, out_hits);
  }
  return static_cast<int>(cudaGetLastError());
}
