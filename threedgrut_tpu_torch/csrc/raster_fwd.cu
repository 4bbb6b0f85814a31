// Kernel B: forward compositing of one 16x16 tile's depth-ordered pairs.
//
// Replaces threedgrut_tpu/ops/pallas/raster.py:_fwd_strip_kernel (reached
// through rasterize_tiles -> _pallas_forward) in its serving and training
// mode: shared ray origin, constant per-particle RGB, exact kill, kernel
// degree 2 or 4, in global-Z order (W = 0) or in the sorted mode of 3DGRT
// and sorted 3DGUT (W = 16; bitonic_sort_by_key and
// bitonic_replay_unsort, raster.py:686-780, in _chunk_composite
// :885-925). The TPU kernel evaluates [256 pixels x 128 candidates]
// register tiles with matmuls and a log-space prefix scan for
// transmittance; this kernel takes the reference renderer's shape instead
// (gutKBufferRenderer.cuh): one 256-thread block per tile, one thread per
// pixel, a sequential front-to-back walk per pixel with the transmittance
// carried in a register.
//
// Sorted mode: the candidates are cut into windows of W aligned on the
// global pair index (pair // W), each intersected with the tile's
// [start, end), as the TPU kernel's windows of its 128-aligned chunks
// are. Batches start at start rounded down to W, so no window crosses a
// batch. Per window each thread sorts its accepted candidates by hit_t
// (common.cuh:sort_window: insertion sort of the key and an 8-bit lane in
// per-thread arrays), then
// composites them in that order with the kill. Windows follow each other
// in pair order, so T carries from one to the next as in the TPU kernel.
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
// memory traffic is small (64 B per pair and block, 28 B per pixel out).
// Dead pixels drop out of the walk, and the block leaves once every pixel
// of the tile is dead (__syncthreads_count), as the reference does.
//
// Outputs: features, opacity = 1 - T_final, depth, hit count and T_final
// itself (raster.py lane f+3), which the backward (kernel C,
// raster_bwd.cu) reads as saved: rebuilding it as 1 - opacity would lose
// its relative precision where T is near the kill threshold.
//
// Numerics: fp32 throughout, expf (no fast math). The hit math is
// common.cuh:eval_hit, shared with kernels C and E. The W = 0 degree-2
// path does the serving slice's kernel's fp32 arithmetic in the same
// order, so its outputs are unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using gut::kBlock;
using gut::kRec;
using gut::kTile;

constexpr int kBatch = 256;            // pairs staged per batch
constexpr int kStaged = kRec + 1;      // + squared-distance threshold

template <int kDeg, int kW>
__global__ void __launch_bounds__(kBlock)
raster_fwd_kernel(const float* __restrict__ table,        // [C, 16]
                  const int32_t* __restrict__ pair_particle,  // [P]
                  const int32_t* __restrict__ tile_start,     // [T + 1]
                  const float* __restrict__ ray_d,        // [H, W, 3]
                  const float* __restrict__ ray_tmin,     // [H, W]
                  const float* __restrict__ ray_tmax,     // [H, W]
                  gut::RasterParams p,
                  float* __restrict__ out_feat,           // [H, W, 3]
                  float* __restrict__ out_opacity,        // [H, W]
                  float* __restrict__ out_depth,          // [H, W]
                  float* __restrict__ out_hits,           // [H, W]
                  float* __restrict__ out_tfinal) {       // [H, W]
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
  constexpr int kWin = kW > 0 ? kW : 1;
  // blend staged pair j, accepted with hit h, and apply the exact kill
  auto composite = [&](const gut::Hit& h, int j) {
    const float w = h.alpha * trans;
    f0 += w * s_rec[gut::kRgb + 0][j];
    f1 += w * s_rec[gut::kRgb + 1][j];
    f2 += w * s_rec[gut::kRgb + 2][j];
    depth += w * h.hit_t;
    hits += w > 0.f ? 1.f : 0.f;
    trans *= 1.0f - h.alpha;
    // exact kill: the ray stops once T drops below the threshold
    if (trans < p.min_transmittance) alive = false;
  };

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  // sorted mode: batches (and so windows) start on a multiple of W
  const int first = start - start % kWin;
  for (int base = first; base < end; base += kBatch) {
    // all pixels of the tile dead (or off-image): the block is done
    if (__syncthreads_count(alive) == 0) break;
    const int idx = base + threadIdx.x;
    if (idx >= start && idx < end) {
      const float4* row = reinterpret_cast<const float4*>(
          table + static_cast<int64_t>(pair_particle[idx]) * kRec);
      const float4 v0 = row[0], v1 = row[1], v2 = row[2], v3 = row[3];
      const float vals[kRec] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                                v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};
#pragma unroll
      for (int f = 0; f < kRec; ++f) s_rec[f][threadIdx.x] = vals[f];
      s_rec[kRec][threadIdx.x] = gut::sq_threshold<kDeg>(v3.x, p);
    }
    __syncthreads();
    const int nb = min(kBatch, end - base);
    if constexpr (kW == 0) {
      for (int j = 0; alive && j < nb; ++j) {
        gut::Hit h;
        if (!gut::eval_hit<kDeg>(&s_rec[0][j], kBatch, dx, dy, dz, tmin, tmax,
                                 s_rec[kRec][j], p, h)) {
          continue;
        }
        composite(h, j);
      }
    } else {
      const int lo0 = max(start - base, 0);   // lanes before the tile
      for (int w0 = 0; alive && w0 < nb; w0 += kWin) {
        float key[kWin];
        uint8_t lane[kWin];
        const int n = gut::sort_window<kDeg, kWin>(
            &s_rec[0][0], kBatch, s_rec[kRec], max(w0, lo0),
            min(w0 + kWin, nb), dx, dy, dz, tmin, tmax, p, key, lane);
        for (int i = 0; alive && i < n; ++i) {
          const int j = lane[i];
          gut::Hit h;
          gut::eval_hit<kDeg>(&s_rec[0][j], kBatch, dx, dy, dz, tmin, tmax,
                              s_rec[kRec][j], p, h);
          composite(h, j);
        }
      }
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
    out_tfinal[pix] = trans;
  }
}

}  // namespace

// degree: 2 or 4; window: 0 (global-Z order) or 16 (sorted mode).
extern "C" int raster_fwd_launch(
    const float* table, const int32_t* pair_particle,
    const int32_t* tile_start, const float* ray_d, const float* ray_tmin,
    const float* ray_tmax, int width, int height, int grid_x, int num_tiles,
    int degree, int window, float min_transmittance, float max_alpha,
    float sq_thr_response, float log_min_alpha, float gg_scale,
    float* out_feat, float* out_opacity, float* out_depth, float* out_hits,
    float* out_tfinal, void* stream) {
  gut::RasterParams p{width, height, grid_x, min_transmittance, max_alpha,
                      sq_thr_response, log_min_alpha, gg_scale};
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  return gut::launch_mode(degree, window, [&](auto deg, auto win) {
    raster_fwd_kernel<decltype(deg)::value, decltype(win)::value>
        <<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
            table, pair_particle, tile_start, ray_d, ray_tmin, ray_tmax, p,
            out_feat, out_opacity, out_depth, out_hits, out_tfinal);
  });
}
