// Kernel E: blend-weight telemetry, the per-pair max over a tile's pixels
// of w = alpha * T.
//
// Replaces threedgrut_tpu/ops/pallas/raster.py:_wmax_kernel (reached
// through rasterize_weight_telemetry, raster.py:2199-2325), the telemetry
// that the GS strategy's weight pruning reads (render/gut.py:291-297). The
// TPU kernel streams 128-pair chunks, takes the max of each chunk's
// [256 pixels x 128] weights over pixels and read-modify-writes the row of
// a chunk it shares with the previous tile (race-free only because TPU grid
// steps run one after another). This kernel takes kernel B's shape: one
// 256-thread block per 16x16 tile, one thread per pixel, 256-pair batches
// staged in shared memory with the table gather fused in, the same walk,
// kill and (sorted mode) windows as raster_fwd.cu. A pair belongs to one
// tile, so its max is taken inside one block: no cross-block race.
//
// Per batch, every thread computes its pixel's w for each pair, in pair
// order (W = 0) or, per window of W, in its sorted order with w stored
// back at the pair's own lane (the TPU kernel's unsort_w). The block's max
// per pair is a warp max (__reduce_max_sync on the float's bits: the order
// of non-negative floats is that of their bits) and then one shared-memory
// atomicMax per warp. A max does not depend on the order it is taken in,
// so the result is deterministic. Thread t then writes pair base + t once.
// Pairs the block never reaches (every pixel dead first), and culled pairs
// past the last tile, keep the zeros the wrapper allocates, as the TPU
// kernel's zero rows do (raster.py:2272-2287).
//
// Bound on this card: kernel B's per-(pixel, pair) arithmetic plus one
// warp reduction per pair; 64 B gathered and 4 B written per pair.
//
// Numerics: fp32, -fmad=false, the hit math of common.cuh:eval_hit, so w
// is kernel B's weight bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using gut::kBlock;
using gut::kRec;
using gut::kTile;

constexpr int kBatch = 256;        // pairs staged per batch
constexpr int kStaged = kRec + 1;  // + squared-distance threshold
constexpr unsigned kFull = 0xffffffffu;

template <int kDeg, int kW>
__global__ void __launch_bounds__(kBlock)
wmax_kernel(const float* __restrict__ table,            // [C, 16]
            const int32_t* __restrict__ pair_particle,  // [P]
            const int32_t* __restrict__ tile_start,     // [T + 1]
            const float* __restrict__ ray_d,            // [H, W, 3]
            const float* __restrict__ ray_tmin,         // [H, W]
            const float* __restrict__ ray_tmax,         // [H, W]
            gut::RasterParams p,
            float* __restrict__ wpair) {                // [P]
  __shared__ float s_rec[kStaged][kBatch];
  __shared__ unsigned s_wmax[kBatch];   // bits of the batch's per-pair max

  const int tile = blockIdx.x;
  const int lane_id = threadIdx.x & 31;
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
  float trans = 1.f;
  constexpr int kWin = kW > 0 ? kW : 1;
  // the weight of staged pair j, accepted with hit h; applies the kill
  auto blend = [&](const gut::Hit& h) {
    const float w = h.alpha * trans;
    trans *= 1.0f - h.alpha;
    if (trans < p.min_transmittance) alive = false;
    return w;
  };
  // the block's max of w over pixels for staged pair j (all threads call)
  auto reduce = [&](float w, int j) {
    const unsigned v = __reduce_max_sync(kFull, __float_as_uint(w));
    if (lane_id == 0 && v != 0u) atomicMax(&s_wmax[j], v);
  };

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  // sorted mode: batches (and so windows) start on a multiple of W
  const int first = start - start % kWin;
  for (int base = first; base < end; base += kBatch) {
    // all pixels of the tile dead (or off-image): the block is done
    if (__syncthreads_count(alive) == 0) break;
    const int idx = base + threadIdx.x;
    s_wmax[threadIdx.x] = 0u;
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
    const int lo0 = max(start - base, 0);   // lanes before the tile
    if constexpr (kW == 0) {
      for (int j = 0; j < nb; ++j) {
        float w = 0.f;
        gut::Hit h;
        if (alive && gut::eval_hit<kDeg>(&s_rec[0][j], kBatch, dx, dy, dz,
                                         tmin, tmax, s_rec[kRec][j], p, h)) {
          w = blend(h);
        }
        reduce(w, j);
      }
    } else {
      for (int w0 = 0; w0 < nb; w0 += kWin) {
        float wv[kWin];   // w of the window's pairs, by lane
#pragma unroll
        for (int k = 0; k < kWin; ++k) wv[k] = 0.f;
        if (alive) {
          float key[kWin];
          uint8_t order[kWin];
          const int n = gut::sort_window<kDeg, kWin>(
              &s_rec[0][0], kBatch, s_rec[kRec], max(w0, lo0),
              min(w0 + kWin, nb), dx, dy, dz, tmin, tmax, p, key, order);
          for (int i = 0; alive && i < n; ++i) {
            const int j = order[i];
            gut::Hit h;
            gut::eval_hit<kDeg>(&s_rec[0][j], kBatch, dx, dy, dz, tmin, tmax,
                                s_rec[kRec][j], p, h);
            wv[j - w0] = blend(h);
          }
        }
        const int nw = min(kWin, nb - w0);
        for (int k = 0; k < nw; ++k) reduce(wv[k], w0 + k);
      }
    }
    __syncthreads();
    if (idx >= start && idx < end) {
      wpair[idx] = __uint_as_float(s_wmax[threadIdx.x]);
    }
  }
}

}  // namespace

// degree: 2 or 4; window: 0 (global-Z order) or 16 (sorted mode).
extern "C" int wmax_launch(const float* table, const int32_t* pair_particle,
                           const int32_t* tile_start, const float* ray_d,
                           const float* ray_tmin, const float* ray_tmax,
                           int width, int height, int grid_x, int num_tiles,
                           int degree, int window, float min_transmittance,
                           float max_alpha, float sq_thr_response,
                           float log_min_alpha, float gg_scale, float* wpair,
                           void* stream) {
  gut::RasterParams p{width, height, grid_x, min_transmittance, max_alpha,
                      sq_thr_response, log_min_alpha, gg_scale};
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  return gut::launch_mode(degree, window, [&](auto deg, auto win) {
    wmax_kernel<decltype(deg)::value, decltype(win)::value>
        <<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
            table, pair_particle, tile_start, ray_d, ray_tmin, ray_tmax, p,
            wpair);
  });
}
