// Kernel E: blend-weight telemetry, the per-pair max over a tile's pixels
// of w = alpha * T.
//
// Replaces threedgrut_tpu/ops/pallas/raster.py:_wmax_kernel (reached
// through rasterize_weight_telemetry, raster.py:2199-2325), the telemetry
// that the GS strategy's weight pruning reads (render/gut.py:291-297). The
// TPU kernel streams 128-pair chunks, takes the max of each chunk's
// [256 pixels x 128] weights over pixels and read-modify-writes the row of
// a chunk it shares with the previous tile (race-free only because TPU grid
// steps run one after another). This kernel takes kernel B's shape
// (raster_fwd.cu:raster_fwd_rgb_kernel): one 256-thread block per 16x16
// tile, warp w on its 8x4 pixel block, 256-pair batches staged in shared
// memory with the table gather fused in, the same cull (common.cuh,
// "kernels B and E in their RGB modes"), walk, kill and (sorted mode)
// windows. A pair belongs to one tile, so its max is taken inside one
// block: no cross-block race.
//
// Per batch, each warp walks the staged pairs its pyramid keeps while a
// ray of it lives. In pair order (W = 0) the block's max per pair is a
// warp max (__reduce_max_sync on the float's bits: the order of
// non-negative floats is that of their bits) and then one shared-memory
// atomicMax per warp. Per window of W (the sorted mode) each ray takes
// the window's pairs in its own sorted order, so each weight goes into
// the pair's max by a shared atomicMax of its own: the earlier design's
// per-ray row of the window's weights and 16 warp maxima a window was
// slower than the parent on the sorted-3DGUT view (PERF.md §6). A max
// does not depend on the order it is taken in, and a culled pair is one
// the ray rejects (weight 0), so the result is the unculled kernel's bit
// for bit. Thread t then writes pair base + t once. Pairs the block never
// reaches (every pixel dead first), and culled pairs past the last tile,
// keep the zeros the wrapper allocates, as the TPU kernel's zero rows do
// (raster.py:2272-2287).
//
// In the general-geometry mode (kGen) the hit is common.cuh:
// eval_hit_general with the pixel's own ray origin, as in kernel B.
//
// Bound on this card: kernel B's per-(pixel, pair) arithmetic (the test
// of what the cull leaves) plus one warp reduction per walked pair; 64 B
// gathered and 4 B written per pair.
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

constexpr int kBatch = kBlock;     // pairs staged per batch, one a thread
constexpr unsigned kFull = 0xffffffffu;

template <int kDeg, int kW, bool kGen>
__device__ __forceinline__ void wmax_body(
    const float* __restrict__ table,            // [C, 16]
    const int32_t* __restrict__ pair_particle,  // [P]
    const int32_t* __restrict__ tile_start,     // [T + 1]
    const float* __restrict__ ray_o,            // [H, W, 3], kGen
    const float* __restrict__ ray_d,            // [H, W, 3]
    const float* __restrict__ ray_tmin,         // [H, W]
    const float* __restrict__ ray_tmax,         // [H, W]
    gut::RasterParams p,
    float* __restrict__ wpair) {                // [P]
  static_assert(kW == 0 || kW == 16, "launch_mode's windows");
  // kernel B's staged rows, bundles, keep bits and lists
  // (raster_fwd.cu:rgb_forward)
  __shared__ __align__(16) float s_row[kBatch * gut::kRgbRow];
  __shared__ gut::Bundle s_bundle[gut::kWarps];
  constexpr bool kEllipsoid = kW == 0 && kDeg == 2;
  __shared__ gut::PlaneQuads s_quads[kEllipsoid ? gut::kWarps : 1];
  __shared__ uint8_t s_keep[kBatch];
  __shared__ uint8_t s_list[gut::kWarps][kBatch];
  __shared__ unsigned s_wmax[kBatch];   // bits of the batch's per-pair max

  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int px = (tile % p.grid_x) * kTile + gut::warp_block_x(threadIdx.x);
  const int py = (tile / p.grid_x) * kTile + gut::warp_block_y(threadIdx.x);
  const bool inside = px < p.width && py < p.height;
  const int64_t pix = static_cast<int64_t>(py) * p.width + px;

  const gut::Ray ray =
      gut::load_ray<kGen>(ray_o, ray_d, ray_tmin, ray_tmax, inside, pix);
  {
    const gut::Bundle bd = gut::warp_bundle(ray, ray.tmax > ray.tmin, lane);
    if (lane == 0) {
      s_bundle[warp] = bd;
      if constexpr (kEllipsoid) s_quads[warp] = gut::plane_quads(bd);
    }
  }
  bool alive = inside;
  float trans = 1.f;
  // the weight of a candidate accepted with alpha; applies the kill
  auto blend = [&](float alpha) {
    const float w = alpha * trans;
    trans *= 1.0f - alpha;
    if (trans < p.min_transmittance) alive = false;
    return w;
  };
  // the block's max of w over pixels for staged pair j (the whole warp
  // calls)
  auto reduce = [&](float w, int j) {
    const unsigned v = __reduce_max_sync(kFull, __float_as_uint(w));
    if (lane == 0 && v != 0u) atomicMax(&s_wmax[j], v);
  };

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  // sorted mode: batches (and so windows) start on a multiple of W
  const int first = kW ? start - start % kW : start;
  for (int base = first; base < end; base += kBatch) {
    // all pixels of the tile dead (or off-image): the block is done
    if (__syncthreads_count(alive) == 0) break;
    const int idx = base + threadIdx.x;
    s_wmax[threadIdx.x] = 0u;
    unsigned keep = 0u;
    if (idx >= start && idx < end) {
      keep = gut::stage_rgb_row<kDeg, kGen, kEllipsoid>(
          table + static_cast<int64_t>(pair_particle[idx]) * kRec,
          s_row + threadIdx.x * gut::kRgbRow, s_bundle, s_quads, p);
    }
    s_keep[threadIdx.x] = static_cast<uint8_t>(keep);
    __syncthreads();
    const uint8_t* list = s_list[warp];
    int n = 0, n_first;
    if (__any_sync(kFull, alive)) {
      n = gut::warp_list(s_keep, kBatch, warp, lane, s_list[warp], n_first);
    }
    // the warp walks its list while a ray of it lives
    if constexpr (kW == 0) {
      for (int i = 0; i < n && __any_sync(kFull, alive); ++i) {
        const float* row = s_row + list[i] * gut::kRgbRow;
        float r[kRec];
        gut::load_rgb_row(row, r);
        float w = 0.f;
        gut::Hit h;
        if (alive && gut::eval_ray<kDeg, kGen>(r, 1, ray, row[gut::kThrSlot],
                                               p, h)) {
          w = blend(h.alpha);
        }
        reduce(w, list[i]);
      }
    } else {
      // window by window of the list, in each ray's sorted order; a
      // weight goes straight into the pair's max (a shared atomicMax: the
      // rays of a warp take the window's pairs in their own orders)
      for (int i = 0; alive && i < n;) {
        const int i1 = gut::window_end<kW>(list, i, n);
        float key[kW], alpha[kW];
        uint8_t pos[kW];
        const int m = gut::sort_list<kDeg, kW, kGen>(s_row, list, i, i1, ray,
                                                     p, key, pos, alpha);
        for (int k = 0; alive && k < m; ++k) {
          const float w = blend(alpha[k]);
          if (w > 0.f) {
            atomicMax(&s_wmax[list[i + pos[k]]], __float_as_uint(w));
          }
        }
        i = i1;
      }
    }
    __syncthreads();
    if (idx >= start && idx < end) {
      wpair[idx] = __uint_as_float(s_wmax[threadIdx.x]);
    }
  }
}

// E's entries, as B's (raster_fwd.cu:raster_fwd_rgb_kernel): at degree 2
// in global-Z order (the ellipsoid cull) four blocks an SM, elsewhere the
// compiler's own register count (measured faster there, PERF.md §6).
template <int kDeg, int kW, bool kGen>
__global__ void __launch_bounds__(kBlock, 4)
wmax_capped_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ pair_particle,
                   const int32_t* __restrict__ tile_start,
                   const float* __restrict__ ray_o,
                   const float* __restrict__ ray_d,
                   const float* __restrict__ ray_tmin,
                   const float* __restrict__ ray_tmax, gut::RasterParams p,
                   float* __restrict__ wpair) {
  wmax_body<kDeg, kW, kGen>(table, pair_particle, tile_start, ray_o, ray_d,
                            ray_tmin, ray_tmax, p, wpair);
}

template <int kDeg, int kW, bool kGen>
__global__ void __launch_bounds__(kBlock)
wmax_kernel(const float* __restrict__ table,
            const int32_t* __restrict__ pair_particle,
            const int32_t* __restrict__ tile_start,
            const float* __restrict__ ray_o,
            const float* __restrict__ ray_d,
            const float* __restrict__ ray_tmin,
            const float* __restrict__ ray_tmax, gut::RasterParams p,
            float* __restrict__ wpair) {
  wmax_body<kDeg, kW, kGen>(table, pair_particle, tile_start, ray_o, ray_d,
                            ray_tmin, ray_tmax, p, wpair);
}

}  // namespace

// degree: 2 or 4; window: 0 (global-Z order) or 16 (sorted mode); general:
// 1 reads ray_o (the general-geometry mode), 0 ignores it.
extern "C" int wmax_launch(const float* table, const int32_t* pair_particle,
                           const int32_t* tile_start, const float* ray_o,
                           const float* ray_d, const float* ray_tmin,
                           const float* ray_tmax, int width, int height,
                           int grid_x, int num_tiles, int degree, int window,
                           int general, float min_transmittance,
                           float max_alpha, float sq_thr_response,
                           float log_min_alpha, float gg_scale, float* wpair,
                           void* stream) {
  gut::RasterParams p{width, height, grid_x, min_transmittance, max_alpha,
                      sq_thr_response, log_min_alpha, gg_scale};
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const auto stream_ = static_cast<cudaStream_t>(stream);
  return gut::launch_mode(degree, window, general, [&](auto deg, auto win,
                                                       auto gen) {
    constexpr int kDeg = decltype(deg)::value, kW = decltype(win)::value;
    constexpr bool kGen = decltype(gen)::value;
    if constexpr (kW == 0 && kDeg == 2) {
      wmax_capped_kernel<kDeg, kW, kGen><<<num_tiles, kBlock, 0, stream_>>>(
          table, pair_particle, tile_start, ray_o, ray_d, ray_tmin, ray_tmax,
          p, wpair);
    } else {
      wmax_kernel<kDeg, kW, kGen><<<num_tiles, kBlock, 0, stream_>>>(
          table, pair_particle, tile_start, ray_o, ray_d, ray_tmin, ray_tmax,
          p, wpair);
    }
  });
}
