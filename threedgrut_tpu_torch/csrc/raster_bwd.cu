// Kernel C: backward of the tile compositing (kernel B), per-pair record
// gradients.
//
// Replaces threedgrut_tpu/ops/pallas/raster.py:_bwd_strip_kernel (reached
// through rasterize_tiles' custom_vjp -> _pallas_backward) in its training
// mode: _bwd_chunk_fast with the exact kill, the suffix-sum cotangents of
// _suffix_cotangents and the hand pullback of _fast_pullback, kernel
// degree 2 or 4; and in the sorted mode of 3DGRT and sorted 3DGUT
// (_bwd_chunk_fast_sorted, raster.py:1814-1896; W = 16). The TPU
// kernel streams 128-pair chunks through a DMA ring and carries per-chunk
// gradients in pending slots across grid steps; this kernel takes the
// reference's shape (gutKBufferRenderer.cuh backward, K = 0): one
// 256-thread block per 16x16 tile, one thread per pixel, a front-to-back
// replay of the forward walk.
//
// Per pixel, with the saved forward outputs (features F, depth D, T_final)
// and the upstream gradients (g_feat, g_opacity, g_depth):
//   g_t = -g_opacity, phi_total = <g_feat, F> + g_depth * D,
// and for each accepted, alive candidate j (w_j = alpha_j T_j,
// u_j = <g_feat, rgb_j> + g_depth * hit_t_j, S_j = phi_total - sum_{k<=j}
// w_k u_k):
//   g_alpha = T_j u_j - (S_j + g_t T_final) / max(1 - alpha_j, 1e-6),
//   g_hit_t = g_depth w_j,  g_rgb = g_feat w_j,
// pulled back through alpha = min(max_alpha, resp(sq) density) with
// resp = exp(s sq) (degree 2) or exp(s sq^2) (degree 4),
// sq = |a x b|^2 / |b|^2, hit_t = -(a . b) / |b|^2, b = M d to the 16
// record fields a (3), M (9), density, rgb (3).
//
// Reduction over pixels: each pair's 16 gradients are summed over the
// block's 256 pixels in a fixed order (xor-butterfly inside each warp, then
// the 8 warp partials in warp order through shared memory) and written
// once, with no atomics: a pair belongs to one tile, so rows never race and
// the result is the same run to run. A warp in which no pixel touched the
// pair skips its butterfly and contributes zeros.
//
// Bound on this card: the per-(pixel, pair) arithmetic (~150 flops and one
// expf) and the 16-value warp butterflies (80 shuffles per warp and pair
// that some pixel of the warp hit). Device memory traffic is 64 B gathered
// and 64 B written per pair and block. The block leaves once every pixel
// is dead (__syncthreads_count, checked at every group of pairs); pairs it
// never reaches, and culled pairs past the last tile, keep the zeros the
// wrapper allocates.
//
// Sorted mode: windows of W pairs aligned on the global pair index and
// cut to the tile, in kernel B's order (raster_fwd.cu). Per window each
// thread sorts its accepted candidates by hit_t (common.cuh:sort_window)
// and walks them in that order: T, the psi prefix (so the residual S_j)
// and the kill follow the sorted walk, as in the forward. It stores g_alpha
// and w in per-thread arrays indexed by the pair's own lane (the TPU
// kernel's bitonic_replay_unsort); then the block pulls the window back
// pair by pair in lane order with the unsorted path's reduction. The
// reduction groups of 16 pairs tile each window (one group for W = 16),
// and the kill check that ends the block waits for the window's last
// group. Rows of the window outside the tile's [start, end)
// belong to another tile's block and are not written.
//
// Numerics: fp32, built with -fmad=false like kernel B, and the hit math is
// the same common.cuh:eval_hit, so accept and kill decisions equal the
// forward's. The W = 0 degree-2 path does the training slice's kernel's
// fp32 arithmetic in the same order, so its gradients are unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using gut::kBlock;
using gut::kRec;
using gut::kTile;

constexpr int kBatch = 256;        // pairs staged per batch
constexpr int kStaged = kRec + 1;  // + squared-distance threshold
constexpr int kGroup = 16;         // pairs per reduction group
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

// Pull (g_alpha, g_hit_t = g_depth w, g_rgb = g_feat w) of one accepted
// candidate back to its 16 record fields (_fast_pullback) through
// alpha = min(max_alpha, resp(sq) density), sq = |a x b|^2 / |b|^2,
// hit_t = -(a . b) / |b|^2 and b = M d.
template <int kDeg>
__device__ __forceinline__ void pullback(const gut::Hit& h, const float* r,
                                         int stride, float g_alpha, float w,
                                         float gf0, float gf1, float gf2,
                                         float gd, float dx, float dy,
                                         float dz, const gut::RasterParams& p,
                                         float (&d)[kRec]) {
  const float g_ht = gd * w;
  // alpha = min(max_alpha, alpha_raw): no gradient when clamped
  const float g_eff = h.alpha_raw < p.max_alpha ? g_alpha : 0.f;
  const float dens = r[gut::kDensity * stride];
  const float d_resp = g_eff * dens;
  // particle_response_dsq: d resp / d sq
  const float d_sq = d_resp * gut::response_dsq<kDeg>(h, p);
  const float d_q = -g_ht * h.inv_m;
  const float d_inv_m = d_sq * h.c2 - g_ht * h.q;
  const float d_c2 = d_sq * h.inv_m;
  const float d_m = -d_inv_m * h.inv_m * h.inv_m;
  const float gcx = 2.0f * d_c2 * h.cx;
  const float gcy = 2.0f * d_c2 * h.cy;
  const float gcz = 2.0f * d_c2 * h.cz;
  const float ax = r[0], ay = r[stride], az = r[2 * stride];
  // c = a x b: d_a = b x g_c, d_b = g_c x a; q = a . b; m = |b|^2
  d[0] = h.by * gcz - h.bz * gcy + d_q * h.bx;
  d[1] = h.bz * gcx - h.bx * gcz + d_q * h.by;
  d[2] = h.bx * gcy - h.by * gcx + d_q * h.bz;
  const float dbx = gcy * az - gcz * ay + d_q * ax + 2.0f * d_m * h.bx;
  const float dby = gcz * ax - gcx * az + d_q * ay + 2.0f * d_m * h.by;
  const float dbz = gcx * ay - gcy * ax + d_q * az + 2.0f * d_m * h.bz;
  // b = M d: d_M[i][k] = d_b[i] * d[k] (row-major M)
  d[3] = dbx * dx;
  d[4] = dbx * dy;
  d[5] = dbx * dz;
  d[6] = dby * dx;
  d[7] = dby * dy;
  d[8] = dby * dz;
  d[9] = dbz * dx;
  d[10] = dbz * dy;
  d[11] = dbz * dz;
  d[12] = g_eff * h.resp;
  d[13] = gf0 * w;
  d[14] = gf1 * w;
  d[15] = gf2 * w;
}

// Sum d over the warp (xor butterfly, skipped when no lane of the warp
// touched the pair) and publish it: lane f writes field f of the warp sum.
__device__ __forceinline__ void warp_publish(float (&d)[kRec], bool touched,
                                             int lane, float* out) {
  if (__any_sync(kFull, touched)) {
#pragma unroll
    for (int f = 0; f < kRec; ++f) {
      float v = d[f];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(kFull, v, off);
      }
      d[f] = v;
    }
  }
  if (lane < kRec) {
    float v = 0.f;
#pragma unroll
    for (int f = 0; f < kRec; ++f) v = (lane == f) ? d[f] : v;
    out[lane] = v;
  }
}

template <int kDeg, int kW>
__global__ void __launch_bounds__(kBlock)
raster_bwd_kernel(const float* __restrict__ table,            // [C, 16]
                  const int32_t* __restrict__ pair_particle,  // [P]
                  const int32_t* __restrict__ tile_start,     // [T + 1]
                  const float* __restrict__ ray_d,            // [H, W, 3]
                  const float* __restrict__ ray_tmin,         // [H, W]
                  const float* __restrict__ ray_tmax,         // [H, W]
                  const float* __restrict__ fwd_feat,         // [H, W, 3]
                  const float* __restrict__ fwd_depth,        // [H, W]
                  const float* __restrict__ fwd_tfinal,       // [H, W]
                  const float* __restrict__ g_feat,           // [H, W, 3]
                  const float* __restrict__ g_opacity,        // [H, W]
                  const float* __restrict__ g_depth_in,       // [H, W]
                  gut::RasterParams p,
                  float* __restrict__ d_records) {            // [P, 16]
  __shared__ float s_rec[kStaged][kBatch];
  // per-warp partial sums of one group, double-buffered so one barrier
  // per group separates writing a group from reading it back
  __shared__ float s_part[2][kWarps][kGroup][kRec];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int px = (tile % p.grid_x) * kTile + threadIdx.x % kTile;
  const int py = (tile / p.grid_x) * kTile + threadIdx.x / kTile;
  const bool inside = px < p.width && py < p.height;
  const int64_t pix = static_cast<int64_t>(py) * p.width + px;

  float dx = 0.f, dy = 0.f, dz = 0.f, tmin = 0.f, tmax = -1.f;
  float gf0 = 0.f, gf1 = 0.f, gf2 = 0.f, g_t = 0.f, gd = 0.f;
  float t_final = 0.f, phi_total = 0.f;
  if (inside) {
    dx = ray_d[3 * pix + 0];
    dy = ray_d[3 * pix + 1];
    dz = ray_d[3 * pix + 2];
    tmin = ray_tmin[pix];
    tmax = ray_tmax[pix];
    gf0 = g_feat[3 * pix + 0];
    gf1 = g_feat[3 * pix + 1];
    gf2 = g_feat[3 * pix + 2];
    g_t = -g_opacity[pix];
    gd = g_depth_in[pix];
    t_final = fwd_tfinal[pix];
    phi_total = gf0 * fwd_feat[3 * pix + 0] + gf1 * fwd_feat[3 * pix + 1] +
                gf2 * fwd_feat[3 * pix + 2] + gd * fwd_depth[pix];
  }
  bool alive = inside;
  float trans = 1.f;    // T before the current candidate
  float psi_acc = 0.f;  // inclusive prefix of w * u
  constexpr int kWin = kW > 0 ? kW : 1;
  static_assert(kW % kGroup == 0, "reduction groups tile each window");
  // the suffix-sum cotangent of alpha, and accumulate w u
  auto g_alpha_of = [&](const gut::Hit& h, int j, float w) {
    const float u = gf0 * s_rec[gut::kRgb + 0][j] +
                    gf1 * s_rec[gut::kRgb + 1][j] +
                    gf2 * s_rec[gut::kRgb + 2][j] + gd * h.hit_t;
    psi_acc += w * u;
    const float suffix = phi_total - psi_acc;
    return trans * u - (suffix + g_t * t_final) / fmaxf(1.0f - h.alpha, 1e-6f);
  };

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  // sorted mode: batches (and so windows) start on a multiple of W
  const int first = start - start % kWin;
  int group = 0;        // running group count: picks the s_part buffer
  bool done = false;
  for (int base = first; base < end && !done; base += kBatch) {
    // the previous batch's reads of s_rec are over before restaging
    __syncthreads();
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
      for (int g0 = 0; g0 < nb; g0 += kGroup, ++group) {
        float (*part)[kGroup][kRec] = s_part[group & 1];
        const int ng = min(kGroup, nb - g0);
        for (int jj = 0; jj < ng; ++jj) {
          const int j = g0 + jj;
          float d[kRec];
#pragma unroll
          for (int f = 0; f < kRec; ++f) d[f] = 0.f;
          bool touched = false;
          gut::Hit h;
          if (alive && gut::eval_hit<kDeg>(&s_rec[0][j], kBatch, dx, dy, dz,
                                           tmin, tmax, s_rec[kRec][j], p, h)) {
            const float w = h.alpha * trans;
            const float g_alpha = g_alpha_of(h, j, w);
            if (w > 0.f) {
              touched = true;
              pullback<kDeg>(h, &s_rec[0][j], kBatch, g_alpha, w, gf0, gf1,
                             gf2, gd, dx, dy, dz, p, d);
            }
            trans *= 1.0f - h.alpha;
            // exact kill: T_final froze here in the forward too
            if (trans < p.min_transmittance) alive = false;
          }
          warp_publish(d, touched, lane, part[warp][jj]);
        }
        const int n_alive = __syncthreads_count(alive);
        // thread t sums field (t % 16) of pair (t / 16) over the 8 warps
        const int jj = threadIdx.x / kRec;
        const int f = threadIdx.x % kRec;
        if (jj < ng) {
          float acc = 0.f;
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) acc += part[wi][jj][f];
          d_records[static_cast<int64_t>(base + g0 + jj) * kRec + f] = acc;
        }
        if (n_alive == 0) {
          done = true;   // every pixel dead: later pairs keep their zeros
          break;
        }
      }
    } else {
      const int lo0 = max(start - base, 0);   // lanes before the tile
      for (int w0 = 0; w0 < nb && !done; w0 += kWin) {
        // g_alpha and w of the window's pairs, by lane (0: not touched)
        float ga[kWin], wv[kWin];
#pragma unroll
        for (int k = 0; k < kWin; ++k) ga[k] = wv[k] = 0.f;
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
            const float w = h.alpha * trans;
            const float g_alpha = g_alpha_of(h, j, w);
            if (w > 0.f) {
              ga[j - w0] = g_alpha;
              wv[j - w0] = w;
            }
            trans *= 1.0f - h.alpha;
            if (trans < p.min_transmittance) alive = false;
          }
        }
        int n_alive = 1;
        for (int g0 = 0; g0 < kWin; g0 += kGroup, ++group) {
          float (*part)[kGroup][kRec] = s_part[group & 1];
          for (int jj = 0; jj < kGroup; ++jj) {
            const int k = g0 + jj;
            const int j = w0 + k;
            float d[kRec];
#pragma unroll
            for (int f = 0; f < kRec; ++f) d[f] = 0.f;
            const bool touched = wv[k] > 0.f;
            if (touched) {
              gut::Hit h;
              gut::eval_hit<kDeg>(&s_rec[0][j], kBatch, dx, dy, dz, tmin,
                                  tmax, s_rec[kRec][j], p, h);
              pullback<kDeg>(h, &s_rec[0][j], kBatch, ga[k], wv[k], gf0, gf1,
                             gf2, gd, dx, dy, dz, p, d);
            }
            warp_publish(d, touched, lane, part[warp][jj]);
          }
          n_alive = __syncthreads_count(alive);
          const int jj = threadIdx.x / kRec;
          const int f = threadIdx.x % kRec;
          const int row = base + w0 + g0 + jj;
          if (row >= start && row < end) {
            float acc = 0.f;
#pragma unroll
            for (int wi = 0; wi < kWarps; ++wi) acc += part[wi][jj][f];
            d_records[static_cast<int64_t>(row) * kRec + f] = acc;
          }
        }
        // every pixel dead after this window: later pairs keep their zeros
        if (n_alive == 0) done = true;
      }
    }
  }
}

}  // namespace

// degree: 2 or 4; window: 0 (global-Z order) or 16 (sorted mode).
extern "C" int raster_bwd_launch(
    const float* table, const int32_t* pair_particle,
    const int32_t* tile_start, const float* ray_d, const float* ray_tmin,
    const float* ray_tmax, const float* fwd_feat, const float* fwd_depth,
    const float* fwd_tfinal, const float* g_feat, const float* g_opacity,
    const float* g_depth, int width, int height, int grid_x, int num_tiles,
    int degree, int window, float min_transmittance, float max_alpha,
    float sq_thr_response, float log_min_alpha, float gg_scale,
    float* d_records, void* stream) {
  gut::RasterParams p{width, height, grid_x, min_transmittance, max_alpha,
                      sq_thr_response, log_min_alpha, gg_scale};
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  return gut::launch_mode(degree, window, [&](auto deg, auto win) {
    raster_bwd_kernel<decltype(deg)::value, decltype(win)::value>
        <<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
            table, pair_particle, tile_start, ray_d, ray_tmin, ray_tmax,
            fwd_feat, fwd_depth, fwd_tfinal, g_feat, g_opacity, g_depth, p,
            d_records);
  });
}
