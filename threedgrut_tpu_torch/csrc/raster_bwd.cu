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
// General-geometry mode (kGen, the TPU's kernel 5): the hit is
// common.cuh:eval_hit_general, a = M (o - p) per (pixel, pair), and the
// pullback goes on from d_a to the record's position and M:
// d_p = -M^T d_a, d_M = d_a (o - p)^T + d_b d^T, summed over the tile's
// pixels in the same fixed order, so still bitwise repeatable. Kernel D
// folds the rows unchanged and autograd maps (p, M) back to the
// parameters.
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
// Shared-segment mode (kShared; raster.py:_bwd_strip_kernel with
// shared_segments :2051-2167, the TPU's kernel 7, trace()'s brute force):
// every block walks the one segment [tile_start[0], tile_start[1]) of n
// slots, as kernel B does. The TPU kernel adds each chunk's gradient
// across blocks by a read-modify-write of HBM, race-free only because its
// grid steps run in order; here block t writes its sums for slot j to row
// t n + j of d_records ([blocks x n, 16]): one writer per row, no atomics,
// bitwise repeatable. Kernel D then folds the n_blocks rows of each slot
// (ops/cuda/raster.py:shared_fold_meta).
//
// Windows of 128 (raster_bwd_trace_kernel: trace()'s degree-4 general
// mode over per-block segments or a shared segment). Taking one suspect
// away at a time from the earlier design (the sort above with its arrays
// 128 long, then a group loop over every lane of the window) showed where
// its 12.1 ms (grid) and 13.6 ms (kernel 7) went: the exact test of
// every pair (4.3-4.7 ms, as in kernel B) and the group loop's visit of
// every lane, touched or not (4-5 ms); its local-memory arrays cost
// nothing measurable, its butterflies and group barriers 0.3-0.7 ms (on
// an H100 80GB HBM3 at 700 W, PERF.md §6). So:
//  - kernel B's cull, list and k-buffer (raster_fwd.cu) give each ray
//    its accepted candidates in the sorted order;
//  - a candidate is pulled back as it is composited: its 16 values go to
//    the warp's value rows in shared memory, and lanes 0-15 (one field
//    each) add the step's touched lanes' rows, in lane order, to the
//    warp's accumulators of the window's 128 pairs (runs of one pair sum
//    in registers first); the warp marks the pairs it touched;
//  - at the window's end, one barrier; each touched pair's 16 fields are
//    summed over the 8 warps in warp order, written once, and the
//    accumulators zeroed; untouched rows are not written (the wrapper's
//    zeros), which in kernel 7 leaves most of its [blocks x slots, 16]
//    rows alone.
// A fixed order throughout and no atomics on gradient values: bitwise
// repeatable. Dynamic shared memory 102,912 bytes (staged records with
// the cull's rows, accumulators, value rows): two blocks an SM.
//
// NHT mode (raster_bwd_nht_kernel; raster.py's NHT mode, the TPU's kernel
// 8, through _bwd_chunk_grads :1899-1961: nht_hit_features for the
// cotangents, then the VJP of chunk_hits_general and of
// nht_feature_weighted_sum with w held constant). General mode, global-Z
// order, 64-float records (common.cuh:kRecNht), 24 ray features. The
// residual form is kept with phi and g_feat 24 wide: u_j = <g_feat,
// f_j> + g_depth hit_t_j, where f_j = (sin b_k, cos b_k) of the blends b_k
// of pair j's control features at the pixel's canonical hit point. Then,
// with e_k = w (cos b_k g_sin,k - sin b_k g_cos,k):
//   d feature[v][k] = bary_v e_k (48 fields),
//   d bary_v = sum_k feature[v][k] e_k, pulled through the barycentric map
//   to the canonical point c = a + b tc, tc = -(a . b) / |b|^2, and from
//   there onto a and b beside the alpha path: d_a += d_c, d_b += d_c tc,
//   and d_c . b joins tc's cotangent (g_depth w |d|), which the hit
//   distance shares;
// then d_a, d_b go to p and M as in the general mode.
//
// What bounds it on this card, measured at 800x800 on the 100k NHT cloud
// (600,658 pairs, 43.8M composited candidates at degree 2): not the
// ~570 operations a composited candidate needs (0.51 ms at the fp32 peak)
// but how they are issued. A warp runs the composited path whenever one
// of its 32 pixels composites the pair; the 12 sines and cosines, the
// 61-field reduction over the pixels, shared-memory traffic and
// occupancy are what the design spends on. Taking each away from the
// earlier design (the per-pair scatter butterfly of 88 shuffles a warp
// and a block barrier every 4 pairs, 12 libdevice sincosf, -fmad=false
// throughout, 178 registers and one block an SM) saved 2.19, 1.48, 0.64
// and (at 128 registers, with spills) 1.68 ms of its 7.75 ms
// (scripts/compare_tree_torch.py --nht-variants). So:
//  - Reduction: each composited pixel writes its 29 values (13 geometry
//    cotangents, 4 barycentric weights, 12 e_k) to its warp's value rows
//    in shared memory, and the warp sums them over the ballot of its
//    composited lanes only, from the highest lane down: every lane adds
//    two fields (a feature field is the sum of bary_v e_k, so the 48 come
//    from 16 rows; a geometry field is an FMA by a row of ones, the plain
//    add), three loads and two FMAs a composited pixel, each pixel's
//    loads issued before the previous one's FMAs. No shuffles; a warp
//    with one composited pixel does one step. The 8 warp partials of
//    groups of 8 pairs then meet at one block barrier and are summed in
//    warp order, as before: a fixed order throughout, no atomics, bitwise
//    repeatable.
//  - Sine and cosine: sincos_fast, a two-constant Cody-Waite step onto
//    [-pi, pi] and the SFU (__sincosf), within 1e-6 of float64 on the
//    card for blends up to kTrigFastMax = 2^20 (chip_smoke.py phase 27
//    measures it). A hit with a blend past that redoes its features with
//    the accurate libdevice sincosf (nht_features<true>), out of the
//    unrolled loop.
//  - Contraction: the file keeps -fmad=false, so the hit test
//    (common.cuh:eval_hit_general) and the transmittance take kernel B's
//    accept and kill decisions; the blends, the feature path and the
//    pullback, which decide nothing, are written in explicit __fmaf_rn.
//  - Shared memory and occupancy: the 128 staged records are rows of 68
//    floats (record from float 3, so the 48 control features start
//    16-byte aligned and a vertex's four control dims are one float4
//    load; the test's 13 fields are four), in dynamic shared memory with
//    the warp partials and value rows: 95 KB a block, two blocks an SM at
//    __launch_bounds__(256, 2), 128 registers (degree 4 spills 56 bytes
//    to reach it; one block an SM without the spill was slower).
// Together (chip_smoke.py phase 27, H100 80GB HBM3, 700 W): 3.62 ms at
// degree 2 and 1.41 ms at degree 4, 2.15x and 1.94x faster than before
// (scripts/compare_tree_torch.py).
//
// Numerics: fp32, built with -fmad=false like kernel B, and the hit math is
// the same common.cuh:eval_hit, so accept and kill decisions equal the
// forward's. The W = 0 degree-2 path does the training slice's kernel's
// fp32 arithmetic in the same order, so its gradients are unchanged. The
// NHT mode's pullback uses explicit FMAs and the SFU sine (above).
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

// The cotangents of a and b of one accepted candidate (_fast_pullback)
// through alpha = min(max_alpha, resp(sq) density), sq = |a x b|^2 / |b|^2
// (g_eff: alpha's cotangent where alpha_raw is under max_alpha, else 0)
// and tc = -(a . b) / |b|^2 (g_tc), with b = M d.
struct GradAB {
  float ax, ay, az, bx, by, bz;
};

template <int kDeg>
__device__ __forceinline__ GradAB pull_ab(const gut::Hit& h, float g_eff,
                                          float dens, float g_tc,
                                          const gut::RasterParams& p) {
  const float d_resp = g_eff * dens;
  // particle_response_dsq: d resp / d sq
  const float d_sq = d_resp * gut::response_dsq<kDeg>(h, p);
  const float d_q = -g_tc * h.inv_m;
  const float d_inv_m = d_sq * h.c2 - g_tc * h.q;
  const float d_c2 = d_sq * h.inv_m;
  const float d_m = -d_inv_m * h.inv_m * h.inv_m;
  const float gcx = 2.0f * d_c2 * h.cx;
  const float gcy = 2.0f * d_c2 * h.cy;
  const float gcz = 2.0f * d_c2 * h.cz;
  const float ax = h.ax, ay = h.ay, az = h.az;
  // c = a x b: d_a = b x g_c, d_b = g_c x a; q = a . b; m = |b|^2
  GradAB g;
  g.ax = h.by * gcz - h.bz * gcy + d_q * h.bx;
  g.ay = h.bz * gcx - h.bx * gcz + d_q * h.by;
  g.az = h.bx * gcy - h.by * gcx + d_q * h.bz;
  g.bx = gcy * az - gcz * ay + d_q * ax + 2.0f * d_m * h.bx;
  g.by = gcz * ax - gcx * az + d_q * ay + 2.0f * d_m * h.by;
  g.bz = gcx * ay - gcy * ax + d_q * az + 2.0f * d_m * h.bz;
  return g;
}

// The general mode's map of (d_a, d_b) through a = M e, e = o - p and
// b = M d onto rows 0-11 of its record: d_p = -M^T d_a,
// d_M[i][k] = d_a[i] e[k] + d_b[i] d[k].
template <int kN>
__device__ __forceinline__ void general_rows(const GradAB& g,
                                             const gut::Hit& h,
                                             const float* r, int stride,
                                             const gut::Ray& ray,
                                             float (&d)[kN]) {
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  d[0] = -(r[3 * stride] * g.ax + r[6 * stride] * g.ay + r[9 * stride] * g.az);
  d[1] = -(r[4 * stride] * g.ax + r[7 * stride] * g.ay + r[10 * stride] * g.az);
  d[2] = -(r[5 * stride] * g.ax + r[8 * stride] * g.ay + r[11 * stride] * g.az);
  d[3] = g.ax * h.ex + g.bx * dx;
  d[4] = g.ax * h.ey + g.bx * dy;
  d[5] = g.ax * h.ez + g.bx * dz;
  d[6] = g.ay * h.ex + g.by * dx;
  d[7] = g.ay * h.ey + g.by * dy;
  d[8] = g.ay * h.ez + g.by * dz;
  d[9] = g.az * h.ex + g.bz * dx;
  d[10] = g.az * h.ey + g.bz * dy;
  d[11] = g.az * h.ez + g.bz * dz;
}

// Pull (g_alpha, g_hit_t = g_depth w, g_rgb = g_feat w) of one accepted
// candidate back to its 16 record fields (_fast_pullback) through pull_ab.
//
// The general mode (kGen; raster.py:_bwd_chunk_grads' pullback of
// chunk_hits_general) goes on from d_a and d_b through a = M (o - p),
// hit_t scaled by |d| (general_rows), and writes d_p in rows 0-2 of the
// general record.
template <int kDeg, bool kGen>
__device__ __forceinline__ void pullback(const gut::Hit& h, const float* r,
                                         int stride, float g_alpha, float w,
                                         float gf0, float gf1, float gf2,
                                         float gd, const gut::Ray& ray,
                                         const gut::RasterParams& p,
                                         float (&d)[kRec]) {
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const float g_ht = kGen ? gd * w * ray.dn : gd * w;
  // alpha = min(max_alpha, alpha_raw): no gradient when clamped
  const float g_eff = h.alpha_raw < p.max_alpha ? g_alpha : 0.f;
  const GradAB g =
      pull_ab<kDeg>(h, g_eff, r[gut::kDensity * stride], g_ht, p);
  const float dbx = g.bx, dby = g.by, dbz = g.bz;
  if constexpr (kGen) {
    general_rows(g, h, r, stride, ray, d);
  } else {
    d[0] = g.ax;
    d[1] = g.ay;
    d[2] = g.az;
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
  }
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

// Set bit k of a window's touched mask, and read the 16 bits of the group
// starting at lane g0 (a multiple of 16): the words are selected in an
// unrolled loop, so the mask stays in registers.
template <int kWords>
__device__ __forceinline__ void mask_set(uint32_t (&m)[kWords], int k) {
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    if (q == (k >> 5)) m[q] |= 1u << (k & 31);
  }
}

template <int kWords>
__device__ __forceinline__ uint32_t mask_group(const uint32_t (&m)[kWords],
                                               int g0) {
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    if (q == (g0 >> 5)) word = m[q];
  }
  return (word >> (g0 & 31)) & 0xffffu;
}

template <int kDeg, int kW, bool kGen, bool kShared>
__global__ void __launch_bounds__(kBlock)
raster_bwd_kernel(const float* __restrict__ table,            // [C, 16]
                  const int32_t* __restrict__ pair_particle,  // [P]
                  const int32_t* __restrict__ tile_start,     // [T + 1]
                  const float* __restrict__ ray_o,     // [H, W, 3], kGen
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

  const gut::Ray ray =
      gut::load_ray<kGen>(ray_o, ray_d, ray_tmin, ray_tmax, inside, pix);
  float gf0 = 0.f, gf1 = 0.f, gf2 = 0.f, g_t = 0.f, gd = 0.f;
  float t_final = 0.f, phi_total = 0.f;
  if (inside) {
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

  // kShared: every block walks the one segment [tile_start[0],
  // tile_start[1]) and writes pair idx to row tile (end - start) + idx -
  // start
  const int start = tile_start[kShared ? 0 : tile];
  const int end = tile_start[kShared ? 1 : tile + 1];
  float* const d_rows =
      kShared ? d_records + (static_cast<int64_t>(tile) * (end - start) -
                             start) * kRec
              : d_records;
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
          if (alive && gut::eval_ray<kDeg, kGen>(&s_rec[0][j], kBatch, ray,
                                                 s_rec[kRec][j], p, h)) {
            const float w = h.alpha * trans;
            const float g_alpha = g_alpha_of(h, j, w);
            if (w > 0.f) {
              touched = true;
              pullback<kDeg, kGen>(h, &s_rec[0][j], kBatch, g_alpha, w, gf0,
                                   gf1, gf2, gd, ray, p, d);
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
          d_rows[static_cast<int64_t>(base + g0 + jj) * kRec + f] = acc;
        }
        if (n_alive == 0) {
          done = true;   // every pixel dead: later pairs keep their zeros
          break;
        }
      }
    } else {
      const int lo0 = max(start - base, 0);   // lanes before the tile
      for (int w0 = 0; w0 < nb && !done; w0 += kWin) {
        // g_alpha and w of the window's touched pairs, by lane, and the
        // touched lanes' bits
        constexpr int kWords = (kWin + 31) / 32;
        float ga[kWin], wv[kWin];
        uint32_t touched_mask[kWords];
#pragma unroll
        for (int q = 0; q < kWords; ++q) touched_mask[q] = 0u;
        if (alive) {
          float key[kWin];
          uint8_t order[kWin];
          const int n = gut::sort_window<kDeg, kWin, kGen>(
              &s_rec[0][0], kBatch, s_rec[kRec], max(w0, lo0),
              min(w0 + kWin, nb), ray, p, key, order);
          for (int i = 0; alive && i < n; ++i) {
            const int j = order[i];
            gut::Hit h;
            gut::eval_ray<kDeg, kGen>(&s_rec[0][j], kBatch, ray,
                                      s_rec[kRec][j], p, h);
            const float w = h.alpha * trans;
            const float g_alpha = g_alpha_of(h, j, w);
            if (w > 0.f) {
              ga[j - w0] = g_alpha;
              wv[j - w0] = w;
              mask_set(touched_mask, j - w0);
            }
            trans *= 1.0f - h.alpha;
            if (trans < p.min_transmittance) alive = false;
          }
        }
        int n_alive = 1;
        for (int g0 = 0; g0 < kWin; g0 += kGroup, ++group) {
          float (*part)[kGroup][kRec] = s_part[group & 1];
          const uint32_t gbits = mask_group(touched_mask, g0);
          for (int jj = 0; jj < kGroup; ++jj) {
            const int k = g0 + jj;
            const int j = w0 + k;
            float d[kRec];
#pragma unroll
            for (int f = 0; f < kRec; ++f) d[f] = 0.f;
            const bool touched = (gbits >> jj) & 1u;
            if (touched) {
              gut::Hit h;
              gut::eval_ray<kDeg, kGen>(&s_rec[0][j], kBatch, ray,
                                        s_rec[kRec][j], p, h);
              pullback<kDeg, kGen>(h, &s_rec[0][j], kBatch, ga[k], wv[k], gf0,
                                   gf1, gf2, gd, ray, p, d);
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
            d_rows[static_cast<int64_t>(row) * kRec + f] = acc;
          }
        }
        // every pixel dead after this window: later pairs keep their zeros
        if (n_alive == 0) done = true;
      }
    }
  }
}

// ---- trace()'s windows of 128 (raster_bwd_trace_kernel) ----

// dynamic shared memory of the trace kernel, floats: the staged records
// (record, threshold, the cull's rows), each warp's accumulators of the
// window's 128 pairs, and each warp's value rows (a touched lane's 16
// values, then the window lane of its pair)
constexpr int kTraceRecFloats = (kStaged + gut::kCullRows) * kBatch;
constexpr int kTraceAccFloats = kWarps * gut::kTraceW * kRec;
constexpr int kValPadT = 33;     // value row stride: lanes hit distinct banks
constexpr int kTraceValFloats = kWarps * (kRec * kValPadT + 32);
constexpr int kTraceSmemBytes =
    (kTraceRecFloats + kTraceAccFloats + kTraceValFloats) * 4;

template <bool kShared>
__global__ void __launch_bounds__(kBlock)
raster_bwd_trace_kernel(const float* __restrict__ table,      // [C, 16]
                        const int32_t* __restrict__ pair_particle,  // [P]
                        const int32_t* __restrict__ tile_start,  // [T + 1]
                        const float* __restrict__ ray_o,      // [H, W, 3]
                        const float* __restrict__ ray_d,      // [H, W, 3]
                        const float* __restrict__ ray_tmin,   // [H, W]
                        const float* __restrict__ ray_tmax,   // [H, W]
                        const float* __restrict__ fwd_feat,   // [H, W, 3]
                        const float* __restrict__ fwd_depth,  // [H, W]
                        const float* __restrict__ fwd_tfinal,  // [H, W]
                        const float* __restrict__ g_feat,     // [H, W, 3]
                        const float* __restrict__ g_opacity,  // [H, W]
                        const float* __restrict__ g_depth_in,  // [H, W]
                        gut::RasterParams p,
                        float* __restrict__ d_records) {      // [P, 16]
  constexpr int kDeg = 4;            // trace()'s degree, general mode
  constexpr int kW = gut::kTraceW;
  extern __shared__ __align__(16) float s_dyn[];
  float (*s_rec)[kBatch] = reinterpret_cast<float (*)[kBatch]>(s_dyn);
  float (*s_acc)[kW][kRec] =
      reinterpret_cast<float (*)[kW][kRec]>(s_dyn + kTraceRecFloats);
  __shared__ gut::Bundle s_bundle[kWarps];
  __shared__ uint8_t s_keep[kBatch];
  __shared__ uint8_t s_list[kWarps][kBatch];
  // the window's touched pairs, a bit each, for two windows in turn
  __shared__ uint32_t s_tmask[2][kW / 32];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's value rows: value f of lane i at val[f * kValPadT + i],
  // the window lane of its pair at vk[i]
  float* val = s_dyn + kTraceRecFloats + kTraceAccFloats +
               warp * (kRec * kValPadT + 32);
  int* vk = reinterpret_cast<int*>(val + kRec * kValPadT);
  const int px = (tile % p.grid_x) * kTile + threadIdx.x % kTile;
  const int py = (tile / p.grid_x) * kTile + threadIdx.x / kTile;
  const bool inside = px < p.width && py < p.height;
  const int64_t pix = static_cast<int64_t>(py) * p.width + px;

  const gut::Ray ray =
      gut::load_ray<true>(ray_o, ray_d, ray_tmin, ray_tmax, inside, pix);
  float gf0 = 0.f, gf1 = 0.f, gf2 = 0.f, g_t = 0.f, gd = 0.f;
  float t_final = 0.f, phi_total = 0.f;
  if (inside) {
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
  const gut::Bundle bd = gut::warp_bundle(ray, ray.tmax > ray.tmin, lane);
  if (lane == 0) s_bundle[warp] = bd;
  const float dd = ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz;
  for (int i = threadIdx.x; i < kTraceAccFloats; i += kBlock) {
    (&s_acc[0][0][0])[i] = 0.f;
  }
  if (threadIdx.x < 2 * kW / 32) (&s_tmask[0][0])[threadIdx.x] = 0u;

  // kShared: every block walks the one segment [tile_start[0],
  // tile_start[1]) and writes pair idx to row tile (end - start) + idx -
  // start
  const int start = tile_start[kShared ? 0 : tile];
  const int end = tile_start[kShared ? 1 : tile + 1];
  float* const d_rows =
      kShared ? d_records + (static_cast<int64_t>(tile) * (end - start) -
                             start) * kRec
              : d_records;
  const int first = start - start % kW;
  int win = 0;          // running window count: picks the touched mask
  bool done = false;
  for (int base = first; base < end && !done; base += kBatch) {
    // the previous batch's reads of s_rec are over before restaging
    __syncthreads();
    const int idx = base + threadIdx.x;
    unsigned keep = 0u;
    if (idx >= start && idx < end) {
      const float4* row = reinterpret_cast<const float4*>(
          table + static_cast<int64_t>(pair_particle[idx]) * kRec);
      const float4 v0 = row[0], v1 = row[1], v2 = row[2], v3 = row[3];
      const float vals[kRec] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                                v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};
#pragma unroll
      for (int f = 0; f < kRec; ++f) s_rec[f][threadIdx.x] = vals[f];
      s_rec[kRec][threadIdx.x] = gut::sq_threshold<kDeg>(v3.x, p);
      keep = gut::stage_cull(&s_rec[0][threadIdx.x], kBatch, s_bundle);
    }
    s_keep[threadIdx.x] = static_cast<uint8_t>(keep);
    __syncthreads();
    const int nb = min(kBatch, end - base);
    int n_first = 0;
    const int n_list =
        gut::warp_list(s_keep, kBatch, warp, lane, s_list[warp], n_first);
    for (int w0 = 0; w0 < nb && !done; w0 += kW, ++win) {
      uint32_t* tmask = s_tmask[win & 1];
      // composite this lane's staged pair j (has) at one step of the warp:
      // its pullback goes to the warp's value rows, and lanes 0-15 add the
      // step's touched lanes' values, in lane order, to the accumulators
      // of their pairs (field = lane)
      auto step = [&](bool has, int j) {
        bool touched = false;
        float d[kRec];
        if (has) {
          gut::Hit h;
          gut::eval_hit_general<kDeg>(&s_rec[0][j], kBatch, ray,
                                      s_rec[kRec][j], p, h);
          const float w = h.alpha * trans;
          const float u = gf0 * s_rec[gut::kRgb + 0][j] +
                          gf1 * s_rec[gut::kRgb + 1][j] +
                          gf2 * s_rec[gut::kRgb + 2][j] + gd * h.hit_t;
          psi_acc += w * u;
          const float suffix = phi_total - psi_acc;
          const float g_alpha = trans * u - (suffix + g_t * t_final) /
                                                fmaxf(1.0f - h.alpha, 1e-6f);
          if (w > 0.f) {
            touched = true;
            pullback<kDeg, true>(h, &s_rec[0][j], kBatch, g_alpha, w, gf0,
                                 gf1, gf2, gd, ray, p, d);
          }
          trans *= 1.0f - h.alpha;
          // exact kill: T_final froze here in the forward too
          if (trans < p.min_transmittance) alive = false;
        }
        const unsigned m = __ballot_sync(kFull, touched);
        if (m == 0u) return;
        if (touched) {
          const int k = j - w0;
#pragma unroll
          for (int f = 0; f < kRec; ++f) val[f * kValPadT + lane] = d[f];
          vk[lane] = k;
          atomicOr(&tmask[k >> 5], 1u << (k & 31));
        }
        __syncwarp();
        if (lane < kRec) {
          // runs of one pair sum in registers
          unsigned mm = m;
          int cur = vk[__ffs(mm) - 1];
          float acc = 0.f;
          while (mm) {
            const int i = __ffs(mm) - 1;
            mm &= mm - 1u;
            const int k = vk[i];
            const float v = val[lane * kValPadT + i];
            if (k != cur) {
              s_acc[warp][cur][lane] += acc;
              cur = k;
              acc = v;
            } else {
              acc += v;
            }
          }
          s_acc[warp][cur][lane] += acc;
        }
        __syncwarp();
      };
      const int i0 = w0 ? n_first : 0, i1 = w0 ? n_list : n_first;
      uint64_t last = 0ull;   // every key is above 0
      bool more = alive;
      while (__any_sync(kFull, more)) {
        uint64_t buf[gut::kTraceK];
        const int cnt = more ? gut::kbuffer_pass<kDeg>(
                                   &s_rec[0][0], kBatch, s_list[warp], i0, i1,
                                   ray, dd, p, last, buf)
                             : 0;
        const int n = min(cnt, gut::kTraceK);
        for (int q = 0; __any_sync(kFull, alive && q < n); ++q) {
          const bool has = alive && q < n;
          int j = 0;
          if (has) {
            last = gut::kbuffer_pop(buf);
            j = static_cast<int>(last & 0xffu);
          }
          step(has, j);
        }
        more = more && alive && cnt > gut::kTraceK;
        if (more) atomicAdd(&gut::g_window_overflows, 1ull);
      }
      // the window's sums: each touched pair's 16 fields over the 8 warps
      // in warp order, written once; the accumulators go back to zero
      const int n_alive = __syncthreads_count(alive);
      uint32_t words[kW / 32];
      int total = 0;
#pragma unroll
      for (int q = 0; q < kW / 32; ++q) {
        words[q] = tmask[q];
        total += __popc(words[q]);
      }
      for (int item = threadIdx.x; item < total * kRec; item += kBlock) {
        int r = item / kRec;
        const int f = item % kRec;
        int k = 0;
#pragma unroll
        for (int q = 0; q < kW / 32; ++q) {
          const int c = __popc(words[q]);
          if (r >= 0 && r < c) k = 32 * q + __fns(words[q], 0, r + 1);
          r -= c;
        }
        float acc = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) {
          acc += s_acc[wi][k][f];
          s_acc[wi][k][f] = 0.f;
        }
        d_rows[static_cast<int64_t>(base + w0 + k) * kRec + f] = acc;
      }
      // the next window's mask (read before the last window's barrier)
      if (threadIdx.x < kW / 32) s_tmask[(win + 1) & 1][threadIdx.x] = 0u;
      __syncthreads();
      // every pixel dead after this window: later pairs keep their zeros
      if (n_alive == 0) done = true;
    }
  }
}

// ---- NHT mode (raster_bwd_nht_kernel) ----

constexpr int kBatchNht = 128;   // records staged per batch (34.8 KB)
// a staged record's row: 3 floats of padding, the 64 fields from
// kRowField (so the 48 control features start 16-byte aligned, four
// control dims of a vertex to a float4), then the squared-distance
// threshold
constexpr int kRowField = 3;
constexpr int kRowNht = kRowField + gut::kRecNht + 1;
static_assert((kRowField + gut::kNhtFeat) % 4 == 0 && kRowNht % 4 == 0,
              "float4 rows and features");
constexpr int kGroupNht = 8;     // pairs per block-level reduction group
// gradient fields written per pair: p, M, density, 48 features (the
// record's last 3 slots are padding and keep the wrapper's zeros)
constexpr int kFieldsNht = gut::kNhtFeat + 4 * gut::kNhtDim;
// a touched pixel's values for the warp reduction: the 13 geometry
// cotangents, the 4 barycentric weights and the 12 blend cotangents e_k
// (a feature field's gradient is the pixel sum of bary_v e_k), then a
// row of ones
constexpr int kValBary = gut::kNhtFeat;
constexpr int kValE = kValBary + 4;
constexpr int kValOnes = kValE + gut::kNhtDim;
constexpr int kValRows = kValOnes + 1;
constexpr int kValPad = 33;      // row stride: lanes hit distinct banks
// dynamic shared memory, floats: staged records and thresholds, the warp
// partials of two groups, and each warp's value rows
constexpr int kNhtRecFloats = kBatchNht * kRowNht;
constexpr int kNhtPartFloats = 2 * kWarps * kGroupNht * kFieldsNht;
constexpr int kNhtValFloats = kWarps * kValRows * kValPad;
constexpr int kNhtSmemBytes =
    (kNhtRecFloats + kNhtPartFloats + kNhtValFloats) * 4;

// The fast sine and cosine below hold for |x| <= kTrigFastMax = 2^20,
// far past any blend of trained features; a hit with a blend past it
// redoes its features with the accurate libdevice sincosf
// (nht_features<true>), whose Payne-Hanek reduction keeps a local-memory
// frame, outside the unrolled hot loop. Past ~2^23 the reduced argument
// leaves [-4, 4] and the fast path's error grows.
constexpr float kTrigFastMax = 1048576.0f;

// sin x and cos x of an NHT blend: a two-constant Cody-Waite step onto
// about [-pi, pi], j = rint(x / 2pi), r = (x - j C1) - j C2 with C1 =
// fp32(2pi) and C2 = fp32(2pi - C1), each step one rounding (x - j C1 is
// exact: both are multiples of 2^-21 and |r| < 4; the constants' own
// error, j 7e-15, is far below), then the SFU's sine and cosine
// (__sincosf: at most 2^-21.41 = 3.6e-7 absolute on [-pi, pi], CUDA's
// stated bound). Error against float64: the reduction within 1.21e-7 on
// |x| <= kTrigFastMax (its float32 emulation, ops/cuda/raster.py:
// nht_sincos_plain, holds sin and cos of r within 1.5e-7;
// tests/test_torch_table_route.py); the whole is held to 1e-6 on the
// card over 6M arguments of that range (chip_smoke.py phase 27 prints
// it).
__device__ __forceinline__ void sincos_fast(float x, float& s, float& c) {
  const float j = rintf(__fmul_rn(x, 0.159154937f));
  float r = __fmaf_rn(-j, 6.28318548f, x);
  r = __fmaf_rn(-j, -1.74845553e-07f, r);
  __sincosf(r, &s, &c);
}

// pull_ab in explicit FMAs: the NHT pullback takes no decision, so it
// need not keep the file's no-contraction order.
template <int kDeg>
__device__ __forceinline__ GradAB pull_ab_fma(const gut::Hit& h, float g_eff,
                                              float dens, float g_tc,
                                              const gut::RasterParams& p) {
  const float d_resp = __fmul_rn(g_eff, dens);
  const float slope = kDeg == 4
      ? __fmul_rn(__fmul_rn(h.resp, p.gg_scale), __fmul_rn(2.0f, h.sq))
      : __fmul_rn(h.resp, p.gg_scale);
  const float d_sq = __fmul_rn(d_resp, slope);
  const float d_q = -__fmul_rn(g_tc, h.inv_m);
  const float d_inv_m = __fmaf_rn(d_sq, h.c2, -__fmul_rn(g_tc, h.q));
  const float d_c2 = __fmul_rn(d_sq, h.inv_m);
  const float d_m2 = -2.0f * __fmul_rn(__fmul_rn(d_inv_m, h.inv_m), h.inv_m);
  const float gcx = __fmul_rn(2.0f * d_c2, h.cx);
  const float gcy = __fmul_rn(2.0f * d_c2, h.cy);
  const float gcz = __fmul_rn(2.0f * d_c2, h.cz);
  GradAB g;
  g.ax = __fmaf_rn(d_q, h.bx, __fmaf_rn(h.by, gcz, -__fmul_rn(h.bz, gcy)));
  g.ay = __fmaf_rn(d_q, h.by, __fmaf_rn(h.bz, gcx, -__fmul_rn(h.bx, gcz)));
  g.az = __fmaf_rn(d_q, h.bz, __fmaf_rn(h.bx, gcy, -__fmul_rn(h.by, gcx)));
  g.bx = __fmaf_rn(d_m2, h.bx, __fmaf_rn(d_q, h.ax,
         __fmaf_rn(gcy, h.az, -__fmul_rn(gcz, h.ay))));
  g.by = __fmaf_rn(d_m2, h.by, __fmaf_rn(d_q, h.ay,
         __fmaf_rn(gcz, h.ax, -__fmul_rn(gcx, h.az))));
  g.bz = __fmaf_rn(d_m2, h.bz, __fmaf_rn(d_q, h.az,
         __fmaf_rn(gcx, h.ay, -__fmul_rn(gcy, h.ax))));
  return g;
}

// The ray features' part of one accepted hit: per control dim k, the
// blend b_k of the staged record r at the barycentric weights wb, its sine
// and cosine, their part of u (added to ``u``), the blend's cotangent e_k
// = w (cos b_k g_sin,k - sin b_k g_cos,k) (w held constant) into this
// lane's value row ``val``, and e_k's part of each barycentric weight's
// cotangent (added to ``dw``). Returns whether a blend was past
// kTrigFastMax (kAccurate: the libdevice sincosf, never).
__device__ __forceinline__ float part4(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

template <bool kAccurate>
__device__ __forceinline__ bool nht_features(
    const float* row, const float (&wb)[4],
    const float (&gs)[gut::kNhtDim], const float (&gc)[gut::kNhtDim],
    float w, float* val, float& u, float (&dw)[4]) {
  bool far = false;
  // control dims 4c .. 4c + 3: one float4 load a vertex
  auto dims = [&](int c) {
    float4 fv[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      fv[v] = *reinterpret_cast<const float4*>(
          row + kRowField + gut::kNhtFeat + v * gut::kNhtDim + 4 * c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * c + i;
      float f[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) f[v] = part4(fv[v], i);
      const float b = __fmaf_rn(wb[0], f[0], __fmaf_rn(wb[1], f[1],
                      __fmaf_rn(wb[2], f[2], __fmul_rn(wb[3], f[3]))));
      float sk, ck;
      if constexpr (kAccurate) {
        sincosf(b, &sk, &ck);
      } else {
        far |= !(fabsf(b) <= kTrigFastMax);
        sincos_fast(b, sk, ck);
      }
      u = __fmaf_rn(gs[k], sk, __fmaf_rn(gc[k], ck, u));
      const float e =
          __fmul_rn(w, __fmaf_rn(ck, gs[k], -__fmul_rn(sk, gc[k])));
#pragma unroll
      for (int v = 0; v < 4; ++v) dw[v] = __fmaf_rn(f[v], e, dw[v]);
      val[(kValE + k) * kValPad] = e;
    }
  };
  if constexpr (kAccurate) {
#pragma unroll 1
    for (int c = 0; c < gut::kNhtDim / 4; ++c) dims(c);
  } else {
#pragma unroll
    for (int c = 0; c < gut::kNhtDim / 4; ++c) dims(c);
  }
  return far;
}

template <int kDeg>
__global__ void __launch_bounds__(kBlock, 2)
raster_bwd_nht_kernel(const float* __restrict__ table,      // [C, 64]
                      const int32_t* __restrict__ pair_particle,  // [P]
                      const int32_t* __restrict__ tile_start,     // [T + 1]
                      const float* __restrict__ ray_o,      // [H, W, 3]
                      const float* __restrict__ ray_d,      // [H, W, 3]
                      const float* __restrict__ ray_tmin,   // [H, W]
                      const float* __restrict__ ray_tmax,   // [H, W]
                      const float* __restrict__ fwd_feat,   // [H, W, 24]
                      const float* __restrict__ fwd_depth,  // [H, W]
                      const float* __restrict__ fwd_tfinal,  // [H, W]
                      const float* __restrict__ g_feat,     // [H, W, 24]
                      const float* __restrict__ g_opacity,  // [H, W]
                      const float* __restrict__ g_depth_in,  // [H, W]
                      gut::RasterParams p,
                      float* __restrict__ d_records) {      // [P, 64]
  constexpr int kR = gut::kRecNht;
  constexpr int kD = gut::kNhtDim;
  extern __shared__ __align__(16) float s_dyn[];
  float* s_rec = s_dyn;   // kBatchNht rows of kRowNht
  float (*s_part)[kWarps][kGroupNht][kFieldsNht] =
      reinterpret_cast<float (*)[kWarps][kGroupNht][kFieldsNht]>(
          s_dyn + kNhtRecFloats);
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's value rows: row q of lane i at val[q * kValPad + i]
  float* val = s_dyn + kNhtRecFloats + kNhtPartFloats +
               warp * kValRows * kValPad;
  val[kValOnes * kValPad + lane] = 1.0f;
  // the two fields this lane sums over the touched lanes: field o0 is the
  // sum of val[rx] * val[ry0], o1 of val[rx] * val[ry1], so three loads an
  // item. Lanes 0-6 take the geometry fields in twos (rx the ones row:
  // an FMA by 1 is the plain add); lanes 7-30 a blend cotangent e_k with
  // the weights of vertices 0 and 1 or 2 and 3; lane 31 none (-1).
  int rx, ry0, ry1, o0, o1;
  if (lane < 7) {
    rx = kValOnes;
    ry0 = 2 * lane;
    ry1 = 2 * lane + 1;
    o0 = 2 * lane;
    o1 = 2 * lane + 1 < gut::kNhtFeat ? 2 * lane + 1 : -1;
  } else if (lane < 31) {
    const int k = (lane - 7) % kD, v = 2 * ((lane - 7) / kD);
    rx = kValE + k;
    ry0 = kValBary + v;
    ry1 = kValBary + v + 1;
    o0 = gut::kNhtFeat + v * kD + k;
    o1 = o0 + kD;
  } else {
    rx = ry0 = ry1 = kValOnes;
    o0 = o1 = -1;
  }
  const float* vx = val + rx * kValPad;
  const float* vy0 = val + ry0 * kValPad;
  const float* vy1 = val + ry1 * kValPad;
  const int px = (tile % p.grid_x) * kTile + threadIdx.x % kTile;
  const int py = (tile / p.grid_x) * kTile + threadIdx.x / kTile;
  const bool inside = px < p.width && py < p.height;
  const int64_t pix = static_cast<int64_t>(py) * p.width + px;

  const gut::Ray ray =
      gut::load_ray<true>(ray_o, ray_d, ray_tmin, ray_tmax, inside, pix);
  // upstream gradients of the (sin, cos) ray features, per control dim
  float gs[kD], gc[kD];
  float g_t = 0.f, gd = 0.f, t_final = 0.f, phi_total = 0.f;
#pragma unroll
  for (int k = 0; k < kD; ++k) gs[k] = gc[k] = 0.f;
  if (inside) {
    g_t = -g_opacity[pix];
    gd = g_depth_in[pix];
    t_final = fwd_tfinal[pix];
    phi_total = gd * fwd_depth[pix];
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      gs[k] = g_feat[2 * kD * pix + 2 * k];
      gc[k] = g_feat[2 * kD * pix + 2 * k + 1];
      phi_total += gs[k] * fwd_feat[2 * kD * pix + 2 * k] +
                   gc[k] * fwd_feat[2 * kD * pix + 2 * k + 1];
    }
  }
  bool alive = inside;
  float trans = 1.f;    // T before the current candidate
  float psi_acc = 0.f;  // inclusive prefix of w * u

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  int group = 0;        // running group count: picks the s_part buffer
  bool done = false;
  for (int base = start; base < end && !done; base += kBatchNht) {
    // the previous batch's reads of s_rec are over before restaging
    __syncthreads();
    const int idx = base + threadIdx.x;
    if (threadIdx.x < kBatchNht && idx < end) {
      // the row shifted by kRowField: each float4 stored takes the last
      // three fields of one float4 read and the first of the next
      const float4* src = reinterpret_cast<const float4*>(
          table + static_cast<int64_t>(pair_particle[idx]) * kR);
      float4* dst = reinterpret_cast<float4*>(s_rec + threadIdx.x * kRowNht);
      float4 prev = make_float4(0.f, 0.f, 0.f, 0.f);
      float dens = 0.f;
#pragma unroll
      for (int q = 0; q < kR / 4; ++q) {
        const float4 cur = src[q];
        if (q == gut::kDensity / 4) dens = cur.x;
        dst[q] = make_float4(prev.y, prev.z, prev.w, cur.x);
        prev = cur;
      }
      dst[kR / 4] = make_float4(prev.y, prev.z, prev.w,
                                gut::sq_threshold<kDeg>(dens, p));
    }
    __syncthreads();
    const int nb = min(kBatchNht, end - base);
    for (int g0 = 0; g0 < nb; g0 += kGroupNht, ++group) {
      float (*part)[kGroupNht][kFieldsNht] = s_part[group & 1];
      const int ng = min(kGroupNht, nb - g0);
      for (int jj = 0; jj < ng; ++jj) {
        const float* row = s_rec + (g0 + jj) * kRowNht;
        const float* r = row + kRowField;   // field f at r[f]
        // the geometry fields for the test: four float4 loads
        float geo[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 t = reinterpret_cast<const float4*>(row)[q];
          geo[4 * q + 0] = t.x;
          geo[4 * q + 1] = t.y;
          geo[4 * q + 2] = t.z;
          geo[4 * q + 3] = t.w;
        }
        bool touched = false;
        gut::Hit h;
        if (alive &&
            gut::eval_hit_general<kDeg>(geo + kRowField, 1, ray,
                                        row[kRowNht - 1], p, h)) {
          const gut::NhtHit n = gut::nht_hit(h);
          const float w = h.alpha * trans;
          float u = gd * h.hit_t;
          float dw[4] = {0.f, 0.f, 0.f, 0.f};
          if (nht_features<false>(row, n.w, gs, gc, w, val + lane, u,
                                  dw)) {
            // a blend past the fast sine's range: the accurate one
            u = gd * h.hit_t;
#pragma unroll
            for (int v = 0; v < 4; ++v) dw[v] = 0.f;
            nht_features<true>(row, n.w, gs, gc, w, val + lane, u, dw);
          }
          psi_acc = __fmaf_rn(w, u, psi_acc);
          const float suffix = phi_total - psi_acc;
          const float g_alpha =
              __fmaf_rn(trans, u, -(suffix + g_t * t_final) /
                                      fmaxf(1.0f - h.alpha, 1e-6f));
          if (w > 0.f) {
            touched = true;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              val[(kValBary + v) * kValPad + lane] = n.w[v];
            }
            // w_i = G_i . (c - v0), w_0 = 1 - w_1 - w_2 - w_3
            const float d1 = dw[1] - dw[0], d2 = dw[2] - dw[0],
                        d3 = dw[3] - dw[0];
            const float dcx = __fmul_rn(gut::kTetG1x, d1);
            const float dcy = __fmaf_rn(gut::kTetG1y, d1,
                                        __fmul_rn(gut::kTetG2y, d2));
            const float dcz = __fmaf_rn(gut::kTetG1z, d1, __fmaf_rn(
                gut::kTetG2z, d2, __fmul_rn(gut::kTetG3z, d3)));
            // c = a + b tc: tc's cotangent joins the hit distance's
            const float g_tc = __fmaf_rn(__fmul_rn(gd, w), ray.dn,
                __fmaf_rn(dcx, h.bx, __fmaf_rn(dcy, h.by,
                                               __fmul_rn(dcz, h.bz))));
            const float g_eff = h.alpha_raw < p.max_alpha ? g_alpha : 0.f;
            const GradAB g = pull_ab_fma<kDeg>(
                h, g_eff, r[gut::kDensity], g_tc, p);
            const float gax = g.ax + dcx, gay = g.ay + dcy, gaz = g.az + dcz;
            const float gbx = __fmaf_rn(dcx, n.tc, g.bx);
            const float gby = __fmaf_rn(dcy, n.tc, g.by);
            const float gbz = __fmaf_rn(dcz, n.tc, g.bz);
            // d_p = -M^T d_a, d_M[i][k] = d_a[i] e[k] + d_b[i] d[k]
            const float ga[3] = {gax, gay, gaz}, gb[3] = {gbx, gby, gbz};
            const float ee[3] = {h.ex, h.ey, h.ez};
            const float dd[3] = {ray.dx, ray.dy, ray.dz};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              val[c * kValPad + lane] = -__fmaf_rn(
                  r[3 + c], gax, __fmaf_rn(r[6 + c], gay,
                                           __fmul_rn(r[9 + c], gaz)));
            }
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                val[(3 + 3 * i + c) * kValPad + lane] =
                    __fmaf_rn(ga[i], ee[c], __fmul_rn(gb[i], dd[c]));
              }
            }
            val[gut::kDensity * kValPad + lane] = __fmul_rn(g_eff, h.resp);
          }
          trans *= 1.0f - h.alpha;
          // exact kill: T_final froze here in the forward too
          if (trans < p.min_transmittance) alive = false;
        }
        // the warp's sums over the touched lanes, from the highest lane
        // down (a fixed order; an untouched lane's zeros are skipped,
        // which changes no sum)
        unsigned m = __ballot_sync(kFull, touched);
        float* out = part[warp][jj];
        float acc0 = 0.f, acc1 = 0.f;
        __syncwarp();   // the value rows are written
        if (m) {
          // each touched lane's three loads are issued before the
          // previous lane's two FMAs
          int i = 31 - __clz(m);
          float x = vx[i], y0 = vy0[i], y1 = vy1[i];
          for (m ^= 1u << i; m; m ^= 1u << i) {
            i = 31 - __clz(m);
            const float xn = vx[i], y0n = vy0[i], y1n = vy1[i];
            acc0 = __fmaf_rn(x, y0, acc0);
            acc1 = __fmaf_rn(x, y1, acc1);
            x = xn;
            y0 = y0n;
            y1 = y1n;
          }
          acc0 = __fmaf_rn(x, y0, acc0);
          acc1 = __fmaf_rn(x, y1, acc1);
        }
        __syncwarp();   // read before the next pair writes them
        if (o0 >= 0) out[o0] = acc0;
        if (o1 >= 0) out[o1] = acc1;
      }
      const int n_alive = __syncthreads_count(alive);
      // sum the 8 warp partials of each (pair, field) in warp order
      for (int t = threadIdx.x; t < ng * kFieldsNht; t += kBlock) {
        const int jj = t / kFieldsNht;
        const int f = t % kFieldsNht;
        float acc = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) acc += part[wi][jj][f];
        d_records[static_cast<int64_t>(base + g0 + jj) * kR + f] = acc;
      }
      if (n_alive == 0) {
        done = true;   // every pixel dead: later pairs keep their zeros
        break;
      }
    }
  }
}

}  // namespace

// degree: 2 or 4; window: 0 (global-Z order), 16 (sorted mode) or 128
// (trace); general: 1 reads ray_o (the general-geometry mode), 0 ignores
// it; nht: 1 for the NHT mode (64-float records, 24 features; general,
// window 0 only); shared: 1 walks one segment in every block and writes
// block t's rows at t x segment length (common.cuh:launch_raster lists
// the combinations built).
extern "C" int raster_bwd_launch(
    const float* table, const int32_t* pair_particle,
    const int32_t* tile_start, const float* ray_o, const float* ray_d,
    const float* ray_tmin, const float* ray_tmax, const float* fwd_feat,
    const float* fwd_depth, const float* fwd_tfinal, const float* g_feat,
    const float* g_opacity, const float* g_depth, int width, int height,
    int grid_x, int num_tiles, int degree, int window, int general, int nht,
    int shared, float min_transmittance, float max_alpha,
    float sq_thr_response, float log_min_alpha, float gg_scale,
    float* d_records, void* stream) {
  gut::RasterParams p{width, height, grid_x, min_transmittance, max_alpha,
                      sq_thr_response, log_min_alpha, gg_scale};
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const auto stream_ = static_cast<cudaStream_t>(stream);
  if (nht) {
    if (shared) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t attr = cudaSuccess;
    const int err = gut::launch_nht(degree, window, general, [&](auto deg) {
      const auto kernel = raster_bwd_nht_kernel<decltype(deg)::value>;
      attr = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNhtSmemBytes);
      if (attr != cudaSuccess) return;
      kernel<<<num_tiles, kBlock, kNhtSmemBytes, stream_>>>(
          table, pair_particle, tile_start, ray_o, ray_d, ray_tmin, ray_tmax,
          fwd_feat, fwd_depth, fwd_tfinal, g_feat, g_opacity, g_depth, p,
          d_records);
    });
    return attr != cudaSuccess ? static_cast<int>(attr) : err;
  }
  cudaError_t attr = cudaSuccess;
  const int err = gut::launch_raster<false>(
      degree, window, general, shared, 0,
      [&](auto deg, auto win, auto gen, auto sh, auto) {
        if constexpr (decltype(win)::value == gut::kTraceW) {
          const auto kernel = raster_bwd_trace_kernel<decltype(sh)::value>;
          attr = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              kTraceSmemBytes);
          if (attr != cudaSuccess) return;
          kernel<<<num_tiles, kBlock, kTraceSmemBytes, stream_>>>(
              table, pair_particle, tile_start, ray_o, ray_d, ray_tmin,
              ray_tmax, fwd_feat, fwd_depth, fwd_tfinal, g_feat, g_opacity,
              g_depth, p, d_records);
        } else {
          raster_bwd_kernel<decltype(deg)::value, decltype(win)::value,
                            decltype(gen)::value, decltype(sh)::value>
              <<<num_tiles, kBlock, 0, stream_>>>(
                  table, pair_particle, tile_start, ray_o, ray_d, ray_tmin,
                  ray_tmax, fwd_feat, fwd_depth, fwd_tfinal, g_feat,
                  g_opacity, g_depth, p, d_records);
        }
      });
  return attr != cudaSuccess ? static_cast<int>(attr) : err;
}

// Registers, local (spill and stack) bytes, static shared bytes and
// dynamic shared bytes a launch asks for, of kernel C's NHT mode at degree
// 2 then 4, then of its trace modes over per-block segments (the grid)
// then a shared segment: out[4 i + 0..3]. Returns the first error.
extern "C" int raster_bwd_attributes(int* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(raster_bwd_nht_kernel<2>),
      reinterpret_cast<const void*>(raster_bwd_nht_kernel<4>),
      reinterpret_cast<const void*>(raster_bwd_trace_kernel<false>),
      reinterpret_cast<const void*>(raster_bwd_trace_kernel<true>)};
  const int dyn[] = {kNhtSmemBytes, kNhtSmemBytes, kTraceSmemBytes,
                     kTraceSmemBytes};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[4 * i + 0] = a.numRegs;
    out[4 * i + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * i + 2] = static_cast<int>(a.sharedSizeBytes);
    out[4 * i + 3] = dyn[i];
  }
  return 0;
}

namespace {

// The NHT mode's sine and cosine on given arguments (sincos_fast within
// kTrigFastMax, the libdevice sincosf past it), for measuring its error on
// the card.
__global__ void nht_sincos_kernel(const float* __restrict__ x, int n,
                                  float* __restrict__ s,
                                  float* __restrict__ c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float si, ci;
  if (fabsf(x[i]) <= kTrigFastMax) {
    sincos_fast(x[i], si, ci);
  } else {
    sincosf(x[i], &si, &ci);
  }
  s[i] = si;
  c[i] = ci;
}

}  // namespace

extern "C" int nht_sincos_launch(const float* x, int n, float* s, float* c,
                                 void* stream) {
  if (n > 0) {
    nht_sincos_kernel<<<(n + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, n, s, c);
  }
  return static_cast<int>(cudaGetLastError());
}
