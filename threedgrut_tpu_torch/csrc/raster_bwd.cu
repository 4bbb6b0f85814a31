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
// Reduction over pixels and what bounds this kernel on the card. Its
// bound (chip_smoke.py:BWD_ACCEPT_FLOPS) is the hit test of every (pixel,
// pair) and ~100-140 operations a composited candidate; its time goes to
// issuing instructions. A breakdown of the earlier design (each suspect
// taken away in turn, on chip_smoke.py phases 8, 14 and 20's inputs;
// PERF.md §6, H100 80GB HBM3, 700 W) put it beside the walk (the test, T
// and the kill, 0.38-1.25 ms) in a per-(warp, pair) xor butterfly of the 16
// values (0.2-1.0 ms), in the publish of zeros, a barrier every 16 pairs
// and the 8-warp sum of every pair even where no pixel touched it (0.4 ms
// at 3DGUT, 6.7 of trace's brute force), and in the pullback (0.1-0.5 ms,
// under -fmad=false). So:
//  - a warp whose lanes touch no pair costs a ballot; one with a touched
//    lane writes its 32 lanes' values (zeros for an untouched lane) to
//    its value rows in shared memory with four float4 stores, each lane
//    sums one field over its half warp's 16 rows in a fixed order
//    (half_sum), one shuffle adds the two halves, and the warp's sum goes
//    to its partial of the pair with the pair's bit in its mask;
//  - a group of 32 pairs (W = 16: a window) ends at one barrier; the
//    pairs some warp touched are summed over the warps that touched them
//    in warp order and written once; the rest keep the wrapper's zeros;
//  - warp w takes the 8x4 pixel block (w % 2, w / 2) of the tile, not two
//    rows: a particle's footprint touches fewer warps, so fewer warps run
//    the pullback and the sum for it (up to 6% of the time);
//  - the pullback and the suffix residual are in explicit FMAs (the
//    division an approximate one); the hit test, T and the kill keep
//    kernel B's unfused operations, so the decisions are B's.
// No atomics on gradient values and a fixed order throughout: bitwise
// repeatable; a pair belongs to one tile, so rows never race. What is
// left is the walk and, at ~9 composited pixels of 32 a touched warp,
// the pullback and the sum run with most lanes idle (the breakdown of
// this design in PERF.md §6). The block leaves once every pixel is dead
// (__syncthreads_count at each group's barrier); pairs it never reaches,
// and culled pairs past the last tile, keep the wrapper's zeros. Dynamic
// shared memory 70,656 bytes, at most 80 registers: three blocks an SM.
//
// Sorted mode: windows of W pairs aligned on the global pair index and
// cut to the tile, in kernel B's order (raster_fwd.cu). Per window each
// thread sorts its accepted candidates by hit_t (common.cuh:sort_window,
// which keeps each candidate's alpha beside its key) and walks them in
// that order: T, the psi prefix (so the residual S_j) and the kill
// follow the sorted walk, as in the forward, with no second test. It
// keeps g_alpha and w by the pair's window lane (the TPU kernel's
// bitonic_replay_unsort); then the warp pulls back each window lane one
// of its pixels touched, in lane order (testing it again there), through
// the global-Z order's sum. Pulling each candidate back as it is
// composited instead needs a sum keyed by window lane at every step of
// the walk; measured, it was no faster at 800x800 and 22% slower in the
// general mode (PERF.md §6). The touched lanes all lie in the
// tile's [start, end).
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
//  - Sine and cosine: common.cuh:sincos_fast, a two-constant Cody-Waite
//    step onto [-pi, pi] and the SFU (__sincosf), within 1e-6 of float64
//    on the card for blends up to kTrigFastMax = 2^20 (chip_smoke.py
//    phase 27 measures it); a hit whose blends may pass that
//    (common.cuh:nht_far) takes the accurate libdevice sincosf
//    (nht_features<true>), out of the unrolled loop. Kernel B takes the
//    same sines (common.cuh:nht_dims), so the residual's F and u agree.
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
// forward's. What decides nothing (the pullbacks, the residual, the NHT
// features) is written in explicit FMAs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using gut::kBlock;
using gut::kRec;
using gut::kTile;

constexpr int kBatch = 256;        // pairs staged per batch
constexpr int kStaged = kRec + 1;  // + squared-distance threshold
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

// The cotangents of a and b of one accepted candidate (_fast_pullback)
// through alpha = min(max_alpha, resp(sq) density), sq = |a x b|^2 / |b|^2
// (g_eff: alpha's cotangent where alpha_raw is under max_alpha, else 0)
// and tc = -(a . b) / |b|^2 (g_tc), with b = M d. The pullback takes no
// decision, so it is written in explicit FMAs under the file's
// -fmad=false.
struct GradAB {
  float ax, ay, az, bx, by, bz;
};

template <int kDeg>
__device__ __forceinline__ GradAB pull_ab(const gut::Hit& h, float g_eff,
                                          float dens, float g_tc,
                                          const gut::RasterParams& p) {
  const float d_resp = __fmul_rn(g_eff, dens);
  // particle_response_dsq: d resp / d sq
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
  // c = a x b: d_a = b x g_c, d_b = g_c x a; q = a . b; m = |b|^2
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

// The general mode's map of (d_a, d_b) through a = M e, e = o - p and
// b = M d onto rows 0-11 of its record (field f at r[f * stride]):
// d_p = -M^T d_a, d_M[i][k] = d_a[i] e[k] + d_b[i] d[k].
__device__ __forceinline__ void general_rows(const GradAB& g,
                                             const gut::Hit& h,
                                             const float* r, int stride,
                                             const gut::Ray& ray,
                                             float* d, int d_stride) {
  const float ga[3] = {g.ax, g.ay, g.az}, gb[3] = {g.bx, g.by, g.bz};
  const float ee[3] = {h.ex, h.ey, h.ez};
  const float dd[3] = {ray.dx, ray.dy, ray.dz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c * d_stride] = -__fmaf_rn(
        r[(3 + c) * stride], g.ax, __fmaf_rn(r[(6 + c) * stride], g.ay,
                                             __fmul_rn(r[(9 + c) * stride],
                                                       g.az)));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d[(3 + 3 * i + c) * d_stride] =
          __fmaf_rn(ga[i], ee[c], __fmul_rn(gb[i], dd[c]));
    }
  }
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
  const float g_ht = kGen ? __fmul_rn(__fmul_rn(gd, w), ray.dn)
                          : __fmul_rn(gd, w);
  // alpha = min(max_alpha, alpha_raw): no gradient when clamped
  const float g_eff = h.alpha_raw < p.max_alpha ? g_alpha : 0.f;
  const GradAB g =
      pull_ab<kDeg>(h, g_eff, r[gut::kDensity * stride], g_ht, p);
  if constexpr (kGen) {
    general_rows(g, h, r, stride, ray, d, 1);
  } else {
    const float gb[3] = {g.bx, g.by, g.bz};
    const float dd[3] = {ray.dx, ray.dy, ray.dz};
    d[0] = g.ax;
    d[1] = g.ay;
    d[2] = g.az;
    // b = M d: d_M[i][k] = d_b[i] * d[k] (row-major M)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) d[3 + 3 * i + c] = __fmul_rn(gb[i], dd[c]);
    }
  }
  d[12] = __fmul_rn(g_eff, h.resp);
  d[13] = __fmul_rn(gf0, w);
  d[14] = __fmul_rn(gf1, w);
  d[15] = __fmul_rn(gf2, w);
}

// ---- the RGB modes (raster_bwd_kernel) ----

// pairs per block-level reduction group in global-Z order (W = 0); the
// sorted mode reduces each window of W
constexpr int kGroup = 32;
// a lane's value row: its 16 values padded to 20 floats, so the four
// float4 stores of 8 lanes at a time fall in distinct banks
constexpr int kValRow = 20;
// dynamic shared memory, floats: the staged records and thresholds, each
// warp's value rows, and the warp partials of two groups ([warp][pair]
// [field]; a window of 16 takes half the room)
constexpr int kRgbRecFloats = kStaged * kBatch;
constexpr int kRgbValFloats = kWarps * 32 * kValRow;
constexpr int kRgbAccFloats = 2 * kWarps * kGroup * kRec;
constexpr int kRgbSmemBytes =
    (kRgbRecFloats + kRgbValFloats + kRgbAccFloats) * 4;
// blocks an SM: the shared memory of three fits the SM's 228 KB
constexpr int kRgbBlocksPerSm = 3;

// A lane's 16 values into its value row (zeros for an untouched lane):
// four float4 stores.
__device__ __forceinline__ void store_row(float* row, const float (&d)[kRec],
                                          bool touched) {
  float4* r4 = reinterpret_cast<float4*>(row);
  if (touched) {
#pragma unroll
    for (int q = 0; q < kRec / 4; ++q) {
      r4[q] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kRec / 4; ++q) r4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Field ``fld`` of the lanes of this lane's half warp (rows at
// val[(h0 + i) * kValRow], h0 = lane & 16; an untouched lane's row holds
// zeros): every row is read at once and summed in a fixed order (four
// running sums over i mod 4, then (0 + 1) + (2 + 3)); then lanes 0-15
// add the upper half's sum, so they hold the warp's.
__device__ __forceinline__ float half_sum(const float* val, int fld,
                                          int lane) {
  const int h0 = lane & 16;
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = val[(h0 + i) * kValRow + fld];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i & 3] += v[i];
  const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  return sum + __shfl_down_sync(kFull, sum, 16);
}

template <int kDeg, int kW, bool kGen, bool kShared>
__global__ void __launch_bounds__(kBlock, kRgbBlocksPerSm)
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
  constexpr int kWin = kW > 0 ? kW : 1;
  static_assert(kW == 0 || kW == 16, "windows of 16: a window in a group");
  extern __shared__ __align__(16) float s_dyn[];
  float (*s_rec)[kBatch] = reinterpret_cast<float (*)[kBatch]>(s_dyn);
  float* const s_acc = s_dyn + kRgbRecFloats + kRgbValFloats;
  // each warp's touched pairs of a group or window, for two in turn
  __shared__ uint32_t s_wmask[2][kWarps];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's value rows: lane i's value f at val[i * kValRow + f]
  float* const val = s_dyn + kRgbRecFloats + warp * 32 * kValRow;
  // the field this lane sums, over the lanes of its half of the warp
  const int fld = lane & 15;
  // warp w covers the 8x4 pixel block (w % 2, w / 2) of the tile
  const int px = (tile % p.grid_x) * kTile + (threadIdx.x >> 5) % 2 * 8 +
                 (threadIdx.x & 7);
  const int py = (tile / p.grid_x) * kTile + (threadIdx.x >> 6) * 4 +
                 ((threadIdx.x >> 3) & 3);
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
  // composite accepted candidate j (its alpha and hit_t) at this pixel's
  // place in the walk: returns w and sets g_alpha, its suffix-sum
  // cotangent (the residual in FMAs, the division approximate: they
  // decide nothing; T, w and the kill keep kernel B's unfused products)
  auto composite = [&](float alpha, float hit_t, int j, float& g_alpha) {
    const float w = alpha * trans;
    const float u = __fmaf_rn(gf0, s_rec[gut::kRgb + 0][j], __fmaf_rn(
        gf1, s_rec[gut::kRgb + 1][j], __fmaf_rn(
            gf2, s_rec[gut::kRgb + 2][j], __fmul_rn(gd, hit_t))));
    psi_acc = __fmaf_rn(w, u, psi_acc);
    const float suffix = phi_total - psi_acc;
    g_alpha = __fmaf_rn(trans, u,
                        -__fdividef(__fmaf_rn(g_t, t_final, suffix),
                                    fmaxf(1.0f - alpha, 1e-6f)));
    trans *= 1.0f - alpha;
    // exact kill: T_final froze here in the forward too
    if (trans < p.min_transmittance) alive = false;
    return w;
  };
  // this warp's sum of the pullbacks d of the lanes that touched staged
  // pair j (touched), as lanes 0-15's fields of part (this warp's
  // partial of the pair); false when no lane did
  auto reduce = [&](bool touched, const float (&d)[kRec], float* part) {
    const unsigned m = __ballot_sync(kFull, touched);
    if (m == 0u) return false;
    store_row(val + lane * kValRow, d, touched);
    __syncwarp();
    const float acc = half_sum(val, fld, lane);
    if (lane < 16) part[lane] = acc;
    __syncwarp();   // read before the next pair's rows are written
    return true;
  };
  // after the barrier that ends a group of pairs (W = 16: a window),
  // each pair some warp touched (bit jj of the warps' masks in wmasks):
  // its 16 fields summed over the warps that touched it, in warp order
  // (warp wi's partial of pair jj at parts[(wi * n + jj) * kRec]), and
  // written to row row0 + jj; rows no pixel touched keep the wrapper's
  // zeros
  auto flush = [&](const uint32_t* wmasks, const float* parts, int n,
                   int64_t row0) {
    uint32_t wm[kWarps], any = 0u;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      wm[wi] = wmasks[wi];
      any |= wm[wi];
    }
    for (int item = threadIdx.x; item < __popc(any) * kRec; item += kBlock) {
      const int jj = __fns(any, 0, item / kRec + 1);
      const int f = item % kRec;
      float acc = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        if ((wm[wi] >> jj) & 1u) acc += parts[(wi * n + jj) * kRec + f];
      }
      d_records[(row0 + jj) * kRec + f] = acc;
    }
  };

  // kShared: every block walks the one segment [tile_start[0],
  // tile_start[1]) and writes pair idx to row tile (end - start) + idx -
  // start
  const int start = tile_start[kShared ? 0 : tile];
  const int end = tile_start[kShared ? 1 : tile + 1];
  const int64_t rows0 =
      kShared ? static_cast<int64_t>(tile) * (end - start) - start : 0;
  // sorted mode: batches (and so windows) start on a multiple of W
  const int first = start - start % kWin;
  int group = 0;        // running group (window) count: picks the buffer
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
        // this warp's partials of the group's pairs: field f of pair jj at
        // part[jj * kRec + f]
        float* const part =
            s_acc + ((group & 1) * kWarps + warp) * kGroup * kRec;
        const int ng = min(kGroup, nb - g0);
        uint32_t wmask = 0;   // the group's pairs some lane touched
        // a warp whose pixels are all dead has nothing to add
        for (int jj = 0; jj < ng && __any_sync(kFull, alive); ++jj) {
          const int j = g0 + jj;
          float d[kRec];
          bool touched = false;
          gut::Hit h;
          if (alive && gut::eval_ray<kDeg, kGen>(&s_rec[0][j], kBatch, ray,
                                                 s_rec[kRec][j], p, h)) {
            float g_alpha;
            const float w = composite(h.alpha, h.hit_t, j, g_alpha);
            touched = w > 0.f;
            if (touched) {
              pullback<kDeg, kGen>(h, &s_rec[0][j], kBatch, g_alpha, w,
                                   gf0, gf1, gf2, gd, ray, p, d);
            }
          }
          if (reduce(touched, d, part + jj * kRec)) wmask |= 1u << jj;
        }
        if (lane == 0) s_wmask[group & 1][warp] = wmask;
        const int n_alive = __syncthreads_count(alive);
        flush(s_wmask[group & 1], s_acc + (group & 1) * kWarps * kGroup * kRec,
              kGroup, rows0 + base + g0);
        if (n_alive == 0) {
          done = true;   // every pixel dead: later pairs keep their zeros
          break;
        }
      }
    } else {
      const int lo0 = max(start - base, 0);   // lanes before the tile
      for (int w0 = 0; w0 < nb && !done; w0 += kWin, ++group) {
        // this warp's partials of the window's lanes: field f of window
        // lane k at part[k * kRec + f]
        float* const part =
            s_acc + ((group & 1) * kWarps + warp) * kWin * kRec;
        // the walk in the window's sorted order (the sort keeps each
        // candidate's alpha and hit_t, so no second test): g_alpha and w
        // of the window lanes this pixel composited and touched, by lane
        float ga[kWin], wv[kWin];
        uint32_t mine = 0u;
        if (alive) {
          float key[kWin], alpha[kWin];
          uint8_t order[kWin];
          const int n = gut::sort_window<kDeg, kWin, kGen>(
              &s_rec[0][0], kBatch, s_rec[kRec], max(w0, lo0),
              min(w0 + kWin, nb), ray, p, key, order, alpha);
          for (int i = 0; alive && i < n; ++i) {
            const int j = order[i];
            float g_alpha;
            const float w = composite(alpha[i], key[i], j, g_alpha);
            if (w > 0.f) {
              ga[j - w0] = g_alpha;
              wv[j - w0] = w;
              mine |= 1u << (j - w0);
            }
          }
        }
        // the window lanes some lane of the warp touched, in lane order:
        // each one's pullback on the lanes that touched it, reduced as in
        // global-Z order
        const uint32_t wmask = __reduce_or_sync(kFull, mine);
        for (uint32_t mm = wmask; mm; mm &= mm - 1u) {
          const int k = __ffs(mm) - 1;
          const bool touched = (mine >> k) & 1u;
          float d[kRec];
          if (touched) {
            const int j = w0 + k;
            gut::Hit h;
            gut::eval_ray<kDeg, kGen>(&s_rec[0][j], kBatch, ray,
                                      s_rec[kRec][j], p, h);
            pullback<kDeg, kGen>(h, &s_rec[0][j], kBatch, ga[k], wv[k], gf0,
                                 gf1, gf2, gd, ray, p, d);
          }
          reduce(touched, d, part + k * kRec);
        }
        if (lane == 0) s_wmask[group & 1][warp] = wmask;
        const int n_alive = __syncthreads_count(alive);
        // (the touched window lanes all lie in [start, end), where the
        // walk took its candidates)
        flush(s_wmask[group & 1], s_acc + (group & 1) * kWarps * kWin * kRec,
              kWin, rows0 + base + w0);
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
// a staged record's row: common.cuh:kNhtRow
constexpr int kRowField = gut::kNhtRowPad;
constexpr int kRowNht = gut::kNhtRow;
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

// The ray features' part of one accepted hit: per control dim k, the
// blend b_k of the staged row at the barycentric weights wb and its sine
// and cosine (common.cuh:nht_dims, which kernel B shares), their part of
// u (added to ``u``), the blend's cotangent e_k = w (cos b_k g_sin,k -
// sin b_k g_cos,k) (w held constant) into this lane's value row ``val``,
// and e_k's part of each barycentric weight's cotangent (added to
// ``dw``). kAccurate: the libdevice sincosf, for a hit that
// common.cuh:nht_far finds may pass the fast sine's range.
template <bool kAccurate>
__device__ __forceinline__ void nht_features(
    const float* row, const float (&wb)[4],
    const float (&gs)[gut::kNhtDim], const float (&gc)[gut::kNhtDim],
    float w, float* val, float& u, float (&dw)[4]) {
  // control dims 4c .. 4c + 3
  auto dims = [&](int c) {
    float f[4][4], sk[4], ck[4];
    gut::nht_dims<kAccurate>(row + kRowField + gut::kNhtFeat, wb, c, f, sk,
                             ck);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * c + i;
      u = __fmaf_rn(gs[k], sk[i], __fmaf_rn(gc[k], ck[i], u));
      const float e =
          __fmul_rn(w, __fmaf_rn(ck[i], gs[k], -__fmul_rn(sk[i], gc[k])));
#pragma unroll
      for (int v = 0; v < 4; ++v) dw[v] = __fmaf_rn(f[v][i], e, dw[v]);
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
      gut::stage_nht_row<kDeg>(
          table + static_cast<int64_t>(pair_particle[idx]) * kR,
          s_rec + threadIdx.x * kRowNht, p);
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
          // a blend that may pass the fast sine's range: the accurate one
          if (gut::nht_far(row, n.w)) {
            nht_features<true>(row, n.w, gs, gc, w, val + lane, u, dw);
          } else {
            nht_features<false>(row, n.w, gs, gc, w, val + lane, u, dw);
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
            const GradAB g = pull_ab<kDeg>(
                h, g_eff, r[gut::kDensity], g_tc, p);
            // d_a and d_b with c's cotangent, then onto p and M
            const GradAB gc_ab{g.ax + dcx, g.ay + dcy, g.az + dcz,
                               __fmaf_rn(dcx, n.tc, g.bx),
                               __fmaf_rn(dcy, n.tc, g.by),
                               __fmaf_rn(dcz, n.tc, g.bz)};
            general_rows(gc_ab, h, r, 1, ray, val + lane, kValPad);
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
          const auto kernel =
              raster_bwd_kernel<decltype(deg)::value, decltype(win)::value,
                                decltype(gen)::value, decltype(sh)::value>;
          attr = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              kRgbSmemBytes);
          if (attr != cudaSuccess) return;
          kernel<<<num_tiles, kBlock, kRgbSmemBytes, stream_>>>(
              table, pair_particle, tile_start, ray_o, ray_d, ray_tmin,
              ray_tmax, fwd_feat, fwd_depth, fwd_tfinal, g_feat, g_opacity,
              g_depth, p, d_records);
        }
      });
  return attr != cudaSuccess ? static_cast<int>(attr) : err;
}

// Registers, local (spill and stack) bytes, static shared bytes and
// dynamic shared bytes a launch asks for, of kernel C's NHT mode at degree
// 2 then 4, of its trace modes over per-block segments (the grid) then a
// shared segment, then of its RGB modes: shared origin at degree 2 and 4
// in global-Z order (W 0), then W 16; the same in the general mode; and
// the general W 0 shared-segment mode: out[4 i + 0..3]. Returns the first
// error.
extern "C" int raster_bwd_attributes(int* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(raster_bwd_nht_kernel<2>),
      reinterpret_cast<const void*>(raster_bwd_nht_kernel<4>),
      reinterpret_cast<const void*>(raster_bwd_trace_kernel<false>),
      reinterpret_cast<const void*>(raster_bwd_trace_kernel<true>),
      reinterpret_cast<const void*>(raster_bwd_kernel<2, 0, false, false>),
      reinterpret_cast<const void*>(raster_bwd_kernel<4, 0, false, false>),
      reinterpret_cast<const void*>(raster_bwd_kernel<2, 16, false, false>),
      reinterpret_cast<const void*>(raster_bwd_kernel<4, 16, false, false>),
      reinterpret_cast<const void*>(raster_bwd_kernel<2, 0, true, false>),
      reinterpret_cast<const void*>(raster_bwd_kernel<4, 0, true, false>),
      reinterpret_cast<const void*>(raster_bwd_kernel<2, 16, true, false>),
      reinterpret_cast<const void*>(raster_bwd_kernel<4, 16, true, false>),
      reinterpret_cast<const void*>(raster_bwd_kernel<4, 0, true, true>)};
  constexpr int n = sizeof(fns) / sizeof(fns[0]);
  for (int i = 0; i < n; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[4 * i + 0] = a.numRegs;
    out[4 * i + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * i + 2] = static_cast<int>(a.sharedSizeBytes);
    out[4 * i + 3] = i < 2 ? kNhtSmemBytes
                           : i < 4 ? kTraceSmemBytes : kRgbSmemBytes;
  }
  return 0;
}

namespace {

// The NHT sine and cosine on given arguments (common.cuh:sincos_fast
// within kTrigFastMax, the libdevice sincosf past it), for measuring its
// error on the card.
__global__ void nht_sincos_kernel(const float* __restrict__ x, int n,
                                  float* __restrict__ s,
                                  float* __restrict__ c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float si, ci;
  if (fabsf(x[i]) <= gut::kTrigFastMax) {
    gut::sincos_fast(x[i], si, ci);
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
