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
// (common.cuh:sort_list: insertion sort of the key, the alpha and an
// 8-bit offset in per-thread arrays; windows of 128 below), then
// composites them in that order with the kill. Windows follow each other
// in pair order, so T carries from one to the next as in the TPU kernel.
//
// General-geometry mode (kGen; raster.py:chunk_hits_general, the TPU's
// kernel 5, which a rolling-shutter camera or a caller's own rays take):
// every pixel has its own ray origin o, the record carries the particle
// position p in slots 0-2, and each (pixel, pair) forms a = M (o - p)
// (common.cuh:eval_hit_general); the hit distance is scaled by |d| as
// JAX's general one is. Everything else is the shared-origin walk.
//
// Pair batches: the block walks [tile_start[t], tile_start[t+1]) in
// batches of 256 pairs. Each thread stages one pair's 16-float record into
// shared memory, gathering it from the per-particle table through
// pair_particle (fusing render/gut.py's table[idx] gather: no [P, 16]
// records array exists). Every thread then reads the same staged record at
// the same time, a shared-memory broadcast.
//
// The RGB modes (rgb_forward: degree 2 in global-Z order and degree 2
// or 4 at W 16, shared or per-pixel origin, with or without normals;
// degree 4 in global-Z order below). A breakdown of the
// earlier design (raster_fwd_kernel then took them; each suspect taken
// away in turn on chip_smoke.py phases 4, 13 and 19's inputs; PERF.md §6,
// H100 80GB HBM3, 700 W) put 91-94% of its time in the test of every
// staged pair on every pixel: ~50 instructions, none contracted, since
// the decisions must stay those of kernels C and E and of the plain
// version. Staging, the gather and the barriers took 0.05-0.10 ms. So:
//  - a conservative per-warp cull (common.cuh, "kernels B and E in their
//    RGB modes"): the thread that stages a pair tests the particle
//    against each warp's pyramid of rays (its acceptance ellipsoid at
//    degree 2 in global-Z order, its sphere at W 16), and each warp's
//    rays walk only the lanes it keeps, in lane order (window by window
//    at W 16). The cull keeps every candidate the exact test accepts, so
//    the outputs are those of testing every pair, bit for bit. A bench
//    particle covers most of a tile: the ellipsoid culls 26-34% of the
//    tests, the sphere 10-17%; four blocks an SM at degree 2 in
//    global-Z order;
//  - warp w takes the 8x4 pixel block (w % 2, w / 2) of the tile, which
//    narrows its pyramid;
//  - records staged pair-major as float4 (common.cuh:kRgbRow): five
//    shared loads a test, not seventeen;
//  - at W 16 the sort keeps each accepted candidate's alpha beside its
//    key (common.cuh:sort_list), so only the normals test it again.
// Its bound is the test (~50 instructions) of what the cull leaves;
// normals take the same walk. Degree 4 in global-Z order keeps the
// earlier walk of every pair (raster_fwd_kernel): its rays die within a
// few dozen pairs, and there the staging, cull and lists cost more than
// they save (4-13% slower, PERF.md §6).
//
// Bound on this card: the per-(pixel, pair) arithmetic (~40 flops and one
// expf) and the latency of the one dependent gather per batch; device
// memory traffic is small (64 B per pair and block, 28 B per pixel out).
// Dead pixels drop out of the walk, and the block leaves once every pixel
// of the tile is dead (__syncthreads_count), as the reference does.
//
// NHT mode (raster_fwd_nht_kernel; raster.py's NHT mode, the TPU's kernel
// 8: tetra_barycentric :593 and nht_feature_weighted_sum :609 inside
// _fwd_strip_kernel). Always the general mode in global-Z order, as JAX
// runs NHT. The record is 64 floats (common.cuh:kRecNht): p, M, density
// and 4 x 12 tetrahedron control features. Per (pixel, pair) it takes
// eval_hit_general's a = M (o - p) and b = M d, forms the canonical hit
// point c = a - b (a . b) / |b|^2 and its barycentric weights
// (common.cuh:nht_hit), blends the 4 vertices' features for each of the
// 12 control dims and accumulates w sin and w cos of each into 24
// register accumulators: the 24 ray features. Its bound is that
// arithmetic (~180 operations a composited hit beside the general test).
// A breakdown of the earlier design (the RGB kernel's kNht branch; each
// suspect taken away in turn on chip_smoke.py phase 26's inputs; PERF.md
// §6, H100 80GB HBM3, 700 W) put 1.4 of its 2.0 ms (degree 2) in
// the features: the 12 libdevice sincosf 0.67 ms, -fmad=false 0.22 ms.
// So, in a kernel of its own:
//  - the features come from common.cuh:nht_dims, which kernel C's NHT
//    mode shares: blends in explicit FMAs, sincos_fast (a Cody-Waite step
//    and the SFU) and the accurate sincosf for a hit whose blends may
//    pass 2^20 (common.cuh:nht_far, from the largest |feature| staged in
//    the row's padding); the features accumulate in FMAs;
//  - the records are staged pair-major in rows of 68 floats
//    (common.cuh:kNhtRow: float4 loads of the test's fields and of a
//    vertex's four control dims), 128 pairs a batch;
//  - warp w takes the 8x4 pixel block (w % 2, w / 2) of the tile, so
//    fewer warps run the features for a particle's footprint (7%);
//  - at most 80 registers: three blocks an SM.
// The test, w, depth, hits, T and the kill keep the unfused operations
// and the order of the RGB walk, so opacity, depth, hits and T_final
// are those of the earlier design bit for bit; only the 24 features move
// (the sine; 4.2e-7 at most on the bench view).
//
// Shared-segment mode (kShared; raster.py:_fwd_strip_kernel with
// shared_segments :1158-1166, the TPU's kernel 7, which trace()'s brute
// force takes): every block composites the same depth-ranked segment
// [tile_start[0], tile_start[1]) instead of its own [tile_start[t],
// tile_start[t + 1]). The TPU kernel keeps the segment's chunks resident
// across grid steps; here each block stages it anew through the L2 (one
// 8192-slot segment is 512 KB of records, read by every block).
// trace() runs it in the general mode at degree 4, in global order or
// W = 128.
//
// Windows of 128 (kTrace: trace()'s sort_window = CHUNK, degree 4, the
// general mode, over per-block segments (the grid) or a shared segment
// (kernel 7)): the sorted mode's function, redesigned for this card. Its
// time was the exact test of every (ray, candidate) pair (5.4 of 6.9 ms
// on kernel 7's phase-31 inputs, 4.7 of 6.0 on the grid's phase-33 ones,
// by a breakdown of the earlier kernel on an H100 80GB HBM3 at 700 W,
// PERF.md §6), though it accepts 0.03% and 0.27% of them. So (common.cuh, "trace()'s windows of 128"):
//  - the thread that stages a pair tests its particle's sphere against
//    each warp's bundle of rays; each warp lists the lanes it keeps, in
//    lane order, and its rays walk only those (the phases keep 0.23% and
//    1.7% of the pairs); per ray a sphere test, then the exact test;
//  - per ray and window a register k-buffer of the kTraceK smallest
//    (hit_t, lane) keys replaces the 640 B of local-memory arrays; a ray
//    that accepts more takes another pass over the window's list for the
//    keys above the last it composited (g_window_overflows counts them).
// The cull keeps every candidate the exact test accepts, and the
// k-buffer composites them in the sorted mode's order, so the outputs
// are the unculled walk's bit for bit. Bound now: staging and the cull's
// tests (~30 operations a pair and warp), a few barriers a batch.
//
// Normals (kNormals; raster.py compute_normals :1238-1240, :1296-1299,
// per hit :436-449 and :531-550): sum w n of each pixel's composited
// candidates, n the hit's world normal (common.cuh:hit_normal), into a
// third output [H, W, 3]. Forward only, as in JAX: no cotangent.
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

template <int kDeg, int kW, bool kGen, bool kShared, bool kNormals>
__global__ void __launch_bounds__(kBlock)
raster_fwd_kernel(const float* __restrict__ table,        // [C, 16]
                  const int32_t* __restrict__ pair_particle,  // [P]
                  const int32_t* __restrict__ tile_start,     // [T + 1]
                  const float* __restrict__ ray_o,        // [H, W, 3], kGen
                  const float* __restrict__ ray_d,        // [H, W, 3]
                  const float* __restrict__ ray_tmin,     // [H, W]
                  const float* __restrict__ ray_tmax,     // [H, W]
                  gut::RasterParams p,
                  float* __restrict__ out_feat,           // [H, W, 3]
                  float* __restrict__ out_opacity,        // [H, W]
                  float* __restrict__ out_depth,          // [H, W]
                  float* __restrict__ out_hits,           // [H, W]
                  float* __restrict__ out_tfinal,         // [H, W]
                  float* __restrict__ out_normals) {      // [H, W, 3]
  constexpr int kBatch = 256;   // pairs staged per batch
  // trace()'s windows of 128: the cull and the k-buffer (common.cuh)
  constexpr bool kTrace = kW == gut::kTraceW;
  static_assert(kTrace ? (kGen && kDeg == 4) : kW == 0,
                "trace's modes, and global-Z order; rgb_forward takes W 16");
  // the record and the squared-distance threshold of each staged pair
  // (kTrace: then the cull's rows)
  __shared__ float s_rec[kRec + 1 + (kTrace ? gut::kCullRows : 0)][kBatch];
  // kTrace: each warp's bundle, the warps keeping each staged pair (a bit
  // each), and each warp's list of the lanes it keeps
  __shared__ gut::Bundle s_bundle[kTrace ? gut::kWarps : 1];
  __shared__ uint8_t s_keep[kTrace ? kBatch : 1];
  __shared__ uint8_t s_list[kTrace ? gut::kWarps : 1]
                           [kTrace ? kBatch : 1];

  const int tile = blockIdx.x;
  const int px = (tile % p.grid_x) * kTile + threadIdx.x % kTile;
  const int py = (tile / p.grid_x) * kTile + threadIdx.x / kTile;
  const bool inside = px < p.width && py < p.height;
  const int64_t pix = static_cast<int64_t>(py) * p.width + px;

  const gut::Ray ray =
      gut::load_ray<kGen>(ray_o, ray_d, ray_tmin, ray_tmax, inside, pix);
  bool alive = inside;
  float trans = 1.f, depth = 0.f, hits = 0.f;
  float feat[3] = {0.f, 0.f, 0.f};
  float nrm[3] = {0.f, 0.f, 0.f};   // kNormals: sum of w n
  constexpr int kWin = kW > 0 ? kW : 1;
  float dd = 0.f;   // kTrace: |d|^2, for the sphere test
  if constexpr (kTrace) {
    const int lane = threadIdx.x & 31;
    const gut::Bundle bd = gut::warp_bundle(ray, ray.tmax > ray.tmin, lane);
    if (lane == 0) s_bundle[threadIdx.x >> 5] = bd;
    dd = ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz;
  }
  // blend staged pair j, accepted with hit h, and apply the exact kill
  auto composite = [&](const gut::Hit& h, int j) {
    const float w = h.alpha * trans;
#pragma unroll
    for (int c = 0; c < 3; ++c) feat[c] += w * s_rec[gut::kRgb + c][j];
    if constexpr (kNormals) {
      const float3 n = gut::hit_normal(&s_rec[0][j], kBatch, h);
      nrm[0] += w * n.x;
      nrm[1] += w * n.y;
      nrm[2] += w * n.z;
    }
    depth += w * h.hit_t;
    hits += w > 0.f ? 1.f : 0.f;
    trans *= 1.0f - h.alpha;
    // exact kill: the ray stops once T drops below the threshold
    if (trans < p.min_transmittance) alive = false;
  };

  // kShared: every block walks the one segment [tile_start[0],
  // tile_start[1])
  const int start = tile_start[kShared ? 0 : tile];
  const int end = tile_start[kShared ? 1 : tile + 1];
  // windows of 128: batches (and so windows) start on a multiple of W
  const int first = start - start % kWin;
  for (int base = first; base < end; base += kBatch) {
    // all pixels of the tile dead (or off-image): the block is done
    if (__syncthreads_count(alive) == 0) break;
    const int idx = base + threadIdx.x;
    unsigned keep = 0u;   // kTrace: the warps that keep the pair
    if (idx >= start && idx < end) {
      const float4* row = reinterpret_cast<const float4*>(
          table + static_cast<int64_t>(pair_particle[idx]) * kRec);
#pragma unroll
      for (int q = 0; q < kRec / 4; ++q) {
        const float4 v = row[q];
        s_rec[4 * q + 0][threadIdx.x] = v.x;
        s_rec[4 * q + 1][threadIdx.x] = v.y;
        s_rec[4 * q + 2][threadIdx.x] = v.z;
        s_rec[4 * q + 3][threadIdx.x] = v.w;
      }
      s_rec[kRec][threadIdx.x] = gut::sq_threshold<kDeg>(
          s_rec[gut::kDensity][threadIdx.x], p);
      if constexpr (kTrace) {
        keep = gut::stage_cull(&s_rec[0][threadIdx.x], kBatch, s_bundle);
      }
    }
    if constexpr (kTrace) s_keep[threadIdx.x] = static_cast<uint8_t>(keep);
    __syncthreads();
    const int nb = min(kBatch, end - base);
    if constexpr (kW == 0) {
      for (int j = 0; alive && j < nb; ++j) {
        gut::Hit h;
        if (!gut::eval_ray<kDeg, kGen>(&s_rec[0][j], kBatch, ray,
                                       s_rec[kRec][j], p, h)) {
          continue;
        }
        composite(h, j);
      }
    } else {
      // the warp's listed lanes, window by window; per ray the k-buffer's
      // passes composite the accepted in (hit_t, lane) order
      const int warp = threadIdx.x >> 5;
      int n_first = 0;
      const int n_list = gut::warp_list(s_keep, kBatch, warp, threadIdx.x & 31,
                                        s_list[warp], n_first);
      for (int wi = 0; alive && wi < kBatch / kWin; ++wi) {
        uint64_t last = 0ull;   // every key is above 0
        bool more = true;
        while (alive && more) {
          uint64_t buf[gut::kTraceK];
          const int cnt = gut::kbuffer_pass<kDeg>(
              &s_rec[0][0], kBatch, s_list[warp], wi ? n_first : 0,
              wi ? n_list : n_first, ray, dd, p, last, buf);
          for (int q = 0; alive && q < min(cnt, gut::kTraceK); ++q) {
            last = gut::kbuffer_pop(buf);
            const int j = static_cast<int>(last & 0xffu);
            gut::Hit h;
            gut::eval_ray<kDeg, kGen>(&s_rec[0][j], kBatch, ray,
                                      s_rec[kRec][j], p, h);
            composite(h, j);
          }
          more = cnt > gut::kTraceK;
          if (more && alive) atomicAdd(&gut::g_window_overflows, 1ull);
        }
      }
    }
    __syncthreads();
  }
  if (inside) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out_feat[3 * pix + c] = feat[c];
    out_opacity[pix] = 1.0f - trans;
    out_depth[pix] = depth;
    out_hits[pix] = hits;
    out_tfinal[pix] = trans;
    if constexpr (kNormals) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out_normals[3 * pix + c] = nrm[c];
    }
  }
}

// ---- the RGB modes (rgb_forward) ----

// pairs staged per batch, one a thread
constexpr int kBatchRgb = kBlock;

template <int kDeg, int kW, bool kGen, bool kNormals>
__device__ __forceinline__ void rgb_forward(
    const float* __restrict__ table,            // [C, 16]
    const int32_t* __restrict__ pair_particle,  // [P]
    const int32_t* __restrict__ tile_start,     // [T + 1]
    const float* __restrict__ ray_o,            // [H, W, 3], kGen
    const float* __restrict__ ray_d,            // [H, W, 3]
    const float* __restrict__ ray_tmin,         // [H, W]
    const float* __restrict__ ray_tmax,         // [H, W]
    gut::RasterParams p,
    float* __restrict__ out_feat,               // [H, W, 3]
    float* __restrict__ out_opacity,            // [H, W]
    float* __restrict__ out_depth,              // [H, W]
    float* __restrict__ out_hits,               // [H, W]
    float* __restrict__ out_tfinal,             // [H, W]
    float* __restrict__ out_normals) {          // [H, W, 3]
  static_assert(kW == 0 || kW == 16, "launch_mode's windows");
  constexpr unsigned kFull = 0xffffffffu;
  // the batch's staged rows (common.cuh:kRgbRow), each warp's bundle, the
  // warps keeping each staged pair (a bit each) and each warp's list
  __shared__ __align__(16) float s_row[kBatchRgb * gut::kRgbRow];
  __shared__ gut::Bundle s_bundle[gut::kWarps];
  constexpr bool kEllipsoid = kW == 0 && kDeg == 2;
  __shared__ gut::PlaneQuads s_quads[kEllipsoid ? gut::kWarps : 1];
  __shared__ uint8_t s_keep[kBatchRgb];
  __shared__ uint8_t s_list[gut::kWarps][kBatchRgb];

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
  float trans = 1.f, depth = 0.f, hits = 0.f;
  float feat[3] = {0.f, 0.f, 0.f};
  float nrm[3] = {0.f, 0.f, 0.f};   // kNormals: sum of w n
  // blend a candidate accepted with alpha and hit_t (rgb: its three
  // colour fields; kNormals: its record r and hit h), then the exact kill
  auto composite = [&](float alpha, float hit_t, const float* rgb,
                       const float* r, const gut::Hit* h) {
    const float w = alpha * trans;
#pragma unroll
    for (int c = 0; c < 3; ++c) feat[c] += w * rgb[c];
    if constexpr (kNormals) {
      const float3 n = gut::hit_normal(r, 1, *h);
      nrm[0] += w * n.x;
      nrm[1] += w * n.y;
      nrm[2] += w * n.z;
    }
    depth += w * hit_t;
    hits += w > 0.f ? 1.f : 0.f;
    trans *= 1.0f - alpha;
    if (trans < p.min_transmittance) alive = false;
  };

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  // sorted mode: batches (and so windows) start on a multiple of W
  const int first = kW ? start - start % kW : start;
  for (int base = first; base < end; base += kBatchRgb) {
    // all pixels of the tile dead (or off-image): the block is done
    if (__syncthreads_count(alive) == 0) break;
    const int idx = base + threadIdx.x;
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
      n = gut::warp_list(s_keep, kBatchRgb, warp, lane, s_list[warp],
                         n_first);
    }
    if constexpr (kW == 0) {
      for (int i = 0; alive && i < n; ++i) {
        const float* row = s_row + list[i] * gut::kRgbRow;
        float r[kRec];
        gut::load_rgb_row(row, r);
        gut::Hit h;
        if (!gut::eval_ray<kDeg, kGen>(r, 1, ray, row[gut::kThrSlot], p, h)) {
          continue;
        }
        composite(h.alpha, h.hit_t, r + gut::kRgb, r, &h);
      }
    } else {
      // window by window of the list: the sort keeps each candidate's
      // alpha beside its key, so only the normals test a lane again
      for (int i = 0; alive && i < n;) {
        const int i1 = gut::window_end<kW>(list, i, n);
        float key[kW], alpha[kW];
        uint8_t pos[kW];
        const int m = gut::sort_list<kDeg, kW, kGen>(s_row, list, i, i1, ray,
                                                     p, key, pos, alpha);
        for (int k = 0; alive && k < m; ++k) {
          const float* row = s_row + list[i + pos[k]] * gut::kRgbRow;
          if constexpr (kNormals) {
            float r[kRec];
            gut::load_rgb_row(row, r);
            gut::Hit h;
            gut::eval_ray<kDeg, kGen>(r, 1, ray, row[gut::kThrSlot], p, h);
            composite(alpha[k], key[k], r + gut::kRgb, r, &h);
          } else {
            composite(alpha[k], key[k], row + gut::kRgb, nullptr, nullptr);
          }
        }
        i = i1;
      }
    }
    __syncthreads();
  }
  if (inside) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out_feat[3 * pix + c] = feat[c];
    out_opacity[pix] = 1.0f - trans;
    out_depth[pix] = depth;
    out_hits[pix] = hits;
    out_tfinal[pix] = trans;
    if constexpr (kNormals) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out_normals[3 * pix + c] = nrm[c];
    }
  }
}

// The RGB modes' entries: at degree 2 in global-Z order (the ellipsoid
// cull) at most 64 registers, four blocks an SM, measured faster than
// the compiler's own choice of 69-78; in windows of 16 the compiler's
// own (PERF.md §6). Degree 4 in global-Z order takes raster_fwd_kernel's
// walk of every pair: its rays die within a few dozen pairs, and this
// walk's staging, cull and lists made it 4-13% slower there.
template <int kDeg, bool kGen, bool kNormals>
__global__ void __launch_bounds__(kBlock, 4)
raster_fwd_rgb_kernel(const float* __restrict__ table,
                      const int32_t* __restrict__ pair_particle,
                      const int32_t* __restrict__ tile_start,
                      const float* __restrict__ ray_o,
                      const float* __restrict__ ray_d,
                      const float* __restrict__ ray_tmin,
                      const float* __restrict__ ray_tmax,
                      gut::RasterParams p, float* __restrict__ out_feat,
                      float* __restrict__ out_opacity,
                      float* __restrict__ out_depth,
                      float* __restrict__ out_hits,
                      float* __restrict__ out_tfinal,
                      float* __restrict__ out_normals) {
  rgb_forward<kDeg, 0, kGen, kNormals>(
      table, pair_particle, tile_start, ray_o, ray_d, ray_tmin, ray_tmax, p,
      out_feat, out_opacity, out_depth, out_hits, out_tfinal, out_normals);
}

template <int kDeg, bool kGen, bool kNormals>
__global__ void __launch_bounds__(kBlock)
raster_fwd_rgb_sorted_kernel(const float* __restrict__ table,
                             const int32_t* __restrict__ pair_particle,
                             const int32_t* __restrict__ tile_start,
                             const float* __restrict__ ray_o,
                             const float* __restrict__ ray_d,
                             const float* __restrict__ ray_tmin,
                             const float* __restrict__ ray_tmax,
                             gut::RasterParams p, float* __restrict__ out_feat,
                             float* __restrict__ out_opacity,
                             float* __restrict__ out_depth,
                      float* __restrict__ out_hits,
                             float* __restrict__ out_tfinal,
                             float* __restrict__ out_normals) {
  rgb_forward<kDeg, 16, kGen, kNormals>(
      table, pair_particle, tile_start, ray_o, ray_d, ray_tmin, ray_tmax, p,
      out_feat, out_opacity, out_depth, out_hits, out_tfinal, out_normals);
}

// ---- the NHT mode (raster_fwd_nht_kernel) ----

// records staged per batch, and blocks an SM (at most 80 registers):
// measured faster than 256 and two or four (PERF.md §6)
constexpr int kBatchNht = 128;
static_assert(kBatchNht <= kBlock, "a thread stages a record");

template <int kDeg>
__global__ void __launch_bounds__(kBlock, 3)
raster_fwd_nht_kernel(const float* __restrict__ table,      // [C, 64]
                      const int32_t* __restrict__ pair_particle,  // [P]
                      const int32_t* __restrict__ tile_start,     // [T + 1]
                      const float* __restrict__ ray_o,      // [H, W, 3]
                      const float* __restrict__ ray_d,      // [H, W, 3]
                      const float* __restrict__ ray_tmin,   // [H, W]
                      const float* __restrict__ ray_tmax,   // [H, W]
                      gut::RasterParams p,
                      float* __restrict__ out_feat,         // [H, W, 24]
                      float* __restrict__ out_opacity,      // [H, W]
                      float* __restrict__ out_depth,        // [H, W]
                      float* __restrict__ out_hits,         // [H, W]
                      float* __restrict__ out_tfinal) {     // [H, W]
  constexpr int kD = gut::kNhtDim;
  // the batch's staged rows (common.cuh:kNhtRow)
  __shared__ __align__(16) float s_row[kBatchNht * gut::kNhtRow];
  const int tile = blockIdx.x;
  // warp w covers the 8x4 pixel block (w % 2, w / 2) of the tile
  const int px = (tile % p.grid_x) * kTile + (threadIdx.x >> 5) % 2 * 8 +
                 (threadIdx.x & 7);
  const int py = (tile / p.grid_x) * kTile + (threadIdx.x >> 6) * 4 +
                 ((threadIdx.x >> 3) & 3);
  const bool inside = px < p.width && py < p.height;
  const int64_t pix = static_cast<int64_t>(py) * p.width + px;

  const gut::Ray ray =
      gut::load_ray<true>(ray_o, ray_d, ray_tmin, ray_tmax, inside, pix);
  bool alive = inside;
  float trans = 1.f, depth = 0.f, hits = 0.f;
  float feat[gut::kNhtOut];
#pragma unroll
  for (int c = 0; c < gut::kNhtOut; ++c) feat[c] = 0.f;

  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];
  for (int base = start; base < end; base += kBatchNht) {
    // all pixels of the tile dead (or off-image): the block is done
    if (__syncthreads_count(alive) == 0) break;
    const int idx = base + threadIdx.x;
    if (threadIdx.x < kBatchNht && idx < end) {
      gut::stage_nht_row<kDeg>(
          table + static_cast<int64_t>(pair_particle[idx]) * gut::kRecNht,
          s_row + threadIdx.x * gut::kNhtRow, p);
    }
    __syncthreads();
    const int nb = min(kBatchNht, end - base);
    for (int j = 0; alive && j < nb; ++j) {
      const float* row = s_row + j * gut::kNhtRow;
      // the fields of the hit test: the row's first four float4
      float geo[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 t = reinterpret_cast<const float4*>(row)[q];
        geo[4 * q + 0] = t.x;
        geo[4 * q + 1] = t.y;
        geo[4 * q + 2] = t.z;
        geo[4 * q + 3] = t.w;
      }
      gut::Hit h;
      if (!gut::eval_hit_general<kDeg>(geo + gut::kNhtRowPad, 1, ray,
                                       row[gut::kNhtRow - 1], p, h)) {
        continue;
      }
      const float w = h.alpha * trans;
      const gut::NhtHit n = gut::nht_hit(h);
      // w sin and w cos of the 12 blends (common.cuh:nht_dims, as kernel
      // C takes them), four control dims at a time; a hit whose blends
      // may pass the fast sine's range takes the accurate one
      const float* fr = row + gut::kNhtRowPad + gut::kNhtFeat;
      auto add = [&](auto accurate) {
#pragma unroll
        for (int c = 0; c < kD / 4; ++c) {
          float f[4][4], sn[4], cs[4];
          gut::nht_dims<decltype(accurate)::value>(fr, n.w, c, f, sn, cs);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 4 * c + i;
            feat[2 * k] = __fmaf_rn(w, sn[i], feat[2 * k]);
            feat[2 * k + 1] = __fmaf_rn(w, cs[i], feat[2 * k + 1]);
          }
        }
      };
      if (gut::nht_far(row, n.w)) {
        add(std::true_type{});
      } else {
        add(std::false_type{});
      }
      // depth, hits, T and the kill: kernel B's unfused order
      depth += w * h.hit_t;
      hits += w > 0.f ? 1.f : 0.f;
      trans *= 1.0f - h.alpha;
      if (trans < p.min_transmittance) alive = false;
    }
    __syncthreads();
  }
  if (inside) {
#pragma unroll
    for (int c = 0; c < gut::kNhtOut; ++c) {
      out_feat[gut::kNhtOut * pix + c] = feat[c];
    }
    out_opacity[pix] = 1.0f - trans;
    out_depth[pix] = depth;
    out_hits[pix] = hits;
    out_tfinal[pix] = trans;
  }
}

}  // namespace

// degree: 2 or 4; window: 0 (global-Z order), 16 (sorted mode) or 128
// (trace); general: 1 reads ray_o (the general-geometry mode), 0 ignores
// it; nht: 1 for the NHT mode (64-float records, 24 features out;
// general, window 0 only); shared: 1 walks one segment in every block;
// normals: 1 writes out_normals. common.cuh:launch_raster lists the
// combinations built.
extern "C" int raster_fwd_launch(
    const float* table, const int32_t* pair_particle,
    const int32_t* tile_start, const float* ray_o, const float* ray_d,
    const float* ray_tmin, const float* ray_tmax, int width, int height,
    int grid_x, int num_tiles, int degree, int window, int general, int nht,
    int shared, int normals, float min_transmittance, float max_alpha,
    float sq_thr_response, float log_min_alpha, float gg_scale,
    float* out_feat, float* out_opacity, float* out_depth, float* out_hits,
    float* out_tfinal, float* out_normals, void* stream) {
  gut::RasterParams p{width, height, grid_x, min_transmittance, max_alpha,
                      sq_thr_response, log_min_alpha, gg_scale};
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const auto stream_ = static_cast<cudaStream_t>(stream);
  if (nht) {
    if (shared || normals) return static_cast<int>(cudaErrorInvalidValue);
    return gut::launch_nht(degree, window, general, [&](auto deg) {
      raster_fwd_nht_kernel<decltype(deg)::value>
          <<<num_tiles, kBlock, 0, stream_>>>(
              table, pair_particle, tile_start, ray_o, ray_d, ray_tmin,
              ray_tmax, p, out_feat, out_opacity, out_depth, out_hits,
              out_tfinal);
    });
  }
  return gut::launch_raster<true>(
      degree, window, general, shared, normals,
      [&](auto deg, auto win, auto gen, auto sh, auto nrm) {
        constexpr int kDeg = decltype(deg)::value, kW = decltype(win)::value;
        constexpr bool kGen = decltype(gen)::value,
                       kSh = decltype(sh)::value,
                       kNrm = decltype(nrm)::value;
        if constexpr (!kSh && kW == 0 && kDeg == 2) {
          raster_fwd_rgb_kernel<kDeg, kGen, kNrm>
              <<<num_tiles, kBlock, 0, stream_>>>(
                  table, pair_particle, tile_start, ray_o, ray_d, ray_tmin,
                  ray_tmax, p, out_feat, out_opacity, out_depth, out_hits,
                  out_tfinal, out_normals);
        } else if constexpr (!kSh && kW == 16) {
          raster_fwd_rgb_sorted_kernel<kDeg, kGen, kNrm>
              <<<num_tiles, kBlock, 0, stream_>>>(
                  table, pair_particle, tile_start, ray_o, ray_d, ray_tmin,
                  ray_tmax, p, out_feat, out_opacity, out_depth, out_hits,
                  out_tfinal, out_normals);
        } else {
          raster_fwd_kernel<kDeg, kW, kGen, kSh, kNrm>
              <<<num_tiles, kBlock, 0, stream_>>>(
                  table, pair_particle, tile_start, ray_o, ray_d, ray_tmin,
                  ray_tmax, p, out_feat, out_opacity, out_depth, out_hits,
                  out_tfinal, out_normals);
        }
      });
}

// Registers, local (spill and stack) bytes, static shared bytes and
// dynamic shared bytes (none) of kernel B's trace modes, windows of 128
// over per-block segments (the grid) then a shared segment, without
// normals; of its NHT mode at degree 2 and 4; then of its RGB modes
// without normals, degree 2 then 4 for W 0, W 16, general W 0 and general
// W 16: out[4 i + 0..3]. Returns the first error.
extern "C" int raster_fwd_attributes(int* out) {
  using V = const void*;
  const void* fns[] = {
      reinterpret_cast<V>(
          raster_fwd_kernel<4, gut::kTraceW, true, false, false>),
      reinterpret_cast<V>(
          raster_fwd_kernel<4, gut::kTraceW, true, true, false>),
      reinterpret_cast<V>(raster_fwd_nht_kernel<2>),
      reinterpret_cast<V>(raster_fwd_nht_kernel<4>),
      reinterpret_cast<V>(raster_fwd_rgb_kernel<2, false, false>),
      reinterpret_cast<V>(raster_fwd_kernel<4, 0, false, false, false>),
      reinterpret_cast<V>(raster_fwd_rgb_sorted_kernel<2, false, false>),
      reinterpret_cast<V>(raster_fwd_rgb_sorted_kernel<4, false, false>),
      reinterpret_cast<V>(raster_fwd_rgb_kernel<2, true, false>),
      reinterpret_cast<V>(raster_fwd_kernel<4, 0, true, false, false>),
      reinterpret_cast<V>(raster_fwd_rgb_sorted_kernel<2, true, false>),
      reinterpret_cast<V>(raster_fwd_rgb_sorted_kernel<4, true, false>)};
  constexpr int kFns = sizeof(fns) / sizeof(fns[0]);
  for (int i = 0; i < kFns; ++i) {
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
