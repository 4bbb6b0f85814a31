// Shared by every kernel library of the port: the C entry point that
// turns a CUDA error code returned by a launch function into its text,
// and the per-(pixel, pair) hit math of the raster kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace gut {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;  // pixels per tile == threads per block
constexpr int kRec = 16;               // a(3) M(9) density(1) rgb(3)
constexpr int kDensity = 12;
constexpr int kRgb = 13;

struct RasterParams {
  int width, height, grid_x;
  float min_transmittance, max_alpha;
  float sq_thr_response;  // ln(min_response) / s
  float log_min_alpha;    // ln(min_alpha)
  float gg_scale;         // s = -0.5 for degree 2, -1/18 for degree 4
};

// Per-pair squared-distance acceptance threshold (raster.py:
// _sq_accept_threshold): with the response f(sq) = exp(s sq^(deg/2)),
//   resp > min_response and resp * density > min_alpha  <=>
//   sq^(deg/2) < t = min(ln(min_response), ln(min_alpha) - ln(density)) / s
// so sq < t for degree 2 and sq < sqrt(max(t, 0)) for degree 4.
template <int kDeg>
__device__ __forceinline__ float sq_threshold(float density,
                                              const RasterParams& p) {
  const float t = fminf(p.sq_thr_response,
                        (p.log_min_alpha - logf(fmaxf(density, 1e-30f))) /
                            p.gg_scale);
  if (kDeg == 4) return sqrtf(fmaxf(t, 0.f));
  return t;
}

// One pixel's ray: its origin (the general mode only), direction, |d|
// (the general mode's hit distance scale) and t-range.
struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float dn;
  float tmin, tmax;
};

// Intermediates of one ray against one particle record in the shared-origin
// factorisation: b = M d, c = a x b, m = |b|^2, q = a . b. The general mode
// also keeps e = o - p, from which it formed a = M e.
struct Hit {
  float ax, ay, az;
  float ex, ey, ez;
  float bx, by, bz;
  float cx, cy, cz;
  float inv_m;      // 1 / max(m, 1e-30)
  float c2;         // |c|^2
  float q;          // a . b
  float sq;         // squared canonical distance c2 / m
  float hit_t;      // -q / m, the ray distance of the max response
  float resp;       // exp(s * sq) (degree 2) or exp(s * sq * sq) (degree 4)
  float alpha_raw;  // resp * density
  float alpha;      // min(max_alpha, alpha_raw)
};

// The hit of a ray with canonical origin h.a = (ax, ay, az) already set:
// everything after a, shared by both modes. kGen scales the hit distance
// by dn = |d|.
template <int kDeg, bool kGen>
__device__ __forceinline__ bool hit_from_a(const float* r, int stride,
                                           float dx, float dy, float dz,
                                           float dn, float tmin, float tmax,
                                           float thr, const RasterParams& p,
                                           Hit& h) {
  const float ax = h.ax, ay = h.ay, az = h.az;
  h.bx = r[3 * stride] * dx + r[4 * stride] * dy + r[5 * stride] * dz;
  h.by = r[6 * stride] * dx + r[7 * stride] * dy + r[8 * stride] * dz;
  h.bz = r[9 * stride] * dx + r[10 * stride] * dy + r[11 * stride] * dz;
  h.cx = ay * h.bz - az * h.by;
  h.cy = az * h.bx - ax * h.bz;
  h.cz = ax * h.by - ay * h.bx;
  h.inv_m = 1.0f / fmaxf(h.bx * h.bx + h.by * h.by + h.bz * h.bz, 1e-30f);
  h.c2 = h.cx * h.cx + h.cy * h.cy + h.cz * h.cz;
  h.sq = h.c2 * h.inv_m;
  if (!(h.sq < thr)) return false;
  h.q = ax * h.bx + ay * h.by + az * h.bz;
  h.hit_t = -h.q * h.inv_m;
  if (kGen) h.hit_t = h.hit_t * dn;
  if (!(h.hit_t > tmin && h.hit_t < tmax)) return false;
  if (kDeg == 4) {
    h.resp = expf(p.gg_scale * h.sq * h.sq);
  } else {
    h.resp = expf(p.gg_scale * h.sq);
  }
  h.alpha_raw = h.resp * r[kDensity * stride];
  h.alpha = fminf(p.max_alpha, h.alpha_raw);
  return true;
}

// Evaluate record ``r`` (field f at r[f * stride]) on the unit ray
// direction d. Returns whether the candidate is accepted (sq below the
// staged threshold ``thr``) and hits inside (tmin, tmax); the fields of
// ``h`` after the failing test are left unset. Kernels B, C and E all call
// this, so their accept and kill decisions are the same: built with
// -fmad=false, the fp32 operation order is that of the plain PyTorch
// version (ops/cuda/raster.py:_hit_terms).
template <int kDeg>
__device__ __forceinline__ bool eval_hit(const float* r, int stride, float dx,
                                         float dy, float dz, float tmin,
                                         float tmax, float thr,
                                         const RasterParams& p, Hit& h) {
  h.ax = r[0];
  h.ay = r[stride];
  h.az = r[2 * stride];
  return hit_from_a<kDeg, false>(r, stride, dx, dy, dz, 1.f, tmin, tmax, thr,
                                 p, h);
}

// The general-geometry mode (raster.py:chunk_hits_general, the TPU's
// kernel 5): the record holds the particle position p in slots 0-2 and the
// ray its own origin o, so a = M (o - p) is formed per (pixel, pair): 3
// subtractions and 9 products more than eval_hit. Forming M o - M p
// instead would cancel most of fp32's digits at world coordinates of
// hundreds of metres. The hit distance is JAX's general one, |d| times
// the shared-origin -(a . b) / |b|^2: the two agree for unit directions.
// The fp32 operation order is ops/cuda/raster.py:_canonical_hit with ``o``.
template <int kDeg>
__device__ __forceinline__ bool eval_hit_general(const float* r, int stride,
                                                 const Ray& ray, float thr,
                                                 const RasterParams& p,
                                                 Hit& h) {
  h.ex = ray.ox - r[0];
  h.ey = ray.oy - r[stride];
  h.ez = ray.oz - r[2 * stride];
  h.ax = r[3 * stride] * h.ex + r[4 * stride] * h.ey + r[5 * stride] * h.ez;
  h.ay = r[6 * stride] * h.ex + r[7 * stride] * h.ey + r[8 * stride] * h.ez;
  h.az = r[9 * stride] * h.ex + r[10 * stride] * h.ey + r[11 * stride] * h.ez;
  return hit_from_a<kDeg, true>(r, stride, ray.dx, ray.dy, ray.dz, ray.dn,
                                ray.tmin, ray.tmax, thr, p, h);
}

// The hit of record ``r`` in either mode: eval_hit, or eval_hit_general
// (kGen).
template <int kDeg, bool kGen>
__device__ __forceinline__ bool eval_ray(const float* r, int stride,
                                         const Ray& ray, float thr,
                                         const RasterParams& p, Hit& h) {
  if constexpr (kGen) {
    return eval_hit_general<kDeg>(r, stride, ray, thr, p, h);
  } else {
    return eval_hit<kDeg>(r, stride, ray.dx, ray.dy, ray.dz, ray.tmin,
                          ray.tmax, thr, p, h);
  }
}

// The ray's fields for pixel ``pix`` (tmax = -1: an empty range, for
// pixels off the image).
template <bool kGen>
__device__ __forceinline__ Ray load_ray(const float* ray_o, const float* ray_d,
                                        const float* ray_tmin,
                                        const float* ray_tmax, bool inside,
                                        int64_t pix) {
  Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, -1.f};
  if (!inside) return ray;
  ray.dx = ray_d[3 * pix + 0];
  ray.dy = ray_d[3 * pix + 1];
  ray.dz = ray_d[3 * pix + 2];
  ray.tmin = ray_tmin[pix];
  ray.tmax = ray_tmax[pix];
  if constexpr (kGen) {
    ray.ox = ray_o[3 * pix + 0];
    ray.oy = ray_o[3 * pix + 1];
    ray.oz = ray_o[3 * pix + 2];
    ray.dn = sqrtf(ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz);
  }
  return ray;
}

// d resp / d sq (ops/hit.py:particle_response_dsq): resp s (degree 2),
// resp s 2 sq (degree 4).
template <int kDeg>
__device__ __forceinline__ float response_dsq(const Hit& h,
                                              const RasterParams& p) {
  if (kDeg == 4) return h.resp * p.gg_scale * 2.0f * h.sq;
  return h.resp * p.gg_scale;
}

// The world normal of an accepted hit (ops/hit.py:hit_normal; raster.py
// :531-550, the shared-origin form, which the general mode's a = M (o - p)
// and b = M d share): the entry point of the ray into the particle's
// 3-sigma canonical ellipsoid, a + b / |b| t_entry with t_entry =
// -(a . b) / |b| - sqrt(max(9 - sq, 0)), scaled elementwise by R s and
// normalised. R s comes from M = diag(1/s) R^T alone: s_i^2 =
// 1 / |M row i|^2 and (R s)_j = sum_i M_ij s_i^2.
__device__ __forceinline__ float3 hit_normal(const float* r, int stride,
                                             const Hit& h) {
  float rs[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float m0 = r[(3 + 3 * i) * stride], m1 = r[(4 + 3 * i) * stride],
                m2 = r[(5 + 3 * i) * stride];
    const float s2 = 1.0f / fmaxf(m0 * m0 + m1 * m1 + m2 * m2, 1e-24f);
    rs[0] += m0 * s2;
    rs[1] += m1 * s2;
    rs[2] += m2 * s2;
  }
  const float inv_b = sqrtf(h.inv_m);   // 1 / |b|
  const float t_entry = -h.q * inv_b - sqrtf(fmaxf(9.0f - h.sq, 0.f));
  const float nx = (h.ax + h.bx * inv_b * t_entry) * rs[0];
  const float ny = (h.ay + h.by * inv_b * t_entry) * rs[1];
  const float nz = (h.az + h.bz * inv_b * t_entry) * rs[2];
  const float inv_n = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-24f));
  return make_float3(nx * inv_n, ny * inv_n, nz * inv_n);
}

// The sorted mode's per-ray window (raster.py:_chunk_composite with
// sorted_compositing, the 3DGRT k-buffer): the accepted candidates among
// the staged lanes [lo, hi) of one window, in ascending hit_t. Insertion
// sort of (hit_t, lane) in per-thread arrays; equal keys keep lane order
// (the plain version's stable sort). Returns the count; the caller
// re-evaluates each lane's hit from shared memory, which gives the same
// values bit for bit, so only the key and an 8-bit lane ride the sort.
// Kernels B, C and E take it at W = 16; trace()'s windows of 128 take the
// k-buffer below instead. With ``alpha`` (kernel C) each candidate's
// alpha rides beside its key, so a walk that needs only alpha and hit_t
// does not test the lane again.
template <int kDeg, int kW, bool kGen>
__device__ __forceinline__ int sort_window(const float* rec, int stride,
                                           const float* thr, int lo, int hi,
                                           const Ray& ray,
                                           const RasterParams& p,
                                           float (&key)[kW],
                                           uint8_t (&lane)[kW],
                                           float* alpha = nullptr) {
  int n = 0;
  for (int j = lo; j < hi; ++j) {
    Hit h;
    if (!eval_ray<kDeg, kGen>(rec + j, stride, ray, thr[j], p, h)) {
      continue;
    }
    int i = n++;
    while (i > 0 && key[i - 1] > h.hit_t) {
      key[i] = key[i - 1];
      lane[i] = lane[i - 1];
      if (alpha) alpha[i] = alpha[i - 1];
      --i;
    }
    key[i] = h.hit_t;
    lane[i] = static_cast<uint8_t>(j);
    if (alpha) alpha[i] = h.alpha;
  }
  return n;
}

// ---- trace()'s windows of 128: the cull and the k-buffer ----
//
// Kernels B and C in trace()'s modes (degree 4, the general mode, windows
// of kTraceW over per-block segments or one shared segment) test only the
// candidates that a conservative cull keeps (the exact test accepts
// 0.27% of the grid's and 0.033% of the brute force's (ray, candidate)
// pairs on chip_smoke.py phases 33 and 31's inputs, which count them):
//  1. at staging, each pair's particle is a world sphere of radius
//     cull_radius (below) and each warp's 32 rays lie in a pyramid
//     (warp_bundle): a pair outside a warp's pyramid is left out of that
//     warp's list, kept in lane order (bundle_keeps);
//  2. per ray, a listed pair whose sphere the ray's line misses is not
//     tested (sphere_keeps);
//  3. the rest take the exact test (eval_hit_general), whose decisions are
//     the only ones that count: the cull removes only candidates it would
//     reject, so the outputs are those of testing every pair.
// The proof is in the margins (cull_radius) and, empirically, in
// ops/cuda/raster.py:trace_cull_plain, this cull in the same fp32
// operation order, which tests/test_torch_trace_cull.py and chip_smoke.py
// phases 31 and 33 hold against the exact test: no culled candidate is
// ever accepted.
constexpr int kTraceW = 128;
// the k-buffer: the window's accepted candidates of a ray, smallest key
// first; a window with more takes another pass for the next kTraceK
constexpr int kTraceK = 8;
// extra staged rows of a pair: its sphere's squared radius terms a2 and
// b2 for the per-ray test (sphere_keeps)
constexpr int kCullRows = 2;
constexpr int kWarps = kBlock / 32;
constexpr float kEps = 5.9604645e-8f;   // 2^-24, fp32's unit roundoff

// The least and largest squared norm of record r's M rows (field f at
// r[f * stride]): 1 / s_max^2 and 1 / s_min^2.
__device__ __forceinline__ void row_norm_range(const float* r, int stride,
                                               float& mn, float& mx) {
  float m[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float m0 = r[(3 + 3 * i) * stride], m1 = r[(4 + 3 * i) * stride],
                m2 = r[(5 + 3 * i) * stride];
    m[i] = m0 * m0 + m1 * m1 + m2 * m2;
  }
  mn = fminf(fminf(m[0], m[1]), m[2]);
  mx = fmaxf(fmaxf(m[0], m[1]), m[2]);
}

// The world radius beyond which a ray's line cannot be accepted, as
// A + B |e| (e = o - p, in world units), from the record's M rows (field f
// at r[f * stride]) and the staged squared-distance threshold thr.
//
// Why: M = diag(1/s) R^T, so |M row i|^2 = 1 / s_i^2 and M's least
// singular value is 1 / s_max. The canonical squared distance sq of a ray
// is min over its line of |M (x - p)|^2 >= dist^2 / s_max^2, dist the
// world distance from p to the line, so sq < thr needs dist < sqrt(thr)
// s_max. The fp32 margins, with eps = 2^-24 and kappa = s_max / s_min
// (the rows' fp32 norms bound the singular values to a relative
// 4 kappa eps):
//  - relative: 1e-4 + 16 kappa eps on the radius covers the rounding of
//    s_max, of sq's norms and division (2.5 eps) and of this bound;
//  - in |e|: the exact test forms a = M e and b = M d and then c = a x b,
//    which cancels where the line passes near p while |a| reaches the
//    hundreds (far origins): its sqrt(sq) is off by up to about (8.2 +
//    10.4 kappa) eps |e| / s_min, s_max (8.2 kappa + 10.4 kappa^2) eps |e|
//    in world units, and the cull's own e x d by 3 eps |e| and its dot
//    products by 4 eps |p - c|. B = 64 (1 + kappa)^2 eps covers their sum
//    for every kappa >= 1 with a factor of 1.5 or more; the pyramid takes
//    2 B for the hit distance's rounding near the apex.
// A row of norm zero gives A = inf or NaN: every test keeps the pair.
__device__ __forceinline__ void cull_radius(const float* r, int stride,
                                            float thr, float& a, float& b) {
  float mn, mx;
  row_norm_range(r, stride, mn, mx);
  const float kap = sqrtf(mx / mn);
  const float k1 = 1.0f + kap;
  a = sqrtf(thr / mn) * (1.0001f + 16.0f * kEps * kap);
  b = 64.0f * kEps * k1 * k1;
}

// A warp's rays as a pyramid with apex c, expanded by rho: every point
// o + t d (t >= 0) of a ray of the warp with a non-empty t-range lies
// within rho of the five planes' inner sides, (x - c) . n_i <= rho.
// mode: kBundlePlanes, or kBundleNone (no ray of the warp has a range:
// the warp tests nothing) or kBundleAll (its rays do not fit one pyramid:
// a ray with tmin < 0, or one more than 78 degrees off the first ray's
// direction; the warp tests every pair).
constexpr int kBundlePlanes = 0, kBundleNone = 1, kBundleAll = 2;
struct Bundle {
  float cx, cy, cz, rho;
  float n[5][3];
  int mode;
};

// The bundle of the calling warp's rays (every lane gets it). The axis a
// is the first valid ray's direction, u the deviation from a of the ray
// deviating most (so u follows a fan of rays), v = a x u; each ray's
// gnomonic coordinates (d.u / d.a, d.v / d.a) bound the side planes,
// padded by 1e-5 (1 + |x|), which covers their fp32 rounding (under 2e-6
// (1 + |x|) with d.a >= 0.2 |d|) so no ray leaves its plane; the fifth
// plane is the apex's, n = -a. c is the first valid ray's origin, rho the
// largest distance of a valid ray's origin from it (0 for a camera's
// rays). ops/cuda/raster.py:_warp_bundles_plain is this in the same fp32
// operation order.
__device__ __forceinline__ Bundle warp_bundle(const Ray& ray, bool valid,
                                              int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  Bundle bd;
  const unsigned vb = __ballot_sync(kAll, valid);
  if (vb == 0u) {
    bd.mode = kBundleNone;
    return bd;
  }
  const int l0 = __ffs(vb) - 1;
  bd.cx = __shfl_sync(kAll, ray.ox, l0);
  bd.cy = __shfl_sync(kAll, ray.oy, l0);
  bd.cz = __shfl_sync(kAll, ray.oz, l0);
  float ax = __shfl_sync(kAll, ray.dx, l0);
  float ay = __shfl_sync(kAll, ray.dy, l0);
  float az = __shfl_sync(kAll, ray.dz, l0);
  const float an = 1.0f / sqrtf(ax * ax + ay * ay + az * az);
  ax = ax * an;
  ay = ay * an;
  az = az * an;
  const float ox = ray.ox - bd.cx, oy = ray.oy - bd.cy, oz = ray.oz - bd.cz;
  float rho = valid ? sqrtf(ox * ox + oy * oy + oz * oz) : 0.f;
  const float da = ray.dx * ax + ray.dy * ay + ray.dz * az;
  const float qx = ray.dx - da * ax, qy = ray.dy - da * ay,
              qz = ray.dz - da * az;
  const float q2 = qx * qx + qy * qy + qz * qz;
  // pyramid needs t >= 0 and every direction well in front of a
  const bool off = valid && (ray.tmin < 0.f || !(da >= 0.2f * ray.dn));
  if (__any_sync(kAll, off)) {
    bd.mode = kBundleAll;
    return bd;
  }
  // the most deviating valid ray (the lowest lane among equals)
  uint64_t best = valid ? (static_cast<uint64_t>(__float_as_uint(q2)) << 32)
                              | static_cast<uint32_t>(31 - lane)
                        : 0ull;
#pragma unroll
  for (int off_ = 16; off_ > 0; off_ >>= 1) {
    const uint64_t o = __shfl_xor_sync(kAll, best, off_);
    best = o > best ? o : best;
  }
  const int lu = 31 - static_cast<int>(best & 31u);
  float ux = __shfl_sync(kAll, qx, lu);
  float uy = __shfl_sync(kAll, qy, lu);
  float uz = __shfl_sync(kAll, qz, lu);
  if (!(__uint_as_float(static_cast<uint32_t>(best >> 32)) > 1e-12f)) {
    // every ray along a: any u across it (the axis a leans on least)
    const float fx = fabsf(ax), fy = fabsf(ay), fz = fabsf(az);
    ux = (fx <= fy && fx <= fz) ? 1.f : 0.f;
    uy = (ux == 0.f && fy <= fz) ? 1.f : 0.f;
    uz = (ux == 0.f && uy == 0.f) ? 1.f : 0.f;
  }
  const float ua = ux * ax + uy * ay + uz * az;
  ux = ux - ua * ax;
  uy = uy - ua * ay;
  uz = uz - ua * az;
  const float un = 1.0f / sqrtf(ux * ux + uy * uy + uz * uz);
  ux = ux * un;
  uy = uy * un;
  uz = uz * un;
  const float vx = ay * uz - az * uy, vy = az * ux - ax * uz,
              vz = ax * uy - ay * ux;
  const float kInf = __int_as_float(0x7f800000);
  const float gx = (ray.dx * ux + ray.dy * uy + ray.dz * uz) / da;
  const float gy = (ray.dx * vx + ray.dy * vy + ray.dz * vz) / da;
  float xmax = valid ? gx : -kInf, xmin = valid ? gx : kInf;
  float ymax = valid ? gy : -kInf, ymin = valid ? gy : kInf;
#pragma unroll
  for (int off_ = 16; off_ > 0; off_ >>= 1) {
    xmax = fmaxf(xmax, __shfl_xor_sync(kAll, xmax, off_));
    xmin = fminf(xmin, __shfl_xor_sync(kAll, xmin, off_));
    ymax = fmaxf(ymax, __shfl_xor_sync(kAll, ymax, off_));
    ymin = fminf(ymin, __shfl_xor_sync(kAll, ymin, off_));
    rho = fmaxf(rho, __shfl_xor_sync(kAll, rho, off_));
  }
  xmax = xmax + 1e-5f * (1.0f + fabsf(xmax));
  xmin = xmin - 1e-5f * (1.0f + fabsf(xmin));
  ymax = ymax + 1e-5f * (1.0f + fabsf(ymax));
  ymin = ymin - 1e-5f * (1.0f + fabsf(ymin));
  const float pl[5][3] = {
      {ux - xmax * ax, uy - xmax * ay, uz - xmax * az},
      {xmin * ax - ux, xmin * ay - uy, xmin * az - uz},
      {vx - ymax * ax, vy - ymax * ay, vz - ymax * az},
      {ymin * ax - vx, ymin * ay - vy, ymin * az - vz},
      {-ax, -ay, -az}};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float s = 1.0f / sqrtf(pl[i][0] * pl[i][0] + pl[i][1] * pl[i][1] +
                                 pl[i][2] * pl[i][2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) bd.n[i][k] = pl[i][k] * s;
  }
  bd.rho = rho;
  bd.mode = kBundlePlanes;
  return bd;
}

// Whether x (the particle's centre from the apex c) lies within reach of
// every plane's inner side.
__device__ __forceinline__ bool planes_keep(const Bundle& bd, float x,
                                            float y, float z, float reach) {
  bool out = false;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    out |= x * bd.n[i][0] + y * bd.n[i][1] + z * bd.n[i][2] > reach;
  }
  return !out;
}

// Whether a warp of bundle bd may accept the particle at (px, py, pz) of
// radius a + b |e|: it lies within a + 2 b (|p - c| + rho) + rho of every
// plane's inner side (|e| <= |p - c| + rho).
__device__ __forceinline__ bool bundle_keeps(const Bundle& bd, float px,
                                             float py, float pz, float a,
                                             float b) {
  if (bd.mode != kBundlePlanes) return bd.mode == kBundleAll;
  const float x = px - bd.cx, y = py - bd.cy, z = pz - bd.cz;
  const float len = sqrtf(x * x + y * y + z * z);
  return planes_keep(bd, x, y, z, a + 2.0f * b * (len + bd.rho) + bd.rho);
}

// Whether the ray may accept the particle: its line passes within
// a + b |e| of p, e = o - p as eval_hit_general forms it, tested squared
// as |e x d|^2 < (a2 + b2 |e|^2) |d|^2 with a2 = 1.0625 a^2 and b2 = 17 b^2
// ((a + b |e|)^2 <= (1 + 1/16) a^2 + 17 b^2 |e|^2); dd = |d|^2.
__device__ __forceinline__ bool sphere_keeps(const Ray& ray, float dd,
                                             float ex, float ey, float ez,
                                             float a2, float b2) {
  const float cx = ey * ray.dz - ez * ray.dy;
  const float cy = ez * ray.dx - ex * ray.dz;
  const float cz = ex * ray.dy - ey * ray.dx;
  const float c2 = cx * cx + cy * cy + cz * cz;
  const float e2 = ex * ex + ey * ey + ez * ez;
  return !(c2 >= (a2 + b2 * e2) * dd);
}

// The sort key of an accepted candidate at staged lane j: hit_t's bits
// made order-preserving (sign flip; -0 as +0) above the lane, so keys
// order as (hit_t, lane), the sorted mode's stable order.
__device__ __forceinline__ uint64_t window_key(float hit_t, int j) {
  uint32_t bits = __float_as_uint(hit_t);
  if ((bits << 1) == 0u) bits = 0u;
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<uint64_t>(bits) << 32) | static_cast<uint32_t>(j);
}

// Keep the kTraceK smallest keys in buf (ascending): insert key.
__device__ __forceinline__ void kbuffer_insert(uint64_t (&buf)[kTraceK],
                                               uint64_t key) {
#pragma unroll
  for (int q = 0; q < kTraceK; ++q) {
    const uint64_t lo = key < buf[q] ? key : buf[q];
    key = key < buf[q] ? buf[q] : key;
    buf[q] = lo;
  }
}

// Take the smallest key out of buf.
__device__ __forceinline__ uint64_t kbuffer_pop(uint64_t (&buf)[kTraceK]) {
  const uint64_t key = buf[0];
#pragma unroll
  for (int q = 0; q + 1 < kTraceK; ++q) buf[q] = buf[q + 1];
  buf[kTraceK - 1] = ~0ull;
  return key;
}

// Passes a ray took beyond the first in a window (more than kTraceK
// accepted candidates), summed over launches; window_overflows() reads
// (and with reset, zeroes) it.
__device__ unsigned long long g_window_overflows;

// Stage the cull of a trace pair (record field f at r[f * stride], its
// threshold at r[kRec * stride]): sphere_keeps' a2 and b2 in the rows
// after the threshold; returns the bits of the warps whose bundles keep
// the pair.
__device__ __forceinline__ unsigned stage_cull(float* r, int stride,
                                               const Bundle* bundles) {
  float a, b;
  cull_radius(r, stride, r[kRec * stride], a, b);
  r[(kRec + 1) * stride] = 1.0625f * a * a;
  r[(kRec + 2) * stride] = 17.0f * b * b;
  unsigned keep = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    keep |= static_cast<unsigned>(
                bundle_keeps(bundles[w], r[0], r[stride], r[2 * stride], a, b))
            << w;
  }
  return keep;
}

// The calling warp's list: the batch's staged lanes whose keep bits hold
// the warp's bit, in lane order; returns the count, n_first those of the
// batch's first window (lanes below kTraceW).
__device__ __forceinline__ int warp_list(const uint8_t* keep, int n_lanes,
                                         int warp, int lane, uint8_t* list,
                                         int& n_first) {
  int n = 0;
  for (int q = 0; q < n_lanes / 32; ++q) {
    const bool k = (keep[32 * q + lane] >> warp) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, k);
    if (k) {
      list[n + __popc(m & ((1u << lane) - 1u))] =
          static_cast<uint8_t>(32 * q + lane);
    }
    n += __popc(m);
    if (32 * (q + 1) == kTraceW) n_first = n;
  }
  __syncwarp();
  return n;
}

// ---- kernels B and E in their RGB modes: the per-warp cull ----
//
// Kernels B (raster_fwd_rgb_kernel) and E (wmax_kernel) in the eight
// modes of launch_mode (but B at degree 4 in global-Z order,
// raster_fwd.cu says why) take trace's cull without its per-ray sphere
// test: the thread that stages a pair tests the particle against each
// warp's pyramid of 8x4 rays (warp_bundle): at degree 2 in global-Z
// order its acceptance ellipsoid on the side planes (cull_quadric,
// ellipsoid_keeps), elsewhere its sphere (cull_sphere, bundle_keeps;
// stage_rgb_row says why); each warp lists the staged
// lanes it keeps, in lane order (warp_list), and its rays walk only
// those with the exact test. A culled candidate is one the exact test
// rejects, so the walk composites what testing every pair composites,
// in the same order, bit for bit.
// ops/cuda/raster.py:cull_plain mirrors it in the same fp32 operation
// order; tests/test_torch_tile_cull.py and chip_smoke.py phases 4, 13,
// 15, 19 and 21 hold it against the exact test.
//
// A staged pair is a row of kRgbRow floats in shared memory, pair after
// pair: the record's 16 fields (four float4), then the squared-distance
// threshold and 3 floats of padding.
constexpr int kRgbRow = kRec + 4;
constexpr int kThrSlot = kRec;

// The four float4 of a staged row's record into registers.
__device__ __forceinline__ void load_rgb_row(const float* row,
                                             float (&r)[kRec]) {
#pragma unroll
  for (int q = 0; q < kRec / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(row)[q];
    r[4 * q + 0] = t.x;
    r[4 * q + 1] = t.y;
    r[4 * q + 2] = t.z;
    r[4 * q + 3] = t.w;
  }
}

// The world sphere of record r with threshold thr: its centre (x, y, z)
// relative to the origin of the mode's rays and its radius a + b |e|
// (cull_radius). The general mode's record holds the centre p. A
// shared-origin record holds a = M (o - p) instead, so the centre is
// re-derived as p - o = -M^-1 a, with M^-1 = M^T diag(1 / |M row i|^2)
// (M = diag(1/s) R^T); the rays then start at 0.
//
// Margin of the re-derivation (eps = 2^-24): the fp32 rows of M are
// orthogonal up to the rounding of R from a unit quaternion and of M's
// entries, so |M^T diag(1 / |row i|^2) M - I| <= 16 eps; each of the
// three terms M_ij a_i / |row i|^2 is at most |p - o| and carries at most
// 5 roundings (|row|^2 3, the division, the product), the sum 2 more,
// so each component is off by at most 21 eps 3 |p - o| and the vector by
// 37 eps |p - o|: 53 eps |p - o| in all. bundle_keeps' reach grows by
// 2 b |p - c|, so 64 eps more in b covers it more than twice.
template <bool kGen>
__device__ __forceinline__ void cull_sphere(const float (&r)[kRec],
                                            float thr, float& x, float& y,
                                            float& z, float& a, float& b) {
  cull_radius(r, 1, thr, a, b);
  if constexpr (kGen) {
    x = r[0];
    y = r[1];
    z = r[2];
  } else {
    float u[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float m0 = r[3 + 3 * i], m1 = r[4 + 3 * i], m2 = r[5 + 3 * i];
      u[i] = r[i] / (m0 * m0 + m1 * m1 + m2 * m2);
    }
    x = -(r[3] * u[0] + r[6] * u[1] + r[9] * u[2]);
    y = -(r[4] * u[0] + r[7] * u[1] + r[10] * u[2]);
    z = -(r[5] * u[0] + r[8] * u[1] + r[11] * u[2]);
    b = b + 64.0f * kEps;
  }
}

// The side planes' quadratic monomials of a warp's pyramid (n the unit
// normal of side plane i): nx^2, ny^2, nz^2, 2 nx ny, 2 nx nz, 2 ny nz,
// so n^T Q n of a symmetric Q (q00, q11, q22, q01, q02, q12) is their
// dot product (quadric_extent). Zero for a bundle without planes.
struct PlaneQuads {
  float m[4][6];
};

__device__ __forceinline__ PlaneQuads plane_quads(const Bundle& bd) {
  PlaneQuads pq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool on = bd.mode == kBundlePlanes;
    const float nx = on ? bd.n[i][0] : 0.f, ny = on ? bd.n[i][1] : 0.f,
                nz = on ? bd.n[i][2] : 0.f;
    pq.m[i][0] = nx * nx;
    pq.m[i][1] = ny * ny;
    pq.m[i][2] = nz * nz;
    pq.m[i][3] = 2.0f * nx * ny;
    pq.m[i][4] = 2.0f * nx * nz;
    pq.m[i][5] = 2.0f * ny * nz;
  }
  return pq;
}

// The acceptance ellipsoid of record r with threshold thr,
// {x : |M (x - p)|^2 <= thr}, as the quadric Q = thr f M^T diag(1 /
// |M row k|^4) M: with M's rows orthogonal (M = diag(1/s) R^T, so
// M^-1 = M^T diag(1 / |M row k|^2)), n^T Q n / f is the square of the
// ellipsoid's extent from p along a unit n, thr |M^-T n|^2. f covers the
// fp32 rounding of Q and of n^T Q n (each term's at most 5 eps relative,
// the terms at most 3 kappa^2 times the form, kappa^2 = the rows' largest
// squared norm over their least: 30 eps kappa^2), the rows' orthogonality
// (16 eps kappa on |M^-T n|, 32 eps kappa on its square) and the exact
// test's own rounding of sq (2.5 eps): f = 1.0003 + 256 eps kappa^2
// covers their sum at least 4 times.
__device__ __forceinline__ void cull_quadric(const float (&r)[kRec],
                                             float thr, float kap2,
                                             float (&q)[6]) {
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float m0 = r[3 + 3 * k], m1 = r[4 + 3 * k], m2 = r[5 + 3 * k];
    const float im = 1.0f / (m0 * m0 + m1 * m1 + m2 * m2);
    w[k] = im * im;
  }
  const float g = thr * (1.0003f + 256.0f * kEps * kap2);
  // S_jl = sum_k M_kj M_kl w_k for (j, l) = 00, 11, 22, 01, 02, 12
  auto entry = [&](int j, int l) {
    return (r[3 + j] * r[3 + l] * w[0] + r[6 + j] * r[6 + l] * w[1] +
            r[9 + j] * r[9 + l] * w[2]) * g;
  };
  q[0] = entry(0, 0);
  q[1] = entry(1, 1);
  q[2] = entry(2, 2);
  q[3] = entry(0, 1);
  q[4] = entry(0, 2);
  q[5] = entry(1, 2);
}

// n^T Q n for side plane i of a warp (plane_quads).
__device__ __forceinline__ float quadric_extent(const float (&q)[6],
                                                const float (&m)[6]) {
  return q[0] * m[0] + q[1] * m[1] + q[2] * m[2] + q[3] * m[3] +
         q[4] * m[4] + q[5] * m[5];
}

// Whether a warp of bundle bd (side-plane monomials pq) may accept the
// particle centred at x (from the apex c) with sphere radius a (a2 =
// a a), quadric q and slack base = 2 b (|p - c| + rho) + rho (what
// bundle_keeps adds to a): on each side plane its ellipsoid's extent (the
// least of it and the sphere's) within base of the plane's inner side;
// on the apex plane its sphere.
__device__ __forceinline__ bool ellipsoid_keeps(const Bundle& bd,
                                                const PlaneQuads& pq,
                                                float x, float y, float z,
                                                float a, float a2,
                                                const float (&q)[6],
                                                float base) {
  bool out = x * bd.n[4][0] + y * bd.n[4][1] + z * bd.n[4][2] > a + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d =
        x * bd.n[i][0] + y * bd.n[i][1] + z * bd.n[i][2] - base;
    const float lim = fminf(quadric_extent(q, pq.m[i]), a2);
    out |= d > 0.f && d * d > lim;
  }
  return !out;
}

// Stage the record at src (a row of the [C, 16] table) into row dst and
// cull it: returns the bits of the warps whose pyramids keep the pair,
// by its ellipsoid (kEllipsoid: ellipsoid_keeps) or its sphere
// (bundle_keeps). The ellipsoid culls twice the sphere's share on the
// bench views but costs ~3x at staging: it pays at degree 2 in global-Z
// order, where a ray walks the most pairs, and not in windows of 16 or
// at degree 4, whose rays die sooner (PERF.md §6).
template <int kDeg, bool kGen, bool kEllipsoid>
__device__ __forceinline__ unsigned stage_rgb_row(const float* src,
                                                  float* dst,
                                                  const Bundle* bundles,
                                                  const PlaneQuads* quads,
                                                  const RasterParams& p) {
  float r[kRec];
#pragma unroll
  for (int q = 0; q < kRec / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    reinterpret_cast<float4*>(dst)[q] = v;
    r[4 * q + 0] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
  const float thr = sq_threshold<kDeg>(r[kDensity], p);
  reinterpret_cast<float4*>(dst)[kRec / 4] = make_float4(thr, 0.f, 0.f, 0.f);
  float x, y, z, a, b;
  cull_sphere<kGen>(r, thr, x, y, z, a, b);
  // shared origin: every pyramid's apex is 0 and its rho 0, so |p - c|
  // is taken once
  const float len0 = kGen ? 0.f : sqrtf(x * x + y * y + z * z);
  unsigned keep = 0u;
  if constexpr (kEllipsoid) {
    float mn, mx, q[6];
    row_norm_range(r, 1, mn, mx);
    cull_quadric(r, thr, mx / mn, q);
    const float a2 = a * a;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const Bundle& bd = bundles[w];
      bool k = bd.mode == kBundleAll;
      if (bd.mode == kBundlePlanes) {
        float ex = x, ey = y, ez = z, base = 2.0f * b * len0;
        if constexpr (kGen) {
          ex = x - bd.cx;
          ey = y - bd.cy;
          ez = z - bd.cz;
          const float len = sqrtf(ex * ex + ey * ey + ez * ez);
          base = 2.0f * b * (len + bd.rho) + bd.rho;
        }
        k = ellipsoid_keeps(bd, quads[w], ex, ey, ez, a, a2, q, base);
      }
      keep |= static_cast<unsigned>(k) << w;
    }
  } else if constexpr (kGen) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      keep |= static_cast<unsigned>(bundle_keeps(bundles[w], x, y, z, a, b))
              << w;
    }
  } else {
    const float reach = a + 2.0f * b * len0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const Bundle& bd = bundles[w];
      const bool k = bd.mode == kBundlePlanes
                         ? planes_keep(bd, x, y, z, reach)
                         : bd.mode == kBundleAll;
      keep |= static_cast<unsigned>(k) << w;
    }
  }
  return keep;
}

// sort_window over a warp's listed lanes list[i0, i1) of one window
// (staged rows at rows + j kRgbRow): the accepted ones by (hit_t, list
// order), their alphas beside; pos gets each one's offset in the list
// from i0. The list keeps lane order, so the order is the unculled
// sort's. A candidate at or past the largest key so far (most: the pairs
// come in depth order) is appended without reading the arrays back.
template <int kDeg, int kW, bool kGen>
__device__ __forceinline__ int sort_list(const float* rows,
                                         const uint8_t* list, int i0, int i1,
                                         const Ray& ray,
                                         const RasterParams& p,
                                         float (&key)[kW], uint8_t (&pos)[kW],
                                         float (&alpha)[kW]) {
  int n = 0;
  float last = 0.f;   // the largest key so far (n > 0)
  for (int i = i0; i < i1; ++i) {
    const float* row = rows + list[i] * kRgbRow;
    float r[kRec];
    load_rgb_row(row, r);
    Hit h;
    if (!eval_ray<kDeg, kGen>(r, 1, ray, row[kThrSlot], p, h)) continue;
    int q = n++;
    if (q == 0 || !(last > h.hit_t)) {
      last = h.hit_t;
    } else {
      while (q > 0 && key[q - 1] > h.hit_t) {
        key[q] = key[q - 1];
        pos[q] = pos[q - 1];
        alpha[q] = alpha[q - 1];
        --q;
      }
    }
    key[q] = h.hit_t;
    pos[q] = static_cast<uint8_t>(i - i0);
    alpha[q] = h.alpha;
  }
  return n;
}

// The end of the window that starts at list[i]: the first list index
// past it whose lane lies in another window of kW lanes.
template <int kW>
__device__ __forceinline__ int window_end(const uint8_t* list, int i, int n) {
  const int wi = list[i] / kW;
  int i1 = i + 1;
  while (i1 < n && list[i1] / kW == wi) ++i1;
  return i1;
}

// The pixel of thread t in a tile's 16x16 block: warp w takes the 8x4
// block (w % 2, w / 2), lane l its pixel (l % 8, l / 8); (dx, dy) from
// the tile's corner.
__device__ __forceinline__ int warp_block_x(int t) {
  return ((t >> 5) & 1) * 8 + (t & 7);
}
__device__ __forceinline__ int warp_block_y(int t) {
  return (t >> 6) * 4 + ((t >> 3) & 3);
}

// One pass of a ray's k-buffer over a window's listed lanes list[i0, i1)
// (staged records at rec[j], field f at rec[j + f * stride]): the sphere
// test, then the exact test (eval_hit_general) of each; buf gets the
// kTraceK smallest keys above last of the accepted. Returns how many were
// above last: more than kTraceK calls for another pass from the largest
// key composited.
template <int kDeg>
__device__ __forceinline__ int kbuffer_pass(const float* rec, int stride,
                                            const uint8_t* list, int i0,
                                            int i1, const Ray& ray, float dd,
                                            const RasterParams& p,
                                            uint64_t last,
                                            uint64_t (&buf)[kTraceK]) {
#pragma unroll
  for (int q = 0; q < kTraceK; ++q) buf[q] = ~0ull;
  int cnt = 0;
  for (int i = i0; i < i1; ++i) {
    const int j = list[i];
    const float* r = rec + j;
    if (!sphere_keeps(ray, dd, ray.ox - r[0], ray.oy - r[stride],
                      ray.oz - r[2 * stride], r[(kRec + 1) * stride],
                      r[(kRec + 2) * stride])) {
      continue;
    }
    Hit h;
    if (!eval_hit_general<kDeg>(r, stride, ray, r[kRec * stride], p, h)) {
      continue;
    }
    const uint64_t key = window_key(h.hit_t, j);
    if (key > last) {
      ++cnt;
      kbuffer_insert(buf, key);
    }
  }
  return cnt;
}

// The NHT record (raster.py's NHT mode, the TPU's kernel 8; always the
// general mode): p (3), M (9), density, then 12 control features for each
// of the 4 vertices of the canonical tetrahedron, vertex-major (48), and 3
// slots of padding. A ray reads sin and cos of the vertices' barycentric
// blend at its canonical hit point: 24 ray features, (sin, cos) per
// control dim.
constexpr int kRecNht = 64;
constexpr int kNhtFeat = 13;               // first control-feature slot
constexpr int kNhtDim = 12;                // control features per vertex
constexpr int kNhtOut = 2 * kNhtDim;       // ray features

// The canonical tetrahedron (raster.py:_tetra_constants, in fp32 as the
// JAX kernel uses them): vertex 0, and the rows G1-G3 of the inverse edge
// matrix, w_i = G_i . (c - v0) for i = 1..3 and w_0 = 1 - w_1 - w_2 - w_3.
// The zero entries of G2 and G3 are left out of the products.
constexpr float kTetV0x = 2.44948983f, kTetV0y = -1.41421354f,
                kTetV0z = -1.0f;
constexpr float kTetG1x = -0.204124153f, kTetG1y = -0.117851131f,
                kTetG1z = -0.0833333358f;
constexpr float kTetG2y = 0.235702261f, kTetG2z = -0.0833333358f;
constexpr float kTetG3z = 0.25f;

// The canonical hit point c = a + b tc, tc = -(a . b) / |b|^2 (the
// unscaled hit distance; raster.py:433-435), and its barycentric weights.
struct NhtHit {
  float tc;
  float cx, cy, cz;
  float w[4];
};

__device__ __forceinline__ NhtHit nht_hit(const Hit& h) {
  NhtHit n;
  n.tc = -h.q * h.inv_m;
  n.cx = h.ax + h.bx * n.tc;
  n.cy = h.ay + h.by * n.tc;
  n.cz = h.az + h.bz * n.tc;
  const float dx = n.cx - kTetV0x, dy = n.cy - kTetV0y, dz = n.cz - kTetV0z;
  n.w[1] = kTetG1x * dx + kTetG1y * dy + kTetG1z * dz;
  n.w[2] = kTetG2y * dy + kTetG2z * dz;
  n.w[3] = kTetG3z * dz;
  n.w[0] = 1.0f - n.w[1] - n.w[2] - n.w[3];
  return n;
}

// A staged NHT record (kernels B and C): a row of kNhtRow floats, pair
// after pair in shared memory, with kNhtRowPad floats of padding before the
// 64 fields (so the 48 control features start 16-byte aligned, four
// control dims of a vertex to a float4; the hit test's 13 fields are the
// row's first four float4) and the squared-distance threshold last.
constexpr int kNhtRowPad = 3;
constexpr int kNhtRow = kNhtRowPad + kRecNht + 1;
static_assert((kNhtRowPad + kNhtFeat) % 4 == 0 && kNhtRow % 4 == 0,
              "float4 rows and features");

// Stage record ``rec`` of the [C, 64] table into row ``dst`` (16-byte
// aligned) with float4 copies: each float4 stored takes the last three
// fields of one float4 read and the first of the next. The row's first
// padding float gets the largest |control feature| (for nht_far).
template <int kDeg>
__device__ __forceinline__ void stage_nht_row(const float* rec, float* dst,
                                              const RasterParams& p) {
  const float4* src = reinterpret_cast<const float4*>(rec);
  float4* out = reinterpret_cast<float4*>(dst);
  float4 prev = make_float4(0.f, 0.f, 0.f, 0.f);
  float dens = 0.f, fmax_abs = 0.f;
#pragma unroll
  for (int q = 0; q < kRecNht / 4; ++q) {
    const float4 cur = src[q];
    // fields 13-15, then 16-63, are the features (and 3 padding zeros)
    const float m4 = fmaxf(fmaxf(fabsf(cur.y), fabsf(cur.z)),
                           fmaxf(fabsf(cur.w), q > 3 ? fabsf(cur.x) : 0.f));
    if (q == 3) dens = cur.x;
    if (q >= 3) fmax_abs = fmaxf(fmax_abs, m4);
    out[q] = make_float4(prev.y, prev.z, prev.w, cur.x);
    prev = cur;
  }
  static_assert(kDensity == 12 && kNhtFeat == 13, "density in float4 3");
  dst[0] = fmax_abs;
  out[kRecNht / 4] = make_float4(prev.y, prev.z, prev.w,
                                 sq_threshold<kDeg>(dens, p));
}

// The fast sine and cosine below hold for |x| <= kTrigFastMax = 2^20,
// far past any blend of trained features; a hit whose blends may pass it
// (nht_far) takes the accurate libdevice sincosf instead (nht_dims<true>).
// Past ~2^23 the reduced argument leaves [-4, 4] and the fast path's
// error grows.
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

__device__ __forceinline__ float part4(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// Whether a hit with barycentric weights wb on a staged NHT row may have
// a blend past kTrigFastMax: |b_k| <= max_v |f_v| sum_v |wb_v|, the
// largest |feature| staged in the row's first float; the 0.999 covers
// the float32 rounding of the blend and of this bound. Kernels B and C
// take the accurate sine for such a hit (never for trained features:
// the bound is ~1).
__device__ __forceinline__ bool nht_far(const float* row,
                                        const float (&wb)[4]) {
  const float sw = (fabsf(wb[0]) + fabsf(wb[1])) + (fabsf(wb[2]) +
                                                    fabsf(wb[3]));
  return !(row[0] * sw <= 0.999f * kTrigFastMax);
}

// The libdevice sincosf, out of line: the accurate path of a far hit
// keeps its Payne-Hanek frame out of the unrolled hot loop.
__device__ __noinline__ void sincos_accurate(float x, float& s, float& c) {
  sincosf(x, &s, &c);
}

// Control dims 4c .. 4c + 3 of an accepted hit with barycentric weights
// wb on a staged NHT row (its control features at ``feat``, 16-byte
// aligned, vertex-major): f[v][i], vertex v's value of dim 4c + i (one
// float4 load a vertex); the blends b_i = sum_v wb_v f[v][i] in explicit
// FMAs; and sn[i], cs[i] their sine and cosine: sincos_fast, or with
// kAccurate (a hit nht_far finds) the libdevice sincosf. Kernels B and C
// both take a hit's features from here, so they agree on them bit for
// bit.
template <bool kAccurate>
__device__ __forceinline__ void nht_dims(const float* feat,
                                         const float (&wb)[4], int c,
                                         float (&f)[4][4], float (&sn)[4],
                                         float (&cs)[4]) {
  float4 fv[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    fv[v] = *reinterpret_cast<const float4*>(feat + v * kNhtDim + 4 * c);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int v = 0; v < 4; ++v) f[v][i] = part4(fv[v], i);
    const float b = __fmaf_rn(wb[0], f[0][i], __fmaf_rn(wb[1], f[1][i],
                    __fmaf_rn(wb[2], f[2][i], __fmul_rn(wb[3], f[3][i]))));
    if constexpr (kAccurate) {
      sincos_accurate(b, sn[i], cs[i]);
    } else {
      sincos_fast(b, sn[i], cs[i]);
    }
  }
}

// Call launch(deg, win, gen) with the kernel degree, sort window and
// geometry mode of a raster launch as compile-time constants
// (std::integral_constant): degree 2 or 4, window 0 (global-Z order) or 16
// (the window every shipped sorted config composes), shared origin
// (general 0) or the general mode (1), the instantiations that
// ops/cuda/raster.py:DEGREES and WINDOWS name. Returns the launch's error,
// or cudaErrorInvalidValue for a combination that is not built.
template <typename F>
int launch_mode(int degree, int window, int general, F&& launch) {
  using D2 = std::integral_constant<int, 2>;
  using D4 = std::integral_constant<int, 4>;
  using W0 = std::integral_constant<int, 0>;
  using W16 = std::integral_constant<int, 16>;
  using G0 = std::integral_constant<bool, false>;
  using G1 = std::integral_constant<bool, true>;
  auto with_gen = [&](auto deg, auto win) {
    if (general) {
      launch(deg, win, G1{});
    } else {
      launch(deg, win, G0{});
    }
  };
  if (general != 0 && general != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (degree * 100 + window) {
    case 200: with_gen(D2{}, W0{}); break;
    case 216: with_gen(D2{}, W16{}); break;
    case 400: with_gen(D4{}, W0{}); break;
    case 416: with_gen(D4{}, W16{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Call launch(deg, win, gen, shared, normals) for a launch of kernel B
// (kNormals: the normals output is built) or C (not built) with its mode
// as compile-time constants. Built: launch_mode's eight modes, unshared;
// and trace()'s (render/grt.py): degree 4, the general mode, window 128
// over per-block segments (the grid), or window 0 (global order) or 128
// over a shared segment (brute force, the TPU's kernel 7). normals
// (kernel B only) doubles each. Returns the launch's error, or
// cudaErrorInvalidValue for a combination that is not built.
template <bool kNormals, typename F>
int launch_raster(int degree, int window, int general, int shared,
                  int normals, F&& launch) {
  using B0 = std::integral_constant<bool, false>;
  using B1 = std::integral_constant<bool, true>;
  using D4 = std::integral_constant<int, 4>;
  using W0 = std::integral_constant<int, 0>;
  using W128 = std::integral_constant<int, 128>;
  if ((shared != 0 && shared != 1)
      || (normals != 0 && !(kNormals && normals == 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = [&](auto deg, auto win, auto gen, auto sh) {
    if (!normals) {
      launch(deg, win, gen, sh, B0{});
    } else if constexpr (kNormals) {
      launch(deg, win, gen, sh, B1{});
    }
  };
  if (!shared && window != 128) {
    return launch_mode(degree, window, general, [&](auto deg, auto win,
                                                    auto gen) {
      go(deg, win, gen, B0{});
    });
  }
  if (degree != 4 || general != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (window * 10 + shared) {
    case 1: go(D4{}, W0{}, B1{}, B1{}); break;
    case 1280: go(D4{}, W128{}, B1{}, B0{}); break;
    case 1281: go(D4{}, W128{}, B1{}, B1{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Call launch(deg) for an NHT launch, which the kernels build for degrees
// 2 and 4 in the general mode with global-Z order only (JAX turns the
// sorted mode off for NHT, render/gut.py:208). Returns the launch's error,
// or cudaErrorInvalidValue for another combination.
template <typename F>
int launch_nht(int degree, int window, int general, F&& launch) {
  if (window != 0 || general != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (degree) {
    case 2: launch(std::integral_constant<int, 2>{}); break;
    case 4: launch(std::integral_constant<int, 4>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gut

// The k-buffer's extra passes so far (common.cuh:g_window_overflows) into
// *out; reset: then zero them. Returns the CUDA error.
extern "C" int window_overflows(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, gut::g_window_overflows,
                                         sizeof(*out));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0ull;
    err = cudaMemcpyToSymbol(gut::g_window_overflows, &zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
