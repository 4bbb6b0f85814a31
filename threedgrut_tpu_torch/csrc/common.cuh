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

// Intermediates of one ray against one particle record in the shared-origin
// factorisation: b = M d, c = a x b, m = |b|^2, q = a . b.
struct Hit {
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
  const float ax = r[0], ay = r[stride], az = r[2 * stride];
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

// d resp / d sq (ops/hit.py:particle_response_dsq): resp s (degree 2),
// resp s 2 sq (degree 4).
template <int kDeg>
__device__ __forceinline__ float response_dsq(const Hit& h,
                                              const RasterParams& p) {
  if (kDeg == 4) return h.resp * p.gg_scale * 2.0f * h.sq;
  return h.resp * p.gg_scale;
}

// The sorted mode's per-ray window (raster.py:_chunk_composite with
// sorted_compositing, the 3DGRT k-buffer): the accepted candidates among
// the staged lanes [lo, hi) of one window, in ascending hit_t. Insertion
// sort of (hit_t, lane) in per-thread arrays; equal keys keep lane order
// (the plain version's stable sort). Returns the count; the caller
// re-evaluates each lane's hit from shared memory, which gives the same
// values bit for bit, so only the key and an 8-bit lane ride the sort.
template <int kDeg, int kW>
__device__ __forceinline__ int sort_window(const float* rec, int stride,
                                           const float* thr, int lo, int hi,
                                           float dx, float dy, float dz,
                                           float tmin, float tmax,
                                           const RasterParams& p,
                                           float (&key)[kW],
                                           uint8_t (&lane)[kW]) {
  int n = 0;
  for (int j = lo; j < hi; ++j) {
    Hit h;
    if (!eval_hit<kDeg>(rec + j, stride, dx, dy, dz, tmin, tmax, thr[j], p,
                        h)) {
      continue;
    }
    int i = n++;
    while (i > 0 && key[i - 1] > h.hit_t) {
      key[i] = key[i - 1];
      lane[i] = lane[i - 1];
      --i;
    }
    key[i] = h.hit_t;
    lane[i] = static_cast<uint8_t>(j);
  }
  return n;
}

// Call launch(deg, win) with the kernel degree and sort window of a raster
// launch as compile-time constants (std::integral_constant): degree 2 or
// 4, window 0 (global-Z order) or 16 (the window every shipped sorted
// config composes), the instantiations that ops/cuda/raster.py:DEGREES and
// WINDOWS name. Returns the launch's error, or cudaErrorInvalidValue for a
// pair that is not built.
template <typename F>
int launch_mode(int degree, int window, F&& launch) {
  using D2 = std::integral_constant<int, 2>;
  using D4 = std::integral_constant<int, 4>;
  using W0 = std::integral_constant<int, 0>;
  using W16 = std::integral_constant<int, 16>;
  switch (degree * 100 + window) {
    case 200: launch(D2{}, W0{}); break;
    case 216: launch(D2{}, W16{}); break;
    case 400: launch(D4{}, W0{}); break;
    case 416: launch(D4{}, W16{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gut
