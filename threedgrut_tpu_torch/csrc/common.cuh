// Shared by every kernel library of the port: the C entry point that
// turns a CUDA error code returned by a launch function into its text,
// and the per-(pixel, pair) hit math of the raster kernels.
#pragma once
#include <cuda_runtime.h>

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
  float gg_scale;         // s = -0.5 for degree 2
};

// Per-pair squared-distance acceptance threshold (raster.py:
// _sq_accept_threshold, degree 2):
//   resp > min_response and resp * density > min_alpha  <=>
//   sq < min(ln(min_response), ln(min_alpha) - ln(density)) / s
__device__ __forceinline__ float sq_threshold(float density,
                                              const RasterParams& p) {
  return fminf(p.sq_thr_response,
               (p.log_min_alpha - logf(fmaxf(density, 1e-30f))) / p.gg_scale);
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
  float resp;       // exp(s * sq)
  float alpha_raw;  // resp * density
  float alpha;      // min(max_alpha, alpha_raw)
};

// Evaluate record ``r`` (field f at r[f * stride]) on the unit ray
// direction d. Returns whether the candidate is accepted (sq below the
// staged threshold ``thr``) and hits inside (tmin, tmax); the fields of
// ``h`` after the failing test are left unset. Kernels B and C both call
// this, so their accept and kill decisions are the same: built with
// -fmad=false, the fp32 operation order is that of the plain PyTorch
// version (ops/cuda/raster.py:_hit_terms).
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
  h.resp = expf(p.gg_scale * h.sq);
  h.alpha_raw = h.resp * r[kDensity * stride];
  h.alpha = fminf(p.max_alpha, h.alpha_raw);
  return true;
}

}  // namespace gut
