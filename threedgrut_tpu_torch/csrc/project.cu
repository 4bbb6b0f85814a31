// Kernel P: a view's projection of every particle row in one pass.
//
// Replaces no TPU kernel: the JAX package writes the projection as plain
// XLA-fused code (threedgrut_tpu/ops/ut.py, ops/sh.py, render/gut.py), and
// the port ran it as plain PyTorch (ops/ut.py:unscented_projection,
// ops/sh.py:eval_sh_radiance, render/gut.py:particle_table and
// _scene_aabb): some 500 launches a view, each sweeping every row, 19.6 ms
// of a 2.3M-row 1920x1080 frame's 23.4 ms of kernels on an H100. It serves
// every render of an SH model on the card; under a gradient
// ops/cuda/project.py:ProjectFunction pairs it with its backward, kernel
// P_b (below). ops/cuda/project.py:project_view_plain, the composition,
// is its plain version.
//
// Per row, in fp32: the activations of scale and density; the UT
// projection (7 sigma points through the camera model and shutter, the
// weighted covariance, dilation, conic, mip-splatting opacity, the validity
// tests, the extent and the sort depth); the SH radiance at the
// sensor-to-particle direction up to the active degree, clamped at 0; the
// 16-float table record (a = M (o - p) with one shared origin o, else p;
// M = diag(1/s) R^T row-major; density; rgb); and the scene AABB of the
// active rows (+-3 sigma): min and max over the block, then one atomic min
// and max a block and axis on the float's order-preserving integer views,
// exact and independent of the order.
//
// Bound on this card: memory. A row reads 236 B at SH degree 3 (position
// 12, quaternion 16, scale 12, density 4, SH 192) and writes 101 (valid 1,
// center 8, conic 12, opacity 4, extent 8, depth 4, the record 64): 337 B,
// 0.23 ms at 3.35 TB/s for 2,300,160 rows, against ~800 fp32 operations a
// row (~0.03 ms at 67 TFLOP/s; chip_smoke.py:PROJECT_FLOPS). Design: one thread a row, kRows rows a
// block. The block stages its contiguous slices of the six row-major inputs
// in shared memory (30 KB at degree 3) with 16-byte cp.async copies, all in
// flight before any thread computes, so each byte is read once, by
// coalesced 16-byte transactions, where a thread's own loads would stride
// 180 bytes; the records and conics go back through shared memory as
// coalesced float4 stores. Templated on the camera model and on the
// shutter, so the global-shutter path carries no rolling-shutter state
// (a rolling shutter's sigma points stay a loop, keeping its build short).
// On an H100 it takes 0.31 ms at 2,300,160 rows, 74% of the byte bound.
// The camera is read on the card from its own tensors: no host read. Built
// without FMA contraction, with precise expf, logf, sqrtf and division:
// each row gets the plain composition's values up to the order of its sums.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;          // rows (threads) a block
constexpr int kWarps = kRows / 32;
constexpr int kMaxSpec = 45;        // SH degree 3: 15 coefficients x 3
constexpr int kStageFloats = (3 + 4 + 3 + 1 + 3 + kMaxSpec) * kRows;
constexpr int kCamFloats = 46;
constexpr float kBig = 3e37f;       // render/gut.py:_scene_aabb's fill

enum Model { kPinhole = 0, kFisheye = 1, kFTheta = 2 };
enum Act { kNone = 0, kExp = 1, kSigmoid = 2 };
enum Shutter { kGlobal = 0, kTopToBottom = 1, kLeftToRight = 2,
               kBottomToTop = 3, kRightToLeft = 4 };

// the order of project_launch's arrays (ops/cuda/project.py mirrors it)
constexpr int kNumInputs = 6;    // positions rotation scale density albedo spec
constexpr int kNumOutputs = 8;   // valid center conic opacity extent depth table aabb
constexpr int kNumCamFields = 13;
constexpr int kNumInts = 18;
constexpr int kNumFloats = 12;

struct Params {
  int n, n_active, sh_degree, sh_stride;
  int scale_act, density_act, model, shutter, n_iterations, ftheta_ref;
  int require_all, rect, tight, mip, global_z, shared;
  int width, height;
  float w0, wi, w0_cov, delta;
  float lo_x, lo_y, hi_x, hi_y, roi;  // the image's margin bounds
  float min_sensor_z, dilation, alpha_threshold;
};

static_assert(offsetof(Params, w0) == kNumInts * sizeof(int) &&
                  sizeof(Params) == (kNumInts + kNumFloats) * 4,
              "Params: kNumInts ints, then kNumFloats floats");

// the camera's tensors, in the order of CameraModel's fields
struct CamPtrs {
  const float* f[kNumCamFields];
};

struct Inputs {
  const float *pos, *rot, *scale, *dens, *albedo, *spec;
};

struct Outputs {
  uint8_t* valid;
  float *center, *conic, *opacity, *extent, *depth, *table, *aabb;
};

// the camera as a block reads it: its fields, the rotations of its start
// and end quaternions (as given, as ops/cameras.py:world_to_camera), the
// sensor position, and the pose slerp's per-camera terms
struct Cam {
  float focal[2], principal[2], radial[6], tangential[2], prism[4];
  float max_angle;
  float a2p[6], p2a[6], cde[3];
  float t0[3], q0[4], t1[3], q1[4];  // q1 on q0's side for the slerp
  float r0[9], r1[9];
  float sensor[3];
  float dcoef[5];
  float theta, safe;
  int lerp;
};

__device__ __forceinline__ void rotmat(float w, float x, float y, float z,
                                       float* r) {
  // ops/quaternion.py:quat_to_rotmat
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  r[0] = 1.0f - 2.0f * (yy + zz);
  r[1] = 2.0f * (xy - wz);
  r[2] = 2.0f * (xz + wy);
  r[3] = 2.0f * (xy + wz);
  r[4] = 1.0f - 2.0f * (xx + zz);
  r[5] = 2.0f * (yz - wx);
  r[6] = 2.0f * (xz - wy);
  r[7] = 2.0f * (yz + wx);
  r[8] = 1.0f - 2.0f * (xx + yy);
}

// the i-th of the camera's kCamFloats values, its fields end to end
__device__ float cam_field(const CamPtrs& c, int i) {
  constexpr int count[kNumCamFields] = {2, 2, 6, 2, 4, 1, 6, 6, 3,
                                        3, 4, 3, 4};
#pragma unroll
  for (int f = 0; f < kNumCamFields; ++f) {
    if (i < count[f]) return c.f[f][i];
    i -= count[f];
  }
  return 0.f;
}

// one thread: the raw fields in CameraModel order -> Cam
__device__ void derive_camera(const float* raw, Cam* c) {
  const float* s = raw;
  auto take = [&s](float* dst, int n) {
    for (int i = 0; i < n; ++i) dst[i] = *s++;
  };
  take(c->focal, 2);
  take(c->principal, 2);
  take(c->radial, 6);
  take(c->tangential, 2);
  take(c->prism, 4);
  take(&c->max_angle, 1);
  take(c->a2p, 6);
  take(c->p2a, 6);
  take(c->cde, 3);
  take(c->t0, 3);
  take(c->q0, 4);
  take(c->t1, 3);
  take(c->q1, 4);
  rotmat(c->q0[0], c->q0[1], c->q0[2], c->q0[3], c->r0);
  rotmat(c->q1[0], c->q1[1], c->q1[2], c->q1[3], c->r1);
  // ops/ut.py:sensor_position: -(R^T t)
  for (int i = 0; i < 3; ++i) {
    c->sensor[i] = -(c->r0[i] * c->t0[0] + c->r0[3 + i] * c->t0[1] +
                     c->r0[6 + i] * c->t0[2]);
  }
  // ops/cameras.py:_project_ftheta's derivative coefficients
  for (int i = 0; i < 5; ++i) {
    c->dcoef[i] = static_cast<float>(i + 1) * c->p2a[i + 1];
  }
  // ops/quaternion.py:quat_slerp's terms that do not depend on t
  float dot = c->q0[0] * c->q1[0];
  for (int i = 1; i < 4; ++i) dot = dot + c->q0[i] * c->q1[i];
  if (dot < 0.f) {
    for (int i = 0; i < 4; ++i) c->q1[i] = -c->q1[i];
  }
  dot = fminf(fmaxf(fabsf(dot), -1.0f), 1.0f);
  c->theta = acosf(dot);
  const float st = sinf(c->theta);
  c->lerp = st < 1e-7f;
  c->safe = c->lerp ? 1.0f : st;
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kExp) return expf(x);
  if (act == kSigmoid) return 1.0f / (1.0f + expf(-x));
  return x;
}

__device__ __forceinline__ bool within(float u, float v, const Params& p) {
  return u > p.lo_x && v > p.lo_y && u < p.hi_x && v < p.hi_y;
}

// ops/cameras.py:_stable_norm2
__device__ __forceinline__ float stable_norm2(float x, float y) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mn = fminf(ax, ay), mx = fmaxf(ax, ay);
  const float ratio = mn / fmaxf(mx, 1e-30f);
  return mx <= 0.f ? 0.f : mx * sqrtf(1.0f + ratio * ratio);
}

// sum_i c[i] x^i, i < n (ops/cameras.py:_horner)
__device__ __forceinline__ float horner(const float* c, int n, float x) {
  float y = c[n - 1];
  for (int i = n - 2; i >= 0; --i) y = x * y + c[i];
  return y;
}

// a camera-space point -> its pixel and validity (ops/cameras.py:
// project_point with the image's margin)
template <int kModel>
__device__ __forceinline__ bool project_point(const Cam& c, const Params& p,
                                              float x, float y, float z,
                                              float& u, float& v) {
  if (kModel == kPinhole) {
    // _project_opencv_pinhole
    const bool valid_z = z > 0.f;
    const float zs = valid_z ? z : 1.0f;
    const float ux = x / zs, uy = y / zs;
    const float u2x = ux * ux, u2y = uy * uy;
    const float r2 = u2x + u2y;
    const float a1 = 2.0f * ux * uy;
    const float a2 = r2 + 2.0f * u2x;
    const float a3 = r2 + 2.0f * u2y;
    const float* k = c.radial;
    const float num = 1.0f + r2 * (k[0] + r2 * (k[1] + r2 * k[2]));
    const float den = 1.0f + r2 * (k[3] + r2 * (k[4] + r2 * k[5]));
    const float icd = num / den;
    const float t0 = c.tangential[0], t1 = c.tangential[1];
    const float* s = c.prism;
    const float dx = t0 * a1 + t1 * a2 + r2 * (s[0] + r2 * s[1]);
    const float dy = t0 * a3 + t1 * a1 + r2 * (s[2] + r2 * s[3]);
    const bool valid_radial = icd > 0.8f && icd < 1.2f;
    if (valid_radial) {
      u = (icd * ux + dx) * c.focal[0] + c.principal[0];
      v = (icd * uy + dy) * c.focal[1] + c.principal[1];
    } else {
      // an out-of-image radius along the direction
      const float scale = (1.0f / sqrtf(fmaxf(r2, 1e-20f))) * p.roi;
      u = scale * ux + c.principal[0];
      v = scale * uy + c.principal[1];
    }
    const bool valid = valid_z && valid_radial && within(u, v, p);
    if (!valid_z) {
      u = 0.f;
      v = 0.f;
    }
    return valid;
  } else {
    // _project_opencv_fisheye, _project_ftheta
    const float rho = fmaxf(stable_norm2(x, y), 1.1754944e-38f);
    const float theta = fminf(atan2f(rho, z), c.max_angle);
    if (kModel == kFisheye) {
      const float theta2 = theta * theta;
      const float poly = horner(c.radial, 4, theta2);
      const float delta = theta * (poly * theta2 + 1.0f) / rho;
      u = c.focal[0] * x * delta + c.principal[0];
      v = c.focal[1] * y * delta + c.principal[1];
    } else {
      float delta = horner(c.a2p, 6, theta);
      if (p.ftheta_ref == 1) {
        for (int it = 0; it < 3; ++it) {
          const float dfdx = horner(c.dcoef, 5, delta);
          const float residual = horner(c.p2a, 6, delta) - theta;
          delta = delta - residual / dfdx;
        }
      }
      const float scaled = delta / rho;
      u = scaled * (c.cde[0] * x + c.cde[1] * y) + c.principal[0] + 0.5f;
      v = scaled * (c.cde[2] * x + y) + c.principal[1] + 0.5f;
    }
    return theta < c.max_angle && within(u, v, p);
  }
}

__device__ __forceinline__ void to_camera(const float* r, const float* t,
                                          const float* w, float* out) {
  for (int i = 0; i < 3; ++i) {
    out[i] = r[3 * i] * w[0] + r[3 * i + 1] * w[1] + r[3 * i + 2] * w[2] +
             t[i];
  }
}

// ops/cameras.py:relative_shutter_time
__device__ __forceinline__ float shutter_time(const Params& p, float u,
                                              float v) {
  switch (p.shutter) {
    case kTopToBottom:
      return floorf(v) / (p.height - 1.0f);
    case kLeftToRight:
      return floorf(u) / (p.width - 1.0f);
    case kBottomToTop:
      return (static_cast<float>(p.height) - ceilf(v)) / (p.height - 1.0f);
    case kRightToLeft:
      return (static_cast<float>(p.width) - ceilf(u)) / (p.width - 1.0f);
    default:
      return 0.5f;
  }
}

// a world point through the shutter -> its pixel and validity
// (ops/cameras.py:project_point_with_shutter)
template <int kModel, bool kRolling>
__device__ __forceinline__ bool project_world(const Cam& c, const Params& p,
                                              const float* w, float& u,
                                              float& v) {
  float pc[3];
  to_camera(c.r0, c.t0, w, pc);
  bool valid = project_point<kModel>(c, p, pc[0], pc[1], pc[2], u, v);
  if (!kRolling) return valid;
  float ue, ve;
  to_camera(c.r1, c.t1, w, pc);
  const bool valid_end = project_point<kModel>(c, p, pc[0], pc[1], pc[2],
                                               ue, ve);
  if (!valid) {
    u = ue;
    v = ve;
  }
  const bool seeded = valid || valid_end;
  valid = seeded;
  for (int it = 0; it < p.n_iterations; ++it) {
    const float a = shutter_time(p, u, v);
    float w0, w1;
    if (c.lerp) {
      w0 = 1.0f - a;
      w1 = a;
    } else {
      w0 = sinf((1.0f - a) * c.theta) / c.safe;
      w1 = sinf(a * c.theta) / c.safe;
    }
    float q[4];
    for (int i = 0; i < 4; ++i) q[i] = w0 * c.q0[i] + w1 * c.q1[i];
    const float norm =
        fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]),
              1e-12f);
    float r[9], t[3];
    rotmat(q[0] / norm, q[1] / norm, q[2] / norm, q[3] / norm, r);
    for (int i = 0; i < 3; ++i) t[i] = c.t0[i] * (1.0f - a) + c.t1[i] * a;
    to_camera(r, t, w, pc);
    valid = project_point<kModel>(c, p, pc[0], pc[1], pc[2], u, v);
  }
  return valid && seeded;
}

// ops/sh.py:eval_sh_radiance for one channel: the DC coefficient and the
// rest (stride 3) up to the nb basis functions, clamped at 0; unrolled, so
// the basis stays in registers
__device__ __forceinline__ float sh_radiance(const float* basis, int nb,
                                             float dc, const float* rest) {
  float acc = basis[0] * dc;
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    if (k < nb) acc = acc + basis[k] * rest[3 * (k - 1)];
  }
  return fmaxf(acc + 0.5f, 0.f);
}

__device__ void sh_basis(float x, float y, float z, int degree,
                         float* b) {
  // ops/sh.py:sh_basis (constants of gaussianParticles.cuh)
  b[0] = 0.28209479177387814f;
  if (degree < 1) return;
  const float c1 = 0.4886025119029199f;
  b[1] = -c1 * y;
  b[2] = c1 * z;
  b[3] = -c1 * x;
  if (degree < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  b[4] = 1.0925484305920792f * xy;
  b[5] = -1.0925484305920792f * yz;
  b[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
  b[7] = -1.0925484305920792f * xz;
  b[8] = 0.5462742152960396f * (xx - yy);
  if (degree < 3) return;
  b[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
  b[10] = 2.890611442640554f * xy * z;
  b[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
  b[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  b[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
  b[14] = 1.445305721320277f * z * (xx - yy);
  b[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// n contiguous floats of src into dst (16-byte aligned), by the block:
// 16-byte copies where src is 16-byte aligned, the tail by 4 bytes
__device__ __forceinline__ void stage_in(float* dst, const float* src,
                                         int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += kRows) {
      cp_async16(dst + 4 * i, src + 4 * i);
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += kRows) {
    cp_async4(dst + i, src + i);
  }
}

// n contiguous floats of src (shared, 16-byte aligned) out to dst
__device__ __forceinline__ void stage_out(float* dst, const float* src,
                                          int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += kRows) {
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += kRows) dst[i] = src[i];
}

// atomic min / max of a float through its integer views: signed for
// values >= 0, whose order the signed bits keep; unsigned and reversed for
// negative ones
__device__ __forceinline__ void atomic_min_float(float* a, float v) {
  if (v >= 0.f) {
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_float(float* a, float v) {
  if (v >= 0.f) {
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
  }
}

__global__ void aabb_init_kernel(float* aabb) {
  if (threadIdx.x < 6) aabb[threadIdx.x] = threadIdx.x < 3 ? kBig : -kBig;
}

template <int kModel, bool kRolling>
__global__ void __launch_bounds__(kRows)
project_kernel(Inputs in, Outputs out, CamPtrs cam_ptrs, Params p) {
  __shared__ __align__(16) float s_buf[kStageFloats];
  __shared__ float s_raw[kCamFloats];
  __shared__ Cam s_cam;
  __shared__ float s_red[kWarps][6];

  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, p.n - r0);
  const int stride = p.sh_stride;
  float* s_pos = s_buf;
  float* s_rot = s_pos + 3 * kRows;
  float* s_scale = s_rot + 4 * kRows;
  float* s_dens = s_scale + 3 * kRows;
  float* s_alb = s_dens + kRows;
  float* s_spec = s_alb + 3 * kRows;

  // 1. every copy of the block's rows in flight, then the camera
  stage_in(s_pos, in.pos + 3 * static_cast<int64_t>(r0), 3 * nr);
  stage_in(s_rot, in.rot + 4 * static_cast<int64_t>(r0), 4 * nr);
  stage_in(s_scale, in.scale + 3 * static_cast<int64_t>(r0), 3 * nr);
  stage_in(s_dens, in.dens + r0, nr);
  stage_in(s_alb, in.albedo + 3 * static_cast<int64_t>(r0), 3 * nr);
  if (p.sh_degree > 0) {
    stage_in(s_spec, in.spec + stride * static_cast<int64_t>(r0),
             stride * nr);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (t < kCamFloats) s_raw[t] = cam_field(cam_ptrs, t);
  __syncthreads();
  if (t == 0) derive_camera(s_raw, &s_cam);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const Cam& c = s_cam;

  // 2. one row a thread
  const int row = r0 + t;
  const bool live = t < nr;
  bool valid = false;
  float cx = 0.f, cy = 0.f, con[3] = {0.f, 0.f, 0.f}, opacity = 0.f;
  float ex = 0.f, ey = 0.f, depth = 0.f;
  float rec[16];
  float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
  if (live) {
    const float pw[3] = {s_pos[3 * t], s_pos[3 * t + 1], s_pos[3 * t + 2]};
    const float4 q4 = reinterpret_cast<const float4*>(s_rot)[t];
    float s[3];
    for (int i = 0; i < 3; ++i) s[i] = activate(s_scale[3 * t + i],
                                                p.scale_act);
    const float dens = activate(s_dens[t], p.density_act);

    // ops/quaternion.py:quat_normalize, quat_to_rotmat
    const float qn = fmaxf(sqrtf(q4.x * q4.x + q4.y * q4.y + q4.z * q4.z +
                                 q4.w * q4.w),
                           1e-12f);
    float r[9];
    rotmat(q4.x / qn, q4.y / qn, q4.z / qn, q4.w / qn, r);

    // the sigma points: p, then p + delta R_a s_a and p - delta R_a s_a
    // for the axes a
    float pu[7], pv[7];
    int n_ok = project_world<kModel, kRolling>(c, p, pw, pu[0], pv[0]);
    auto sigma = [&](int k) {
      const int a = (k - 1) % 3;
      float w[3];
      for (int i = 0; i < 3; ++i) {
        const float d = p.delta * (r[3 * i + a] * s[a]);
        w[i] = k <= 3 ? pw[i] + d : pw[i] - d;
      }
      n_ok += project_world<kModel, kRolling>(c, p, w, pu[k], pv[k]);
    };
    if (kRolling) {
#pragma unroll 1
      for (int k = 1; k < 7; ++k) sigma(k);
    } else {
#pragma unroll
      for (int k = 1; k < 7; ++k) sigma(k);
    }
    float su = pu[1], sv = pv[1];
    for (int k = 2; k < 7; ++k) {
      su = su + pu[k];
      sv = sv + pv[k];
    }
    cx = p.w0 * pu[0] + p.wi * su;
    cy = p.w0 * pv[0] + p.wi * sv;
    float cov_xx = 0.f, cov_xy = 0.f, cov_yy = 0.f;
    for (int k = 0; k < 7; ++k) {
      const float wk = k == 0 ? p.w0_cov : p.wi;
      const float du = pu[k] - cx, dv = pv[k] - cy;
      cov_xx = cov_xx + wk * du * du;
      cov_xy = cov_xy + wk * du * dv;
      cov_yy = cov_yy + wk * dv * dv;
    }
    valid = p.require_all ? n_ok == 7 : n_ok > 0;

    // opacity threshold, min sensor z (ops/ut.py)
    const float sr[3] = {pw[0] - c.sensor[0], pw[1] - c.sensor[1],
                         pw[2] - c.sensor[2]};
    const float z_sensor =
        pw[0] * c.r0[6] + pw[1] * c.r0[7] + pw[2] * c.r0[8] + c.t0[2];
    valid = valid && dens >= p.alpha_threshold &&
            z_sensor >= p.min_sensor_z && row < p.n_active;

    // conic, extent
    const float dil_xx = cov_xx + p.dilation;
    const float dil_yy = cov_yy + p.dilation;
    const float det_dil = dil_xx * dil_yy - cov_xy * cov_xy;
    const float det_safe = det_dil == 0.f ? 1.0f : det_dil;
    con[0] = dil_yy / det_safe;
    con[1] = -cov_xy / det_safe;
    con[2] = dil_xx / det_safe;
    if (p.mip) {
      const float det_raw = cov_xx * cov_yy - cov_xy * cov_xy;
      opacity = dens * sqrtf(fmaxf(det_raw / det_safe, 2.5e-5f));
    } else {
      opacity = dens;
    }
    valid = valid && det_dil != 0.f && opacity >= p.alpha_threshold;
    const float max_power =
        logf(fmaxf(opacity, 1e-30f) / p.alpha_threshold);
    const float factor =
        p.tight ? fminf(sqrtf(2.0f * fmaxf(max_power, 0.f)), 3.33f) : 3.33f;
    const float mid = 0.5f * (dil_xx + dil_yy);
    const float lam_max = mid + sqrtf(fmaxf(mid * mid - det_dil, 0.01f));
    const float radius = factor * sqrtf(lam_max);
    ex = p.rect ? fminf(factor * sqrtf(dil_xx), radius) : radius;
    ey = p.rect ? fminf(factor * sqrtf(dil_yy), radius) : radius;
    valid = valid && radius > 0.f;
    const float dist = sqrtf(sr[0] * sr[0] + sr[1] * sr[1] + sr[2] * sr[2]);
    depth = p.global_z ? z_sensor : dist;
    if (!valid) {
      ex = 0.f;
      ey = 0.f;
      depth = INFINITY;
    }

    // SH radiance at the sensor -> particle direction
    const float dist_safe = fmaxf(dist, 1e-12f);
    const float vx = sr[0] / dist_safe, vy = sr[1] / dist_safe,
                vz = sr[2] / dist_safe;
    float basis[16];
    sh_basis(vx, vy, vz, p.sh_degree, basis);
    const int nb = (p.sh_degree + 1) * (p.sh_degree + 1);
    const float* spec = s_spec + stride * t;
    for (int ch = 0; ch < 3; ++ch) {
      rec[13 + ch] = sh_radiance(basis, nb, s_alb[3 * t + ch], spec + ch);
    }

    // the table record (render/gut.py:particle_table): M = diag(1/s) R^T
    for (int i = 0; i < 3; ++i) {
      const float inv_s = 1.0f / s[i];
      for (int j = 0; j < 3; ++j) rec[3 + 3 * i + j] = inv_s * r[3 * j + i];
    }
    if (p.shared) {
      const float d[3] = {c.sensor[0] - pw[0], c.sensor[1] - pw[1],
                          c.sensor[2] - pw[2]};
      for (int i = 0; i < 3; ++i) {
        const float* m = rec + 3 + 3 * i;
        rec[i] = m[0] * d[0] + m[1] * d[1] + m[2] * d[2];
      }
    } else {
      for (int i = 0; i < 3; ++i) rec[i] = pw[i];
    }
    rec[12] = dens;

    // the scene AABB (render/gut.py:_scene_aabb): +-3 sigma, active rows
    if (row < p.n_active) {
      const float rad = 3.0f * fmaxf(fmaxf(s[0], s[1]), s[2]);
      for (int i = 0; i < 3; ++i) {
        lo[i] = pw[i] - rad;
        hi[i] = pw[i] + rad;
      }
    }
  }

  // 3. the outputs: coalesced per-thread stores, the records and conics
  // through shared memory
  if (live) {
    out.valid[row] = valid;
    reinterpret_cast<float2*>(out.center)[row] = make_float2(cx, cy);
    reinterpret_cast<float2*>(out.extent)[row] = make_float2(ex, ey);
    out.opacity[row] = opacity;
    out.depth[row] = depth;
  }
  __syncthreads();  // every thread is done with the staged inputs
  float* s_table = s_buf;
  float* s_conic = s_buf + 16 * kRows;
  if (live) {
    float4* dst = reinterpret_cast<float4*>(s_table + 16 * t);
    for (int i = 0; i < 4; ++i) {
      dst[i] = make_float4(rec[4 * i], rec[4 * i + 1], rec[4 * i + 2],
                           rec[4 * i + 3]);
    }
    for (int i = 0; i < 3; ++i) s_conic[3 * t + i] = con[i];
  }
  for (int i = 0; i < 3; ++i) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], off));
      hi[i] = fmaxf(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], off));
    }
  }
  if ((t & 31) == 0) {
    for (int i = 0; i < 3; ++i) {
      s_red[t >> 5][i] = lo[i];
      s_red[t >> 5][3 + i] = hi[i];
    }
  }
  __syncthreads();
  stage_out(out.table + 16 * static_cast<int64_t>(r0), s_table, 16 * nr);
  stage_out(out.conic + 3 * static_cast<int64_t>(r0), s_conic, 3 * nr);
  if (t < 6) {
    float v = s_red[0][t];
    for (int w = 1; w < kWarps; ++w) {
      v = t < 3 ? fminf(v, s_red[w][t]) : fmaxf(v, s_red[w][t]);
    }
    if (t < 3) {
      atomic_min_float(out.aabb + t, v);
    } else {
      atomic_max_float(out.aabb + t, v);
    }
  }
}

template <int kModel, bool kRolling>
void launch(const Inputs& in, const Outputs& out, const CamPtrs& cam,
            const Params& p, cudaStream_t stream) {
  const int blocks = (p.n + kRows - 1) / kRows;
  project_kernel<kModel, kRolling><<<blocks, kRows, 0, stream>>>(in, out,
                                                                 cam, p);
}

#define PROJECT_KERNELS(X)                                           \
  X(kPinhole, false) X(kPinhole, true) X(kFisheye, false)            \
  X(kFisheye, true) X(kFTheta, false) X(kFTheta, true)

}  // namespace

// ptrs: the kNumInputs inputs (positions [N,3], rotation [N,4], scale
// [N,3], density [N,1], features_albedo [N,3], features_specular [N,S]),
// the kNumOutputs outputs (valid [N] bool, center [N,2], conic [N,3],
// opacity [N], extent [N,2], depth [N], table [N,16], aabb [6]: lo then
// hi), then the kNumCamFields camera tensors in CameraModel's order
// (focal, principal, radial, tangential, thin_prism, max_angle,
// ftheta_angle_to_pixeldist, ftheta_pixeldist_to_angle, ftheta_linear_cde,
// t_start, q_start, t_end, q_end). ints and floats: Params' fields in
// order. Returns the first CUDA error.
extern "C" int project_launch(const void* const* ptrs, const int* ints,
                              const float* floats, void* stream) {
  Params p;
  memcpy(&p, ints, kNumInts * sizeof(int));
  memcpy(&p.w0, floats, kNumFloats * sizeof(float));
  if (p.sh_stride > kMaxSpec || p.sh_degree < 0 || p.sh_degree > 3 ||
      p.sh_stride < 3 * ((p.sh_degree + 1) * (p.sh_degree + 1) - 1) ||
      p.model < kPinhole || p.model > kFTheta || p.shutter < kGlobal ||
      p.shutter > kRightToLeft) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto in_ptr = [ptrs](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out_ptr = [ptrs](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[kNumInputs + i]));
  };
  const Inputs in{in_ptr(0), in_ptr(1), in_ptr(2),
                  in_ptr(3), in_ptr(4), in_ptr(5)};
  const Outputs out{reinterpret_cast<uint8_t*>(out_ptr(0)), out_ptr(1),
                    out_ptr(2), out_ptr(3), out_ptr(4), out_ptr(5),
                    out_ptr(6), out_ptr(7)};
  CamPtrs cam;
  for (int i = 0; i < kNumCamFields; ++i) {
    cam.f[i] = static_cast<const float*>(ptrs[kNumInputs + kNumOutputs + i]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  aabb_init_kernel<<<1, 32, 0, s>>>(out.aabb);
  if (p.n > 0) {
    const bool rolling = p.shutter != kGlobal;
#define PROJECT_CASE(M, R) \
  if (p.model == M && rolling == R) launch<M, R>(in, out, cam, p, s);
    PROJECT_KERNELS(PROJECT_CASE)
#undef PROJECT_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers, local (spill and stack) bytes, static shared bytes and
// dynamic shared bytes (none) of the six instantiations, in the order
// pinhole, pinhole rolling, fisheye, fisheye rolling, ftheta, ftheta
// rolling: out[4 i + 0..3]. Returns the first error.
extern "C" int project_attributes(int* out) {
#define PROJECT_FN(M, R) reinterpret_cast<const void*>(project_kernel<M, R>),
  const void* fns[] = {PROJECT_KERNELS(PROJECT_FN)};
#undef PROJECT_FN
  for (int i = 0; i < 6; ++i) {
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

// Kernel P_b: the backward of kernel P under a gradient, the cotangent of
// its table to the six raw parameters (ops/cuda/project.py:ProjectFunction).
//
// Replaces no TPU kernel: JAX differentiates the XLA composition, and the
// port ran the composition's autograd (ops/cuda/project.py:
// project_view_backward_plain writes the same chain rule out in PyTorch,
// in this kernel's order). The gradient enters the projection only through
// the table (the UT's outputs feed the binning, which carries none), and
// each record depends on its row's parameters alone, so this is one map
// over the rows with no reduction: a = M (o - p) (p in the general mode),
// M = diag(1/s) R(q / |q|)^T, the density, and rgb = max(SH(dir) . coeffs
// + 0.5, 0) with dir = (p - o) / max(|p - o|, 1e-12) from the start pose's
// sensor o. Nothing depends on the camera model or the shutter. Rows whose
// cotangent is 0 (past n_active, or touched by no pixel) get exact zeros,
// as do the SH coefficients past the active degree; the clamp passes its
// gradient at 0, as torch.clamp's.
//
// Bound on this card: memory. A row reads 236 B of parameters at SH degree
// 3 and 64 B of cotangent, and writes 236 B of gradients: 536 B, 0.37 ms
// at 3.35 TB/s for 2,300,160 rows, against ~700 fp32 operations a row
// (~0.02 ms at 67 TFLOP/s; chip_smoke.py:PROJECT_BWD_FLOPS).
// Design: P's layout. One thread a row, kRows rows a block; the block
// stages its contiguous slices of the six inputs and of the cotangent in
// shared memory with 16-byte cp.async copies, all in flight before any
// thread computes; each thread writes its row's gradients over its row's
// inputs in shared memory, and the block stores each gradient's slice back
// as coalesced float4 stores, where a thread's own stores would stride 180
// bytes. A gradient nobody asked for (a frozen parameter) is neither
// computed into memory nor stored. Templated on the SH degree, so the
// basis and its derivative unroll. Built as P is, without FMA contraction
// and with precise division, expf and sqrtf.
namespace {

constexpr int kBwdStageFloats = (3 + 4 + 3 + 1 + 3 + kMaxSpec + 16) * kRows;

// the order of project_bwd_launch's arrays (ops/cuda/project.py mirrors it)
// 6 inputs, d_table, 6 gradients, t_start, q_start
constexpr int kNumBwdPtrs = 15;
constexpr int kNumBwdInts = 6;

struct BwdParams {
  int n, sh_degree, sh_stride, scale_act, density_act, shared;
};

static_assert(sizeof(BwdParams) == kNumBwdInts * sizeof(int),
              "BwdParams: kNumBwdInts ints");

// the gradients, in the inputs' layouts; null where none is wanted
struct Grads {
  float *pos, *rot, *scale, *dens, *albedo, *spec;
};

// g d activate(x) / dx from the activated value y (torch's exp and sigmoid
// backward: g y and g (1 - y) y)
__device__ __forceinline__ float activate_grad(float g, float y, int act) {
  if (act == kExp) return g * y;
  if (act == kSigmoid) return g * (1.0f - y) * y;
  return g;
}

// the unit direction's cotangent from d(sum_k gb[k] basis_k) at (x, y, z),
// k < (kDeg + 1)^2 (the derivative of sh_basis, term by term)
template <int kDeg>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z,
                                             const float* gb, float* gd) {
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (kDeg >= 1) {
    const float c1 = 0.4886025119029199f;
    gy = gy - c1 * gb[1];
    gz = gz + c1 * gb[2];
    gx = gx - c1 * gb[3];
  }
  if (kDeg >= 2) {
    float t = 1.0925484305920792f * gb[4];
    gx = gx + t * y;
    gy = gy + t * x;
    t = -1.0925484305920792f * gb[5];
    gy = gy + t * z;
    gz = gz + t * y;
    t = 0.31539156525252005f * gb[6];
    gx = gx - t * (2.0f * x);
    gy = gy - t * (2.0f * y);
    gz = gz + t * (4.0f * z);
    t = -1.0925484305920792f * gb[7];
    gx = gx + t * z;
    gz = gz + t * x;
    t = 0.5462742152960396f * gb[8];
    gx = gx + t * (2.0f * x);
    gy = gy - t * (2.0f * y);
  }
  if (kDeg >= 3) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    float t = -0.5900435899266435f * gb[9];
    gx = gx + t * (6.0f * xy);
    gy = gy + t * (3.0f * xx - 3.0f * yy);
    t = 2.890611442640554f * gb[10];
    gx = gx + t * yz;
    gy = gy + t * xz;
    gz = gz + t * xy;
    t = -0.4570457994644658f * gb[11];
    gx = gx - t * (2.0f * xy);
    gy = gy + t * (4.0f * zz - xx - 3.0f * yy);
    gz = gz + t * (8.0f * yz);
    t = 0.3731763325901154f * gb[12];
    gx = gx - t * (6.0f * xz);
    gy = gy - t * (6.0f * yz);
    gz = gz + t * (6.0f * zz - 3.0f * xx - 3.0f * yy);
    t = -0.4570457994644658f * gb[13];
    gx = gx + t * (4.0f * zz - 3.0f * xx - yy);
    gy = gy - t * (2.0f * xy);
    gz = gz + t * (8.0f * xz);
    t = 1.445305721320277f * gb[14];
    gx = gx + t * (2.0f * xz);
    gy = gy - t * (2.0f * yz);
    gz = gz + t * (xx - yy);
    t = -0.5900435899266435f * gb[15];
    gx = gx + t * (3.0f * xx - 3.0f * yy);
    gy = gy - t * (6.0f * xy);
  }
  gd[0] = gx;
  gd[1] = gy;
  gd[2] = gz;
}

// the cotangent of u / max(|u|, 1e-12) to u, from the unit vector v, the
// clamped norm ns, the norm n and the output's cotangent g (n of them);
// torch's clamp passes the norm's gradient where n >= 1e-12
template <int kN>
__device__ __forceinline__ void normalize_vjp(const float* v, float ns,
                                              float n, float* g) {
  float vg = v[0] * g[0];
  for (int i = 1; i < kN; ++i) vg = vg + v[i] * g[i];
  if (n < 1e-12f) vg = 0.f;
  for (int i = 0; i < kN; ++i) g[i] = (g[i] - v[i] * vg) / ns;
}

template <int kDeg>
__global__ void __launch_bounds__(kRows)
project_bwd_kernel(Inputs in, const float* d_table, Grads out,
                   const float* t_start, const float* q_start, BwdParams p) {
  constexpr int kNb = (kDeg + 1) * (kDeg + 1);
  __shared__ __align__(16) float s_buf[kBwdStageFloats];
  __shared__ float s_o[3];

  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, p.n - r0);
  const int stride = p.sh_stride;
  float* s_pos = s_buf;
  float* s_rot = s_pos + 3 * kRows;
  float* s_scale = s_rot + 4 * kRows;
  float* s_dens = s_scale + 3 * kRows;
  float* s_alb = s_dens + kRows;
  float* s_spec = s_alb + 3 * kRows;
  float* s_dt = s_spec + kMaxSpec * kRows;

  // 1. every copy of the block's rows in flight, then the sensor position
  stage_in(s_pos, in.pos + 3 * static_cast<int64_t>(r0), 3 * nr);
  stage_in(s_rot, in.rot + 4 * static_cast<int64_t>(r0), 4 * nr);
  stage_in(s_scale, in.scale + 3 * static_cast<int64_t>(r0), 3 * nr);
  stage_in(s_dens, in.dens + r0, nr);
  stage_in(s_alb, in.albedo + 3 * static_cast<int64_t>(r0), 3 * nr);
  if (kDeg > 0) {
    stage_in(s_spec, in.spec + stride * static_cast<int64_t>(r0),
             stride * nr);
  }
  stage_in(s_dt, d_table + 16 * static_cast<int64_t>(r0), 16 * nr);
  asm volatile("cp.async.commit_group;\n" ::);
  if (t == 0) {
    // ops/ut.py:sensor_position, as kernel P's derive_camera: -(R^T t)
    float r[9];
    rotmat(q_start[0], q_start[1], q_start[2], q_start[3], r);
    for (int i = 0; i < 3; ++i) {
      s_o[i] = -(r[i] * t_start[0] + r[3 + i] * t_start[1] +
                 r[6 + i] * t_start[2]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // 2. one row a thread; its gradients over its inputs in shared memory
  if (t < nr) {
    float g[16];
    const float4* g4 = reinterpret_cast<const float4*>(s_dt + 16 * t);
    bool zero = true;
    for (int i = 0; i < 4; ++i) {
      const float4 v = g4[i];
      g[4 * i] = v.x;
      g[4 * i + 1] = v.y;
      g[4 * i + 2] = v.z;
      g[4 * i + 3] = v.w;
      zero = zero && v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f;
    }
    float* spec = s_spec + stride * t;
    float gp[3] = {0.f, 0.f, 0.f}, gq[4] = {0.f, 0.f, 0.f, 0.f};
    float gs[3] = {0.f, 0.f, 0.f}, ga[3] = {0.f, 0.f, 0.f}, gd = 0.f;
    if (!zero) {
      const float pw[3] = {s_pos[3 * t], s_pos[3 * t + 1], s_pos[3 * t + 2]};

      // the radiance: rgb = max(SH(dir) . coeffs + 0.5, 0)
      const float sr[3] = {pw[0] - s_o[0], pw[1] - s_o[1], pw[2] - s_o[2]};
      const float dist = sqrtf(sr[0] * sr[0] + sr[1] * sr[1] + sr[2] * sr[2]);
      const float ds = fmaxf(dist, 1e-12f);
      const float v[3] = {sr[0] / ds, sr[1] / ds, sr[2] / ds};
      float basis[16];
      sh_basis(v[0], v[1], v[2], kDeg, basis);
      float gpre[3];
      for (int ch = 0; ch < 3; ++ch) {
        float acc = basis[0] * s_alb[3 * t + ch];
#pragma unroll
        for (int k = 1; k < kNb; ++k) {
          acc = acc + basis[k] * spec[3 * (k - 1) + ch];
        }
        gpre[ch] = acc + 0.5f >= 0.f ? g[13 + ch] : 0.f;
        ga[ch] = basis[0] * gpre[ch];
      }
      // each coefficient's cotangent in its place, and the basis'
      float gb[16];
#pragma unroll
      for (int k = 1; k < kNb; ++k) {
        float* c = spec + 3 * (k - 1);
        gb[k] = c[0] * gpre[0] + c[1] * gpre[1] + c[2] * gpre[2];
        for (int ch = 0; ch < 3; ++ch) c[ch] = basis[k] * gpre[ch];
      }
      sh_basis_vjp<kDeg>(v[0], v[1], v[2], gb, gp);
      normalize_vjp<3>(v, ds, dist, gp);

      // M = diag(1/s) R(q / |q|)^T
      const float4 q4 = reinterpret_cast<const float4*>(s_rot)[t];
      const float q[4] = {q4.x, q4.y, q4.z, q4.w};
      const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                             q[3] * q[3]);
      const float qs = fmaxf(qn, 1e-12f);
      const float qh[4] = {q[0] / qs, q[1] / qs, q[2] / qs, q[3] / qs};
      float r[9];
      rotmat(qh[0], qh[1], qh[2], qh[3], r);
      float s[3], inv[3];
      for (int i = 0; i < 3; ++i) {
        s[i] = activate(s_scale[3 * t + i], p.scale_act);
        inv[i] = 1.0f / s[i];
      }
      // the table's M columns, and a = M (o - p) into M and p
      float gm[9];
      for (int i = 0; i < 9; ++i) gm[i] = g[3 + i];
      if (p.shared) {
        const float d[3] = {s_o[0] - pw[0], s_o[1] - pw[1], s_o[2] - pw[2]};
        for (int i = 0; i < 3; ++i) {
          for (int j = 0; j < 3; ++j) {
            gm[3 * i + j] = gm[3 * i + j] + g[i] * d[j];
          }
        }
        for (int j = 0; j < 3; ++j) {
          gp[j] = gp[j] - (inv[0] * r[3 * j] * g[0] +
                           inv[1] * r[3 * j + 1] * g[1] +
                           inv[2] * r[3 * j + 2] * g[2]);
        }
      } else {
        for (int i = 0; i < 3; ++i) gp[i] = gp[i] + g[i];
      }
      // M[i][j] = inv[i] R[j][i]: to 1/s, then the raw scale; to R, then q
      float gr[9];
      for (int i = 0; i < 3; ++i) {
        const float g_inv = gm[3 * i] * r[i] + gm[3 * i + 1] * r[3 + i] +
                            gm[3 * i + 2] * r[6 + i];
        gs[i] = activate_grad(-g_inv * (inv[i] * inv[i]), s[i], p.scale_act);
        for (int j = 0; j < 3; ++j) gr[3 * j + i] = gm[3 * i + j] * inv[i];
      }
      // ops/quaternion.py:quat_to_rotmat's derivative at (w, x, y, z)
      const float w = qh[0], x = qh[1], y = qh[2], z = qh[3];
      gq[0] = 2.0f * (-z * gr[1] + y * gr[2] + z * gr[3] - x * gr[5] -
                      y * gr[6] + x * gr[7]);
      gq[1] = 2.0f * (y * gr[1] + z * gr[2] + y * gr[3] - 2.0f * x * gr[4] -
                      w * gr[5] + z * gr[6] + w * gr[7] - 2.0f * x * gr[8]);
      gq[2] = 2.0f * (-2.0f * y * gr[0] + x * gr[1] + w * gr[2] + x * gr[3] +
                      z * gr[5] - w * gr[6] + z * gr[7] - 2.0f * y * gr[8]);
      gq[3] = 2.0f * (-2.0f * z * gr[0] - w * gr[1] + x * gr[2] + w * gr[3] -
                      2.0f * z * gr[4] + y * gr[5] + x * gr[6] + y * gr[7]);
      normalize_vjp<4>(qh, qs, qn, gq);

      const float dens = activate(s_dens[t], p.density_act);
      gd = activate_grad(g[12], dens, p.density_act);
    }
    // the coefficients past the active degree, and every one of a zero row
    for (int k = zero ? 0 : 3 * (kNb - 1); k < stride; ++k) spec[k] = 0.f;
    for (int i = 0; i < 3; ++i) {
      s_pos[3 * t + i] = gp[i];
      s_scale[3 * t + i] = gs[i];
      s_alb[3 * t + i] = ga[i];
    }
    reinterpret_cast<float4*>(s_rot)[t] = make_float4(gq[0], gq[1], gq[2],
                                                      gq[3]);
    s_dens[t] = gd;
  }
  __syncthreads();

  // 3. each wanted gradient's slice out by coalesced float4 stores
  if (out.pos) {
    stage_out(out.pos + 3 * static_cast<int64_t>(r0), s_pos, 3 * nr);
  }
  if (out.rot) {
    stage_out(out.rot + 4 * static_cast<int64_t>(r0), s_rot, 4 * nr);
  }
  if (out.scale) {
    stage_out(out.scale + 3 * static_cast<int64_t>(r0), s_scale, 3 * nr);
  }
  if (out.dens) stage_out(out.dens + r0, s_dens, nr);
  if (out.albedo) {
    stage_out(out.albedo + 3 * static_cast<int64_t>(r0), s_alb, 3 * nr);
  }
  if (out.spec) {
    stage_out(out.spec + stride * static_cast<int64_t>(r0), s_spec,
              stride * nr);
  }
}

#define PROJECT_BWD_KERNELS(X) X(0) X(1) X(2) X(3)

}  // namespace

// ptrs: the six inputs as project_launch takes them, d_table [N,16], the
// six gradients in the inputs' shapes (null where none is wanted), then
// the camera's t_start [3] and q_start [4]. ints: BwdParams' fields in
// order. Returns the first CUDA error.
extern "C" int project_bwd_launch(const void* const* ptrs, const int* ints,
                                  void* stream) {
  BwdParams p;
  memcpy(&p, ints, sizeof(p));
  if (p.sh_stride > kMaxSpec || p.sh_degree < 0 || p.sh_degree > 3 ||
      p.sh_stride < 3 * ((p.sh_degree + 1) * (p.sh_degree + 1) - 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto in_ptr = [ptrs](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out_ptr = [ptrs](int i) {
    return static_cast<float*>(const_cast<void*>(ptrs[7 + i]));
  };
  const Inputs in{in_ptr(0), in_ptr(1), in_ptr(2),
                  in_ptr(3), in_ptr(4), in_ptr(5)};
  const Grads out{out_ptr(0), out_ptr(1), out_ptr(2),
                  out_ptr(3), out_ptr(4), out_ptr(5)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.n > 0) {
    const int blocks = (p.n + kRows - 1) / kRows;
#define PROJECT_BWD_CASE(D)                                          \
  if (p.sh_degree == D) {                                            \
    project_bwd_kernel<D><<<blocks, kRows, 0, s>>>(                  \
        in, in_ptr(6), out, in_ptr(13), in_ptr(14), p);              \
  }
    PROJECT_BWD_KERNELS(PROJECT_BWD_CASE)
#undef PROJECT_BWD_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

// As project_attributes, for P_b's four instantiations, SH degrees 0-3.
extern "C" int project_bwd_attributes(int* out) {
#define PROJECT_BWD_FN(D) reinterpret_cast<const void*>(project_bwd_kernel<D>),
  const void* fns[] = {PROJECT_BWD_KERNELS(PROJECT_BWD_FN)};
#undef PROJECT_BWD_FN
  for (int i = 0; i < 4; ++i) {
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
