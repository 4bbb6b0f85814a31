// The row copy of kernels G and H (expand_rows.cu, fill.cu): a block
// writes its slots' rows, each slot's source row index staged in shared
// memory first.
//
// Bound: memory. The block's output is q units a slot (float4s where the
// width is a multiple of 4 and both pointers are 16-byte aligned, else
// floats); each round its threads store kThreads consecutive units, one
// contiguous run, and no index is divided per element. The stores are
// streaming (evict-first), so the output, written once and never read
// here, does not push the gathered rows and the marks out of L2 (20% of
// the pair expansion's time on the H100, PERF.md §6). Values are copied,
// never combined: bit for bit, denormals and NaN payloads included.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace copy_rows_detail {

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// dst[s * q + c] = rows[src[s] * q + c] (zeros for src[s] < 0), s < n_slots:
// the block's threads take consecutive units u = s * q + c, kThreads a
// round, each thread stepping its (s, c) by (kThreads / q, kThreads % q)
// with a carry, so no thread idles and no index is divided in the loop
template <int kThreads, typename T>
__device__ __forceinline__ void copy_units(const T* __restrict__ rows,
                                           const int* src, int n_slots,
                                           int q, T* __restrict__ dst) {
  const int d_slot = kThreads / q;
  const int d_c = kThreads - d_slot * q;
  const int n_units = n_slots * q;  // the launch keeps it below 2^31
  int s = threadIdx.x / q;
  int c = threadIdx.x - s * q;
#pragma unroll 4
  for (int u = threadIdx.x; u < n_units; u += kThreads) {
    const int k = src[s];
    __stcs(dst + u,
           k >= 0 ? rows[static_cast<int64_t>(k) * q + c] : zero<T>());
    s += d_slot;
    c += d_c;
    if (c >= q) {
      c -= q;
      ++s;
    }
  }
}

}  // namespace copy_rows_detail

// Whether the block copy may move float4s: the width a multiple of 4 and
// both arrays 16-byte aligned (then every row and every block's output
// base are too).
inline bool copy_rows_vec(const float* rows, const float* out, int width) {
  return width % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// Whether a block of span slots may copy rows of `width` floats: its
// n_slots * width stays below 2^31.
inline bool copy_rows_width_ok(int width, int span) {
  return width >= 1 && width <= INT_MAX / span;
}

// The block writes n_slots rows of `width` floats to dst, slot s taking
// row src[s] of rows (src in shared memory, -1 for zeros); vec from
// copy_rows_vec. No barrier inside: call it after src is staged.
template <int kThreads>
__device__ __forceinline__ void copy_rows(const float* __restrict__ rows,
                                          const int* src, int n_slots,
                                          int width, bool vec,
                                          float* __restrict__ dst) {
  if (vec) {
    copy_rows_detail::copy_units<kThreads>(
        reinterpret_cast<const float4*>(rows), src, n_slots, width / 4,
        reinterpret_cast<float4*>(dst));
  } else {
    copy_rows_detail::copy_units<kThreads>(rows, src, n_slots, width, dst);
  }
}
