// What the instance-norm forward and backward kernels share: the block size,
// the packed loads and stores of a thread's VEC neighbouring channels, and the
// fixed-order reduction over the rows of a tile.
//
// Both kernels view x as a contiguous (N, HW, C) array with C fastest and use
// one block of kThreads threads per (sample, channel tile), laid out as
// TX (channel direction) x TY = kThreads / TX (row direction).  Thread (tx, ty)
// owns the VEC channels c0 = (tile * TX + tx) * VEC .. c0 + VEC - 1 and the
// rows ty, ty + TY, ...  VEC is 1 (any C, any alignment) or the number of
// elements in 16 bytes (4 for fp32, 8 for bf16), which needs C % VEC == 0 and
// 16-byte aligned base pointers.  TX is a power of two <= 32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace instance_norm {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

template <>
struct Pack<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// Sum `acc` over the TY threads that share a tx; every thread of the block
// calls this and gets the total of its own tx back in `acc`.  `red` holds
// kThreads * VEC floats.  The TY partial sums of a channel are added by a
// binary tree (stride TY/2, TY/4, ..., 1): the order is fixed, so results are
// reproducible from run to run.
template <int VEC>
__device__ __forceinline__ void reduce_over_rows(float (&acc)[VEC], float* red, int tx_count) {
  const int tid = threadIdx.x;
  const int ty = tid / tx_count;
  const int tx = tid - ty * tx_count;
#pragma unroll
  for (int v = 0; v < VEC; ++v) red[tid * VEC + v] = acc[v];
  __syncthreads();
  for (int s = (kThreads / tx_count) >> 1; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[tid * VEC + v] += red[(tid + s * tx_count) * VEC + v];
    }
    __syncthreads();
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = red[tx * VEC + v];
  __syncthreads();  // `red` is reused by the next reduction
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// What both C entry points refuse: returns false for a geometry the kernels
// do not take.
inline bool geometry_ok(int n, int hw, int c, int affine_stride, int vec, int tx_count) {
  if (n < 1 || hw < 1 || c < 1) return false;
  if (affine_stride != 0 && affine_stride != c) return false;
  if (tx_count < 1 || tx_count > 32 || (tx_count & (tx_count - 1)) != 0) return false;
  if (vec != 1 && c % vec != 0) return false;
  return true;
}

}  // namespace instance_norm
