// Fused instance-norm backward (+ per-sample affine, + optional ReLU) for Hopper.
//
// Replaces the TPU kernel `_bwd_kernel` / `_bwd` of
// domain_transfer_gan_tpu/ops/pallas/instance_norm.py (the backward half of
// `instance_norm_pallas`).  The forward is csrc/instance_norm.cu; it saved
// mean and rstd.  For x, dy, dx viewed as contiguous (N, HW, C) arrays, per
// (sample n, channel c), with s = scale[n, c] (1 without affine) and
// t = shift[n, c] (0 without affine):
//
//     xhat   = (x - mean) * rstd
//     dy'    = dy                           (dy where xhat * s + t > 0, else 0, if relu)
//     dshift = sum_hw dy'
//     dscale = sum_hw dy' * xhat
//     dx     = s * rstd * (dy' - dshift / HW - xhat * dscale / D)
//
// with D = HW, or max(HW - 1, 1) if `unbiased` (the forward's own divisor, so
// HW == 1 gives dx = 0 and not a division by zero).
//
// Form.  The TPU kernel takes four sums: dshift, dscale, sum(dxhat) and
// sum(dxhat * centered) with dxhat = dy' * s.  Since s is constant over HW the
// last two are s * dshift and s * dscale / rstd, and its
//     dx = dxhat * rstd - sum(dxhat) * rstd / HW - centered * rstd^3 * sum(dxhat * centered) / D
// collapses to the line above.  This kernel uses the collapsed form: two
// reductions instead of four, and the same value up to rounding.
//
// x, dy and dx are fp32 or bf16; every sum and the whole epilogue are fp32.
// The ReLU mask is recomputed from xhat * s + t > 0 in fp32, as the TPU kernel
// does, not read off a rounded y.  scale and shift are fp32, read as
// scale[n * affine_stride + c]: affine_stride = C for per-sample (N, C) maps,
// 0 for per-channel (C,) parameters; null pointers mean no affine.  dscale
// and dshift are (N, C) fp32, one value per sample: for a per-channel affine
// the caller sums them over N, as the TPU package does outside its kernel.
// Both null means the caller does not want them (no affine).
//
// What differs from the TPU kernel.  That one holds a whole (samples, HW,
// channel-tile) block of x, dy and dx in on-chip memory and refuses shapes
// that do not fit.  Here a thread block loops over HW, so every HW >= 1 and
// every C >= 1 is served and no size falls back.
//
// Launch geometry: the forward's (instance_norm_common.cuh), chosen by the
// same Python function.  grid = N * ceil(C / (TX * VEC)) blocks of 256
// threads, one block per (sample, channel tile).
//
// Reduction order: each thread sums its rows in order in registers, then the
// TY partial sums of a channel are added by a fixed binary tree in shared
// memory, dshift first, then dscale.  No atomics: results repeat run to run.
// Pass 1 reads x and dy and reduces, pass 2 reads both again and writes dx.
//
// Bound.  Memory-bound: ~15 floating-point operations per element against
// 3 * sizeof(T) bytes.  The function must read x and dy once and write dx once
// (mean, rstd, scale, shift, dscale, dshift are N * C * 24 bytes, negligible),
// so the least time on an H100 SXM is 3 * N * HW * C * sizeof(T) / 3.35e12 s.
// This kernel reads x and dy twice; the second read of a tile comes mostly
// from the 50 MB L2.  Keeping the tile on chip to read it once, TMA loads and
// a split of HW over a cluster are left for later work, as for the forward.

#include "instance_norm_common.cuh"

using namespace instance_norm;

namespace {

// The ReLU mask: xhat * s + t > 0 with the product rounded before the sum (no
// fused multiply-add), so that the mask is bit for bit the one a plain fp32
// evaluation of the forward gives.  dx is discontinuous in it: a mask that
// differed on an element within one rounding of zero would move dx there by
// |s * rstd * dy|.
__device__ __forceinline__ bool pre_positive(float xhat, float s, float t) {
  return __fadd_rn(__fmul_rn(xhat, s), t) > 0.f;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                         const float* __restrict__ scale, const float* __restrict__ shift,
                         T* __restrict__ dx, float* __restrict__ dscale_out,
                         float* __restrict__ dshift_out, int hw, int c, int affine_stride,
                         int tiles, int tx_count, int unbiased, int relu) {
  __shared__ float red[kThreads * VEC];

  const int ty_count = kThreads / tx_count;
  const int ty = threadIdx.x / tx_count;
  const int tx = threadIdx.x - ty * tx_count;
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int c0 = (tile * tx_count + tx) * VEC;
  const bool active = c0 < c;  // VEC > 1 implies c % VEC == 0: a pack is whole or absent

  const size_t sample = static_cast<size_t>(n) * hw * c;
  const T* xp = x + sample + c0;
  const T* dyp = dy + sample + c0;
  T* dxp = dx + sample + c0;

  float mean[VEC], rstd[VEC], s[VEC], t[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = 0.f; rstd[i] = 0.f; s[i] = 1.f; t[i] = 0.f;
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] = mean_in[static_cast<size_t>(n) * c + c0 + i];
      rstd[i] = rstd_in[static_cast<size_t>(n) * c + c0 + i];
      if (scale) {
        s[i] = scale[static_cast<size_t>(n) * affine_stride + c0 + i];
        t[i] = shift[static_cast<size_t>(n) * affine_stride + c0 + i];
      }
    }
  }

  float xv[VEC], gv[VEC];
  float sum_g[VEC], sum_gx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) { sum_g[i] = 0.f; sum_gx[i] = 0.f; }

  // pass 1: dshift = sum dy', dscale = sum dy' * xhat
  if (active) {
#pragma unroll 4
    for (int r = ty; r < hw; r += ty_count) {
      Pack<T, VEC>::load(xp + static_cast<size_t>(r) * c, xv);
      Pack<T, VEC>::load(dyp + static_cast<size_t>(r) * c, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = (xv[i] - mean[i]) * rstd[i];
        const float g = (relu && !pre_positive(xhat, s[i], t[i])) ? 0.f : gv[i];
        sum_g[i] += g;
        sum_gx[i] += g * xhat;
      }
    }
  }
  reduce_over_rows<VEC>(sum_g, red, tx_count);
  reduce_over_rows<VEC>(sum_gx, red, tx_count);

  if (!active) return;  // no barrier follows

  if (ty == 0 && dscale_out != nullptr) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dscale_out[static_cast<size_t>(n) * c + c0 + i] = sum_gx[i];
      dshift_out[static_cast<size_t>(n) * c + c0 + i] = sum_g[i];
    }
  }

  const float inv_hw = 1.f / static_cast<float>(hw);
  const float inv_d = unbiased ? 1.f / static_cast<float>(hw > 1 ? hw - 1 : 1) : inv_hw;
  float k[VEC], mg[VEC], mgx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    k[i] = s[i] * rstd[i];
    mg[i] = sum_g[i] * inv_hw;
    mgx[i] = sum_gx[i] * inv_d;
  }

  // pass 2: dx
#pragma unroll 4
  for (int r = ty; r < hw; r += ty_count) {
    Pack<T, VEC>::load(xp + static_cast<size_t>(r) * c, xv);
    Pack<T, VEC>::load(dyp + static_cast<size_t>(r) * c, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xhat = (xv[i] - mean[i]) * rstd[i];
      const float g = (relu && !pre_positive(xhat, s[i], t[i])) ? 0.f : gv[i];
      xv[i] = k[i] * (g - mg[i] - xhat * mgx[i]);
    }
    Pack<T, VEC>::store(dxp + static_cast<size_t>(r) * c, xv);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* dy, const void* mean, const void* rstd, const void* scale,
           const void* shift, void* dx, void* dscale, void* dshift, int n, int hw, int c,
           int affine_stride, int tx_count, int unbiased, int relu, cudaStream_t stream) {
  const int per_tile = tx_count * VEC;
  const int tiles = (c + per_tile - 1) / per_tile;
  const long long blocks = static_cast<long long>(n) * tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  instance_norm_bwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(dx), static_cast<float*>(dscale),
      static_cast<float*>(dshift), hw, c, affine_stride, tiles, tx_count, unbiased, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 4 (float32) / 8 (bfloat16).
// tx_count: threads along the channel direction, a power of two in 1..32.
// scale and shift: both null (no affine) or both given, with affine_stride
// 0 (per channel) or c (per sample).  dscale and dshift: both null or both
// given, (N, C) fp32.
// Launches on `stream`, allocates nothing, does not synchronise.  Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int instance_norm_bwd(const void* x, const void* dy, const void* mean,
                                 const void* rstd, const void* scale, const void* shift,
                                 void* dx, void* dscale, void* dshift, int n, int hw, int c,
                                 int affine_stride, int dtype, int vec, int tx_count,
                                 int unbiased, int relu, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!geometry_ok(n, hw, c, affine_stride, vec, tx_count)) return invalid;
  if (x == nullptr || dy == nullptr || dx == nullptr || mean == nullptr || rstd == nullptr)
    return invalid;
  if ((scale == nullptr) != (shift == nullptr)) return invalid;
  if ((dscale == nullptr) != (dshift == nullptr)) return invalid;
  if (vec != 1 && (!aligned16(x) || !aligned16(dy) || !aligned16(dx))) return invalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, dy, mean, rstd, scale, shift, dx, dscale, dshift, n, hw, c, affine_stride, tx_count, unbiased, relu, st);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, dy, mean, rstd, scale, shift, dx, dscale, dshift, n, hw, c, affine_stride, tx_count, unbiased, relu, st);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, dy, mean, rstd, scale, shift, dx, dscale, dshift, n, hw, c, affine_stride, tx_count, unbiased, relu, st);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, dy, mean, rstd, scale, shift, dx, dscale, dshift, n, hw, c, affine_stride, tx_count, unbiased, relu, st);
  return invalid;
}
