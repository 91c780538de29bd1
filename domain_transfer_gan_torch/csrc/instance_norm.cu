// Fused instance-norm forward (+ per-sample affine, + optional ReLU) for Hopper.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd` of
// domain_transfer_gan_tpu/ops/pallas/instance_norm.py (the forward half of
// `instance_norm_pallas`).  For x viewed as a contiguous (N, HW, C) array, per
// (sample n, channel c):
//
//     mean = sum_hw x / HW
//     var  = sum_hw (x - mean)^2 / HW          (times HW / max(HW-1, 1) if unbiased)
//     rstd = rsqrt(var + eps)
//     y    = (x - mean) * rstd * scale[n, c] + shift[n, c]     (max(y, 0) if relu)
//
// x and y are fp32 or bf16; every sum and the whole epilogue are fp32.  scale
// and shift are fp32, read as scale[n * affine_stride + c]: affine_stride = C
// for per-sample (N, C) maps, 0 for per-channel (C,) parameters; null pointers
// mean no affine.  mean and rstd are (N, C) fp32 and are written out because
// the backward kernel needs them.
//
// What differs from the TPU kernel.  That one holds a whole (samples, HW,
// channel-tile) block in on-chip memory and therefore refuses shapes whose
// block does not fit.  Here a thread block loops over HW, so every HW >= 1 and
// every C >= 1 is served and no size falls back.
//
// Launch geometry (chosen by the Python wrapper, checked below):
//   * grid  = N * ceil(C / (TX * VEC)) blocks, one per (sample, channel tile);
//   * block = 256 threads laid out as TX (channel direction) x TY = 256 / TX
//     (row direction).  Thread (tx, ty) owns VEC neighbouring channels
//     c0 = (tile * TX + tx) * VEC .. c0 + VEC - 1 and the rows ty, ty + TY, ...
//     Neighbouring tx read neighbouring addresses, so a row of the tile is one
//     coalesced segment of TX * VEC * sizeof(T) bytes;
//   * VEC is 1 (any C, any alignment) or the number of elements in 16 bytes
//     (4 for fp32, 8 for bf16), which needs C % VEC == 0 and 16-byte aligned
//     base pointers.  TX is a power of two <= 32.  The wrapper narrows the
//     tile (smaller TX) while the grid would leave most of the 132 SMs idle.
//
// Reduction order: each thread sums its rows in order in a register, then the
// TY partial sums of a channel are added by a binary tree in shared memory
// (stride TY/2, TY/4, ..., 1).  The order is fixed, so results are
// reproducible from run to run.  Pass 1 gives the mean, pass 2 the centered
// sum of squares (the same form as the TPU kernel, not E[x^2] - mean^2),
// pass 3 writes y.
//
// Bound.  The function is memory-bound: ~8 floating-point operations per
// element against 2 * sizeof(T) bytes.  It must read x once and write y once
// (scale, shift, mean, rstd are N * C * 16 bytes, negligible), so the least
// time on an H100 SXM is 2 * N * HW * C * sizeof(T) / 3.35e12 s.  This kernel
// reads x three times; the second and third reads of a tile come mostly from
// the 50 MB L2 (one path-shape activation is at most 16.8 MB).  Keeping the
// tile in shared memory or registers to read it once, TMA loads, and a split
// of HW over a cluster for shapes with few channels are left for later work.

#include "instance_norm_common.cuh"

using namespace instance_norm;

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
instance_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ shift, T* __restrict__ y,
                         float* __restrict__ mean_out, float* __restrict__ rstd_out,
                         int hw, int c, int affine_stride, int tiles, int tx_count,
                         float eps, int unbiased, int relu) {
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
  T* yp = y + sample + c0;

  float acc[VEC];
  float v[VEC];

  // pass 1: mean
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (active) {
#pragma unroll 4
    for (int r = ty; r < hw; r += ty_count) {
      Pack<T, VEC>::load(xp + static_cast<size_t>(r) * c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += v[i];
    }
  }
  reduce_over_rows<VEC>(acc, red, tx_count);
  float mean[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = acc[i] / static_cast<float>(hw);

  // pass 2: centered variance
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (active) {
#pragma unroll 4
    for (int r = ty; r < hw; r += ty_count) {
      Pack<T, VEC>::load(xp + static_cast<size_t>(r) * c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - mean[i];
        acc[i] += d * d;
      }
    }
  }
  reduce_over_rows<VEC>(acc, red, tx_count);

  if (!active) return;  // no barrier follows

  const float correction =
      unbiased ? static_cast<float>(hw) / static_cast<float>(hw > 1 ? hw - 1 : 1) : 1.f;
  float rstd[VEC], a[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float var = acc[i] / static_cast<float>(hw) * correction;
    rstd[i] = rsqrtf(var + eps);
    a[i] = scale ? scale[static_cast<size_t>(n) * affine_stride + c0 + i] : 1.f;
    b[i] = shift ? shift[static_cast<size_t>(n) * affine_stride + c0 + i] : 0.f;
  }
  if (ty == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean_out[static_cast<size_t>(n) * c + c0 + i] = mean[i];
      rstd_out[static_cast<size_t>(n) * c + c0 + i] = rstd[i];
    }
  }

  // pass 3: normalise, affine, ReLU, store
#pragma unroll 4
  for (int r = ty; r < hw; r += ty_count) {
    Pack<T, VEC>::load(xp + static_cast<size_t>(r) * c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float o = (v[i] - mean[i]) * rstd[i];
      o = o * a[i] + b[i];
      v[i] = relu ? fmaxf(o, 0.f) : o;
    }
    Pack<T, VEC>::store(yp + static_cast<size_t>(r) * c, v);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* scale, const void* shift, void* y, void* mean, void* rstd,
           int n, int hw, int c, int affine_stride, int tx_count, float eps, int unbiased,
           int relu, cudaStream_t stream) {
  const int per_tile = tx_count * VEC;
  const int tiles = (c + per_tile - 1) / per_tile;
  const long long blocks = static_cast<long long>(n) * tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  instance_norm_fwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), hw, c, affine_stride, tiles, tx_count, eps, unbiased, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 4 (float32) / 8 (bfloat16).
// tx_count: threads along the channel direction, a power of two in 1..32.
// scale and shift: both null (no affine) or both given, with affine_stride
// 0 (per channel) or c (per sample).
// Launches on `stream`, allocates nothing, does not synchronise.  Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int instance_norm_fwd(const void* x, const void* scale, const void* shift, void* y,
                                 void* mean, void* rstd, int n, int hw, int c, int affine_stride,
                                 int dtype, int vec, int tx_count, float eps, int unbiased, int relu,
                                 void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!geometry_ok(n, hw, c, affine_stride, vec, tx_count)) return invalid;
  if ((scale == nullptr) != (shift == nullptr)) return invalid;
  if (vec != 1 && (!aligned16(x) || !aligned16(y))) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, scale, shift, y, mean, rstd, n, hw, c, affine_stride, tx_count, eps, unbiased, relu, s);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, scale, shift, y, mean, rstd, n, hw, c, affine_stride, tx_count, eps, unbiased, relu, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, scale, shift, y, mean, rstd, n, hw, c, affine_stride, tx_count, eps, unbiased, relu, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, scale, shift, y, mean, rstd, n, hw, c, affine_stride, tx_count, eps, unbiased, relu, s);
  return invalid;
}
