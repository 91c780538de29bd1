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
// Bound.  Memory-bound: ~15 floating-point operations per element against
// 3 * sizeof(T) bytes.  The function must read x and dy once and write dx once
// (mean, rstd, scale, shift, dscale, dshift are N * C * 24 bytes, negligible),
// so the least time on an H100 SXM is 3 * N * HW * C * sizeof(T) / 3.35e12 s.
//
// Three variants, picked per shape by ops/kernels/instance_norm.py::
// cluster_plan as for the forward (instance_norm.cu); a refused launch is an
// error, never a move to another.
//
// 1. On chip (instance_norm_bwd_cluster, the training path's): a cluster of K
//    CTAs per sample holds the sample's x and dy in shared memory, so both
//    are read from device memory exactly once (instance_norm_cluster.cuh:
//    layout, copies, reduction order).  CTA rank k bulk-copies x and dy of
//    its rows in `stages` copies (one mbarrier per stage counts both) and
//      pass 1  sums dy' and dy' * xhat, stage by stage as the copies land;
//      merge   publishes the pair and, after the one cluster barrier, every
//              CTA adds the K pairs in rank order; rank 0 writes dscale and
//              dshift;
//      pass 2  forms dx from shared memory and writes it with 16-byte
//              stores.
//    A cluster of one CTA is an ordinary launch whose barriers are block
//    barriers.  Taken where C * sizeof(T) is a multiple of 16 bytes, the
//    tensors are 16-byte aligned and some K <= 16 fits x and dy into 227 KB
//    per CTA: every shape of the train steps (a float32 (32, 4096, 64) site
//    needs K = 16, 2 MB per sample).
// 2. The ring route, two launches, where no cluster holds x and dy (the
//    256x256 generator sites and the widest 256x256 discriminator sites):
//    instance_norm_bwd_partial_sums_cluster (K2-split's cluster variant,
//    below) over a cluster of K CTAs per sample streams x and dy once
//    through the ring, recomputes the ReLU mask as pre_positive does, and
//    rank 0 writes dshift = sum dy' and dscale = sum dy' * xhat in rank
//    order; then instance_norm_bwd_apply_dx (K2-split's second launch) over
//    a grid of (sample, row chunk, channel tile) blocks reads x and dy again
//    and writes dx from those sums with hw_total = HW.  The two launches
//    move 5 * N * HW * C * sizeof(T) bytes, 1.67x the bound above.  Taken
//    where C * sizeof(T) is a multiple of 16 bytes and the tensors are
//    16-byte aligned.
// 3. Streaming (instance_norm_bwd, the first port of the kernel): one block
//    of 256 threads per (sample, channel tile) loops over HW, with the
//    forward's streaming geometry (instance_norm_common.cuh, chosen by the
//    same Python function); every HW >= 1 and C >= 1 is served.  Pass 1
//    reads x and dy and reduces (each thread in row order, then a fixed
//    binary tree over the TY partials, dshift first, then dscale); pass 2
//    reads both again, mostly from the 50 MB L2, and writes dx.  Taken
//    elsewhere: rows of other widths, unaligned tensors, and the mid-size
//    sites where the card measured it faster than a cluster.
//
// Every variant adds in a fixed order and uses no atomics, so a result
// repeats bit for bit from run to run.

#include "instance_norm_cluster.cuh"
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


// ---------------------------------------------------------------------------
// The on-chip variant (see the head of this file).

namespace {

template <typename T>
__global__ void __launch_bounds__(kClusterThreadsMax)
instance_norm_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                 const float* __restrict__ mean_in,
                                 const float* __restrict__ rstd_in,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ shift, T* __restrict__ dx,
                                 float* __restrict__ dscale_out, float* __restrict__ dshift_out,
                                 int hw, int c, int affine_stride, int k_count, int rows,
                                 int stages, int unbiased, int relu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const ClusterLayout lay = cluster_layout(2, rows, c, sizeof(T), blockDim.x, stages);
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + static_cast<size_t>(rows) * c;
  float* part = reinterpret_cast<float*>(smem + lay.part);  // [2][c]: dshift, dscale
  float* stat = reinterpret_cast<float*>(smem + lay.stat);  // [2][c]
  float* red = reinterpret_cast<float*>(smem + lay.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n = blockIdx.x / k_count;
  const int packs = c / VEC;
  const int ty_count = blockDim.x / packs;
  const int tid = threadIdx.x;
  const int ty = tid / packs;
  const int tx = tid - ty * packs;
  const int c0 = tx * VEC;
  const int first = min(rank * rows, hw);
  const int last = min(first + rows, hw);
  const size_t sample = static_cast<size_t>(n) * hw * c;

  if (tid == 0) {
    const T* const src[2] = {x, dy};
    start_loads<T, 2>(xs, rows * c, src, sample, first, last, c, stages, bars);
  }

  float mean[VEC], rstd[VEC], s[VEC], t[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = mean_in[static_cast<size_t>(n) * c + c0 + i];
    rstd[i] = rstd_in[static_cast<size_t>(n) * c + c0 + i];
    s[i] = scale ? scale[static_cast<size_t>(n) * affine_stride + c0 + i] : 1.f;
    t[i] = scale ? shift[static_cast<size_t>(n) * affine_stride + c0 + i] : 0.f;
  }
  __syncthreads();

  // pass 1: the CTA's dshift (acc[0..VEC)) and dscale (acc[VEC..2 VEC))
  float acc[2 * VEC], xv[VEC], gv[VEC];
#pragma unroll
  for (int i = 0; i < 2 * VEC; ++i) acc[i] = 0.f;
  for (int st = 0; st < stages; ++st) {
    int r0, r1;
    stage_rows(first, last, stages, st, r0, r1);
    if (r1 == r0) continue;
    mbar_wait(&bars[st], 0);
    for (int r = r0 + ty; r < r1; r += ty_count) {
      const size_t off = static_cast<size_t>(r - first) * c + c0;
      Pack<T, VEC>::load(xs + off, xv);
      Pack<T, VEC>::load(gs + off, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = (xv[i] - mean[i]) * rstd[i];
        const float g = (relu && !pre_positive(xhat, s[i], t[i])) ? 0.f : gv[i];
        acc[i] += g;
        acc[VEC + i] += g * xhat;
      }
    }
  }
  tree_over_rows<2 * VEC>(acc, red, packs, ty_count);
  if (ty == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part[c0 + i] = red[tx * 2 * VEC + i];
      part[c + c0 + i] = red[tx * 2 * VEC + VEC + i];
    }
  }
  cluster_sync(k_count);
  if (ty == 0) {
    float sum_g[VEC], sum_gx[VEC];
    cluster_total<VEC>(sum_g, part, c0, k_count);
    cluster_total<VEC>(sum_gx, part, c + c0, k_count);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      stat[c0 + i] = sum_g[i];
      stat[c + c0 + i] = sum_gx[i];
    }
    if (rank == 0 && dscale_out != nullptr) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        dscale_out[static_cast<size_t>(n) * c + c0 + i] = sum_gx[i];
        dshift_out[static_cast<size_t>(n) * c + c0 + i] = sum_g[i];
      }
    }
  }
  // no CTA reads another's shared memory after this point; each waits for
  // the others' arrival only before it exits
  if (k_count > 1) cluster_arrive();
  __syncthreads();

  const float inv_hw = 1.f / static_cast<float>(hw);
  const float inv_d = unbiased ? 1.f / static_cast<float>(hw > 1 ? hw - 1 : 1) : inv_hw;
  float k[VEC], mg[VEC], mgx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    k[i] = s[i] * rstd[i];
    mg[i] = stat[c0 + i] * inv_hw;
    mgx[i] = stat[c + c0 + i] * inv_d;
  }

  // pass 2: dx from the slab in shared memory, 16-byte stores
  T* dxp = dx + sample + c0;
  for (int r = first + ty; r < last; r += ty_count) {
    const size_t off = static_cast<size_t>(r - first) * c + c0;
    Pack<T, VEC>::load(xs + off, xv);
    Pack<T, VEC>::load(gs + off, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xhat = (xv[i] - mean[i]) * rstd[i];
      const float g = (relu && !pre_positive(xhat, s[i], t[i])) ? 0.f : gv[i];
      xv[i] = k[i] * (g - mg[i] - xhat * mgx[i]);
    }
    Pack<T, VEC>::store(dxp + static_cast<size_t>(r) * c, xv);
  }
  if (k_count > 1) cluster_wait();
}

}  // namespace

// The on-chip variant.  dtype: 0 = float32, 1 = bfloat16.  The plan
// (ops/kernels/instance_norm.py::cluster_plan): `cluster` CTAs per sample,
// `rows` rows per CTA, `stages` copies per CTA, `threads` per CTA (a multiple
// of C / VEC), `smem_bytes` of dynamic shared memory, which must equal the
// layout's size.  x, dy and dx 16-byte aligned, C * sizeof(T) a multiple of
// 16.  The other arguments as for instance_norm_bwd.  Launches on `stream`,
// allocates nothing, does not synchronise.  Returns the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for arguments the kernel does
// not take, cudaErrorInvalidConfiguration if no cluster of this shape fits
// the card.
extern "C" int instance_norm_bwd_cluster(const void* x, const void* dy, const void* mean,
                                         const void* rstd, const void* scale, const void* shift,
                                         void* dx, void* dscale, void* dshift, int n, int hw,
                                         int c, int affine_stride, int dtype, int cluster,
                                         int rows, int stages, int threads, int smem_bytes,
                                         int unbiased, int relu, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return invalid;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (!cluster_plan_ok(n, hw, c, affine_stride, itemsize, 2, cluster, rows, stages, threads,
                       smem_bytes))
    return invalid;
  if (x == nullptr || dy == nullptr || dx == nullptr || mean == nullptr || rstd == nullptr)
    return invalid;
  if ((scale == nullptr) != (shift == nullptr)) return invalid;
  if ((dscale == nullptr) != (dshift == nullptr)) return invalid;
  if (!aligned16(x) || !aligned16(dy) || !aligned16(dx)) return invalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = n * cluster;
  if (dtype == 0)
    return launch_cluster(instance_norm_bwd_cluster_kernel<float>, blocks, cluster, threads,
                          smem_bytes, st, static_cast<const float*>(x),
                          static_cast<const float*>(dy), static_cast<const float*>(mean),
                          static_cast<const float*>(rstd), static_cast<const float*>(scale),
                          static_cast<const float*>(shift), static_cast<float*>(dx),
                          static_cast<float*>(dscale), static_cast<float*>(dshift), hw, c,
                          affine_stride, cluster, rows, stages, unbiased, relu);
  return launch_cluster(instance_norm_bwd_cluster_kernel<__nv_bfloat16>, blocks, cluster, threads,
                        smem_bytes, st, static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(mean),
                        static_cast<const float*>(rstd), static_cast<const float*>(scale),
                        static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(dx),
                        static_cast<float*>(dscale), static_cast<float*>(dshift), hw, c,
                        affine_stride, cluster, rows, stages, unbiased, relu);
}


// ---------------------------------------------------------------------------
// K2-split: the backward for an activation whose rows are sliced over ranks
// (see K1-split in instance_norm.cu).  The two sums of the collapsed form
// run over all of a sample's rows, on every rank, so they are formed in two
// launches around a collective:
//
//   instance_norm_bwd_partial_sums  per (n, c) sum dy' and sum dy' * xhat
//                                   over this rank's rows (the ReLU mask
//                                   recomputed as above);
//   (the caller sums them over the ranks)
//   instance_norm_bwd_apply_dx      dx = s * rstd * (dy' - sum_g / HW
//                                   - xhat * sum_gx / D) from the global
//                                   sums, HW the global row count and D = HW
//                                   or max(HW - 1, 1) if unbiased.
//
// dscale and dshift of this rank are its partial sums (the caller sums the
// ranks' parameter gradients).  partial_sums has the geometry and reduction
// order of instance_norm_bwd (its cluster variant is at the end of this
// file); apply_dx is elementwise over the row-chunk grid of K1-split's
// apply (instance_norm.cu) and is also the ring route's second launch.
// Bound: partial_sums must read x and dy once (2 * N * hw * C * sizeof(T)
// bytes); apply_dx reads x, dy and writes dx once (3 * N * hw * C *
// sizeof(T)).

namespace {

template <typename T, int VEC>
__device__ __forceinline__ void load_affine_stats(const float* mean_in, const float* rstd_in,
                                                  const float* scale, const float* shift, int n,
                                                  int c, int c0, int affine_stride,
                                                  float (&mean)[VEC], float (&rstd)[VEC],
                                                  float (&s)[VEC], float (&t)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = mean_in[static_cast<size_t>(n) * c + c0 + i];
    rstd[i] = rstd_in[static_cast<size_t>(n) * c + c0 + i];
    s[i] = scale ? scale[static_cast<size_t>(n) * affine_stride + c0 + i] : 1.f;
    t[i] = shift ? shift[static_cast<size_t>(n) * affine_stride + c0 + i] : 0.f;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_partial_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                      const float* __restrict__ mean_in,
                                      const float* __restrict__ rstd_in,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift,
                                      float* __restrict__ sum_g_out,
                                      float* __restrict__ sum_gx_out, int hw, int c,
                                      int affine_stride, int tiles, int tx_count, int relu) {
  __shared__ float red[kThreads * VEC];

  const int ty_count = kThreads / tx_count;
  const int ty = threadIdx.x / tx_count;
  const int tx = threadIdx.x - ty * tx_count;
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int c0 = (tile * tx_count + tx) * VEC;
  const bool active = c0 < c;
  const size_t sample = static_cast<size_t>(n) * hw * c;
  const T* xp = x + sample + c0;
  const T* dyp = dy + sample + c0;

  float mean[VEC], rstd[VEC], s[VEC], t[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = 0.f; rstd[i] = 0.f; s[i] = 1.f; t[i] = 0.f;
  }
  if (active)
    load_affine_stats<T, VEC>(mean_in, rstd_in, scale, shift, n, c, c0, affine_stride, mean,
                              rstd, s, t);
  float xv[VEC], gv[VEC], sum_g[VEC], sum_gx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) { sum_g[i] = 0.f; sum_gx[i] = 0.f; }
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
  if (active && ty == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sum_g_out[static_cast<size_t>(n) * c + c0 + i] = sum_g[i];
      sum_gx_out[static_cast<size_t>(n) * c + c0 + i] = sum_gx[i];
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_apply_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                  const float* __restrict__ mean_in,
                                  const float* __restrict__ rstd_in,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ shift,
                                  const float* __restrict__ sum_g_in,
                                  const float* __restrict__ sum_gx_in, T* __restrict__ dx,
                                  int hw, int c, int hw_total, int affine_stride, int tiles,
                                  int tx_count, int chunk_rows, int chunks, int unbiased,
                                  int relu) {
  const int ty_count = kThreads / tx_count;
  const int ty = threadIdx.x / tx_count;
  const int tx = threadIdx.x - ty * tx_count;
  // block = (sample, row chunk, channel tile), the tile fastest
  const int tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const int chunk = rest % chunks;
  const int n = rest / chunks;
  const int c0 = (tile * tx_count + tx) * VEC;
  if (c0 >= c) return;  // no barrier in this kernel
  const int r0 = chunk * chunk_rows;
  const int r1 = min(r0 + chunk_rows, hw);
  const size_t sample = static_cast<size_t>(n) * hw * c;
  const T* xp = x + sample + c0;
  const T* dyp = dy + sample + c0;
  T* dxp = dx + sample + c0;

  float mean[VEC], rstd[VEC], s[VEC], t[VEC];
  load_affine_stats<T, VEC>(mean_in, rstd_in, scale, shift, n, c, c0, affine_stride, mean, rstd,
                            s, t);
  const float inv_hw = 1.f / static_cast<float>(hw_total);
  const float inv_d =
      unbiased ? 1.f / static_cast<float>(hw_total > 1 ? hw_total - 1 : 1) : inv_hw;
  float k[VEC], mg[VEC], mgx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    k[i] = s[i] * rstd[i];
    mg[i] = sum_g_in[static_cast<size_t>(n) * c + c0 + i] * inv_hw;
    mgx[i] = sum_gx_in[static_cast<size_t>(n) * c + c0 + i] * inv_d;
  }
  float xv[VEC], gv[VEC];
#pragma unroll 4
  for (int r = r0 + ty; r < r1; r += ty_count) {
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

inline int split_blocks(int n, int c, int per_tile, int& tiles, unsigned& blocks,
                        int chunks = 1) {
  tiles = (c + per_tile - 1) / per_tile;
  const long long b = static_cast<long long>(n) * chunks * tiles;
  if (b > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  blocks = static_cast<unsigned>(b);
  return 0;
}

template <typename T, int VEC>
int launch_partial_sums(const void* x, const void* dy, const void* mean, const void* rstd,
                        const void* scale, const void* shift, void* sum_g, void* sum_gx, int n,
                        int hw, int c, int affine_stride, int tx_count, int relu,
                        cudaStream_t stream) {
  int tiles;
  unsigned blocks;
  const int err = split_blocks(n, c, tx_count * VEC, tiles, blocks);
  if (err) return err;
  instance_norm_bwd_partial_sums_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(sum_g), static_cast<float*>(sum_gx),
      hw, c, affine_stride, tiles, tx_count, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_apply_dx(const void* x, const void* dy, const void* mean, const void* rstd,
                    const void* scale, const void* shift, const void* sum_g, const void* sum_gx,
                    void* dx, int n, int hw, int c, int hw_total, int affine_stride, int tx_count,
                    int chunk_rows, int unbiased, int relu, cudaStream_t stream) {
  int tiles;
  unsigned blocks;
  const int chunks = (hw + chunk_rows - 1) / chunk_rows;
  const int err = split_blocks(n, c, tx_count * VEC, tiles, blocks, chunks);
  if (err) return err;
  instance_norm_bwd_apply_dx_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(sum_g),
      static_cast<const float*>(sum_gx), static_cast<T*>(dx), hw, c, hw_total, affine_stride,
      tiles, tx_count, chunk_rows, chunks, unbiased, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2-split, first launch.  x, dy: this rank's rows, (n, hw, c) fp32 or bf16
// (dtype 0 / 1); mean, rstd: the forward's global statistics, (n, c) fp32;
// scale / shift / affine_stride as for instance_norm_bwd; sum_g, sum_gx:
// (n, c) fp32 outputs.  Launches on `stream`, allocates nothing, does not
// synchronise; returns the cudaError_t of the launch.
extern "C" int instance_norm_bwd_partial_sums(const void* x, const void* dy, const void* mean,
                                              const void* rstd, const void* scale,
                                              const void* shift, void* sum_g, void* sum_gx,
                                              int n, int hw, int c, int affine_stride, int dtype,
                                              int vec, int tx_count, int relu, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!geometry_ok(n, hw, c, affine_stride, vec, tx_count)) return invalid;
  if (x == nullptr || dy == nullptr || mean == nullptr || rstd == nullptr || sum_g == nullptr ||
      sum_gx == nullptr)
    return invalid;
  if ((scale == nullptr) != (shift == nullptr)) return invalid;
  if (vec != 1 && (!aligned16(x) || !aligned16(dy))) return invalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return launch_partial_sums<float, 1>(x, dy, mean, rstd, scale, shift, sum_g, sum_gx, n, hw, c, affine_stride, tx_count, relu, st);
  if (dtype == 0 && vec == 4)
    return launch_partial_sums<float, 4>(x, dy, mean, rstd, scale, shift, sum_g, sum_gx, n, hw, c, affine_stride, tx_count, relu, st);
  if (dtype == 1 && vec == 1)
    return launch_partial_sums<__nv_bfloat16, 1>(x, dy, mean, rstd, scale, shift, sum_g, sum_gx, n, hw, c, affine_stride, tx_count, relu, st);
  if (dtype == 1 && vec == 8)
    return launch_partial_sums<__nv_bfloat16, 8>(x, dy, mean, rstd, scale, shift, sum_g, sum_gx, n, hw, c, affine_stride, tx_count, relu, st);
  return invalid;
}

// K2-split, second launch, and the second launch of K2's ring route: dx from
// the global sums (n, c) fp32 and the global row count hw_total of a sample
// (hw_total = hw on the ring route).  A block owns `chunk_rows` rows (>= 1;
// hw: the whole slice) of one sample and one channel tile.  Same
// conventions as above.
extern "C" int instance_norm_bwd_apply_dx(const void* x, const void* dy, const void* mean,
                                          const void* rstd, const void* scale, const void* shift,
                                          const void* sum_g, const void* sum_gx, void* dx, int n,
                                          int hw, int c, int hw_total, int affine_stride,
                                          int dtype, int vec, int tx_count, int chunk_rows,
                                          int unbiased, int relu, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!geometry_ok(n, hw, c, affine_stride, vec, tx_count) || hw_total < hw || chunk_rows < 1)
    return invalid;
  if (x == nullptr || dy == nullptr || dx == nullptr || mean == nullptr || rstd == nullptr ||
      sum_g == nullptr || sum_gx == nullptr)
    return invalid;
  if ((scale == nullptr) != (shift == nullptr)) return invalid;
  if (vec != 1 && (!aligned16(x) || !aligned16(dy) || !aligned16(dx))) return invalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return launch_apply_dx<float, 1>(x, dy, mean, rstd, scale, shift, sum_g, sum_gx, dx, n, hw, c, hw_total, affine_stride, tx_count, chunk_rows, unbiased, relu, st);
  if (dtype == 0 && vec == 4)
    return launch_apply_dx<float, 4>(x, dy, mean, rstd, scale, shift, sum_g, sum_gx, dx, n, hw, c, hw_total, affine_stride, tx_count, chunk_rows, unbiased, relu, st);
  if (dtype == 1 && vec == 1)
    return launch_apply_dx<__nv_bfloat16, 1>(x, dy, mean, rstd, scale, shift, sum_g, sum_gx, dx, n, hw, c, hw_total, affine_stride, tx_count, chunk_rows, unbiased, relu, st);
  if (dtype == 1 && vec == 8)
    return launch_apply_dx<__nv_bfloat16, 8>(x, dy, mean, rstd, scale, shift, sum_g, sum_gx, dx, n, hw, c, hw_total, affine_stride, tx_count, chunk_rows, unbiased, relu, st);
  return invalid;
}


// ---------------------------------------------------------------------------
// K2-split's first launch, cluster variant (instance_norm_bwd_partial_sums_
// cluster): the same sums as instance_norm_bwd_partial_sums (the ReLU mask
// recomputed from xhat, s and t, then plain sums of dy' and dy' * xhat), with
// the work split of K1-split's cluster variant (instance_norm.cu): a
// sample's rows on this rank over a cluster of K CTAs, each streaming whole
// rows of x and dy together through the ring of instance_norm_cluster.cuh
// (one mbarrier per slot counts both), so both are read from device memory
// once.  Reduction order, fixed (no atomics): in-thread in row order; across
// the CTA's threads by tree_over_rows; across the cluster by rank 0, which
// adds the K CTAs' sums (each stored into its shared memory over DSMEM) in
// rank order 0..K-1 and writes them.

namespace {

template <typename T>
__global__ void __launch_bounds__(kRingThreadsMax)
instance_norm_bwd_partial_sums_cluster_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, const float* __restrict__ scale,
    const float* __restrict__ shift, float* __restrict__ sum_g_out,
    float* __restrict__ sum_gx_out, int hw, int c, int affine_stride, int k_count, int rows,
    int stages, int stage_rows, int relu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const RingLayout lay =
      ring_layout(2, stage_rows, c, sizeof(T), blockDim.x, stages, k_count);
  float* part = reinterpret_cast<float*>(smem + lay.part);  // [K][3][c]: sum_g, sum_gx, -
  float* red = reinterpret_cast<float*>(smem + lay.red);

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n = blockIdx.x / k_count;
  const int packs = c / VEC;
  const int ty_count = blockDim.x / packs;
  const int tid = threadIdx.x;
  const int ty = tid / packs;
  const int tx = tid - ty * packs;
  const int c0 = tx * VEC;
  const size_t sample = static_cast<size_t>(n) * hw * c;

  Ring<T, 2> ring;
  ring.slots = reinterpret_cast<T*>(smem);
  ring.bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  ring.src[0] = x + sample;
  ring.src[1] = dy + sample;
  ring.first = min(rank * rows, hw);
  ring.last = min(ring.first + rows, hw);
  ring.c = c;
  ring.stage_rows = stage_rows;
  ring.stages = stages;
  if (k_count > 1) cluster_arrive_relaxed();
  if (tid == 0) ring.start();

  float mean[VEC], rstd[VEC], s[VEC], t[VEC];
  load_affine_stats<T, VEC>(mean_in, rstd_in, scale, shift, n, c, c0, affine_stride, mean, rstd,
                            s, t);
  __syncthreads();

  // acc: sum dy' [0, VEC), sum dy' * xhat [VEC, 2 VEC)
  float acc[2 * VEC], xv[VEC], gv[VEC];
#pragma unroll
  for (int i = 0; i < 2 * VEC; ++i) acc[i] = 0.f;
  const int chunks = ring.chunks();
  for (int ch = 0; ch < chunks; ++ch) {
    ring.wait(ch);
    const T* xs = ring.chunk(ch, 0) + c0;
    const T* gs = ring.chunk(ch, 1) + c0;
    const int in_chunk = ring.rows_of(ch);
#pragma unroll 4
    for (int r = ty; r < in_chunk; r += ty_count) {
      Pack<T, VEC>::load(xs + static_cast<size_t>(r) * c, xv);
      Pack<T, VEC>::load(gs + static_cast<size_t>(r) * c, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = (xv[i] - mean[i]) * rstd[i];
        const float g = (relu && !pre_positive(xhat, s[i], t[i])) ? 0.f : gv[i];
        acc[i] += g;
        acc[VEC + i] += g * xhat;
      }
    }
    ring.release(ch);
  }
  tree_over_rows<2 * VEC>(acc, red, packs, ty_count);
  publish_to_rank0<2 * VEC, VEC>(red, part, rank, c, c0, tx, ty, k_count);
  cluster_sync(k_count);
  if (rank == 0 && ty == 0) {
    float sum_g[VEC], sum_gx[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum_g[i] = sum_gx[i] = 0.f;
    for (int k = 0; k < k_count; ++k) {
      add_f4<VEC>(sum_g, part + k * 3 * c + c0);
      add_f4<VEC>(sum_gx, part + k * 3 * c + c + c0);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sum_g_out[static_cast<size_t>(n) * c + c0 + i] = sum_g[i];
      sum_gx_out[static_cast<size_t>(n) * c + c0 + i] = sum_gx[i];
    }
  }
}

}  // namespace

// K2-split, first launch, cluster variant.  x, dy: this rank's rows,
// (n, hw, c) fp32 or bf16 (dtype 0 / 1), 16-byte aligned, C * sizeof(T) a
// multiple of 16; mean, rstd, scale / shift / affine_stride, sum_g, sum_gx
// as for instance_norm_bwd_partial_sums; the plan (cluster, rows, stages,
// stage_rows, threads, smem_bytes) as for
// instance_norm_partial_stats_cluster.  Launches on `stream`, allocates
// nothing, does not synchronise; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take,
// cudaErrorInvalidConfiguration if no cluster of this shape fits the card).
extern "C" int instance_norm_bwd_partial_sums_cluster(
    const void* x, const void* dy, const void* mean, const void* rstd, const void* scale,
    const void* shift, void* sum_g, void* sum_gx, int n, int hw, int c, int affine_stride,
    int dtype, int cluster, int rows, int stages, int stage_rows, int threads, int smem_bytes,
    int relu, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return invalid;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (!ring_plan_ok(n, hw, c, itemsize, 2, cluster, rows, stages, stage_rows, threads,
                    smem_bytes))
    return invalid;
  if (affine_stride != 0 && affine_stride != c) return invalid;
  if (x == nullptr || dy == nullptr || mean == nullptr || rstd == nullptr || sum_g == nullptr ||
      sum_gx == nullptr)
    return invalid;
  if ((scale == nullptr) != (shift == nullptr)) return invalid;
  if (!aligned16(x) || !aligned16(dy)) return invalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = n * cluster;
  if (dtype == 0)
    return launch_cluster(instance_norm_bwd_partial_sums_cluster_kernel<float>, blocks, cluster,
                          threads, smem_bytes, st, static_cast<const float*>(x),
                          static_cast<const float*>(dy), static_cast<const float*>(mean),
                          static_cast<const float*>(rstd), static_cast<const float*>(scale),
                          static_cast<const float*>(shift), static_cast<float*>(sum_g),
                          static_cast<float*>(sum_gx), hw, c, affine_stride, cluster, rows,
                          stages, stage_rows, relu);
  return launch_cluster(instance_norm_bwd_partial_sums_cluster_kernel<__nv_bfloat16>, blocks,
                        cluster, threads, smem_bytes, st, static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(mean),
                        static_cast<const float*>(rstd), static_cast<const float*>(scale),
                        static_cast<const float*>(shift), static_cast<float*>(sum_g),
                        static_cast<float*>(sum_gx), hw, c, affine_stride, cluster, rows, stages,
                        stage_rows, relu);
}
