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
// the backward kernel needs them.  The variance is the centered one (as the
// TPU kernel's, never E[x^2] - mean^2).
//
// Bound.  The function is memory-bound: ~8 floating-point operations per
// element against 2 * sizeof(T) bytes.  It must read x once and write y once
// (scale, shift, mean, rstd are N * C * 16 bytes, negligible), so the least
// time on an H100 SXM is 2 * N * HW * C * sizeof(T) / 3.35e12 s.
//
// Three variants; ops/kernels/instance_norm.py::cluster_plan picks one per
// shape, and a refused launch is an error, never a move to another.
//
// 1. On chip (instance_norm_fwd_cluster, the main path's): a cluster of K
//    CTAs per sample holds the sample's slab in shared memory, so x is read
//    from device memory exactly once and y is written from shared memory
//    (instance_norm_cluster.cuh: layout, copies, reduction order).  CTA rank
//    k bulk-copies its rows [k * rows, min((k + 1) * rows, HW)) in `stages`
//    copies and
//      pass 1  sums them, stage by stage as the copies land;
//      pass 2  sums (x - m_k)^2 about its own mean m_k, from shared memory;
//      merge   publishes (sum_k, M2_k, m_k) and, after the one cluster
//              barrier, every CTA adds the K sums in rank order (the mean)
//              and M2 = sum_k M2_k + n_k (m_k - mean)^2 in rank order (Chan
//              et al.'s merge: the centered sum of squares about the
//              sample's mean, with one exchange instead of two);
//      pass 3  normalises from shared memory and writes y with 16-byte
//              stores (bulk stores from shared memory measured slower).
//    A cluster of one CTA is an ordinary launch whose barriers are block
//    barriers.  Taken where C * sizeof(T) is a multiple of 16 bytes, the
//    tensors are 16-byte aligned and some K <= 16 fits the slab into 227 KB
//    per CTA: every shape of the serving path and of the train steps.
// 2. The ring route, two launches, where no cluster holds the slab (the
//    256x256 generator sites, 1-16 MB of x per sample, and the widest
//    256x256 discriminator sites): instance_norm_ring_stats, the ring of
//    K1-split's cluster variant (below) over a cluster of K CTAs per sample,
//    reads x once and merges by Chan's rule in rank order, and rank 0's
//    finalizing epilogue writes mean and rstd; then instance_norm_apply
//    (K1-split's second launch, below) over a grid of (sample, row chunk,
//    channel tile) blocks reads x again and writes y.  Bound as above; the
//    two launches move 3 * N * HW * C * sizeof(T) bytes, 1.5x it.  Taken
//    where C * sizeof(T) is a multiple of 16 bytes and the tensors are
//    16-byte aligned.
// 3. Streaming (instance_norm_fwd, the first port of the kernel): one block
//    per (sample, channel tile) loops over HW, so every HW >= 1 and C >= 1 is
//    served.  It reads x three times (mean, centered variance, output; the
//    second and third reads mostly from the 50 MB L2).  Taken elsewhere:
//    rows of other widths and unaligned tensors, and at the mid-size
//    discriminator sites where the card measured it faster than a cluster.
//      * grid  = N * ceil(C / (TX * VEC)) blocks, one per (sample, channel
//        tile);
//      * block = 256 threads laid out as TX (channel direction) x TY = 256 /
//        TX (row direction).  Thread (tx, ty) owns VEC neighbouring channels
//        c0 = (tile * TX + tx) * VEC .. c0 + VEC - 1 and the rows ty, ty + TY,
//        ...  Neighbouring tx read neighbouring addresses, so a row of the
//        tile is one coalesced segment of TX * VEC * sizeof(T) bytes;
//      * VEC is 1 (any C, any alignment) or the number of elements in 16
//        bytes (4 for fp32, 8 for bf16), which needs C % VEC == 0 and 16-byte
//        aligned base pointers.  TX is a power of two <= 32; the wrapper
//        narrows the tile (smaller TX) while the grid would leave most of the
//        132 SMs idle (launch_geometry).
//      * reduction order: each thread sums its rows in order in a register,
//        then the TY partial sums of a channel are added by a binary tree in
//        shared memory (stride TY/2, TY/4, ..., 1).  Pass 1 gives the mean,
//        pass 2 the centered sum of squares, pass 3 writes y.
//
// Every variant adds in a fixed order and uses no atomics, so a result
// repeats bit for bit from run to run.

#include "instance_norm_cluster.cuh"
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


// ---------------------------------------------------------------------------
// The on-chip variant (see the head of this file).

namespace {

template <typename T>
__global__ void __launch_bounds__(kClusterThreadsMax)
instance_norm_fwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                 const float* __restrict__ shift, T* __restrict__ y,
                                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                                 int hw, int c, int affine_stride, int k_count, int rows,
                                 int stages, float eps, int unbiased, int relu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const ClusterLayout lay = cluster_layout(1, rows, c, sizeof(T), blockDim.x, stages);
  T* slab = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(smem + lay.part);  // [3][c]: sum, M2, mean of the CTA
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
    const T* const src[1] = {x};
    start_loads<T, 1>(slab, 0, src, sample, first, last, c, stages, bars);
  }
  __syncthreads();

  // pass 1: the CTA's sums, stage by stage as the copies land
  float acc[VEC], v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int s = 0; s < stages; ++s) {
    int r0, r1;
    stage_rows(first, last, stages, s, r0, r1);
    if (r1 == r0) continue;
    mbar_wait(&bars[s], 0);
    for (int r = r0 + ty; r < r1; r += ty_count) {
      Pack<T, VEC>::load(slab + static_cast<size_t>(r - first) * c + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += v[i];
    }
  }
  tree_over_rows<VEC>(acc, red, packs, ty_count);
  const int own = last - first;
  float sum[VEC] = {};
  if (ty == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sum[i] = red[tx * VEC + i];
      stat[c0 + i] = own > 0 ? sum[i] / static_cast<float>(own) : 0.f;
    }
  }
  __syncthreads();
  float local_mean[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) local_mean[i] = stat[c0 + i];

  // pass 2: the CTA's centered sum of squares, about its own mean
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int r = first + ty; r < last; r += ty_count) {
    Pack<T, VEC>::load(slab + static_cast<size_t>(r - first) * c + c0, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = v[i] - local_mean[i];
      acc[i] += d * d;
    }
  }
  tree_over_rows<VEC>(acc, red, packs, ty_count);  // its first barrier orders the reads of stat
  if (ty == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part[c0 + i] = sum[i];
      part[c + c0 + i] = red[tx * VEC + i];
      part[2 * c + c0 + i] = local_mean[i];
    }
  }

  // the one exchange: every CTA merges the K (sum, M2) pairs in rank order,
  // M2 = sum_k M2_k + n_k (mean_k - mean)^2 (Chan et al.), the centered sum
  // of squares about the sample's mean
  cluster_sync(k_count);
  if (ty == 0) {
    float mean[VEC], m2[VEC];
    cluster_total<VEC>(mean, part, c0, k_count);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] /= static_cast<float>(hw);
      m2[i] = 0.f;
    }
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll 4
    for (int k = 0; k < k_count; ++k) {
      const float nk = static_cast<float>(rows_of_rank(k, rows, hw));
      const float* pk = k_count == 1 ? part : cluster.map_shared_rank(part, k);
      float qk[VEC], mk[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) qk[i] = mk[i] = 0.f;
      add_f4<VEC>(qk, pk + c + c0);
      add_f4<VEC>(mk, pk + 2 * c + c0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = mk[i] - mean[i];
        m2[i] += qk[i] + nk * d * d;  // an empty CTA adds 0 + 0 * d * d
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      stat[c0 + i] = mean[i];
      stat[c + c0 + i] = m2[i];
    }
  }
  // no CTA reads another's shared memory after this point; each waits for
  // the others' arrival only before it exits
  if (k_count > 1) cluster_arrive();
  __syncthreads();

  const float correction =
      unbiased ? static_cast<float>(hw) / static_cast<float>(hw > 1 ? hw - 1 : 1) : 1.f;
  float mean[VEC], rstd[VEC], a[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = stat[c0 + i];
    const float var = stat[c + c0 + i] / static_cast<float>(hw) * correction;
    rstd[i] = rsqrtf(var + eps);
    a[i] = scale ? scale[static_cast<size_t>(n) * affine_stride + c0 + i] : 1.f;
    b[i] = shift ? shift[static_cast<size_t>(n) * affine_stride + c0 + i] : 0.f;
  }
  if (rank == 0 && ty == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean_out[static_cast<size_t>(n) * c + c0 + i] = mean[i];
      rstd_out[static_cast<size_t>(n) * c + c0 + i] = rstd[i];
    }
  }

  // pass 3: normalise, affine, ReLU, 16-byte stores straight to y
  T* yp = y + sample + c0;
  for (int r = first + ty; r < last; r += ty_count) {
    Pack<T, VEC>::load(slab + static_cast<size_t>(r - first) * c + c0, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float o = (v[i] - mean[i]) * rstd[i];
      o = o * a[i] + b[i];
      v[i] = relu ? fmaxf(o, 0.f) : o;
    }
    Pack<T, VEC>::store(yp + static_cast<size_t>(r) * c, v);
  }
  if (k_count > 1) cluster_wait();
}

}  // namespace

// The on-chip variant.  dtype: 0 = float32, 1 = bfloat16.  The plan
// (ops/kernels/instance_norm.py::cluster_plan): `cluster` CTAs per sample
// (1, 2, 4, 8 or 16), `rows` rows per CTA, `stages` copies per CTA,
// `threads` per CTA (a multiple of C / VEC), `smem_bytes` of dynamic shared
// memory, which must equal the layout's size.  x and y 16-byte aligned,
// C * sizeof(T) a multiple of 16.  scale, shift, affine_stride as for
// instance_norm_fwd.  Launches on `stream`, allocates nothing, does not
// synchronise.  Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for arguments the kernel does not take,
// cudaErrorInvalidConfiguration if no cluster of this shape fits the card.
extern "C" int instance_norm_fwd_cluster(const void* x, const void* scale, const void* shift,
                                         void* y, void* mean, void* rstd, int n, int hw, int c,
                                         int affine_stride, int dtype, int cluster, int rows,
                                         int stages, int threads, int smem_bytes, float eps,
                                         int unbiased, int relu, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return invalid;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (!cluster_plan_ok(n, hw, c, affine_stride, itemsize, 1, cluster, rows, stages, threads,
                       smem_bytes))
    return invalid;
  if (x == nullptr || y == nullptr || mean == nullptr || rstd == nullptr) return invalid;
  if ((scale == nullptr) != (shift == nullptr)) return invalid;
  if (!aligned16(x) || !aligned16(y)) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n * cluster;
  if (dtype == 0)
    return launch_cluster(instance_norm_fwd_cluster_kernel<float>, blocks, cluster, threads,
                          smem_bytes, s, static_cast<const float*>(x),
                          static_cast<const float*>(scale), static_cast<const float*>(shift),
                          static_cast<float*>(y), static_cast<float*>(mean),
                          static_cast<float*>(rstd), hw, c, affine_stride, cluster, rows, stages,
                          eps, unbiased, relu);
  return launch_cluster(instance_norm_fwd_cluster_kernel<__nv_bfloat16>, blocks, cluster, threads,
                        smem_bytes, s, static_cast<const __nv_bfloat16*>(x),
                        static_cast<const float*>(scale), static_cast<const float*>(shift),
                        static_cast<__nv_bfloat16*>(y), static_cast<float*>(mean),
                        static_cast<float*>(rstd), hw, c, affine_stride, cluster, rows, stages,
                        eps, unbiased, relu);
}


// ---------------------------------------------------------------------------
// K1-split: the forward for an activation whose rows are sliced over ranks
// (the space axis of --spatial).  A rank holds rows [r*h, (r+1)*h) of each
// sample; no rank sees a whole (sample, channel) slab, so the statistics are
// formed in two launches around a collective:
//
//   instance_norm_partial_stats  per (n, c) the mean and the centered sum of
//                                squares M2 of this rank's rows (count = hw);
//   (the caller gathers the ranks' (mean, M2) and merges them by Chan et
//    al.'s rule in rank order: the global mean and the global M2 about it,
//    the centered variance the unsplit kernel takes, never E[x^2] - mean^2)
//   instance_norm_apply          y = (x - mean) * rstd * scale + shift
//                                (max(y, 0) if relu) from the global mean
//                                and rstd.
//
// partial_stats has the geometry of instance_norm_fwd (one block of 256
// threads per (sample, channel tile), rows strided over TY, the same
// fixed-order reduction), so a result repeats bit for bit; its cluster
// variant is at the end of this file.  apply is elementwise over a grid of
// (sample, row chunk, channel tile) blocks of 256 threads, TX x TY as
// above with TX covering up to 32 channel packs, each block's rows a
// contiguous chunk of `chunk_rows` (ops/kernels/instance_norm.py::
// apply_grid: several waves of blocks on 132 SMs, each thread loading its
// channels' statistics and affine once for 4-32 rows).  It is also the
// ring route's second launch (above).
// Bound: partial_stats must read x once (it reads it twice, the second time
// mostly from L2): N * hw * C * sizeof(T) bytes; apply reads x and writes y
// once: 2 * N * hw * C * sizeof(T) bytes.

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
instance_norm_partial_stats_kernel(const T* __restrict__ x, float* __restrict__ mean_out,
                                   float* __restrict__ m2_out, int hw, int c, int tiles,
                                   int tx_count) {
  __shared__ float red[kThreads * VEC];

  const int ty_count = kThreads / tx_count;
  const int ty = threadIdx.x / tx_count;
  const int tx = threadIdx.x - ty * tx_count;
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int c0 = (tile * tx_count + tx) * VEC;
  const bool active = c0 < c;
  const T* xp = x + static_cast<size_t>(n) * hw * c + c0;

  float acc[VEC], v[VEC];
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
  for (int i = 0; i < VEC; ++i) {
    mean[i] = acc[i] / static_cast<float>(hw);
    acc[i] = 0.f;
  }
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
  if (active && ty == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean_out[static_cast<size_t>(n) * c + c0 + i] = mean[i];
      m2_out[static_cast<size_t>(n) * c + c0 + i] = acc[i];
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
instance_norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in, const float* __restrict__ scale,
                           const float* __restrict__ shift, T* __restrict__ y, int hw, int c,
                           int affine_stride, int tiles, int tx_count, int chunk_rows, int chunks,
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
  T* yp = y + sample + c0;
  float mean[VEC], rstd[VEC], a[VEC], b[VEC], v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = mean_in[static_cast<size_t>(n) * c + c0 + i];
    rstd[i] = rstd_in[static_cast<size_t>(n) * c + c0 + i];
    a[i] = scale ? scale[static_cast<size_t>(n) * affine_stride + c0 + i] : 1.f;
    b[i] = shift ? shift[static_cast<size_t>(n) * affine_stride + c0 + i] : 0.f;
  }
#pragma unroll 4
  for (int r = r0 + ty; r < r1; r += ty_count) {
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
int launch_partial_stats(const void* x, void* mean, void* m2, int n, int hw, int c, int tx_count,
                         cudaStream_t stream) {
  const int per_tile = tx_count * VEC;
  const int tiles = (c + per_tile - 1) / per_tile;
  const long long blocks = static_cast<long long>(n) * tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  instance_norm_partial_stats_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(mean), static_cast<float*>(m2), hw, c, tiles,
      tx_count);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_apply(const void* x, const void* mean, const void* rstd, const void* scale,
                 const void* shift, void* y, int n, int hw, int c, int affine_stride, int tx_count,
                 int chunk_rows, int relu, cudaStream_t stream) {
  const int per_tile = tx_count * VEC;
  const int tiles = (c + per_tile - 1) / per_tile;
  const int chunks = (hw + chunk_rows - 1) / chunk_rows;
  const long long blocks = static_cast<long long>(n) * chunks * tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  instance_norm_apply_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(scale), static_cast<const float*>(shift), static_cast<T*>(y), hw,
      c, affine_stride, tiles, tx_count, chunk_rows, chunks, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1-split, first launch.  x: this rank's rows, (n, hw, c) fp32 or bf16
// (dtype 0 / 1); mean and m2: (n, c) fp32 outputs.  vec and tx_count as for
// instance_norm_fwd.  Launches on `stream`, allocates nothing, does not
// synchronise; returns the cudaError_t of the launch (cudaErrorInvalidValue
// for arguments the kernel does not take).
extern "C" int instance_norm_partial_stats(const void* x, void* mean, void* m2, int n, int hw,
                                           int c, int dtype, int vec, int tx_count,
                                           void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!geometry_ok(n, hw, c, 0, vec, tx_count)) return invalid;
  if (x == nullptr || mean == nullptr || m2 == nullptr) return invalid;
  if (vec != 1 && !aligned16(x)) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1) return launch_partial_stats<float, 1>(x, mean, m2, n, hw, c, tx_count, s);
  if (dtype == 0 && vec == 4) return launch_partial_stats<float, 4>(x, mean, m2, n, hw, c, tx_count, s);
  if (dtype == 1 && vec == 1)
    return launch_partial_stats<__nv_bfloat16, 1>(x, mean, m2, n, hw, c, tx_count, s);
  if (dtype == 1 && vec == 8)
    return launch_partial_stats<__nv_bfloat16, 8>(x, mean, m2, n, hw, c, tx_count, s);
  return invalid;
}

// K1-split, second launch, and the second launch of K1's ring route: y from
// the global mean and rstd ((n, c) fp32), with scale / shift / affine_stride
// as for instance_norm_fwd and the optional ReLU.  A block owns `chunk_rows`
// rows (>= 1; hw: the whole sample) of one sample and one channel tile.
// Same conventions as above.
extern "C" int instance_norm_apply(const void* x, const void* mean, const void* rstd,
                                   const void* scale, const void* shift, void* y, int n, int hw,
                                   int c, int affine_stride, int dtype, int vec, int tx_count,
                                   int chunk_rows, int relu, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!geometry_ok(n, hw, c, affine_stride, vec, tx_count) || chunk_rows < 1) return invalid;
  if (x == nullptr || y == nullptr || mean == nullptr || rstd == nullptr) return invalid;
  if ((scale == nullptr) != (shift == nullptr)) return invalid;
  if (vec != 1 && (!aligned16(x) || !aligned16(y))) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return launch_apply<float, 1>(x, mean, rstd, scale, shift, y, n, hw, c, affine_stride, tx_count, chunk_rows, relu, s);
  if (dtype == 0 && vec == 4)
    return launch_apply<float, 4>(x, mean, rstd, scale, shift, y, n, hw, c, affine_stride, tx_count, chunk_rows, relu, s);
  if (dtype == 1 && vec == 1)
    return launch_apply<__nv_bfloat16, 1>(x, mean, rstd, scale, shift, y, n, hw, c, affine_stride, tx_count, chunk_rows, relu, s);
  if (dtype == 1 && vec == 8)
    return launch_apply<__nv_bfloat16, 8>(x, mean, rstd, scale, shift, y, n, hw, c, affine_stride, tx_count, chunk_rows, relu, s);
  return invalid;
}


// ---------------------------------------------------------------------------
// K1-split's first launch, cluster variant (instance_norm_partial_stats_
// cluster): the streaming kernel above reads x twice and, at a 256x256
// rank's shapes, has one block per (sample, channel tile) for a grid of 32
// blocks on 132 SMs.  Here a sample's rows on this rank are split over a
// cluster of K CTAs, each streaming whole rows of all C channels through the
// ring of instance_norm_cluster.cuh, so x is read from device memory once,
// and a sample gets K CTAs.  One pass with two-pass accuracy: a thread holds
// up to kRingRowsPerThread rows of its channel pack in registers, forms
// that chunk's mean and its M2 about that mean, and folds (count, mean, M2)
// into its running triple by Chan's rule; never sums of x and x^2.  Every
// mean is formed of x less the sample's first row on this rank, and that
// row is added back once, to the mean written out: the merges' differences
// of means then keep the digits of the spread where x sits far from 0.
// Reduction order, fixed so that a result repeats bit for bit (no atomics):
// in-thread in row order; across the CTA's threads by tree_over_rows with
// Chan's merge; across the cluster by rank 0, which merges the K CTAs'
// triples (each stored into its shared memory over DSMEM) in rank order
// 0..K-1 and writes mean and M2 (instance_norm_ring_stats, the ring route's
// first launch, whose rows are a whole sample's: mean and rstd).

namespace {

template <typename T>
__global__ void __launch_bounds__(kRingThreadsMax)
instance_norm_partial_stats_cluster_kernel(const T* __restrict__ x, float* __restrict__ mean_out,
                                           float* __restrict__ m2_out, int hw, int c,
                                           int k_count, int rows, int stages, int stage_rows,
                                           int finalize, float eps, int unbiased) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RPT = kRingRowsPerThread;
  extern __shared__ __align__(16) unsigned char smem[];
  const RingLayout lay =
      ring_layout(1, stage_rows, c, sizeof(T), blockDim.x, stages, k_count);
  float* part = reinterpret_cast<float*>(smem + lay.part);  // [K][3][c]: count, mean, M2
  float* red = reinterpret_cast<float*>(smem + lay.red);

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n = blockIdx.x / k_count;
  const int packs = c / VEC;
  const int ty_count = blockDim.x / packs;
  const int tid = threadIdx.x;
  const int ty = tid / packs;
  const int tx = tid - ty * packs;
  const int c0 = tx * VEC;

  Ring<T, 1> ring;
  ring.slots = reinterpret_cast<T*>(smem);
  ring.bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  ring.src[0] = x + static_cast<size_t>(n) * hw * c;
  ring.first = min(rank * rows, hw);
  ring.last = min(ring.first + rows, hw);
  ring.c = c;
  ring.stage_rows = stage_rows;
  ring.stages = stages;
  if (k_count > 1) cluster_arrive_relaxed();
  if (tid == 0) ring.start();

  // this thread's (count, mean, M2) of its rows, per channel, of x less
  // `ref`, the sample's first row on this rank (the same for every thread
  // and CTA): every mean merged below then has the digits of the spread,
  // not of the mean, so Chan's d = mb - ma keeps them where x sits far from
  // 0; rank 0 adds ref back to the mean it writes
  float cnt = 0.f, mean[VEC], m2[VEC], ref[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
  Pack<T, VEC>::load(ring.src[0] + c0, ref);
  __syncthreads();
  const int chunks = ring.chunks();
  for (int ch = 0; ch < chunks; ++ch) {
    ring.wait(ch);
    const T* xs = ring.chunk(ch, 0) + c0;
    const int in_chunk = ring.rows_of(ch);
    for (int base = 0; base < in_chunk; base += RPT * ty_count) {
      float v[RPT][VEC];
      int m = 0;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = base + ty + j * ty_count;
        if (r < in_chunk) {
          Pack<T, VEC>::load(xs + static_cast<size_t>(r) * c, v[j]);
          ++m;
        }
      }
      if (m == 0) continue;
      // Chan's merge of this chunk of m rows into the running triple; the
      // counts are the pack's, so the weights are formed once for its VEC
      // channels
      const float fm = static_cast<float>(m);
      const float inv_m = m == RPT ? 1.f / RPT : 1.f / fm;
      const float total = cnt + fm;
      const float w = fm / total;
      const float wa = cnt * w;
      cnt = total;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float u[RPT];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          u[j] = j < m ? v[j][i] - ref[i] : 0.f;
          sum += u[j];
        }
        const float mb = sum * inv_m;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          if (j < m) {
            const float d = u[j] - mb;
            q += d * d;
          }
        }
        const float d = mb - mean[i];
        mean[i] = mean[i] + d * w;
        m2[i] = (m2[i] + q) + (d * d) * wa;
      }
    }
    ring.release(ch);
  }
  float acc[3 * VEC];  // as ChanOp lays triples out
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    acc[i] = cnt;
    acc[VEC + i] = mean[i];
    acc[2 * VEC + i] = m2[i];
  }
  tree_over_rows<3 * VEC>(acc, red, packs, ty_count, ChanOp<VEC>());
  publish_to_rank0<3 * VEC, VEC>(red, part, rank, c, c0, tx, ty, k_count);
  cluster_sync(k_count);
  if (rank == 0 && ty == 0) {
    float tot[3 * VEC];
#pragma unroll
    for (int i = 0; i < 3 * VEC; ++i) tot[i] = 0.f;
    for (int k = 0; k < k_count; ++k) {
      const float* pk = part + k * 3 * c + c0;
      float cnt_k[VEC], mk[VEC], qk[VEC];
      load_f4<VEC>(cnt_k, pk);
      load_f4<VEC>(mk, pk + c);
      load_f4<VEC>(qk, pk + 2 * c);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        chan_merge(tot[i], tot[VEC + i], tot[2 * VEC + i], cnt_k[i], mk[i], qk[i]);
    }
    // the finalizing epilogue (K1's ring route, whose rows are the whole
    // sample): rstd in place of M2, as the cluster forward forms it
    const float correction =
        unbiased ? static_cast<float>(hw) / static_cast<float>(hw > 1 ? hw - 1 : 1) : 1.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float m2 = tot[2 * VEC + i];
      mean_out[static_cast<size_t>(n) * c + c0 + i] = tot[VEC + i] + ref[i];
      m2_out[static_cast<size_t>(n) * c + c0 + i] =
          finalize ? rsqrtf(m2 / static_cast<float>(hw) * correction + eps) : m2;
    }
  }
}

// The launch of both entry points below.
int launch_ring_stats(const void* x, void* mean, void* out2, int n, int hw, int c, int dtype,
                      int cluster, int rows, int stages, int stage_rows, int threads,
                      int smem_bytes, int finalize, float eps, int unbiased, cudaStream_t s) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return invalid;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (!ring_plan_ok(n, hw, c, itemsize, 1, cluster, rows, stages, stage_rows, threads,
                    smem_bytes))
    return invalid;
  if (x == nullptr || mean == nullptr || out2 == nullptr || !aligned16(x)) return invalid;
  const int blocks = n * cluster;
  if (dtype == 0)
    return launch_cluster(instance_norm_partial_stats_cluster_kernel<float>, blocks, cluster,
                          threads, smem_bytes, s, static_cast<const float*>(x),
                          static_cast<float*>(mean), static_cast<float*>(out2), hw, c, cluster,
                          rows, stages, stage_rows, finalize, eps, unbiased);
  return launch_cluster(instance_norm_partial_stats_cluster_kernel<__nv_bfloat16>, blocks,
                        cluster, threads, smem_bytes, s, static_cast<const __nv_bfloat16*>(x),
                        static_cast<float*>(mean), static_cast<float*>(out2), hw, c, cluster, rows,
                        stages, stage_rows, finalize, eps, unbiased);
}

}  // namespace

// K1-split, first launch, cluster variant.  x: this rank's rows, (n, hw, c)
// fp32 or bf16 (dtype 0 / 1), 16-byte aligned, C * sizeof(T) a multiple of
// 16; mean and m2: (n, c) fp32 outputs.  The plan
// (ops/kernels/instance_norm.py::split_plan): `cluster` CTAs per sample (1,
// 2, 4, 8 or 16), `rows` rows per CTA, a ring of `stages` slots of
// `stage_rows` rows, `threads` per CTA (a multiple of C / VEC),
// `smem_bytes` of dynamic shared memory, which must equal the layout's
// size.  Launches on `stream`, allocates nothing, does not synchronise.
// Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for arguments the kernel does not take,
// cudaErrorInvalidConfiguration if no cluster of this shape fits the card.
extern "C" int instance_norm_partial_stats_cluster(const void* x, void* mean, void* m2, int n,
                                                   int hw, int c, int dtype, int cluster,
                                                   int rows, int stages, int stage_rows,
                                                   int threads, int smem_bytes, void* stream) {
  return launch_ring_stats(x, mean, m2, n, hw, c, dtype, cluster, rows, stages, stage_rows,
                           threads, smem_bytes, 0, 0.f, 0, static_cast<cudaStream_t>(stream));
}

// K1's ring route, first launch: the same kernel over a whole sample's rows
// (hw = H * W), with the finalizing epilogue: rank 0 writes mean and
// rstd = rsqrt(M2 / hw * corr + eps), corr = hw / max(hw - 1, 1) if
// `unbiased`, else 1.  The plan and the conventions as above; mean and rstd
// are (n, c) fp32 outputs.  The second launch is instance_norm_apply.
extern "C" int instance_norm_ring_stats(const void* x, void* mean, void* rstd, int n, int hw,
                                        int c, int dtype, int cluster, int rows, int stages,
                                        int stage_rows, int threads, int smem_bytes, float eps,
                                        int unbiased, void* stream) {
  return launch_ring_stats(x, mean, rstd, n, hw, c, dtype, cluster, rows, stages, stage_rows,
                           threads, smem_bytes, 1, eps, unbiased,
                           static_cast<cudaStream_t>(stream));
}
