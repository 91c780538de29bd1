// What the on-chip ("cluster") variants of the instance-norm forward and
// backward kernels share: the shared-memory layout of a CTA, the bulk copies
// of its rows, the reduction inside a CTA and across the cluster, and the
// checked launch.
//
// A sample's slab (HW rows of C channels, contiguous in the NHWC tensor) is
// split over a cluster of K CTAs.  CTA rank k owns the rows
// [k * rows, min((k + 1) * rows, HW)), all C channels: one contiguous byte
// range, which it copies into its shared memory with one-dimensional bulk
// copies (cp.async.bulk, the TMA's copy without a tensor map; a 2-D tensor
// map would only be needed for channel tiles, which this layout does not
// use), in `stages` pieces of rows, each completing on an mbarrier of its
// own, so that summing starts on the first piece while the rest arrive.  x
// (and dy) are read from device memory exactly once; the output is written
// from shared memory with 16-byte stores.  A bulk copy needs 16-byte aligned
// addresses and a size that is a multiple of 16 bytes: the variant takes only
// rows of C * sizeof(T) % 16 == 0 bytes and 16-byte aligned tensors, so every
// row boundary is a legal copy boundary and no ragged piece is left.  Other
// shapes take the streaming kernels (the Python plan says which).
//
// Threads: `threads` = packs * TY, packs = C / VEC with VEC = 16 /
// sizeof(T); thread (tx, ty) owns the VEC channels tx * VEC .. and the rows
// ty, ty + TY, ... of each stage.  Reduction order, fixed so that a result
// repeats bit for bit: in-thread sums in row order; where packs divides 32 a
// butterfly of warp shuffles over the rows a warp holds; a binary tree over
// the remaining rows in shared memory (tree_over_rows); then every CTA adds
// the K per-CTA partials of the cluster, read from the CTAs' shared memory
// (DSMEM), in rank order 0..K-1, so all K CTAs hold the same total.  No
// atomics.  One cluster barrier per launch; each CTA waits before it exits
// until no other can still read its shared memory.
//
// Shared memory of a CTA (`ClusterLayout`, mirrored by
// ops/kernels/instance_norm.py::_cluster_smem_bytes):
//   slab  arrays * rows * C * sizeof(T)   x (and dy) of the CTA's rows
//   part  3 * C floats                    the CTA's partials, read by the cluster
//   stat  2 * C floats                    the cluster's totals, for the CTA's threads
//   red   tree_rows * C * arrays floats   the tree (tree_rows: see tree_over_rows)
//   bars  stages mbarriers

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <tuple>

#include "instance_norm_common.cuh"

namespace instance_norm {

namespace cg = cooperative_groups;

constexpr int kClusterThreadsMax = 256;
constexpr int kClusterMax = 16;
constexpr int kStagesMax = 8;
constexpr int kSmemPerBlockMax = 232448;  // 227 KB, an H100's opt-in maximum

struct ClusterLayout {
  int part, stat, red, bars, total;  // byte offsets, and the whole size
};

// Rows of partials tree_over_rows adds in shared memory: one per warp where
// a warp holds several rows of a channel pack (packs divides 32), else one
// per thread row.
__host__ __device__ inline int tree_rows(int packs, int threads) {
  return (packs < 32 && 32 % packs == 0) ? threads / 32 : threads / packs;
}

// `arrays` is 1 for the forward (x), 2 for the backward (x and dy).
__host__ __device__ inline ClusterLayout cluster_layout(int arrays, int rows, int c, int itemsize,
                                                        int threads, int stages) {
  const int vec = 16 / itemsize;
  ClusterLayout l;
  l.part = arrays * rows * c * itemsize;
  l.stat = l.part + 3 * c * 4;
  l.red = l.stat + 2 * c * 4;
  l.bars = l.red + tree_rows(c / vec, threads) * c * arrays * 4;
  l.total = l.bars + stages * 8;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Make the barriers' initialisation visible to the bulk-copy (async) proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  }
}

// Copy `bytes` (a multiple of 16) from global `src` to this CTA's shared
// `dst` (both 16-byte aligned); completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Every thread of every CTA of the cluster: release this CTA's shared-memory
// writes, then wait for all (the two halves of cluster.sync()).  With a
// cluster of one CTA a block barrier does.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync(int k_count) {
  if (k_count > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// Rows [r0, r1) of stage s of a CTA whose rows are [c0, c1).
__device__ __forceinline__ void stage_rows(int c0, int c1, int stages, int s, int& r0, int& r1) {
  const int per = (c1 - c0 + stages - 1) / stages;
  r0 = min(c0 + s * per, c1);
  r1 = min(r0 + per, c1);
}

// Thread 0 starts the copies of every stage: of each array in `src`, the
// rows [first, last) of the sample at `sample_off` elements, into `slab` at
// `slab_stride` elements per array.
template <typename T, int ARRAYS>
__device__ __forceinline__ void start_loads(T* slab, int slab_stride, const T* const (&src)[ARRAYS],
                                            size_t sample_off, int first, int last, int c,
                                            int stages, uint64_t* bars) {
  for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
  fence_barrier_init();
  for (int s = 0; s < stages; ++s) {
    int r0, r1;
    stage_rows(first, last, stages, s, r0, r1);
    if (r1 == r0) continue;
    const uint32_t bytes = static_cast<uint32_t>(r1 - r0) * c * sizeof(T);
    mbar_expect_tx(&bars[s], ARRAYS * bytes);
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a)
      bulk_load(slab + a * slab_stride + static_cast<size_t>(r0 - first) * c,
                src[a] + sample_off + static_cast<size_t>(r0) * c, bytes, &bars[s]);
  }
}

template <int NV>
__device__ __forceinline__ void store_f4(float* p, const float (&v)[NV]) {
#pragma unroll
  for (int q = 0; q < NV / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int NV>
__device__ __forceinline__ void add_f4(float (&v)[NV], const float* p) {
#pragma unroll
  for (int q = 0; q < NV / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] += f.x; v[4 * q + 1] += f.y; v[4 * q + 2] += f.z; v[4 * q + 3] += f.w;
  }
}

// Sum `acc` (NV floats, a multiple of 4) over the TY = threads / packs
// threads that share a tx; every thread of the CTA must call it.  Where a
// warp holds several rows of a tx (packs divides 32), they are first added
// by a butterfly of shuffles (lane l adds lane l ^ off, off = 16, 8, ...,
// packs: every lane of the class gets the same bits), leaving one row per
// warp.  The remaining rows are added by a binary tree in `red` (rows *
// packs * NV floats): at stride s = P/2, P/4, ..., 1 (P the power of two >=
// rows) row t adds row t + s where that row exists.  Afterwards red[tx * NV
// ..] hold the CTA's totals, for the threads tid < packs.
template <int NV>
__device__ __forceinline__ void tree_over_rows(float (&acc)[NV], float* red, int packs,
                                               int ty_count) {
  const int tid = threadIdx.x;
  int row = tid / packs;
  int rows = ty_count;
  bool holder = true;
  if (packs < 32 && 32 % packs == 0) {  // then threads is a multiple of 32
    for (int off = 16; off >= packs; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    const int lane = tid & 31;
    holder = lane < packs;
    row = tid >> 5;
    rows = blockDim.x >> 5;
  }
  const int slot = row * packs + tid % packs;
  if (holder) store_f4<NV>(red + slot * NV, acc);
  __syncthreads();
  int span = 1;
  while (span < rows) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (holder && row < s && row + s < rows) {
      float v[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = red[slot * NV + i];
      add_f4<NV>(v, red + (slot + s * packs) * NV);
      store_f4<NV>(red + slot * NV, v);
    }
    __syncthreads();
  }
}

// The cluster's total of the VEC floats at part[off ..] of each CTA, added in
// rank order 0..K-1 (so every CTA gets the same bits), into `out`.
template <int VEC>
__device__ __forceinline__ void cluster_total(float (&out)[VEC], float* part, int off, int k_count) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = 0.f;
  if (k_count == 1) {
    add_f4<VEC>(out, part + off);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll 4
  for (int k = 0; k < k_count; ++k) add_f4<VEC>(out, cluster.map_shared_rank(part, k) + off);
}

// Rows of CTA rank k of a cluster whose CTAs hold `rows` rows each.
__host__ __device__ inline int rows_of_rank(int k, int rows, int hw) {
  const int first = min(k * rows, hw);
  return min(first + rows, hw) - first;
}

// The launch of a cluster kernel: the attributes it needs (dynamic shared
// memory above 48 KB, clusters of 16), a check that one cluster of this
// shape can be resident at all (cudaOccupancyMaxActiveClusters, or for a
// cluster of one CTA cudaOccupancyMaxActiveBlocksPerMultiprocessor; refused
// with cudaErrorInvalidConfiguration if not), then cudaLaunchKernelEx with
// the cluster dimension (none for a cluster of one).  The attribute setting and the check run once per
// (kernel, device, cluster, threads, shared memory).  Returns the launch's
// cudaError_t.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int blocks, int cluster, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  static std::mutex mu;
  static std::set<std::tuple<int, int, int, int>> checked;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one CTA: an ordinary launch

  const auto key = std::make_tuple(device, cluster, threads, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!checked.count(key)) {
      const void* fn = reinterpret_cast<const void*>(kernel);
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlockMax);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      int resident = 0;
      if (err == cudaSuccess)
        err = cluster > 1 ? cudaOccupancyMaxActiveClusters(&resident, fn, &cfg)
                          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, threads, smem);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return static_cast<int>(err);
      }
      if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      checked.insert(key);
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What both cluster entry points refuse: returns false for a plan the
// kernels do not take.
inline bool cluster_plan_ok(int n, int hw, int c, int affine_stride, int itemsize, int arrays,
                            int cluster, int rows, int stages, int threads, int smem) {
  const int vec = 16 / itemsize;
  if (n < 1 || hw < 1 || c < 1 || c % vec != 0) return false;
  if (affine_stride != 0 && affine_stride != c) return false;
  if (cluster < 1 || cluster > kClusterMax || (cluster & (cluster - 1)) != 0) return false;
  if (static_cast<long long>(n) * cluster > 2147483647LL) return false;
  if (rows < 1 || static_cast<long long>(rows) * cluster < hw || rows > hw) return false;
  if (stages < 1 || stages > kStagesMax) return false;
  const int packs = c / vec;
  if (threads < packs || threads > kClusterThreadsMax || threads % packs != 0) return false;
  const long long slab = static_cast<long long>(arrays) * rows * c * itemsize;
  if (slab > kSmemPerBlockMax) return false;
  if (smem != cluster_layout(arrays, rows, c, itemsize, threads, stages).total) return false;
  return smem <= kSmemPerBlockMax;
}

}  // namespace instance_norm
