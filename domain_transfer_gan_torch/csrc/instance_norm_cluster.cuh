// What the on-chip ("cluster") variants of the instance-norm forward and
// backward kernels share: the shared-memory layout of a CTA, the bulk copies
// of its rows, the reduction inside a CTA and across the cluster, and the
// checked launch; and, at the end, the ring through which the cluster
// variants of the split reductions (K1-split's partial statistics, K2-split's
// partial sums) and the first launch of K1's and K2's ring route stream rows
// that need not fit the cluster.
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
// The first half of a barrier that orders nothing: arrived at when a CTA
// starts, waited for (cluster_wait) before its first store into another
// CTA's shared memory, which must not precede that CTA's start.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
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
__device__ __forceinline__ void load_f4(float (&v)[NV], const float* p) {
#pragma unroll
  for (int q = 0; q < NV / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
  }
}

template <int NV>
__device__ __forceinline__ void add_f4(float (&v)[NV], const float* p) {
#pragma unroll
  for (int q = 0; q < NV / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] += f.x; v[4 * q + 1] += f.y; v[4 * q + 2] += f.z; v[4 * q + 3] += f.w;
  }
}

// The combining step of tree_over_rows: a := a (+) b, `a` the lower row.
// Plain sums (the K1 / K2 cluster kernels, K2-split's sums).
struct AddOp {
  static constexpr bool kCommutative = true;  // a + b and b + a give the same bits
  template <int NV>
  __device__ __forceinline__ void operator()(float (&a)[NV], const float (&b)[NV]) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) a[i] += b[i];
  }
};

// Combine `acc` (NV floats, a multiple of 4) over the TY = threads / packs
// threads that share a tx with `op`; every thread of the CTA must call it.
// Where a warp holds several rows of a tx (packs divides 32), they are first
// combined by a butterfly of shuffles (lane l with lane l ^ off, off = 16, 8,
// ..., packs; the lane with bit `off` clear is the lower row, so both lanes
// of a pair get the same bits), leaving one row per warp.  The remaining
// rows are combined by a binary tree in `red` (rows * packs * NV floats): at
// stride s = P/2, P/4, ..., 1 (P the power of two >= rows) row t takes row
// t + s where that row exists.  Afterwards red[tx * NV ..] hold the CTA's
// totals, for the threads tid < packs.
template <int NV, typename Op = AddOp>
__device__ __forceinline__ void tree_over_rows(float (&acc)[NV], float* red, int packs,
                                               int ty_count, Op op = Op()) {
  const int tid = threadIdx.x;
  int row = tid / packs;
  int rows = ty_count;
  bool holder = true;
  if (packs < 32 && 32 % packs == 0) {  // then threads is a multiple of 32
    for (int off = 16; off >= packs; off >>= 1) {
      float other[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) other[i] = __shfl_xor_sync(0xffffffffu, acc[i], off);
      if (Op::kCommutative || !(tid & off)) {
        op(acc, other);
      } else {
        op(other, acc);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] = other[i];
      }
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
      float v[NV], w[NV];
      load_f4<NV>(v, red + slot * NV);
      load_f4<NV>(w, red + (slot + s * packs) * NV);
      op(v, w);
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
  static std::set<std::tuple<const void*, int, int, int, int>> checked;
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

  const void* fn = reinterpret_cast<const void*>(kernel);
  const auto key = std::make_tuple(fn, device, cluster, threads, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!checked.count(key)) {
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


// ---------------------------------------------------------------------------
// The ring: the cluster variant of the split reductions (K1-split's partial
// statistics, K2-split's partial sums), whose rows need not fit the cluster,
// and the first launch of K1's and K2's ring route over whole samples.
//
// A reduction never needs a row again once it has read it.  CTA rank k of a
// cluster of K owns the rows [k * rows, min((k + 1) * rows, HW)) of its
// sample, all C channels: one contiguous byte range, read as chunks of
// `stage_rows` whole rows through a ring of `stages` slots in shared memory.
// Thread 0 starts the first `stages` chunks, one bulk copy per array (x, and
// dy for the sums), each chunk completing on its slot's mbarrier (waited on
// with the parity of the slot's use count); the threads reduce chunk i while
// chunks i + 1 .. i + stages - 1 are in flight, and after a block barrier
// thread 0 refills chunk i's slot with chunk i + stages.  So x (and dy) are
// read from device memory exactly once, whatever the size of a sample.
//
// After the tree every CTA stores its partials into rank 0's `part` (over
// DSMEM), at its own rank's place, and one cluster barrier later rank 0
// merges them in rank order and writes the result; no CTA reads another's
// shared memory, so none waits again before it exits.  (A barrier arrived
// at when the CTAs start, and waited for before those stores, makes sure
// rank 0 has started; it costs no wait by then.)
//
// Shared memory of a CTA (`RingLayout`, mirrored by
// ops/kernels/instance_norm.py::_ring_smem_bytes):
//   ring  stages * arrays * stage_rows * C * sizeof(T)
//   part  cluster * 3 * C floats       every CTA's partials (used in rank 0)
//   red   tree_rows * C * 3 floats     the tree (tree_rows: see tree_over_rows)
//   bars  stages mbarriers

constexpr int kRingRowsPerThread = 4;  // rows of a thread's pack held in registers at once
constexpr int kRingStagesMax = 8;
constexpr int kRingThreadsMax = 512;

struct RingLayout {
  int part, red, bars, total;  // byte offsets, and the whole size
};

__host__ __device__ inline RingLayout ring_layout(int arrays, int stage_rows, int c, int itemsize,
                                                  int threads, int stages, int cluster) {
  const int vec = 16 / itemsize;
  RingLayout l;
  l.part = stages * arrays * stage_rows * c * itemsize;
  l.red = l.part + cluster * 3 * c * 4;
  l.bars = l.red + tree_rows(c / vec, threads) * c * 3 * 4;
  l.total = l.bars + stages * 8;
  return l;
}

// One CTA's rows [first, last) of ARRAYS arrays (`src`: each at the sample's
// first element) as chunks through the ring.
template <typename T, int ARRAYS>
struct Ring {
  T* slots;
  uint64_t* bars;
  const T* src[ARRAYS];
  int first, last, c, stage_rows, stages;

  __device__ __forceinline__ int chunks() const {
    return (last - first + stage_rows - 1) / stage_rows;
  }
  __device__ __forceinline__ int rows_of(int i) const {
    return min(stage_rows, last - first - i * stage_rows);
  }
  // array a of chunk i, in its slot
  __device__ __forceinline__ const T* chunk(int i, int a) const {
    return slots + (static_cast<size_t>(i % stages) * ARRAYS + a) * stage_rows * c;
  }
  // thread 0: chunk i's copies into its slot
  __device__ __forceinline__ void issue(int i) const {
    const size_t r0 = static_cast<size_t>(first) + static_cast<size_t>(i) * stage_rows;
    const uint32_t bytes = static_cast<uint32_t>(rows_of(i)) * c * sizeof(T);
    uint64_t* bar = &bars[i % stages];
    mbar_expect_tx(bar, ARRAYS * bytes);
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a)
      bulk_load(const_cast<T*>(chunk(i, a)), src[a] + r0 * c, bytes, bar);
  }
  // thread 0: the barriers, then the first `stages` chunks; a block barrier
  // must follow before any thread waits
  __device__ __forceinline__ void start() const {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    fence_barrier_init();
    const int n = min(stages, chunks());
    for (int i = 0; i < n; ++i) issue(i);
  }
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(&bars[i % stages], static_cast<uint32_t>((i / stages) & 1));
  }
  // every thread, once it has read chunk i: thread 0 refills its slot
  __device__ __forceinline__ void release(int i) const {
    if (i + stages < chunks()) {  // the same for every thread
      __syncthreads();
      if (threadIdx.x == 0) issue(i + stages);
    }
  }
};

// Chan et al.'s merge of two (count, mean, M2) triples: (n, mean, m2) :=
// the rows of both, (n, mean, m2) the lower rows.  M2 is the centered sum
// of squares, and the merge keeps it centered: M2 = M2_a + M2_b + d^2 n_a
// n_b / n with d the difference of the means.  An empty side (count 0)
// leaves the other unchanged, bit for bit.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  const float na = n;
  const float total = na + nb;
  const float w = nb / fmaxf(total, 1.f);
  const float d = mb - mean;
  mean = mean + d * w;
  m2 = (m2 + m2b) + (d * d) * (na * w);
  n = total;
}

// tree_over_rows' step for triples laid out as 3 * VEC floats: counts
// [0, VEC), means [VEC, 2 VEC), M2 [2 VEC, 3 VEC).
template <int VEC>
struct ChanOp {
  static constexpr bool kCommutative = false;
  template <int NV>
  __device__ __forceinline__ void operator()(float (&a)[NV], const float (&b)[NV]) const {
    static_assert(NV == 3 * VEC, "triples of VEC channels");
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      chan_merge(a[i], a[VEC + i], a[2 * VEC + i], b[i], b[VEC + i], b[2 * VEC + i]);
  }
};

// After tree_over_rows, the ty == 0 threads (tid < packs) store the CTA's
// NV = 3 * VEC totals of channels c0 .. into rank 0's part[rank][3][c]
// (part[3][c] of the one CTA of a cluster of one), as [k][c] for k < NV / VEC.
// Every thread of the CTA calls it (the wait is a cluster barrier's half).
template <int NV, int VEC>
__device__ __forceinline__ void publish_to_rank0(const float* red, float* part, int rank, int c,
                                                 int c0, int tx, int ty, int k_count) {
  float* dst = part;
  if (k_count > 1) {
    cluster_wait();  // of the arrival at the start: rank 0 has started
    dst = cg::this_cluster().map_shared_rank(part, 0);
  }
  if (ty != 0) return;
  dst += rank * 3 * c + c0;
#pragma unroll
  for (int k = 0; k < NV / VEC; ++k) {
    float v[VEC];
    load_f4<VEC>(v, red + tx * NV + k * VEC);
    store_f4<VEC>(dst + k * c, v);
  }
}

// What both ring entry points refuse: returns false for a plan the kernels
// do not take.
inline bool ring_plan_ok(int n, int hw, int c, int itemsize, int arrays, int cluster, int rows,
                         int stages, int stage_rows, int threads, int smem) {
  const int vec = 16 / itemsize;
  if (n < 1 || hw < 1 || c < 1 || c % vec != 0) return false;
  if (cluster < 1 || cluster > kClusterMax || (cluster & (cluster - 1)) != 0) return false;
  if (static_cast<long long>(n) * cluster > 2147483647LL) return false;
  if (rows < 1 || static_cast<long long>(rows) * cluster < hw || rows > hw) return false;
  if (stages < 1 || stages > kRingStagesMax || stage_rows < 1) return false;
  const int packs = c / vec;
  if (threads < packs || threads > kRingThreadsMax || threads % packs != 0) return false;
  const long long ring = static_cast<long long>(stages) * arrays * stage_rows * c * itemsize;
  if (ring > kSmemPerBlockMax) return false;
  if (smem != ring_layout(arrays, stage_rows, c, itemsize, threads, stages, cluster).total)
    return false;
  return smem <= kSmemPerBlockMax;
}

}  // namespace instance_norm
