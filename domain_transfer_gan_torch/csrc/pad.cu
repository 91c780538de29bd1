// Reflection and replication padding of an NCHW activation held in
// channels_last memory (physically a contiguous (N, H, W, C) array), forward
// and backward, for Hopper.
//
// Replaces no TPU kernel.  The JAX package pads with jnp.pad
// (domain_transfer_gan_tpu/ops/convs.py::reflect_pad2d / replicate_pad2d),
// which XLA lowers to a fusion; the port first called F.pad, whose CUDA
// backward (reflection_pad2d_backward_cuda / replication_pad2d_backward_cuda)
// adds the gradients of the mirrored or clamped border into the input's with
// atomics, in an order that changes from run to run.  Every pad of a
// generator (conv0's 3-pixel pad, two 1-pixel pads per residual block) lies
// on the path of every train step's and every UBO step's backward, so those
// atomics made a step's result differ in its last bits from run to run, and
// RMSprop's and Adam's sign-like first updates grew the difference.  These
// kernels give the same bits on every run.
//
// For an input of (H, W) and pads (top, bottom, left, right), the output is
// (H + top + bottom, W + left + right) and output position (oh, ow) holds
// input (src(oh - top, H), src(ow - left, W)), where
//     reflect:   src(j, L) = |j|, mirrored again past L - 1: 2 (L - 1) - |j|
//                (the edge itself is not repeated; every pad < L);
//     replicate: src(j, L) = min(max(j, 0), L - 1).
//
// Bound.  Both directions move bytes and do almost no arithmetic: the
// forward reads x once and writes y once, the backward reads dy once and
// writes dx once, so the least time on an H100 SXM is
// (N H W C + N Ho Wo C) * sizeof(T) / 3.35e12 s either way.
//
// Forward (pad2d_fwd): one thread per output word, which copies the word of
// its source pixel.  A word is the widest of 16, 8, 4 or 2 bytes that divides
// a pixel's C * sizeof(T) bytes and the alignment of both pointers, so a
// pixel of 128 float32 channels is 32 16-byte copies and one of 3 float32
// channels three 4-byte copies; neighbouring threads copy neighbouring words
// of the output.  The forward is a copy: its output is F.pad's bit for bit.
//
// Backward (pad2d_bwd): the gather form.  One thread per input element (or
// per 16 bytes of neighbouring channels, where C * sizeof(T) is a multiple
// of 16 and the pointers are aligned) adds the output gradients of every
// output position that copied it, in a fixed order (output rows ascending,
// and within a row output columns ascending), in float32 from 0, and stores
// the sum once.  No atomics, so the result repeats bit for bit.  An interior
// element has one such position; under reflection an element within `pad`
// of an edge has up to three per axis (itself and its mirror images in the
// pads on either side), under replication an edge element has the pad's
// width plus one, so a corner sums up to 9 (reflect) or (pad + 1)^2
// (replicate) gradients.  The order is the one in which PyTorch's CPU
// backward adds them, so in float32 the CPU's plain version gives the same
// bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "instance_norm_common.cuh"

namespace {

using instance_norm::Pack;

constexpr int kPadThreads = 256;

// The input position along one axis of length `len` that output position
// j + before copies.
__device__ __forceinline__ int source(int j, int len, bool reflect) {
  if (reflect) {
    j = j < 0 ? -j : j;
    return j > len - 1 ? 2 * (len - 1) - j : j;
  }
  return j < 0 ? 0 : (j > len - 1 ? len - 1 : j);
}

template <typename W>
__global__ void __launch_bounds__(kPadThreads)
pad2d_fwd_kernel(const W* __restrict__ x, W* __restrict__ y, long long total, int h, int w,
                 int ho, int wo, int words, int top, int left, bool reflect) {
  const long long i = static_cast<long long>(blockIdx.x) * kPadThreads + threadIdx.x;
  if (i >= total) return;
  long long p = i / words;
  const int k = static_cast<int>(i - p * words);
  const int ow = static_cast<int>(p % wo);
  p /= wo;
  const int oh = static_cast<int>(p % ho);
  const long long n = p / ho;
  const int ih = source(oh - top, h, reflect);
  const int iw = source(ow - left, w, reflect);
  y[i] = x[((n * h + ih) * w + iw) * words + k];
}

// The output positions along one axis that copy input position i under
// reflection, ascending: the mirror image in the pad before, i itself, the
// mirror image in the pad after.
__device__ __forceinline__ int reflect_sources(int i, int len, int before, int after,
                                               int (&o)[3]) {
  int k = 0;
  if (i >= 1 && i <= before) o[k++] = before - i;
  o[k++] = before + i;
  if (i <= len - 2 && i >= len - 1 - after) o[k++] = before + 2 * (len - 1) - i;
  return k;
}

template <typename T, int VEC>
__device__ __forceinline__ void add_at(const T* p, float (&acc)[VEC]) {
  float v[VEC];
  Pack<T, VEC>::load(p, v);
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] += v[q];
}

template <typename T, int VEC, bool REFLECT>
__global__ void __launch_bounds__(kPadThreads)
pad2d_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, long long total, int h, int w,
                 int c, int top, int bottom, int left, int right) {
  const long long i = static_cast<long long>(blockIdx.x) * kPadThreads + threadIdx.x;
  if (i >= total) return;
  const int packs = c / VEC;
  const long long pixel = i / packs;
  const int c0 = static_cast<int>(i - pixel * packs) * VEC;
  long long p = pixel;
  const int iw = static_cast<int>(p % w);
  p /= w;
  const int ih = static_cast<int>(p % h);
  const long long n = p / h;
  const int ho = h + top + bottom, wo = w + left + right;
  const T* base = dy + n * ho * wo * c + c0;
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  if (REFLECT) {
    int rows[3], cols[3];
    const int nr = reflect_sources(ih, h, top, bottom, rows);
    const int nc = reflect_sources(iw, w, left, right, cols);
    for (int a = 0; a < nr; ++a)
      for (int b = 0; b < nc; ++b)
        add_at<T, VEC>(base + (static_cast<long long>(rows[a]) * wo + cols[b]) * c, acc);
  } else {
    const int r0 = ih == 0 ? 0 : top + ih, r1 = ih == h - 1 ? ho - 1 : top + ih;
    const int q0 = iw == 0 ? 0 : left + iw, q1 = iw == w - 1 ? wo - 1 : left + iw;
    for (int r = r0; r <= r1; ++r)
      for (int q = q0; q <= q1; ++q)
        add_at<T, VEC>(base + (static_cast<long long>(r) * wo + q) * c, acc);
  }
  Pack<T, VEC>::store(dx + pixel * c + c0, acc);
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

// What both entry points refuse.
inline bool pads_ok(int n, int h, int w, int c, int top, int bottom, int left, int right,
                    int mode) {
  if (n < 1 || h < 1 || w < 1 || c < 1) return false;
  if (top < 0 || bottom < 0 || left < 0 || right < 0) return false;
  if (mode != 0 && mode != 1) return false;
  // reflection mirrors inside the axis: every pad shorter than it
  if (mode == 0 && (top >= h || bottom >= h || left >= w || right >= w)) return false;
  return true;
}

inline int grid_of(long long total, unsigned* blocks) {
  const long long b = (total + kPadThreads - 1) / kPadThreads;
  if (b < 1 || b > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return 0;
}

template <typename W>
int launch_fwd(const void* x, void* y, int n, int h, int w, int row_bytes, int top, int bottom,
               int left, int right, int mode, cudaStream_t s) {
  const int words = row_bytes / static_cast<int>(sizeof(W));
  const int ho = h + top + bottom, wo = w + left + right;
  const long long total = static_cast<long long>(n) * ho * wo * words;
  unsigned blocks;
  if (grid_of(total, &blocks) != 0) return static_cast<int>(cudaErrorInvalidValue);
  pad2d_fwd_kernel<W><<<blocks, kPadThreads, 0, s>>>(static_cast<const W*>(x),
                                                     static_cast<W*>(y), total, h, w, ho, wo,
                                                     words, top, left, mode == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd(const void* dy, void* dx, int n, int h, int w, int c, int top, int bottom,
               int left, int right, int mode, cudaStream_t s) {
  const long long total = static_cast<long long>(n) * h * w * (c / VEC);
  unsigned blocks;
  if (grid_of(total, &blocks) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0)
    pad2d_bwd_kernel<T, VEC, true><<<blocks, kPadThreads, 0, s>>>(
        static_cast<const T*>(dy), static_cast<T*>(dx), total, h, w, c, top, bottom, left, right);
  else
    pad2d_bwd_kernel<T, VEC, false><<<blocks, kPadThreads, 0, s>>>(
        static_cast<const T*>(dy), static_cast<T*>(dx), total, h, w, c, top, bottom, left, right);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, h, w, c) of `itemsize`-byte elements, contiguous; y: (n, h + top +
// bottom, w + left + right, c), contiguous.  mode: 0 = reflect, 1 =
// replicate.  Launches on `stream`, allocates nothing, does not synchronise.
// Returns the cudaError_t of the launch (0 on success), cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int pad2d_fwd(const void* x, void* y, int n, int h, int w, int c, int itemsize,
                         int top, int bottom, int left, int right, int mode, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!pads_ok(n, h, w, c, top, bottom, left, right, mode)) return invalid;
  if (x == nullptr || y == nullptr || itemsize < 2 || itemsize > 8) return invalid;
  if (static_cast<long long>(c) * itemsize > 2147483647LL) return invalid;
  const int row_bytes = c * itemsize;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fits = [&](unsigned bytes) {
    return row_bytes % bytes == 0 && aligned(x, bytes) && aligned(y, bytes);
  };
  if (fits(16))
    return launch_fwd<uint4>(x, y, n, h, w, row_bytes, top, bottom, left, right, mode, s);
  if (fits(8))
    return launch_fwd<uint2>(x, y, n, h, w, row_bytes, top, bottom, left, right, mode, s);
  if (fits(4))
    return launch_fwd<uint32_t>(x, y, n, h, w, row_bytes, top, bottom, left, right, mode, s);
  if (fits(2))
    return launch_fwd<uint16_t>(x, y, n, h, w, row_bytes, top, bottom, left, right, mode, s);
  return invalid;
}

// dy: (n, h + top + bottom, w + left + right, c), contiguous; dx: (n, h, w,
// c), contiguous, written whole.  dtype: 0 = float32, 1 = bfloat16.  mode as
// above.  Same contract as pad2d_fwd.
extern "C" int pad2d_bwd(const void* dy, void* dx, int n, int h, int w, int c, int dtype,
                         int top, int bottom, int left, int right, int mode, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!pads_ok(n, h, w, c, top, bottom, left, right, mode)) return invalid;
  if (dy == nullptr || dx == nullptr) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = aligned(dy, 16) && aligned(dx, 16);
  if (dtype == 0) {
    if (wide && c % 4 == 0)
      return launch_bwd<float, 4>(dy, dx, n, h, w, c, top, bottom, left, right, mode, s);
    return launch_bwd<float, 1>(dy, dx, n, h, w, c, top, bottom, left, right, mode, s);
  }
  if (dtype == 1) {
    if (wide && c % 8 == 0)
      return launch_bwd<__nv_bfloat16, 8>(dy, dx, n, h, w, c, top, bottom, left, right, mode, s);
    return launch_bwd<__nv_bfloat16, 1>(dy, dx, n, h, w, c, top, bottom, left, right, mode, s);
  }
  return invalid;
}
