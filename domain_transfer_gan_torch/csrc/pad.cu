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
// (Ho, Wo) = (H + top + bottom, W + left + right) and output position
// (oh, ow) holds input (src(oh - top, H), src(ow - left, W)), where
//     reflect:   src(j, L) = |j|, mirrored again past L - 1: 2 (L - 1) - |j|
//                (the edge itself is not repeated; every pad < L);
//     replicate: src(j, L) = min(max(j, 0), L - 1).
//
// Bound.  Both directions move bytes and do almost no arithmetic: the
// forward reads x once and writes y once, the backward reads dy once and
// writes dx once, so the least time on an H100 SXM is
// (N H W C + N Ho Wo C) * sizeof(T) / 3.35e12 s either way.  In memory a
// sample's rows are contiguous runs of W C (x, dx) or Wo C (y, dy) elements;
// conv0's pixels are 12 bytes (3 float32 channels), a residual block's 512.
//
// Two kernels each way; ops/kernels/pad.py::pad_plan picks one per launch
// by the rule an H100 measured (ring_sweeps.py pads --bands, PERF.md):
//
// The band kernels (pad2d_band_fwd_kernel, pad2d_band_bwd_kernel): one CTA
// per (sample, band of rows: output rows forward, input rows backward), so
// that a CTA's output is one contiguous span, written 16 bytes a store; a
// band's row count puts every band on 16 bytes where the sample's rows
// allow it (conv0's 840-byte output rows: an even count), and the bytes of
// a band before its first and after its last 16-byte boundary are stored
// one word or element at a time.  Index arithmetic is 32-bit inside a
// sample, counters stepped rather than divided.  Forward: each thread
// gathers 16 bytes of output at a time from device memory, a word (the
// widest of 16, 8, 4 or 2 bytes that divides a pixel's C * sizeof(T) bytes
// and both pointers' alignment) at a time through a table of each output
// word's source word in an input row (the reflected or clamped columns,
// 32-bit, built once a CTA in shared memory), four such chunks in flight a
// thread.  Backward, the gather form: each thread sums 16 bytes of dx at a
// time, a pixel's channels together where C * sizeof(T) is a multiple of
// 16 (16-byte loads), else element by element.  (Staging a band's rows in
// shared memory by 1-D bulk copies and storing it by one measured slower
// than both designs here at 94 of 96 main-path cases: PERF.md §6.)
//
// The word kernels (pad2d_fwd_kernel, pad2d_bwd_kernel): one thread per
// output word forward, one per input element or 16-byte pack backward,
// reading device memory directly.  Where a pixel is 16 bytes or more (a
// residual block's) the forward is a 16-byte streaming copy that a band's
// does not beat, and so is the backward except on large launches.
//
// Backward sums, both kernels: an input element adds the output gradients
// of every output position that copied it, in a fixed order (output rows
// ascending, and within a row output columns ascending), in float32 from
// 0, and stores the sum once.  No atomics, so the result repeats bit for
// bit.  An interior element has one such position; under reflection an
// element within `pad` of an edge has up to three per axis (itself and its
// mirror images in the pads on either side), under replication an edge
// element has the pad's width plus one, so a corner sums up to 9 (reflect)
// or (pad + 1)^2 (replicate) gradients.  The order is the one in which
// PyTorch's CPU backward adds them, so in float32 the CPU's plain version
// gives the same bits.  The forward is a copy: its output is F.pad's bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "instance_norm_common.cuh"

namespace {

using instance_norm::Pack;

constexpr int kPadThreads = 256;      // the word kernels' blocks
constexpr int kBandThreadsMax = 512;  // a band CTA's threads, at most
constexpr int kTableBytesMax = 49152;  // the band forward's source table

// The input position along one axis of length `len` that output position
// j + before copies.
__host__ __device__ __forceinline__ int source(int j, int len, bool reflect) {
  if (reflect) {
    j = j < 0 ? -j : j;
    return j > len - 1 ? 2 * (len - 1) - j : j;
  }
  return j < 0 ? 0 : (j > len - 1 ? len - 1 : j);
}

__device__ __forceinline__ long long addr(const void* p) {
  return static_cast<long long>(reinterpret_cast<uintptr_t>(p));
}

template <typename T, int VEC>
__device__ __forceinline__ void add_at(const T* p, float (&acc)[VEC]) {
  float v[VEC];
  Pack<T, VEC>::load(p, v);
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] += v[q];
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

// ---------------------------------------------------------------- band kernels

// 16 bytes as V words of W.
template <typename W>
union Chunk {
  uint4 q;
  W w[16 / sizeof(W)];
};

// x: (n, h, w, pw words of W a pixel); y: (n, ho, wo, pw).  One CTA per
// (sample, band of `rows` output rows); each thread gathers 16 bytes of the
// band's output at a time straight from device memory, through a table of
// each output word's source word in an input row, and stores them at once;
// the band's words before its first and after its last 16-byte boundary
// are stored one by one.
template <typename W>
__global__ void __launch_bounds__(kBandThreadsMax)
pad2d_band_fwd_kernel(const W* __restrict__ x, W* __restrict__ y, int h, int w, int pw, int top,
                      int bottom, int left, int right, int rows, int bands, bool reflect) {
  extern __shared__ int table[];
  constexpr int V = 16 / static_cast<int>(sizeof(W));
  const int ho = h + top + bottom, wo = w + left + right;
  const int in_words = w * pw, out_words = wo * pw;
  const int sample = blockIdx.x / bands, o0 = (blockIdx.x - sample * bands) * rows;
  const int words = (o0 + rows < ho ? rows : ho - o0) * out_words;
  for (int j = threadIdx.x; j < out_words; j += blockDim.x) {
    const int ow = j / pw;
    table[j] = source(ow - left, w, reflect) * pw + (j - ow * pw);
  }
  __syncthreads();
  const W* xs = x + static_cast<long long>(sample) * h * in_words;
  W* ys = y + (static_cast<long long>(sample) * ho + o0) * out_words;
  const int lead = static_cast<int>(((16 - (addr(ys) & 15)) & 15) / sizeof(W));
  const int head = lead < words ? lead : words;
  const int chunks = (words - head) / V, tail = head + chunks * V;
  auto word_at = [&](int r, int j) {
    return __ldg(xs + source(o0 + r - top, h, reflect) * in_words + table[j]);
  };
  for (int e = threadIdx.x; e < head + words - tail; e += blockDim.x) {
    const int at = e < head ? e : tail + e - head, r = at / out_words;
    ys[at] = word_at(r, at - r * out_words);
  }
  constexpr int kUnroll = 4;  // chunks a thread has in flight
  for (int k0 = threadIdx.x; k0 < chunks; k0 += kUnroll * blockDim.x) {
    Chunk<W> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < chunks) {
        const int e = head + k * V;
        int r = e / out_words, j = e - r * out_words;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          v[u].w[i] = word_at(r, j);
          if (++j == out_words) j = 0, ++r;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < chunks) *reinterpret_cast<uint4*>(ys + head + k * V) = v[u].q;
    }
  }
}

// dy: (n, ho, wo, c); dx: (n, h, w, c).  One CTA per (sample, band of
// `rows` input rows); each thread sums 16 bytes of the band's dx at a time
// (VEC elements: where PACKED, VEC channels of one pixel, read by 16-byte
// loads; else element by element) straight from device memory, in the fixed
// order, and stores them at once; the ends off 16 bytes one by one.
template <typename T, int VEC, bool PACKED, bool REFLECT>
__global__ void __launch_bounds__(kBandThreadsMax)
pad2d_band_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int h, int w, int c, int top,
                      int bottom, int left, int right, int rows, int bands) {
  const int ho = h + top + bottom, wo = w + left + right;
  const int sample = blockIdx.x / bands, i0 = (blockIdx.x - sample * bands) * rows;
  const int elems = (i0 + rows < h ? rows : h - i0) * w * c;
  const T* dys = dy + static_cast<long long>(sample) * ho * wo * c;
  T* dxs = dx + (static_cast<long long>(sample) * h + i0) * w * c;
  const int lead = static_cast<int>(((16 - (addr(dxs) & 15)) & 15) / sizeof(T));
  const int head = lead < elems ? lead : elems;
  const int chunks = (elems - head) / VEC, tail = head + chunks * VEC;
  // the sums of the N elements of input pixel (ih, iw) from channel ch on
  // (acc: float[N], from 0), in the fixed order
  auto gather = [&](int ih, int iw, int ch, auto& acc) {
    constexpr int N = sizeof(acc) / sizeof(float);
    if (REFLECT) {
      int rs[3], cs[3];
      const int nr = reflect_sources(ih, h, top, bottom, rs);
      const int nc = reflect_sources(iw, w, left, right, cs);
      for (int a = 0; a < nr; ++a)
        for (int b = 0; b < nc; ++b) add_at<T, N>(dys + (rs[a] * wo + cs[b]) * c + ch, acc);
    } else {
      const int r0 = ih == 0 ? 0 : top + ih, r1 = ih == h - 1 ? ho - 1 : top + ih;
      const int q0 = iw == 0 ? 0 : left + iw, q1 = iw == w - 1 ? wo - 1 : left + iw;
      for (int a = r0; a <= r1; ++a)
        for (int b = q0; b <= q1; ++b) add_at<T, N>(dys + (a * wo + b) * c + ch, acc);
    }
  };
  auto element = [&](int e) {  // the sum of element e of the band
    const int pixel = e / c, r = pixel / w;
    float acc[1] = {0.f};
    gather(i0 + r, pixel - r * w, e - pixel * c, acc);
    return acc[0];
  };
  for (int e = threadIdx.x; e < head + elems - tail; e += blockDim.x) {
    const int at = e < head ? e : tail + e - head;
    float v[1] = {element(at)};
    Pack<T, 1>::store(dxs + at, v);
  }
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const int e = head + k * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    if (PACKED) {
      const int pixel = e / c, r = pixel / w;
      gather(i0 + r, pixel - r * w, e - pixel * c, acc);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = element(e + i);
    }
    Pack<T, VEC>::store(dxs + e, acc);
  }
}

// ---------------------------------------------------------------- word kernels

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

// ---------------------------------------------------------------- host side

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
  // a sample's elements are addressed with 32-bit indices
  if (static_cast<long long>(h + top + bottom) * (w + left + right) * c > 2147483647LL)
    return false;
  return true;
}

inline int grid_of(long long total, unsigned* blocks) {
  const long long b = (total + kPadThreads - 1) / kPadThreads;
  if (b < 1 || b > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return 0;
}

template <typename W>
int launch_fwd(const void* x, void* y, int n, int h, int w, int pixel_bytes, int top, int bottom,
               int left, int right, int mode, int rows, int threads, cudaStream_t s) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const int pw = pixel_bytes / static_cast<int>(sizeof(W));
  const int ho = h + top + bottom, wo = w + left + right;
  if (rows == 0) {  // the word kernel
    const long long total = static_cast<long long>(n) * ho * wo * pw;
    unsigned blocks;
    if (grid_of(total, &blocks) != 0) return invalid;
    pad2d_fwd_kernel<W><<<blocks, kPadThreads, 0, s>>>(
        static_cast<const W*>(x), static_cast<W*>(y), total, h, w, ho, wo, pw, top, left, mode == 0);
    return static_cast<int>(cudaGetLastError());
  }
  const long long table = 4LL * wo * pw;
  const long long blocks = static_cast<long long>(n) * ((ho + rows - 1) / rows);
  if (threads < 32 || threads > kBandThreadsMax || threads % 32 || table > kTableBytesMax ||
      blocks > 2147483647LL)
    return invalid;
  pad2d_band_fwd_kernel<W><<<static_cast<unsigned>(blocks), threads, table, s>>>(
      static_cast<const W*>(x), static_cast<W*>(y), h, w, pw, top, bottom, left, right, rows,
      (ho + rows - 1) / rows, mode == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd(const void* dy, void* dx, int n, int h, int w, int c, int top, int bottom,
               int left, int right, int mode, int rows, int threads, cudaStream_t s) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const bool reflect = mode == 0;
  if (rows == 0) {  // the word kernel
    const long long total = static_cast<long long>(n) * h * w * (c / VEC);
    unsigned blocks;
    if (grid_of(total, &blocks) != 0) return invalid;
    if (reflect)
      pad2d_bwd_kernel<T, VEC, true><<<blocks, kPadThreads, 0, s>>>(
          static_cast<const T*>(dy), static_cast<T*>(dx), total, h, w, c, top, bottom, left, right);
    else
      pad2d_bwd_kernel<T, VEC, false><<<blocks, kPadThreads, 0, s>>>(
          static_cast<const T*>(dy), static_cast<T*>(dx), total, h, w, c, top, bottom, left, right);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte chunk
  const long long blocks = static_cast<long long>(n) * ((h + rows - 1) / rows);
  if (threads < 32 || threads > kBandThreadsMax || threads % 32 || blocks > 2147483647LL)
    return invalid;
  const bool packed = VEC == kVec;  // a chunk is kVec channels of a pixel
  auto kernel = packed ? (reflect ? &pad2d_band_bwd_kernel<T, kVec, true, true>
                                  : &pad2d_band_bwd_kernel<T, kVec, true, false>)
                       : (reflect ? &pad2d_band_bwd_kernel<T, kVec, false, true>
                                  : &pad2d_band_bwd_kernel<T, kVec, false, false>);
  kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<T*>(dx), h, w, c, top, bottom, left, right, rows,
      (h + rows - 1) / rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, h, w, c) of `itemsize`-byte elements, contiguous; y: (n, h + top +
// bottom, w + left + right, c), contiguous.  mode: 0 = reflect, 1 =
// replicate.  rows: output rows a CTA takes (the band kernel), or 0 for the
// word kernel; threads: a band CTA's threads (ops/kernels/pad.py::pad_plan
// picks both).  Launches on `stream`, allocates nothing, does not
// synchronise.  Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int pad2d_fwd(const void* x, void* y, int n, int h, int w, int c, int itemsize,
                         int top, int bottom, int left, int right, int mode, int rows,
                         int threads, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!pads_ok(n, h, w, c, top, bottom, left, right, mode) || rows < 0) return invalid;
  if (x == nullptr || y == nullptr || itemsize < 2 || itemsize > 8) return invalid;
  if (static_cast<long long>(c) * itemsize > 2147483647LL) return invalid;
  const int pixel_bytes = c * itemsize;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fits = [&](unsigned bytes) {
    return pixel_bytes % bytes == 0 && aligned(x, bytes) && aligned(y, bytes);
  };
  if (fits(16))
    return launch_fwd<uint4>(x, y, n, h, w, pixel_bytes, top, bottom, left, right, mode, rows,
                             threads, s);
  if (fits(8))
    return launch_fwd<uint2>(x, y, n, h, w, pixel_bytes, top, bottom, left, right, mode, rows,
                             threads, s);
  if (fits(4))
    return launch_fwd<uint32_t>(x, y, n, h, w, pixel_bytes, top, bottom, left, right, mode, rows,
                                threads, s);
  if (fits(2))
    return launch_fwd<uint16_t>(x, y, n, h, w, pixel_bytes, top, bottom, left, right, mode, rows,
                                threads, s);
  return invalid;
}

// dy: (n, h + top + bottom, w + left + right, c), contiguous; dx: (n, h, w,
// c), contiguous, written whole.  dtype: 0 = float32, 1 = bfloat16.  mode,
// rows (input rows a CTA takes, or 0) and threads as above.  Same contract
// as pad2d_fwd.
extern "C" int pad2d_bwd(const void* dy, void* dx, int n, int h, int w, int c, int dtype,
                         int top, int bottom, int left, int right, int mode, int rows,
                         int threads, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!pads_ok(n, h, w, c, top, bottom, left, right, mode) || rows < 0) return invalid;
  if (dy == nullptr || dx == nullptr) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = aligned(dy, 16) && aligned(dx, 16);
  if (dtype == 0) {
    if (wide && c % 4 == 0)
      return launch_bwd<float, 4>(dy, dx, n, h, w, c, top, bottom, left, right, mode, rows,
                                  threads, s);
    return launch_bwd<float, 1>(dy, dx, n, h, w, c, top, bottom, left, right, mode, rows,
                                threads, s);
  }
  if (dtype == 1) {
    if (wide && c % 8 == 0)
      return launch_bwd<__nv_bfloat16, 8>(dy, dx, n, h, w, c, top, bottom, left, right, mode,
                                          rows, threads, s);
    return launch_bwd<__nv_bfloat16, 1>(dy, dx, n, h, w, c, top, bottom, left, right, mode, rows,
                                        threads, s);
  }
  return invalid;
}
