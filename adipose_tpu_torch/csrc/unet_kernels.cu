// U-Net sigmoid head: p[b,h,w] = sigmoid(sum_c x[b,h,w,c] * w[c] + bias), and
// its backward.
//
// Replaces the TPU kernel `diff_sigmoid_head` (body `_head_kernel`) and its
// custom VJP `diff_sigmoid_head_vjp` (`_head_bwd`) in
// adipose_tpu/ops/pallas/unet_kernels.py. The main head feeds it the tap
// difference of the two-class 1x1 conv (softmax(l0, l1)[1] ==
// sigmoid(l1 - l0)); the deep-supervision heads feed it their 1x1 conv taps.
//
// What bounds both on Hopper: device memory. At the main path's shape
// (16 x 1024^2 pixels x 44 bf16 channels) the forward reads 1.5 GB and writes
// 64 MB for 2 operations per element read. The backward at the training
// path's main head (2 x 1024^2 pixels x 44 bf16) reads x (185 MB), g and p
// (17 MB) and writes dx (185 MB), for 2 operations per element.
//
// What the forward's design does about that:
//   * x is channels-last, so one block's pixels are one contiguous span of
//     device memory. The block copies that span into shared memory with
//     coalesced 16-byte loads, then each thread reduces its own pixel from
//     shared memory. C need not be a multiple of anything (44 at full width):
//     there is no lane padding to read.
//   * Products are taken in f32 from exact upcasts (a bf16 x bf16 product is
//     exact in f32) and summed in f32 in channel order; the sigmoid is
//     1 / (1 + expf(-z)) with IEEE expf (no fast math), as torch.sigmoid.
//   * The pixels per block shrink with C so the span stays within 48 KB of
//     shared memory: 256 pixels at C = 44 bf16.
//
// The backward, per pixel: dlogit = g * p * (1 - p) in f32 (the _rn
// intrinsics keep nvcc from contracting it into an FMA, so it is the plain
// version's bits); dx[pixel, :] = dlogit * w[:] rounded once to x's dtype;
// dw[c] = sum x * dlogit and dbias = sum dlogit in f32.
//   * A block walks spans of pixels as the forward does: the x span is staged
//     in shared memory with 16-byte loads, dx is written as the same
//     contiguous span with 16-byte stores.
//   * dw and dbias: the block's threads split the span's pixels into a fixed
//     number of interleaved groups per column, add the groups in order into a
//     per-block f32 partial, and write it to a (blocks, C + 1) buffer; a
//     second kernel sums each column of that buffer in a fixed tree. The
//     grid depends only on the shape, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr size_t kMaxSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void head_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ bias, float* __restrict__ out,
                            long long npix, int channels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pix_per_block = blockDim.x;
  T* span = reinterpret_cast<T*>(smem);
  float* wf = reinterpret_cast<float*>(smem + sizeof(T) * pix_per_block * channels);

  for (int c = threadIdx.x; c < channels; c += pix_per_block) wf[c] = to_f32(w[c]);

  const long long p0 = static_cast<long long>(blockIdx.x) * pix_per_block;
  const int np = static_cast<int>(min(static_cast<long long>(pix_per_block), npix - p0));
  const T* src = x + p0 * channels;
  const long long nelem = static_cast<long long>(np) * channels;
  const long long nbytes = nelem * static_cast<long long>(sizeof(T));
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && nbytes % 16 == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(span);
    for (long long i = threadIdx.x; i < nbytes / 16; i += pix_per_block) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < nelem; i += pix_per_block) span[i] = src[i];
  }
  __syncthreads();

  if (threadIdx.x < np) {
    const T* px = span + static_cast<long long>(threadIdx.x) * channels;
    float acc = 0.f;
    for (int c = 0; c < channels; ++c) acc += to_f32(px[c]) * wf[c];
    out[p0 + threadIdx.x] = 1.f / (1.f + expf(-(acc + *bias)));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias, float* out,
                   long long npix, int channels, cudaStream_t stream) {
  int pix = 256;
  auto smem = [&](int p) { return sizeof(T) * p * channels + sizeof(float) * channels; };
  while (pix > 32 && smem(pix) > kMaxSmem) pix >>= 1;
  if (smem(pix) > kMaxSmem) return cudaErrorInvalidValue;
  const long long blocks = (npix + pix - 1) / pix;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  head_kernel<T><<<static_cast<unsigned>(blocks), pix, smem(pix), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, out, npix, channels);
  return cudaSuccess;
}


constexpr int kBwdThreads = 256;
constexpr int kBwdMaxBlocks = 1024;

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// Shared memory of the backward: the x span, then f32 dlogit[pix], w[C],
// acc[C + 1] and the group sums red[max(threads, C + 1)].
template <typename T>
size_t bwd_smem(int pix, int channels) {
  const int ncols = channels + 1;
  return sizeof(T) * pix * channels +
         sizeof(float) * (pix + channels + ncols + std::max(kBwdThreads, ncols));
}

template <typename T>
__global__ void head_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                const float* __restrict__ g, const float* __restrict__ p,
                                T* __restrict__ dx, float* __restrict__ partial,
                                long long npix, int channels, int pix_per_span) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncols = channels + 1;
  T* span = reinterpret_cast<T*>(smem);
  float* dl = reinterpret_cast<float*>(smem + sizeof(T) * pix_per_span * channels);
  float* wf = dl + pix_per_span;
  float* acc = wf + channels;
  float* red = acc + ncols;
  const int tid = threadIdx.x;
  // Column sums: `groups` interleaved subsets of a span's pixels per column.
  const int groups = max(1, kBwdThreads / ncols);

  for (int c = tid; c < channels; c += kBwdThreads) wf[c] = to_f32(w[c]);
  for (int c = tid; c < ncols; c += kBwdThreads) acc[c] = 0.f;

  const long long nspans = (npix + pix_per_span - 1) / pix_per_span;
  for (long long s = blockIdx.x; s < nspans; s += gridDim.x) {
    const long long p0 = s * pix_per_span;
    const int np = static_cast<int>(min(static_cast<long long>(pix_per_span), npix - p0));
    const long long nelem = static_cast<long long>(np) * channels;
    const long long nbytes = nelem * static_cast<long long>(sizeof(T));
    const T* src = x + p0 * channels;
    T* out = dx + p0 * channels;
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && nbytes % 16 == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(span);
      for (long long i = tid; i < nbytes / 16; i += kBwdThreads) d4[i] = s4[i];
    } else {
      for (long long i = tid; i < nelem; i += kBwdThreads) span[i] = src[i];
    }
    for (int k = tid; k < np; k += kBwdThreads) {
      const float pk = p[p0 + k];
      dl[k] = __fmul_rn(__fmul_rn(g[p0 + k], pk), __fsub_rn(1.f, pk));
    }
    __syncthreads();

    // dx: the same contiguous span, 16 bytes a thread where aligned.
    constexpr int kVec = 16 / sizeof(T);
    if (reinterpret_cast<uintptr_t>(out) % 16 == 0 && nbytes % 16 == 0) {
      for (long long v = tid; v < nelem / kVec; v += kBwdThreads) {
        __align__(16) T vals[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const long long e = v * kVec + u;
          from_f32(__fmul_rn(dl[e / channels], wf[e % channels]), &vals[u]);
        }
        reinterpret_cast<uint4*>(out)[v] = *reinterpret_cast<const uint4*>(vals);
      }
    } else {
      for (long long e = tid; e < nelem; e += kBwdThreads) {
        from_f32(__fmul_rn(dl[e / channels], wf[e % channels]), &out[e]);
      }
    }

    // Partial dw (columns < C) and dbias (column C) of this span.
    for (int item = tid; item < groups * ncols; item += kBwdThreads) {
      const int c = item % ncols, grp = item / ncols;
      float sum = 0.f;
      if (c < channels) {
        for (int k = grp; k < np; k += groups) {
          sum = __fadd_rn(sum, __fmul_rn(to_f32(span[static_cast<long long>(k) * channels + c]),
                                         dl[k]));
        }
      } else {
        for (int k = grp; k < np; k += groups) sum = __fadd_rn(sum, dl[k]);
      }
      red[item] = sum;
    }
    __syncthreads();
    for (int c = tid; c < ncols; c += kBwdThreads) {
      float sum = acc[c];
      for (int grp = 0; grp < groups; ++grp) sum = __fadd_rn(sum, red[grp * ncols + c]);
      acc[c] = sum;
    }
    __syncthreads();  // the next span overwrites span, dl and red
  }
  for (int c = tid; c < ncols; c += kBwdThreads) {
    partial[static_cast<long long>(blockIdx.x) * ncols + c] = acc[c];
  }
}

// One block per column of the (blocks, C + 1) partials: a strided sum per
// thread, then a fixed tree over the threads.
template <typename T>
__global__ void head_bwd_finalize(const float* __restrict__ partial, int nblocks, int channels,
                                  T* __restrict__ dw, float* __restrict__ dbias) {
  __shared__ float s[kBwdThreads];
  const int c = blockIdx.x, ncols = channels + 1, tid = threadIdx.x;
  float sum = 0.f;
  for (int r = tid; r < nblocks; r += kBwdThreads) {
    sum = __fadd_rn(sum, partial[static_cast<long long>(r) * ncols + c]);
  }
  s[tid] = sum;
  __syncthreads();
  for (int stride = kBwdThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) s[tid] = __fadd_rn(s[tid], s[tid + stride]);
    __syncthreads();
  }
  if (tid == 0) {
    if (c < channels) {
      from_f32(s[0], &dw[c]);
    } else {
      *dbias = s[0];
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const float* g, const float* p, void* dx,
                       float* partial, void* dw, float* dbias, long long npix, int channels,
                       cudaStream_t stream) {
  int pix = 256;
  while (pix > 32 && bwd_smem<T>(pix, channels) > kMaxSmem) pix >>= 1;
  if (bwd_smem<T>(pix, channels) > kMaxSmem) return cudaErrorInvalidValue;
  const long long nspans = (npix + pix - 1) / pix;
  const int blocks = static_cast<int>(std::min(nspans, static_cast<long long>(kBwdMaxBlocks)));
  head_bwd_kernel<T><<<blocks, kBwdThreads, bwd_smem<T>(pix, channels), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), g, p, static_cast<T*>(dx), partial,
      npix, channels, pix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_bwd_finalize<T><<<channels + 1, kBwdThreads, 0, stream>>>(
      partial, blocks, channels, static_cast<T*>(dw), dbias);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x: (npix, channels) bf16 (x_bf16) or float32, contiguous (a channels-last
// NCHW tensor). w: (channels,) in x's dtype. bias: one float32 on the device.
// out: (npix,) float32. Returns a cudaError_t.
int adipose_sigmoid_head(int device, const void* x, int x_bf16, const void* w, const void* bias,
                         void* out, long long npix, int channels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (npix <= 0 || channels <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  err = x_bf16 ? launch<__nv_bfloat16>(x, w, b, o, npix, channels, s)
               : launch<float>(x, w, b, o, npix, channels, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The backward of adipose_sigmoid_head. x: (npix, channels) in x's dtype
// (x_bf16), contiguous; w: (channels,) in x's dtype; g, p: (npix,) float32.
// dx: (npix, channels) in x's dtype; dw: (channels,) in x's dtype; dbias: one
// float32. partial: float32 scratch of partial_rows x (channels + 1); the
// kernel uses at most 1024 rows. Returns a cudaError_t.
int adipose_sigmoid_head_bwd(int device, const void* x, int x_bf16, const void* w,
                             const void* g, const void* p, void* dx, void* partial,
                             int partial_rows, void* dw, void* dbias, long long npix,
                             int channels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (npix <= 0 || channels <= 0 || partial_rows < kBwdMaxBlocks) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* pf = static_cast<const float*>(p);
  float* part = static_cast<float*>(partial);
  float* db = static_cast<float*>(dbias);
  err = x_bf16 ? launch_bwd<__nv_bfloat16>(x, w, gf, pf, dx, part, dw, db, npix, channels, s)
               : launch_bwd<float>(x, w, gf, pf, dx, part, dw, db, npix, channels, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
