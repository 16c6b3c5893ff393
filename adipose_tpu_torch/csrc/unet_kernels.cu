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
// dw[c] = sum x * dlogit and dbias = sum dlogit in f32. Its launch plan is
// made on the host (ops/cuda/unet_kernels.py:head_bwd_plan).
//   * The period path. x is read straight into registers as 16-byte vectors
//     of V = 16 / sizeof(T) elements, with no staging in shared memory. The
//     channels repeat every P = C / gcd(C, V) vectors (P = 11 at C = 44, bf16
//     or f32), so a block of a multiple of P threads whose grid stride is a
//     multiple of P gives each thread the same V channels in every vector it
//     visits: it keeps their taps and V f32 partial sums of dw in registers
//     for the whole grid-stride loop, and knows once for all which of its
//     elements fall in the vector's second pixel (V <= C + 1, so a vector
//     spans at most two) and which are channel 0, whose thread adds the
//     pixel's dlogit to dbias. Per vector: one 16-byte load of x, the g and p
//     of at most two pixels (their neighbours' threads read the same lines,
//     which L1 serves), one 16-byte store of dx; no division, no barrier.
//     Each thread issues kBwdUnroll vectors' loads before it computes them.
//     The last period, when the pixel count ends inside one, is done element
//     by element.
//   * The general path, for a C whose period has a least common multiple
//     with 32 above 1024 (no block holds a whole number of periods and
//     warps), a C smaller than V - 1, or an x not 16-byte aligned: one thread
//     per column (C channels and dbias) and pixel lane, scalar loads and
//     stores.
//   * dw and dbias: each block folds its threads' partial sums by column in
//     shared memory in a fixed order (dbias through a fixed warp-shuffle
//     tree) and writes one row of a (blocks, C + 1) buffer; a second kernel
//     sums each column of that buffer in a fixed tree. No atomics, and the
//     grid depends only on the shape and the card, so two runs give the same
//     bits.

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


// The most blocks of a backward launch: the rows of its partial buffer.
constexpr int kBwdMaxBlocks = 1024;
constexpr int kFinalizeThreads = 256;
constexpr int kBwdUnroll = 4;

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dlogit(float g, float p) {
  return __fmul_rn(__fmul_rn(g, p), __fsub_rn(1.f, p));
}

// One 16-byte vector of the period path: dx stored, dw and dbias summed.
// Element u belongs to the vector's second pixel where bit u of `second` is
// set, and is channel 0 where bit u of `zero` is.
template <typename T, int V>
__device__ __forceinline__ void head_bwd_vector(const uint4& xin, float dla, float dlb,
                                                unsigned second, unsigned zero,
                                                const float (&wf)[V], float (&acc)[V],
                                                float& db, uint4* dst) {
  const T* xe = reinterpret_cast<const T*>(&xin);
  __align__(16) T out[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float dl = (second >> u) & 1u ? dlb : dla;
    from_f32(__fmul_rn(dl, wf[u]), &out[u]);
    acc[u] = fmaf(to_f32(xe[u]), dl, acc[u]);
    if ((zero >> u) & 1u) db = __fadd_rn(db, dl);
  }
  __stcs(dst, *reinterpret_cast<const uint4*>(out));
}

// The period path; blockDim.x is a multiple of 32 and of `period`. Shared
// memory: blockDim.x * V floats for the dw partials, then one float a warp.
template <typename T>
__global__ void __launch_bounds__(1024) head_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ g,
    const float* __restrict__ p, T* __restrict__ dx, float* __restrict__ partial,
    long long npix, int channels, int period) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float red[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % period;          // the same in every block: nthreads % period == 0
  const int ppp = period * V / channels;  // pixels per period
  const int k0 = lane * V / channels;     // the pixel, within a period, of the first element

  float wf[V], acc[V];
  unsigned second = 0, zero = 0;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int e = lane * V + u, c = e % channels;
    wf[u] = to_f32(w[c]);
    acc[u] = 0.f;
    if (e / channels != k0) second |= 1u << u;
    if (c == 0) zero |= 1u << u;
  }
  float db = 0.f;

  const long long total = npix * channels;
  const long long nfull = total / (static_cast<long long>(period) * V);  // whole periods
  const long long qstride = static_cast<long long>(gridDim.x) * nthreads / period;
  long long q = (static_cast<long long>(blockIdx.x) * nthreads + tid) / period;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ dv = reinterpret_cast<uint4*>(dx);

  for (; q + (kBwdUnroll - 1) * qstride < nfull; q += kBwdUnroll * qstride) {
    uint4 xin[kBwdUnroll];
    float dla[kBwdUnroll], dlb[kBwdUnroll];
#pragma unroll
    for (int r = 0; r < kBwdUnroll; ++r) {
      const long long qr = q + r * qstride, pix = qr * ppp + k0;
      xin[r] = __ldcs(xv + qr * period + lane);
      dla[r] = dlogit(g[pix], p[pix]);
      dlb[r] = second ? dlogit(g[pix + 1], p[pix + 1]) : dla[r];
    }
#pragma unroll
    for (int r = 0; r < kBwdUnroll; ++r) {
      head_bwd_vector<T, V>(xin[r], dla[r], dlb[r], second, zero, wf, acc, db,
                            dv + (q + r * qstride) * period + lane);
    }
  }
  for (; q < nfull; q += qstride) {
    const long long pix = q * ppp + k0;
    const float dla = dlogit(g[pix], p[pix]);
    const float dlb = second ? dlogit(g[pix + 1], p[pix + 1]) : dla;
    head_bwd_vector<T, V>(__ldcs(xv + q * period + lane), dla, dlb, second, zero, wf, acc, db,
                          dv + q * period + lane);
  }
  if (q == nfull) {  // the pixel count may end inside this period: element by element
    const long long v = q * period + lane;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const long long e = v * V + u;
      if (e < total) {
        const long long pix = q * ppp + k0 + ((second >> u) & 1u);
        const float dl = dlogit(g[pix], p[pix]);
        from_f32(__fmul_rn(dl, wf[u]), &dx[e]);
        acc[u] = fmaf(to_f32(x[e]), dl, acc[u]);
        if ((zero >> u) & 1u) db = __fadd_rn(db, dl);
      }
    }
  }

  // Fold. Thread t = s * period + lane keeps element u's sum at red[t * V +
  // u] = red[s * period * V + e], where e = lane * V + u is the element's
  // place within a period and e % C its channel.
#pragma unroll
  for (int u = 0; u < V; ++u) red[tid * V + u] = acc[u];
  for (int off = 16; off > 0; off >>= 1) {
    db = __fadd_rn(db, __shfl_xor_sync(0xffffffffu, db, off));
  }
  float* warp_db = red + nthreads * V;
  if (tid % 32 == 0) warp_db[tid / 32] = db;
  __syncthreads();
  const int ncols = channels + 1, span = period * V;
  for (int c = tid; c < ncols; c += nthreads) {
    float sum = 0.f;
    if (c < channels) {
      for (int s = 0; s < nthreads / period; ++s) {
        for (int e = c; e < span; e += channels) sum = __fadd_rn(sum, red[s * span + e]);
      }
    } else {
      for (int wi = 0; wi < nthreads / 32; ++wi) sum = __fadd_rn(sum, warp_db[wi]);
    }
    partial[static_cast<long long>(blockIdx.x) * ncols + c] = sum;
  }
}

// The general path: thread (tx, ty) takes column c0 + tx (channel c, or
// dbias at c == C) over the pixels ty, ty + blockDim.y, ... of the block's
// share. Shared memory: blockDim.x * blockDim.y floats.
template <typename T>
__global__ void __launch_bounds__(1024) head_bwd_kernel_general(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ g,
    const float* __restrict__ p, T* __restrict__ dx, float* __restrict__ partial,
    long long npix, int channels) {
  extern __shared__ float red[];
  const int tx = threadIdx.x, ty = threadIdx.y, kx = blockDim.x, ky = blockDim.y;
  const int ncols = channels + 1;
  const long long pstride = static_cast<long long>(gridDim.x) * ky;
  for (int c0 = 0; c0 < ncols; c0 += kx) {
    const int c = c0 + tx;
    float acc = 0.f;
    if (c < ncols) {
      const float wc = c < channels ? to_f32(w[c]) : 0.f;
      for (long long pix = static_cast<long long>(blockIdx.x) * ky + ty; pix < npix;
           pix += pstride) {
        const float dl = dlogit(g[pix], p[pix]);
        if (c < channels) {
          const long long e = pix * channels + c;
          from_f32(__fmul_rn(dl, wc), &dx[e]);
          acc = fmaf(to_f32(x[e]), dl, acc);
        } else {
          acc = __fadd_rn(acc, dl);
        }
      }
    }
    red[ty * kx + tx] = acc;
    __syncthreads();
    if (ty == 0 && c < ncols) {
      float sum = 0.f;
      for (int y = 0; y < ky; ++y) sum = __fadd_rn(sum, red[y * kx + tx]);
      partial[static_cast<long long>(blockIdx.x) * ncols + c] = sum;
    }
    __syncthreads();
  }
}

// One block per column of the (blocks, C + 1) partials: a strided sum per
// thread, then a fixed tree over the threads.
template <typename T>
__global__ void head_bwd_finalize(const float* __restrict__ partial, int nblocks, int channels,
                                  T* __restrict__ dw, float* __restrict__ dbias) {
  __shared__ float s[kFinalizeThreads];
  const int c = blockIdx.x, ncols = channels + 1, tid = threadIdx.x;
  float sum = 0.f;
  for (int r = tid; r < nblocks; r += kFinalizeThreads) {
    sum = __fadd_rn(sum, partial[static_cast<long long>(r) * ncols + c]);
  }
  s[tid] = sum;
  __syncthreads();
  for (int stride = kFinalizeThreads / 2; stride > 0; stride >>= 1) {
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

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// As many blocks as fit on the card at once, and no more than the work needs
// or the partial buffer holds.
template <typename K>
cudaError_t persistent_blocks(int device, K kernel, int threads, size_t smem, long long work,
                              int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = std::min(static_cast<long long>(sms) * per_sm,
                                 static_cast<long long>(kBwdMaxBlocks));
  *blocks = static_cast<int>(std::max(1LL, std::min(fit, work)));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(int device, const void* x, const void* w, const float* g, const float* p,
                       void* dx, float* partial, void* dw, float* dbias, long long npix,
                       int channels, int period, int block_x, int block_y, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* dxt = static_cast<T*>(dx);
  if (block_x <= 0 || block_y <= 0 || block_x % 32 != 0 || block_x * block_y > 1024) {
    return cudaErrorInvalidValue;
  }
  int blocks = 0;
  cudaError_t err;
  if (period > 0) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dx)) % 16) == 0;
    if (period != channels / gcd(channels, V) || V > channels + 1 ||
        block_y != 1 || block_x % period != 0 || !aligned) {
      return cudaErrorInvalidValue;
    }
    const int ppp = period * V / channels;
    const long long periods = (npix + ppp - 1) / ppp;
    const size_t smem = sizeof(float) * (block_x * V + block_x / 32);
    err = persistent_blocks(device, head_bwd_kernel<T>, block_x, smem,
                            (periods * period + block_x - 1) / block_x, &blocks);
    if (err != cudaSuccess) return err;
    head_bwd_kernel<T><<<blocks, block_x, smem, stream>>>(xt, wt, g, p, dxt, partial, npix,
                                                           channels, period);
  } else {
    const size_t smem = sizeof(float) * block_x * block_y;
    err = persistent_blocks(device, head_bwd_kernel_general<T>, block_x * block_y, smem,
                            (npix + block_y - 1) / block_y, &blocks);
    if (err != cudaSuccess) return err;
    head_bwd_kernel_general<T><<<blocks, dim3(block_x, block_y), smem, stream>>>(
        xt, wt, g, p, dxt, partial, npix, channels);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_bwd_finalize<T><<<channels + 1, kFinalizeThreads, 0, stream>>>(
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
// kernel uses at most 1024 rows. period, block_x, block_y: the launch plan
// (ops/cuda/unet_kernels.py:head_bwd_plan), period 0 for the general path.
// Returns a cudaError_t.
int adipose_sigmoid_head_bwd(int device, const void* x, int x_bf16, const void* w,
                             const void* g, const void* p, void* dx, void* partial,
                             int partial_rows, void* dw, void* dbias, long long npix,
                             int channels, int period, int block_x, int block_y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (npix <= 0 || channels <= 0 || partial_rows < kBwdMaxBlocks) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* pf = static_cast<const float*>(p);
  float* part = static_cast<float*>(partial);
  float* db = static_cast<float*>(dbias);
  err = x_bf16 ? launch_bwd<__nv_bfloat16>(device, x, w, gf, pf, dx, part, dw, db, npix,
                                           channels, period, block_x, block_y, s)
               : launch_bwd<float>(device, x, w, gf, pf, dx, part, dw, db, npix, channels,
                                   period, block_x, block_y, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
