// U-Net sigmoid head: p[b,h,w] = sigmoid(sum_c x[b,h,w,c] * w[c] + bias).
//
// Replaces the TPU kernel `diff_sigmoid_head` (body `_head_kernel`) in
// adipose_tpu/ops/pallas/unet_kernels.py, forward only. The main head feeds it
// the tap difference of the two-class 1x1 conv (softmax(l0, l1)[1] ==
// sigmoid(l1 - l0)); the deep-supervision heads feed it their 1x1 conv taps.
//
// What bounds it on Hopper: device memory. At the main path's shape
// (16 x 1024^2 pixels x 44 bf16 channels) it reads 1.5 GB and writes 64 MB
// for 2 operations per element read.
//
// What the design does about that:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
