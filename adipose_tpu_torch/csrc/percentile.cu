// Exact per-tile percentile stretch of uint8-valued tiles to [0, 1].
//
// Replaces the TPU kernel `percentile_normalize_u8` (body `_percentile_kernel`)
// in adipose_tpu/ops/pallas/preprocess.py. For each (H, W) tile:
//   hist      256-bin histogram of the (rounded) pixel values
//   v(k)      = sum_b [cdf[b] <= k], the value at sorted index k
//   low/high  numpy-'linear' p_low/p_high: v(r) + frac * (v(r + 1) - v(r))
//   out       clip((x - low) / max(high - low, 1e-3), 0, 1), float32
//
// What bounds it on Hopper: device memory. It does a few operations per
// pixel; its floor is reading the input once and writing the f32 output once.
//
// What the design does about that:
//   * The TPU kernel keeps one whole tile in VMEM per grid step and loops 256
//     times over it. Here a 2-D grid (chunks of a tile x batch) gives every SM
//     work at batch 16: each block builds a 256-bin histogram of its chunk in
//     shared memory with integer atomics and adds its non-zero bins into a
//     (batch, 256) int32 buffer. Counts are exact and independent of order.
//   * One block per tile scans the 256 bins and counts, with
//     __syncthreads_count, the bins whose cumulative count is <= each rank.
//     low and scale go to a (batch, 2) device buffer: the host never waits.
//   * The apply pass reads the input a second time (it is 4x smaller than the
//     f32 output). Each thread takes four neighbouring pixels a step and
//     writes them as one float4, so a warp's stores cover one contiguous
//     512-byte span; the histogram pass loads 16 bytes a thread.
//   * Float input is rounded half to even (rintf, as jnp.round) before it is
//     binned and stretched; values that round outside [0, 255] fall in no bin,
//     as in the TPU kernel. The _rn intrinsics keep nvcc from contracting the
//     interpolation into an FMA, so the result is bit-equal to the plain
//     PyTorch version's separate f32 operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;  // elements of one tile per block

__device__ __forceinline__ float rounded(unsigned char v) { return static_cast<float>(v); }
__device__ __forceinline__ float rounded(float v) { return rintf(v); }

template <typename TIn> struct InTraits;
template <> struct InTraits<unsigned char> { static constexpr int kVec = 16; };
template <> struct InTraits<float> { static constexpr int kVec = 4; };

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const TIn* __restrict__ x, int* __restrict__ hist, long long n, int vec) {
  constexpr int kVec = InTraits<TIn>::kVec;
  __shared__ int h[256];
  h[threadIdx.x] = 0;
  __syncthreads();

  const long long tile = blockIdx.y;
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(start + kChunk, n);
  const TIn* xt = x + tile * n;
  auto bin = [&](TIn v) {
    const float r = rounded(v);
    if (r >= 0.f && r <= 255.f) atomicAdd(&h[static_cast<int>(r)], 1);
  };
  if (vec) {
    for (long long i = start + threadIdx.x * kVec; i < end; i += kThreads * kVec) {
      alignas(16) TIn in[kVec];
      *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(xt + i);
#pragma unroll
      for (int j = 0; j < kVec; ++j) bin(in[j]);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads) bin(xt[i]);
  }
  __syncthreads();
  const int c = h[threadIdx.x];
  if (c) atomicAdd(hist + tile * 256 + threadIdx.x, c);
}

// One block of 256 threads per tile: inclusive scan of the histogram, then the
// four order statistics and the stretch's (low, scale).
__global__ void __launch_bounds__(256)
percentile_kernel(const int* __restrict__ hist, float* __restrict__ low_scale,
                  float rank_lo, float frac_lo, float rank_hi, float frac_hi) {
  __shared__ int warp_total[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cum = hist[blockIdx.x * 256 + threadIdx.x];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, cum, o);
    if (lane >= o) cum += up;
  }
  if (lane == 31) warp_total[warp] = cum;
  __syncthreads();
  for (int w = 0; w < warp; ++w) cum += warp_total[w];

  // Counts and ranks compare in double: exact for any tile size (the TPU
  // kernel's f32 cumulative sum is exact below 2^24 pixels, where the two agree).
  const double c = static_cast<double>(cum);
  const float vl_lo = static_cast<float>(__syncthreads_count(c <= rank_lo));
  const float vh_lo = static_cast<float>(__syncthreads_count(c <= __fadd_rn(rank_lo, 1.f)));
  const float vl_hi = static_cast<float>(__syncthreads_count(c <= rank_hi));
  const float vh_hi = static_cast<float>(__syncthreads_count(c <= __fadd_rn(rank_hi, 1.f)));
  if (threadIdx.x == 0) {
    const float low = __fadd_rn(vl_lo, __fmul_rn(frac_lo, __fsub_rn(vh_lo, vl_lo)));
    const float high = __fadd_rn(vl_hi, __fmul_rn(frac_hi, __fsub_rn(vh_hi, vl_hi)));
    low_scale[2 * blockIdx.x] = low;
    low_scale[2 * blockIdx.x + 1] = fmaxf(__fsub_rn(high, low), 1e-3f);
  }
}

__device__ __forceinline__ float stretch(float r, float low, float scale) {
  const float q = __fdiv_rn(__fsub_rn(r, low), scale);  // IEEE division
  return q < 0.f ? 0.f : (q > 1.f ? 1.f : q);  // NaN passes, as torch.clamp
}

template <typename TIn> struct Quad;  // four pixels in one load
template <> struct Quad<unsigned char> { using T = uchar4; };
template <> struct Quad<float> { using T = float4; };

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const TIn* __restrict__ x, const float* __restrict__ low_scale,
             float* __restrict__ out, long long n, int vec) {
  const long long tile = blockIdx.y;
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(start + kChunk, n);
  const TIn* xt = x + tile * n;
  float* ot = out + tile * n;
  const float low = low_scale[2 * tile], scale = low_scale[2 * tile + 1];
  if (vec) {
    using Q = typename Quad<TIn>::T;
    const Q* xq = reinterpret_cast<const Q*>(xt);
    float4* oq = reinterpret_cast<float4*>(ot);
#pragma unroll 4
    for (long long i = start / 4 + threadIdx.x; i < end / 4; i += kThreads) {
      const Q v = xq[i];
      oq[i] = make_float4(stretch(rounded(v.x), low, scale), stretch(rounded(v.y), low, scale),
                          stretch(rounded(v.z), low, scale), stretch(rounded(v.w), low, scale));
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads)
      ot[i] = stretch(rounded(xt[i]), low, scale);
  }
}

template <typename TIn>
cudaError_t launch(const void* x, int* hist, float* low_scale, float* out, int batch,
                   long long n, float rank_lo, float frac_lo, float rank_hi, float frac_hi,
                   cudaStream_t stream) {
  constexpr int kVec = InTraits<TIn>::kVec;
  const int vec = n % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((n + kChunk - 1) / kChunk), batch);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * 256 * batch, stream);
  if (err != cudaSuccess) return err;
  const TIn* xin = static_cast<const TIn*>(x);
  hist_kernel<TIn><<<grid, kThreads, 0, stream>>>(xin, hist, n, vec);
  percentile_kernel<<<batch, 256, 0, stream>>>(hist, low_scale, rank_lo, frac_lo, rank_hi,
                                               frac_hi);
  apply_kernel<TIn><<<grid, kThreads, 0, stream>>>(xin, low_scale, out, n, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (batch, n) uint8 (in_u8) or float32, contiguous. hist: (batch, 256)
// int32 scratch. low_scale: (batch, 2) float32, written. out: (batch, n)
// float32. rank_* = floor(p / 100 * (n - 1)) and frac_* its fraction, both
// computed in double and rounded to float32. Returns a cudaError_t.
int adipose_percentile(int device, const void* x, int in_u8, void* hist, void* low_scale,
                       void* out, int batch, long long n, float rank_lo, float frac_lo,
                       float rank_hi, float frac_hi, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || batch > 65535 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* h = static_cast<int*>(hist);
  float* ls = static_cast<float*>(low_scale);
  float* o = static_cast<float*>(out);
  if (in_u8)
    return launch<unsigned char>(x, h, ls, o, batch, n, rank_lo, frac_lo, rank_hi, frac_hi, s);
  return launch<float>(x, h, ls, o, batch, n, rank_lo, frac_lo, rank_hi, frac_hi, s);
}

}  // extern "C"
