// Identity copy of a 4-D bf16 tensor over its logical (H, W, B, C) index
// space:
//
//   out[h, w, b, c] = x[h, w, b, c]
//
// where x and out are laid out by the same strides, in elements, and C's
// stride is 1.
//
// Replaces the TPU kernel `pallas_ident_hwbc` (body `ident_kernel`) of
// scripts/exp_layout_probe.py: an identity with grid over H and blocks
// (1, W, B, C), put between two convs on the (H, W, B, C) view of a conv
// activation to ask whether a hand-written kernel can take the conv's own
// byte order. On the card the view is the permuted channels-last (B, C, H, W)
// activation that cuDNN writes and reads, strides (W*C, C, H*W*C, 1); the
// kernel reads and writes that byte order as it is.
//
// What bounds it on Hopper: device memory. It reads each element once and
// writes it once, with no arithmetic: at the probe's (1024, 1024, 16, 64) bf16
// that is 2 x 2.15 GB.
//
// What the design does about that:
//   * The launch plan is made on the host from the shape and the strides
//     (ops/cuda/layout.py:ident_plan): the dimensions are sorted by stride
//     and every dimension whose stride is the size times the stride of the
//     one inside it is folded into it, as PyTorch's TensorIterator folds
//     them. A dense tensor folds into one run of numel elements, whatever
//     its order: the probe's view (C, then W at stride C, H at W*C, B at
//     H*W*C) and a contiguous tensor alike. The run goes in 16-byte vectors
//     where both tensors start 16-byte aligned (the output, a fresh
//     allocation, always does), element by element where the input does
//     not (a view that starts inside a 16-byte line).
//   * One vector per thread, in a grid of 256-thread blocks that covers the
//     whole run: no loop, no division, no alignment test, neighbouring
//     threads on neighbouring addresses. The blocks start in order, so the
//     loads in flight at any moment lie in one window that slides along the
//     run. On an H100 (700 W) this matched cudaMemcpyAsync's device-to-device
//     copy at 2 GiB (1.4082 against 1.4109 ms, csrc/bench/ident_copy_bench.cu),
//     where persistent grids that stride over the run, with 2 to 8 vectors a
//     thread in flight or with TMA bulk copies through shared memory, took
//     1.45-1.51 ms. The loads and stores are streaming (evict-first):
//     nothing is read twice.
//   * The tail, fewer than one vector, goes to the first threads of block 0.
//   * Offsets are 64-bit: one probe tensor holds 2^30 elements, 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Vec holds V bf16 elements: 8 (uint4, 16 bytes) or 1.
template <typename Vec>
__global__ void __launch_bounds__(kThreads) ident_hwbc_kernel(
    const uint16_t* __restrict__ x, uint16_t* __restrict__ out, long long nvec, int tail) {
  constexpr int V = sizeof(Vec) / sizeof(uint16_t);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < nvec) {
    __stcs(reinterpret_cast<Vec*>(out) + i, __ldcs(reinterpret_cast<const Vec*>(x) + i));
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    const long long e = nvec * V + threadIdx.x;
    out[e] = x[e];
  }
}

template <typename Vec>
cudaError_t launch(const uint16_t* x, uint16_t* out, long long n, cudaStream_t stream) {
  constexpr int V = sizeof(Vec) / sizeof(uint16_t);
  const long long nvec = n / V;
  const long long blocks = nvec > 0 ? (nvec + kThreads - 1) / kThreads : 1;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ident_hwbc_kernel<Vec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, out, nvec, static_cast<int>(n % V));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: one run of n bf16 elements each, the span of a dense tensor and of
// its copy with the same strides (ops/cuda/layout.py:ident_plan). vec: bf16
// elements per load and store, 8 (both x and out 16-byte aligned) or 1.
// Returns a cudaError_t.
int adipose_layout_ident(int device, const void* x, void* out, long long n, int vec,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const uint16_t* xs = static_cast<const uint16_t*>(x);
  uint16_t* os = static_cast<uint16_t*>(out);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (n <= 0 || !(vec == 1 || (vec == 8 && aligned))) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 8 ? launch<uint4>(xs, os, n, s) : launch<unsigned short>(xs, os, n, s);
}

}  // extern "C"
