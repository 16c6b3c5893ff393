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
//   * One block per h, as the Pallas grid. The block walks its (W, B, C) slab
//     with whichever of W and B has the smaller stride as the inner dimension,
//     so that neighbouring threads touch neighbouring addresses for the
//     probe's view and for a contiguous (H, W, B, C) tensor alike. The
//     indexing follows the strides; it is never a flat memcpy.
//   * A thread copies an 8-element chunk of a C row: one 16-byte load and
//     store where the row starts 16-byte aligned in both tensors and the chunk
//     is full, element by element otherwise (the tail of a row whose C is not
//     a multiple of 8, or a row that is not aligned).
//   * Each thread issues kUnroll loads before it stores them, so that more
//     bytes are in flight per thread.
//   * Offsets are 64-bit: one probe tensor holds 2^30 elements, 2^31 bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 elements in 16 bytes
constexpr int kUnroll = 4;

struct Slab {
  long long stride_h, stride_outer, stride_inner;  // elements
  int n_inner, chunks;                              // chunks: ceil(C / kVec) per C row
  int per_slab;                                     // n_outer * n_inner * chunks
  int c;
};

__global__ void __launch_bounds__(kThreads) ident_hwbc_kernel(
    const uint16_t* __restrict__ x, uint16_t* __restrict__ out, Slab s) {
  const long long h_off = static_cast<long long>(blockIdx.x) * s.stride_h;
  const int per_outer = s.n_inner * s.chunks;
  for (int base = threadIdx.x; base < s.per_slab; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
    long long off[kUnroll];
    int len[kUnroll];
    bool vec[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      off[u] = 0;
      len[u] = 0;
      vec[u] = false;
      if (j < s.per_slab) {
        const int o = j / per_outer;
        const int r = j - o * per_outer;
        const int i = r / s.chunks;
        const int k = r - i * s.chunks;
        const long long row = h_off + o * s.stride_outer + i * s.stride_inner;
        const bool aligned =
            ((reinterpret_cast<uintptr_t>(x + row) | reinterpret_cast<uintptr_t>(out + row)) &
             15) == 0;
        off[u] = row + k * kVec;
        len[u] = min(kVec, s.c - k * kVec);
        vec[u] = aligned && len[u] == kVec;
        if (vec[u]) v[u] = *reinterpret_cast<const uint4*>(x + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (vec[u]) {
        *reinterpret_cast<uint4*>(out + off[u]) = v[u];
      } else {
        for (int e = 0; e < len[u]; ++e) out[off[u] + e] = x[off[u] + e];
      }
    }
  }
}

}  // namespace

extern "C" {

// x, out: (n_h, n_w, n_b, n_c) bf16 with the strides (s_h, s_w, s_b, s_c) in
// elements, s_c == 1; out has x's strides. Returns a cudaError_t.
int adipose_layout_ident(int device, const void* x, void* out, long long n_h, long long n_w,
                         long long n_b, long long n_c, long long s_h, long long s_w,
                         long long s_b, long long s_c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_h <= 0 || n_w <= 0 || n_b <= 0 || n_c <= 0 || s_c != 1 || n_h > INT_MAX ||
      n_c > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  // A slab's chunk index, and the loop's step past it, stay within int.
  const long long chunks = (n_c + kVec - 1) / kVec;
  if (n_w * n_b * chunks > INT_MAX - kThreads * kUnroll) return cudaErrorInvalidValue;
  // The dimension with the smaller stride goes inner.
  const bool w_inner = s_w <= s_b;
  Slab s;
  s.stride_h = s_h;
  s.stride_outer = w_inner ? s_b : s_w;
  s.stride_inner = w_inner ? s_w : s_b;
  s.n_inner = static_cast<int>(w_inner ? n_w : n_b);
  s.chunks = static_cast<int>(chunks);
  s.per_slab = static_cast<int>(n_w * n_b * chunks);
  s.c = static_cast<int>(n_c);
  ident_hwbc_kernel<<<static_cast<unsigned>(n_h), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), s);
  return cudaGetLastError();
}

}  // extern "C"
