// Per-sample D4 transform of a batch of square float32 tiles.
//
//   out[b, i, j] = x[b, src],  i' = a ? N-1-i : i,  j' = f ? N-1-j : j,
//                  src = t ? (j', i') : (i', j')
//
// with (t, a, f) = (transpose, flip rows, flip columns) looked up from the
// per-sample transform id (adipose_tpu/ops/d4.py `_D4_TRANSPOSE`,
// `_D4_FLIP_H`, `_D4_FLIP_W`).
//
// Replaces the TPU kernel `pin_default_layout` (adipose_tpu/ops/pallas/
// layout.py), whose only site is `apply_transform_batch` in
// adipose_tpu/ops/d4.py. There the Pallas kernel is an identity copy that
// forces XLA to lay the transposed batch out row-major; PyTorch has no layout
// assignment, so the counterpart is the whole per-sample transform the pin
// guards, in one launch.
//
// What bounds it on Hopper: device memory. It reads each element once and
// writes it once, with no arithmetic.
//
// What the design does about that:
//   * One block per (32 x 32 output tile, sample). It loads the matching
//     source tile into shared memory with a warp along a source row, then
//     writes the output tile with a warp along an output row: both the read
//     and the write are coalesced whether or not the sample is transposed.
//     The tile's pitch of 33 floats keeps the transposed read from shared
//     memory free of bank conflicts.
//   * The ids are read from device memory, so no launch waits on the host.
//   * N need not be a multiple of 32: edge tiles load and store only their
//     valid rows and columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads in y; each covers kTile / kRows rows

__constant__ unsigned char kTranspose[8] = {0, 1, 0, 1, 0, 1, 0, 1};
__constant__ unsigned char kFlipH[8] = {0, 1, 1, 0, 0, 0, 1, 1};
__constant__ unsigned char kFlipW[8] = {0, 0, 1, 1, 1, 0, 0, 1};

__global__ void d4_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                          float* __restrict__ out, int n) {
  __shared__ float tile[kTile][kTile + 1];
  const int b = blockIdx.z;
  const int id = min(max(ids[b], 0), 7);  // clamped, as a jnp gather clamps
  const bool t = kTranspose[id], a = kFlipH[id], f = kFlipW[id];
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - i0), cols = min(kTile, n - j0);
  // The output tile's source rows i' and columns j' each span one range.
  const int ip0 = a ? n - i0 - rows : i0;
  const int jp0 = f ? n - j0 - cols : j0;
  // The source tile: (i', j') directly, or (j', i') when transposed.
  const int sr0 = t ? jp0 : ip0, sc0 = t ? ip0 : jp0;
  const int nsr = t ? cols : rows, nsc = t ? rows : cols;
  const long long plane = static_cast<long long>(n) * n;
  const float* src = x + b * plane;
  float* dst = out + b * plane;

  for (int r = threadIdx.y; r < nsr; r += kRows) {
    if (threadIdx.x < nsc) {
      tile[r][threadIdx.x] = src[static_cast<long long>(sr0 + r) * n + sc0 + threadIdx.x];
    }
  }
  __syncthreads();
  for (int li = threadIdx.y; li < rows; li += kRows) {
    const int lj = threadIdx.x;
    if (lj < cols) {
      const int ipl = a ? rows - 1 - li : li;  // i' - ip0
      const int jpl = f ? cols - 1 - lj : lj;  // j' - jp0
      dst[static_cast<long long>(i0 + li) * n + j0 + lj] = t ? tile[jpl][ipl] : tile[ipl][jpl];
    }
  }
}

}  // namespace

extern "C" {

// x, out: (batch, n, n) float32, contiguous. ids: (batch,) int32 on the
// device. Returns a cudaError_t.
int adipose_d4(int device, const void* x, const void* ids, void* out, int batch, int n,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || batch > 65535 || n <= 0) return cudaErrorInvalidValue;
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  d4_kernel<<<dim3(tiles, tiles, batch), dim3(kTile, kRows), 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(ids), static_cast<float*>(out), n);
  return cudaGetLastError();
}

}  // extern "C"
