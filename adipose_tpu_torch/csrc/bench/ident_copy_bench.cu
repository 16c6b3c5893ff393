// Copy designs for kernel I (csrc/layout.cu) on one run of 2 GiB, the size of
// the layout probe's (1024, 1024, 16, 64) bf16 activation, each timed by CUDA
// events (three rounds of 10 copies after a checked first copy) against
// cudaMemcpyAsync's device-to-device copy, which is what clone does for a
// dense tensor. A standalone program, not part of the kernel library (the
// build compiles csrc/*.cu only):
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//       -o build/ident_copy_bench adipose_tpu_torch/csrc/bench/ident_copy_bench.cu
//   build/ident_copy_bench
//
// vec_grid: a grid-stride loop, U vectors of 16 bytes in flight a thread;
// "full grid" launches one block per 256 x U vectors instead of as many
// blocks as fit at once (kernel I's design is "vec_grid U1 full grid").
// vec_tile: each block copies 256 x U contiguous vectors per step. tma: one
// thread a block keeps S bulk loads (cp.async.bulk) in flight into a ring of
// shared memory and writes each chunk back out with a bulk store.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#define CK(x) do { cudaError_t e = (x); if (e != cudaSuccess) { printf("ERR %s line %d: %s\n", #x, __LINE__, cudaGetErrorString(e)); return 1; } } while (0)

template <int U, bool CS>
__global__ void __launch_bounds__(256) vec_grid(const uint4* x, uint4* o, long long n) {
  const long long stride = (long long)gridDim.x * 256;
  long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  for (; i + (U - 1) * stride < n; i += U * stride) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = CS ? __ldcs(x + i + u * stride) : x[i + u * stride];
#pragma unroll
    for (int u = 0; u < U; ++u) { if (CS) __stcs(o + i + u * stride, v[u]); else o[i + u * stride] = v[u]; }
  }
  for (; i < n; i += stride) o[i] = x[i];
}

// Block-contiguous tiles of 256 * U vectors, grid-stride over tiles.
template <int U, bool CS>
__global__ void __launch_bounds__(256) vec_tile(const uint4* x, uint4* o, long long n) {
  const long long tile = 256LL * U;
  for (long long base = (long long)blockIdx.x * tile; base < n; base += (long long)gridDim.x * tile) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) { long long i = base + u * 256 + threadIdx.x; if (i < n) v[u] = CS ? __ldcs(x + i) : x[i]; }
#pragma unroll
    for (int u = 0; u < U; ++u) { long long i = base + u * 256 + threadIdx.x; if (i < n) { if (CS) __stcs(o + i, v[u]); else o[i] = v[u]; } }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void tma_load(uint32_t dst, const char* src, int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// TMA bulk copies: one thread per block keeps S chunk loads in flight into a
// ring of shared memory and stores each chunk back out as it lands.
template <int S>
__global__ void tma_copy(const char* x, char* o, long long nchunks, int chunk) {
  extern __shared__ __align__(128) char ring[];
  __shared__ __align__(8) uint64_t bar[S];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < S; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&bar[s])));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  long long k = 0;
  const long long first = blockIdx.x, step = gridDim.x;
  for (int s = 0; s < S && first + s * step < nchunks; ++s) tma_load(smem_u32(ring + (size_t)s * chunk), x + (first + s * step) * chunk, chunk, smem_u32(&bar[s]));
  uint32_t phase = 0;  // bit s: parity to wait for on stage s
  for (long long c = first; c < nchunks; c += step, ++k) {
    const int s = (int)(k % S);
    const uint32_t par = (phase >> s) & 1u;
    uint32_t done = 0;
    while (!done) {
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                   : "=r"(done) : "r"(smem_u32(&bar[s])), "r"(par) : "memory");
    }
    phase ^= 1u << s;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(o + c * chunk), "r"(smem_u32(ring + (size_t)s * chunk)), "r"(chunk) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    const long long next = c + (long long)S * step;
    if (next < nchunks) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      tma_load(smem_u32(ring + (size_t)s * chunk), x + next * chunk, chunk, smem_u32(&bar[s]));
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void diff(const uint4* a, const uint4* b, long long n, unsigned long long* bad) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    uint4 p = a[i], q = b[i];
    if (p.x != q.x || p.y != q.y || p.z != q.z || p.w != q.w) atomicAdd(bad, 1ULL);
  }
}

__global__ void fill(uint4* a, long long n, uint32_t seed) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x)
    a[i] = make_uint4((uint32_t)i * 2654435761u ^ seed, (uint32_t)(i >> 7) + seed, seed * 7u + (uint32_t)i, ~(uint32_t)i);
}

int main() {
  const long long bytes = 1LL << 31, n = bytes / 16;
  uint4 *x, *o; unsigned long long* bad;
  CK(cudaMalloc(&x, bytes)); CK(cudaMalloc(&o, bytes)); CK(cudaMalloc(&bad, 8));
  int sms; CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  fill<<<sms * 8, 256>>>(x, n, 12345u);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  const int iters = 10;
  auto report = [&](const char* name, auto&& run) -> int {
    CK(cudaMemset(o, 0, bytes));
    run(); CK(cudaGetLastError()); CK(cudaDeviceSynchronize());
    CK(cudaMemset(bad, 0, 8));
    diff<<<sms * 8, 256>>>(x, o, n, bad);
    unsigned long long nb; CK(cudaMemcpy(&nb, bad, 8, cudaMemcpyDeviceToHost));
    float best = 1e9, sum = 0;
    for (int r = 0; r < 3; ++r) {
      cudaEventRecord(a);
      for (int i = 0; i < iters; ++i) run();
      cudaEventRecord(b); CK(cudaEventSynchronize(b));
      float ms; cudaEventElapsedTime(&ms, a, b); ms /= iters; sum += ms; if (ms < best) best = ms;
    }
    printf("%-38s mean %.4f ms best %.4f ms  %.3f TB/s  mismatches %llu\n", name, sum / 3, best, 2.0 * bytes / (sum / 3) / 1e9, nb);
    return 0;
  };
  auto occ = [&](const void* k, int threads, size_t smem) { int p = 0; cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, k, threads, smem); return p; };
  report("memcpy D2D", [&] { cudaMemcpyAsync(o, x, bytes, cudaMemcpyDeviceToDevice); });
  int g;
  g = sms * occ((const void*)vec_grid<4, true>, 256, 0);
  printf("vec_grid blocks %d\n", g);
  report("vec_grid U4 cs", [&] { vec_grid<4, true><<<g, 256>>>(x, o, n); });
  report("vec_grid U4 plain", [&] { vec_grid<4, false><<<g, 256>>>(x, o, n); });
  report("vec_grid U8 cs", [&] { vec_grid<8, true><<<g, 256>>>(x, o, n); });
  report("vec_grid U2 cs", [&] { vec_grid<2, true><<<g, 256>>>(x, o, n); });
  report("vec_grid U4 cs half grid", [&] { vec_grid<4, true><<<g / 2, 256>>>(x, o, n); });
  report("vec_grid U1 cs full grid (kernel I)", [&] { vec_grid<1, true><<<(unsigned)((n + 255) / 256), 256>>>(x, o, n); });
  report("vec_grid U4 cs full grid", [&] { vec_grid<4, true><<<(unsigned)((n + 1023) / 1024), 256>>>(x, o, n); });
  report("vec_tile U4 cs", [&] { vec_tile<4, true><<<g, 256>>>(x, o, n); });
  report("vec_tile U8 cs", [&] { vec_tile<8, true><<<g, 256>>>(x, o, n); });
  report("vec_tile U4 plain", [&] { vec_tile<4, false><<<g, 256>>>(x, o, n); });
  report("vec_tile U8 plain", [&] { vec_tile<8, false><<<g, 256>>>(x, o, n); });
  struct T { int stages, chunk, per_sm; };
  for (T t : {T{4, 16384, 2}, T{4, 32768, 1}, T{6, 32768, 1}, T{8, 16384, 1}, T{4, 8192, 4}, T{3, 16384, 4}, T{2, 16384, 6}}) {
    const size_t smem = (size_t)t.stages * t.chunk;
    const void* k = t.stages == 2 ? (const void*)tma_copy<2> : t.stages == 3 ? (const void*)tma_copy<3> : t.stages == 4 ? (const void*)tma_copy<4> : t.stages == 6 ? (const void*)tma_copy<6> : (const void*)tma_copy<8>;
    CK(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    const int blocks = sms * t.per_sm;
    const long long nch = bytes / t.chunk;
    char name[64]; snprintf(name, 64, "tma S%d chunk %d x%d/SM", t.stages, t.chunk, t.per_sm);
    report(name, [&] {
      switch (t.stages) {
        case 2: tma_copy<2><<<blocks, 32, smem>>>((const char*)x, (char*)o, nch, t.chunk); break;
        case 3: tma_copy<3><<<blocks, 32, smem>>>((const char*)x, (char*)o, nch, t.chunk); break;
        case 4: tma_copy<4><<<blocks, 32, smem>>>((const char*)x, (char*)o, nch, t.chunk); break;
        case 6: tma_copy<6><<<blocks, 32, smem>>>((const char*)x, (char*)o, nch, t.chunk); break;
        default: tma_copy<8><<<blocks, 32, smem>>>((const char*)x, (char*)o, nch, t.chunk); break;
      }
    });
  }
  report("memcpy D2D again", [&] { cudaMemcpyAsync(o, x, bytes, cudaMemcpyDeviceToDevice); });
  return 0;
}
