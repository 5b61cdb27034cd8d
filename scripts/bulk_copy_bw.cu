// How fast can CTAs pull a large buffer into shared memory on one card?
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/bulk_copy_bw scripts/bulk_copy_bw.cu && build/bulk_copy_bw
//
// Streams 256 MB once per launch (5 launches timed with CUDA events, after a
// warm-up) three ways: bulk copies (cp.async.bulk, completing on one
// mbarrier per slot) into a ring of 16 KB stages, for several CTA counts,
// copy sizes and ring depths, contiguous or as strided 512-byte row pieces;
// and plain 16-byte ld.global.cg loads, 8 in flight per thread.  Prints
// one line per variant: ms per launch and GB/s.  The pinned matmul's decode
// variant (src/repro_torch/kernels/csrc/persistent_matmul.cu) streams its
// weights the first way.
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ unsigned sa(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void expect(unsigned long long* b, int n) { asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(sa(b)), "r"(n) : "memory"); }
__device__ __forceinline__ void bulk(void* d, const void* s, int n, unsigned long long* b) { asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" :: "r"(sa(d)), "l"(s), "r"(n), "r"(sa(b)) : "memory"); }
__device__ __forceinline__ void wait(unsigned long long* b, int par) { for (;;) { unsigned d; asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0,1,0,p; }" : "=r"(d) : "r"(sa(b)), "r"(par) : "memory"); if (d) return; } }
// each CTA streams `per` bytes starting at its offset; copies of `csz` bytes; stage = 16KB; ring = RING
template <int RING>
__global__ void k_bulk(const char* src, size_t per, int csz, int stride_rows, float* sink) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ unsigned long long bars[RING];
  if (threadIdx.x < RING) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(sa(&bars[threadIdx.x])));
  asm volatile("fence.mbarrier_init.release.cluster;");
  __syncthreads();
  const int stage = 16384, nst = per / stage, cps = stage / csz;
  const char* base = src + blockIdx.x * (stride_rows ? (size_t)csz : per);
  size_t rowstride = stride_rows ? (size_t)csz * gridDim.x : 0;  // strided rows layout
  auto issue = [&](int g) {
    if (g >= nst || threadIdx.x >= 32) return;
    unsigned long long* b = &bars[g % RING];
    if (threadIdx.x == 0) expect(b, stage);
    __syncwarp();
    for (int i = threadIdx.x; i < cps; i += 32) {
      const char* s = stride_rows ? base + (size_t)(g * cps + i) * rowstride : base + (size_t)g * stage + i * csz;
      bulk(sm + (g % RING) * stage + i * csz, s, csz, b);
    }
  };
  for (int g = 0; g < RING - 1; ++g) issue(g);
  float acc = 0;
  for (int g = 0; g < nst; ++g) {
    issue(g + RING - 1);
    wait(&bars[g % RING], (g / RING) & 1);
    __syncthreads();
    acc += ((float*)(sm + (g % RING) * stage))[threadIdx.x];
    __syncthreads();
  }
  if (acc == 12345.f) *sink = acc;
}
__global__ void k_ld(const uint4* src, size_t per16, float* sink) {
  const uint4* p = src + blockIdx.x * per16;
  unsigned acc = 0;
  for (size_t i = threadIdx.x; i < per16; i += blockDim.x * 8) {
    uint4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (i + j * blockDim.x < per16) ? __ldcg(p + i + j * blockDim.x) : make_uint4(0,0,0,0);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc ^= v[j].x ^ v[j].w;
  }
  if (acc == 12345u) *sink = acc;
}
int main() {
  size_t total = 256ull << 20;
  char* buf; cudaMalloc(&buf, total); cudaMemset(buf, 1, total);
  float* sink; cudaMalloc(&sink, 4);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  auto run = [&](const char* name, auto launch) {
    launch(); cudaDeviceSynchronize();
    cudaEventRecord(a); for (int r = 0; r < 5; ++r) launch(); cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b); ms /= 5;
    printf("%-40s %.4f ms  %.0f GB/s (of total)  err=%s\n", name, ms, total / ms / 1e6, cudaGetErrorString(cudaGetLastError()));
  };
  int smem4 = 4 * 16384, smem6 = 6 * 16384;
  cudaFuncSetAttribute(k_bulk<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem4);
  cudaFuncSetAttribute(k_bulk<6>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem6);
  for (int ctas : {132, 264, 528}) for (int csz : {512, 2048, 16384}) {
    char nm[80]; snprintf(nm, 80, "bulk ring4 ctas=%d copy=%d contiguous", ctas, csz);
    run(nm, [&] { k_bulk<4><<<ctas, 256, smem4>>>(buf, total / ctas / 16384 * 16384, csz, 0, sink); });
  }
  for (int ctas : {264}) for (int csz : {512}) {
    char nm[80]; snprintf(nm, 80, "bulk ring6 ctas=%d copy=%d contiguous", ctas, csz);
    run(nm, [&] { k_bulk<6><<<ctas, 256, smem6>>>(buf, total / ctas / 16384 * 16384, csz, 0, sink); });
    snprintf(nm, 80, "bulk ring4 ctas=%d copy=%d strided rows", ctas, csz);
    run(nm, [&] { k_bulk<4><<<ctas, 256, smem4>>>(buf, total / ctas / 16384 * 16384, csz, 1, sink); });
  }
  for (int ctas : {264, 1056, 4224}) {
    char nm[80]; snprintf(nm, 80, "ld.cg v4 x8 ctas=%d", ctas);
    run(nm, [&] { k_ld<<<ctas, 256>>>((const uint4*)buf, total / 16 / ctas, sink); });
  }
  return 0;
}
