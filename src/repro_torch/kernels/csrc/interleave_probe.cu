// Interleave probes: Fig. 6's latency-extension ratio alpha on Hopper.
//
// Replaces no TPU kernel: a measuring tool.  The JAX benchmark
// benchmarks/fig6_interleave.py (_workloads) times four jitted probes on the
// host, where nothing shares an SM; on the card alpha is the time of one
// lane with two lanes co-resident on its SM over its time alone.  Each probe
// here is the counterpart of one of _workloads' kernel types:
//  * compute: a register-blocked matrix product (4 x 4 outputs a thread, a
//    64 x 64 tile of A and of x in shared memory, two 16-byte shared loads
//    per 16 FMAs), as _workloads' chain of 256 x 256 products;
//  * memory: dst = src + 1 over the lane's own 4 MB slice in 16-byte loads
//    and stores, as its roll + 1 (bound by HBM bytes once enough lanes run);
//  * branch: a two-way branch per element on a per-thread random bit, each
//    side a different chain of eight operations, so warps diverge, as its
//    where(x > 0, ...);
//  * special: sin + cos by the special function units (__sinf, __cosf) on
//    four chains, as its sin(x) + cos(x).
//
// Pinning, as persistent_matmul.cu: the launch over-subscribes the card;
// each CTA reads %smid and looks up the SM's band (-1 = not probed); on a
// probed SM a per-band atomic counter hands out lanes 0..lanes-1, and later
// CTAs on that SM return at once.  lanes = 1 runs one lane per SM alone,
// lanes = 2 two co-resident lanes that do the same work each.  A working
// lane stamps %globaltimer (ns) before and after its work, so the caller
// reads each lane's own time and whether the two lanes of an SM overlapped,
// and adds one to `done`: the caller checks that every lane ran.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // the compute probe's shared tiles: kTile x kTile floats each

struct Args {
  const int* sm_band;
  int n_sm_ids;
  int lanes;
  int* lane_ctr;        // one per band
  int* done;            // lanes that ran
  float* buf;           // per lane (band * 2 + lane): 2 * elems floats
  long long elems;      // the memory probe's floats per lane, a multiple of 4 * kThreads
  int iters;
  unsigned long long* stamps;  // per lane: start, end (ns)
};

__device__ __forceinline__ unsigned sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float compute_work(int iters, float seed) {
  __shared__ __align__(16) float s_a[kTile * kTile];
  __shared__ __align__(16) float s_x[kTile * kTile];
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    s_a[i] = 1.0f + 1e-3f * static_cast<float>(i % 7) + seed;
    s_x[i] = 1.0f - 1e-3f * static_cast<float>(i % 5);
  }
  __syncthreads();
  // 256 threads own a 64 x 64 output as 16 x 16 blocks of 4 x 4
  const int r0 = (threadIdx.x / 16) * 4, c0 = (threadIdx.x % 16) * 4;
  float acc[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&s_a[k * kTile + r0]);
      const float4 x = *reinterpret_cast<const float4*>(&s_x[k * kTile + c0]);
      const float av[4] = {a.x, a.y, a.z, a.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += acc[i][j];
  return sum;
}

__device__ __forceinline__ float memory_work(const Args& a, int slot, float seed) {
  const float4* src = reinterpret_cast<const float4*>(a.buf + 2 * a.elems * slot);
  float4* dst = reinterpret_cast<float4*>(a.buf + 2 * a.elems * slot + a.elems);
  const long long n4 = a.elems / 4;
  for (int it = 0; it < a.iters; ++it) {
#pragma unroll 8
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      float4 v = __ldcs(src + i);
      v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += seed;
      __stcs(dst + i, v);
    }
  }
  return 0.f;
}

__device__ __forceinline__ float branch_work(int iters, float seed) {
  unsigned s = 2654435761u * (threadIdx.x + 1) + __float_as_uint(seed);
  float x = 1.0f + 1e-3f * threadIdx.x;
  for (int it = 0; it < iters; ++it) {
    s = s * 1664525u + 1013904223u;
    if (s & 0x10000u) {
      x = fmaf(x, 0.99f, 0.01f); x = fmaf(x, 1.01f, -0.01f); x = fmaf(x, 0.98f, 0.02f);
      x = fmaf(x, 1.02f, -0.02f); x = fmaf(x, 0.97f, 0.03f); x = fmaf(x, 1.03f, -0.03f);
      x = fmaf(x, 0.96f, 0.04f); x = fmaf(x, 1.04f, -0.04f);
    } else {
      x = x * 1.01f - 0.01f; x = x * 0.99f + 0.01f; x = x * 1.02f - 0.02f;
      x = x * 0.98f + 0.02f; x = x * 1.03f - 0.03f; x = x * 0.97f + 0.03f;
      x = x * 1.04f - 0.04f; x = x * 0.96f + 0.04f;
    }
  }
  return x;
}

__device__ __forceinline__ float special_work(int iters, float seed) {
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = seed + 0.25f * j + 1e-3f * threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __sinf(x[j]) + __cosf(x[j]);
  }
  return x[0] + x[1] + x[2] + x[3];
}

template <int kKind>
__global__ void __launch_bounds__(kThreads) probe_kernel(const Args a) {
  __shared__ int s_lane;
  const unsigned sm = sm_id();
  const int band = static_cast<int>(sm) < a.n_sm_ids ? a.sm_band[sm] : -1;
  if (band < 0) return;
  if (threadIdx.x == 0) s_lane = atomicAdd(&a.lane_ctr[band], 1);
  __syncthreads();
  const int lane = s_lane;
  if (lane >= a.lanes) return;
  const int slot = band * 2 + lane;
  const float seed = 1e-6f * static_cast<float>(slot);
  const unsigned long long t0 = global_ns();
  float r;
  if constexpr (kKind == 0) r = compute_work(a.iters, seed);
  else if constexpr (kKind == 1) r = memory_work(a, slot, seed);
  else if constexpr (kKind == 2) r = branch_work(a.iters, seed);
  else r = special_work(a.iters, seed);
  __syncthreads();
  if (kKind != 1) a.buf[2 * a.elems * slot + threadIdx.x] = r;  // keeps the work live
  if (threadIdx.x == 0) {
    a.stamps[2 * slot] = t0;
    a.stamps[2 * slot + 1] = global_ns();
    atomicAdd(a.done, 1);
  }
}

}  // namespace

extern "C" {

// kind: 0 compute, 1 memory, 2 branch, 3 special.  counters holds n_bands
// lane counters and the count of lanes that ran; stamps 2 per lane slot
// (band * 2 + lane), 4 * n_bands in all; both zeroed here.  buf holds
// 2 * elems floats per slot, elems >= kThreads and a multiple of
// 4 * kThreads.  grid: CTAs of the launch, enough to put `lanes` on every
// probed SM in its first wave.
int interleave_probe(int kind, const int* sm_band, int n_sm_ids, int n_bands, int lanes,
                     int grid, float* buf, long long elems, int iters, int* counters,
                     unsigned long long* stamps, void* stream) {
  if (kind < 0 || kind > 3 || lanes < 1 || lanes > 2 || n_bands < 1 || grid < 1 ||
      elems < kThreads || elems % (4 * kThreads))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counters, 0, sizeof(int) * (n_bands + 1), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(stamps, 0, sizeof(unsigned long long) * 4 * n_bands, s);
  if (err != cudaSuccess) return err;
  const Args a{sm_band, n_sm_ids, lanes, counters, counters + n_bands, buf, elems, iters,
               stamps};
  switch (kind) {
    case 0: probe_kernel<0><<<grid, kThreads, 0, s>>>(a); break;
    case 1: probe_kernel<1><<<grid, kThreads, 0, s>>>(a); break;
    case 2: probe_kernel<2><<<grid, kThreads, 0, s>>>(a); break;
    default: probe_kernel<3><<<grid, kThreads, 0, s>>>(a); break;
  }
  return cudaGetLastError();
}

}  // extern "C"
