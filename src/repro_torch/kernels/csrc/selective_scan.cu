// Selective scan (Mamba's SSM recurrence) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/selective_scan.py
// (selective_scan, _kernel).  For every channel (b, d) and step t:
//   h_t = abar_t * h_{t-1} + bx_t,   y_t[d] = sum_n h_t[d, n] * c_t[n],
// with abar, bx [B, S, D, N] float32, c [B, S, N] float32 or bfloat16,
// y [B, S, D] float32.  Beside the TPU kernel's function it takes an
// optional initial state h0 [B, D, N] (zeros when null) and writes the final
// state h_out [B, D, N]: the model carries h across its time chunks with
// them, where the TPU kernel carried it in VMEM across its sequential grid
// axis.  N is 4, 8 or 16; any S >= 1 and D.
//
// Bound on the H100: bytes.  Each abar and bx element is read once and used
// for one FMA, so at the prefill chunk (B 4, S 128, D 8192, N 16) the
// 537 MB of abar and bx take 0.16 ms at 3.35 TB/s; c, y and the state
// are under 1% of that.  The design only has to keep the loads wide,
// contiguous and in flight:
//  * the time axis is a loop inside the thread (the TPU's sequential grid
//    axis); the state never leaves registers;
//  * N / 4 neighbouring threads share a channel, four states each, so a
//    step is one 16-byte load of abar and one of bx per thread, and a warp
//    reads 512 contiguous bytes of each (neighbouring channels are
//    neighbouring rows of N floats);
//  * step t+1's operands are loaded into registers before step t is
//    computed;
//  * y_t[d] is a reduction over the channel's threads with __shfl_xor_sync;
//  * abar and bx are read once: streaming loads (ld.global.cs) keep them
//    from evicting c, which every channel of a batch row reads.
// At the prefill shape that is 131,072 threads, about 1,000 per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 load_c4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load_c4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// TPC threads share one channel (b, d); thread j of the channel holds the
// states 4j .. 4j + 3.
template <int TPC, typename C>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ abar, const float* __restrict__ bx,
                const C* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int B, int S, int D) {
  constexpr int N = 4 * TPC;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long channel = g / TPC;
  if (channel >= static_cast<long long>(B) * D) return;  // whole channels leave together
  const int j = static_cast<int>(g % TPC);
  const int b = static_cast<int>(channel / D);
  const int d = static_cast<int>(channel % D);

  const size_t step4 = static_cast<size_t>(D) * N / 4;  // float4s per time step
  const size_t off = static_cast<size_t>(b) * S * D * N + static_cast<size_t>(d) * N + 4 * j;
  const float4* a_p = reinterpret_cast<const float4*>(abar + off);
  const float4* b_p = reinterpret_cast<const float4*>(bx + off);
  const C* c_p = c + static_cast<size_t>(b) * S * N + 4 * j;
  float* y_p = y + static_cast<size_t>(b) * S * D + d;
  const size_t h_off = (static_cast<size_t>(b) * D + d) * N + 4 * j;

  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  if (h0 != nullptr) h = *reinterpret_cast<const float4*>(h0 + h_off);

  // the channel's lanes, for the shuffles
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = ((1u << TPC) - 1u) << (lane & ~static_cast<unsigned>(TPC - 1));

  float4 a_next = __ldcs(a_p), b_next = __ldcs(b_p), c_next = load_c4(c_p);
  for (int t = 0; t < S; ++t) {
    const float4 a = a_next, bv = b_next, cv = c_next;
    if (t + 1 < S) {
      a_p += step4;
      b_p += step4;
      c_p += N;
      a_next = __ldcs(a_p);
      b_next = __ldcs(b_p);
      c_next = load_c4(c_p);
    }
    h.x = fmaf(a.x, h.x, bv.x);
    h.y = fmaf(a.y, h.y, bv.y);
    h.z = fmaf(a.z, h.z, bv.z);
    h.w = fmaf(a.w, h.w, bv.w);
    float part = h.x * cv.x + h.y * cv.y + h.z * cv.z + h.w * cv.w;
    if constexpr (TPC >= 2) part += __shfl_xor_sync(mask, part, 1);
    if constexpr (TPC >= 4) part += __shfl_xor_sync(mask, part, 2);
    if (j == 0) __stcs(y_p + static_cast<size_t>(t) * D, part);
  }
  *reinterpret_cast<float4*>(h_out + h_off) = h;
}

template <int TPC, typename C>
int launch(const void* abar, const void* bx, const void* c, const void* h0, void* y,
           void* h_out, int B, int S, int D, cudaStream_t stream) {
  const long long threads = static_cast<long long>(B) * D * TPC;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  scan_kernel<TPC, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(abar), static_cast<const float*>(bx),
      static_cast<const C*>(c), static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), B, S, D);
  return cudaGetLastError();
}

template <typename C>
int launch_n(const void* abar, const void* bx, const void* c, const void* h0, void* y,
             void* h_out, int B, int S, int D, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<1, C>(abar, bx, c, h0, y, h_out, B, S, D, stream);
    case 8: return launch<2, C>(abar, bx, c, h0, y, h_out, B, S, D, stream);
    case 16: return launch<4, C>(abar, bx, c, h0, y, h_out, B, S, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// c_dtype is 0 for float32, 1 for bfloat16; h0 may be null (zero state);
// every pointer is 16-byte aligned and every array contiguous.
int selective_scan(const void* abar, const void* bx, const void* c, int c_dtype,
                   const void* h0, void* y, void* h_out, int B, int S, int D, int N,
                   void* stream) {
  if (B < 1 || S < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c_dtype == 0) return launch_n<float>(abar, bx, c, h0, y, h_out, B, S, D, N, st);
  if (c_dtype == 1)
    return launch_n<__nv_bfloat16>(abar, bx, c, h0, y, h_out, B, S, D, N, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
