// Causal flash attention (optional sliding window) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _kernel).  q/k/v/o: [BH, S, hd], hd in {32, 64, 128},
// float32 or bfloat16; K/V arrive expanded to the query heads.
//
// One CTA per (query tile of 64 rows, bh).  The math is the TPU kernel's:
// logits = (q.k) * scale, masked to -1e30 outside kpos <= qpos (and
// kpos > qpos - window), float32 online softmax with the running max
// starting at -1e30, p cast to the input type before the P.V product,
// acc / max(l, 1e-30) at the end.  The KV loop stops at the tile's last
// query (causal) and skips tiles wholly before every query's window.  S
// need not divide the tile: rows past S are read as zeros and not stored.
//
// Bound on the H100: at the prefill shape (BH = 64, S = 256, hd = 128) the
// work is small: 17 MB of q/k/v/o and 1.1 causal GFLOP, so bytes bound it
// (5 us at 3.35 TB/s).  The logits never reach device memory, which is
// what the TPU kernel was written for.  Two variants:
//  * bfloat16 (the main path): four warps, each owning 16 query rows, run
//    both products on the tensor cores (mma.sync m16n8k16, float32
//    accumulation).  The logits stay in registers: an accumulator fragment
//    of Q.K^T has the layout of the A operand of P.V, so p is rounded to
//    bfloat16 and fed back without passing through shared memory.  K and
//    V^T tiles sit in padded shared memory (conflict-free fragment loads).
//  * float32: CUDA-core FMAs (no TF32), four threads to a query row, Q/K/V
//    and p tiles in shared memory as float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;
constexpr int kF32Threads = 256;  // float32: four threads to a query row
constexpr int kMmaThreads = 128;  // bfloat16: four warps of 16 query rows

template <int HD>
constexpr int f32_smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBlockQ * (HD + 1) + kBlockKV * (HD + 1) + kBlockKV * HD + kBlockQ * (kBlockKV + 1));
}

template <int HD>
constexpr int mma_smem_bytes() {  // Qs and Ks [64][HD + 8], Vt [HD][64 + 8]
  return static_cast<int>(sizeof(__nv_bfloat16)) *
         (kBlockQ * (HD + 8) + kBlockKV * (HD + 8) + HD * (kBlockKV + 8));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values at p[0], p[1] as one fragment register (p[0] low).
__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                 float scale, int window) {
  constexpr int LD = HD + 8;          // Qs/Ks row stride (+16 bytes: conflict-free)
  constexpr int LDV = kBlockKV + 8;   // Vt row stride
  constexpr int KS = HD / 16;         // 16-deep steps of Q.K^T
  constexpr int NS = kBlockKV / 8;    // 8-wide logit tiles
  constexpr int NO = HD / 8;          // 8-wide output tiles
  constexpr int CH = HD / 8;          // 16-byte chunks in a row
  extern __shared__ uint4 mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* Ks = Qs + kBlockQ * LD;
  __nv_bfloat16* Vt = Ks + kBlockKV * LD;

  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, tig = tid % 4;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Neighbouring threads take neighbouring rows of one 16-byte column chunk:
  // the transposed V stores then fall in distinct banks.
  for (int i = tid; i < kBlockQ * CH; i += kMmaThreads) {
    const int r = i % kBlockQ, c = (i / kBlockQ) * 8;
    *reinterpret_cast<uint4*>(&Qs[r * LD + c]) =
        q0 + r < S ? *reinterpret_cast<const uint4*>(&q[base + static_cast<size_t>(q0 + r) * HD + c])
                   : zero;
  }
  __syncthreads();

  const int wr = warp * 16;  // the warp's first row in the tile
  unsigned qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* r0 = &Qs[(wr + g) * LD + kk * 16 + tig * 2];
    qa[kk][0] = ld_pair(r0);
    qa[kk][1] = ld_pair(r0 + 8 * LD);
    qa[kk][2] = ld_pair(r0 + 8);
    qa[kk][3] = ld_pair(r0 + 8 * LD + 8);
  }

  // This thread holds rows qpos0 (h = 0) and qpos0 + 8 (h = 1) of the
  // warp's strip: accumulator elements e = 2h and 2h + 1 of each tile.
  const int qpos0 = q0 + wr + g;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int k_end = min(S, q0 + kBlockQ);  // causal: no key after the tile's last query
  for (int k0 = 0; k0 < k_end; k0 += kBlockKV) {
    if (window > 0 && k0 + kBlockKV - 1 <= q0 - window) continue;  // before every window
    __syncthreads();  // the previous K/V tile is no longer read
    for (int i = tid; i < kBlockKV * CH; i += kMmaThreads) {
      const int r = i % kBlockKV, c = (i / kBlockKV) * 8;
      const bool in = k0 + r < S;
      const size_t at = base + static_cast<size_t>(k0 + r) * HD + c;
      *reinterpret_cast<uint4*>(&Ks[r * LD + c]) =
          in ? *reinterpret_cast<const uint4*>(&k[at]) : zero;
      const uint4 vv = in ? *reinterpret_cast<const uint4*>(&v[at]) : zero;
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + r] = hv[j];
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kr = &Ks[(j * 8 + g) * LD + kk * 16 + tig * 2];
        mma_bf16(s[j], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qpos0 + 8 * (e / 2);
        const int kpos = k0 + j * 8 + tig * 2 + (e % 2);
        bool keep = kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[j][e] = keep ? s[j][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a row's four threads are one quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);
        row_sum[e / 2] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
      l[h] = l[h] * alpha[h] + row_sum[h];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];

    // P.V: logit tiles 2t and 2t+1 form the A fragment of keys [16t, 16t+16).
#pragma unroll
    for (int t = 0; t < NS / 2; ++t) {
      const unsigned pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vr = &Vt[(n * 8 + g) * LDV + t * 16 + tig * 2];
        mma_bf16(acc[n], pa, ld_pair(vr), ld_pair(vr + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = qpos0 + 8 * h;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(&o[base + static_cast<size_t>(qpos) * HD + n * 8 + tig * 2]) =
          __floats2bfloat162_rn(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 float scale, int window) {
  constexpr int LD = HD + 1;         // padded rows: no bank conflicts across rows
  constexpr int LDP = kBlockKV + 1;
  constexpr int NS = kBlockKV / 4;   // logits per thread per tile
  constexpr int NO = HD / 4;         // output columns per thread
  extern __shared__ float f32_smem[];
  float* Qs = f32_smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockKV * LD;
  float* Ps = Vs + kBlockKV * HD;

  const int tid = threadIdx.x;
  const int r = tid >> 2;    // query row within the tile
  const int sub = tid & 3;   // this thread's quarter of the row
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;

  for (int i = tid; i < kBlockQ * HD; i += kF32Threads) {
    const int rr = i / HD, d = i % HD;
    Qs[rr * LD + d] = (q0 + rr < S) ? q[base + static_cast<size_t>(q0 + rr) * HD + d] : 0.f;
  }

  const int qpos = q0 + r;
  float m = kNegInf, l = 0.f;
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;

  const int k_end = min(S, q0 + kBlockQ);
  for (int k0 = 0; k0 < k_end; k0 += kBlockKV) {
    if (window > 0 && k0 + kBlockKV - 1 <= q0 - window) continue;
    __syncthreads();  // Q loaded; the previous K/V tile is no longer read
    for (int i = tid; i < kBlockKV * HD; i += kF32Threads) {
      const int rr = i / HD, d = i % HD;
      const bool in = k0 + rr < S;
      const size_t at = base + static_cast<size_t>(k0 + rr) * HD + d;
      Ks[rr * LD + d] = in ? k[at] : 0.f;
      Vs[rr * HD + d] = in ? v[at] : 0.f;
    }
    __syncthreads();

    float sc[NS];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = sub + 4 * j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(Qs[r * LD + d], Ks[c * LD + d], dot);
      const int kpos = k0 + c;
      bool keep = kpos <= qpos;
      if (window > 0) keep = keep && kpos > qpos - window;
      sc[j] = keep ? dot * scale : kNegInf;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = expf(sc[j] - m_new);
      row_sum += p;
      Ps[r * LDP + sub + 4 * j] = p;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = l * alpha + row_sum;
    m = m_new;
    __syncwarp();  // the row's four threads see each other's p

#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] *= alpha;
    for (int c = 0; c < kBlockKV; ++c) {
      const float p = Ps[r * LDP + c];
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] = fmaf(p, Vs[c * HD + sub + 4 * j], acc[j]);
    }
    __syncwarp();  // p read before the next tile overwrites it
  }

  if (qpos < S) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      o[base + static_cast<size_t>(qpos) * HD + sub + 4 * j] = acc[j] / denom;
  }
}

// Launches kernel on a (query tile, bh) grid.  The dynamic shared-memory
// limit is set once per device, so that a launch is nothing but the launch
// (and can be captured into a CUDA graph).
template <typename T, typename Kernel>
int launch(Kernel kernel, bool* smem_set, int threads, int smem, const void* q,
           const void* k, const void* v, void* o, int bh, int s, float scale,
           int window, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, scale, window);
  return cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int bh, int s,
              int dtype, float scale, int window, cudaStream_t stream) {
  static bool f32_set[kMaxDevices] = {};
  static bool mma_set[kMaxDevices] = {};
  if (dtype == 0)
    return launch<float>(flash_f32_kernel<HD>, f32_set, kF32Threads, f32_smem_bytes<HD>(),
                         q, k, v, o, bh, s, scale, window, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(flash_mma_kernel<HD>, mma_set, kMmaThreads,
                                 mma_smem_bytes<HD>(), q, k, v, o, bh, s, scale, window,
                                 stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype is 0 for float32, 1 for bfloat16; q/k/v/o are 16-byte aligned;
// window <= 0 means no window.
int flash_attention(const void* q, const void* k, const void* v, void* o, int bh, int s,
                    int hd, int dtype, float scale, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<32>(q, k, v, o, bh, s, dtype, scale, window, st);
    case 64: return launch_hd<64>(q, k, v, o, bh, s, dtype, scale, window, st);
    case 128: return launch_hd<128>(q, k, v, o, bh, s, dtype, scale, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
