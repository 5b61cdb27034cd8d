// Persistent matmul pinned to SMs: the RTGPU paper's Algorithm 1 on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/persistent_matmul.py
// (persistent_matmul, _kernel, tile_of).  out[M,N] = x[M,K] @ w[K,N] with a
// float32 accumulator, in float32 (IEEE FMA, no TF32) or bfloat16.
//
// Pinning: the launch over-subscribes the card.  Each CTA reads %smid and
// looks up the SM's band in `sm_band` (-1 = not allocated to this task); a
// CTA on a foreign SM returns at once.  On an allocated SM, a per-band
// atomic counter hands out lanes 0 and 1 (the paper's two self-interleaved
// halves); later CTAs on that SM return.  Lane `lane` of band `b` walks the
// work units linear = b*2T + step*2 + lane, T = ceil(units / (2*n_bands)),
// the TPU kernel's tile_of map, and masks units and edges past the end.
//
// Work units: a unit is (row tile, col tile, K slice), linear = tile * S +
// slice.  The slice count S and length are a function of the shape alone
// (persistent_matmul.py::split_plan), never of n_bands or the card: S = 1
// where the tiles fill 2 x 132 lanes, else the slice length (a multiple of
// the variant's K step; the last slice ragged) that minimises a lane's
// estimated time.  With S = 1 a unit writes its tile.  With S > 1 it writes
// a float32 partial to the workspace [S, M, N], fences, and adds one to its
// tile's arrival counter; the unit that arrives last fences, reads the S
// partials through L2 (ld.global.cg) and sums them in slice order 0..S-1.
// No CTA ever waits for another: with pinning, the lanes that would
// release it may be queued behind it on the same SM.
//
// Completion: the hardware scheduler decides where CTAs land.  Launching
// 2 * (resident CTAs per SM) * (SMs) CTAs puts at least two on every SM in
// the first wave, but nothing guarantees it, so every finished unit adds
// one to `units_done`, and a traced launch records each unit's %smid and
// hit count for the caller to check.
//
// Bound on the H100: decode (M = 4) reads the weights once and is bound by
// HBM bytes; prefill (M = 1024) is bound by operations, but its narrow
// shapes (N = 33, N = 16) have too few tiles to fill the card.  Variants:
//  * M <= 4 (decode): a unit is 4 rows of x by 512 bytes of each weight
//    row (256 bf16 or 128 float32 columns) over a K slice.  The weights
//    stream through a 4-slot shared-memory ring of 16 KB stages fed by
//    bulk copies (cp.async.bulk, the copy engine; L2 only, nothing kept in
//    L1) that complete on one mbarrier per slot; three stages stay in
//    flight while one is used, across stage and unit boundaries: 48 KB per
//    lane, 96 KB per SM.  bf16 row segments go to the tensor cores
//    (mma.sync m16n8k16, out^T = w^T x^T with x's 4 rows padded to 8;
//    ldmatrix.trans reads w from rows padded to 528 bytes, so without bank
//    conflicts) and x's fragments come through L1; each warp owns 32
//    columns, so a unit needs no reduction across warps.  Where one unit
//    spans all of N (x_proj's 33, the router's 16) a stage is one
//    contiguous slab of the weights, one bulk copy whatever N's alignment
//    (K % 8 == 0), with x's slice beside it, and CUDA-core FMAs over
//    columns indexed in shared memory, reduced in a fixed order (row
//    groups of a warp by shuffles, then the 8 warps in order).  Weights
//    whose rows are not 16-byte aligned are loaded element by element.
//    What bounds it: the HBM stream where the units fill the card; at
//    small shapes the launch, the lane claim and the split's fence and
//    arrival count, a few microseconds in all.
//  * M > 16 in bfloat16 with K % 8 == 0 and N % 8 == 0 (every wide prefill
//    projection): pinned_wgmma_kernel, 128 x 128 tiles, K step 64.  It
//    replaces the mma.sync tile below for these shapes, which ran at 5-10
//    times torch.matmul: register-staged loads of one 32-deep step kept the
//    tensor cores waiting.  What bounds it is tensor-core operations, and
//    at 128 x 128 the L2 traffic that feeds them (64 FLOP per byte of a
//    stage).  So: one producer warp keeps a 3-stage shared-memory ring full
//    with TMA (cp.async.bulk.tensor.2d, 128-byte swizzle; x's [128 x 64]
//    box and two [64 x 64] boxes of w, each stage 32 KB, a full and an
//    empty mbarrier per stage, across unit boundaries); one consumer
//    warpgroup runs wgmma.mma_async m64n128k16 (two per 16-deep step, f32
//    accumulators, 128 a thread), A = x K-major and B = w's row-major
//    boxes read MN-major through the descriptor's transpose bit, so w is
//    never transposed in memory.  One stage's products stay in flight
//    while the next is issued.  97 KB of shared memory and 160 threads of
//    at most 200 registers a CTA keep the two lanes of an SM resident, and
//    while one lane writes its tile the other keeps the tensor cores busy.
//    TMA zero-fills the ragged edges; the ring needs 16-byte row strides,
//    hence K % 8 == 0 and N % 8 == 0 (the wrapper copies a misaligned base).
//  * other M > 16 in bfloat16 (x_proj's N = 33, ragged N): 64 x 64 tiles,
//    mma.sync m16n8k16 with float32 accumulation; the next K step's tiles
//    are loaded into registers while the current one is multiplied.
//  * otherwise (float32, or 4 < M <= 16): 16 x 64 or 64 x 64 tiles, IEEE
//    FMAs on the CUDA cores from float32 tiles in shared memory, the next
//    K step's values loaded into registers during the products.
// The register-staged variants take 16-byte loads of x where K % 8 == 0
// and of w where N % 8 == 0, each flag apart.  Each unit's K order is fixed
// and so is the order of the partials' sum, which makes results
// bit-identical for every band count.
#include <cuda.h>  // CUtensorMap; the encoder is found at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
// wgmma units: 128 x 128 tiles, K step 64 (one 128-byte swizzle row of bf16)
constexpr int kWgTile = 128;
constexpr int kWgK = 64;
constexpr int kWgStages = 3;
constexpr int kWgConsumers = 128;                 // one warpgroup
constexpr int kWgThreads = kWgConsumers + 32;     // and one producer warp
constexpr int kWgABytes = kWgTile * kWgK * 2;     // x's [128 x 64] box, 16 KB
constexpr int kWgBBox = kWgK * 64 * 2;            // one of w's [64 x 64] boxes, 8 KB
constexpr int kWgStageBytes = kWgABytes + 2 * kWgBBox;
constexpr int kWgSmem = kWgStages * kWgStageBytes + 1024;  // + slack to align to 1024
constexpr int kWgSumRows = 8;  // rows a thread sums at a time (split units)
constexpr int kBlockK = 32;
constexpr int kBlockN = 64;
constexpr int kMaxDevices = 64;
// decode units
constexpr int kGemvRows = 4;
constexpr int kGemvRowBytes = 512;  // a unit's segment of a weight row: 256 bf16, 128 f32
constexpr int kRing = 4;            // stages in the ring
constexpr int kStageBytes = 16384;  // weights per stage
constexpr int kMaxStageRows = 128;
constexpr int kRowPad = 16;  // bytes after each 512-byte row segment: conflict-free ldmatrix
constexpr int kWsBytes = kStageBytes + kStageBytes / kGemvRowBytes * kRowPad;
constexpr int kMaxTcSteps = kStageBytes / kGemvRowBytes / 16;  // 16-row steps of a bf16 stage
constexpr int kXStageBytes = kGemvRows * kMaxStageRows * 4;
constexpr int kSlotBytes = kWsBytes + kXStageBytes;
// the 8 warps' float32 sums of a unit (at most 256 columns)
constexpr int kPartBytes = (kThreads / 32) * kGemvRows * 256 * 4;
constexpr int kGemvSmem = kRing * kSlotBytes + kPartBytes;

// One launch: operands, the unit plan, counters and the optional trace.
struct Args {
  const void* x;
  const void* w;
  void* out;
  int M, N, K;
  const int* sm_band;
  int n_sm_ids;
  int per_lane, n_tiles_n, n_slices, slice_len, total_units, stage_rows;
  int* lane_ctr;
  int* units_done;
  int* arrive;  // one count per tile (split launches)
  float* ws;    // [n_slices, M, N] partials (split launches)
  int* unit_sm;
  int* unit_hits;
  int vec_x, vec_w;
};

// A unit's tile and K range.
struct Unit {
  int tile, slice, row0, col0, k_begin, k_end;
};

__device__ __forceinline__ Unit unit_at(const Args& a, int linear, int bm, int bn) {
  Unit u;
  u.tile = linear / a.n_slices;
  u.slice = linear - u.tile * a.n_slices;
  u.row0 = (u.tile / a.n_tiles_n) * bm;
  u.col0 = (u.tile % a.n_tiles_n) * bn;
  u.k_begin = u.slice * a.slice_len;
  u.k_end = min(a.K, u.k_begin + a.slice_len);
  return u;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive values from a 16-byte aligned address, as float.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned sm_id_bound() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nsmid;" : "=r"(r));
  return r;
}

// Keeps the compiler from moving accesses of `d` across the wgmma fences
// and waits, which it cannot see are tied to the registers.
__device__ __forceinline__ void wg_fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// d[64 x 128] += A[64 x 16] (K-major) * B[16 x 128] (MN-major: the
// transpose bit), bf16 in, f32 accumulate; d in the accumulator layout
// (warp w, lane l: rows 16w + l/4 (+8), columns 8j + 2(l%4) (+1)).
__device__ __forceinline__ void wgmma_128(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// 8 values p[r][c..c+8) of a row-major bf16 matrix with row stride ld, zero
// outside rows x cols; one 16-byte load when `vec` (ld % 8 == 0, aligned
// base).
__device__ __forceinline__ uint4 load_row8(const __nv_bfloat16* p, int r, int c, int rows,
                                           int ld, int cols, int vec) {
  if (r < rows && vec && c + 8 <= cols)
    return *reinterpret_cast<const uint4*>(p + static_cast<size_t>(r) * ld + c);
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    h[j] = (r < rows && c + j < cols) ? p[static_cast<size_t>(r) * ld + c + j]
                                      : __float2bfloat16(0.f);
  return u;
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

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The CTA's lane (0 or 1) on SM `sm` and the SM's band, or -1 when the CTA
// must return: the SM is not allocated to this task, or both of its lanes
// are taken.  Every thread of the CTA calls it.
__device__ __forceinline__ int claim_lane(unsigned sm, const Args& a, int* s_lane,
                                          int* band) {
  *band = static_cast<int>(sm) < a.n_sm_ids ? a.sm_band[sm] : -1;
  if (*band < 0) return -1;
  if (threadIdx.x == 0) *s_lane = atomicAdd(&a.lane_ctr[*band], 1);
  __syncthreads();
  return *s_lane < 2 ? *s_lane : -1;
}

// A barrier over the CTA (kCount = 0), or over its first kCount threads
// alone (the wgmma kernel's consumers; named barrier 1).
template <int kCount>
__device__ __forceinline__ void sync_threads() {
  if constexpr (kCount == 0)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;\n" :: "n"(kCount) : "memory");
}

// After a split unit's partials are written: true, in every thread that
// takes part (sync_threads<kCount>), when this CTA is the last of its
// tile's units to arrive.  Writers fence before the count; the last arriver
// fences before it reads.  Nothing waits.
template <int kCount = 0>
__device__ __forceinline__ bool arrive_last(const Args& a, int tile, int* s_flag) {
  __threadfence();
  sync_threads<kCount>();
  if (threadIdx.x == 0) *s_flag = atomicAdd(&a.arrive[tile], 1) == a.n_slices - 1;
  sync_threads<kCount>();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}

// The sum of the partials at `off` in slice order, read through L2, eight
// loads in flight at a time.
__device__ __forceinline__ float sum_partials(const Args& a, size_t off) {
  const size_t stride = static_cast<size_t>(a.M) * a.N;
  const float* p = a.ws + off;
  float s = 0.f;
  int i = 0;
  for (; i + 8 <= a.n_slices; i += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldcg(p + (i + j) * stride);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  for (; i < a.n_slices; ++i) s += __ldcg(p + i * stride);
  return s;
}

__device__ __forceinline__ size_t partial_at(const Args& a, const Unit& u, size_t off) {
  return static_cast<size_t>(u.slice) * a.M * a.N + off;
}

__device__ __forceinline__ void unit_done(const Args& a, int linear, unsigned sm) {
  if (threadIdx.x == 0) {
    atomicAdd(a.units_done, 1);
    if (a.unit_sm != nullptr) {
      a.unit_sm[linear] = static_cast<int>(sm);
      atomicAdd(&a.unit_hits[linear], 1);
    }
  }
}

// block_m x 64 output tiles; each thread owns a TM x TN micro-tile.  The
// next K step's x and w values are loaded into registers during the products.
template <typename T, int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2) pinned_matmul_kernel(const Args a) {
  static_assert((BM / TM) * (kBlockN / TN) == kThreads, "thread layout");
  constexpr int kLoadsA = BM * kBlockK / kThreads, kLoadsB = kBlockK * kBlockN / kThreads;
  __shared__ float As[kBlockK][BM + 1];  // x tile, transposed; +1 avoids bank conflicts
  __shared__ float Bs[kBlockK][kBlockN];
  __shared__ int s_lane, s_flag;

  const unsigned sm = sm_id();
  int band;
  const int lane = claim_lane(sm, a, &s_lane, &band);
  if (lane < 0) return;

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  T* out = static_cast<T*>(a.out);
  const int M = a.M, N = a.N, K = a.K;
  const int tid = threadIdx.x;
  const int tx = tid % (kBlockN / TN);
  const int ty = tid / (kBlockN / TN);

  for (int step = 0; step < a.per_lane; ++step) {
    const int linear = band * 2 * a.per_lane + step * 2 + lane;
    if (linear >= a.total_units) break;
    const Unit u = unit_at(a, linear, BM, kBlockN);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    // the next K step's tiles are loaded into registers during the products
    float ra[kLoadsA], rb[kLoadsB];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int t = 0; t < kLoadsA; ++t) {
        const int i = tid + t * kThreads;
        const int gr = u.row0 + i / kBlockK, gc = k0 + i % kBlockK;
        ra[t] = (gr < M && gc < u.k_end) ? to_f(x[static_cast<size_t>(gr) * K + gc]) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kLoadsB; ++t) {
        const int i = tid + t * kThreads;
        const int gr = k0 + i / kBlockN, gc = u.col0 + i % kBlockN;
        rb[t] = (gr < u.k_end && gc < N) ? to_f(w[static_cast<size_t>(gr) * N + gc]) : 0.f;
      }
    };
    fetch(u.k_begin);
    for (int k0 = u.k_begin; k0 < u.k_end; k0 += kBlockK) {
      __syncthreads();  // the previous K step (and unit) is no longer read
#pragma unroll
      for (int t = 0; t < kLoadsA; ++t) {
        const int i = tid + t * kThreads;
        As[i % kBlockK][i / kBlockK] = ra[t];
      }
#pragma unroll
      for (int t = 0; t < kLoadsB; ++t) {
        const int i = tid + t * kThreads;
        Bs[i / kBlockN][i % kBlockN] = rb[t];
      }
      __syncthreads();
      if (k0 + kBlockK < u.k_end) fetch(k0 + kBlockK);
#pragma unroll
      for (int kk = 0; kk < kBlockK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // the tile (S = 1) or the partial; the last arriver sums the partials
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = u.row0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = u.col0 + tx * TN + j;
        if (r >= M || c >= N) continue;
        const size_t off = static_cast<size_t>(r) * N + c;
        if (a.n_slices == 1)
          out[off] = from_f<T>(acc[i][j]);
        else
          a.ws[partial_at(a, u, off)] = acc[i][j];
      }
    }
    if (a.n_slices > 1 && arrive_last(a, u.tile, &s_flag)) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = u.row0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = u.col0 + tx * TN + j;
          if (r < M && c < N) {
            const size_t off = static_cast<size_t>(r) * N + c;
            out[off] = from_f<T>(sum_partials(a, off));
          }
        }
      }
    }
    unit_done(a, linear, sm);
  }
}

// M <= 4: a unit is 4 rows x 512 bytes of each weight row (4 x N where that
// spans N) over a K slice; thread = (row group, 8 columns).
template <typename T>
__global__ void __launch_bounds__(kThreads) pinned_gemv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_lane, s_flag;
  __shared__ unsigned long long bars[kRing];  // one per ring slot: its stage has landed

  const unsigned sm = sm_id();
  int band;
  const int lane = claim_lane(sm, a, &s_lane, &band);
  if (lane < 0) return;

  constexpr int kEB = static_cast<int>(sizeof(T));
  constexpr int kCols = kGemvRowBytes / kEB;          // columns of a unit
  constexpr int kOut = kGemvRows * kCols / kThreads;  // a unit's outputs per thread
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  T* out = static_cast<T*>(a.out);
  const int tid = threadIdx.x, warp = tid / 32;
  const bool slab = a.N <= kCols;  // one unit spans all of N
  const int ldw = slab ? a.N : kCols;             // columns of a stage
  const int lds = slab ? a.N : kCols + kRowPad / kEB;  // their stride in shared memory
  int cgs = 1;  // threads across a row, 8 columns each: a power of two <= 32
  while (cgs * 8 < ldw) cgs *= 2;
  const int row_groups = kThreads / cgs;
  const int kr = tid / cgs, c = (tid % cgs) * 8;  // row group, first column
  const int R = a.stage_rows;
  const bool bulk = a.vec_w && a.vec_x;  // bulk copies; else element loads
  // bf16 row segments go through the tensor cores: warp w owns the unit's
  // columns [32w, 32w + 32) as two 16-column tiles of m16n8k16 products
  // (out^T = w^T x^T, x's 4 rows padded to 8); else CUDA-core FMAs
  const bool tc = std::is_same_v<T, __nv_bfloat16> && bulk && !slab;
  const int g4 = (tid % 32) / 4, t4 = tid % 4;  // an mma fragment's row and column pair
  const int spu = a.slice_len / R;       // stages per unit
  const int first = band * 2 * a.per_lane + lane;  // the lane's units: first + 2 * step
  const int n_units = first < a.total_units ? min(a.per_lane, (a.total_units - first + 1) / 2) : 0;
  const int n_stages = n_units * spu;
  float* part = reinterpret_cast<float*>(smem + kRing * kSlotBytes);

  // A cursor over the lane's stages: stage g is stage sg of unit `linear`,
  // K rows [k0, k0 + R) clipped to the slice (none at the end of a ragged
  // last slice).  Divisions only where a unit starts.
  struct Cursor {
    int g, sg, k0, linear;
    Unit u;
  };
  auto open_unit = [&](Cursor& q) {
    q.sg = 0;
    q.linear = first + 2 * (q.g / spu);
    q.u = unit_at(a, q.linear, kGemvRows, kCols);
    q.k0 = q.u.k_begin;
  };
  auto next = [&](Cursor& q) {
    ++q.g;
    q.k0 += R;
    if (++q.sg == spu && q.g < n_stages) open_unit(q);
  };

  // Issues stage q.g into its slot, then moves q on.  With `bulk`, lanes of
  // warp 0 issue one bulk copy per weight row segment (a slab: one copy)
  // and per x row, and lane 0 arrives on the slot's barrier expecting their
  // bytes (0 for an empty stage); otherwise every thread loads elements.
  auto issue = [&](Cursor& q) {
    const int rows = max(0, min(R, q.u.k_end - q.k0));
    unsigned char* slot = smem + (q.g % kRing) * kSlotBytes;
    T* ws = reinterpret_cast<T*>(slot);
    T* xs = reinterpret_cast<T*>(slot + kWsBytes);
    if (bulk) {
      if (warp == 0) {
        const int seg = min(kCols, a.N - q.u.col0) * kEB;  // bytes of a row segment
        const int w_copies = slab ? (rows > 0) : rows;
        const int w_bytes = slab ? rows * a.N * kEB : rows * seg;
        const int m_rows = rows > 0 && !tc ? min(a.M, kGemvRows) : 0;  // tc: x from L1
        unsigned long long* bar = &bars[q.g % kRing];
        if (tid == 0) mbar_expect(bar, w_bytes + m_rows * rows * kEB);
        __syncwarp();
        for (int i = tid; i < w_copies + m_rows; i += 32) {
          if (i < w_copies) {
            const T* src = w + static_cast<size_t>(q.k0 + i) * a.N + q.u.col0;
            bulk_copy(slab ? ws : ws + i * lds, src, slab ? w_bytes : seg, bar);
          } else {
            const int m = i - w_copies;
            bulk_copy(xs + m * R, x + static_cast<size_t>(m) * a.K + q.k0, rows * kEB, bar);
          }
        }
      }
    } else {
      for (int i = tid; i < rows * ldw; i += kThreads) {
        const int r = i / ldw, cc = i % ldw;
        ws[r * lds + cc] = q.u.col0 + cc < a.N
                               ? w[static_cast<size_t>(q.k0 + r) * a.N + q.u.col0 + cc]
                               : from_f<T>(0.f);
      }
      for (int i = tid; i < kGemvRows * rows; i += kThreads) {
        const int m = i / rows, r = i % rows;
        xs[m * R + r] = m < a.M ? x[static_cast<size_t>(m) * a.K + q.k0 + r] : from_f<T>(0.f);
      }
    }
    next(q);
  };

  // bulk: x rows past M are never copied, so they are zeroed once here
  if (bulk) {
    for (int i = tid; i < kRing * kGemvRows * kMaxStageRows; i += kThreads) {
      const int slot = i / (kGemvRows * kMaxStageRows), e = i % (kGemvRows * kMaxStageRows);
      if (e / R >= a.M && e < kGemvRows * R)
        reinterpret_cast<T*>(smem + slot * kSlotBytes + kWsBytes)[e] = from_f<T>(0.f);
    }
    if (tid < kRing) mbar_init(&bars[tid]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_stages == 0) return;

  Cursor pq{0}, cq{0};  // producer and consumer
  open_unit(pq);
  open_unit(cq);
  while (pq.g < min(kRing - 1, n_stages)) issue(pq);
  // output i of the current unit: x row i / ldw, column col0 + i % ldw
  auto unit_out = [&](int i, size_t& off) {
    const int m = i / ldw, col = cq.u.col0 + i % ldw;
    off = static_cast<size_t>(m) * a.N + col;
    return i < kGemvRows * ldw && m < a.M && col < a.N;
  };
  float acc[kGemvRows][8];
  for (int g = 0; g < n_stages; ++g) {
    if (pq.g < n_stages) issue(pq);  // stage g + kRing - 1
    const int rows = min(R, cq.u.k_end - cq.k0);
    // tc: the stage's x fragments (x rows g4 < M; 8 bytes per 16-row step)
    // from global memory through L1, in flight while the stage lands
    unsigned xf[kMaxTcSteps][2] = {};
    if (tc && g4 < a.M) {
      const T* xr = x + static_cast<size_t>(g4) * a.K + cq.k0 + 2 * t4;
#pragma unroll
      for (int s = 0; s < kMaxTcSteps; ++s) {
        if (s * 16 < rows) xf[s][0] = __ldg(reinterpret_cast<const unsigned*>(xr + s * 16));
        if (s * 16 + 16 <= rows) xf[s][1] = __ldg(reinterpret_cast<const unsigned*>(xr + s * 16 + 8));
      }
    }
    if (bulk) mbar_wait(&bars[g % kRing], (g / kRing) & 1);  // stage g has landed
    __syncthreads();

    if (cq.sg == 0) {
#pragma unroll
      for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
    }
    const unsigned char* slot = smem + (g % kRing) * kSlotBytes;
    const T* ws = reinterpret_cast<const T*>(slot);
    const T* xs = reinterpret_cast<const T*>(slot + kWsBytes);
    if (tc) {
      // acc[nt][0..3]: columns 32w + 16nt + g4 (+8 for [2], [3]), x rows
      // 2t4 and 2t4 + 1.  rows is a multiple of 8: a 16-row step is whole
      // or its upper half is outside the slice (zeroed, as stale shared
      // memory times zero could be NaN).  x rows past M stay zero.
#pragma unroll
      for (int s = 0; s < kMaxTcSteps; ++s) {
        const int ks = s * 16;
        if (ks >= rows) break;
        const bool whole = ks + 16 <= rows;
        const int l = tid % 32;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          unsigned af[4];
          ldmatrix_x4_trans(af, ws + (ks + l / 16 * 8 + l % 8) * lds + warp * 32 + nt * 16 +
                                    (l / 8) % 2 * 8);
          if (!whole) af[2] = af[3] = 0u;
          mma_bf16(acc[nt], af, xf[s][0], xf[s][1]);
        }
      }
    } else if (c < ldw) {
#pragma unroll 4
      for (int r = kr; r < rows; r += row_groups) {
        float wv[8];
        if (lds * kEB % 16 == 0) {
          load8(ws + r * lds + c, wv);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) wv[j] = c + j < ldw ? to_f(ws[r * lds + c + j]) : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kGemvRows; ++m) {
          const float xv = to_f(xs[m * R + r]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
        }
      }
    }

    if (cq.sg == spu - 1 && tc) {
      // each warp holds its columns' sums and writes the tile (S = 1) or
      // the partial
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // [nt][h][mm]
        const int m = 2 * t4 + e % 2;
        const int col = cq.u.col0 + warp * 32 + e / 4 * 16 + g4 + e / 2 % 2 * 8;
        if (m >= a.M || col >= a.N) continue;
        const size_t off = static_cast<size_t>(m) * a.N + col;
        const float v = acc[e / 4][e % 4];
        if (a.n_slices == 1)
          out[off] = from_f<T>(v);
        else
          a.ws[partial_at(a, cq.u, off)] = v;
      }
    } else if (cq.sg == spu - 1) {
      // Fixed-order reduction over the row groups: those of a warp by
      // shuffles (a + b == b + a exactly, so every lane holds the same
      // sum), then the 8 warps in order.
      for (int off = cgs; off < 32; off *= 2) {
#pragma unroll
        for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
      }
      if (tid % 32 < cgs) {
#pragma unroll
        for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
          for (int j = 0; j < 8; ++j) part[(warp * kGemvRows + m) * kCols + c + j] = acc[m][j];
      }
      __syncthreads();
      float sum[kOut];  // outputs i = tid + kThreads * e: row i / ldw, column i % ldw
#pragma unroll
      for (int e = 0; e < kOut; ++e) {
        const int i = tid + kThreads * e;
        sum[e] = 0.f;
        if (i < kGemvRows * ldw) {
#pragma unroll
          for (int p = 0; p < kThreads / 32; ++p)
            sum[e] += part[(p * kGemvRows + i / ldw) * kCols + i % ldw];
        }
      }
#pragma unroll
      for (int e = 0; e < kOut; ++e) {  // the tile (S = 1) or the partial
        size_t off;
        if (!unit_out(tid + kThreads * e, off)) continue;
        if (a.n_slices == 1)
          out[off] = from_f<T>(sum[e]);
        else
          a.ws[partial_at(a, cq.u, off)] = sum[e];
      }
    }
    if (cq.sg == spu - 1) {
      if (a.n_slices > 1 && arrive_last(a, cq.u.tile, &s_flag)) {  // sums the partials
#pragma unroll
        for (int e = 0; e < kOut; ++e) {
          size_t off;
          if (unit_out(tid + kThreads * e, off)) out[off] = from_f<T>(sum_partials(a, off));
        }
      }
      unit_done(a, cq.linear, sm);
    }
    next(cq);
    __syncthreads();  // slot g % kRing and `part` are free again
  }
}

// M > 16, bfloat16: 64 x 64 tiles; 8 warps, each a 16 x 32 strip of four
// m16n8k16 products per 16-deep K step.
__global__ void __launch_bounds__(kThreads) pinned_mma_kernel(const Args a) {
  constexpr int BM = 64, BN = 64, BK = kBlockK, LDS = BK + 8;  // +8: conflict-free fragments
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDS];  // x tile, [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDS];  // w tile transposed, [n][k]
  __shared__ int s_lane, s_flag;

  const unsigned sm = sm_id();
  int band;
  const int lane = claim_lane(sm, a, &s_lane, &band);
  if (lane < 0) return;

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const int M = a.M, N = a.N, K = a.K;
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, tig = tid % 4;
  const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;
  const int a_row = tid / 4, a_k = (tid % 4) * 8;  // staging: 8 k of one x row
  const int b_k = tid % 32, b_n = (tid / 32) * 8;  // staging: 8 n of one w row

  for (int step = 0; step < a.per_lane; ++step) {
    const int linear = band * 2 * a.per_lane + step * 2 + lane;
    if (linear >= a.total_units) break;
    const Unit u = unit_at(a, linear, BM, BN);
    const int ke = u.k_end;

    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

    uint4 ra = load_row8(x, u.row0 + a_row, u.k_begin + a_k, M, K, ke, a.vec_x);
    uint4 rb = load_row8(w, u.k_begin + b_k, u.col0 + b_n, ke, N, N, a.vec_w);
    for (int k0 = u.k_begin; k0 < ke; k0 += BK) {
      __syncthreads();  // the previous K step (and unit) is no longer read
      *reinterpret_cast<uint4*>(&As[a_row][a_k]) = ra;
      const __nv_bfloat16* hb = reinterpret_cast<const __nv_bfloat16*>(&rb);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[b_n + j][b_k] = hb[j];
      __syncthreads();
      if (k0 + BK < ke) {  // next K step's tiles, in flight during the products
        ra = load_row8(x, u.row0 + a_row, k0 + BK + a_k, M, K, ke, a.vec_x);
        rb = load_row8(w, k0 + BK + b_k, u.col0 + b_n, ke, N, N, a.vec_w);
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[4];
        af[0] = *reinterpret_cast<const unsigned*>(&As[wm + g][kk + tig * 2]);
        af[1] = *reinterpret_cast<const unsigned*>(&As[wm + g + 8][kk + tig * 2]);
        af[2] = *reinterpret_cast<const unsigned*>(&As[wm + g][kk + 8 + tig * 2]);
        af[3] = *reinterpret_cast<const unsigned*>(&As[wm + g + 8][kk + 8 + tig * 2]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn + j * 8 + g;
          const unsigned b0 = *reinterpret_cast<const unsigned*>(&Bs[n][kk + tig * 2]);
          const unsigned b1 = *reinterpret_cast<const unsigned*>(&Bs[n][kk + 8 + tig * 2]);
          mma_bf16(acc[j], af, b0, b1);
        }
      }
    }

    // the tile (S = 1) or the partial; the last arriver sums the partials
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = u.row0 + wm + g + 8 * (e / 2);
        const int c = u.col0 + wn + j * 8 + tig * 2 + e % 2;
        if (r >= M || c >= N) continue;
        const size_t off = static_cast<size_t>(r) * N + c;
        if (a.n_slices == 1)
          out[off] = __float2bfloat16(acc[j][e]);
        else
          a.ws[partial_at(a, u, off)] = acc[j][e];
      }
    }
    if (a.n_slices > 1 && arrive_last(a, u.tile, &s_flag)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = u.row0 + wm + g + 8 * (e / 2);
          const int c = u.col0 + wn + j * 8 + tig * 2 + e % 2;
          if (r < M && c < N) {
            const size_t off = static_cast<size_t>(r) * N + c;
            out[off] = __float2bfloat16(sum_partials(a, off));
          }
        }
      }
    }
    unit_done(a, linear, sm);
  }
}

// M > 16, bfloat16, K % 8 == 0, N % 8 == 0: 128 x 128 tiles from a TMA-fed
// ring.  Threads 0-127 are the consumer warpgroup, 128-159 the producer
// warp (one thread issues).  Both walk the lane's units in the same order;
// stage g of the walk lives in slot g % kWgStages.
__global__ void __launch_bounds__(kWgThreads, 2)
    pinned_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap tmap_x,
                        const __grid_constant__ CUtensorMap tmap_w) {
  extern __shared__ unsigned char wg_raw[];
  __shared__ __align__(8) unsigned long long full[kWgStages], empty[kWgStages];
  __shared__ int s_lane, s_flag;

  const unsigned sm = sm_id();
  int band;
  const int lane = claim_lane(sm, a, &s_lane, &band);
  if (lane < 0) return;

  // the 128-byte swizzle repeats every 1024 bytes: TMA and wgmma agree on
  // it where every box starts on a 1024-byte boundary
  unsigned char* ring = wg_raw + ((1024 - (smem_addr(wg_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], kWgConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int first = band * 2 * a.per_lane + lane;  // the lane's units: first + 2 * i
  const int n_units =
      first < a.total_units ? min(a.per_lane, (a.total_units - first + 1) / 2) : 0;

  if (tid >= kWgConsumers) {  // producer
    if (tid == kWgConsumers) {
      int g = 0;
      for (int i = 0; i < n_units; ++i) {
        const Unit u = unit_at(a, first + 2 * i, kWgTile, kWgTile);
        for (int k0 = u.k_begin; k0 < u.k_end; k0 += kWgK, ++g) {
          const int s = g % kWgStages;
          if (g >= kWgStages) mbar_wait(&empty[s], (g / kWgStages - 1) & 1);
          unsigned char* st = ring + s * kWgStageBytes;
          mbar_expect(&full[s], kWgStageBytes);  // boxes count whole, zero fill included
          tma_load(st, &tmap_x, k0, u.row0, &full[s]);
          tma_load(st + kWgABytes, &tmap_w, u.col0, k0, &full[s]);
          tma_load(st + kWgABytes + kWgBBox, &tmap_w, u.col0 + 64, k0, &full[s]);
        }
      }
    }
    return;
  }

  // consumers
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const int warp = tid / 32, l = tid % 32;
  const unsigned ring_addr = smem_addr(ring);
  float acc[2][64];  // rows [64h, 64h + 64) of the tile
  int g = 0;
  for (int i = 0; i < n_units; ++i) {
    const int linear = first + 2 * i;
    const Unit u = unit_at(a, linear, kWgTile, kWgTile);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[h][e] = 0.f;
      wg_fence_regs(acc[h]);
    }
    int held = -1;  // the slot whose products may still be in flight
    for (int k0 = u.k_begin; k0 < u.k_end; k0 += kWgK, ++g) {
      const int s = g % kWgStages;
      mbar_wait(&full[s], (g / kWgStages) & 1);
      const unsigned xa = ring_addr + s * kWgStageBytes, wa = xa + kWgABytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgK / 16; ++kk) {
        // B: 16 K rows of 128 bytes at 2048 kk; the second 64 columns one
        // box (8 KB) on; 8-row groups 1024 bytes apart
        const uint64_t db = wg_desc(wa + kk * 2048, kWgBBox, 1024);
        // A: 32 bytes of each 128-byte row at 32 kk; 8-row groups 1024 apart
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_128(acc[h], wg_desc(xa + h * 64 * 128 + kk * 32, 16, 1024), db);
      }
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done: free its slot
      if (held >= 0 && l == 0) mbar_arrive(&empty[held]);
      held = s;
    }
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) wg_fence_regs(acc[h]);
    if (held >= 0 && l == 0) mbar_arrive(&empty[held]);

    // the tile (S = 1) in bf16 or the float32 partial, from the accumulator
    // layout; N % 8 == 0, so a column pair is inside N or outside it whole
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = u.row0 + 64 * h + 16 * warp + l / 4 + 8 * half;
          const int c = u.col0 + 8 * j + 2 * (l % 4);
          if (r >= a.M || c >= a.N) continue;
          const size_t off = static_cast<size_t>(r) * a.N + c;
          const float v0 = acc[h][4 * j + 2 * half], v1 = acc[h][4 * j + 2 * half + 1];
          if (a.n_slices == 1)
            *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(a.ws + partial_at(a, u, off)) = make_float2(v0, v1);
        }
      }
    }
    // the last arriver sums the tile's partials in slice order: lane l
    // takes 4 columns, warp w the rows w, w + 4, ..; 8 rows of two slices
    // are in flight at a time
    if (a.n_slices > 1 && arrive_last<kWgConsumers>(a, u.tile, &s_flag)) {
      const size_t stride = static_cast<size_t>(a.M) * a.N;
      const int c = u.col0 + 4 * l, r_end = min(a.M, u.row0 + kWgTile);
      for (int r0 = u.row0 + warp; c < a.N && r0 < r_end; r0 += 4 * kWgSumRows) {
        float4 sum[kWgSumRows];
#pragma unroll
        for (int i = 0; i < kWgSumRows; ++i) sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
        for (int sl = 0; sl < a.n_slices; ++sl) {
          const float* p = a.ws + sl * stride + c;
#pragma unroll
          for (int i = 0; i < kWgSumRows; ++i) {
            const int r = r0 + 4 * i;
            if (r >= r_end) continue;
            const float4 v =
                __ldcg(reinterpret_cast<const float4*>(p + static_cast<size_t>(r) * a.N));
            sum[i].x += v.x;
            sum[i].y += v.y;
            sum[i].z += v.z;
            sum[i].w += v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < kWgSumRows; ++i) {
          const int r = r0 + 4 * i;
          if (r >= r_end) continue;
          __nv_bfloat162* o =
              reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * a.N + c);
          o[0] = __floats2bfloat162_rn(sum[i].x, sum[i].y);
          o[1] = __floats2bfloat162_rn(sum[i].z, sum[i].w);
        }
      }
    }
    unit_done(a, linear, sm);
  }
}

template <typename Kernel, typename... Maps>
int launch(Kernel kernel, int threads, int smem, int* resident, int* n_sms, const Args& a,
           int n_counters, cudaStream_t stream, const Maps&... maps) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    if (smem > 0) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev], kernel, threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&n_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (resident[dev] < 2) return cudaErrorInvalidConfiguration;  // two lanes must fit
  err = cudaMemsetAsync(a.lane_ctr, 0, sizeof(int) * n_counters, stream);
  if (err != cudaSuccess) return err;
  const int grid = 2 * resident[dev] * n_sms[dev];
  kernel<<<grid, threads, smem, stream>>>(a, maps...);
  return cudaGetLastError();
}

// A map of the row-major bf16 [rows, cols] matrix at `base` in boxes of
// box_rows x 64 (128 bytes, the swizzle's width); zeros outside the matrix.
bool encode_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int dispatch(const Args& a, int block_m, int n_counters, cudaStream_t stream) {
  static int resident[4][kMaxDevices] = {};
  static int n_sms[4][kMaxDevices] = {};
  switch (block_m) {
    case kGemvRows: {
      const int cols = kGemvRowBytes / static_cast<int>(sizeof(T));
      const int ldw = a.N <= cols ? a.N : cols;
      const int R = a.stage_rows;
      if (R <= 0 || R > kMaxStageRows || R % 8 || R * ldw * static_cast<int>(sizeof(T)) > kStageBytes ||
          a.slice_len % R)
        return cudaErrorInvalidValue;
      return launch(pinned_gemv_kernel<T>, kThreads, kGemvSmem, resident[0], n_sms[0], a,
                    n_counters, stream);
    }
    case 16:
      return launch(pinned_matmul_kernel<T, 16, 1, 4>, kThreads, 0, resident[1], n_sms[1], a,
                    n_counters, stream);
    case 64:
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return launch(pinned_mma_kernel, kThreads, 0, resident[2], n_sms[2], a, n_counters,
                      stream);
      else
        return launch(pinned_matmul_kernel<T, 64, 4, 4>, kThreads, 0, resident[2], n_sms[2], a,
                      n_counters, stream);
    case kWgTile:
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        // TMA: 16-byte aligned bases and row strides; never another variant
        if (a.K % 8 || a.N % 8 || reinterpret_cast<uintptr_t>(a.x) % 16 ||
            reinterpret_cast<uintptr_t>(a.w) % 16)
          return cudaErrorInvalidValue;
        CUtensorMap tmap_x, tmap_w;
        if (!encode_map(&tmap_x, a.x, a.M, a.K, kWgTile) ||
            !encode_map(&tmap_w, a.w, a.K, a.N, kWgK))
          return cudaErrorInvalidValue;
        return launch(pinned_wgmma_kernel, kWgThreads, kWgSmem, resident[3], n_sms[3], a,
                      n_counters, stream, tmap_x, tmap_w);
      } else {
        return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
}

__global__ void sm_probe_kernel(int* seen, int cap, int* n_ids) {
  const long long start = clock64();
  while (clock64() - start < 20000) {
  }  // stay resident so the first wave spreads over every SM
  if (threadIdx.x != 0) return;
  const unsigned sm = sm_id();
  if (static_cast<int>(sm) < cap) seen[sm] = 1;
  if (blockIdx.x == 0) *n_ids = static_cast<int>(sm_id_bound());
}

}  // namespace

extern "C" {

// Marks seen[smid] = 1 for every SM a CTA ran on; n_ids gets %nsmid.
int sm_probe(int* seen, int cap, int* n_ids, int n_blocks, void* stream) {
  sm_probe_kernel<<<n_blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(seen, cap, n_ids);
  return cudaGetLastError();
}

// block_m is 4 (M <= 4, decode), 16 (M <= 16), 64, or 128 (the wgmma
// variant: bfloat16, K % 8 == 0, N % 8 == 0, 16-byte aligned x and w);
// dtype is 0 for float32, 1 for bfloat16.  The plan
// (persistent_matmul.py::tile_grid): tiles output tiles, n_tiles_n of them
// across N, n_slices K slices of slice_len, a multiple of k_step, the
// variant's K step (the decode variant's rows per stage).  counters holds
// n_bands lane counters, the finished-unit count and, when n_slices > 1,
// one arrival count per tile (all zeroed here); ws is the float32
// [n_slices, M, N] workspace when n_slices > 1.  unit_sm / unit_hits may be
// null (untraced launch).  vec_x: x's rows are 16-byte aligned (K % 8 == 0,
// aligned base); vec_w: w's rows are (N % 8 == 0), or, for a decode launch
// with N <= 64, w's base is.
int pinned_matmul(const void* x, const void* w, void* out, int M, int N, int K, int dtype,
                  int block_m, const int* sm_band, int n_sm_ids, int n_bands, int per_lane,
                  int n_tiles_n, int tiles, int n_slices, int slice_len, int k_step,
                  int* counters, float* ws, int* unit_sm, int* unit_hits, int vec_x,
                  int vec_w, void* stream) {
  const int step = block_m == kGemvRows ? k_step : block_m == kWgTile ? kWgK : kBlockK;
  if (n_slices < 1 || slice_len < 1 || (n_slices > 1 && ws == nullptr) || k_step != step ||
      slice_len % step)
    return cudaErrorInvalidValue;
  Args a{x, w, out, M, N, K, sm_band, n_sm_ids, per_lane, n_tiles_n, n_slices, slice_len,
         tiles * n_slices, k_step, counters, counters + n_bands, counters + n_bands + 1, ws,
         unit_sm, unit_hits, vec_x, vec_w};
  const int n_counters = n_bands + 1 + (n_slices > 1 ? tiles : 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, block_m, n_counters, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, block_m, n_counters, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
