// Causal flash attention (optional sliding window) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _kernel).  It reads the model's own layout and GQA:
// q is [B, S, H, hd] and k/v are [B, S, Hkv, hd] (any batch and position
// strides that are multiples of 16 bytes, heads packed in a row, the last
// dimension contiguous); query head h reads KV head h / (H / Hkv), which
// is repeat_interleave's order and jnp.repeat's.  The output is written
// straight into [B, S, H * hd], the input of the output projection.
// hd in {32, 64, 128}; float32 or bfloat16.
//
// The math is the TPU kernel's: logits = (q.k) * scale, masked to -1e30
// outside kpos <= qpos (and kpos > qpos - window), float32 online softmax
// with the running max starting at -1e30, p rounded to the input type
// before the P.V product, acc / max(l, 1e-30) at the end (the wgmma variant
// multiplies by that one reciprocal a row: within a float32 rounding).  KV
// tiles wholly past the causal limit or wholly before the window are
// skipped.  S need not divide a tile: rows past S are read as zeros and not
// stored.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at qwen3-0.6b's
// prefill (B 4, S 256, 16 query and 8 KV heads of 128, bf16) q, k, v and o
// are 12.6 MB, 3.76 us at the memory's rate, and the causal products 1.08
// GFLOP, 1.09 us at the tensor cores' peak; jamba-v0.1-52b's 32/8 heads
// 21.0 MB, 6.26 us, against 2.18 us.  Bytes bound it, so K and V must leave
// device memory once per KV head and no copy may run around the kernel.
//
// Variants (flash_attention.py::kernel_name):
//  * flash_wgmma_kernel<HD>, bfloat16 at hd 64 and 128 (every attention
//    layer of the main path).  One CTA covers one KV head, one or two of
//    its query heads and a tile of positions: two consumer warpgroups of
//    64 query rows each (the same 64 positions of two query heads of the
//    group where H / Hkv is even, else 128 positions of one head) and one
//    producer warp.  Against what held the mma.sync design back:
//     1. loads overlap the math: the producer keeps TMA loads of K and V
//        tiles (64 keys) in flight into a 4-stage ring with a full and an
//        empty mbarrier per stage, so a stage is refilled while the others
//        are multiplied;
//     2. V is never transposed by hand: P.V reads V's row-major [keys x
//        hd] boxes MN-major through the wgmma transpose bit;
//     3. both products run on wgmma: S = Q.K^T (m64n64k16, Q and K both
//        K-major in shared memory) and O += P.V (m64n{hd}k16) with P from
//        registers: the accumulator fragment of S is the A fragment of
//        P.V, so p is rounded to bfloat16 and fed back without passing
//        through shared memory; the two warpgroups' softmax and products
//        interleave on the SM's tensor cores;
//     4. the grid is one CTA per (position tile, batch, KV head, head
//        pair), 128 CTAs of 288 threads at qwen's shape, and it issues the
//        longest causal position tiles first;
//     5. GQA and the layout are read in the kernel: TMA reads q, k and v
//        through 3-D tensor maps over (H * hd, S, B) with the tensors' own
//        strides (zeros past S: a ragged S never reads the next sequence),
//        in [64 x 64] boxes under the 128-byte swizzle, two per row at hd
//        128; both query heads of a pair read the same K/V stage; the
//        output tile goes through the warpgroup's Q buffer (same swizzle)
//        and leaves by one TMA store per box, rows past S clipped.
//        ops.mha_flash is one launch and no copy.
//    What bounds it now is the SM's issue rate, not memory: a 64-key step
//    takes about 1.4 us with both warpgroups busy, half of it the
//    softmax's ALU work, against 0.28 us of tensor-core time (globaltimer
//    stamps, PERF.md); the mask's index arithmetic runs only on tiles that
//    cross the diagonal or the window's edge.
//  * flash_mma_kernel<32>, bfloat16 at hd 32 (wgmma would need a 64-byte
//    swizzle for a 32-wide K step): four warps of 16 query rows on
//    mma.sync m16n8k16, K and V^T tiles in padded shared memory.
//  * flash_f32_kernel<HD>, float32: CUDA-core FMAs (no TF32), four threads
//    to a query row, Q/K/V and p tiles in shared memory as float32.
// The last two run one CTA per (64-row query tile, batch, query head) and
// read K/V per query head; no main-path shape takes them.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;
constexpr int kF32Threads = 256;  // float32: four threads to a query row
constexpr int kMmaThreads = 128;  // bfloat16 hd 32: four warps of 16 query rows
// wgmma variant
constexpr int kWgRows = 64;                     // query rows of a consumer warpgroup
constexpr int kWgGroups = 2;                    // consumer warpgroups a CTA
constexpr int kWgConsumers = 128 * kWgGroups;
constexpr int kWgThreads = kWgConsumers + 32;   // and one producer warp
constexpr int kWgStages = 4;
constexpr int kBox = 64 * 64 * 2;               // a [64 x 64] bf16 TMA box: 64 rows of 128 bytes

// Where a launch's operands lie: element strides of batch and position
// (the head stride is hd, the last dimension contiguous); o is [B, S, H*hd].
struct Layout {
  int B, S, H, Hkv;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
};

// A CTA's (batch, query head, KV head) from its (batch * query head) index.
struct Head {
  int b, h, kvh;
};

__device__ __forceinline__ Head head_of(const Layout& L, int bh) {
  Head r;
  r.b = bh / L.H;
  r.h = bh - r.b * L.H;
  r.kvh = r.h / (L.H / L.Hkv);
  return r;
}

template <int HD>
struct WgShape {
  static constexpr int kBoxes = HD / 64;                      // boxes across a row
  static constexpr int kQBytes = kWgGroups * kBoxes * kBox;   // both warpgroups' Q
  static constexpr int kTileBytes = kBoxes * kBox;            // 64 rows of K or of V
  static constexpr int kStageBytes = 2 * kTileBytes;          // K, then V
  static constexpr int kSmem = kQBytes + kWgStages * kStageBytes + 1024;  // + alignment
};

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

// The [64 x 64] box of a 3-D `map` at (c0, c1, c2) <- shared memory at
// `src`, in the map's swizzle; rows outside the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until the bulk stores issued by this thread have read shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of d's N registers across the
// wgmma fences and waits, which it cannot see are tied to them.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64]: Q and K, both K-major in shared
// memory (128-byte swizzle); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] * B[16 x 64]: P from registers (the m16n8k16 A
// fragment of each warp's 16 rows), V MN-major in shared memory through the
// transpose bit.
__device__ __forceinline__ void wgmma_pv64(float* d, const unsigned* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
// d[64 x 128] += A[64 x 16] * B[16 x 128]: P from registers (the m16n8k16 A
// fragment of each warp's 16 rows), V MN-major in shared memory through the
// transpose bit.
__device__ __forceinline__ void wgmma_pv128(float* d, const unsigned* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// bfloat16, hd 64 or 128.  Threads 0-255 are the two consumer warpgroups,
// 256-287 the producer warp (one thread issues).  `pair` is 2 where the
// CTA takes two query heads of a KV group (H / Hkv even), else 1.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                       const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       const __grid_constant__ CUtensorMap tmap_o, int B, int S, int H,
                       int Hkv, int pair, float scale, int window) {
  using W = WgShape<HD>;
  extern __shared__ unsigned char fa_raw[];
  __shared__ __align__(8) unsigned long long full[kWgStages], empty[kWgStages], q_full;

  // the 128-byte swizzle repeats every 1024 bytes: TMA and wgmma agree on
  // it where every box starts on a 1024-byte boundary
  unsigned char* q_sm = fa_raw + ((1024 - (smem_addr(fa_raw) & 1023)) & 1023);
  unsigned char* ring = q_sm + W::kQBytes;

  // the CTA: a tile of `span` positions, batch b, KV head kvh, query heads
  // head0 .. head0 + pair - 1; the longest causal tiles come first
  const int group = H / Hkv, chunks = group / pair;
  const int span = kWgGroups / pair * kWgRows;
  const int per_tile = B * Hkv * chunks;
  const int n_tiles = (S + span - 1) / span;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int b = rest / (Hkv * chunks);
  const int kvh = rest / chunks % Hkv;
  const int head0 = kvh * group + rest % chunks * pair;
  const int p0 = tile * span;
  // its KV tiles: none past its last row, none wholly before its first
  // row's window
  const int kt_begin = window > 0 ? max(0, p0 - window + 1) / kBlockKV : 0;
  const int n_kv = (min(S, p0 + span) + kBlockKV - 1) / kBlockKV - kt_begin;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], kWgConsumers / 32);  // one arrival per consumer warp
    }
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWgConsumers) {  // producer
    if (tid == kWgConsumers) {
      // Q of both warpgroups; a warpgroup wholly past S loads nothing
      int q_bytes = 0;
      for (int w = 0; w < kWgGroups; ++w)
        if (p0 + (pair == 2 ? 0 : w * kWgRows) < S) q_bytes += W::kTileBytes;
      mbar_expect(&q_full, q_bytes);  // boxes count whole, zero fill included
      for (int w = 0; w < kWgGroups; ++w) {
        const int h = head0 + (pair == 2 ? w : 0), pw = p0 + (pair == 2 ? 0 : w * kWgRows);
        if (pw >= S) continue;
        for (int c = 0; c < W::kBoxes; ++c)
          tma_load_3d(q_sm + (w * W::kBoxes + c) * kBox, &tmap_q, h * HD + 64 * c, pw, b,
                      &q_full);
      }
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % kWgStages;
        if (i >= kWgStages) mbar_wait(&empty[s], (i / kWgStages - 1) & 1);
        unsigned char* st = ring + s * W::kStageBytes;
        const int k0 = (kt_begin + i) * kBlockKV;
        mbar_expect(&full[s], W::kStageBytes);
        for (int c = 0; c < W::kBoxes; ++c) {
          tma_load_3d(st + c * kBox, &tmap_k, kvh * HD + 64 * c, k0, b, &full[s]);
          tma_load_3d(st + W::kTileBytes + c * kBox, &tmap_v, kvh * HD + 64 * c, k0, b,
                      &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns 64 query rows of head h from position pw;
  // this thread holds rows row0 and row0 + 8 (accumulator elements 4j + e,
  // rows e / 2, columns 8j + 2 (l % 4) + e % 2)
  const int w = tid / 128, warp = tid / 32 % 4, l = tid % 32;
  const int h = head0 + (pair == 2 ? w : 0), pw = p0 + (pair == 2 ? 0 : w * kWgRows);
  const int row0 = pw + 16 * warp + l / 4;
  const unsigned q_addr = smem_addr(q_sm + w * W::kTileBytes);
  const unsigned ring_addr = smem_addr(ring);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  mbar_wait(&q_full, 0);

  for (int i = 0; i < n_kv; ++i) {
    const int s = i % kWgStages;
    const int k0 = (kt_begin + i) * kBlockKV;
    mbar_wait(&full[s], (i / kWgStages) & 1);
    // the warpgroup's own skip: a tile past its last row or wholly before
    // its first row's window (uniform across the warpgroup)
    const bool live = pw < S && k0 <= pw + kWgRows - 1 &&
                      !(window > 0 && k0 + kBlockKV - 1 <= pw - window);
    if (live) {
      const unsigned k_addr = ring_addr + s * W::kStageBytes;
      const unsigned v_addr = k_addr + W::kTileBytes;
      float sc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // 32 bytes of each 128-byte row at 32 (kk % 4), box kk / 4; 8-row
        // groups 1024 bytes apart
        const unsigned off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_qk(sc, wg_desc(q_addr + off, 16, 1024), wg_desc(k_addr + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(sc);

      // the mask changes nothing on a tile wholly at or before the first
      // row and wholly inside the last row's window
      const bool edge = k0 + kBlockKV - 1 > pw || (window > 0 && k0 <= pw + kWgRows - 1 - window);
      float mx[2] = {kNegInf, kNegInf};
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = row0 + 8 * (e / 2);
            const int kpos = k0 + 8 * j + 2 * (l % 4) + (e % 2);
            bool keep = kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            sc[4 * j + e] = keep ? sc[4 * j + e] * scale : kNegInf;
            mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
          }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          sc[e] *= scale;
          mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], sc[e]);
        }
      }
      float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row's four threads are one quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = __expf(m[r] - m_new);
        m[r] = m_new;
      }
      unsigned pa[kBlockKV / 16][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = __expf(sc[4 * j + e] - m[e / 2]);
          row_sum[e / 2] += p[e];
        }
        // keys 16t .. 16t + 16 of rows row0 and row0 + 8: the A fragment
        pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
        row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
        lsum[r] = lsum[r] * alpha[r] + row_sum[r];
      }
#pragma unroll
      for (int i2 = 0; i2 < HD / 2; ++i2) acc[i2] *= alpha[(i2 % 4) / 2];

      fence_regs<HD / 2>(acc);
      wg_fence();
#pragma unroll
      for (int t = 0; t < kBlockKV / 16; ++t) {
        // B: keys 16t .. 16t + 16, rows of 128 bytes at 2048 t; the next 64
        // columns of hd one box (8 KB) on; 8-row groups 1024 bytes apart
        const uint64_t db = wg_desc(v_addr + t * 2048, kBox, 1024);
        if constexpr (HD == 128)
          wgmma_pv128(acc, pa[t], db);
        else
          wgmma_pv64(acc, pa[t], db);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<HD / 2>(acc);
    }
    if (l == 0) mbar_arrive(&empty[s]);  // this warp no longer reads stage s
  }

  // the output tile, normalised, in bf16 into this warpgroup's Q buffer
  // (its products are done) in the boxes' 128-byte swizzle (16-byte chunk
  // j of row r at j ^ (r % 8): a warp's stores hit 32 distinct banks), then
  // one TMA store per box; rows past S are not written
  if (pw >= S) return;
  unsigned char* o_sm = q_sm + w * W::kTileBytes;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + l / 4 + 8 * r;
    const float inv = 1.f / fmaxf(lsum[r], 1e-30f);  // one division a row, not 64
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int chunk = (j % 8) ^ (row % 8);
      *reinterpret_cast<__nv_bfloat162*>(o_sm + (j / 8) * kBox + row * 128 + chunk * 16 +
                                         4 * (l % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");   // the warpgroup's writes
  if (tid % 128 == 0) {
    for (int c = 0; c < W::kBoxes; ++c)
      tma_store_3d(&tmap_o, o_sm + c * kBox, h * HD + 64 * c, pw, b);
    tma_store_wait();
  }
}

// bfloat16, hd 32: one CTA per (64-row query tile, batch * query head).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 const Layout L, float scale, int window) {
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
  const int S = L.S;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // the longest tiles first
  const Head who = head_of(L, blockIdx.x);
  const __nv_bfloat16* qb = q + who.b * L.q_sb + who.h * HD;
  const __nv_bfloat16* kb = k + who.b * L.k_sb + who.kvh * HD;
  const __nv_bfloat16* vb = v + who.b * L.v_sb + who.kvh * HD;
  const size_t ld = static_cast<size_t>(L.H) * HD;
  __nv_bfloat16* ob = o + static_cast<size_t>(who.b) * S * ld + who.h * HD;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Neighbouring threads take neighbouring rows of one 16-byte column chunk:
  // the transposed V stores then fall in distinct banks.
  for (int i = tid; i < kBlockQ * CH; i += kMmaThreads) {
    const int r = i % kBlockQ, c = (i / kBlockQ) * 8;
    *reinterpret_cast<uint4*>(&Qs[r * LD + c]) =
        q0 + r < S ? *reinterpret_cast<const uint4*>(&qb[(q0 + r) * L.q_ss + c]) : zero;
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
      *reinterpret_cast<uint4*>(&Ks[r * LD + c]) =
          in ? *reinterpret_cast<const uint4*>(&kb[(k0 + r) * L.k_ss + c]) : zero;
      const uint4 vv = in ? *reinterpret_cast<const uint4*>(&vb[(k0 + r) * L.v_ss + c]) : zero;
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
      *reinterpret_cast<__nv_bfloat162*>(&ob[qpos * ld + n * 8 + tig * 2]) =
          __floats2bfloat162_rn(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
  }
}

// float32: one CTA per (64-row query tile, batch * query head).
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, const Layout L,
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
  const int S = L.S;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // the longest tiles first
  const Head who = head_of(L, blockIdx.x);
  const float* qb = q + who.b * L.q_sb + who.h * HD;
  const float* kb = k + who.b * L.k_sb + who.kvh * HD;
  const float* vb = v + who.b * L.v_sb + who.kvh * HD;
  const size_t ld = static_cast<size_t>(L.H) * HD;
  float* ob = o + static_cast<size_t>(who.b) * S * ld + who.h * HD;

  for (int i = tid; i < kBlockQ * HD; i += kF32Threads) {
    const int rr = i / HD, d = i % HD;
    Qs[rr * LD + d] = (q0 + rr < S) ? qb[(q0 + rr) * L.q_ss + d] : 0.f;
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
      Ks[rr * LD + d] = in ? kb[(k0 + rr) * L.k_ss + d] : 0.f;
      Vs[rr * HD + d] = in ? vb[(k0 + rr) * L.v_ss + d] : 0.f;
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
    for (int j = 0; j < NO; ++j) ob[qpos * ld + sub + 4 * j] = acc[j] / denom;
  }
}

// The dynamic shared-memory limit of `kernel`, set once per device, so
// that a launch is nothing but the launch (and can be captured into a CUDA
// graph).
template <typename Kernel>
int prepare(Kernel kernel, bool* smem_set, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  return cudaSuccess;
}

// The float32 and hd 32 kernels on a (batch * query head, query tile) grid.
template <typename T, typename Kernel>
int launch_tiles(Kernel kernel, bool* smem_set, int threads, int smem, const void* q,
                 const void* k, const void* v, void* o, const Layout& L, float scale,
                 int window, cudaStream_t stream) {
  const int err = prepare(kernel, smem_set, smem);
  if (err != cudaSuccess) return err;
  const long long bh = static_cast<long long>(L.B) * L.H;
  const int tiles = (L.S + kBlockQ - 1) / kBlockQ;
  if (bh > INT_MAX || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bh), tiles);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), L, scale, window);
  return cudaGetLastError();
}

// A 3-D map of the bf16 view (cols, S, B) at `base`, innermost first, with
// row stride ss and batch stride sb in elements, in [64 x 64] boxes (128
// bytes, the swizzle's width); zeros outside the view.
bool encode_map_3d(CUtensorMap* map, const void* base, int cols, int S, int B, long long ss,
                   long long sb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, const Layout& L,
                 float scale, int window, cudaStream_t stream) {
  using W = WgShape<HD>;
  static bool smem_set[kMaxDevices] = {};
  const int err = prepare(flash_wgmma_kernel<HD>, smem_set, W::kSmem);
  if (err != cudaSuccess) return err;
  // TMA: 16-byte aligned bases and strides
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || reinterpret_cast<uintptr_t>(o) % 16 ||
      L.q_ss % 8 || L.q_sb % 8 || L.k_ss % 8 || L.k_sb % 8 || L.v_ss % 8 || L.v_sb % 8)
    return cudaErrorInvalidValue;
  const int group = L.H / L.Hkv;
  const int pair = group % 2 == 0 ? 2 : 1;
  const int span = kWgGroups / pair * kWgRows;
  const long long ctas = static_cast<long long>((L.S + span - 1) / span) * L.B * L.Hkv *
                         (group / pair);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  const long long o_ss = static_cast<long long>(L.H) * HD;
  CUtensorMap tq, tk, tv, to;
  if (!encode_map_3d(&tq, q, L.H * HD, L.S, L.B, L.q_ss, L.q_sb) ||
      !encode_map_3d(&tk, k, L.Hkv * HD, L.S, L.B, L.k_ss, L.k_sb) ||
      !encode_map_3d(&tv, v, L.Hkv * HD, L.S, L.B, L.v_ss, L.v_sb) ||
      !encode_map_3d(&to, o, L.H * HD, L.S, L.B, o_ss, o_ss * L.S))
    return cudaErrorInvalidValue;
  flash_wgmma_kernel<HD><<<static_cast<unsigned>(ctas), kWgThreads, W::kSmem, stream>>>(
      tq, tk, tv, to, L.B, L.S, L.H, L.Hkv, pair, scale, window);
  return cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, const Layout& L,
               float scale, int window, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  return launch_tiles<float>(flash_f32_kernel<HD>, smem_set, kF32Threads, f32_smem_bytes<HD>(),
                             q, k, v, o, L, scale, window, stream);
}

int launch_mma32(const void* q, const void* k, const void* v, void* o, const Layout& L,
                 float scale, int window, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  return launch_tiles<__nv_bfloat16>(flash_mma_kernel<32>, smem_set, kMmaThreads,
                                     mma_smem_bytes<32>(), q, k, v, o, L, scale, window, stream);
}

}  // namespace

extern "C" {

// q [B, S, H, hd], k/v [B, S, Hkv, hd] with element strides *_sb (batch)
// and *_ss (position), head stride hd, last dimension contiguous;
// o [B, S, H * hd] contiguous.  H % Hkv == 0; dtype is 0 for float32, 1
// for bfloat16; window <= 0 means no window.  bfloat16 needs 16-byte
// aligned bases and strides.
int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                    int Hkv, int hd, long long q_sb, long long q_ss, long long k_sb,
                    long long k_ss, long long v_sb, long long v_ss, int dtype, float scale,
                    int window, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const Layout L{B, S, H, Hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (hd) {
      case 32: return launch_mma32(q, k, v, o, L, scale, window, st);
      case 64: return launch_wgmma<64>(q, k, v, o, L, scale, window, st);
      case 128: return launch_wgmma<128>(q, k, v, o, L, scale, window, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (hd) {
      case 32: return launch_f32<32>(q, k, v, o, L, scale, window, st);
      case 64: return launch_f32<64>(q, k, v, o, L, scale, window, st);
      case 128: return launch_f32<128>(q, k, v, o, L, scale, window, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
