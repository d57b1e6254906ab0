// Blockwise online-softmax (flash) attention on Hopper's tensor cores: bf16
// operands, f32 accumulation, GQA, TMA-fed tiles.
//
// Replaces the TPU kernel _fa_kernel / flash_attention in
// src/repro/kernels/flash_attn.py for bf16 q, k, v with head dim 64, 128 or
// 256.
// It computes what csrc/flash_attn.cu and flash_attention_plain compute:
// out = softmax(q k^T / sqrt(d) + mask) v, where query head h of batch b
// reads key/value head h / (H / Hkv) (kv_row = (bh / H) * Hkv + (bh % H) /
// (H / Hkv)), the causal mask is the TPU kernel's top-left one (key kpos is
// hidden from query qpos when kpos > qpos), masked scores contribute exactly
// 0, out = o / l with the l > 0 guard, and out is bf16.  The TPU kernel's
// f32 jnp.dots are single bf16 MXU passes at XLA's default precision, so
// bf16 products with f32 sums compute what the reference computes; P is
// rounded to bf16 for the P V product, l sums the f32 probabilities.
//
// Bound on an H100 at Yi-6B's prefill shape (B 4, H 32, Hkv 4, T = S = 2048,
// d 128, causal): 137.5 GFLOP over the visible (query, key) pairs and 151 MB
// of q, k, v and out, so 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak
// and 0.045 ms by bytes: operations bound it.  At recurrentgemma-2b's
// attention (4, 10, 1, 2048, d 256, causal) 85.9 GFLOP, 0.0869 ms.  Design,
// simple first:
// - One block of two warpgroups (256 threads) owns one (b, h, 128-row q
//   tile); each warpgroup owns 64 query rows, wgmma's M.  q tiles launch
//   heaviest first.  The block loops over key tiles of BK = 128 keys (64 at
//   d = 256, where Q's 64 KB and two stages of 128-key K and V tiles would
//   be 320 KB of the 227 KB a block may use; 64-key tiles make it 192 KB)
//   and skips the tiles wholly above the diagonal; with 64-key tiles the
//   first warpgroup also skips the last tile, which lies above its rows.
// - TMA loads Q once and K, V tile by tile through 4-D tensor maps over
//   (d, seq, heads, batch) built from the tensors' own strides, so strided
//   views need no copy and a ragged T or S is zero-filled per head.  Rows
//   are 128-byte swizzled (a 128-wide row is two 64-wide panels).  K and V
//   go through a 2-stage ring, one mbarrier per stage with its phase bit;
//   thread 0 issues tile j + 1 before the block computes on tile j.  No
//   producer warpgroup and no setmaxnreg yet: warp specialisation and
//   ping-pong scheduling are later work.  At d = 256 a row is four panels.
// - S = Q K^T is wgmma m64nBKk16 with Q and K read from shared memory,
//   both K-major.  The online softmax runs on the accumulator fragment in
//   f32 with IEEE expf (built without fast math): a thread holds column
//   pairs of rows warp*16 + lane/4 and + 8, and a row's max takes a quad
//   shuffle.  m starts at the finite -1e30 and masked scores are -inf, so
//   alpha = exp(m_old - m_new) is never NaN and masked p are exactly 0.
// - O += P V is wgmma with P from registers: the f32 accumulator layout of
//   S is the bf16 A-fragment layout, so P packs pairs of floats in place.
//   V is (keys, d), MN-major for the product: the B-transpose bit is set.
//   At d = 256 the product is two m64n128k16 per 16 keys, one per pair of
//   V's 64-wide panels (the second at two panels' offset).  O stays in f32
//   registers (128 a thread at d = 256, with S's 32 and P's 16: no room
//   for more keys a tile), scaled by alpha per tile; the epilogue divides
//   by l once, rounds to bf16 and stores rows < T.
//
// Layouts: q (B, H, T, d), k and v (B, Hkv, S, d), out (B, H, T, d), each
// with unit stride in d and any other strides that are multiples of 8
// elements (16 bytes), 16-byte aligned; bf16; d 64, 128 or 256.  The
// launch takes the key tile and the shared-memory size that the wrapper
// computes (kernels/flash_attn.py:tc_launch_config) and refuses a pair that
// differs from Smem<d>'s.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // query rows per block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int PANEL = 64;        // bf16 values per 128-byte swizzled row
constexpr int STAGES = 2;        // K/V ring depth
constexpr float NEG_BIG = -1e30f;

template <int D>
struct Smem {
  static constexpr int BK = D == 256 ? 64 : 128;       // keys per tile
  static constexpr int ON = D < 128 ? D : 128;         // O columns per P V product
  static constexpr int NO = D / ON;                    // P V products per 16 keys
  static constexpr int NP = D / PANEL;                 // panels per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;          // one tile of K or of V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;     // K then V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 64 + 1024;    // barriers, alignment slack
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (the tensor maps' mode).
// Atoms of 8 rows x 128 bytes are 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes across its issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D32 D8(0), D8(8), D8(16), D8(24)
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
    "%30, %31}"
#define R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
    "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
    "%60, %61, %62, %63}"

// d (64 x N, f32) (+)= A (64 x 16, shared, K-major) * B (16 x N, shared,
// K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32 : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64 : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) (+)= A (64 x 16, registers) * B (16 x N, shared, MN-major:
// the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef D8
#undef D32
#undef D64
#undef R32
#undef R64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- the kernel -------------------------------------------------------------

// K and V tile j into ring stage j % STAGES; one thread issues it.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t skv, uint32_t bar_kv, int j,
                                        int hkv, int b) {
  using L = Smem<D>;
  const int st = j % STAGES;
  const uint32_t bar = bar_kv + 8 * st;
  const uint32_t ks = skv + st * L::STAGE_BYTES, vs = ks + L::KV_BYTES;
  mbar_expect_tx(bar, L::STAGE_BYTES);
#pragma unroll
  for (int p = 0; p < L::NP; ++p) {
    tma_load(ks + p * L::BK * 128, tk, bar, p * PANEL, j * L::BK, hkv, b);
    tma_load(vs + p * L::BK * 128, tv, bar, p * PANEL, j * L::BK, hkv, b);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_tc_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ out, long long osb,
                     long long osh, long long ost, int H, int Hkv, int T, int S,
                     float scale, int causal) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = smem_u32(base);
  const uint32_t skv = sq + L::Q_BYTES;
  const uint32_t bar_q = sq + L::BAR_OFF;
  const uint32_t bar_kv = bar_q + 8;                 // one per stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest q tiles first
  const int kend = causal ? min(S, min(q0 + BQ, T)) : S;
  const int ntiles = (kend + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      tma_load(sq + p * BQ * 128, &tq, bar_q, p * PANEL, q0, h, b);
    load_kv<D>(&tk, &tv, skv, bar_kv, 0, hkv, b);
  }

  // this thread's rows (block-relative) and column pair within each 8 columns
  const int r0 = 64 * wg + 16 * warp + lane / 4;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const int cq = 2 * (lane % 4);
  const int wg_first_row = q0 + 64 * wg;

  float o[L::NO][L::ON / 2];
#pragma unroll
  for (int hh = 0; hh < L::NO; ++hh)
#pragma unroll
    for (int i = 0; i < L::ON / 2; ++i) o[hh][i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    const int k0 = j * BK;
    // the stage of tile j + 1 was released by the __syncthreads closing
    // iteration j - 1
    if (tid == 0 && j + 1 < ntiles) load_kv<D>(&tk, &tv, skv, bar_kv, j + 1, hkv, b);
    mbar_wait(bar_kv + 8 * st, (j / STAGES) & 1);
    const uint32_t ks = skv + st * L::STAGE_BYTES, vs = ks + L::KV_BYTES;
    // a tile wholly above this warpgroup's rows adds nothing (only 64-key
    // tiles can be: BK == BQ compiles the test away)
    if (BK < BQ && causal && k0 > wg_first_row + 63) {
      __syncthreads();                        // stage st is free for tile j + 2
      continue;
    }

    // ---- S = Q K^T (64 x BK per warpgroup) ----
    float s[BK / 2];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // panel kk / 4, 32 bytes (16 values) along the swizzled row per step
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da =
          sw128_desc(sq + (kk / 4) * BQ * 128 + wg * 64 * 128 + off, 16, 1024);
      const uint64_t db = sw128_desc(ks + (kk / 4) * BK * 128 + off, 16, 1024);
      wgmma_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // ---- online softmax on the accumulator fragment ----
    const bool need_mask = k0 + BK > S || (causal && k0 + BK - 1 > wg_first_row);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n8 + 2 * hr + e;
          float x = s[i] * scale;
          if (need_mask) {
            const int kpos = k0 + 8 * n8 + cq + e;
            if (kpos >= S || (causal && kpos > qpos[hr])) x = -CUDART_INF_F;
          }
          s[i] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = expf(m[hr] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n8 + 2 * hr + e;
          s[i] = expf(s[i] - m_new);          // exactly 0 where masked
          rsum += s[i];
        }
      l[hr] = l[hr] * alpha + rsum;           // this thread's columns; quad sum at the end
      m[hr] = m_new;
#pragma unroll
      for (int hh = 0; hh < L::NO; ++hh)
#pragma unroll
        for (int n8 = 0; n8 < L::ON / 8; ++n8) {
          o[hh][4 * n8 + 2 * hr] *= alpha;
          o[hh][4 * n8 + 2 * hr + 1] *= alpha;
        }
    }

    // ---- O += P V, P from registers in the A-fragment layout ----
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)   // 16 keys a step; panels BK * 128 B apart
#pragma unroll
      for (int hh = 0; hh < L::NO; ++hh)   // O columns hh * ON.. : panel hh * ON / 64
        wgmma_rs(o[hh], pa[kk],
                 sw128_desc(vs + kk * 16 * 128 + hh * (L::ON / PANEL) * BK * 128,
                            BK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    __syncthreads();                          // stage st is free for tile j + 2
  }

  // ---- epilogue: o / l, rounded once to bf16 ----
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (qpos[hr] >= T) continue;
    const float den = lt > 0.f ? lt : 1.f;
    __nv_bfloat16* orow = out + b * osb + h * osh + (long long)qpos[hr] * ost;
#pragma unroll
    for (int hh = 0; hh < L::NO; ++hh)
#pragma unroll
      for (int n8 = 0; n8 < L::ON / 8; ++n8) {
        const int i = 4 * n8 + 2 * hr;
        *reinterpret_cast<__nv_bfloat162*>(orow + hh * L::ON + 8 * n8 + cq) =
            __floats2bfloat162_rn(o[hh][i] / den, o[hh][i + 1] / den);
      }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime: nothing new to link.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (d, seq, heads, batch) with strides in elements; boxes of
// 64 x rows x 1 x 1, 128-byte swizzle, out-of-range rows read as zeros.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d,
                  int seq, int heads, int batch, long long s_seq,
                  long long s_head, long long s_batch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_seq * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {(cuuint32_t)PANEL, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int Hkv, int T, int S, long long qsb, long long qsh, long long qst,
           long long ksb, long long ksh, long long kst, long long vsb,
           long long vsh, long long vst, long long osb, long long osh,
           long long ost, int bk, int smem, float scale, int causal,
           cudaStream_t stream) {
  if (bk != Smem<D>::BK || smem != Smem<D>::BYTES) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return -999;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(enc, &tq, q, D, T, H, B, qst, qsh, qsb, BQ);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tk, k, D, S, Hkv, B, kst, ksh, ksb, bk);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tv, v, D, S, Hkv, B, vst, vsh, vsb, bk);
  if (r != CUDA_SUCCESS) return -(int)r;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attn_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_attn_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, osb, osh, ost, H, Hkv, T, S, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements, (batch, head, seq) for each tensor; the unit
// stride of d is implied.  bk and smem are the wrapper's key tile and
// shared-memory bytes, checked against the kernel's.  Returns 0, a
// cudaError_t, or -(CUresult) when a tensor map cannot be encoded (-999:
// cuTensorMapEncodeTiled is unavailable).
extern "C" int flash_attn_tc_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Hkv, int T, int S, int d, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost, int bk,
    int smem, float scale, int causal, void* stream) {
  if ((d != 64 && d != 128 && d != 256) || B <= 0 || H <= 0 || Hkv <= 0 ||
      H % Hkv || T <= 0 || S <= 0 || (T + BQ - 1) / BQ > 65535 ||
      (long long)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS q, k, v, out, B, H, Hkv, T, S, qsb, qsh, qst, ksb, ksh, kst, vsb, \
             vsh, vst, osb, osh, ost, bk, smem, scale, causal, st
  if (d == 64) return launch<64>(ARGS);
  if (d == 128) return launch<128>(ARGS);
  return launch<256>(ARGS);
#undef ARGS
}
