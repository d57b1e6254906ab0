// Blockwise online-softmax (flash) attention in f32 on Hopper's TF32 tensor
// cores (wgmma) with a 3xTF32 split (f32 accuracy), GQA, TMA-fed Q and K.
//
// Replaces the TPU kernel _fa_kernel / flash_attention in
// src/repro/kernels/flash_attn.py for f32 q, k, v with head dim 64, 128 or
// 256.  It computes what flash_attention_plain computes: out = softmax(q k^T
// / sqrt(d) + mask) v, where query head h reads key/value head h / (H /
// Hkv), the causal mask is the TPU kernel's top-left one (key kpos is hidden
// from query qpos when kpos > qpos), masked scores contribute exactly 0, and
// out = o / l with the l > 0 guard.  Both products, Q K^T and P V, run as
// three TF32 tensor-core passes on hi + lo splits (tf32x3::split: hi has its
// low 13 bits zero, lo = x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi, so they
// keep f32 accuracy; the softmax is f32 with IEEE expf (no fast math).
//
// Bound on an H100 at Yi-6B's prefill shape (B 4, H 32, Hkv 4, T = S = 2048,
// d 128, causal): 137.5 GFLOP of f32 products over the visible (query, key)
// pairs, three TF32 passes each, so 0.833 ms at 495 TFLOP/s; 302 MB of q, k,
// v and out, 0.090 ms at 3.35 TB/s: operations bound it (2.05 ms at the 67
// TFLOP/s FP32 SIMT rate of csrc/flash_attn.cu).  At recurrentgemma-2b's
// attention (4, 10, 1, 2048, d 256, causal): 85.9 GFLOP, 0.521 ms, against
// 185 MB, 0.055 ms (1.283 ms at the FP32 SIMT rate).
//
// Design (tile sizes per head dim in Smem<D>):
// - At d = 64 and 128 one block of two warpgroups (256 threads) owns one
//   (b, h, 128-row q tile); each warpgroup owns 64 query rows, wgmma's M,
//   and all of O's columns.  q tiles launch heaviest first.  The block
//   loops over 32-key tiles and skips those wholly above the diagonal; a
//   warpgroup also skips the tiles above its own rows (it still helps split
//   them).
// - TF32 wgmma reads A and B from shared memory only K-major (the transpose
//   bit is for 16-bit types), and each operand is needed as hi and lo.
//   Q and K have d contiguous, K-major for S = Q K^T: TMA lands them through
//   4-D tensor maps over (d, seq, heads, batch) built from the tensors' own
//   strides (the model's transposed views need no copy; a ragged T or S is
//   zero-filled; 5-D at d = 256, see below), 128-byte swizzled; the threads
//   then write each element's hi and its lo to buffers of the same layout
//   (at d 64 and 128 the hi over the element in place).  Q is split once;
//   K tile by tile, at d 64 and 128 through a 2-stage TMA ring.
// - V is (keys, d), MN-major for O += P V, so at d 64 and 128 the threads
//   load V tile j + 1 from device memory into registers while tile j
//   computes (at d = 256 TMA lands it, see below), and write it
//   transposed (rows d, keys contiguous) as hi and lo, in the 128-byte
//   swizzle the descriptors name: a 32-key row is one 128-byte line.
// - P comes from registers: the f32 accumulator fragment of S holds keys
//   {2t, 2t+1} of each 8-key group (t = lane % 4), the TF32 A fragment
//   wants k-slots {t, t+4}.  The order of keys inside a product is free, so
//   slot t takes key 2t and slot t + 4 key 2t + 1, and V^T's columns are
//   written in that order: no shuffle.  P is split in registers.
// - The tensor core's f32 accumulation truncates, and the error grows with
//   the passes summed in one accumulator (4.5e-6 at the prefill shape when
//   S and O were summed entirely in the core, measured).
//   So S sums its hi*hi passes in chains of 8 k-steps (one per 64-wide part
//   of d; at d = 256 see below) and its small passes in a third
//   accumulator, added in f32 registers; O sums each key tile's 12 passes
//   in a zeroed accumulator and takes it with one rounded fma, o = o *
//   alpha + part, which is also the online softmax's rescale.
// - The online softmax runs on the accumulator fragment: a thread holds
//   keys {2t, 2t+1} of each 8-key group for rows g and g + 8 of its warp's
//   16, and a row's max takes a quad shuffle.  m starts at the finite -1e30
//   and masked scores are -inf, so alpha = exp(m_old - m_new) is never NaN
//   and masked p are exactly 0.  V rows past S are loaded as 0.
// - Shared memory at d = 128: Q hi and lo 128 KB, the K ring 32 KB, K lo,
//   V^T hi and V^T lo 16 KB each: 208 KB, one block an SM.  The split
//   buffers of K and V are single: two barriers a tile.  No producer warp,
//   no ping-pong between the warpgroups yet, so the tensor core idles while
//   the block splits a tile and runs its softmax, and the m64n32 products
//   of S read 3 KB of shared memory per 32 KFLOP, more than the TF32 rate
//   needs: that is what holds it at about 2.4x its bound (inferred).
// - d = 256 (Smem<256>::SPLIT): Q hi and lo of 128 rows would be 256 KB,
//   over the 227 KB a block may use, and one warpgroup owning 64 rows x 256
//   columns would hold 128 registers of O and as many of a tile's part,
//   over the 255 a thread has.  So a block owns 64 query rows and the two
//   warpgroups split O's columns: warpgroup w owns columns 128 w .. 128 w +
//   127 (64 + 64 registers of O and part, as at d = 128) and the same half
//   of d for S, whose partial sums the two exchange.  Tiles stay 32 keys,
//   so S stays at least m64n32.  Shared memory, 225 KB: Q hi and lo 128
//   KB, one raw tile R (32 KB) that TMA lands K tile j in and then V tile
//   j, and per warpgroup a 32 KB region W_w that holds in turn its half of
//   d of K as (K lo, K hi) panel pairs, its 64 x 32 partial S (8 KB) and
//   its 128 rows of V^T hi and lo (16 KB each).  With a panel's K lo and K
//   hi side by side, S runs two products a k-step, Q lo * K hi (m64n32)
//   and Q hi * (K lo | K hi) (m64n64), so Q hi is read once for both of
//   its passes; the hi*hi pass sums in one chain of the warpgroup's 16
//   k-steps, each small pass in an accumulator of its own.  A tile:
//   warpgroup w waits for K in R, splits its half into W_w, runs its half
//   of S, writes the partial over its K; block barrier, after which the
//   second warpgroup has TMA land V in R; w adds the other's partial (the
//   same sum in both, so both run the same softmax) and splits P; block
//   barrier (the other has read W_w); w waits for V, writes its V^T from R
//   into W_w; block barrier, after which the first warpgroup has TMA land
//   K tile j + 1 in R; P V.  K and V land as one 5-D box each (32 columns
//   x 32 keys x 8 panels): eight 4-D boxes held the issuing thread long
//   enough that the other warpgroup waited for it at the next barrier.
//   Tried first and slower: 16-key tiles (S m64n16, twice the wgmma and
//   barriers a key), V loaded through registers (slow to issue, and it
//   spilled), and three m64n32 passes for S.  Per tile
//   (tools/flash_tf32_phases.py) S and P V take some two fifths of the
//   time; splitting K, writing V^T, the softmax and the barriers take the
//   rest, with the tensor core idle, since the exchange keeps the
//   warpgroups in step.  (Two warpgroups splitting the key tiles would
//   need a K and a V^T buffer each; folding one 64 x 256 O in two n128
//   halves would leave one warpgroup an SM.)
//
// Layouts: q (B, H, T, d), k and v (B, Hkv, S, d), out (B, H, T, d), each
// with unit stride in d and any other strides that are multiples of 4
// elements (16 bytes), 16-byte aligned; f32; d 64, 128 or 256.  The launch
// takes the tile (query rows, keys) and the shared-memory size that the
// wrapper computes (kernels/flash_attn.py:tf32_launch_config) and refuses
// any that differ from Smem<d>'s.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int BK = 32;           // keys per tile: one 128-byte line of V^T
constexpr int THREADS = 256;     // two warpgroups
constexpr int PANEL = 32;        // floats per 128-byte swizzled row
constexpr int STAGES = 2;        // K ring depth at d 64 and 128
constexpr float NEG_BIG = -1e30f;

template <int D>
struct Smem {
  static constexpr bool SPLIT = D == 256;              // warpgroups split O's columns
  static constexpr int BQ = SPLIT ? 64 : 128;          // query rows per block
  static constexpr int COLS = SPLIT ? D / 2 : D;       // O columns a warpgroup owns
  static constexpr int Q_BYTES = BQ * D * 4;           // Q hi, then Q lo
  static constexpr int K_BYTES = BK * D * 4;           // one K tile, or V^T tile
  static constexpr int QLO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;            // raw K ring; SPLIT: R, K or V
  static constexpr int KLO_OFF = K_OFF + (SPLIT ? 1 : STAGES) * K_BYTES;  // SPLIT: W_0
  static constexpr int VHI_OFF = KLO_OFF + K_BYTES;    //                SPLIT: W_1
  static constexpr int VLO_OFF = VHI_OFF + K_BYTES;
  static constexpr int BAR_OFF = SPLIT ? VHI_OFF + K_BYTES : VLO_OFF + K_BYTES;
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

// A 5-D box: SPLIT lands a whole K or V tile, every 32-column panel, at once.
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Writes by the threads become visible to wgmma and TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (the tensor maps' mode):
// 8-row groups 1024 bytes apart, atoms 1024-byte aligned (base offset 0).
// The start address is bits 0-13 in 16-byte units; shared addresses are
// below 256 KB, so desc(a) + (off >> 4) == desc(a + off): a k-step's
// descriptor is its operand's base plus an immediate.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint32_t lbo = 16, sbo = 1024;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D16 D8(0), D8(8)
#define D32 D16, D8(16), D8(24)
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
    "%30, %31}"
#define R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
    "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
    "%60, %61, %62, %63}"

// d (64 x 32, f32) (+)= A (64 x 8, shared) * B (8 x 32, shared), both K-major
// TF32; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
      ", %16, %17, p, 1, 1;\n}\n"
      : D16 : "l"(da), "l"(db), "r"(scale_d));
}

// The same at N = 64 (SPLIT: Q hi against a panel's K lo and K hi at once).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
      ", %32, %33, p, 1, 1;\n}\n"
      : D32 : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) (+)= A (64 x 8, registers) * B (8 x N, shared, K-major), TF32.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef D8
#undef D16
#undef D32
#undef D64
#undef R16
#undef R32
#undef R64

// A barrier of one warpgroup's 128 threads (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// ---- the kernel -------------------------------------------------------------

// Each of n4 16-byte chunks of x becomes its hi; its lo goes to lo.  NT
// threads (the block, or at d = 256 one warpgroup), this one tid.
template <int NT>
__device__ __forceinline__ void split_tile(float4* x, float4* lo, int n4, int tid) {
  for (int i = tid; i < n4; i += NT) {
    const float4 v = x[i];
    const tf32x3::Split a = tf32x3::split(v.x), b = tf32x3::split(v.y),
                        c = tf32x3::split(v.z), e = tf32x3::split(v.w);
    x[i] = make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                       __uint_as_float(c.hi), __uint_as_float(e.hi));
    lo[i] = make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                        __uint_as_float(c.lo), __uint_as_float(e.lo));
  }
}

// This thread's share of V tile k0 (keys past S read as 0).  Chunk c of
// V^T row n holds k-slots 4c .. 4c + 3, which are keys 8 (c / 2) + c % 2 +
// {0, 2, 4, 6}: slot t of an 8-key group takes key 2t, slot t + 4 key 2t + 1.
template <int D>
__device__ __forceinline__ void load_v(float (&vr)[D * (BK / 4) / THREADS][4],
                                       const float* __restrict__ vh, long long vst,
                                       int k0, int S, int tid) {
#pragma unroll
  for (int r = 0; r < D * (BK / 4) / THREADS; ++r) {
    const int idx = tid + THREADS * r;
    const int n = idx % D, c = idx / D;
    const int key = k0 + 8 * (c / 2) + c % 2;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      vr[r][e] = key + 2 * e < S ? __ldg(vh + (long long)(key + 2 * e) * vst + n) : 0.f;
  }
}

// V^T (D rows of 32 k-slots, one 128-byte swizzled line each) as hi and lo.
// Eight neighbouring lanes write eight rows: one chunk per bank group.
template <int D>
__device__ __forceinline__ void store_vt(const float (&vr)[D * (BK / 4) / THREADS][4],
                                         float* vhi, float* vlo, int tid) {
#pragma unroll
  for (int r = 0; r < D * (BK / 4) / THREADS; ++r) {
    const int idx = tid + THREADS * r;
    const int n = idx % D, c = idx / D;
    const int off = n * PANEL + ((c ^ (n % 8)) * 4);
    const tf32x3::Split a = tf32x3::split(vr[r][0]), b = tf32x3::split(vr[r][1]),
                        cc = tf32x3::split(vr[r][2]), e = tf32x3::split(vr[r][3]);
    *reinterpret_cast<float4*>(vhi + off) =
        make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                    __uint_as_float(cc.hi), __uint_as_float(e.hi));
    *reinterpret_cast<float4*>(vlo + off) =
        make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                    __uint_as_float(cc.lo), __uint_as_float(e.lo));
  }
}

// SPLIT: one warpgroup's 4 raw K panels (32 keys x 32 columns each) split
// into w as (lo, hi) panel pairs, 8 KB a pair: a 64-row B operand then
// holds a panel's K lo and K hi, and Q hi is read once for both passes.
__device__ __forceinline__ void split_k_pairs(const float4* raw, float4* w, int t) {
  constexpr int P4 = BK * 128 / 16;                  // 16-byte chunks a panel
  for (int i = t; i < 4 * P4; i += 128) {
    const float4 v = raw[i];
    const tf32x3::Split a = tf32x3::split(v.x), b = tf32x3::split(v.y),
                        c = tf32x3::split(v.z), e = tf32x3::split(v.w);
    float4* pair = w + (i / P4) * 2 * P4 + i % P4;
    pair[0] = make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                          __uint_as_float(c.lo), __uint_as_float(e.lo));
    pair[P4] = make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                           __uint_as_float(c.hi), __uint_as_float(e.hi));
  }
}

// SPLIT: V^T of one warpgroup's 128 columns (thread t of 128 takes row n =
// t) as hi and lo, from its 4 panels of the raw V tile TMA landed at vraw
// (per panel 32 keys of 32 columns, 128-byte rows, swizzled).  A warp reads
// one 128-byte row a load and writes as store_vt does: no bank conflicts.
__device__ __forceinline__ void store_vt_from_tile(const float* vraw, float* vhi,
                                                   float* vlo, int t) {
  const float* col = vraw + (t / PANEL) * (BK * PANEL);
  const int cn = t % PANEL;
#pragma unroll
  for (int c = 0; c < BK / 4; ++c) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * (c / 2) + c % 2 + 2 * e;
      x[e] = col[key * PANEL + (((cn / 4) ^ (key % 8)) * 4) + cn % 4];
    }
    const int off = t * PANEL + ((c ^ (t % 8)) * 4);
    const tf32x3::Split a = tf32x3::split(x[0]), b = tf32x3::split(x[1]),
                        cc = tf32x3::split(x[2]), e = tf32x3::split(x[3]);
    *reinterpret_cast<float4*>(vhi + off) =
        make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                    __uint_as_float(cc.hi), __uint_as_float(e.hi));
    *reinterpret_cast<float4*>(vlo + off) =
        make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                    __uint_as_float(cc.lo), __uint_as_float(e.lo));
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const float* __restrict__ v, long long vsb, long long vsh,
                       long long vst, float* __restrict__ out, long long osb,
                       long long osh, long long ost, int H, int Hkv, int T, int S,
                       float scale, int causal, const __grid_constant__ CUtensorMap tv) {
  using L = Smem<D>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int BQ = L::BQ, COLS = L::COLS;
  constexpr int KSTEPS = COLS / 8;                   // k-steps of S a warpgroup runs
  constexpr int NMAIN = KSTEPS / 8;                  // hi*hi chains of 8 k-steps
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = smem_u32(base);
  const uint32_t sqlo = sq + L::QLO_OFF;
  const uint32_t sk = sq + L::K_OFF, sklo = sq + L::KLO_OFF;
  const uint32_t svhi = sq + L::VHI_OFF, svlo = sq + L::VLO_OFF;
  const uint32_t bar_q = sq + L::BAR_OFF;
  const uint32_t bar_k = bar_q + 8;                  // one per stage
  [[maybe_unused]] const uint32_t bar_v = bar_q + 24;  // SPLIT: the raw V tile
  float* vhi = reinterpret_cast<float*>(base + L::VHI_OFF);
  float* vlo = reinterpret_cast<float*>(base + L::VLO_OFF);

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
  const float* vh = v + b * vsb + hkv * vsh;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_k + 8 * s, 1);
    if constexpr (SPLIT) mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p)
      tma_load(sq + p * BQ * 128, &tq, bar_q, p * PANEL, q0, h, b);
    mbar_expect_tx(bar_k, L::K_BYTES);
    if constexpr (SPLIT) {
      tma_load5(sk, &tk, bar_k, 0, 0, 0, hkv, b);
    } else {
#pragma unroll
      for (int p = 0; p < D / PANEL; ++p)
        tma_load(sk + p * BK * 128, &tk, bar_k, p * PANEL, 0, hkv, b);
    }
  }
  float vr[D * (BK / 4) / THREADS][4];                // d 64 and 128: V tile j + 1
  if constexpr (!SPLIT) load_v<D>(vr, vh, vst, 0, S, tid);

  // this warpgroup's rows and columns: rows 64 wg .. and every column, or
  // (SPLIT) the block's 64 rows and columns COLS wg ..
  const int wg_row = SPLIT ? 0 : 64 * wg, col0 = SPLIT ? COLS * wg : 0;
  // SPLIT: thread wt of this warpgroup, its region W_w (at w_reg, sw)
  [[maybe_unused]] const int wt = tid % 128;
  [[maybe_unused]] uint8_t* w_reg = base + L::KLO_OFF + wg * L::K_BYTES;
  [[maybe_unused]] const uint32_t sw = sq + L::KLO_OFF + wg * L::K_BYTES;
  constexpr int HALF = L::K_BYTES / 2;               // SPLIT: K hi, K lo, V^T hi, lo
  // this thread's rows (block-relative) and key pair within each 8 keys
  const int r0 = wg_row + 16 * warp + lane / 4;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const int cq = 2 * (lane % 4);
  const int wg_first = q0 + wg_row, wg_last = wg_first + 63;

  float o[COLS / 2];
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  if constexpr (SPLIT) {                            // this warpgroup's Q panels
    float4* qw = reinterpret_cast<float4*>(base + wg * (L::Q_BYTES / 2));
    split_tile<128>(qw, qw + L::Q_BYTES / 16, L::Q_BYTES / 32, wt);
  } else {
    split_tile<THREADS>(reinterpret_cast<float4*>(base),
                        reinterpret_cast<float4*>(base + L::QLO_OFF), L::Q_BYTES / 16, tid);
  }
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    const int k0 = j * BK;
    const uint32_t ks = sk + st * L::K_BYTES;
    if constexpr (SPLIT) {
      // ---- split this warpgroup's half of raw K tile j into W_w ----
      mbar_wait(bar_k, j & 1);
      split_k_pairs(reinterpret_cast<const float4*>(base + L::K_OFF + wg * HALF),
                    reinterpret_cast<float4*>(w_reg), wt);
      fence_proxy_async();
      wg_sync(wg);
    } else {
      // ---- split K tile j in place (lo to its twin) and write V^T tile j ----
      mbar_wait(bar_k + 8 * st, (j / STAGES) & 1);
      split_tile<THREADS>(reinterpret_cast<float4*>(base + L::K_OFF + st * L::K_BYTES),
                          reinterpret_cast<float4*>(base + L::KLO_OFF), L::K_BYTES / 16, tid);
      store_vt<D>(vr, vhi, vlo, tid);
      fence_proxy_async();
      __syncthreads();
      // stage (j + 1) % 2 was last read by tile j - 1, whose products are done
      if (tid == 0 && j + 1 < ntiles) {
        const int sn = (j + 1) % STAGES;
        mbar_expect_tx(bar_k + 8 * sn, L::K_BYTES);
#pragma unroll
        for (int p = 0; p < D / PANEL; ++p)
          tma_load(sk + sn * L::K_BYTES + p * BK * 128, &tk, bar_k + 8 * sn, p * PANEL,
                   k0 + BK, hkv, b);
      }
      if (j + 1 < ntiles) load_v<D>(vr, vh, vst, k0 + BK, S, tid);  // in flight meanwhile
    }

    // (SPLIT: both warpgroups share wg_last and take every tile together)
    if (!causal || k0 <= wg_last) {                  // else every score is masked
      float s[BK / 2];
      if constexpr (SPLIT) {
        // ---- S over this warpgroup's half of d: Q lo * K hi in sc, and
        // Q hi * (K lo | K hi) in cm, one m64n64 a k-step over a panel
        // pair (columns 0-31 the small pass, 32-63 hi*hi) ----
        float sc[BK / 2], cm[BK];
        fence_regs(sc);
        fence_regs(cm);
        wgmma_fence();
        const uint32_t qoff = wg * (L::Q_BYTES / 2);
        const uint64_t dq = sw128_desc(sq + qoff), dqlo = sw128_desc(sqlo + qoff);
        const uint64_t dkp = sw128_desc(sw);
#define QO(kk) ((((kk) / 4) * BQ * 128 + ((kk) % 4) * 32) >> 4)
#define KPO(kk) ((((kk) / 4) * 2 * BK * 128 + ((kk) % 4) * 32) >> 4)
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          wgmma_ss(sc, dqlo + QO(kk), dkp + KPO(kk) + (BK * 128 >> 4), kk > 0);
          wgmma_ss(cm, dq + QO(kk), dkp + KPO(kk), kk > 0);
        }
#undef QO
#undef KPO
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(cm);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = (cm[i] + sc[i]) + cm[BK / 2 + i];
      } else {
        // ---- S = Q K^T (64 x 32 per warpgroup): small passes, then hi*hi ----
        float sc[BK / 2], sm[NMAIN][BK / 2];
        fence_regs(sc);
#pragma unroll
        for (int c = 0; c < NMAIN; ++c) fence_regs(sm[c]);
        wgmma_fence();
        // panel kk / 4, 32 bytes (8 values) along the swizzled row per step
        const uint64_t dq = sw128_desc(sq + wg * 64 * 128);
        const uint64_t dqlo = sw128_desc(sqlo + wg * 64 * 128);
        const uint64_t dk = sw128_desc(ks), dklo = sw128_desc(sklo);
#define QO(kk) ((((kk) / 4) * BQ * 128 + ((kk) % 4) * 32) >> 4)
#define KO(kk) ((((kk) / 4) * BK * 128 + ((kk) % 4) * 32) >> 4)
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          wgmma_ss(sc, dqlo + QO(kk), dk + KO(kk), kk > 0);
          wgmma_ss(sc, dq + QO(kk), dklo + KO(kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          wgmma_ss(sm[kk / 8], dq + QO(kk), dk + KO(kk), kk % 8 > 0);
#undef QO
#undef KO
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
#pragma unroll
        for (int c = 0; c < NMAIN; ++c) fence_regs(sm[c]);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float x = sm[0][i];
#pragma unroll
          for (int c = 1; c < NMAIN; ++c) x += sm[c][i];
          s[i] = x + sc[i];
        }
      }
      if constexpr (SPLIT) {
        // S = this warpgroup's half + the other's, the same sum in both: the
        // partial goes over this warpgroup's K in W_w, which no one reads now
        float* xs = reinterpret_cast<float*>(w_reg);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) xs[i * 128 + wt] = s[i];
        __syncthreads();
        // both halves of the raw K tile are split: V tile j may land there
        // (issued by the second warpgroup; the first issues K's)
        if (tid == 128) {
          mbar_expect_tx(bar_v, L::K_BYTES);
          tma_load5(sk, &tv, bar_v, 0, k0, 0, hkv, b);
        }
        const float* other = reinterpret_cast<const float*>(
            base + L::KLO_OFF + (1 - wg) * L::K_BYTES);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] += other[i * 128 + wt];
      }

      // ---- online softmax on the accumulator fragment ----
      const bool need_mask = k0 + BK > S || (causal && k0 + BK - 1 > wg_first);
      float alpha[2];
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
        alpha[hr] = expf(m[hr] - m_new);
        float rsum = 0.f;
#pragma unroll
        for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * n8 + 2 * hr + e;
            s[i] = expf(s[i] - m_new);          // exactly 0 where masked
            rsum += s[i];
          }
        l[hr] = l[hr] * alpha[hr] + rsum;       // this thread's keys; quad sum at the end
        m[hr] = m_new;
      }

      // ---- part = P V (three passes), o = o * alpha + part ----
      // A slot t <- key 2t, slot t + 4 <- key 2t + 1: {s0, s2, s1, s3} per group
      uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int perm[4] = {0, 2, 1, 3};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const tf32x3::Split x = tf32x3::split(s[4 * kk + perm[e]]);
          ph[kk][e] = x.hi;
          pl[kk][e] = x.lo;
        }
      }
      uint32_t vthi = svhi, vtlo = svlo;
      if constexpr (SPLIT) {
        // V^T of this warpgroup's columns over its partial S in W_w, once
        // the other warpgroup has read that
        __syncthreads();
        mbar_wait(bar_v, j & 1);
        store_vt_from_tile(reinterpret_cast<const float*>(base + L::K_OFF + wg * HALF),
                           reinterpret_cast<float*>(w_reg),
                           reinterpret_cast<float*>(w_reg + HALF), wt);
        fence_proxy_async();
        __syncthreads();
        // both halves of the raw V tile are read: K tile j + 1 may land
        if (tid == 0 && j + 1 < ntiles) {
          mbar_expect_tx(bar_k, L::K_BYTES);
          tma_load5(sk, &tk, bar_k, 0, k0 + BK, 0, hkv, b);
        }
        vthi = sw;
        vtlo = sw + HALF;
      }
      float part[COLS / 2];
      fence_regs(part);
      fence_regs(ph);
      fence_regs(pl);
      const uint64_t dvhi = sw128_desc(vthi), dvlo = sw128_desc(vtlo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)       // 8 k-slots (32 bytes) a step
        wgmma_rs(part, pl[kk], dvhi + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_rs(part, ph[kk], dvlo + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_rs(part, ph[kk], dvhi + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(ph);
      fence_regs(pl);
#pragma unroll
      for (int i = 0; i < COLS / 2; ++i) o[i] = fmaf(o[i], alpha[(i / 2) % 2], part[i]);
    }
    // K lo and V^T are free for tile j + 1 (SPLIT: W_w is this warpgroup's alone)
    if constexpr (!SPLIT) __syncthreads();
  }

  // ---- epilogue: o / l ----
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (qpos[hr] >= T) continue;
    const float den = lt > 0.f ? lt : 1.f;
    float* orow = out + b * osb + h * osh + (long long)qpos[hr] * ost + col0;
#pragma unroll
    for (int n8 = 0; n8 < COLS / 8; ++n8) {
      const int i = 4 * n8 + 2 * hr;
      *reinterpret_cast<float2*>(orow + 8 * n8 + cq) =
          make_float2(o[i] / den, o[i + 1] / den);
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

// A 4-D f32 map over (d, seq, heads, batch) with strides in elements; boxes
// of 32 x rows x 1 x 1, 128-byte swizzle, out-of-range rows read as zeros.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d,
                  int seq, int heads, int batch, long long s_seq,
                  long long s_head, long long s_batch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_seq * 4, (cuuint64_t)s_head * 4,
                                 (cuuint64_t)s_batch * 4};
  const cuuint32_t box[4] = {(cuuint32_t)PANEL, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// SPLIT's K and V: a 5-D map over (32 columns, seq, d / 32 panels, heads,
// batch), so one box of 32 x rows x d / 32 lands every panel of a tile,
// panel after panel, as the 4-D boxes do one at a time.
CUresult make_map5(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d,
                   int seq, int heads, int batch, long long s_seq,
                   long long s_head, long long s_batch, int rows) {
  const cuuint64_t dims[5] = {(cuuint64_t)PANEL, (cuuint64_t)seq, (cuuint64_t)(d / PANEL),
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[4] = {(cuuint64_t)s_seq * 4, (cuuint64_t)PANEL * 4,
                                 (cuuint64_t)s_head * 4, (cuuint64_t)s_batch * 4};
  const cuuint32_t box[5] = {(cuuint32_t)PANEL, (cuuint32_t)rows, (cuuint32_t)(d / PANEL),
                             1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int Hkv, int T, int S, long long qsb, long long qsh, long long qst,
           long long ksb, long long ksh, long long kst, long long vsb,
           long long vsh, long long vst, long long osb, long long osh,
           long long ost, int bq, int bk, int smem, float scale, int causal,
           cudaStream_t stream) {
  using L = Smem<D>;
  if (bq != L::BQ || bk != BK || smem != L::BYTES || (T + L::BQ - 1) / L::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return -999;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(enc, &tq, q, D, T, H, B, qst, qsh, qsb, L::BQ);
  if (r == CUDA_SUCCESS && !L::SPLIT)
    r = make_map(enc, &tk, k, D, S, Hkv, B, kst, ksh, ksb, BK);
  if (r == CUDA_SUCCESS && L::SPLIT)
    r = make_map5(enc, &tk, k, D, S, Hkv, B, kst, ksh, ksb, BK);
  if (r == CUDA_SUCCESS && L::SPLIT)
    r = make_map5(enc, &tv, v, D, S, Hkv, B, vst, vsh, vsb, BK);
  if (r != CUDA_SUCCESS) return -(int)r;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attn_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (T + L::BQ - 1) / L::BQ);
  flash_attn_tf32_kernel<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, (const float*)v, vsb, vsh, vst, (float*)out, osb, osh, ost, H, Hkv,
      T, S, scale, causal, L::SPLIT ? tv : tk);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements, (batch, head, seq) for each tensor; the unit
// stride of d is implied.  bq, bk and smem are the wrapper's tile (query
// rows, keys) and shared-memory bytes, checked against the kernel's.
// Returns 0, a cudaError_t, or -(CUresult) when a tensor map cannot be
// encoded (-999: cuTensorMapEncodeTiled is unavailable).
extern "C" int flash_attn_tf32_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Hkv, int T, int S, int d, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost, int bq, int bk,
    int smem, float scale, int causal, void* stream) {
  if ((d != 64 && d != 128 && d != 256) || B <= 0 || H <= 0 || Hkv <= 0 ||
      H % Hkv || T <= 0 || S <= 0 || (long long)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS q, k, v, out, B, H, Hkv, T, S, qsb, qsh, qst, ksb, ksh, kst, vsb, \
             vsh, vst, osb, osh, ost, bq, bk, smem, scale, causal, st
  if (d == 64) return launch<64>(ARGS);
  if (d == 128) return launch<128>(ARGS);
  return launch<256>(ARGS);
#undef ARGS
}
