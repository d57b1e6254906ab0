// Parity-folded multipole-to-local contraction (M2L) over parent planes, on
// Hopper's TF32 tensor cores with a 3xTF32 split (f32 accuracy).
//
// Replaces the TPU kernel _m2l_kernel / m2l_pallas_slab in
// src/repro/kernels/m2l.py.  With K = 4p,
//   out[y, x, b] = sum_{d < 8} sum_{a < K} stack[1 + Dy_d + y, 1 + Dx_d + x, a]
//                                          * W[d, a, b]
// over the PARENT_NEIGH8 offsets (Dx_d, Dy_d), in complex arithmetic.  The
// caller relayouts levels into the (PR+2, PC+2, K) stack and back.
//
// The complex product is one real product on the interleaved (re, im) f32
// view of the complex64 arrays: a row of the stack is 2K floats
// [s_r, s_i, ...], and W[d] acts as the 2K x 2K real matrix
//   B[2a + s][2b + u] = s == u ? W_r[a][b] : (s == 0 ? W_i[a][b] : -W_i[a][b]),
// so out's interleaved row is the stack's row times B.  2K = 8p is a
// multiple of 8, so neither K (the product's depth) nor N needs padding;
// B is never built: each thread reads its B fragment from W[d] as a
// complex (row a, column b) entry and flips the sign it needs.
//
// Bound on an H100 at the leaf (level 10, p = 17, a 514 x 514 stack): 65.5
// GFLOP of f32 products over the operator's 108 nonzero p x p blocks, so
// 0.397 ms for the three TF32 passes at 495 TFLOP/s, against 287 MB of
// stack, W and out, 0.086 ms at 3.35 TB/s: operations bound it (0.977 ms
// at the 67 TFLOP/s FP32 SIMT rate the previous kernel ran on).
//
// Design:
// - One block of 8 warps owns an 8 x 8 tile of parents, the 64 rows of the
//   product.  It stages its (8+2) x (8+2) x 2K halo tile of the stack in
//   shared memory once, with parents 8p + 4 floats apart so that the 8 rows
//   of an A fragment fall in distinct banks.  Warp w computes rows
//   16 (w % 4) .. + 15 (two parent rows) and half the 2K output columns
//   (p n-tiles of 8, split 9 + 8 at p = 17), accumulating the 8 offsets in
//   registers; the block writes once at the end, masking the ragged edge.
// - A fragments come from the halo at the offset's shifted window (any
//   addressing: mma.sync takes A from registers, so a window shifted by one
//   parent needs no restaging) and are split in registers.  The operator
//   comes split: W_split (8, K, K, 4) holds [re_hi, re_lo, im_hi, im_lo]
//   of each entry, made once per operator on the device (kernels/m2l.py:
//   split_operator, cached per operator tensor by cached_split), so a B
//   element is one 8-byte load of its hi and lo.
// - W_split streams through a 3-stage ring of pieces, each KC = 4 k-steps
//   (16 rows a) of one offset, 17 KB at p = 17: one thread issues a bulk
//   async copy per piece to an mbarrier, piece P + 3 goes in flight as soon
//   as the block is done with piece P.  With the halo, 108 KB at p = 17:
//   two blocks share an SM.
// - The tensor core's f32 accumulation truncates: summed over all 8 x p
//   k-steps in the core, the three passes' error reaches 4e-6 at the leaf
//   (measured).  So each piece's products go to a zeroed fragment in the
//   core and are added to the f32 accumulators in registers, rounded.
// - The operator's 20 structural zero p x p blocks are multiplied like the
//   rest: their 2p x 2p real blocks do not align with the 8 x 8 steps.
//
// Orders past MAX_P = 32: the register tile (NTW <= 16 n-tiles a warp, so
// half = ceil(p / 2) <= 16) and shared memory (the halo tile and the W ring
// come to about 252 KB at p = 40) both run out.  m2l_wide_kernel keeps the
// 8 x 8 parents, the warps' layout and the 3xTF32 products, and cuts the
// other two dimensions:
// - the output columns into slices of at most 32 n-tiles (16 a warp), each
//   streaming only its columns of W_split;
// - K into chunks of KC = 4 k-steps: a chunk of the halo tile (10 x 10
//   parents x 16 complex coefficients) and, for each offset, the chunk's
//   16 rows of the slice's W columns, a piece, by 16-byte cp.async copies
//   (the halo's past the stack's edge zero-filled).  47,168 bytes a stage
//   of (halo chunk, W piece) whatever p, so any order whose operator fits
//   the card launches.
// The service's wide jobs give it small grids: at the p = 40 job's stacks,
// one tile x 2 slices, a block a tile and slice walking 10 chunks x 8
// offsets = 80 pieces, each waiting on its copies and two barriers, took
// 0.263 ms on an H100 whatever the batch.  So the launch splits each output tile's
// reduction across a thread-block cluster (wide_config, mirrored by
// kernels/m2l.py:wide_launch_config, chosen from the grid's shape alone):
// - a grid of more than 66 tiles x slices runs split 1, one block a tile
//   and slice walking all 8 offsets on two stages (94,336 bytes), as
//   before: a split block holds its SM alone, so a split past 132 blocks
//   takes a second wave and gains nothing (at 64 x 64 parents, 128 tiles x
//   slices, split 2 ran 0.266 ms against split 1's 0.247 on an H100);
// - a smaller one gives the 8 PARENT_NEIGH8 offsets to a cluster of the
//   most of 2, 4, 8 blocks that stays within 132 blocks, one wave (8 at
//   most: portable):
//   rank r takes offsets r (8 / split) .. over every K chunk, so a block
//   walks nch x 8 / split pieces (10 at p = 40, split 8), four stages deep
//   (188,672 bytes, three pieces in flight while one is multiplied).  At
//   split 8 the slices narrow too, to about 8 n-tiles (4 a warp) while the
//   grid stays within 132 blocks: the p = 40 job's stacks run 5
//   slices x 8 = 40 blocks.  Each block then sums 10 pieces where one
//   block a slice summed 80; a batch of such stacks, whose blocks outnumber
//   the SMs, pays for the narrower slices' repeated halo loads.
//   Each block accumulates its partial 64-row x slice tile in registers
//   as before, then writes it to its own shared memory (the drained ring);
//   after a cluster barrier, rank r adds n-tiles r, r + split, ... of every
//   fragment over the ranks' partials in rank order, read through
//   distributed shared memory, and stores them; a second cluster barrier
//   keeps each block's shared memory alive until all have read it.  One
//   launch, no workspace in device memory, no atomics: the sums' order is
//   fixed, so two launches and a stack's launch alone or in a batch are
//   bit for bit equal.
// blockIdx.x = (tile column * slices + slice) * split + rank.
//
// Batch: B stacks of these shapes on a leading axis, one launch with B on
// gridDim.z; block z stages its halo tile from, and writes to, its own
// slice (64-bit offsets).  The operator is shared by the whole batch and
// streamed per block as for one stack.
//
// Layouts: stack (B, PR+2, PC+2, K), out (B, PR, PC, K), complex64; W_split
// (8, K, K, 4) f32; contiguous, 16-byte aligned.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TY = 8, TX = 8;            // parents per block
constexpr int HY = TY + 2, HX = TX + 2;  // halo tile
constexpr int THREADS = 256;
constexpr int MAX_P = 32;                // 16 n-tiles per warp at most: m2l_kernel
constexpr int KC = 4;                    // k-steps per W piece
constexpr int NS = 3;                    // W ring stages

__host__ __device__ constexpr int halo_pitch(int p) { return 8 * p + 4; }  // floats
__host__ __device__ constexpr int halo_floats(int p) { return HY * HX * halo_pitch(p); }
// one k-step is 4 rows a of W_split: 4 x K x 4 floats
__host__ __device__ constexpr int kstep_bytes(int p) { return 4 * 4 * p * 16; }

int smem_bytes(int p) {
  return halo_floats(p) * 4 + NS * KC * kstep_bytes(p) + 8 * NS + 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar));
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

// One bulk async copy into shared memory, completion counted in bytes on
// the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Piece P of the ring: offset P / nc, k-steps KC (P % nc) .. of it.
__device__ __forceinline__ void load_piece(int P, int nc, int p, const float* wsplit,
                                           uint32_t ring, uint32_t bar) {
  const int d = P / nc, ks0 = KC * (P - d * nc);
  const int kc = min(KC, p - ks0);
  const int K = 4 * p;
  const int st = P % NS;
  bulk_load(ring + st * KC * kstep_bytes(p),
            wsplit + ((size_t)d * K + 4 * ks0) * K * 4, kc * kstep_bytes(p),
            bar + 8 * st);
}

// NTW: n-tiles (of 8 output floats) per warp, at least ceil(p / 2), taken
// JG at a time (NTW % JG == 0) so that JG products are in flight at once.
template <int NTW, int JG>
__global__ void __launch_bounds__(THREADS, NTW <= 9 ? 2 : 1)
m2l_kernel(const float* __restrict__ stack, const float* __restrict__ wsplit,
           float2* __restrict__ out, int PR, int PC, int p) {
  extern __shared__ float4 smem4[];
  const int K = 4 * p, K2 = 8 * p, pitch = halo_pitch(p);
  float* halo = reinterpret_cast<float*>(smem4);
  const float* ring = halo + halo_floats(p);              // NS pieces
  const int stage_floats = KC * kstep_bytes(p) / 4;
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t bar = ring_u32 + NS * stage_floats * 4;  // 8-byte aligned
  const int nc = (p + KC - 1) / KC;                       // pieces per offset
  const int npieces = 8 * nc;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bar + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int P = 0; P < NS && P < npieces; ++P) load_piece(P, nc, p, wsplit, ring_u32, bar);

  // the halo tile, zero past the stack's edge
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int SW = PC + 2, vpp = K2 / 4;                     // float4s per parent
  stack += blockIdx.z * ((size_t)(PR + 2) * SW * K2);      // this block's stack
  out += blockIdx.z * ((size_t)PR * PC * K);
  for (int i = tid; i < HY * HX * vpp; i += THREADS) {
    const int c = i / vpp, v = i - c * vpp;
    const int gy = y0 + c / HX, gx = x0 + c % HX;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy < PR + 2 && gx < SW)
      val = reinterpret_cast<const float4*>(stack + ((size_t)gy * SW + gx) * K2)[v];
    reinterpret_cast<float4*>(halo + c * pitch)[v] = val;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mt = warp % 4;                                 // parent rows 2mt, 2mt + 1
  const int half = (p + 1) / 2;
  const int nt0 = (warp / 4) * half;                       // first n-tile
  const int ntn = warp < 4 ? half : p - half;              // n-tiles of this warp
  // B fragment: k = 8 ks + t (+4) -> a = 4 ks + t/2 (+2), s = t % 2;
  // n = 8 nt + g -> b = 4 nt + g/2, u = g % 2; the entry's (hi, lo) of its
  // real (s == u) or imaginary part, negated where s = 1 and u = 0
  const int s_bit = t & 1, u_bit = g & 1;
  const uint32_t sign = (s_bit == 1 && u_bit == 0) ? 0x80000000u : 0u;
  const int b_off = ((t / 2) * K + g / 2) * 4 + 2 * (s_bit ^ u_bit);

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int P = 0; P < npieces; ++P) {
    const int d = P / nc, ks0 = KC * (P - d * nc);
    const int kc = min(KC, p - ks0);
    const int r = d < 4 ? d : d + 1;                       // 3x3 raster index, (0,0) skipped
    const int Dy = r / 3 - 1, Dx = r % 3 - 1;
    // this thread's A rows: parents (2mt, g) and (2mt + 1, g) of the tile
    const float* h0 = halo + ((2 * mt + 1 + Dy) * HX + (g + 1 + Dx)) * pitch + 8 * ks0 + t;
    const float* h1 = h0 + HX * pitch;
    tf32x3::FragA fa[KC];
#pragma unroll
    for (int i = 0; i < KC; ++i)
      if (i < kc)
        fa[i] = tf32x3::split_a(h0[8 * i], h1[8 * i], h0[8 * i + 4], h1[8 * i + 4]);

    const int st = P % NS;
    mbar_wait(bar + 8 * st, (P / NS) & 1);
    const float* wp = ring + st * stage_floats + b_off + 16 * nt0;
#pragma unroll
    for (int jg = 0; jg < NTW; jg += JG) {
      if (jg < ntn) {
        float part[JG][4] = {};
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          if (i < kc) {
            tf32x3::Split b0[JG], b1[JG];
#pragma unroll
            for (int jj = 0; jj < JG; ++jj) {
              // row 4i + t/2, column 4 (nt0 + jg + jj) + g/2; b1 two rows on
              const float* e0 = wp + 16 * i * K + 16 * (jg + jj);
              const float2 v0 = *reinterpret_cast<const float2*>(e0);
              const float2 v1 = *reinterpret_cast<const float2*>(e0 + 8 * K);
              b0[jj] = {__float_as_uint(v0.x) ^ sign, __float_as_uint(v0.y) ^ sign};
              b1[jj] = {__float_as_uint(v1.x) ^ sign, __float_as_uint(v1.y) ^ sign};
            }
            tf32x3::mma3(part, fa[i], b0, b1, ntn - jg);
          }
        }
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
          if (jg + jj < ntn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jg + jj][e] += part[jj][e];
      }
    }
    __syncthreads();                                       // stage st is free
    if (tid == 0 && P + NS < npieces) load_piece(P + NS, nc, p, wsplit, ring_u32, bar);
  }

  // c0, c1 of n-tile nt are the complex coefficient 4 nt + t of row g
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ty = y0 + 2 * mt + hr, tx = x0 + g;
    if (ty >= PR || tx >= PC) continue;
    float2* o = out + ((size_t)ty * PC + tx) * K + t;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      if (j < ntn) o[4 * (nt0 + j)] = make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
  }
}

// ---- orders past MAX_P ----
constexpr int W_NT = 32;                  // n-tiles a column slice: 16 a warp
constexpr int WH_PITCH = 8 * KC + 4;      // floats a parent in a halo chunk
constexpr int WH_FLOATS = HY * HX * WH_PITCH;
constexpr int WW_FLOATS = 4 * KC * 4 * W_NT * 4;  // 16 rows a x 128 columns b x 4
constexpr int WIDE_STAGE = (WH_FLOATS + WW_FLOATS) * 4;  // a halo chunk and a W piece
constexpr int WIDE_SMEM = 2 * WIDE_STAGE;       // split 1: two stages
constexpr int WIDE_DEEP = 4;                    // stages of a split launch
constexpr int WIDE_SMS = CARD_SMS;              // kernels/_build.py:SMS, by nvcc -D

// 16 bytes global -> shared, zero-filled when !valid (src then unread).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// blockIdx.x = (tile column * nsl + slice) * split + rank.  CLUSTER: the
// cluster's `split` blocks own one tile and slice, rank r summing the
// offsets d = r (8 / split) .. + 8 / split - 1 over every K chunk, on
// WIDE_DEEP stages of (halo chunk, W piece); else split is 1 and one block
// walks all 8 offsets on two stages.
template <bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
m2l_wide_kernel(const float* __restrict__ stack, const float* __restrict__ wsplit,
                float2* __restrict__ out, int PR, int PC, int p, int nsl, int snt,
                int split_arg) {
  constexpr int NSTG = CLUSTER ? WIDE_DEEP : 2;
  const int split = CLUSTER ? split_arg : 1;
  extern __shared__ float4 smem4[];
  float* halo_buf = reinterpret_cast<float*>(smem4);       // NSTG x WH_FLOATS
  float* w_buf = halo_buf + NSTG * WH_FLOATS;              // NSTG x WW_FLOATS
  const int K = 4 * p, K2 = 8 * p;
  const int rank = blockIdx.x % split, tile_slice = blockIdx.x / split;
  const int slice = tile_slice % nsl;
  const int nts = slice * snt;                             // the slice's first n-tile
  const int ns = min(snt, p - nts);                        // and its n-tiles
  const int wsc = 4 * snt;                                 // complex columns a W row
  const int nch = (p + KC - 1) / KC;                       // K chunks
  const int npd = 8 / split, d0 = rank * npd;              // this block's offsets
  const int npieces = nch * npd;
  const int y0 = blockIdx.y * TY, x0 = (tile_slice / nsl) * TX;
  const int SW = PC + 2;
  stack += blockIdx.z * ((size_t)(PR + 2) * SW * K2);
  out += blockIdx.z * ((size_t)PR * PC * K);
  const int tid = threadIdx.x;

  // piece P = (chunk P / npd, offset d0 + P % npd): its W rows, and with
  // the block's first offset the chunk's halo; one commit group a piece
  auto issue = [&](int P) {
    if (P < npieces) {
      const int c = P / npd, d = d0 + P % npd;
      const int kc = min(KC, p - KC * c);
      if (d == d0) {
        float* h = halo_buf + (c % NSTG) * WH_FLOATS;
        const int per = 2 * kc;                            // float4s a parent
        for (int i = tid; i < HY * HX * per; i += THREADS) {
          const int par = i / per, v = i - par * per;
          const int gy = y0 + par / HX, gx = x0 + par % HX;
          const bool in = gy < PR + 2 && gx < SW;
          const float* src = in ? stack + ((size_t)gy * SW + gx) * K2 + 32 * c + 4 * v
                                : stack;
          cp16(h + par * WH_PITCH + 4 * v, src, in);
        }
      }
      float* w = w_buf + (P % NSTG) * WW_FLOATS;
      const int rows = 4 * kc, per = 4 * ns;               // float4s a row
      for (int i = tid; i < rows * per; i += THREADS) {
        const int r = i / per, v = i - r * per;
        const float* src = wsplit + (((size_t)d * K + 16 * c + r) * K + 4 * nts + v) * 4;
        cp16(w + (r * wsc + v) * 4, src, true);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mt = warp % 4;
  const int half = (snt + 1) / 2;
  const int nt_off = (warp / 4) * half;                    // within the slice
  const int ntn = max(0, min(half, ns - nt_off));
  const int s_bit = t & 1, u_bit = g & 1;
  const uint32_t sign = (s_bit == 1 && u_bit == 0) ? 0x80000000u : 0u;
  const int b_off = ((t / 2) * wsc + g / 2) * 4 + 2 * (s_bit ^ u_bit) + 16 * nt_off;

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int P = 0; P < NSTG - 1; ++P) issue(P);
  for (int P = 0; P < npieces; ++P) {
    issue(P + NSTG - 1);           // into piece P - 1's stage, freed below
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NSTG - 1) : "memory");
    __syncthreads();               // piece P has landed for every thread
    const int c = P / npd, d = d0 + P % npd;
    const int kc = min(KC, p - KC * c);
    const int r = d < 4 ? d : d + 1;
    const int Dy = r / 3 - 1, Dx = r % 3 - 1;
    const float* h0 = halo_buf + (c % NSTG) * WH_FLOATS +
                      ((2 * mt + 1 + Dy) * HX + (g + 1 + Dx)) * WH_PITCH + t;
    const float* h1 = h0 + HX * WH_PITCH;
    tf32x3::FragA fa[KC];
#pragma unroll
    for (int i = 0; i < KC; ++i)
      if (i < kc)
        fa[i] = tf32x3::split_a(h0[8 * i], h1[8 * i], h0[8 * i + 4], h1[8 * i + 4]);
    const float* wp = w_buf + (P % NSTG) * WW_FLOATS + b_off;
#pragma unroll
    for (int jg = 0; jg < 16; jg += 4) {
      if (jg < ntn) {
        float part[4][4] = {};
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          if (i < kc) {
            tf32x3::Split b0[4], b1[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float* e0 = wp + 16 * i * wsc + 16 * (jg + jj);
              const float2 v0 = *reinterpret_cast<const float2*>(e0);
              const float2 v1 = *reinterpret_cast<const float2*>(e0 + 8 * wsc);
              b0[jj] = {__float_as_uint(v0.x) ^ sign, __float_as_uint(v0.y) ^ sign};
              b1[jj] = {__float_as_uint(v1.x) ^ sign, __float_as_uint(v1.y) ^ sign};
            }
            tf32x3::mma3(part, fa[i], b0, b1, ntn - jg);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (jg + jj < ntn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jg + jj][e] += part[jj][e];
      }
    }
    __syncthreads();               // stage P % NSTG is free
  }

  // c0, c1 of n-tile j are the complex coefficient 4 (nts + nt_off + j) + t
  // of parent rows 2mt (c0) and 2mt + 1 (c2, c3 as its pair)
  auto store = [&](int j, float4 v) {
    const int col = 4 * (nts + nt_off + j) + t;
    const int ty = y0 + 2 * mt, tx = x0 + g;
    if (tx >= PC) return;
    if (ty < PR) out[((size_t)ty * PC + tx) * K + col] = make_float2(v.x, v.y);
    if (ty + 1 < PR) out[((size_t)(ty + 1) * PC + tx) * K + col] = make_float2(v.z, v.w);
  };
  if constexpr (!CLUSTER) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < ntn) store(j, make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
    return;
  }
  // The cluster's partial tiles, one a block in its own shared memory (the
  // ring is drained and free): rank r sums n-tiles j = r, r + split, ... of
  // every thread's fragment over the ranks' partials in rank order, read
  // through distributed shared memory, and stores them.
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float4* partial = reinterpret_cast<float4*>(smem4);      // 16 x THREADS
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < ntn) partial[j * THREADS + tid] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int j = rank; j < ntn; j += split) {
    float4 s = *cluster.map_shared_rank(partial + j * THREADS + tid, 0);
    for (int rk = 1; rk < split; ++rk) {
      const float4 v = *cluster.map_shared_rank(partial + j * THREADS + tid, rk);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store(j, s);
  }
  cluster.sync();                                          // partials read: blocks may leave
}

// The wide form's launch on one (PR, PC) grid at order p, the same for
// every stack of a batch (kernels/m2l.py:wide_launch_config): column slices
// of at most W_NT n-tiles, as even as p allows; the offsets split over the
// most of 2, 4 or 8 blocks a cluster that keeps the grid within WIDE_SMS
// blocks (one wave: a split block holds its SM alone), on WIDE_DEEP
// stages; a grid of more than WIDE_SMS / 2 tiles x slices runs split 1 on
// two stages.  At split 8 the slices narrow, to as many as ceil(p / 8)
// (about 8 n-tiles, 4 a warp), while the blocks stay within WIDE_SMS.
struct WideConfig {
  int nsl, snt, split, smem;
};

// The launch at order p in about nsl column slices (as even as p allows,
// none left empty) and the given split.
WideConfig slice_config(int p, int nsl, int split) {
  WideConfig c;
  c.snt = (p + nsl - 1) / nsl;
  c.nsl = (p + c.snt - 1) / c.snt;
  c.split = split;
  c.smem = (split == 1 ? 2 : WIDE_DEEP) * WIDE_STAGE;
  return c;
}

WideConfig wide_config(int PR, int PC, int p) {
  int nsl = (p + W_NT - 1) / W_NT;
  const long long tiles = (long long)((PR + TY - 1) / TY) * ((PC + TX - 1) / TX);
  int split = 1;
  for (int s = 2; s <= 8; s *= 2)
    if (tiles * nsl * s <= WIDE_SMS) split = s;
  if (split == 8) {
    const long long fit = WIDE_SMS / (tiles * 8);            // slices within the card
    const int narrow = (int)(fit < (p + 7) / 8 ? fit : (p + 7) / 8);
    if (narrow > nsl) nsl = narrow;
  }
  return slice_config(p, nsl, split);
}

template <bool CLUSTER>
int launch_wide(const void* stack, const void* W, void* out, int batch, int PR, int PC,
                int p, const WideConfig& c, cudaStream_t stream) {
  auto kernel = m2l_wide_kernel<CLUSTER>;
  const long long gx = (long long)((PC + TX - 1) / TX) * c.nsl * c.split;
  if (gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       c.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, (PR + TY - 1) / TY, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c.split > 1;                              // split 1: a plain launch
  e = cudaLaunchKernelEx(&cfg, kernel, (const float*)stack, (const float*)W, (float2*)out,
                         PR, PC, p, c.nsl, c.snt, c.split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int run_wide(const void* stack, const void* W, void* out, int batch, int PR, int PC, int p,
             const WideConfig& c, cudaStream_t stream) {
  return (c.split > 1 ? launch_wide<true> : launch_wide<false>)(stack, W, out, batch, PR,
                                                                  PC, p, c, stream);
}

template <int NTW, int JG>
int launch(const void* stack, const void* wsplit, void* out, int batch, int PR, int PC,
           int p, cudaStream_t stream) {
  const int smem = smem_bytes(p);
  const cudaError_t e = cudaFuncSetAttribute(
      m2l_kernel<NTW, JG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((PC + TX - 1) / TX, (PR + TY - 1) / TY, batch);
  m2l_kernel<NTW, JG><<<grid, THREADS, smem, stream>>>(
      (const float*)stack, (const float*)wsplit, (float2*)out, PR, PC, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs at order p on a grid that fills
// the card (past MAX_P: the wide form at split 1, m2l_wide_config for a
// given grid), or -1 for p < 1.
extern "C" int m2l_smem_bytes(int p) {
  if (p < 1) return -1;
  return p > MAX_P ? WIDE_SMEM : smem_bytes(p);
}

// The wide form's launch on a (PR, PC) grid at order p > MAX_P: column
// slices, cluster split and shared memory; returns 0, or -1 for p <= MAX_P.
extern "C" int m2l_wide_config(int PR, int PC, int p, int* slices, int* split, int* smem) {
  if (p <= MAX_P || PR < 1 || PC < 1) return -1;
  const WideConfig c = wide_config(PR, PC, p);
  *slices = c.nsl;
  *split = c.split;
  *smem = c.smem;
  return 0;
}

// W is the split operator W_split (8, 4p, 4p, 4) f32; batch: the stacks on
// the leading axis (1 to 65535).
extern "C" int m2l_launch(const void* stack, const void* W, void* out, int batch,
                          int PR, int PC, int p, void* stream) {
  if (p < 1 || p > (1 << 20) || PR < 1 || PC < 1 || (PR + TY - 1) / TY > 65535 ||
      batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (p > MAX_P) {
    return run_wide(stack, W, out, batch, PR, PC, p, wide_config(PR, PC, p), st);
  }
  const int half = (p + 1) / 2;
  if (half <= 4) return launch<4, 4>(stack, W, out, batch, PR, PC, p, st);
  if (half <= 9) return launch<9, 3>(stack, W, out, batch, PR, PC, p, st);
  return launch<16, 4>(stack, W, out, batch, PR, PC, p, st);
}

// What one TF32 tensor-core pass reads of each x[i]: out[i] = x[i] * 1.
extern "C" int tf32_probe(const float* x, float* out, int n, void* stream) {
  tf32x3::probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
