// Blockwise online-softmax (flash) attention with GQA for every head dim the
// tensor-core kernels do not take, on Hopper's tensor cores through
// warp-level mma.sync: bf16 products in bf16, f32 products as three TF32
// passes (3xTF32, f32 accuracy).  The route's name, "simt", is kept from the
// FP32 SIMT kernel this one replaced.
//
// Replaces the TPU kernel _fa_kernel / flash_attention in
// src/repro/kernels/flash_attn.py.  For q (B, H, T, d) and k, v (B, Hkv, S,
// d) it computes out = softmax(q k^T / sqrt(d) + mask) v with f32 sums, where
// the query head bh reads the key/value row kv_row = (bh / H) * Hkv + (bh %
// H) / (H / Hkv) (no repeated heads in memory).  The causal mask is the TPU
// kernel's top-left one: key kpos is hidden from query qpos when kpos >
// qpos; masked scores contribute exactly 0, and out = o / l with the l > 0
// guard.  out is in q's type; bf16 or f32, d any multiple of 8 in [8, 256].
//
// Bound on an H100 at Phi-3-mini's attention (B 4, H = Hkv = 32, T = S =
// 2048, d 96, causal): 103.1 GFLOP over the visible (query, key) pairs, so
// 0.104 ms in bf16 at 989 TFLOP/s (201 MB of q, k, v and out, 0.060 ms), and
// 0.625 ms in f32 for three TF32 passes at 495 TFLOP/s (403 MB, 0.120 ms):
// operations bound it.  At the served shape (1, 2, 2, 64, 192, 32, f32, not
// causal), 131 KB: bytes bound it, 0.00004 ms, and the launch's latency is
// what is left.
//
// Design, simple and right first (wgmma and TMA are later work):
// - A block owns a (bh, q tile) of 64 query rows on four warps of 16, or
//   of 128 rows: on four warps of 32 in bf16 up to d = 128 (each K and V
//   fragment a warp loads then feeds two 16-row products), else on eight
//   warps of 16 where a 64-row block would hold its SM alone.  It walks
//   its key tiles in order, skipping those wholly above the diagonal (a
//   warp also skips the tiles that show its own rows no key); q tiles
//   launch heaviest first.  Launch shape per (d, dtype, grid): config(),
//   mirrored by kernels/flash_attn.py:simt_launch_config; the launcher
//   refuses any other.  tools/simt_flash.py --variants times the choices
//   this note calls faster against their alternatives (PERF.md §6).
// - An instance computes a head-dim class D (d rounded up to 32), so its
//   loops are fixed at compile time, with no guard in them: Q's and K's
//   columns past d are zero in shared memory and add exactly 0, O's are
//   never stored.  At d = 32, 64, 96, ..., 256 nothing is padded.
// - bf16: mma.sync.m16n8k16 with f32 accumulators; Q and K fragments come
//   from shared memory by ldmatrix, V's by ldmatrix.trans.  The f32
//   accumulator of S is the bf16 A-fragment layout of P, so P is packed to
//   bf16 in registers, as csrc/flash_attn_tc.cu does; l sums the f32
//   probabilities.
// - f32: tf32x3.cuh's mma.sync.m16n8k8, its split and fragment layout
//   (M2L's), three passes per product.  Every fragment is split in
//   registers where it is loaded; splitting each K and V tile once into hi
//   and lo tiles in shared memory was slower (a pass of the whole block a
//   tile, and twice the bytes for every fragment load).  The order inside
//   a product's depth is free, so slot t of an 8-wide k-step takes element
//   2t and slot t + 4 element 2t + 1: Q and K fragments are float2 loads,
//   and S's accumulator fragment (keys 2t, 2t+1 of each 8) is P's A
//   fragment with no shuffle, V read at rows 2t and 2t + 1.  The core's f32
//   accumulation truncates, so S sums 4 k-steps (12 passes) in a zeroed
//   accumulator before adding it in f32 registers, and O sums each key
//   tile's passes the same way and takes them by one fma, o = o * alpha +
//   part, which is also the online softmax's rescale.
// - Row pitches keep the fragment loads free of bank conflicts: Q and K
//   rows are D plus 8 elements (ldmatrix's 8 rows, and f32's float2 loads,
//   fall in distinct banks); f32 V rows are D + 4 floats (rows 2t and
//   2t + 1, column g).
// - K and V tiles (64 keys in bf16, 32 in f32, 16 in f32's 128-row blocks
//   past d = 192, faster there than 64 rows of 32 keys) arrive by 16-byte
//   cp.async, zero-filled past S, from strided tensors: a unit stride in
//   d, every other stride (batch, head, seq, in elements) a multiple of 16
//   bytes, as the tensor-core routes take them.  A 2-stage ring: the copy of tile
//   j + 1 is in flight while tile j computes.  A thread copies the same
//   16-byte column of every few rows, so a copy costs no index arithmetic.
// - Online softmax on the accumulator fragment: a thread holds 2 rows (g,
//   g + 8) of each of its warp's 16-row m-tiles; the row max takes a quad
//   shuffle; l sums thread-locally and once over the quad at the end.  The running max is
//   of raw scores, and exp((s - m) / sqrt(d)) is one fma and the MUFU's
//   ex2.approx (relative error about 2^-22); only the tiles that reach
//   past S or a warp's diagonal compute the mask.
// - A grid of fewer than SMS / 2 blocks (B * H * ceil(T / rows)) cannot
//   fill the card: the served shape has 2.  There each (bh, q tile) is
//   owned by a thread-block cluster of `split` blocks (2 to 8, the most that
//   keeps the grid within one wave of SMS blocks, no more than the q tile's
//   key tiles), rank r walking the r-th share of its key tiles.  Each block
//   writes its partial (m, l, unnormalized O) to its own shared memory;
//   after a cluster barrier rank r merges its share of the rows, rows r *
//   ceil(rows / split) .., over all partials in rank order, read through
//   distributed shared memory: M = max m_k, w_k = exp(m_k - M), out = sum_k
//   w_k O_k / sum_k w_k l_k; a second cluster barrier keeps the memory
//   alive until all have read it.  No workspace, no atomics: the order is
//   fixed, so a second launch gives the same bits as the first.
// blockIdx.x = ((q tiles - 1 - q tile) * BH + bh) * split + rank.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 256;  // a block: 128 query rows on 8 warps, or 64 on 4
constexpr int MAX_SPLIT = 8;      // blocks a cluster (the portable maximum)
constexpr int SPLIT_SMS = CARD_SMS;   // kernels/_build.py:SMS, by nvcc -D
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use
constexpr float NEG_INF = -1e30f;

// The head-dim class an instance computes: d rounded up to 32 (at least
// 32).  Loops run over the class's columns, fixed at compile time; Q's and
// K's columns past d are zero in shared memory, so they add exactly 0, and
// O's are never stored.
__host__ __device__ constexpr int dclass(int d) { return d <= 32 ? 32 : (d + 31) / 32 * 32; }
// Row pitch, in elements, of Q and K tiles (and bf16 V tiles): the class
// plus 8.  In bytes an odd multiple of 16 (bf16): ldmatrix's 8 rows hit
// distinct banks; = 8 mod 16 floats (f32): a half-warp's float2 loads at
// rows g < 4, columns 2t do too.
__host__ __device__ constexpr int pitch_qk(int D) { return D + 8; }
// f32 V rows: = 4 mod 8 floats, so rows 2t, column g hit distinct banks.
__host__ __device__ constexpr int pitch_v(int D, bool bf16) { return bf16 ? D + 8 : D + 4; }

// Q and a ring of `stages` K and V tiles.
int smem_bytes(int d, bool bf16, int rows, int bk, int stages) {
  const int D = dclass(d), p = pitch_qk(D), pv = pitch_v(D, bf16);
  return (bf16 ? 2 : 4) * (rows * p + stages * bk * (p + pv));
}

struct Config {
  int rows, bk, stages, threads, smem, split;
};

// The launch at head dim d on bh heads of T queries over S keys: 64 query
// rows a block on 4 warps (16 rows a warp), 64-key tiles in bf16 and 32 in
// f32, on 2 stages.  Where T > 64, 128 rows: on 4 warps of 32 rows in bf16
// up to the 128 class (each K and V fragment feeds two m-tiles); else on 8
// warps where a 64-row block would hold its SM alone (more than half of
// MAX_SMEM), with f32's tiles cut to 16 keys where 32 do not fit (the 224
// and 256 classes).  The cluster split of a grid short of the card.
Config config(int d, bool bf16, long long bh, int T, int S, int causal) {
  Config c{64, bf16 ? 64 : 32, 2, 128, 0, 1};
  if (T > 64 && bf16 && dclass(d) <= 128) {
    c.rows = 128;
  } else if (T > 64 && smem_bytes(d, bf16, 64, c.bk, c.stages) > MAX_SMEM / 2) {
    if (!bf16 && smem_bytes(d, bf16, 128, c.bk, c.stages) > MAX_SMEM) c.bk = 16;
    if (smem_bytes(d, bf16, 128, c.bk, c.stages) <= MAX_SMEM) {
      c.rows = 128;
      c.threads = 256;
    } else {
      c.bk = bf16 ? 64 : 32;
    }
  }
  c.smem = smem_bytes(d, bf16, c.rows, c.bk, c.stages);
  const long long blocks = bh * ((T + c.rows - 1) / c.rows);
  const int tiles = ((causal ? (T < S ? T : S) : S) + c.bk - 1) / c.bk;
  for (int s = 2; s <= MAX_SPLIT; ++s)
    if (blocks * s <= SPLIT_SMS && s <= tiles) c.split = s;
  return c;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long qs[3], ks[3], vs[3], os[3];   // (batch, head, seq) strides, elements
  int BH, H, Hkv, T, S, d, rows, split, causal;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zero-filled when !valid (src then unread).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// d (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the MUFU approximation (relative error about 2^-22); 0 far below.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 f) {
  *reinterpret_cast<float4*>(p) = f;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 f) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(f.x, f.y), __floats2bfloat162_rn(f.z, f.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// A thread's share of a tile of `chunks` 16-byte chunks a row (at most the
// block's threads): chunk c of rows r, r + per, ... (per = threads / chunks
// rows a pass), fixed for the whole kernel so a copy costs no index
// arithmetic.
struct Lanes {
  int c, r, per;
  __device__ Lanes(int chunks)
      : c(threadIdx.x % chunks), r(threadIdx.x / chunks), per(blockDim.x / chunks) {}
};

// Rows [r0, r0 + rows) of a strided (seq, d) matrix into shared memory with
// row pitch `pitch`, by the thread's share `ln`: the first `valid` chunks of
// a row read, the rest and the rows at or past `end` zero.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src, long long rstride,
                                      int r0, int end, int rows, const Lanes& ln,
                                      int valid) {
  constexpr int VE = 16 / sizeof(T);
  if (ln.r >= ln.per) return;
  const bool cv = ln.c < valid;
  const T* g = src + (r0 + ln.r) * rstride + ln.c * VE;
  const long long gstep = ln.per * rstride;
  T* sm = dst + ln.r * pitch + ln.c * VE;
  const int sstep = ln.per * pitch;
  for (int r = r0 + ln.r; r < r0 + rows; r += ln.per, g += gstep, sm += sstep) {
    const bool ok = cv && r < end;
    cp16(sm, ok ? g : src, ok);
  }
}

// D: the head-dim class (dclass); BK: keys a tile; MT: 16-row m-tiles a
// warp (each K and V fragment it loads feeds MT products).
template <typename T, int D, int BK, int MT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
flash_attn_kernel(const Params prm) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int NT = BK / 8;          // n-tiles of S an m-tile
  constexpr int ND = D / 8;           // n-tiles of O an m-tile
  constexpr int P = pitch_qk(D), PV = pitch_v(D, BF16);
  constexpr int VE = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int WR = 16 * MT;         // query rows a warp
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int d = prm.d, nd8 = d / 8;
  const int split = prm.split;
  const int rank = blockIdx.x % split, idx = blockIdx.x / split;
  const int BQ = prm.rows;            // query rows of the block: WR a warp
  const int nqt = (prm.T + BQ - 1) / BQ;
  // the heaviest q tiles of every head first
  const int bh = idx % prm.BH, qt = nqt - 1 - idx / prm.BH;
  const int b = bh / prm.H, h = bh % prm.H, hk = h / (prm.H / prm.Hkv);
  const int q0 = qt * BQ;
  const T* qg = static_cast<const T*>(prm.q) + b * prm.qs[0] + h * prm.qs[1];
  const T* kg = static_cast<const T*>(prm.k) + b * prm.ks[0] + hk * prm.ks[1];
  const T* vg = static_cast<const T*>(prm.v) + b * prm.vs[0] + hk * prm.vs[1];
  T* og = static_cast<T*>(prm.out) + b * prm.os[0] + h * prm.os[1];
  const int kend = prm.causal ? min(prm.S, min(q0 + BQ, prm.T)) : prm.S;
  const int ntile = (kend + BK - 1) / BK;
  const int tb = rank * ntile / split, te = (rank + 1) * ntile / split;  // this rank's tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = WR * warp;           // the warp's first row in the tile
  const float sl2 = prm.scale * 1.4426950408889634f;   // exp(x scale) = 2^(x sl2)

  // shared memory: Q, then K and V (see smem_bytes)
  T* Qs = smem;
  T* Kraw = Qs + BQ * P;
  const int valid = d / VE;           // 16-byte chunks of a row read; the class's rest zero
  const Lanes lanes(D / VE);
  auto issue = [&](int j) {           // key tile j into its buffer of the ring K0 V0 K1 V1
    T* ks = Kraw + (j - tb) % 2 * BK * (P + PV);
    T* vs = ks + BK * P;
    stage(ks, P, kg, prm.ks[2], j * BK, prm.S, BK, lanes, valid);
    stage(vs, PV, vg, prm.vs[2], j * BK, prm.S, BK, lanes, valid);
  };

  // thread (g, t) holds rows m0 + 16 i + g (r = 0) and + 8 (r = 1) of m-tile i
  float o[MT][ND][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = NEG_INF;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int jn = 0; jn < ND; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][jn][e] = 0.f;
  }

  if (tb < te) {
    stage(Qs, P, qg, prm.qs[2], q0, prm.T, BQ, lanes, valid);
    issue(tb);
  }
  cp_commit();
  for (int j = tb; j < te; ++j) {
    cp_wait_all();
    __syncthreads();                  // tile j landed for every thread; j - 1 consumed
    if (j + 1 < te) issue(j + 1);     // into j - 1's buffer, while j computes
    cp_commit();
    const T* Kb = Kraw + (j - tb) % 2 * BK * (P + PV);
    const T* Vb = Kb + BK * P;
    const int k0 = j * BK;
    // a warp skips a tile that shows none of its rows a key: all its rows lie
    // past T, or (causal) above the tile's first key
    if (q0 + m0 >= prm.T || (prm.causal && k0 > q0 + m0 + WR - 1)) continue;

    // ---- S = Q K^T (WR rows x BK keys a warp) ----
    float s[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldsm_x4(a[i], Qs + (m0 + 16 * i + lane % 16) * P + 16 * kk + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, Kb + (16 * np + lane % 8 + (lane / 16) * 8) * P + 16 * kk +
                          ((lane / 8) % 2) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(s[i][2 * np], a[i], bb[0], bb[1]);
            mma_bf16(s[i][2 * np + 1], a[i], bb[2], bb[3]);
          }
        }
      }
    } else {
      const float* Qf = reinterpret_cast<const float*>(Qs);
      const float* Kf = reinterpret_cast<const float*>(Kb);
#pragma unroll
      for (int kg4 = 0; kg4 < D / 32; ++kg4) {
        float part[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int kc = 8 * (4 * kg4 + ks) + 2 * t;   // slot t: column kc, t + 4: kc + 1
          tf32x3::Split b0[NT], b1[NT];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 kv = *reinterpret_cast<const float2*>(Kf + (8 * n + g) * P + kc);
            b0[n] = tf32x3::split(kv.x);
            b1[n] = tf32x3::split(kv.y);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float* qr = Qf + (m0 + 16 * i + g) * P + kc;
            const float2 qa = *reinterpret_cast<const float2*>(qr);
            const float2 qb = *reinterpret_cast<const float2*>(qr + 8 * P);
            tf32x3::mma3(part[i], tf32x3::split_a(qa.x, qb.x, qa.y, qb.y), b0, b1);
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][n][e] += part[i][n][e];
      }
    }

    // ---- online softmax on raw scores (m, the running max, is raw too);
    // masked scores contribute exactly 0.  Only the warp's tiles that reach
    // past S or its diagonal mask. ----
    const bool edge = k0 + BK > prm.S || (prm.causal && k0 + BK - 1 > q0 + m0);
    auto visible = [&](int i, int n, int e) {
      const int qpos = q0 + m0 + 16 * i + g + 8 * (e / 2), kpos = k0 + 8 * n + 2 * t + (e & 1);
      return kpos < prm.S && !(prm.causal && kpos > qpos);
    };
    float alpha[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge && !visible(i, n, e)) s[i][n][e] = NEG_INF;
          mx[e / 2] = fmaxf(mx[e / 2], s[i][n][e]);
        }
      float rs[2] = {0.f, 0.f}, msl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[i][r], mx[r]);
        alpha[i][r] = exp2_approx((m[i][r] - m_new) * sl2);
        m[i][r] = m_new;
        msl[r] = m_new * sl2;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][n][e] = exp2_approx(fmaf(s[i][n][e], sl2, -msl[e / 2]));
          if (edge && !visible(i, n, e)) s[i][n][e] = 0.f;
          rs[e / 2] += s[i][n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[i][r] = l[i][r] * alpha[i][r] + rs[r];
    }

    // ---- O = O * alpha + P V ----
    if constexpr (BF16) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < ND; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][jn][e] *= alpha[i][e / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          a[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
          a[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
          a[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
          a[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, Vb + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * PV + 16 * np +
                            (lane / 16) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(o[i][2 * np], a[i], bb[0], bb[1]);
            mma_bf16(o[i][2 * np + 1], a[i], bb[2], bb[3]);
          }
        }
      }
    } else {
      tf32x3::FragA pa[MT][NT];       // slot t: key 2t, slot t + 4: key 2t + 1
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          pa[i][n] = tf32x3::split_a(s[i][n][0], s[i][n][2], s[i][n][1], s[i][n][3]);
      const float* Vf = reinterpret_cast<const float*>(Vb);
#pragma unroll
      for (int ng = 0; ng < ND / 4; ++ng) {
        float part[MT][4][4] = {};    // 4 of O's n-tiles: the tile's passes
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          tf32x3::Split b0[4], b1[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int r0 = (8 * kk + 2 * t) * PV + 8 * (4 * ng + jj) + g;
            b0[jj] = tf32x3::split(Vf[r0]);
            b1[jj] = tf32x3::split(Vf[r0 + PV]);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) tf32x3::mma3(part[i], pa[i][kk], b0, b1);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[i][4 * ng + jj][e] =
                  fmaf(o[i][4 * ng + jj][e], alpha[i][e / 2], part[i][jj][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[i][r] += __shfl_xor_sync(0xffffffffu, l[i][r], 1);
      l[i][r] += __shfl_xor_sync(0xffffffffu, l[i][r], 2);
    }
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + m0 + 16 * i + g + 8 * r;
        if (row >= prm.T) continue;
        const float den = l[i][r] > 0.f ? l[i][r] : 1.f;
        T* orow = og + row * prm.os[2];
#pragma unroll
        for (int jn = 0; jn < ND; ++jn)
          if (jn < nd8)
            store2(orow + 8 * jn + 2 * t, o[i][jn][2 * r] / den, o[i][jn][2 * r + 1] / den);
      }
    return;
  }

  // The cluster's partials, one a block in its own shared memory (the
  // tiles are consumed): O (rows x d, unnormalized), m and l of each row.
  cp_wait_all();
  __syncthreads();
  float* Op = reinterpret_cast<float*>(smem4);
  float* Mp = Op + BQ * d;
  float* Lp = Mp + BQ;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * i + g + 8 * r;
#pragma unroll
      for (int jn = 0; jn < ND; ++jn)
        if (jn < nd8)
          *reinterpret_cast<float2*>(Op + row * d + 8 * jn + 2 * t) =
              make_float2(o[i][jn][2 * r], o[i][jn][2 * r + 1]);
      if (t == 0) {
        Mp[row] = m[i][r];
        Lp[row] = l[i][r];
      }
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (BQ + split - 1) / split;
  const int r_begin = rank * share, r_end = min(min(BQ, r_begin + share), prm.T - q0);
  const int c4 = d / 4;
  for (int i = tid; i < (r_end - r_begin) * c4; i += blockDim.x) {
    const int row = r_begin + i / c4, c = (i % c4) * 4;
    float M = NEG_INF;
    for (int k = 0; k < split; ++k) M = fmaxf(M, *cluster.map_shared_rank(Mp + row, k));
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < split; ++k) {           // rank order: the same bits every run
      const float w = exp2_approx((*cluster.map_shared_rank(Mp + row, k) - M) * sl2);
      L += w * *cluster.map_shared_rank(Lp + row, k);
      const float4 x = *cluster.map_shared_rank(
          reinterpret_cast<float4*>(Op + row * d + c), k);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    const float den = L > 0.f ? L : 1.f;
    store4(og + (q0 + row) * prm.os[2] + c,
           make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den));
  }
  cluster.sync();                     // partials read: blocks may leave
}

template <typename T, int D, int BK, int MT>
int launch(const Params& prm, const Config& c, cudaStream_t stream) {
  auto kernel = flash_attn_kernel<T, D, BK, MT>;
  const long long nqt = (prm.T + c.rows - 1) / c.rows;
  const long long gx = (long long)prm.BH * nqt * c.split;
  if (gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // this instance's shared-memory limit, raised to MAX_SMEM once a device
  static unsigned long long raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64) return e != cudaSuccess ? (int)e : (int)cudaErrorInvalidDevice;
  if (!(raised >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx);
  cfg.blockDim = dim3(c.threads);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c.split > 1;         // split 1: a plain launch
  e = cudaLaunchKernelEx(&cfg, kernel, prm);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// MT = 2 (32 rows a warp) for the bf16 classes up to 128 (config()).
template <typename T, int BK>
int launch_class(const Params& prm, const Config& c, cudaStream_t stream) {
  const bool two = c.rows == c.threads;   // 32 rows a warp
  if constexpr (sizeof(T) == 2) {
    if (two) {
      switch (dclass(prm.d)) {
        case 32: return launch<T, 32, BK, 2>(prm, c, stream);
        case 64: return launch<T, 64, BK, 2>(prm, c, stream);
        case 96: return launch<T, 96, BK, 2>(prm, c, stream);
        case 128: return launch<T, 128, BK, 2>(prm, c, stream);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
  if (two) return (int)cudaErrorInvalidValue;
  switch (dclass(prm.d)) {
    case 32: return launch<T, 32, BK, 1>(prm, c, stream);
    case 64: return launch<T, 64, BK, 1>(prm, c, stream);
    case 96: return launch<T, 96, BK, 1>(prm, c, stream);
    case 128: return launch<T, 128, BK, 1>(prm, c, stream);
    case 160: return launch<T, 160, BK, 1>(prm, c, stream);
    case 192: return launch<T, 192, BK, 1>(prm, c, stream);
    case 224: return launch<T, 224, BK, 1>(prm, c, stream);
    case 256: return launch<T, 256, BK, 1>(prm, c, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The instance for (head-dim class, dtype, key tile) (config()).
int run(Params prm, const Config& c, bool bf16, cudaStream_t stream) {
  prm.rows = c.rows;
  prm.split = c.split;
  if (c.split < 1 || c.split > MAX_SPLIT || c.smem > MAX_SMEM ||
      (c.rows != 64 && c.rows != 128) ||
      (c.threads != 2 * c.rows && !(bf16 && c.threads == c.rows && dclass(prm.d) <= 128)) ||
      c.smem < 4 * (c.rows * prm.d + 2 * c.rows) ||   // the partials of a split fit too
      (bf16 ? c.bk != 64 : c.bk != 32 && c.bk != 16) || c.stages != 2)
    return (int)cudaErrorInvalidValue;
  if (bf16) return launch_class<__nv_bfloat16, 64>(prm, c, stream);
  if (c.bk == 32) return launch_class<float, 32>(prm, c, stream);
  switch (dclass(prm.d)) {            // 16-key tiles: f32's 128-row blocks past 192
    case 224: return launch<float, 224, 16, 1>(prm, c, stream);
    case 256: return launch<float, 256, 16, 1>(prm, c, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool valid_shape(int B, int H, int Hkv, int T, int S, int d) {
  return d >= 8 && d <= 256 && d % 8 == 0 && B > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 &&
         T > 0 && S > 0 && (long long)B * H <= 0x7fffffff;
}

Params make_params(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Hkv, int T, int S, int d, const long long* strides, float scale,
                   int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.BH = B * H;
  p.H = H;
  p.Hkv = Hkv;
  p.T = T;
  p.S = S;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// The launch's (rows per block, keys per tile, stages, threads, shared-memory
// bytes, split) at head dim d on B * H heads of T queries over S keys, into
// out[6]; returns 0, or cudaErrorInvalidValue for a shape the kernel refuses.
extern "C" int flash_attn_config(int d, int bf16, int B, int H, int T, int S, int causal,
                                 int* out) {
  if (!valid_shape(B, H, 1, T, S, d)) return (int)cudaErrorInvalidValue;
  const Config c = config(d, bf16 != 0, (long long)B * H, T, S, causal);
  const int v[6] = {c.rows, c.bk, c.stages, c.threads, c.smem, c.split};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// args: B, H, Hkv, T, S, d; the (batch, head, seq) strides of q, k, v and
// out in elements (the unit stride of d is implied); the wrapper's launch
// configuration (rows, keys per tile, stages, threads, shared-memory bytes,
// split), checked against config(): the launch refuses any other; causal;
// bf16.  Returns 0 or a cudaError_t.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 const long long* args, float scale, void* stream) {
  const int B = (int)args[0], H = (int)args[1], Hkv = (int)args[2], T = (int)args[3],
            S = (int)args[4], d = (int)args[5], causal = (int)args[24];
  const bool bf16 = args[25] != 0;
  if (!valid_shape(B, H, Hkv, T, S, d)) return (int)cudaErrorInvalidValue;
  const Config c = config(d, bf16, (long long)B * H, T, S, causal);
  const long long* w = args + 18;
  if (w[0] != c.rows || w[1] != c.bk || w[2] != c.stages || w[3] != c.threads ||
      w[4] != c.smem || w[5] != c.split)
    return (int)cudaErrorInvalidValue;
  return run(make_params(q, k, v, out, B, H, Hkv, T, S, d, args + 6, scale, causal), c,
             bf16, (cudaStream_t)stream);
}
