// Near-field direct interactions (P2P) over a halo'd leaf grid.
//
// Replaces the TPU kernel _p2p_kernel / p2p_pallas_slab in
// src/repro/kernels/p2p.py.  out[y, x, k] = sum over the 3x3 neighbour boxes
// (y+dy, x+dx) of the halo'd grid and their s slots j of a pair term in
// explicit real/imag arithmetic, skipping empty source slots and coincident
// pairs (r2 > 0), with the mollifier w = 1 - exp(-r2 / (2 sigma^2))
// (singular != 0: w = 1).  Two formulas (NOUT):
// - 1, the vortex kernel (EquationSpec.p2p_terms):
//     q_j (z_k - z_j) / |z_k - z_j|^2 * w;
// - 2, Laplace (LaplaceEquation.p2p_terms), channel 0 the potential
//     q_j * 0.5 log r2 * w, channel 1 the field -q_j / (z_k - z_j) * w.
// Targets are the sources (k runs over the target box's own slots) or, with
// PASSIVE, a separate (rows, cols, st) block zt / mt with no halo.  Masked
// target slots get 0.
//
// Bound on an H100: bytes.  The mask read whole (8.4 MB at the paper's size,
// 1026 x 1026 halo'd boxes, 8 slots), the z and q of the 765,625 live slots
// read once (12.3 MB) and the output written whole (67.1 MB; 134 MB with
// Laplace's two channels) are 88 MB, 0.026 ms at 3.35 TB/s; the arithmetic,
// about 18 FP32 operations on each of the 7.3M live pairs, is a few
// microseconds, because only 9% of the slots are live.  Passive targets add
// their z and mask, read once.
//
// Design: work only on live slots, read each byte about once.
// - A block owns TY x TX target boxes (16 x 16 at s = 8, smaller tiles for
//   more slots or channels: kernels/p2p.py:launch_config) and one thread per
//   box of its (TY+2) x (TX+2) halo tile.  A thread reads its box's mask (8
//   slots as one 8-byte load at s = 8) and the z and q of its live slots, so
//   a dead slot costs no load; a block-wide exclusive scan of the live
//   counts (warp shuffles, then the warps' sums) gives each box its start,
//   and the live sources are packed into shared memory as float4 records
//   (x, y, q.re, q.im) in box order, with each box's start and a (box, slot)
//   tag.  The halo staging reads 1.27x the tile's boxes (1.56x with 8 x 8).
// - Threads then take only live targets.  Sources as targets: thread i takes
//   record i of the tile's inner rows, skips the ghost columns (2 of 18
//   boxes a row).  Passive targets: thread i takes target slots i,
//   i + blockDim, ... of the tile, read from device memory, neighbouring
//   threads on neighbouring slots, and skips the masked ones.  Either walks the live sources of the 3
//   neighbour rows of boxes, each row's 3 boxes one contiguous range of
//   records, one 16-byte shared load a source.  Sums stay in registers and
//   go to an output tile in shared memory.
// - The output tile, zeros in the dead slots, is written in one coalesced
//   pass (16-byte stores at s = 8), so every element of the output is
//   written once.
// The common vortex case (s = 8, sources as targets, 16 x 16 tile) is a
// template instance with the slot count and the halo width as constants;
// any other s (up to 136), tile, formula or target mode runs the same code
// with them at run time.  Built without fast math, so expf, logf and the
// division are the IEEE-accurate forms; each sum visits its sources in
// stencil order (neighbour rows, boxes, slots).
//
// Layouts: z, q complex64 (rows+2, cols+2, s) as float2, 16-byte aligned;
// mask uint8 (same), 8-byte aligned; zt complex64 and mt uint8
// (rows, cols, st); out complex64 (rows, cols, st[, 2]).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 32;
constexpr int MAX_SLOTS = 136;    // kernels/p2p.py:MAX_SLOTS; a tag keeps the slot in 8 bits

// Shared memory of a TY x TX tile with s source slots, st target slots and
// nout channels: live-source records sized for every slot live, the output
// tile, the tags, the boxes' starts and the scan's warp sums.
// kernels/p2p.py:smem_bytes is the same sum.
constexpr int smem_bytes(int ty, int tx, int s, int st, int nout) {
  return (ty + 2) * (tx + 2) * s * 16 + ty * tx * st * nout * 8 +
         (ty + 2) * (tx + 2) * s * 4 + ((ty + 2) * (tx + 2) + 1) * 4 +
         MAX_WARPS * 4;
}

constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// total gets the block's sum.  Leaves the warp sums free for the next call.
__device__ __forceinline__ int block_excl_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? wsum[warp - 1] : 0;
  total = wsum[nwarps - 1];
  __syncthreads();
  return before + x - v;
}

// 8 mask bytes -> one bit per nonzero byte, in bit 8j for slot j.
__device__ __forceinline__ uint64_t live_bytes(uint64_t m8) {
  m8 |= m8 >> 4;
  m8 |= m8 >> 2;
  m8 |= m8 >> 1;
  return m8 & 0x0101010101010101ull;
}

// The sums of one target (x, y) over the live sources of the 3 neighbour rows
// of halo box b, NOUT complex channels as (re, im) pairs.
template <int NOUT>
__device__ __forceinline__ void stencil_sums(float x, float y, int b, int HX,
                                             const int* start, const float4* rec,
                                             float two_s2, int singular,
                                             float (&acc)[2 * NOUT]) {
#pragma unroll
  for (int c = 0; c < 2 * NOUT; ++c) acc[c] = 0.f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int row = b + dy * HX;                       // boxes row-1 .. row+1
    const int end = start[row + 2];
    for (int i = start[row - 1]; i < end; ++i) {
      const float4 src = rec[i];
      const float ddx = x - src.x, ddy = y - src.y;
      const float r2 = ddx * ddx + ddy * ddy;
      if (!(r2 > 0.f)) continue;
      if constexpr (NOUT == 1) {
        float inv = 1.f / r2;
        if (!singular) inv *= 1.f - expf(-r2 / two_s2);
        acc[0] += (src.z * ddx + src.w * ddy) * inv;
        acc[1] += (src.w * ddx - src.z * ddy) * inv;
      } else {
        const float w = singular ? 1.f : 1.f - expf(-r2 / two_s2);
        const float pot = 0.5f * logf(r2) * w, inv = w / r2;
        acc[0] += src.z * pot;
        acc[1] += src.w * pot;
        acc[2] -= (src.z * ddx + src.w * ddy) * inv;
        acc[3] -= (src.w * ddx - src.z * ddy) * inv;
      }
    }
  }
}

// S_, TY_, TX_ > 0: compile-time slots and tile (the s = 8, 16 x 16 case);
// 0: taken from the arguments.  NOUT: the formula's channels; PASSIVE:
// targets from zt / mt.
template <int S_, int TY_, int TX_, int NOUT, bool PASSIVE>
__global__ void __launch_bounds__(TY_ ? round32((TY_ + 2) * (TX_ + 2)) : 1024,
                                  TY_ ? 3 : 1)
p2p_kernel(const float2* __restrict__ z, const float2* __restrict__ q,
           const uint8_t* __restrict__ m, const float2* __restrict__ zt,
           const uint8_t* __restrict__ mt, float2* __restrict__ out, int rows,
           int cols, int s_arg, int st_arg, int ty_arg, int tx_arg,
           float two_s2, int singular) {
  static_assert(S_ == 0 || (S_ == 8 && NOUT == 1 && !PASSIVE),
                "the compile-time instance is the vortex one at 8 slots");
  const int s = S_ ? S_ : s_arg;
  const int st = PASSIVE ? st_arg : s;                      // target slots a box
  const int so = st * NOUT;                                  // output values a box
  const int TY = TY_ ? TY_ : ty_arg, TX = TX_ ? TX_ : tx_arg;
  const int HX = TX + 2, NB = (TY + 2) * HX;
  extern __shared__ float4 smem[];
  float4* rec = smem;                                        // NB * s
  float2* obuf = reinterpret_cast<float2*>(rec + NB * s);    // TY * TX * so
  uint32_t* tag = reinterpret_cast<uint32_t*>(obuf + TY * TX * so);
  int* start = reinterpret_cast<int*>(tag + NB * s);         // NB + 1
  int* wsum = start + NB + 1;

  const int tid = threadIdx.x;
  // the tile's first target box; halo row r0, column c0 is its corner ghost
  const int r0 = blockIdx.y * TY, c0 = blockIdx.x * TX;
  const int W = cols + 2;

  for (int e = tid; e < TY * TX * so; e += blockDim.x) obuf[e] = make_float2(0.f, 0.f);

  // ---- stage the halo tile's live sources, packed in box order ----
  int running = 0;
  for (int base = 0; base < NB; base += blockDim.x) {
    const int b = base + tid;
    size_t g = 0;
    int cnt = 0;
    uint64_t bits = 0;                   // S_ == 8: bit 8j set if slot j is live
    float2 zz[S_ ? S_ : 1], qq[S_ ? S_ : 1];
    if (b < NB) {
      const int gy = r0 + b / HX, gx = c0 + b % HX;
      if (gy < rows + 2 && gx < W) {
        g = ((size_t)gy * W + gx) * s;
        if constexpr (S_ == 8) {
          bits = live_bytes(*reinterpret_cast<const unsigned long long*>(m + g));
          cnt = __popcll(bits);
        } else {
          for (int j = 0; j < s; ++j) cnt += m[g + j] != 0;
        }
      }
    }
    if constexpr (S_ > 0) {              // issue the loads before the scan
#pragma unroll
      for (int j = 0; j < S_; ++j)
        if ((bits >> (8 * j)) & 1) {
          zz[j] = z[g + j];
          qq[j] = q[g + j];
        }
    }
    int total;
    int k = running + block_excl_scan(cnt, wsum, total);
    if (b < NB) start[b] = k;
    if (cnt) {
      if constexpr (S_ > 0) {
#pragma unroll
        for (int j = 0; j < S_; ++j)
          if ((bits >> (8 * j)) & 1) {
            rec[k] = make_float4(zz[j].x, zz[j].y, qq[j].x, qq[j].y);
            if constexpr (PASSIVE) ++k;
            else tag[k++] = (uint32_t)b << 8 | j;
          }
      } else {
        for (int j = 0; j < s; ++j)
          if (m[g + j]) {
            const float2 zj = z[g + j], qj = q[g + j];
            rec[k] = make_float4(zj.x, zj.y, qj.x, qj.y);
            if constexpr (PASSIVE) ++k;
            else tag[k++] = (uint32_t)b << 8 | j;
          }
      }
    }
    running += total;
  }
  if (tid == 0) start[NB] = running;
  __syncthreads();

  if constexpr (PASSIVE) {
    // ---- one thread per target slot of the tile, masked ones skipped ----
    for (int e = tid; e < TY * TX * st; e += blockDim.x) {
      const int box = e / st, j = e - box * st;
      const int ty = box / TX, tx = box - ty * TX;
      if (r0 + ty >= rows || c0 + tx >= cols) continue;   // past the ragged edge
      const size_t g = ((size_t)(r0 + ty) * cols + c0 + tx) * st + j;
      const bool live = mt[g] != 0;
      const float2 zk = zt[g];                          // loaded beside the mask
      if (!live) continue;
      float acc[2 * NOUT];
      stencil_sums<NOUT>(zk.x, zk.y, (ty + 1) * HX + tx + 1, HX, start, rec,
                         two_s2, singular, acc);
#pragma unroll
      for (int c = 0; c < NOUT; ++c) obuf[e * NOUT + c] = make_float2(acc[2 * c], acc[2 * c + 1]);
    }
  } else {
    // ---- one thread per live target of the inner rows ----
    const int lo = start[HX], hi = start[(TY + 1) * HX];
    for (int k = lo + tid; k < hi; k += blockDim.x) {
      const uint32_t t = tag[k];
      const int b = t >> 8, j = t & 0xff;
      const int hy = b / HX, hx = b - hy * HX;
      if (hx == 0 || hx == HX - 1) continue;             // a ghost column: source only
      if (r0 + hy - 1 >= rows || c0 + hx - 1 >= cols) continue;   // past the ragged edge
      const float4 zk = rec[k];
      float acc[2 * NOUT];
      stencil_sums<NOUT>(zk.x, zk.y, b, HX, start, rec, two_s2, singular, acc);
      const int e = ((hy - 1) * TX + hx - 1) * s + j;
#pragma unroll
      for (int c = 0; c < NOUT; ++c) obuf[e * NOUT + c] = make_float2(acc[2 * c], acc[2 * c + 1]);
    }
  }
  __syncthreads();

  // ---- every output element of the tile, coalesced ----
  const int row_elems = TX * so;                         // per tile row
  const int ncol = min(TX, cols - c0) * so;              // of them inside the grid
  if constexpr (S_ > 0 && S_ % 2 == 0) {                 // two slots a 16-byte store
    const float4* o4 = reinterpret_cast<const float4*>(obuf);
    for (int e = tid; e < TY * row_elems / 2; e += blockDim.x) {
      const int ty = 2 * e / row_elems, rem = 2 * e - ty * row_elems;
      if (r0 + ty < rows && rem < ncol)
        *reinterpret_cast<float4*>(out + ((size_t)(r0 + ty) * cols + c0) * so + rem) = o4[e];
    }
  } else {
    for (int e = tid; e < TY * row_elems; e += blockDim.x) {
      const int ty = e / row_elems, rem = e - ty * row_elems;
      if (r0 + ty < rows && rem < ncol)
        out[((size_t)(r0 + ty) * cols + c0) * so + rem] = obuf[e];
    }
  }
}

template <int S_, int TY_, int TX_, int NOUT, bool PASSIVE>
int launch(const void* z, const void* q, const void* m, const void* zt,
           const void* mt, void* out, int rows, int cols, int s, int st, int ty,
           int tx, float two_s2, int singular, int threads, int smem,
           cudaStream_t stream) {
  auto kernel = p2p_kernel<S_, TY_, TX_, NOUT, PASSIVE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((cols + tx - 1) / tx, (rows + ty - 1) / ty);
  kernel<<<grid, threads, smem, stream>>>(
      (const float2*)z, (const float2*)q, (const uint8_t*)m, (const float2*)zt,
      (const uint8_t*)mt, (float2*)out, rows, cols, s, st, ty, tx, two_s2,
      singular);
  return (int)cudaGetLastError();
}

}  // namespace

// zt, mt: passive targets (rows, cols, st), or both null for the sources as
// targets (st == s); nout: 1 (vortex) or 2 (Laplace); ty x tx target boxes a
// block, threads and smem as kernels/p2p.py's launch_config gives them;
// returns 0 or a cudaError_t.
extern "C" int p2p_launch(const void* z, const void* q, const void* m,
                          const void* zt, const void* mt, void* out, int rows,
                          int cols, int s, int st, int nout, int ty, int tx,
                          float two_s2, int singular, int threads, int smem,
                          void* stream) {
  const int nb = (ty + 2) * (tx + 2);
  const bool passive = zt != nullptr;
  if (rows <= 0 || cols <= 0 || s <= 0 || s > MAX_SLOTS || st <= 0 ||
      st > MAX_SLOTS || (nout != 1 && nout != 2) || passive != (mt != nullptr) ||
      (!passive && st != s) || ty <= 0 || tx <= 0 || threads % 32 ||
      threads < 32 || threads > 1024 || nb > (1 << 24) ||
      smem != smem_bytes(ty, tx, s, st, nout) || (rows + ty - 1) / ty > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t sm = (cudaStream_t)stream;
  if (!passive && nout == 1 && s == 8 && ty == 16 && tx == 16 &&
      threads == round32(18 * 18))
    return launch<8, 16, 16, 1, false>(z, q, m, zt, mt, out, rows, cols, s, st,
                                       ty, tx, two_s2, singular, threads, smem, sm);
  if (nout == 1)
    return (passive ? launch<0, 0, 0, 1, true> : launch<0, 0, 0, 1, false>)(
        z, q, m, zt, mt, out, rows, cols, s, st, ty, tx, two_s2, singular,
        threads, smem, sm);
  return (passive ? launch<0, 0, 0, 2, true> : launch<0, 0, 0, 2, false>)(
      z, q, m, zt, mt, out, rows, cols, s, st, ty, tx, two_s2, singular,
      threads, smem, sm);
}
