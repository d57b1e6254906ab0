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
// any other s (up to TILE_SLOTS = 256), tile, formula or target mode runs
// the same code with them at run time.
// - Past 256 source or target slots a tag's 8 bits no longer hold the slot,
//   and a halo tile's records stop fitting shared memory (a 2 x 2 tile holds
//   about 640 slots).  There p2p_stream_kernel takes over: one target box and
//   pass of 256 of its target slots (gridDim.z = batch x passes) a block of
//   256 threads, or a cluster of `split` such blocks.  A block first packs
//   the pass's live targets by a scan of their mask, one a thread, so that
//   they fill the first warps and a warp past the live count sits out.  The
//   neighbourhood's 9 s source slots, in stencil order, are cut into
//   `split` equal parts; rank r streams its part's live sources through
//   shared memory in chunks of 1024 records, each chunk packed by one block
//   scan of the mask (4 consecutive slots a thread, so the records keep
//   stencil order).  Two targets a thread (128-thread blocks) measured
//   slower: the pair term's branch keeps a thread's two sums from
//   overlapping.
//   One block a box and pass, each thread summing all 9 s sources in one
//   dependent chain, left the service's small grids on 128 blocks, an
//   eighth of the card's threads (0.484 ms at 8 x 8 boxes of 512 slots,
//   1.812 at 4 x 4 of 2048, on an H100).  So a grid of fewer than 2 x 132
//   boxes x passes runs split 9, one neighbour box a block: a cluster past
//   the portable 8 (cudaFuncAttributeNonPortableClusterSizeAllowed), since
//   a cluster of 3 (a neighbour row a block) leaves each chain 3x longer
//   and ran up to 1.5x slower (tools/range_forms.py --sweep).  A larger
//   grid runs split 1.  The split is chosen from the grid's shape alone
//   (stream_split, mirrored by kernels/p2p.py:stream_launch_config).  In a
//   cluster each rank writes its partial sums of the pass's 256 slots, zero
//   at dead targets, to its own shared memory; after a cluster barrier rank
//   r adds slots r * ceil(256 / split) .. over the ranks' partials in rank
//   order, read through distributed shared memory, and writes them; a
//   second barrier keeps the partials alive until all are read.  No
//   atomics: two launches, and a grid alone or in a batch, are bit for bit
//   equal.  A cluster whose targets are all dead stages nothing.  Built
//   without fast math, so expf, logf and the division are the IEEE-accurate
//   forms.
//
// Batch: B independent grids of these shapes, stacked on a leading axis,
// run in one launch with B on gridDim.z; block z offsets every pointer by
// its grid's slice (64-bit offsets), and the tiles and shared memory do not
// depend on B.  A bucket of jobs of the serving engine is one launch.
//
// Layouts: z, q complex64 (B, rows+2, cols+2, s) as float2, 16-byte aligned;
// mask uint8 (same), 8-byte aligned, and so is every slice at s = 8, where
// a box's mask is one 8-byte word; zt complex64 and mt uint8
// (B, rows, cols, st); out complex64 (B, rows, cols, st[, 2]).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_WARPS = 32;
constexpr int TILE_SLOTS = 256;   // kernels/p2p.py:TILE_SLOTS; a tag keeps the slot in 8 bits
constexpr int STREAM_THREADS = 256;   // kernels/p2p.py:STREAM_THREADS; target slots a pass
constexpr int STREAM_RAW = 4;         // raw source slots a thread packs a chunk
constexpr int STREAM_RECORDS = STREAM_THREADS * STREAM_RAW;  // source records a chunk
constexpr int STREAM_SPLIT = 9;       // kernels/p2p.py:STREAM_SPLIT: a box a block
constexpr int STREAM_SMS = CARD_SMS;  // kernels/_build.py:SMS, by nvcc -D

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

// Shared memory of p2p_stream_kernel: a chunk of records, the packed live
// targets of a pass and the warp sums (kernels/p2p.py:STREAM_SMEM).
constexpr int STREAM_SMEM = STREAM_RECORDS * 16 + STREAM_THREADS * 4 + MAX_WARPS * 4;

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

// One target (x, y) against one source record, NOUT complex channels as
// (re, im) pairs: the vortex pair term (NOUT 1) or Laplace's potential and
// field (NOUT 2), mollified unless singular; a coincident source adds 0.
template <int NOUT>
__device__ __forceinline__ void add_source(float x, float y, const float4 src,
                                           float two_s2, int singular,
                                           float (&acc)[2 * NOUT]) {
  const float ddx = x - src.x, ddy = y - src.y;
  const float r2 = ddx * ddx + ddy * ddy;
  if (!(r2 > 0.f)) return;
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
    for (int i = start[row - 1]; i < end; ++i)
      add_source<NOUT>(x, y, rec[i], two_s2, singular, acc);
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
  // this block's grid of the batch
  const size_t src_slice = (size_t)(rows + 2) * (cols + 2) * s;
  const size_t tgt_slice = (size_t)rows * cols * st;
  z += blockIdx.z * src_slice;
  q += blockIdx.z * src_slice;
  m += blockIdx.z * src_slice;
  if constexpr (PASSIVE) {
    zt += blockIdx.z * tgt_slice;
    mt += blockIdx.z * tgt_slice;
  }
  out += blockIdx.z * tgt_slice * NOUT;
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
           const void* mt, void* out, int batch, int rows, int cols, int s, int st, int ty,
           int tx, float two_s2, int singular, int threads, int smem,
           cudaStream_t stream) {
  auto kernel = p2p_kernel<S_, TY_, TX_, NOUT, PASSIVE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((cols + tx - 1) / tx, (rows + ty - 1) / ty, batch);
  kernel<<<grid, threads, smem, stream>>>(
      (const float2*)z, (const float2*)q, (const uint8_t*)m, (const float2*)zt,
      (const uint8_t*)mt, (float2*)out, rows, cols, s, st, ty, tx, two_s2,
      singular);
  return (int)cudaGetLastError();
}

// Any slot counts (the launcher sends it those past TILE_SLOTS): blockIdx.x
// = box x * split + rank, blockIdx.y = box y, blockIdx.z = grid * passes +
// pass; blockDim.x == STREAM_THREADS.  The pass's live targets among its
// STREAM_THREADS slots are packed first (a block scan of their mask), and
// thread i takes packed target i, so live targets fill the first warps and
// the rest sit out.  The cluster's `split` blocks share one box and pass:
// rank r sums the r-th of `split` equal parts of the neighbourhood's 9 s
// source slots in stencil order (split 9: neighbour box r), and the ranks'
// partial sums are added in rank order through distributed shared memory.
// Within a part sources are visited in stencil order (neighbour rows,
// boxes, slots).
// Five blocks an SM (48 registers, no spill): at the 54 registers the
// compiler takes unbounded only four fit, and the split grids ran slower.
template <int NOUT, bool PASSIVE>
__global__ void __launch_bounds__(STREAM_THREADS, 5)
p2p_stream_kernel(const float2* __restrict__ z, const float2* __restrict__ q,
                  const uint8_t* __restrict__ m, const float2* __restrict__ zt,
                  const uint8_t* __restrict__ mt, float2* __restrict__ out,
                  int rows, int cols, int s, int st, int split, float two_s2,
                  int singular) {
  const int passes = (st + STREAM_THREADS - 1) / STREAM_THREADS;
  const int grid = blockIdx.z / passes, pass = blockIdx.z - grid * passes;
  const size_t src_slice = (size_t)(rows + 2) * (cols + 2) * s;
  const size_t tgt_slice = (size_t)rows * cols * st;
  z += grid * src_slice;
  q += grid * src_slice;
  m += grid * src_slice;
  if constexpr (PASSIVE) {
    zt += grid * tgt_slice;
    mt += grid * tgt_slice;
  }
  out += grid * tgt_slice * NOUT;
  extern __shared__ float4 smem[];
  float4* rec = smem;                                          // STREAM_RECORDS
  int* tslot = reinterpret_cast<int*>(rec + STREAM_RECORDS);   // STREAM_THREADS
  int* wsum = tslot + STREAM_THREADS;                          // MAX_WARPS

  const int tid = threadIdx.x, by = blockIdx.y;
  const int rank = blockIdx.x % split, bx = blockIdx.x / split;
  const int W = cols + 2;
  const int nraw = 9 * s / split, raw0 = rank * nraw;  // this block's source slots
  // this box's target slots: the passive block's, or the box's own sources
  const float2* zk_ = PASSIVE ? zt : z;
  const uint8_t* mk_ = PASSIVE ? mt : m;
  const size_t tg = PASSIVE ? ((size_t)by * cols + bx) * st
                            : ((size_t)(by + 1) * W + bx + 1) * s;
  const int j0 = pass * STREAM_THREADS;                        // the pass's first slot
  float2* o = out + (((size_t)by * cols + bx) * st + j0) * NOUT;

  // pack the pass's live targets
  const bool live = j0 + tid < st && mk_[tg + j0 + tid] != 0;
  int nlive;
  const int k = block_excl_scan(live, wsum, nlive);
  if (live) tslot[k] = tid;
  __syncthreads();
  const bool has = tid < nlive;                                // packed target tid
  const int t = has ? tslot[tid] : 0;
  float2 zk = make_float2(0.f, 0.f);
  if (has) zk = zk_[tg + j0 + t];
  float acc[2 * NOUT];
#pragma unroll
  for (int c = 0; c < 2 * NOUT; ++c) acc[c] = 0.f;
  if (nlive > 0) {
    for (int r0 = 0; r0 < nraw; r0 += STREAM_RECORDS) {
      // pack the chunk's live sources: STREAM_RAW consecutive raw slots a
      // thread, one block scan a chunk
      const int rb = r0 + tid * STREAM_RAW;
      int nb = (raw0 + rb) / s, js = raw0 + rb - nb * s;
      float4 v[STREAM_RAW];
      uint32_t bits = 0;
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < STREAM_RAW; ++i) {
        if (rb + i < nraw) {
          const size_t g = ((size_t)(by + nb / 3) * W + bx + nb % 3) * s + js;
          if (m[g]) {
            const float2 zj = z[g], qj = q[g];
            v[i] = make_float4(zj.x, zj.y, qj.x, qj.y);
            bits |= 1u << i;
            ++cnt;
          }
        }
        if (++js == s) {
          js = 0;
          ++nb;
        }
      }
      int total;
      int r = block_excl_scan(cnt, wsum, total);
#pragma unroll
      for (int i = 0; i < STREAM_RAW; ++i)
        if ((bits >> i) & 1) rec[r++] = v[i];
      __syncthreads();
      if (has)
        for (int i = 0; i < total; ++i) add_source<NOUT>(zk.x, zk.y, rec[i], two_s2, singular, acc);
      __syncthreads();                   // the chunk is free for the next
    }
  }
  if (split == 1) {
    // zeros at the pass's dead slots, the sums at its live ones
    if (j0 + tid < st && !live)
#pragma unroll
      for (int c = 0; c < NOUT; ++c) o[(size_t)tid * NOUT + c] = make_float2(0.f, 0.f);
    if (has)
#pragma unroll
      for (int c = 0; c < NOUT; ++c) o[(size_t)t * NOUT + c] = make_float2(acc[2 * c], acc[2 * c + 1]);
    return;
  }
  // the partial sums of the pass's slots, channel-major, where the chunk
  // was, zero at dead targets; rank r adds up slots r * per .. + per - 1
  float* partial = reinterpret_cast<float*>(smem);             // 2 NOUT x STREAM_THREADS
#pragma unroll
  for (int c = 0; c < 2 * NOUT; ++c) partial[c * STREAM_THREADS + tid] = 0.f;
  __syncthreads();
  if (has)
#pragma unroll
    for (int c = 0; c < 2 * NOUT; ++c) partial[c * STREAM_THREADS + t] = acc[c];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (STREAM_THREADS + split - 1) / split;
  const int u = rank * per + tid;                              // a slot of the pass
  if (tid < per && u < STREAM_THREADS && j0 + u < st) {
    float sum[2 * NOUT];
    const float* p0 = cluster.map_shared_rank(partial, 0);
#pragma unroll
    for (int c = 0; c < 2 * NOUT; ++c) sum[c] = p0[c * STREAM_THREADS + u];
    for (int rk = 1; rk < split; ++rk) {
      const float* pr = cluster.map_shared_rank(partial, rk);
#pragma unroll
      for (int c = 0; c < 2 * NOUT; ++c) sum[c] += pr[c * STREAM_THREADS + u];
    }
#pragma unroll
    for (int c = 0; c < NOUT; ++c) o[(size_t)u * NOUT + c] = make_float2(sum[2 * c], sum[2 * c + 1]);
  }
  cluster.sync();                                              // partials read: blocks may leave
}

// The streaming form's cluster split on a rows x cols grid of st target
// slots a box, the same for every grid of a batch (kernels/p2p.py:
// stream_launch_config): STREAM_SPLIT where the boxes x passes are fewer
// than 2 x STREAM_SMS blocks, else 1.
int stream_split(int rows, int cols, int st) {
  const long long blocks =
      (long long)rows * cols * ((st + STREAM_THREADS - 1) / STREAM_THREADS);
  return blocks < 2 * STREAM_SMS ? STREAM_SPLIT : 1;
}

template <int NOUT, bool PASSIVE>
int launch_stream(const void* z, const void* q, const void* m, const void* zt,
                  const void* mt, void* out, int batch, int rows, int cols, int s,
                  int st, int split, float two_s2, int singular, cudaStream_t stream) {
  auto kernel = p2p_stream_kernel<NOUT, PASSIVE>;
  if (split > 8) {                        // 9 neighbour boxes: past the portable 8
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cols * split, rows,
                     batch * ((st + STREAM_THREADS - 1) / STREAM_THREADS));
  cfg.blockDim = dim3(STREAM_THREADS);
  cfg.dynamicSmemBytes = STREAM_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1;                                    // split 1: a plain launch
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const float2*)z, (const float2*)q, (const uint8_t*)m,
      (const float2*)zt, (const uint8_t*)mt, (float2*)out, rows, cols, s, st, split,
      two_s2, singular);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The streaming form's cluster split on a rows x cols grid with s source
// and st target slots (kernels/p2p.py:stream_launch_config), or -1 where
// the tiled kernel takes the launch.
extern "C" int p2p_stream_split(int rows, int cols, int s, int st) {
  if (rows <= 0 || cols <= 0 || s <= 0 || st <= 0) return -1;
  return s > TILE_SLOTS || st > TILE_SLOTS ? stream_split(rows, cols, st) : -1;
}

// batch: the grids stacked on the leading axis (1 to 65535); zt, mt: passive
// targets (batch, rows, cols, st), or both null for the sources as targets
// (st == s); nout: 1 (vortex) or 2 (Laplace); ty x tx target boxes a block,
// threads and smem as kernels/p2p.py's launch_config gives them (past
// TILE_SLOTS source or target slots: 1 x 1, STREAM_THREADS, STREAM_SMEM,
// the cluster split from p2p_stream_split);
// returns 0 or a cudaError_t.
extern "C" int p2p_launch(const void* z, const void* q, const void* m,
                          const void* zt, const void* mt, void* out, int batch,
                          int rows, int cols, int s, int st, int nout, int ty,
                          int tx, float two_s2, int singular, int threads,
                          int smem, void* stream) {
  const int nb = (ty + 2) * (tx + 2);
  const bool passive = zt != nullptr;
  if (rows <= 0 || cols <= 0 || s <= 0 || st <= 0 || s > (1 << 24) ||
      st > (1 << 24) || (nout != 1 && nout != 2) || passive != (mt != nullptr) ||
      (!passive && st != s) || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t sm = (cudaStream_t)stream;
  if (s > TILE_SLOTS || st > TILE_SLOTS) {
    const int split = stream_split(rows, cols, st);
    if (ty != 1 || tx != 1 || threads != STREAM_THREADS || smem != STREAM_SMEM ||
        rows > 65535 || (long long)cols * split > 0x7fffffff ||
        (long long)batch * ((st + STREAM_THREADS - 1) / STREAM_THREADS) > 65535)
      return (int)cudaErrorInvalidValue;
    if (nout == 1)
      return (passive ? launch_stream<1, true> : launch_stream<1, false>)(
          z, q, m, zt, mt, out, batch, rows, cols, s, st, split, two_s2, singular, sm);
    return (passive ? launch_stream<2, true> : launch_stream<2, false>)(
        z, q, m, zt, mt, out, batch, rows, cols, s, st, split, two_s2, singular, sm);
  }
  if (ty <= 0 || tx <= 0 || threads % 32 || threads < 32 || threads > 1024 ||
      nb > (1 << 24) || smem != smem_bytes(ty, tx, s, st, nout) ||
      (rows + ty - 1) / ty > 65535)
    return (int)cudaErrorInvalidValue;
  if (!passive && nout == 1 && s == 8 && ty == 16 && tx == 16 &&
      threads == round32(18 * 18))
    return launch<8, 16, 16, 1, false>(z, q, m, zt, mt, out, batch, rows, cols, s,
                                       st, ty, tx, two_s2, singular, threads, smem, sm);
  if (nout == 1)
    return (passive ? launch<0, 0, 0, 1, true> : launch<0, 0, 0, 1, false>)(
        z, q, m, zt, mt, out, batch, rows, cols, s, st, ty, tx, two_s2, singular,
        threads, smem, sm);
  return (passive ? launch<0, 0, 0, 2, true> : launch<0, 0, 0, 2, false>)(
      z, q, m, zt, mt, out, batch, rows, cols, s, st, ty, tx, two_s2, singular,
      threads, smem, sm);
}
