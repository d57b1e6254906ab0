// Leaf expansions: particles to multipoles (P2M) and locals to particles
// (L2P) on a leaf grid, with no power table in device memory.
//
// Replaces no TPU kernel: the reference's P2M and L2P are jnp
// (src/repro/core/expansions.py: p2m, l2p_eval), and so was the port's plain
// version (kernels/leaf_expansions.py: p2m_plain, l2p_plain), which stacks
// zhat^0 .. zhat^(p-1) of every slot along a new last axis and contracts it
// with an einsum: at the paper's size (1024 x 1024 boxes, 8 slots, p = 17)
// the table is 1.14 GB, written with a stride of 17 elements and read back
// whole, and the two stages took 24 ms of an evaluation on an H100.
//
// P2M: me[box, k] = c_k * sum over the box's live slots j of
//   q_j * zhat_j^k,  zhat_j = (z_j - centre) / r,
// with empty slots at zhat = 0 and q = 0 (an empty slot holds z = 0, whose
// zhat^(p-1) overflows float32 from level 9 at p = 17).  c_k are optional
// per-order weights (LaplaceEquation.p2m_coeff), complex.
// L2P: at every slot (live or not: the driver masks) of the box,
//   "value" = sum_l b_l zhat^l and "ngrad" = -(1/r) sum_l l b_l zhat^(l-1),
// by Horner's rule, the derivative's Horner beside the value's.  One or two
// output channels, each either mode (codes: bit c set = channel c "ngrad").
//
// Bound on an H100: bytes.  Every input is read once and every output
// written once: P2M reads z, q (67.1 MB each) and the mask (8.4 MB) and
// writes the coefficients (142.6 MB), 285 MB, 0.085 ms at 3.35 TB/s; L2P at
// the sources reads the coefficients and z and writes the values, 277 MB,
// 0.083 ms; at the probe grid's 4 slots 210 MB, 0.063 ms.  The arithmetic,
// p complex multiply-adds a slot (two running products in P2M), is some
// 2 GFLOP of FP32 at the paper's size, 0.03 ms on the SIMT units.
//
// Design: each byte crosses device memory once, coalesced, and the powers
// live in registers.
// - P2M: a block of 128 threads owns a tile of consecutive boxes, g threads
//   a box (g = 1 up to 8 slots, doubling every doubling of the slots past
//   that, at most a warp), so 128 / g boxes a tile.  The tile's slots are one
//   contiguous range of z, q and mask (the batch and the grid flatten into
//   one box index): the block stages up to 1024 of them at a time, neighbour
//   threads on neighbour slots, each thread's 8 slots' loads in flight at
//   once (a dead slot's z and q are read and dropped, so no load waits on
//   the mask), computing zhat and the masked charge on the way into shared
//   memory (box rows an odd number of slots apart, so the
//   threads of a warp, one box each, read distinct banks; the tile's
//   centres, loaded a thread a box, once a block).  A thread then
//   walks its share of its box's slots, skipping the empty ones (zhat = 0
//   and no charge add exactly nothing), keeping the running power and up to
//   K orders' sums in registers (K = 8, 16, 24 or 32, the least that holds
//   p); past 32 the orders go in chunks of 32, each chunk restarting the
//   running power from 1 and multiplying up to its first order, so the
//   products are those of the plain version's table.  A box's g partial
//   sums meet by warp shuffles; the tile's coefficients, times c_k, go
//   through shared memory and out as one contiguous range.  Slots past what
//   a tile stages (s > 1024 / boxes) are staged in chunks.
// - L2P: a block of 256 threads owns a tile of up to 256 / s boxes (one box
//   past 256 slots, the threads then looping over its slots), at most 4096
//   coefficients: it stages the tile's coefficients, one contiguous range,
//   into shared memory (box rows an odd number apart), then each thread takes
//   one slot (neighbour threads on neighbour slots; its first z and centre
//   are loaded before the stage's barrier), reads z once, runs
//   Horner over its box's row in shared memory and writes its channels (16
//   bytes at once for two).
// Every grid of the batch is independent; a launch's blocks and results do
// not depend on what else is in the batch beyond the box index, and no
// atomics: two launches are bit for bit equal.  Built without fast math: the
// division by r is IEEE round to nearest, as the plain version's (a product
// with 1 / r where r is a power of two, the same number).  Index arithmetic
// steps by adds (Walk), one division a thread and loop.
//
// Layouts: z, q complex64 (..., n, n, s) as float2; mask uint8 (same);
// centres complex64 (n, n), broadcast over the leading axes; coefficients
// complex64 (..., n, n, p); out complex64 (..., n, n, p) for P2M and
// (..., n, n, s[, 2]) for L2P.  Everything contiguous, 8-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int P2M_THREADS = 128;    // kernels/leaf_expansions.py:P2M_THREADS
constexpr int P2M_STAGE = 1024;     // slots a tile stages at once (P2M_STAGE)
constexpr int L2P_THREADS = 256;    // kernels/leaf_expansions.py:L2P_THREADS
constexpr int L2P_COEFFS = 4096;    // coefficients a tile stages at most (L2P_COEFFS)
constexpr int MAX_P = 1024;         // kernels/leaf_expansions.py:MAX_P
constexpr int STAGE_UNROLL = 8;     // slots a P2M thread loads at once (1024 / 128)

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * b + c
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 c) {
  return make_float2(c.x + (a.x * b.x - a.y * b.y), c.y + (a.x * b.y + a.y * b.x));
}

// Orders a thread keeps in registers for p: the least of 8, 16, 24, 32 that
// holds p, 32 past it (kernels/leaf_expansions.py:p2m_launch_config).
int p2m_orders(int p) { return p <= 8 ? 8 : p <= 16 ? 16 : p <= 24 ? 24 : 32; }

// Threads a box: 1 up to 8 slots, then the power of two that gives each
// thread at most 8 slots, at most 32.
int p2m_group(int s) {
  int g = 1;
  while (g < 32 && g * 8 < s) g *= 2;
  return g;
}

// The P2M launch for s slots at order p: orders a chunk, threads a box, boxes
// a tile, slots a stage, shared memory.  The stage's two arrays (zhat, the
// masked charge) and the tile's output share one buffer; the tile's centres
// follow it.
void p2m_config(int s, int p, int* k, int* g, int* nbox, int* sc, int* smem) {
  *k = p2m_orders(p);
  *g = p2m_group(s);
  *nbox = P2M_THREADS / *g;
  *sc = s < P2M_STAGE / *nbox ? s : P2M_STAGE / *nbox;
  const int stage = 2 * *nbox * (*sc | 1), tile = *nbox * (*k | 1);
  *smem = ((stage > tile ? stage : tile) + *nbox) * 8;
}

// The L2P launch for s slots at order p: boxes a tile and shared memory.
void l2p_config(int s, int p, int* nbox, int* smem) {
  int n = L2P_THREADS / s;
  const int cap = L2P_COEFFS / (p | 1);
  if (n > cap) n = cap;
  if (n < 1) n = 1;
  *nbox = n;
  *smem = n * (p | 1) * 8;
}

// (q, r) = divmod(i, d) for i = i0, i0 + stride, ...: a division once, then
// adds.
struct Walk {
  int q, r, dq, dr, d;
  __device__ Walk(int i0, int stride, int d_)
      : q(i0 / d_), r(i0 % d_), dq(stride / d_), dr(stride % d_), d(d_) {}
  __device__ __forceinline__ void step() {
    q += dq;
    r += dr;
    if (r >= d) {
      r -= d;
      ++q;
    }
  }
};

// (x - c) / r; with exact (r a power of two) as the product with 1 / r,
// which is the same number.
__device__ __forceinline__ float2 scaled(float2 x, float2 c, float r, float inv_r,
                                         bool exact) {
  return exact ? make_float2((x.x - c.x) * inv_r, (x.y - c.y) * inv_r)
               : make_float2((x.x - c.x) / r, (x.y - c.y) / r);
}

template <int K>
__global__ void __launch_bounds__(P2M_THREADS)
p2m_kernel(const float2* __restrict__ z, const float2* __restrict__ q,
           const uint8_t* __restrict__ m, const float2* __restrict__ cen,
           const float2* __restrict__ coeff, float2* __restrict__ out,
           long long nboxes, int nn, int s, int p, float r, float inv_r, int exact,
           int g, int nbox, int sc) {
  extern __shared__ float2 sm[];
  const int scp = sc | 1, ks = K | 1;
  float2* szh = sm;                 // the stage: zhat, box rows scp apart
  float2* sw = sm + nbox * scp;     // the masked charges
  float2* sout = sm;                // the tile's output, box rows ks apart
  float2* scen = sm + (2 * nbox * scp > nbox * ks ? 2 * nbox * scp : nbox * ks);
  const long long box0 = (long long)blockIdx.x * nbox;
  const int nb = (int)(nboxes - box0 < nbox ? nboxes - box0 : nbox);
  const int tid = threadIdx.x, b = tid / g, lane = tid % g;
  const unsigned full = 0xffffffffu;
  // a thread a box loads the tile's centres, in flight with the first stage
  float2 myc = make_float2(0.f, 0.f);
  if (tid < nb) myc = cen[(int)((box0 + tid) % nn)];
  bool centres = false;

  for (int k0 = 0; k0 < p; k0 += K) {
    const int kn = p - k0 < K ? p - k0 : K;
    float2 acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = make_float2(0.f, 0.f);
    for (int j0 = 0; j0 < s; j0 += sc) {
      const int sn = s - j0 < sc ? s - j0 : sc, total = nbox * sn;
      __syncthreads();              // the last stage's readers are done
      Walk at(tid, P2M_THREADS, sn);   // (box, slot) of the thread's next element
      for (int e0 = 0; e0 < total; e0 += P2M_THREADS * STAGE_UNROLL) {
        // every load of the round first, none waiting on another (a dead
        // slot's z and q are read and dropped): a thread keeps
        // STAGE_UNROLL slots' loads in flight
        uint8_t mm[STAGE_UNROLL];
        float2 zz[STAGE_UNROLL], qq[STAGE_UNROLL];
        Walk ld = at;
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
          const bool in = e0 + u * P2M_THREADS + tid < total && ld.q < nb;
          const long long i = (box0 + ld.q) * s + j0 + ld.r;
          mm[u] = in ? m[i] : 0;
          zz[u] = in ? z[i] : make_float2(0.f, 0.f);
          qq[u] = in ? q[i] : make_float2(0.f, 0.f);
          ld.step();
        }
        if (!centres) {             // once a block: the centres to shared memory
          if (tid < nbox) scen[tid] = myc;
          __syncthreads();
          centres = true;
        }
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
          if (e0 + u * P2M_THREADS + tid < total) {
            const bool live = mm[u] != 0;
            szh[at.q * scp + at.r] = live ? scaled(zz[u], scen[at.q], r, inv_r, exact)
                                          : make_float2(0.f, 0.f);
            sw[at.q * scp + at.r] = live ? qq[u] : make_float2(0.f, 0.f);
          }
          at.step();
        }
      }
      __syncthreads();
      for (int j = lane; j < sn; j += g) {
        const float2 zh = szh[b * scp + j], w = sw[b * scp + j];
        // an empty slot (zhat = 0, no charge) adds exactly nothing
        if (w.x == 0.f && w.y == 0.f && zh.x == 0.f && zh.y == 0.f) continue;
        float2 pw = make_float2(1.f, 0.f);
        for (int k = 0; k < k0; ++k) pw = cmul(pw, zh);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k < kn) {
            acc[k] = cfma(w, pw, acc[k]);
            pw = cmul(pw, zh);
          }
        }
      }
    }
    for (int o = g / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k].x += __shfl_xor_sync(full, acc[k].x, o);
        acc[k].y += __shfl_xor_sync(full, acc[k].y, o);
      }
    }
    __syncthreads();                // the stage's readers are done: sout reuses it
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kn && k % g == lane)
        sout[b * ks + k] = coeff ? cmul(acc[k], coeff[k0 + k]) : acc[k];
    }
    __syncthreads();
    Walk wo(tid, P2M_THREADS, kn);
    for (int e = tid; e < nb * kn; e += P2M_THREADS, wo.step())
      out[(box0 + wo.q) * p + k0 + wo.r] = sout[wo.q * ks + wo.r];
  }
}

template <int NOUT, bool GRAD>
__global__ void __launch_bounds__(L2P_THREADS)
l2p_kernel(const float2* __restrict__ le, const float2* __restrict__ z,
           const float2* __restrict__ cen, float2* __restrict__ out,
           long long nboxes, int nn, int s, int p, float r, float inv_r, int exact,
           int nbox, int codes) {
  extern __shared__ float2 sm[];
  const int ps = p | 1;
  const long long box0 = (long long)blockIdx.x * nbox;
  const int nb = (int)(nboxes - box0 < nbox ? nboxes - box0 : nbox);
  const int c0 = (int)(box0 % nn), total = nb * s;
  // the first slot's z and centre are on their way while the tile stages
  int t = threadIdx.x;
  Walk at(t, L2P_THREADS, s);       // (box, slot) of the thread's slot
  float2 zz = make_float2(0.f, 0.f), c = zz;
  if (t < total) {
    zz = z[box0 * s + t];
    c = cen[c0 + at.q < nn ? c0 + at.q : (c0 + at.q) % nn];
  }
  Walk st(threadIdx.x, L2P_THREADS, p);
  for (int e = threadIdx.x; e < nb * p; e += L2P_THREADS, st.step())
    sm[st.q * ps + st.r] = le[box0 * p + e];
  __syncthreads();
  for (; t < total; t += L2P_THREADS) {
    const long long i = box0 * s + t;
    const float2 zh = scaled(zz, c, r, inv_r, exact);
    const float2* bl = sm + at.q * ps;
    at.step();
    if (t + L2P_THREADS < total) {  // the next slot's loads, before the sums
      zz = z[i + L2P_THREADS];
      c = cen[c0 + at.q < nn ? c0 + at.q : (c0 + at.q) % nn];
    }
    float2 v = bl[p - 1];
    float2 d = make_float2(0.f, 0.f);
    if (GRAD && p > 1) d = make_float2((p - 1) * v.x, (p - 1) * v.y);
    for (int l = p - 2; l >= 0; --l) {
      const float2 b = bl[l];
      if (GRAD && l >= 1) d = cfma(d, zh, make_float2(l * b.x, l * b.y));
      v = cfma(v, zh, b);
    }
    const float2 ng = exact ? make_float2(-d.x * inv_r, -d.y * inv_r)
                            : make_float2(-d.x / r, -d.y / r);
    if constexpr (NOUT == 1) {
      out[i] = (codes & 1) ? ng : v;
    } else {
      const float2 a = (codes & 1) ? ng : v, o = (codes & 2) ? ng : v;
      reinterpret_cast<float4*>(out)[i] = make_float4(a.x, a.y, o.x, o.y);
    }
  }
}

// r = 2^e, whose reciprocal is exact: dividing by r and multiplying by 1 / r
// give the same number.
int power_of_two(float r) {
  int e;
  return std::frexp(r, &e) == 0.5f && std::isfinite(1.f / r);
}

template <int K>
int launch_p2m(const void* z, const void* q, const void* m, const void* cen,
               const void* coeff, void* out, long long nboxes, int nn, int s, int p,
               float r, int g, int nbox, int sc, int smem, cudaStream_t stream) {
  const long long blocks = (nboxes + nbox - 1) / nbox;
  p2m_kernel<K><<<(unsigned)blocks, P2M_THREADS, smem, stream>>>(
      (const float2*)z, (const float2*)q, (const uint8_t*)m, (const float2*)cen,
      (const float2*)coeff, (float2*)out, nboxes, nn, s, p, r, 1.f / r, power_of_two(r),
      g, nbox, sc);
  return (int)cudaGetLastError();
}

template <int NOUT, bool GRAD>
int launch_l2p(const void* le, const void* z, const void* cen, void* out,
               long long nboxes, int nn, int s, int p, float r, int nbox, int codes,
               int smem, cudaStream_t stream) {
  const long long blocks = (nboxes + nbox - 1) / nbox;
  l2p_kernel<NOUT, GRAD><<<(unsigned)blocks, L2P_THREADS, smem, stream>>>(
      (const float2*)le, (const float2*)z, (const float2*)cen, (float2*)out, nboxes,
      nn, s, p, r, 1.f / r, power_of_two(r), nbox, codes);
  return (int)cudaGetLastError();
}

bool valid_shape(long long nboxes, int nn, int s, int p, int nbox) {
  return nboxes >= 1 && nn >= 1 && nboxes % nn == 0 && s >= 1 && s <= (1 << 24) &&
         p >= 1 && p <= MAX_P && (nboxes + nbox - 1) / nbox <= 0x7fffffffLL;
}

}  // namespace

// The P2M launch's configuration for s slots at order p, as
// kernels/leaf_expansions.py:p2m_launch_config gives it.
extern "C" void leaf_p2m_config(int s, int p, int* k, int* g, int* nbox, int* sc,
                                int* smem) {
  p2m_config(s, p, k, g, nbox, sc, smem);
}

// The L2P launch's configuration (kernels/leaf_expansions.py:l2p_launch_config).
extern "C" void leaf_l2p_config(int s, int p, int* nbox, int* smem) {
  l2p_config(s, p, nbox, smem);
}

// nboxes: the boxes of every grid of the batch (a multiple of nn = n * n);
// coeff: p complex weights or null; smem: the wrapper's
// p2m_launch_config, which must be this file's; returns 0 or a cudaError_t.
extern "C" int leaf_p2m_launch(const void* z, const void* q, const void* m,
                               const void* cen, const void* coeff, void* out,
                               long long nboxes, int nn, int s, int p, float r,
                               int smem, void* stream) {
  int k, g, nbox, sc, want;
  if (s < 1 || p < 1) return (int)cudaErrorInvalidValue;
  p2m_config(s, p, &k, &g, &nbox, &sc, &want);
  if (!valid_shape(nboxes, nn, s, p, nbox) || smem != want || !(r > 0.f))
    return (int)cudaErrorInvalidValue;
  const auto launch = k == 8    ? launch_p2m<8>
                      : k == 16 ? launch_p2m<16>
                      : k == 24 ? launch_p2m<24>
                                : launch_p2m<32>;
  return launch(z, q, m, cen, coeff, out, nboxes, nn, s, p, r, g, nbox, sc, smem,
                (cudaStream_t)stream);
}

// nout: 1 or 2 channels; codes: bit c set = channel c is "ngrad", else
// "value"; smem: the wrapper's l2p_launch_config; returns 0 or a cudaError_t.
extern "C" int leaf_l2p_launch(const void* le, const void* z, const void* cen, void* out,
                               long long nboxes, int nn, int s, int p, float r, int nout,
                               int codes, int smem, void* stream) {
  int nbox, want;
  if (s < 1 || p < 1) return (int)cudaErrorInvalidValue;
  l2p_config(s, p, &nbox, &want);
  if (!valid_shape(nboxes, nn, s, p, nbox) || smem != want || !(r > 0.f) ||
      (nout != 1 && nout != 2) || codes < 0 || codes >= (1 << nout))
    return (int)cudaErrorInvalidValue;
  const auto launch = nout == 1 ? (codes ? launch_l2p<1, true> : launch_l2p<1, false>)
                                : (codes ? launch_l2p<2, true> : launch_l2p<2, false>);
  return launch(le, z, cen, out, nboxes, nn, s, p, r, nbox, codes, smem,
                (cudaStream_t)stream);
}
