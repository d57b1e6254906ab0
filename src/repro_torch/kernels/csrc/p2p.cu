// Near-field direct interactions (P2P) over a halo'd leaf grid, vortex kernel.
//
// Replaces the TPU kernel _p2p_kernel / p2p_pallas_slab in
// src/repro/kernels/p2p.py.  out[y, x, k] = sum over the 3x3 neighbour boxes
// (y+dy, x+dx) of the halo'd grid and their s slots j of
//   q_j (z_k - z_j) / |z_k - z_j|^2 * (1 - exp(-|z_k - z_j|^2 / (2 sigma^2)))
// in explicit real/imag arithmetic (EquationSpec.p2p_terms), skipping empty
// source slots and coincident pairs (r2 > 0).  singular != 0 drops the
// mollifier.
//
// Bound on an H100: bytes (z, q, mask read once and the output written once,
// about 210 MB at the paper's size); the arithmetic, one division and one
// expf per live pair, is far smaller because most slots are empty.  Design:
// a block owns a BY x BX tile of target boxes and stages the (BY+2) x (BX+2)
// x s halo tile of z, q and mask into shared memory once, so each source is
// read from device memory about once instead of nine times; one thread per
// (target box, slot) accumulates re/im in registers and writes once.  Built
// without fast math, so expf and the division are the IEEE-accurate forms.
//
// Layouts: z, q complex64 (rows+2, cols+2, s) as float2; mask uint8 (same);
// out complex64 (rows, cols, s).  Masked target slots get don't-care values.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void p2p_kernel(const float2* __restrict__ z,
                           const float2* __restrict__ q,
                           const uint8_t* __restrict__ m,
                           float2* __restrict__ out,
                           int rows, int cols, int s, int BY, int BX,
                           float two_s2, int singular) {
  extern __shared__ float2 smem[];
  const int HX = BX + 2;
  const int T = (BY + 2) * HX * s;
  float2* sz = smem;
  float2* sq = smem + T;
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem + 2 * T);

  const int r0 = blockIdx.y * BY, c0 = blockIdx.x * BX;
  const int W = cols + 2;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int k = t % s, b = t / s;
    const int gy = r0 + b / HX, gx = c0 + b % HX;
    float2 zz = make_float2(0.f, 0.f), qq = make_float2(0.f, 0.f);
    uint8_t mm = 0;
    if (gy < rows + 2 && gx < W) {
      const size_t g = ((size_t)gy * W + gx) * s + k;
      zz = z[g];
      qq = q[g];
      mm = m[g];
    }
    sz[t] = zz;
    sq[t] = qq;
    sm[t] = mm;
  }
  __syncthreads();

  const int NT = BY * BX * s;
  for (int t = threadIdx.x; t < NT; t += blockDim.x) {
    const int k = t % s, b = t / s;
    const int by = b / BX, bx = b % BX;
    const int ty = r0 + by, tx = c0 + bx;
    if (ty >= rows || tx >= cols) continue;
    const float2 zt = sz[((by + 1) * HX + (bx + 1)) * s + k];
    float re = 0.f, im = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int base = ((by + dy) * HX + (bx + dx)) * s;
        for (int j = 0; j < s; ++j) {
          if (!sm[base + j]) continue;
          const float2 zs = sz[base + j];
          const float ddx = zt.x - zs.x, ddy = zt.y - zs.y;
          const float r2 = ddx * ddx + ddy * ddy;
          if (!(r2 > 0.f)) continue;
          float inv = 1.f / r2;
          if (!singular) inv *= 1.f - expf(-r2 / two_s2);
          const float2 qs = sq[base + j];
          re += (qs.x * ddx + qs.y * ddy) * inv;
          im += (qs.y * ddx - qs.x * ddy) * inv;
        }
      }
    }
    out[((size_t)ty * cols + tx) * s + k] = make_float2(re, im);
  }
}

extern "C" int p2p_launch(const void* z, const void* q, const void* m, void* out,
                          int rows, int cols, int s, int BY, int BX,
                          float two_s2, int singular, int threads,
                          int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        p2p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((cols + BX - 1) / BX, (rows + BY - 1) / BY);
  p2p_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float2*)z, (const float2*)q, (const uint8_t*)m, (float2*)out,
      rows, cols, s, BY, BX, two_s2, singular);
  return (int)cudaGetLastError();
}
