// Parity-folded multipole-to-local contraction (M2L) over parent planes.
//
// Replaces the TPU kernel _m2l_kernel / m2l_pallas_slab in
// src/repro/kernels/m2l.py.  With K = 4p,
//   out[y, x, b] = sum_{d < 8} sum_{a < K} stack[1 + Dy_d + y, 1 + Dx_d + x, a]
//                                          * W[d, a, b]
// over the PARENT_NEIGH8 offsets (Dx_d, Dy_d), in complex arithmetic.  The
// caller relayouts levels into the (PR+2, PC+2, K) stack and back.
//
// Bound on an H100: FP32 arithmetic, 8 K^2 complex multiply-adds (4 FMAs
// each) per parent; the stack, W and the output are each a few hundred MB at
// most.  Design: a block owns an 8 x 8 tile of parents and stages its
// 10 x 10 x K halo tile of the stack into shared memory once; it then walks
// the 8 offsets, staging W[d] (K x K) into shared memory for each.  Every
// thread keeps a 4-parent x 4-coefficient register tile of accumulators, so
// each pair of shared-memory loads feeds 16 complex multiply-adds.  IEEE
// FP32 FMAs on the SIMT units: no TF32 anywhere.
//
// Threads: 16 groups of p; group g owns parents (row g/2, cols 4(g%2)..+3)
// of the tile, thread h of the group owns coefficients b = h + p*j, j < 4.
#include <cuda_runtime.h>

#define TY 8
#define TX 8

__global__ void m2l_kernel(const float2* __restrict__ stack,
                           const float2* __restrict__ W,
                           float2* __restrict__ out, int PR, int PC, int p) {
  extern __shared__ float2 smem[];
  const int K = 4 * p;
  const int HX = TX + 2;
  float2* ss = smem;                         // (TY+2) x (TX+2) x K
  float2* ws = smem + (TY + 2) * HX * K;     // K x K

  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int SW = PC + 2;
  const int nT = (TY + 2) * HX * K;
  for (int t = threadIdx.x; t < nT; t += blockDim.x) {
    const int a = t % K, c = t / K;
    const int gy = y0 + c / HX, gx = x0 + c % HX;
    float2 v = make_float2(0.f, 0.f);
    if (gy < PR + 2 && gx < SW) v = stack[((size_t)gy * SW + gx) * K + a];
    ss[t] = v;
  }

  const int g = threadIdx.x / p, h = threadIdx.x % p;
  const int py = g >> 1, px0 = (g & 1) * 4;
  float accr[4][4], acci[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accr[i][j] = acci[i][j] = 0.f;

  for (int d = 0; d < 8; ++d) {
    const int r = d < 4 ? d : d + 1;         // 3x3 raster index, (0,0) skipped
    const int Dy = r / 3 - 1, Dx = r % 3 - 1;
    __syncthreads();                         // stack staged / last W[d] used
    const float2* Wd = W + (size_t)d * K * K;
    for (int t = threadIdx.x; t < K * K; t += blockDim.x) ws[t] = Wd[t];
    __syncthreads();
    const float2* srow = ss + ((py + 1 + Dy) * HX + (px0 + 1 + Dx)) * K;
    for (int a = 0; a < K; ++a) {
      float2 w[4], sv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ws[a * K + h + p * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = srow[i * K + a];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accr[i][j] = fmaf(sv[i].x, w[j].x, accr[i][j]);
          accr[i][j] = fmaf(-sv[i].y, w[j].y, accr[i][j]);
          acci[i][j] = fmaf(sv[i].x, w[j].y, acci[i][j]);
          acci[i][j] = fmaf(sv[i].y, w[j].x, acci[i][j]);
        }
      }
    }
  }

  const int ty = y0 + py;
  if (ty >= PR) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tx = x0 + px0 + i;
    if (tx >= PC) continue;
    float2* o = out + ((size_t)ty * PC + tx) * K + h;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[p * j] = make_float2(accr[i][j], acci[i][j]);
  }
}

extern "C" int m2l_smem_bytes(int p) {
  const int K = 4 * p;
  return ((TY + 2) * (TX + 2) * K + K * K) * (int)sizeof(float2);
}

extern "C" int m2l_launch(const void* stack, const void* W, void* out, int PR,
                          int PC, int p, void* stream) {
  const int smem = m2l_smem_bytes(p);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        m2l_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((PC + TX - 1) / TX, (PR + TY - 1) / TY);
  m2l_kernel<<<grid, 16 * p, smem, (cudaStream_t)stream>>>(
      (const float2*)stack, (const float2*)W, (float2*)out, PR, PC, p);
  return (int)cudaGetLastError();
}
