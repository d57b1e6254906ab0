// Blockwise online-softmax (flash) attention with GQA, f32 math.
//
// Replaces the TPU kernel _fa_kernel / flash_attention in
// src/repro/kernels/flash_attn.py.  For q (B*H, T, d) and k, v (B*Hkv, S, d)
// it computes out = softmax(q k^T / sqrt(d) + mask) v row by row, where the
// query head bh reads the key/value row kv_row = (bh / H) * Hkv + (bh % H) /
// (H / Hkv) (no repeated heads in memory).  The causal mask is the TPU
// kernel's top-left one: key kpos is hidden from query qpos when kpos > qpos.
// For T == S that is the model's causal mask; for T != S it differs from the
// bottom-right mask of attention_ref (tril(k = S - T)), and the model routes
// only T == S here.  out = o / l with the TPU kernel's l > 0 guard.
//
// Bound on an H100 at the prefill shape of Yi-6B (B 4, H 32, Hkv 4, T = S =
// 2048, d 128, bf16, causal): 137.5 GFLOP over the tiles on or below the
// diagonal and 151 MB of q, k, v and out, so 0.139 ms at the 989 TFLOP/s
// bf16 tensor-core peak, 2.05 ms at the 67 TFLOP/s FP32 SIMT peak this
// kernel runs on, and 0.045 ms by bytes: operations bound it.  Design, simple
// first: one block of 256 threads owns one (bh, 64-row q tile) and loops over
// the 64-key tiles itself (the TPU's sequential kv grid axis), skipping tiles
// wholly above the diagonal.  Q, K and V tiles are staged in shared memory as
// f32 (16-byte loads, ragged T and S zero-filled and masked); each thread
// keeps a 4 x 4 tile of scores, the running max m and normalizer l of its
// 4 rows and a 4 x 4*NJ slice of the output accumulator in registers.  The
// score tile P goes back to shared memory, into K's buffer once QK^T has
// read it, for the P V product.  Products are FP32 FMAs and exponentials IEEE
// expf (built without fast math).  q tiles are launched heaviest first.
// wgmma, TMA and bf16 tensor cores are later work.
//
// Layouts: q, out (B*H, T, d); k, v (B*Hkv, S, d); row-major, contiguous,
// 16-byte aligned; f32 or bf16 (out in q's type); d a multiple of 8, <= 256.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: thread (ty, tx) owns rows ty + 16 i
constexpr int LDP = BK + 4;     // row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(f[0], f[1]),
                         __floats2bfloat162_rn(f[2], f[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// Rows [r0, r0 + 64) of a (rows, d) matrix into shared memory as f32 with
// row stride ld; rows past the end are zero.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ g, int r0, int rows,
                                      int d, float* s, int ld) {
  constexpr int VE = 16 / sizeof(T);
  const int vpr = d / VE;
  for (int idx = threadIdx.x; idx < BQ * vpr; idx += THREADS) {
    const int r = idx / vpr, c = (idx - r * vpr) * VE;
    float f[VE];
    if (r0 + r < rows) {
      load16(g + (size_t)(r0 + r) * d + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VE; e += 4) store4(s + r * ld + c + e, f + e);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NJ: 4-column chunks of the output per thread and row, d <= 64 * NJ.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, NJ <= 2 ? 2 : 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  int H, int Hkv, int Tq, int S, int d, float scale, int causal) {
  extern __shared__ float4 smem4[];
  const int ld = d + 4;                       // = 4 mod 8: float4 reads conflict-free
  const int kbuf = BK * (ld > LDP ? ld : LDP);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * ld;
  float* Ps = Ks;                             // P reuses K's buffer after QK^T
  float* Vs = Ks + kbuf;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest q tiles first
  const int kv_row = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const T* qg = q + (size_t)bh * Tq * d;
  const T* kg = k + (size_t)kv_row * S * d;
  const T* vg = v + (size_t)kv_row * S * d;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nch = d / 4;

  stage(qg, q0, Tq, d, Qs, ld);

  float o[4][NJ][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][jj][e] = 0.f;
  }

  // causal: tiles starting past the block's last query row are skipped
  const int kend = causal ? min(S, min(q0 + BQ, Tq)) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                 // the last tile's P and V are consumed
    stage(kg, k0, S, d, Ks, ld);
    stage(vg, k0, S, d, Vs, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < d; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ld + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax over this tile; masked scores contribute exactly 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && !(causal && kpos > qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][jj][e] *= alpha;
    }
    __syncthreads();                 // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

    for (int c = 0; c < BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int ch = tx + 16 * jj;
          if (ch < nch) {
            const float4 w = *reinterpret_cast<const float4*>(Vs + (c + cc) * ld + 4 * ch);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
              o[i][jj][0] = fmaf(pc, w.x, o[i][jj][0]);
              o[i][jj][1] = fmaf(pc, w.y, o[i][jj][1]);
              o[i][jj][2] = fmaf(pc, w.z, o[i][jj][2]);
              o[i][jj][3] = fmaf(pc, w.w, o[i][jj][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
    T* orow = out + ((size_t)bh * Tq + row) * d;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int ch = tx + 16 * jj;
      if (ch < nch) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = o[i][jj][e] / den;
        store4(orow + 4 * ch, f);
      }
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int H, int Hkv, int Tq, int S, int d, float scale, int causal,
           cudaStream_t stream) {
  const int ld = d + 4;
  const int kbuf = BK * (ld > LDP ? ld : LDP);
  const int smem = (BQ * ld + kbuf + BK * ld) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  flash_attn_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Hkv, Tq, S, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int BH,
             int H, int Hkv, int Tq, int S, int d, float scale, int causal,
             cudaStream_t stream) {
  switch ((d / 4 + 15) / 16) {
    case 1: return launch<T, 1>(q, k, v, out, BH, H, Hkv, Tq, S, d, scale, causal, stream);
    case 2: return launch<T, 2>(q, k, v, out, BH, H, Hkv, Tq, S, d, scale, causal, stream);
    case 3: return launch<T, 3>(q, k, v, out, BH, H, Hkv, Tq, S, d, scale, causal, stream);
    case 4: return launch<T, 4>(q, k, v, out, BH, H, Hkv, Tq, S, d, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int H, int Hkv, int Tq, int S,
                                 int d, float scale, int causal, int bf16,
                                 void* stream) {
  if (d <= 0 || d > 256 || d % 8 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 ||
      S <= 0 || (Tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B * H, H, Hkv, Tq, S, d, scale, causal, st);
  return dispatch<float>(q, k, v, out, B * H, H, Hkv, Tq, S, d, scale, causal, st);
}
