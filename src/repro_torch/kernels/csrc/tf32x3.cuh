// 3xTF32: f32-accurate products on Hopper's TF32 tensor cores.
//
// Shared by csrc/m2l.cu and csrc/flash_attn_tf32.cu.  An f32 x splits into
// two TF32 values, hi = rna(x) (round to nearest, ties away from zero, 10
// mantissa bits, what cvt.rna.tf32.f32 gives) and lo = x - hi, which is
// exact in f32.  A product a*b then runs as three TF32 products with f32
// accumulation, a_lo*b_hi + a_hi*b_lo + a_hi*b_hi; the a_lo*b_lo term is
// below f32's rounding and is dropped.  No single-pass TF32 product is used.
//
// The split costs three full-rate instructions: an integer add of half a
// TF32 ulp to the bits and a mask give hi with its low 13 bits zero, so the
// tensor core reads hi exactly whatever it does with low bits; an f32
// subtraction gives lo.  lo goes to the tensor core with its low bits set:
// the core ignores them (it truncates; tf32_probe shows it on the card), so
// lo enters rounded toward zero to 10 bits, an error below 2^-21 |x|.  The
// CPU model of this arithmetic is kernels/tf32.py.  Valid for finite
// |x| < 2^128 (1 - 2^-12): above that hi would round to infinity.
//
// csrc/flash_attn_tf32.cu uses only split(): its products are wgmma, with
// hi and lo tiles in shared memory.  M2L's products use the warp-level
// mma.sync.m16n8k8 TF32 instruction below, whose A and B fragments come
// from registers: the kernel loads them from shared memory at its shifted
// windows and splits them in registers (the operator, reused by every
// block, comes split once).  The core's f32 accumulation truncates, so the
// error grows with the passes summed in one accumulator: both kernels sum
// a few k-steps in a zeroed accumulator and add it to f32 registers.
// Fragment layout, for g = lane / 4, t = lane % 4:
//   A (16 x 8, row-major):  a0 = A[g][t],   a1 = A[g+8][t],
//                           a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, "col"):       b0 = B[t][g],   b1 = B[t+4][g]
//   C (16 x 8, f32):        c0 = C[g][2t],  c1 = C[g][2t+1],
//                           c2 = C[g+8][2t], c3 = C[g+8][2t+1]
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr uint32_t HALF_ULP = 0x1000u;   // half a TF32 ulp in f32 bits
constexpr uint32_t MASK = 0xffffe000u;   // sign, exponent, 10 mantissa bits

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = (__float_as_uint(x) + HALF_ULP) & MASK;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// d (16 x 8, f32) += A (16 x 8, TF32) * B (8 x 8, TF32): one tensor-core pass.
// Not volatile: it has no side effects, so the compiler may interleave
// independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment, split: hi and lo halves of four f32 values.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(a[i]);
    f.hi[i] = s.hi;
    f.lo[i] = s.lo;
  }
  return f;
}

// d[n] += A * B[n] for N n-tiles in three TF32 passes each, the small
// terms first; a pass runs over all N accumulators before the next, so
// consecutive products are independent and the tensor core's latency
// overlaps.  n-tiles at or past `count` are skipped.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const FragA& a,
                                     const Split (&b0)[N], const Split (&b1)[N],
                                     int count = N) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < count) mma(d[n], a.lo, b0[n].hi, b1[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < count) mma(d[n], a.hi, b0[n].lo, b1[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < count) mma(d[n], a.hi, b0[n].hi, b1[n].hi);
}

// What one TF32 pass makes of each x[i] (times 1): out[i] = D[0][0] of an
// mma with A[0][0] = x[i] and B[0][0] = 1, every other element 0.  One warp.
__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                             int n) {
  const int lane = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t a[4] = {lane == 0 ? __float_as_uint(x[i]) : 0u, 0u, 0u, 0u};
    mma(d, a, lane == 0 ? __float_as_uint(1.f) : 0u, 0u);
    if (lane == 0) out[i] = d[0];
  }
}

}  // namespace tf32x3
