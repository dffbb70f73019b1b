// Tensor-core building blocks shared by the port's bf16 kernels
// (flash_attention.cu, ssd.cu, ssd_bwd.cu): 16-byte `cp.async`, `ldmatrix`,
// the m16n8k16 bf16 `mma.sync` with float32 accumulators, `ex2`, the split
// of float32 operands into bf16 hi + lo, and the XOR swizzle that keeps
// `ldmatrix` free of bank conflicts.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + tq):
//   A (16 x 16, row-major): {a0, a1} row g,     k 2tq, 2tq+1
//                           {a2, a3} row g + 8, k 2tq, 2tq+1
//                           {a4..a7} the same rows at k + 8;
//   B (16 x 8, col-major):  {b0, b1} k 2tq, 2tq+1 of column g; {b2, b3}
//                           the same at k + 8;
//   C (16 x 8, float32):    c0, c1 row g, columns 2tq, 2tq+1; c2, c3 the
//                           same columns of row g + 8.
// `ldmatrix.x4` gives lane l the pair (row l / 4, columns 2 (l % 4) + {0, 1})
// of each of four 8 x 8 matrices whose row addresses lanes 8i..8i+7 supply;
// `.trans` gives the transposed pair, (rows 2 (l % 4) + {0, 1}, column l / 4).
// So a tile stored with the k index along its rows feeds an A or B operand
// through `.trans`, and one stored with k along its columns feeds it without.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; zero-fills when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

// c (16x8 float32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, the MUFU approximation (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi and lo with a = hi + lo to 2^-16 relative: lo is
// the bf16 of the exact remainder
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// Index of 16-byte chunk c of row r in a tile with CPR chunks a row.  The
// chunk is XORed with bits of the row so that the eight rows one
// `ldmatrix` reads in a column of chunks land on eight distinct 16-byte
// bank groups: rows of 128 bytes or more use r & 7; shorter rows, several
// to a 128-byte line, use the bits above the line's rows.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CPR >= 8) return r * CPR + (c ^ (r & 7));
  else if constexpr (CPR == 4) return r * 4 + (c ^ ((r >> 1) & 3));
  else return r * 2 + (c ^ ((r >> 2) & 1));
}

}  // namespace sm90
