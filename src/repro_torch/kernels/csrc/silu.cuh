// The reference's SiLU for Hopper (sm_90a), one device function shared by
// the kernels that apply it: the standalone silu and the mamba block's conv
// pass (silu.cu), and the gated norm (norm.cu).
//
// y = x * r(1 / r(1 + r(exp(-x)))), r the rounding to x's type after every
// op, as XLA on the CPU computes the reference's `jax.nn.silu` (each bf16
// op evaluated in float32 and its result rounded), and as the plain version
// (kernels/silu/ref.py) spells it in four torch ops: torch's exp is expf,
// its reciprocal the IEEE 1 / d.
//
// bf16, the main path's type: exp stays expf (eight instructions, its bits
// are the plain version's), and the IEEE division, a dozen instructions
// and a branch to a slow path, becomes one rcp.approx.  That keeps the
// bits: d = r(1 + e) >= 1 is a bf16 value, m 2^k with one of 128
// mantissas m, and rn(1 / d) = rn(1 / m) 2^-k while 1 / d is normal.  Each
// rn(1 / m) lies at least 129 float32 bit patterns away from a bf16
// rounding midpoint (a lower half of 0x8000; checked over all 128
// mantissas, tests/test_torch_silu.py), and rcp.approx is within one ulp
// of the true reciprocal, so both round to the same bf16.  Only d >= 2^126
// (x < -87.3, or a NaN), where 1 / d leaves the normal range that
// rcp.approx flushes to zero, takes the plain chain op for op.
// tests/test_torch_cuda.py holds the result over all 65536 bf16 inputs.
// float32 keeps the plain chain: there no approximation rounds the same.
//
// silu_n<T, N> takes N values at a time (a 16-byte unit of the caller) and
// branches once for all of them, so the common path has no branch.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "elem.cuh"

namespace silu_detail {

__device__ __forceinline__ float rb(float v) {   // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int N>
struct Vals { float v[N]; };

// The plain version's bf16 chain, op for op, on N values: the rare
// fallback, one call a unit, out of line so that the common path stays
// short.
template <int N>
__device__ __noinline__ Vals<N> silu_bf16_exact(Vals<N> x) {
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    const float e = rb(expf(-x.v[i]));
    const float d = rb(1.0f + e);
    const float s = rb(1.0f / d);
    x.v[i] = rb(x.v[i] * s);
  }
  return x;
}

__device__ __forceinline__ float silu_f32(float x) {
  return x * (1.0f / (1.0f + expf(-x)));
}

// N bf16 values held as floats, in place; roundings in pairs (elem.cuh).
// kRound false leaves the last product unrounded, for a caller that
// packs the values to bf16 next (the pack rounds them the same).
template <int N, bool kRound>
__device__ __forceinline__ void silu_bf16_n(float* v) {
  using B = __nv_bfloat16;
  float e[N], r[N];
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = expf(-v[i]);
  round_n<B, N>(e);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = __fadd_rn(1.0f, e[i]);      // d
  round_n<B, N>(e);
  bool exact = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r[i]) : "f"(e[i]));
    exact |= !(e[i] < 0x1p126f);
  }
  round_n<B, N>(r);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = __fmul_rn(v[i], r[i]);
  if constexpr (kRound) round_n<B, N>(r);
  if (exact) {
    Vals<N> x;
#pragma unroll
    for (int i = 0; i < N; ++i) x.v[i] = v[i];
    x = silu_bf16_exact<N>(x);
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = x.v[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = r[i];
}

}  // namespace silu_detail

// SiLU of N values of type T held as floats, in place: float32 the plain
// chain, bf16 silu_bf16_n (kRound as there).
template <typename T, int N, bool kRound = true>
__device__ __forceinline__ void silu_n(float* v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    silu_detail::silu_bf16_n<N, kRound>(v);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = silu_detail::silu_f32(v[i]);
  }
}
