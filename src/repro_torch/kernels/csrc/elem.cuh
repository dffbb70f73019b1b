// Element helpers of the port's element-wise kernels (silu.cu, norm.cu): a
// 16-byte unit of float or bf16 values as floats and back, rounding to the
// element type, and a 16-byte copy from global to shared memory.
//
// bf16 values are rounded in pairs through one packing conversion
// (__floats2bfloat162_rn, F2FP.BF16.F32.PACK_AB), which issues at the ALU's
// rate; a single conversion (__float2bfloat16_rn, F2F.BF16.F32) issues at a
// quarter of it, and with a handful a element those conversions bound the
// kernels.  Both round to nearest even and give a NaN the same bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

template <typename T>
struct Unit;                      // elements a 16-byte unit
template <>
struct Unit<float> { static constexpr int n = 4; };
template <>
struct Unit<__nv_bfloat16> { static constexpr int n = 8; };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two bf16 values packed in a word as floats: one shift, one mask.
__device__ __forceinline__ void unpack2(unsigned w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&p);
}

// N values held as floats, rounded to T in place.
template <typename T, int N>
__device__ __forceinline__ void round_n(float* v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if constexpr (N % 2 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 2) unpack2(pack2(v[i], v[i + 1]), v + i);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = __bfloat162float(__float2bfloat16_rn(v[i]));
    }
  }
}

// A 16-byte unit as its V floats, and V floats rounded into one.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  } else {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    u = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                   pack2(f[6], f[7]));
  } else {
    u = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                   __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  return u;
}

// 16 bytes from global to shared memory (cached in L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
