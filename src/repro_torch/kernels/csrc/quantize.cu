// Blockwise absmax int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/quantize/kernel.py
// `_quantize_kernel` (launched by `quantize_pallas`) and `_dequantize_kernel`
// (launched by `dequantize_pallas`).
//
// Function: x (M, N) float32 or bfloat16 is cut into (bm, bn) tiles, ragged
// at the bottom and right edges.  Each tile gets one float32 scale
//     scale = absmax(|x|) * f32(1/127)      (1 when the tile is all zero)
// and  q = clip(round_half_even(x * (1/scale)), -127, 127)  as int8.
// Dequantize is  x = (float(q) * scale) cast to the output type.  One kernel
// serves every tile shape: 256x256 for the blockwise API and (1, D) for the
// pipeline's rowwise int8 wire.
//
// Bit-equality with the plain version (kernels/quantize/ref.py) is the
// contract, so every rounding step is spelled out: the constant is
// (float)(1.0/127.0), the product is __fmul_rn (never contracted), the
// reciprocal is the IEEE __frcp_rn, and rounding is rintf (half to even),
// never roundf.  Build without --use_fast_math.
//
// Bound on this card: bytes.  Quantize reads each input element once for
// the absmax and once more for the rounding pass (the second read of a tile
// hits L2: a 256x256 f32 tile is 256 KB, a (1, 2048) wire row 8 KB) and
// writes one byte per element; dequantize reads one byte and writes one
// element.  The design gives one thread block per tile so the absmax is a
// block reduction (warp shuffles, then one word per warp in shared memory)
// with no second launch and no atomics; threads walk the tile row by row
// with neighbouring threads on neighbouring columns, so every pass is
// coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInv127 = (float)(1.0 / 127.0);

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int m, int n, int bm, int bn,
                int gn) {
  __shared__ float red[kThreads / 32];
  const int ti = blockIdx.x / gn, tj = blockIdx.x % gn;
  const int r0 = ti * bm, c0 = tj * bn;
  const int rows = min(bm, m - r0), cols = min(bn, n - c0);

  // pad elements of a ragged tile are zeros in the plain version; |0| never
  // raises the absmax, so skipping them is the same function
  float amax = 0.f;
  for (int r = 0; r < rows; ++r) {
    const T* row = x + (size_t)(r0 + r) * n + c0;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      amax = fmaxf(amax, fabsf(to_f32(row[c])));
  }
  amax = block_max(amax, red);
  const float scale = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  const float inv = __frcp_rn(scale);

  for (int r = 0; r < rows; ++r) {
    const size_t base = (size_t)(r0 + r) * n + c0;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      float v = rintf(__fmul_rn(to_f32(x[base + c]), inv));
      v = fminf(fmaxf(v, -127.f), 127.f);
      q[base + c] = (int8_t)v;
    }
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ x, int m,
                  int n, int bm, int bn, int gn) {
  const int ti = blockIdx.x / gn, tj = blockIdx.x % gn;
  const int r0 = ti * bm, c0 = tj * bn;
  const int rows = min(bm, m - r0), cols = min(bn, n - c0);
  const float scale = scales[blockIdx.x];
  for (int r = 0; r < rows; ++r) {
    const size_t base = (size_t)(r0 + r) * n + c0;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      x[base + c] = from_f32<T>(__fmul_rn((float)q[base + c], scale));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int quantize_launch(const void* x, void* q, void* scales, int m,
                               int n, int bm, int bn, int dtype,
                               void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bm <= 0 || bn <= 0) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm, gn = (n + bn - 1) / bn;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    quantize_kernel<float><<<gm * gn, kThreads, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)scales, m, n, bm, bn, gn);
  else if (dtype == 1)
    quantize_kernel<__nv_bfloat16><<<gm * gn, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scales, m, n, bm, bn,
        gn);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int dequantize_launch(const void* q, const void* scales, void* x,
                                 int m, int n, int bm, int bn, int dtype,
                                 void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bm <= 0 || bn <= 0) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm, gn = (n + bn - 1) / bn;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    dequantize_kernel<float><<<gm * gn, kThreads, 0, st>>>(
        (const int8_t*)q, (const float*)scales, (float*)x, m, n, bm, bn, gn);
  else if (dtype == 1)
    dequantize_kernel<__nv_bfloat16><<<gm * gn, kThreads, 0, st>>>(
        (const int8_t*)q, (const float*)scales, (__nv_bfloat16*)x, m, n, bm,
        bn, gn);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* quantize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
