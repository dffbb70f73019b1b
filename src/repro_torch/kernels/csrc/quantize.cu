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
// Dequantize is  x = (float(q) * scale) cast to the output type.  Any tile
// shape is served: 256x256 for the blockwise API and (1, D) for the
// pipeline's rowwise int8 wire.
//
// Bit-equality with the plain version (kernels/quantize/ref.py) is the
// contract, so every rounding step is spelled out: the constant is
// (float)(1.0/127.0), the product is __fmul_rn (never contracted), the
// reciprocal is the IEEE __frcp_rn, and rounding is rintf (half to even),
// never roundf.  The absmax is order-independent, so any reduction order
// gives the same scale.  Build without --use_fast_math.
//
// Bound on this card: bytes, each input element read once and one byte
// written for it (dequantize: one byte read, one element written).  At the
// wire's shape (2048 rows of 2048 bf16) that is 12.6 MB, 3.8 us at 3.35
// TB/s.  Two paths:
//   * Rowwise (`quantize_rows_kernel`), for a tile one row tall and as wide
//     as the row, the wire's (1, D), when the row is a whole number of
//     8-element units of at most 4096 elements on a 16-byte boundary: one
//     warp a row, four rows a block.  A lane loads its units with 16-byte
//     loads and keeps them in registers, so each element is read from
//     device memory once; the absmax is five xor-shuffles, with no shared
//     memory and no barrier; each unit's 8 int8 go out as one 8-byte store.
//   * General (`quantize_kernel`), every other tile: one block a tile, the
//     absmax a block reduction (warp shuffles, then one word per warp in
//     shared memory), then a second pass over the tile (which hits L2)
//     that rounds; neighbouring threads on neighbouring columns.
// Dequantize has one path, one block a tile.

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

// ---------------------------------------------------------------------------
// rowwise: one warp a row, the row held in registers
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 4;      // rows a block

// 8 consecutive elements of T: one 16-byte load for bf16, two for float32
template <typename T>
struct Unit {
  static constexpr int W = sizeof(T) / 2;   // 16-byte words
  uint4 w[W];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ float at(int e) const {
    return to_f32(reinterpret_cast<const T*>(w)[e]);
  }
};

template <typename T, int UPL>
__global__ void __launch_bounds__(32 * kRowWarps)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, int m, int n) {
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;           // the whole warp leaves together
  const int units = n / 8;
  const T* xr = x + (size_t)row * n;
  Unit<T> u[UPL];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < UPL; ++k) {
    const int idx = k * 32 + lane;  // neighbouring lanes, neighbouring units
    if (idx < units) {
      u[k].load(xr + idx * 8);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(u[k].at(e)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  const float inv = __frcp_rn(scale);
  int8_t* qr = q + (size_t)row * n;
#pragma unroll
  for (int k = 0; k < UPL; ++k) {
    const int idx = k * 32 + lane;
    if (idx < units) {
      uint2 out;
      int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = rintf(__fmul_rn(u[k].at(e), inv));
        o[e] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
      }
      *reinterpret_cast<uint2*>(qr + idx * 8) = out;
    }
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T, int UPL>
int launch_rows(const void* x, void* q, void* scales, int m, int n,
                cudaStream_t st) {
  quantize_rows_kernel<T, UPL>
      <<<(m + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, st>>>(
          (const T*)x, (int8_t*)q, (float*)scales, m, n);
  return (int)cudaGetLastError();
}

// units a lane: the least power of two that covers the row
template <typename T>
int dispatch_rows(const void* x, void* q, void* scales, int m, int n,
                  cudaStream_t st) {
  const int per_lane = (n / 8 + 31) / 32;
  if (per_lane <= 1) return launch_rows<T, 1>(x, q, scales, m, n, st);
  if (per_lane <= 2) return launch_rows<T, 2>(x, q, scales, m, n, st);
  if (per_lane <= 4) return launch_rows<T, 4>(x, q, scales, m, n, st);
  if (per_lane <= 8) return launch_rows<T, 8>(x, q, scales, m, n, st);
  return launch_rows<T, 16>(x, q, scales, m, n, st);
}

}  // namespace

// The rowwise path: x (m, n) contiguous, n a multiple of 8 and at most
// 4096, x 16-byte aligned; scales (m,).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int quantize_rows_launch(const void* x, void* q, void* scales,
                                    int m, int n, int dtype, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0 || n % 8 || n > 4096) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_rows<float>(x, q, scales, m, n, st);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(x, q, scales, m, n, st);
  return (int)cudaErrorInvalidValue;
}

// The general path, any tile.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
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
