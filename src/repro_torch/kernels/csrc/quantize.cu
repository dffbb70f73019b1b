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
// reciprocal is the IEEE __frcp_rn, and rounding is half to even (rintf,
// never roundf; the row path rounds by the adder, below).  The bf16 output
// of dequantize is rounded to nearest even (the packing conversion of
// elem.cuh gives the bits of __float2bfloat16_rn).  The absmax is
// order-independent, so any reduction order gives the same scale.  Build
// without --use_fast_math.
//
// Bound on this card: bytes, each input element read once and one byte
// written for it (dequantize: one byte read, one element written).  At the
// wire's prefill rows, 2048 of 7168 bf16, that is 44 MB, 13.1 us at 3.35
// TB/s.  What else costs: a launch's fixed time (the first loads' latency,
// the last wave's drain), a few us that matter at these sizes; and
// instruction slots, which the row path's rounding spares (no conversion).
// The paths:
//   * Quantize, row path (`quantize_rows_kernel`), for a tile one row tall
//     and as wide as the row (the wire's (1, D)) when the row is a whole
//     number of 8-element units on a 16-byte boundary, up to 16384
//     elements (kernels/quantize/ops.py::rowwise_path).  The row is read
//     from device memory once and held in registers: a lane owns pairs of
//     adjacent units (16 elements: 32 bytes of bf16, 64 of float32)
//     round-robin, neighbouring lanes on neighbouring pairs, and a row
//     takes as many warps as hold it at 128 bytes of x a lane (one warp to
//     2048 bf16, two to 4096, four to 8192, eight at 16384; float32 rows
//     past 8192 hold more, up to kRowPairs pairs a lane at 16384), so that
//     nothing spills; the plan (warps a row, pairs a lane, rows a block)
//     comes from N and the element size alone (ops.py::row_plan), so a
//     row's bits do not depend on M.  A lane first starts every load of
//     its pairs, all in flight together, then reduces: a bf16 pair-wise
//     max on the packed values (exact, and like fmaxf it passes over a
//     NaN), xor-shuffles in the warp, and where a row has several warps
//     one word a warp in shared memory and one barrier, after which every
//     warp reads the combined absmax.  Each pair's 16 int8 leave in one
//     16-byte store (two 8-byte ones where the row of q is not on a
//     16-byte boundary; one 8-byte store for a last lone unit).  Rounding
//     costs no conversion instruction: p + 1.5 * 2^23 rounds p = x * inv
//     to an integer, half to even, in the mantissa's low bits (exact for
//     |p| <= 2^22, and |p| <= 127.00001 here); the clip is on that sum, and
//     the int8 is its low byte.  This gives rintf's and the clip's int8
//     for every input, inf and NaN included (NaN gives -127 either way).
//   * Quantize, general path (`quantize_kernel`), every other tile (the
//     blockwise (256, 256) API, ragged or misaligned tiles, rows past
//     16384): one block a tile, the absmax a block reduction (warp
//     shuffles, then one word per warp in shared memory), then a second
//     pass over the tile (which hits L2) that rounds; neighbouring threads
//     on neighbouring columns.
//   * Dequantize, vectorised (`dequantize_vec_kernel`), where a unit of as
//     many int8 as fill one 16-byte store of the output (8 for bf16, 4 for
//     float32) lies in one row and one tile and q starts on such a
//     boundary (ops.py::dequantize_vectorised: the wire's (1, D), the
//     blockwise (256, 256)): a thread takes two units of the flat (M, N),
//     starts both loads first and finds each unit's scale once; each unit
//     leaves in one 16-byte store, so a warp's loads and its stores each
//     cover adjacent bytes (units of 16 int8, written as two stores 32
//     bytes apart, leave every other 16 bytes of a warp's store).
//   * Dequantize, scalar (`dequantize_kernel`), every other width: one
//     block a tile, one element a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kInv127 = (float)(1.0 / 127.0);

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
      amax = fmaxf(amax, fabsf(to_f<T>(row[c])));
  }
  amax = block_max(amax, red);
  const float scale = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  const float inv = __frcp_rn(scale);

  for (int r = 0; r < rows; ++r) {
    const size_t base = (size_t)(r0 + r) * n + c0;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      float v = rintf(__fmul_rn(to_f<T>(x[base + c]), inv));
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
      x[base + c] = from_f<T>(__fmul_rn((float)q[base + c], scale));
  }
}

// ---------------------------------------------------------------------------
// quantize, row path: a row held in registers, read once
// ---------------------------------------------------------------------------

constexpr int kRowPairs = 4;        // pairs a lane at most (ops.py ROW_PAIRS)
constexpr int kRowThreads = 256;    // threads a block at most
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

// 16 consecutive elements of a row, a lane's pair of 8-element units, as
// loaded: W 16-byte words
template <typename T>
struct Pair {
  static constexpr int W = sizeof(T);   // bf16 2, float32 4
  uint4 w[W];
};

template <typename T>
__device__ __forceinline__ void unpack_pair(const Pair<T>& p, float* f) {
#pragma unroll
  for (int i = 0; i < Pair<T>::W; ++i) unpack<T>(p.w[i], f + i * Unit<T>::n);
}

// The largest |element| of a pair: bf16 pairs of values compared as they
// are (a bf16 max is exact, and like fmaxf it passes over a NaN)
template <typename T>
__device__ __forceinline__ float pair_absmax(const Pair<T>& p) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __nv_bfloat162 m = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int i = 0; i < Pair<T>::W; ++i) {
      const unsigned w[4] = {p.w[i].x, p.w[i].y, p.w[i].z, p.w[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m = __hmax2(m, __habs2(*reinterpret_cast<const __nv_bfloat162*>(
                               &w[j])));
    }
    return fmaxf(__low2float(m), __high2float(m));
  } else {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < Pair<T>::W; ++i)
      m = fmaxf(fmaxf(fmaxf(m, fabsf(__uint_as_float(p.w[i].x))),
                      fmaxf(fabsf(__uint_as_float(p.w[i].y)),
                            fabsf(__uint_as_float(p.w[i].z)))),
                fabsf(__uint_as_float(p.w[i].w)));
    return m;
  }
}

// Four values quantized, their int8 packed in one word: the adder rounds
// (p + 1.5 * 2^23 holds rint(p) in its low mantissa bits), the clip keeps
// the sum within 127 of 1.5 * 2^23, and each sum's low byte is its int8.
__device__ __forceinline__ unsigned quantize4(const float* f, float inv) {
  unsigned b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float t = __fadd_rn(__fmul_rn(f[e], inv), kRound);
    b[e] = __float_as_uint(fminf(fmaxf(t, kRound - 127.f), kRound + 127.f));
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// P pairs a lane; a row of n elements (a multiple of 8) on `warps` warps,
// blockDim.x / (32 warps) rows a block.
template <typename T, int P>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, int m, int n, int warps) {
  __shared__ float part[kRowThreads / 32];
  const int tpr = warps * 32;                   // threads a row
  const int lr = threadIdx.x / tpr;             // the row in the block
  const int t = threadIdx.x - lr * tpr;         // the thread in the row
  const int row = blockIdx.x * (blockDim.x / tpr) + lr;
  const bool live = row < m;
  const int units = n >> 3, pairs = (units + 1) >> 1;

  // every load first, all in flight together; a lone last unit loads half
  // its pair and leaves zeros, which never raise the absmax
  Pair<T> v[P];
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * n);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = t + k * tpr;
    const int words = !live || p >= pairs ? 0
                      : 2 * p + 1 < units ? Pair<T>::W : Pair<T>::W / 2;
#pragma unroll
    for (int i = 0; i < Pair<T>::W; ++i)
      v[k].w[i] = i < words ? __ldg(xr + p * Pair<T>::W + i)
                            : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) amax = fmaxf(amax, pair_absmax<T>(v[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (warps > 1) {                    // the same for every thread a block
    if ((t & 31) == 0) part[threadIdx.x >> 5] = amax;
    __syncthreads();
    const float* pr = part + lr * warps;
    amax = pr[0];
    for (int i = 1; i < warps; ++i) amax = fmaxf(amax, pr[i]);
  }
  if (!live) return;
  const float scale = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  const float inv = __frcp_rn(scale);

  int8_t* qr = q + (size_t)row * n;
  const bool wide = (n & 15) == 0;    // q's rows on 16-byte boundaries
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = t + k * tpr;
    if (p >= pairs) break;
    float f[16];
    unpack_pair<T>(v[k], f);
    const uint4 o = make_uint4(quantize4(f, inv), quantize4(f + 4, inv),
                               quantize4(f + 8, inv), quantize4(f + 12, inv));
    int8_t* dst = qr + 16 * p;
    if (2 * p + 1 >= units) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(o.x, o.y);
    } else if (wide) {
      *reinterpret_cast<uint4*>(dst) = o;
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(o.x, o.y);
      *reinterpret_cast<uint2*>(dst + 8) = make_uint2(o.z, o.w);
    }
  }
  if (t == 0) scales[row] = scale;
}

// the instance for `ppl` pairs a lane, 1 to kRowPairs
template <typename T, int P = 1>
int launch_rows(const void* x, void* q, void* scales, int m, int n,
                int warps, int ppl, int rows, cudaStream_t st) {
  if constexpr (P > kRowPairs) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (ppl != P)
      return launch_rows<T, P + 1>(x, q, scales, m, n, warps, ppl, rows, st);
    quantize_rows_kernel<T, P><<<(m + rows - 1) / rows, 32 * warps * rows, 0,
                                 st>>>((const T*)x, (int8_t*)q,
                                       (float*)scales, m, n, warps);
    return (int)cudaGetLastError();
  }
}

// ---------------------------------------------------------------------------
// dequantize, vectorised: units of as many int8 as fill one 16-byte store of
// the output (8 for bf16, 4 for float32), kDqUnits units a thread
// ---------------------------------------------------------------------------

constexpr int kDqUnits = 2;

template <int V>
struct Bytes;                       // V int8 as one load
template <>
struct Bytes<4> { using type = unsigned; };
template <>
struct Bytes<8> { using type = uint2; };

__device__ __forceinline__ unsigned word(unsigned v, int) { return v; }
__device__ __forceinline__ unsigned word(const uint2& v, int j) {
  return j == 0 ? v.x : v.y;
}

// `units` units of the flat (M, N), `upr` a row; unit i of thread j of
// block b is b U T + i T + j, so each load and each store instruction of a
// warp covers adjacent bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_vec_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales, T* __restrict__ x,
                      int units, int upr, int bm, int bn, int gn) {
  constexpr int V = Unit<T>::n, U = kDqUnits;
  using In = typename Bytes<V>::type;
  const int base = blockIdx.x * (U * kThreads) + threadIdx.x;
  In raw[U];
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * kThreads;
    if (i < units) {
      raw[u] = __ldg(reinterpret_cast<const In*>(q) + i);
      const int r = i / upr, c = (i - r * upr) * V;
      s[u] = __ldg(scales + (r / bm) * gn + c / bn);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * kThreads;
    if (i >= units) break;
    float f[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      f[e] = __fmul_rn((float)(int8_t)(word(raw[u], e >> 2) >> (8 * (e & 3))),
                       s[u]);
    reinterpret_cast<uint4*>(x)[i] = pack<T>(f);
  }
}

template <typename T>
int launch_dq(const void* q, const void* scales, void* x, int m, int n,
              int bm, int bn, int vec, cudaStream_t st) {
  const int gm = (m + bm - 1) / bm, gn = (n + bn - 1) / bn;
  if (!vec) {
    dequantize_kernel<T><<<gm * gn, kThreads, 0, st>>>(
        (const int8_t*)q, (const float*)scales, (T*)x, m, n, bm, bn, gn);
    return (int)cudaGetLastError();
  }
  // a unit lies in one row and one tile, its load and store aligned
  constexpr int V = Unit<T>::n, per = kDqUnits * kThreads;
  if (n % V || (bn % V && bn < n) || (uintptr_t)q % V || (uintptr_t)x % 16
      || (long long)m * n / V > 0x7fffffffLL - per)
    return (int)cudaErrorInvalidValue;
  const int units = (int)((long long)m * n / V), upr = n / V;
  dequantize_vec_kernel<T><<<(units + per - 1) / per, kThreads, 0, st>>>(
      (const int8_t*)q, (const float*)scales, (T*)x, units, upr, bm, bn, gn);
  return (int)cudaGetLastError();
}

}  // namespace

// The row path: x (m, n) contiguous, n a multiple of 8, x on a 16-byte
// boundary; scales (m,).  The plan (ops.py::row_plan): `warps` warps a row,
// `ppl` pairs of 8-element units a lane (enough for the row, at most
// kRowPairs), `rows` rows a block.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int quantize_rows_launch(const void* x, void* q, void* scales,
                                    int m, int n, int warps, int ppl,
                                    int rows, int dtype, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0 || n % 8 || warps < 1 || rows < 1 || ppl < 1
      || ppl > kRowPairs || 32 * warps * rows > kRowThreads
      || (uintptr_t)x % 16 || 32LL * warps * ppl < (n / 8 + 1) / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rows<float>(x, q, scales, m, n, warps, ppl, rows, st);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(x, q, scales, m, n, warps, ppl, rows,
                                      st);
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

// Dequantize, any tile.  `vec` (ops.py::dequantize_vectorised): nonzero for
// the vectorised kernel, which refuses a tile it cannot serve; 0 for the
// scalar one.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int dequantize_launch(const void* q, const void* scales, void* x,
                                 int m, int n, int bm, int bn, int vec,
                                 int dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bm <= 0 || bn <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dq<float>(q, scales, x, m, n, bm, bn, vec, st);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, scales, x, m, n, bm, bn, vec, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* quantize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
