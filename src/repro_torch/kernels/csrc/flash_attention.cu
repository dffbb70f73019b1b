// Forward flash attention (online softmax, GQA, causal) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py
// `_flash_kernel`, launched by `flash_attention_pallas`.
//
// Function: q (BH, S, hd) with BH = batch * q_heads, k/v (BH / group, S, hd),
// S a multiple of 128 (the wrapper pads).  Program row b reads kv row
// b / group, so grouped-query attention never materialises repeated k/v.
// Keys at or beyond `valid_len` (the wrapper's zero padding) and, when
// causal, keys after the query position get a -1e30 score.  Softmax and the
// weighted sum are accumulated in float32; the output is cast to q's type.
//
// Design for the GPU rather than a copy of the TPU blocks: the TPU walked kv
// blocks as a sequential grid axis with the accumulators in VMEM scratch;
// here one thread block owns one (row b, 128-query tile) and loops over kv
// tiles itself, so the online-softmax state never leaves the SM.  Two
// threads share a query row: each keeps half of the row's q and of its
// float32 accumulator in registers (dimensions 2i and 2i+1), the two halves
// of every q.k dot product meet through one warp shuffle, and both threads
// then hold the same score, max and sum.  A 64-key tile of k and v is
// staged in shared memory as float32 (64 * hd * 8 bytes, 64 KB at hd=128);
// every thread reads each staged key as a broadcast, the two halves of a
// pair on neighbouring words, so the reads are free of bank conflicts.
// Scores go through registers 16 keys at a time, so the accumulator is
// rescaled once per 16 keys, not once per key.  For causal attention the
// kv loop stops at the diagonal of the query tile: tiles above it are
// never loaded.
//
// Bound on this card: at the main path's prefill shape (B=4, H=32, KV=8,
// S=512, hd=64, bf16) the least time is set by bytes: 21 MB of q, k, v and
// output take 6.3 us at 3.35 TB/s, the 4.3 GFLOP of causal QK^T and PV
// 4.3 us at the bf16 tensor-core rate; from S of about 1k the operations
// set it.  This first kernel is far from either: it does plain float32 FMA
// work out of shared memory (true float32 products, no TF32, which the
// float32 tests need at 2e-5) and does not use the tensor cores, so the
// FMA units and shared-memory reads limit it.  Moving the bf16 path onto
// mma/wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;          // query rows per block (two threads each)
constexpr int kBK = 64;           // keys per shared-memory tile
constexpr int kChunk = 16;        // keys per online-softmax update
constexpr int kThreads = 2 * kBQ;
constexpr float kNeg = -1e30f;

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s, int group,
                 int causal, int valid_len, float scale) {
  constexpr int kHalf = HD / 2;
  extern __shared__ float smem[];
  float* ks = smem;               // [kBK][HD]
  float* vs = smem + kBK * HD;    // [kBK][HD]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int row = tid >> 1;       // query row within the tile
  const int half = tid & 1;       // which interleaved half of hd
  const int qpos = q0 + row;

  const size_t qoff = ((size_t)b * s + qpos) * HD;
  const size_t kvoff = (size_t)(b / group) * s * HD;

  float qr[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    qr[i] = to_f32(q[qoff + 2 * i + half]);
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  int kv_end = causal ? min(s, q0 + kBQ) : s;
  kv_end = min(kv_end, valid_len);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();              // every thread is done with the last tile
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const size_t g = kvoff + (size_t)k0 * HD + e;
      ks[e] = to_f32(k[g]);
      vs[e] = to_f32(v[g]);
    }
    __syncthreads();

    for (int c0 = 0; c0 < kBK; c0 += kChunk) {
      float sc[kChunk];
      float cmax = kNeg;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (c0 + j) * HD + half;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kHalf; ++i) part = fmaf(qr[i], kr[2 * i], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        const int kpos = k0 + c0 + j;
        float sv = part * scale;
        if ((causal && kpos > qpos) || kpos >= valid_len) sv = kNeg;
        sc[j] = sv;
        cmax = fmaxf(cmax, sv);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        sc[j] = expf(sc[j] - m_new);
        psum += sc[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* vr = vs + (c0 + j) * HD + half;
        const float p = sc[j];
#pragma unroll
        for (int i = 0; i < kHalf; ++i) acc[i] = fmaf(p, vr[2 * i], acc[i]);
      }
      m = m_new;
    }
  }

  const float inv_l = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
    o[qoff + 2 * i + half] = from_f32<T>(acc[i] * inv_l);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int group, int causal, int valid_len, float scale,
           cudaStream_t st) {
  const int smem = 2 * kBK * HD * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(s / kBQ, bh);
  kern<<<grid, kThreads, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                     (T*)o, s, group, causal, valid_len,
                                     scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int bh,
                int s, int hd, int group, int causal, int valid_len,
                float scale, cudaStream_t st) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, o, bh, s, group, causal, valid_len, scale,
                          st);
    case 16:
      return launch<T, 16>(q, k, v, o, bh, s, group, causal, valid_len,
                           scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, bh, s, group, causal, valid_len,
                           scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, s, group, causal, valid_len,
                           scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, s, group, causal, valid_len,
                            scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s,
                                      int hd, int group, int causal,
                                      int valid_len, float scale, int dtype,
                                      void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (s % kBQ != 0 || group <= 0 || bh % group != 0 || valid_len <= 0 ||
      valid_len > s)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, bh, s, hd, group, causal,
                              valid_len, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, s, hd, group, causal,
                                      valid_len, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
