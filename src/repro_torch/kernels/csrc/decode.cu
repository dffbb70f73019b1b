// Row-invariant decode kernels for Hopper (sm_90a).
//
// A decode step of the port's models is a handful of products and
// reductions over one token per sequence.  The library calls it used before
// (cuBLAS GEMMs, torch's row reductions, a masked softmax over the kv
// bucket) pick their algorithm, and so the order of each sum, from the
// number of rows and from the padded length: a request served in a batch
// of four then rounded differently from the same request served alone.
// Here every output of row r is computed by the same sequence of float32
// operations whatever the other rows are, how many there are, and how far
// the cache is padded:
//
//   * rows_matmul      out (M, N) = x (M, K) @ w, w (K, N) row-major or the
//                      transposed view of an (N, K) matrix (a tied head's
//                      embed.T).  Replaces cuBLAS on a decode step's
//                      projections and LM head.
//   * rms_norm_rows    y = x * rsqrt(mean(x^2) + eps) * w, per row.
//   * decode_attention one query token per sequence against keys
//                      [0, kv_len[b]) of its cache, in fixed 64-key chunks
//                      with an online softmax.
//   * ssm_decode_step  the Mamba2 recurrence for one token: state <- state *
//                      exp(dt A) + dt B x, y = C . state.
//
// No TPU kernel of the reference does this: the JAX package leaves these
// products to XLA.  The plain PyTorch versions are in kernels/decode/ref.py.
//
// Invariance.  Each product is an explicit fmaf chain in a fixed order; a
// sum across threads is a fixed xor-shuffle tree, then (across warps) a
// fixed sequential sum through shared memory.  Nothing depends on M: rows
// are handled in chunks of 16 by gridDim.y, and a smaller template MT only
// drops the accumulators of rows that do not exist.  No split-K across
// blocks, no atomics.  Build without --use_fast_math (no contraction or
// reassociation beyond the explicit fmaf).
//
// Bound on this card: bytes.  M <= 16 rows against a weight of K x N is
// 2 M FLOP per weight element, far below the 295 FLOP a byte where the
// tensor cores would bind; every kernel here is a single pass over its
// weight, cache or state.  The design is the simple one: 16-byte loads of
// the weight along its contiguous dimension, each thread eight rows of the
// weight in flight (rows_matmul), and enough blocks for the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // rows_matmul, rms_norm_rows
constexpr int kAttnThreads = 128;
constexpr int kChunk = 64;        // keys a decode-attention chunk
constexpr int kMaxGroup = 16;     // q heads a kv head
constexpr int kMaxHd = 128;
constexpr int kRowsPerBlock = 16; // rows_matmul: rows of x per gridDim.y

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

// VEC consecutive elements of a row as floats: one 16-byte load.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out);
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* out) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p,
                                                   float* out) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> { static constexpr int n = 8; };
template <>
struct Vec<float> { static constexpr int n = 4; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// rows_matmul, w (K, N) with N contiguous
//
// A block owns 4 * VEC columns (32 in bf16), so that a (2048, 8192)
// weight gives 256 blocks, two an SM.  Lane l of warp w reads the column
// group l % 4 (VEC columns, 16 bytes) of weight rows k = 8 j + u,
// j = 8 w + l / 4 (mod 64), u = 0..7: eight 16-byte loads in flight a
// thread, eight 64-byte row segments a warp.  Each thread keeps MT x VEC
// float32 sums, every one an fmaf chain over its rows in increasing k.
// The 64 k-lanes are then summed by three xor-shuffles (lanes l, l^4,
// l^8, ..., l^28) and eight warps in order through shared memory.  ALIGNED: N is a
// multiple of VEC and the base is 16-byte aligned, so a column group is
// one vector; otherwise (an odd vocabulary) each element is loaded alone
// and the ragged tail is guarded.
// ---------------------------------------------------------------------------

constexpr int kKU = 8;            // weight rows a thread has in flight
constexpr int kColGroups = 4;     // 16-byte column groups a block

template <typename T, int MT, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
rows_matmul_kn_kernel(const T* __restrict__ x, long long xs,
                      const T* __restrict__ w, long long wsk,
                      T* __restrict__ out, long long os, int m, int k,
                      int n) {
  constexpr int VEC = Vec<T>::n;
  constexpr int COLS = kColGroups * VEC;
  constexpr int KLANES = kThreads / kColGroups;
  __shared__ float red[kThreads / 32][MT][COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane % kColGroups;
  const int klane = threadIdx.x / kColGroups;         // 0..63
  const int n0 = blockIdx.x * COLS + cg * VEC;
  const int m0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(MT, m - m0);
  const T* xr = x + (long long)m0 * xs;

  float acc[MT][VEC];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;

  for (int kb = klane * kKU; kb < k; kb += KLANES * kKU) {
    float wv[kKU][VEC];
#pragma unroll
    for (int u = 0; u < kKU; ++u) {
      const int kk = kb + u;
      const T* wr = w + (long long)kk * wsk + n0;
      if (ALIGNED) {
        if (kk < k && n0 < n) {
          load_vec<T, VEC>(wr, wv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) wv[u][j] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          wv[u][j] = (kk < k && n0 + j < n) ? to_f32(wr[j]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kKU; ++u) {
      const int kk = kb + u;
      if (kk >= k) break;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float xv = r < rows ? to_f32(xr[(long long)r * xs + kk]) : 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(xv, wv[u][j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int o = kColGroups; o < 32; o <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < kColGroups) red[warp][r][cg * VEC + j] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * COLS; i += kThreads) {
    const int r = i / COLS, c = i % COLS;
    float s = red[0][r][c];
#pragma unroll
    for (int q = 1; q < kThreads / 32; ++q) s += red[q][r][c];
    const int col = blockIdx.x * COLS + c;
    if (r < rows && col < n) out[(long long)(m0 + r) * os + col] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// rows_matmul, w = the transposed view of wt (N, K), K contiguous
//
// One warp an output column: lane l reads VEC consecutive elements of the
// column's K at k = VEC (l + 32 i), four loads in flight, and the same
// elements of every row of x; each row's sum is an fmaf chain over the
// lane's elements in increasing k, then a five-step xor-shuffle tree.
// ---------------------------------------------------------------------------

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
rows_matmul_nk_kernel(const T* __restrict__ x, long long xs,
                      const T* __restrict__ wt, long long wsn,
                      T* __restrict__ out, long long os, int m, int k,
                      int n) {
  constexpr int VEC = Vec<T>::n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * (kThreads / 32) + warp;
  if (col >= n) return;
  const int m0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(MT, m - m0);
  const T* wr = wt + (long long)col * wsn;
  const T* xr = x + (long long)m0 * xs;
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k0 = lane * VEC; k0 < k; k0 += 32 * VEC) {
    float wv[VEC];
    load_vec<T, VEC>(wr + k0, wv);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < rows) {
        float xv[VEC];
        load_vec<T, VEC>(xr + (long long)r * xs + k0, xv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[r] = fmaf(xv[j], wv[j], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == 0 && r < rows) out[(long long)(m0 + r) * os + col] = from_f32<T>(s);
  }
}

template <typename T, int MT>
cudaError_t launch_rows(const void* x, long long xs, const void* w,
                        long long wsk, long long wsn, void* out, long long os,
                        int m, int k, int n, cudaStream_t st) {
  const int gy = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  if (wsn == 1) {
    constexpr int COLS = kColGroups * Vec<T>::n;
    const dim3 grid((n + COLS - 1) / COLS, gy);
    const bool aligned = n % Vec<T>::n == 0 && wsk % Vec<T>::n == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (aligned)
      rows_matmul_kn_kernel<T, MT, true><<<grid, kThreads, 0, st>>>(
          (const T*)x, xs, (const T*)w, wsk, (T*)out, os, m, k, n);
    else
      rows_matmul_kn_kernel<T, MT, false><<<grid, kThreads, 0, st>>>(
          (const T*)x, xs, (const T*)w, wsk, (T*)out, os, m, k, n);
  } else {
    const dim3 grid((n + kThreads / 32 - 1) / (kThreads / 32), gy);
    rows_matmul_nk_kernel<T, MT><<<grid, kThreads, 0, st>>>(
        (const T*)x, xs, (const T*)w, wsn, (T*)out, os, m, k, n);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* x, long long xs, const void* w,
                          long long wsk, long long wsn, void* out,
                          long long os, int m, int k, int n,
                          cudaStream_t st) {
  const int mt = m < kRowsPerBlock ? m : kRowsPerBlock;
  if (mt <= 1) return launch_rows<T, 1>(x, xs, w, wsk, wsn, out, os, m, k, n, st);
  if (mt <= 2) return launch_rows<T, 2>(x, xs, w, wsk, wsn, out, os, m, k, n, st);
  if (mt <= 4) return launch_rows<T, 4>(x, xs, w, wsk, wsn, out, os, m, k, n, st);
  if (mt <= 8) return launch_rows<T, 8>(x, xs, w, wsk, wsn, out, os, m, k, n, st);
  return launch_rows<T, 16>(x, xs, w, wsk, wsn, out, os, m, k, n, st);
}

// ---------------------------------------------------------------------------
// rms_norm_rows: one block a row; each thread's sum of squares over the
// elements tid, tid + 256, ... in order, a warp tree, eight warps in order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_rows_kernel(const T* __restrict__ x, long long xs,
                     const T* __restrict__ w, T* __restrict__ out,
                     long long os, int d, float eps) {
  __shared__ float part[kThreads / 32];
  __shared__ float scale;
  const T* xr = x + (long long)blockIdx.x * xs;
  T* orow = out + (long long)blockIdx.x * os;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = part[0];
#pragma unroll
    for (int q = 1; q < kThreads / 32; ++q) s += part[q];
    scale = rsqrtf(s / (float)d + eps);
  }
  __syncthreads();
  const float r = scale;
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(xr[i]), r),
                                    to_f32(w[i])));
}

// ---------------------------------------------------------------------------
// decode_attention: one block a (row b, kv head); its G q heads together.
// Keys [0, min(kv_len[b], S)) in chunks of 64 from key 0.  Per chunk:
//   load    the chunk's k and v rows into shared memory as float, 16 bytes
//           a load, every thread's loads in flight at once (k rows padded
//           by one word, so the score loop's lanes hit distinct banks);
//   scores  one thread a (head, key): q . k over d in order (fmaf), rounded
//           to q's type (the plain version's einsum output), times the
//           scale;
//   softmax one warp a q head: the chunk max (exact), p = exp(s - m) for the
//           keys below the length, their sum by a tree; the running max,
//           sum and the accumulator's rescale exp(m_old - m_new);
//   p . v   one thread a (head, d): acc * rescale + p_j v_j over the chunk's
//           keys in order, p rounded to q's type (the plain version's
//           probabilities are).
// The output is acc / sum in q's type.  The chunking starts at key 0 and
// stops at the row's length, so neither the batch nor the bucket the cache
// was cut to changes a row's arithmetic.  Shared memory is dynamic (about
// 85 KB at hd 128).
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void load_row(const T* src, float* dst, int hd) {
  constexpr int V = Vec<T>::n;
  for (int d = 0; d < hd; d += V) load_vec<T, V>(src + d, dst + d);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const TQ* __restrict__ q, long long qsb,
                        long long qsh, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, long long ksb,
                        long long kss, long long ksh, long long vsb,
                        long long vss, long long vsh,
                        const int* __restrict__ kv_len, TQ* __restrict__ out,
                        int s_max, int h, int kvh, int hd, float scale) {
  extern __shared__ float smem[];
  const int group = h / kvh;
  const int kst = hd + 1;                          // padded k row
  float* qs = smem;                                // [group][hd]
  float* acc = qs + group * hd;                    // [group][hd]
  float* sc = acc + group * hd;                    // [group][kChunk]
  float* ks = sc + group * kChunk;                 // [kChunk][hd + 1]
  float* vs = ks + kChunk * kst;                   // [kChunk][hd]
  __shared__ float m_run[kMaxGroup], l_run[kMaxGroup], resc[kMaxGroup];
  const int b = blockIdx.x / kvh, g0 = blockIdx.x % kvh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kAttnThreads / 32;
  constexpr int V = Vec<TKV>::n;
  const int len = min(kv_len[b], s_max);

  for (int i = threadIdx.x; i < group * hd; i += kAttnThreads) {
    const int g = i / hd, d = i % hd;
    qs[i] = to_f32(q[b * qsb + (long long)(g0 * group + g) * qsh + d]);
    acc[i] = 0.f;
  }
  if (threadIdx.x < group) {
    m_run[threadIdx.x] = -INFINITY;
    l_run[threadIdx.x] = 0.f;
  }

  const TKV* kb = k + b * ksb + (long long)g0 * ksh;
  const TKV* vb = v + b * vsb + (long long)g0 * vsh;
  const int vecs = hd / V;                         // 16-byte units a row
  for (int c0 = 0; c0 < len; c0 += kChunk) {
    const int n_keys = min(kChunk, len - c0);
    __syncthreads();           // the previous chunk's readers are done
    for (int i = threadIdx.x; i < n_keys * vecs; i += kAttnThreads) {
      const int j = i / vecs, d = (i % vecs) * V;
      float tmp[V];
      load_vec<TKV, V>(kb + (long long)(c0 + j) * kss + d, tmp);
#pragma unroll
      for (int e = 0; e < V; ++e) ks[j * kst + d + e] = tmp[e];
      load_vec<TKV, V>(vb + (long long)(c0 + j) * vss + d, tmp);
#pragma unroll
      for (int e = 0; e < V; ++e) vs[j * hd + d + e] = tmp[e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < group * kChunk; i += kAttnThreads) {
      const int g = i / kChunk, j = i % kChunk;
      if (j < n_keys) {
        const float* qr = qs + g * hd;
        const float* kr = ks + j * kst;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc[i] = to_f32(from_f32<TQ>(dot)) * scale;
      }
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      const float s0 = lane < n_keys ? sc[g * kChunk + lane] : -INFINITY;
      const float s1 = lane + 32 < n_keys ? sc[g * kChunk + lane + 32]
                                          : -INFINITY;
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n_keys ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n_keys ? expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      const float r = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      sc[g * kChunk + lane] = to_f32(from_f32<TQ>(p0));
      sc[g * kChunk + lane + 32] = to_f32(from_f32<TQ>(p1));
      if (lane == 0) {
        m_run[g] = m_new;
        l_run[g] = fmaf(l_run[g], r, sum);
        resc[g] = r;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < group * hd; i += kAttnThreads) {
      const int g = i / hd, d = i % hd;
      const float* p = sc + g * kChunk;
      float a = acc[i] * resc[g];
      for (int j = 0; j < n_keys; ++j) a = fmaf(p[j], vs[j * hd + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * hd; i += kAttnThreads) {
    const int g = i / hd, d = i % hd;
    out[((long long)b * h + g0 * group + g) * hd + d] =
        from_f32<TQ>(acc[i] / l_run[g]);
  }
}

inline size_t attention_smem(int group, int hd) {
  return sizeof(float) * (2 * group * hd + group * kChunk +
                          kChunk * (hd + 1) + kChunk * hd);
}

template <typename TQ, typename TKV>
cudaError_t launch_attention(const void* q, long long qsb, long long qsh,
                             const void* k, const void* v, long long ksb,
                             long long kss, long long ksh, long long vsb,
                             long long vss, long long vsh, const int* kv_len,
                             void* out, int b, int s_max, int h, int kvh,
                             int hd, float scale, cudaStream_t st) {
  const size_t smem = attention_smem(h / kvh, hd);
  static size_t allowed = 48 * 1024;   // set once an instantiation grows
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)attention_smem(kMaxGroup, kMaxHd));
    if (err != cudaSuccess) return err;
    allowed = attention_smem(kMaxGroup, kMaxHd);
  }
  decode_attention_kernel<TQ, TKV><<<b * kvh, kAttnThreads, smem, st>>>(
      (const TQ*)q, qsb, qsh, (const TKV*)k, (const TKV*)v, ksb, kss, ksh,
      vsb, vss, vsh, kv_len, (TQ*)out, s_max, h, kvh, hd, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ssm_decode_step: one block a (row b, head h), four warps over the head
// dim P, the lanes over the state N (n = lane + 32 i).  Each state element:
// state * exp(dt A) + (dt B_n) x_p, unfused as the plain version rounds it;
// y_p = C . state_p as an fmaf chain over the lane's n, then a tree.
// ---------------------------------------------------------------------------

template <typename T, int NI>
__global__ void __launch_bounds__(128)
ssm_decode_kernel(float* __restrict__ state, const T* __restrict__ x,
                  long long xsb, long long xsh, const float* __restrict__ dt,
                  long long dtsb, const float* __restrict__ A,
                  const T* __restrict__ Bm, long long bsb,
                  const T* __restrict__ Cm, long long csb,
                  T* __restrict__ y, int nh, int p, int n) {
  const int b = blockIdx.x / nh, hh = blockIdx.x % nh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float dtv = dt[b * dtsb + hh];
  const float dA = expf(dtv * A[hh]);
  float bv[NI], cv[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int nn = lane + 32 * i;
    bv[i] = nn < n ? __fmul_rn(dtv, to_f32(Bm[b * bsb + nn])) : 0.f;
    cv[i] = nn < n ? to_f32(Cm[b * csb + nn]) : 0.f;
  }
  float* st = state + ((long long)b * nh + hh) * p * n;
  const T* xr = x + b * xsb + (long long)hh * xsh;
  for (int pp = warp; pp < p; pp += 4) {
    const float xv = to_f32(xr[pp]);
    float ys = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int nn = lane + 32 * i;
      if (nn < n) {
        float* e = st + (long long)pp * n + nn;
        const float s = __fadd_rn(__fmul_rn(*e, dA), __fmul_rn(bv[i], xv));
        *e = s;
        ys = fmaf(cv[i], s, ys);
      }
    }
    ys = warp_sum(ys);
    if (lane == 0) y[((long long)b * nh + hh) * p + pp] = from_f32<T>(ys);
  }
}

template <typename T>
cudaError_t dispatch_ssm(void* state, const void* x, long long xsb,
                         long long xsh, const float* dt, long long dtsb,
                         const float* A, const void* Bm, long long bsb,
                         const void* Cm, long long csb, void* y, int b,
                         int nh, int p, int n, cudaStream_t st) {
  const int grid = b * nh;
#define SSM_LAUNCH(NI)                                                      \
  ssm_decode_kernel<T, NI><<<grid, 128, 0, st>>>(                           \
      (float*)state, (const T*)x, xsb, xsh, dt, dtsb, A, (const T*)Bm, bsb, \
      (const T*)Cm, csb, (T*)y, nh, p, n)
  if (n <= 32) SSM_LAUNCH(1);
  else if (n <= 64) SSM_LAUNCH(2);
  else if (n <= 128) SSM_LAUNCH(4);
  else return cudaErrorInvalidValue;
#undef SSM_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Every launch function returns
// cudaGetLastError() after the launch (0 on success); strides are in
// elements.

extern "C" int rows_matmul_launch(const void* x, long long xs, const void* w,
                                  long long wsk, long long wsn, void* out,
                                  long long os, int m, int k, int n,
                                  int dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || m > 65535 * kRowsPerBlock || (wsn != 1 && wsk != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch_rows<float>(x, xs, w, wsk, wsn, out, os, m, k, n, st);
  if (dtype == 1)
    return (int)dispatch_rows<__nv_bfloat16>(x, xs, w, wsk, wsn, out, os, m,
                                             k, n, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rms_norm_rows_launch(const void* x, long long xs,
                                    const void* w, void* out, long long os,
                                    int m, int d, float eps, int dtype,
                                    void* stream) {
  if (m <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    rms_norm_rows_kernel<float><<<m, kThreads, 0, st>>>(
        (const float*)x, xs, (const float*)w, (float*)out, os, d, eps);
  else if (dtype == 1)
    rms_norm_rows_kernel<__nv_bfloat16><<<m, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, xs, (const __nv_bfloat16*)w,
        (__nv_bfloat16*)out, os, d, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q_dtype / kv_dtype: (1, 1), (0, 1) (a bf16 cache under float32 params) or
// (0, 0).  out is (B, 1, H, hd) contiguous in q's type.
extern "C" int decode_attention_launch(
    const void* q, long long qsb, long long qsh, const void* k,
    const void* v, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, const int* kv_len, void* out, int b,
    int s_max, int h, int kvh, int hd, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  if (b <= 0) return 0;
  if (kvh <= 0 || h % kvh || h / kvh > kMaxGroup || hd <= 0 ||
      hd > kMaxHd || hd % (kv_dtype == 1 ? 8 : 4) || s_max <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch_attention<__nv_bfloat16, __nv_bfloat16>(
        q, qsb, qsh, k, v, ksb, kss, ksh, vsb, vss, vsh, kv_len, out, b,
        s_max, h, kvh, hd, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch_attention<float, __nv_bfloat16>(
        q, qsb, qsh, k, v, ksb, kss, ksh, vsb, vss, vsh, kv_len, out, b,
        s_max, h, kvh, hd, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch_attention<float, float>(
        q, qsb, qsh, k, v, ksb, kss, ksh, vsb, vss, vsh, kv_len, out, b,
        s_max, h, kvh, hd, scale, st);
  return (int)cudaErrorInvalidValue;
}

// state (B, H, P, N) float32 contiguous, updated in place; x (B, H, P) and
// B/C (B, N) in `dtype` through their strides; dt (B, H) and A (H,)
// float32; y (B, H, P) contiguous in `dtype`.
extern "C" int ssm_decode_launch(void* state, const void* x, long long xsb,
                                 long long xsh, const float* dt,
                                 long long dtsb, const float* A,
                                 const void* Bm, long long bsb,
                                 const void* Cm, long long csb, void* y,
                                 int b, int nh, int p, int n, int dtype,
                                 void* stream) {
  if (b <= 0) return 0;
  if (nh <= 0 || p <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch_ssm<float>(state, x, xsb, xsh, dt, dtsb, A, Bm, bsb,
                                    Cm, csb, y, b, nh, p, n, st);
  if (dtype == 1)
    return (int)dispatch_ssm<__nv_bfloat16>(state, x, xsb, xsh, dt, dtsb, A,
                                            Bm, bsb, Cm, csb, y, b, nh, p, n,
                                            st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
