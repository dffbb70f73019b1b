// Backward of the Mamba2 SSD chunk scan (csrc/ssd.cu) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's TPU scan has no backward, and
// the reference trains through JAX autodiff of its plain chunked scan
// (src/repro/models/ssm.py `ssd_chunked`, differentiated by
// jax.value_and_grad).  The port's training forward runs the SSD kernel, so
// its gradient is this kernel; kernels/ssd/ref.py `ssd_bwd_ref` is its
// plain version, step for step.
//
// Function: the gradients of y = ssd(x, dt, A, B, C) from a zero state
// against dy (the final state takes none): dx (B, S, H, P) in x's type,
// ddt (B, S, H) and dA (H,) float32, dB and dC (B, S, N) in their type.
// x, dt, B and C are read in place through their strides, dy contiguous.
// Per (b, h) and chunk c of Q tokens, with a = dt A, cs its cumsum in the
// chunk, l_ij = exp(cs_i - cs_j) (j <= i), w_j = exp(cs_last - cs_j) dt_j,
// S_c the state before chunk c and G the gradient of the state after it:
//   W_ij = (C_i . B_j) l_ij dt_j,   E_ij = l_ij dt_j (dy_i . x_j)
//   dx_j = sum_i W_ij dy_i + w_j G B_j
//   dB_j = sum_h [sum_i E_ij C_i + w_j x_j^T G]
//   dC_i = sum_h [sum_j E_ij B_j + exp(cs_i) dy_i^T S_c]
//   dcs_k = rowsum_k T - colsum_k T + exp(cs_k) dy_k^T S_c C_k
//           - w_k x_k^T G B_k   (T_ij = W_ij (dy_i . x_j)), and at the
//           chunk's last token + sum_j w_j x_j^T G B_j + exp(cs_last)<G,S_c>
//   da_t = sum_{k >= t} dcs_k,  ddt_t = the direct terms + A da_t,
//   dA = sum_{b, t} dt_t da_t.
// A ragged last chunk is masked: steps past S read dt = x = B = C = dy = 0
// and write nothing.
//
// Chunk states: recomputed here, not written by the forward.  The forward
// kernel keeps its state in registers across chunks and writes only the
// final one; asking it for every chunk's start state would add an output
// and a path to the serving kernel, while recomputing them is one pass over
// x and B with Q P N operations a chunk, a sixth of this kernel's.
//
// Launches, on the caller's stream:
//   1. the chunk-start states S_c, and 2. the chunk-end states' gradients G,
//      by one kernel: a block owns (16 columns of P, head, batch) and walks
//      the chunks in order (states) or in reverse (gradients), its slice of
//      the (P, N) float32 state in registers, writing it before each chunk
//      to a (2, B, H, NC, P, N) scratch; a chunk's x (or dy) and B (or C)
//      come into shared memory by 16-byte loads;
//   3. the chunk pass: a block owns (head, chunk, batch) and computes, on
//      float32 FMA through k-major shared-memory tiles (each thread an 8 x
//      8 register tile of a 128 x 128 output, fed by 16-byte loads; the
//      tiles staged by 16-byte loads from global memory), C B^T and dy x^T
//      into two Q x Q matrices, the row and column sums of T, then W and E
//      in their place, then dx, the head's terms of dB and dC (to a (2, B,
//      H, S, N) float32 scratch), ddt, and its chunk's term of dA (to (B,
//      NC, H));
//   4. the sums: dB and dC over the heads, dA over the batch and the chunks,
//      each in order.
// Every sum has one owner and a fixed order (no atomics): two runs give the
// same bits.
//
// Bound on this card: at mamba2-1.3b's training shape (B = 4, S = 512,
// H = 64, P = 64, N = 128, Q = 128, bf16) the function needs 1.12 GFLOP
// with bf16 operands (the causal halves of C B^T and dy x^T) and 16.15 with
// a float32 one (the causal halves of the products with W and E, the state
// products, the recomputed states), and moves its inputs and outputs once,
// 70.3 MB.  Counted as the forward kernel runs such products, each float32
// operand split into two bf16 terms on the tensor cores, that is 33.4
// GFLOP at 989 TFLOP/s: 0.034 ms against 0.021 ms for the bytes, so
// operations bound it (chip_smoke.py's ssd_bwd_work); at the float32 FMA
// rate (67 TFLOP/s) the same products would take 0.241 ms.  This first
// design runs them on FMA, the Q x Q products whole, not on the tensor
// cores, and keeps its scratch in device memory: on an H100 it takes about
// 57 times its bound (PERF.md); the forward's split bf16 mma.sync products
// are the way to the bound.  Loading the staged tiles 16 bytes at a time,
// not an element at a time, halved its time: the element loads had cost
// more than the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKc = 32;            // k a staged tile
constexpr int kPs = 16;            // P columns a state block owns
constexpr int kMaxDim = 128;       // P and N at most

struct Strides {
  long long x_b, x_s, x_h;
  long long dt_b, dt_s, dt_h;
  long long b_b, b_s;
  long long c_b, c_s;
};

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const void* dy;        // contiguous (b, s, h, p)
  void* dx;              // contiguous (b, s, h, p)
  float* ddt;            // contiguous (b, s, h)
  float* da;             // (h,)
  void* db;              // contiguous (b, s, n)
  void* dc;
  float* states;         // (2, b, h, nc, p, n): S_c, then G after chunk c
  float* part;           // (2, b, h, s, n): the heads' terms of dB, dC
  float* part_a;         // (b, nc, h): the chunks' terms of dA
  int b, s, h, p, n, nc;
  Strides st;
};

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ float to_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The chunk's dt (zero past S), its cumsum of dt A (one thread, in order)
// and exp(cs): into dts, cs and ec.  Ends with a barrier.
__device__ void chunk_cumsum(const Args& g, int bi, int hi, int c, int q,
                             float* dts, float* cs, float* ec) {
  const int tid = threadIdx.x;
  for (int i = tid; i < q; i += blockDim.x) {
    const int t = c * q + i;
    dts[i] = t < g.s ? g.dt[bi * g.st.dt_b + t * g.st.dt_s + hi * g.st.dt_h]
                     : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    const float a = g.a[hi];
    float run = 0.f;
    for (int i = 0; i < q; ++i) {
      run += dts[i] * a;
      cs[i] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < q; i += blockDim.x) ec[i] = expf(cs[i]);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1, 2. the chunk-start states (GRAD false) and the chunk-end states'
// gradients (GRAD true).  Block (column slice, head, batch); thread t owns
// state elements e = t + 256 k of the slice's kPs x n, (e / n, e % n).
//   states:    before chunk c write S; S <- exp(cs_last) S + sum_i w_i x_i B_i
//   gradients: walking back, before chunk c write G; then
//              G <- exp(cs_last) G + sum_i exp(cs_i) dy_i C_i
// ---------------------------------------------------------------------------

template <typename T, int Q, bool GRAD>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(Args g) {
  constexpr int kEl = kPs * kMaxDim / kThreads;   // elements a thread
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // Q x kPs: weighted x (or dy)
  float* ys = xs + Q * kPs;           // Q x n:   B (or C)
  float* dts = ys + Q * kMaxDim;
  float* cs = dts + Q;
  float* ec = cs + Q;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPs, hi = blockIdx.y, bi = blockIdx.z;
  const int np = min(kPs, g.p - p0);
  const int n = g.n;
  float acc[kEl];
#pragma unroll
  for (int k = 0; k < kEl; ++k) acc[k] = 0.f;

  const T* x = static_cast<const T*>(GRAD ? g.dy : g.x);
  const T* y = static_cast<const T*>(GRAD ? g.cm : g.bm);
  const long long xs_b = GRAD ? (long long)g.s * g.h * g.p : g.st.x_b;
  const long long xs_s = GRAD ? (long long)g.h * g.p : g.st.x_s;
  const long long xs_h = GRAD ? (long long)g.p : g.st.x_h;
  const long long ys_b = GRAD ? g.st.c_b : g.st.b_b;
  const long long ys_s = GRAD ? g.st.c_s : g.st.b_s;
  float* out = g.states + (GRAD ? (long long)g.b * g.h * g.nc * g.p * n : 0);

  for (int step = 0; step < g.nc; ++step) {
    const int c = GRAD ? g.nc - 1 - step : step;
    // write the state (gradient) this chunk starts from (ends at)
    float* dst = out + (((long long)bi * g.h + hi) * g.nc + c) * g.p * n;
#pragma unroll
    for (int k = 0; k < kEl; ++k) {
      const int e = tid + k * kThreads;
      if (e < np * n) dst[(long long)(p0 + e / n) * n + e % n] = acc[k];
    }
    if (GRAD ? c == 0 : c == g.nc - 1) break;
    chunk_cumsum(g, bi, hi, c, Q, dts, cs, ec);
    const float last = cs[Q - 1];
    // 16-byte units of V elements: every row starts on a unit, and the
    // slice's width and n are whole units (the wrapper's checks)
    constexpr int V = Unit<T>::n;
    for (int idx = tid; idx < Q * (kPs / V); idx += kThreads) {
      const int i = idx / (kPs / V), pp = (idx % (kPs / V)) * V;
      const int t = c * Q + i;
      float f[V];
      if (t < g.s && pp < np)
        unpack<T>(__ldg(reinterpret_cast<const uint4*>(
                      x + bi * xs_b + t * xs_s + hi * xs_h + p0 + pp)),
                  f);
      else
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = 0.f;
      const float wt = GRAD ? ec[i] : expf(last - cs[i]) * dts[i];
#pragma unroll
      for (int e = 0; e < V; ++e) xs[i * kPs + pp + e] = f[e] * wt;
    }
    for (int idx = tid; idx < Q * (n / V); idx += kThreads) {
      const int i = idx / (n / V), nn = (idx % (n / V)) * V;
      const int t = c * Q + i;
      float f[V];
      if (t < g.s)
        unpack<T>(__ldg(reinterpret_cast<const uint4*>(
                      y + bi * ys_b + t * ys_s + nn)),
                  f);
      else
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = 0.f;
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(ys + i * kMaxDim + nn + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    __syncthreads();
    const float decay = ec[Q - 1];
#pragma unroll
    for (int k = 0; k < kEl; ++k) {
      const int e = tid + k * kThreads;
      if (e >= np * n) continue;
      const int pp = e / n, nn = e % n;
      float s = 0.f;
      for (int i = 0; i < Q; ++i)
        s = fmaf(xs[i * kPs + pp], ys[i * kMaxDim + nn], s);
      acc[k] = fmaf(acc[k], decay, s);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 3. the chunk pass.  Thread (ty, tx) of a 16 x 16 grid owns a register
// tile of a Q x (up to 128) output: rows 64 h + 4 ty + i and columns
// 64 c + 4 tx + j (i, j < 4; h < Q / 64 groups of rows, at least one; c
// < 2 groups of columns), so that a k step reads its four rows and four
// columns of each group as one 16-byte shared-memory load each: operands
// are staged k-major ([k][row], [k][col]).  The 16 threads of a row lie in
// one half-warp, so a row's sum over its columns is a fixed xor tree of
// shuffles.
// ---------------------------------------------------------------------------

constexpr int kCs = kMaxDim + 4;   // a staged B operand's row stride

template <int Q>
struct Tile {
  static constexpr int GR = Q >= 64 ? Q / 64 : 1;   // row groups
  static constexpr int RM = 4 * GR;                 // rows a thread
  float v[RM][8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) v[a][b] = 0.f;
  }
  // the thread's row a and column b
  __device__ __forceinline__ static int row(int a) {
    return 64 * (a >> 2) + 4 * (threadIdx.x >> 4) + (a & 3);
  }
  __device__ __forceinline__ static int col(int b) {
    return 64 * (b >> 2) + 4 * (threadIdx.x & 15) + (b & 3);
  }
};

// acc[a][b] += sum_{k < kc} A(row a, k) B(k, col b).  A at a[k * aks + r]
// with rows contiguous (AVEC: a 16-byte load a group), else at a[r * ars +
// k]; B staged as b[k * kCs + col].  Row and column groups past Q and the
// ncols columns are left alone (their loads too).
template <int Q, bool AVEC>
__device__ __forceinline__ void mma_fma(Tile<Q>& acc, const float* a,
                                        int ars, int aks, const float* b,
                                        int kc, int ncols) {
  constexpr int GR = Tile<Q>::GR, RM = Tile<Q>::RM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool c0 = 4 * tx < ncols, c1 = 64 + 4 * tx < ncols;
  bool rv[GR];
#pragma unroll
  for (int h = 0; h < GR; ++h) rv[h] = 64 * h + 4 * ty < Q;
  for (int k = 0; k < kc; ++k) {
    float av[RM], bv[8];
#pragma unroll
    for (int h = 0; h < GR; ++h) {
      const int r = 64 * h + 4 * ty;
      if (!rv[h]) {
        av[4 * h] = av[4 * h + 1] = av[4 * h + 2] = av[4 * h + 3] = 0.f;
      } else if constexpr (AVEC) {
        const float4 u = *reinterpret_cast<const float4*>(a + k * aks + r);
        av[4 * h] = u.x;
        av[4 * h + 1] = u.y;
        av[4 * h + 2] = u.z;
        av[4 * h + 3] = u.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) av[4 * h + i] = a[(r + i) * ars + k];
      }
    }
    const float* bk = b + k * kCs + 4 * tx;
    float4 u0 = make_float4(0.f, 0.f, 0.f, 0.f), u1 = u0;
    if (c0) u0 = *reinterpret_cast<const float4*>(bk);
    if (c1) u1 = *reinterpret_cast<const float4*>(bk + 64);
    bv[0] = u0.x; bv[1] = u0.y; bv[2] = u0.z; bv[3] = u0.w;
    bv[4] = u1.x; bv[5] = u1.y; bv[6] = u1.z; bv[7] = u1.w;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
  }
}

// Stage a (rows x kKc) operand tile k-major, dst[k * stride + r], from a
// source of type S read 16 bytes (V elements) at a time: element (r, k) at
// src[r * rs + k] (K_FAST: k contiguous, the units taken along k) or at
// src[k * rs + r] (r contiguous, the units along r).  Elements at k >= kc,
// or whose source row (r for K_FAST, else k) is at or past `valid`, are
// zero.  Consecutive threads take consecutive r, so the stores of a warp
// fall in distinct banks.  rows, kc and every source row's start are whole
// 16-byte units (the wrapper's checks).
template <typename S, bool K_FAST>
__device__ __forceinline__ void stage(float* dst, int stride, const S* src,
                                      long long rs, int rows, int kc,
                                      int valid) {
  constexpr int V = Unit<S>::n;
  if constexpr (K_FAST) {
    for (int idx = threadIdx.x; idx < rows * (kKc / V); idx += kThreads) {
      const int r = idx % rows, k = (idx / rows) * V;
      float f[V];
      if (r < valid && k < kc)
        unpack<S>(__ldg(reinterpret_cast<const uint4*>(src + r * rs + k)),
                  f);
      else
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) dst[(k + e) * stride + r] = f[e];
    }
  } else {
    const int units = rows / V;
    for (int idx = threadIdx.x; idx < units * kKc; idx += kThreads) {
      const int r = (idx % units) * V, k = idx / units;
      float f[V];
      if (k < valid && k < kc)
        unpack<S>(__ldg(reinterpret_cast<const uint4*>(src + k * rs + r)),
                  f);
      else
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = 0.f;
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + k * stride + r + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  }
}

// the sum of v over the 16 threads of a row (all of them get it)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(Args g) {
  using TileQ = Tile<Q>;
  constexpr int RM = TileQ::RM;
  constexpr int QL = Q + 4;          // a Q x Q matrix's row stride
  extern __shared__ __align__(16) float smem[];
  float* m1 = smem;                  // C B^T, then W   ([i][j])
  float* m2 = m1 + Q * QL;           // dy x^T, then E  ([i][j])
  float* sa = m2 + Q * QL;           // kKc x QL: a staged A operand
  float* sb = sa + kKc * QL;         // kKc x kCs: a staged B operand
  float* dts = sb + kKc * kCs;
  float* cs = dts + Q;
  float* ec = cs + Q;
  float* wv = ec + Q;                // w_j
  float* rowt = wv + Q;
  float* colt = rowt + Q;
  float* cold = colt + Q;            // direct ddt, intra-chunk
  float* xgb = cold + Q;             // x_j^T G B_j
  float* rr = xgb + Q;               // exp(cs_i) dy_i^T S C_i
  float* red = rr + Q;               // kThreads: <G, S>
  float* dcs = red + kThreads;

  const int tid = threadIdx.x, tx = tid & 15;
  const int hi = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int p = g.p, n = g.n, s = g.s, t0 = c * Q;
  const T* x = static_cast<const T*>(g.x) + bi * g.st.x_b + hi * g.st.x_h;
  const T* bm = static_cast<const T*>(g.bm) + bi * g.st.b_b;
  const T* cm = static_cast<const T*>(g.cm) + bi * g.st.c_b;
  const T* dy = static_cast<const T*>(g.dy) +
                ((long long)bi * s * g.h + hi) * p;
  const long long dys = (long long)g.h * p;
  const long long sidx = (((long long)bi * g.h + hi) * g.nc + c) * p * n;
  const float* S = g.states + sidx;                                 // S_c
  const float* G = g.states + (long long)g.b * g.h * g.nc * p * n + sidx;

  // the chunk's first rows, and how many of its rows lie before S
  const T* x0 = x + (long long)t0 * g.st.x_s;
  const T* dy0 = dy + (long long)t0 * dys;
  const T* bm0 = bm + (long long)t0 * g.st.b_s;
  const T* cm0 = cm + (long long)t0 * g.st.c_s;
  const int valid = min(Q, s - t0);
  auto xat = [&](int i, int k) {          // x of row i of the chunk
    return t0 + i < s ? ld<T>(x + (t0 + i) * g.st.x_s + k) : 0.f;
  };
  auto dyat = [&](int i, int k) {
    return t0 + i < s ? ld<T>(dy + (t0 + i) * dys + k) : 0.f;
  };
  auto bat = [&](int i, int k) {
    return t0 + i < s ? ld<T>(bm + (t0 + i) * g.st.b_s + k) : 0.f;
  };
  auto cat = [&](int i, int k) {
    return t0 + i < s ? ld<T>(cm + (t0 + i) * g.st.c_s + k) : 0.f;
  };

  chunk_cumsum(g, bi, hi, c, Q, dts, cs, ec);
  const float last = cs[Q - 1];
  for (int i = tid; i < Q; i += kThreads)
    wv[i] = expf(last - cs[i]) * dts[i];

  TileQ acc;

  // m1 = C B^T (K = n), m2 = dy x^T (K = p), each masked to j <= i
  for (int which = 0; which < 2; ++which) {
    const int kk = which == 0 ? n : p;
    acc.zero();
    for (int k0 = 0; k0 < kk; k0 += kKc) {
      const int kc = min(kKc, kk - k0);
      __syncthreads();
      if (which == 0) {
        stage<T, true>(sa, QL, cm0 + k0, g.st.c_s, Q, kc, valid);
        stage<T, true>(sb, kCs, bm0 + k0, g.st.b_s, Q, kc, valid);
      } else {
        stage<T, true>(sa, QL, dy0 + k0, dys, Q, kc, valid);
        stage<T, true>(sb, kCs, x0 + k0, g.st.x_s, Q, kc, valid);
      }
      __syncthreads();
      mma_fma<Q, true>(acc, sa, 0, QL, sb, kc, Q);
    }
    float* m = which == 0 ? m1 : m2;
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int i = TileQ::row(a), j = TileQ::col(b);
        if (i < Q && j < Q) m[i * QL + j] = j <= i ? acc.v[a][b] : 0.f;
      }
  }
  __syncthreads();

  // row sums of T (threads 0..Q-1) and column sums of T and of the direct
  // ddt term (threads Q..2Q-1), each in order
  if (tid < Q) {
    const int i = tid;
    float sum = 0.f;
    for (int j = 0; j <= i; ++j)
      sum = fmaf(m1[i * QL + j] * expf(cs[i] - cs[j]) * dts[j],
                 m2[i * QL + j], sum);
    rowt[i] = sum;
  } else if (tid < 2 * Q) {
    const int j = tid - Q;
    float st = 0.f, sd = 0.f;
    for (int i = j; i < Q; ++i) {
      const float cbq = m1[i * QL + j] * expf(cs[i] - cs[j]) * m2[i * QL + j];
      sd += cbq;
      st = fmaf(cbq, dts[j], st);
    }
    colt[j] = st;
    cold[j] = sd;
  }
  __syncthreads();
  // W and E in place of C B^T and dy x^T
  for (int idx = tid; idx < Q * Q; idx += kThreads) {
    const int i = idx / Q, j = idx % Q;
    if (j <= i) {
      const float l = expf(cs[i] - cs[j]) * dts[j];
      m1[i * QL + j] *= l;
      m2[i * QL + j] *= l;
    }
  }

  // dx (rows j, columns p): w_j G B_j, with x_j^T G B_j kept for ddt, then
  // + sum_i W_ij dy_i
  acc.zero();
  for (int k0 = 0; k0 < n; k0 += kKc) {
    const int kc = min(kKc, n - k0);
    __syncthreads();
    stage<T, true>(sa, QL, bm0 + k0, g.st.b_s, Q, kc, valid);
    stage<float, true>(sb, kCs, G + k0, n, p, kc, p);
    __syncthreads();
    mma_fma<Q, true>(acc, sa, 0, QL, sb, kc, p);
  }
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int j = TileQ::row(a);
    float d = 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = TileQ::col(b);
      if (j < Q && col < p) d = fmaf(acc.v[a][b], xat(j, col), d);
    }
    d = row_sum(d);
    if (tx == 0 && j < Q) xgb[j] = d;
    const float w = j < Q ? wv[j] : 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b) acc.v[a][b] *= w;
  }
  for (int k0 = 0; k0 < Q; k0 += kKc) {
    const int kc = min(kKc, Q - k0);
    __syncthreads();
    stage<T, false>(sb, kCs, dy0 + k0 * dys, dys, p, kc, valid - k0);
    __syncthreads();
    mma_fma<Q, true>(acc, m1 + k0 * QL, 0, QL, sb, kc, p);
  }
  {
    T* dx = static_cast<T*>(g.dx) + ((long long)bi * s * g.h + hi) * p;
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int j = TileQ::row(a);
      if (j >= Q || t0 + j >= s) continue;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int col = TileQ::col(b);
        if (col < p) dx[(t0 + j) * dys + col] = to_t<T>(acc.v[a][b]);
      }
    }
  }

  // the head's term of dB (rows j, columns n): w_j x_j^T G + sum_i E_ij C_i
  acc.zero();
  for (int k0 = 0; k0 < p; k0 += kKc) {
    const int kc = min(kKc, p - k0);
    __syncthreads();
    stage<T, true>(sa, QL, x0 + k0, g.st.x_s, Q, kc, valid);
    stage<float, false>(sb, kCs, G + (long long)k0 * n, n, n, kc, kc);
    __syncthreads();
    mma_fma<Q, true>(acc, sa, 0, QL, sb, kc, n);
  }
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int j = TileQ::row(a);
    const float w = j < Q ? wv[j] : 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b) acc.v[a][b] *= w;
  }
  for (int k0 = 0; k0 < Q; k0 += kKc) {
    const int kc = min(kKc, Q - k0);
    __syncthreads();
    stage<T, false>(sb, kCs, cm0 + k0 * g.st.c_s, g.st.c_s, n, kc,
                    valid - k0);
    __syncthreads();
    mma_fma<Q, true>(acc, m2 + k0 * QL, 0, QL, sb, kc, n);
  }
  const long long pstride = (long long)s * n;
  float* pb = g.part + ((long long)bi * g.h + hi) * pstride;
  float* pc = pb + (long long)g.b * g.h * pstride;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int j = TileQ::row(a);
    if (j >= Q || t0 + j >= s) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = TileQ::col(b);
      if (col < n) pb[(long long)(t0 + j) * n + col] = acc.v[a][b];
    }
  }

  // the head's term of dC (rows i, columns n): exp(cs_i) dy_i^T S_c, with
  // its dot with C_i kept for ddt, then + sum_j E_ij B_j
  acc.zero();
  for (int k0 = 0; k0 < p; k0 += kKc) {
    const int kc = min(kKc, p - k0);
    __syncthreads();
    stage<T, true>(sa, QL, dy0 + k0, dys, Q, kc, valid);
    stage<float, false>(sb, kCs, S + (long long)k0 * n, n, n, kc, kc);
    __syncthreads();
    mma_fma<Q, true>(acc, sa, 0, QL, sb, kc, n);
  }
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = TileQ::row(a);
    float d = 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = TileQ::col(b);
      if (i < Q && col < n) d = fmaf(acc.v[a][b], cat(i, col), d);
    }
    d = row_sum(d);
    const float e = i < Q ? ec[i] : 0.f;
    if (tx == 0 && i < Q) rr[i] = e * d;
#pragma unroll
    for (int b = 0; b < 8; ++b) acc.v[a][b] *= e;
  }
  for (int k0 = 0; k0 < Q; k0 += kKc) {
    const int kc = min(kKc, Q - k0);
    __syncthreads();
    stage<T, false>(sb, kCs, bm0 + k0 * g.st.b_s, g.st.b_s, n, kc,
                    valid - k0);
    __syncthreads();
    mma_fma<Q, false>(acc, m2 + k0, QL, 0, sb, kc, n);
  }
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = TileQ::row(a);
    if (i >= Q || t0 + i >= s) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = TileQ::col(b);
      if (col < n) pc[(long long)(t0 + i) * n + col] = acc.v[a][b];
    }
  }

  // <G, S_c>: each thread's elements in order, then a fixed tree
  {
    float sum = 0.f;
    for (int e = tid; e < p * n; e += kThreads) sum = fmaf(G[e], S[e], sum);
    red[tid] = sum;
  }
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  // dcs, da (a reverse cumsum), ddt and the chunk's term of dA, in order
  if (tid == 0) {
    float vsum = 0.f;
    for (int k = 0; k < Q; ++k) {
      const float v = wv[k] * xgb[k];
      dcs[k] = rowt[k] - colt[k] + rr[k] - v;
      vsum += v;
    }
    dcs[Q - 1] += vsum + ec[Q - 1] * red[0];
    float run = 0.f, pa = 0.f;
    for (int k = Q - 1; k >= 0; --k) {
      run += dcs[k];
      dcs[k] = run;                               // da_k
    }
    for (int k = 0; k < Q; ++k) pa = fmaf(dts[k], dcs[k], pa);
    g.part_a[((long long)bi * g.nc + c) * g.h + hi] = pa;
  }
  __syncthreads();
  for (int k = tid; k < Q; k += kThreads) {
    if (t0 + k >= s) continue;
    const float direct = cold[k] + expf(last - cs[k]) * xgb[k];
    g.ddt[((long long)bi * s + t0 + k) * g.h + hi] =
        fmaf(g.a[hi], dcs[k], direct);
  }
}

// ---------------------------------------------------------------------------
// 4. the sums: dB and dC over the heads (blockIdx.y 0 and 1: one thread an
// element of (b, s, n)), dA over the batch and the chunks (blockIdx.y 2:
// one thread a head), each in order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(Args g) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.y == 2) {
    if (e >= g.h) return;
    float sum = 0.f;
    for (int bi = 0; bi < g.b; ++bi)
      for (int c = 0; c < g.nc; ++c)
        sum += g.part_a[((long long)bi * g.nc + c) * g.h + e];
    g.da[e] = sum;
    return;
  }
  const long long per = (long long)g.s * g.n;
  if (e >= g.b * per) return;
  const long long bi = e / per, rest = e % per;
  const float* src = g.part + (long long)blockIdx.y * g.b * g.h * per +
                     bi * g.h * per + rest;
  float sum = 0.f;
  for (int hi = 0; hi < g.h; ++hi) sum += src[hi * per];
  T* dst = static_cast<T*>(blockIdx.y == 0 ? g.db : g.dc);
  dst[e] = to_t<T>(sum);
}

template <int Q>
constexpr int states_smem() {
  return 4 * (Q * kPs + Q * kMaxDim + 3 * Q);
}

template <int Q>
constexpr int chunk_smem() {
  return 4 * (2 * Q * (Q + 4) + kKc * (Q + 4) + kKc * kCs + 10 * Q +
              kThreads);
}

template <typename T, int Q>
cudaError_t run(const Args& g, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_states_kernel<T, Q, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, states_smem<Q>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_states_kernel<T, Q, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             states_smem<Q>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, Q>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             chunk_smem<Q>());
  if (e != cudaSuccess) return e;
  const dim3 sgrid((g.p + kPs - 1) / kPs, g.h, g.b);
  ssd_bwd_states_kernel<T, Q, false><<<sgrid, kThreads, states_smem<Q>(),
                                       st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_states_kernel<T, Q, true><<<sgrid, kThreads, states_smem<Q>(),
                                      st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_chunk_kernel<T, Q><<<dim3(g.h, g.nc, g.b), kThreads,
                               chunk_smem<Q>(), st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long elems = (long long)g.b * g.s * g.n;
  long long blocks = (elems + kThreads - 1) / kThreads;
  const long long hblocks = (g.h + kThreads - 1) / kThreads;
  if (hblocks > blocks) blocks = hblocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_bwd_sum_kernel<T><<<dim3((unsigned)blocks, 3), kThreads, 0, st>>>(g);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC); dt, A, ddt
// and dA float32.  Strides of x, dt, B and C in elements (their last
// dimensions dense); dy, dx, ddt, dB and dC contiguous; states (2, b, h,
// nc, p, n), part (2, b, h, s, n) and part_a (b, nc, h) float32 scratch
// with nc = ceil(s / chunk).  Returns cudaGetLastError() after the last
// launch (0 on success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* dy, void* dx, void* ddt, void* da, void* db,
    void* dc, void* states, void* part, void* part_a, int batch, int seqlen,
    int heads, int pdim, int ndim, int chunk, long long x_b, long long x_s,
    long long x_h, long long dt_b, long long dt_s, long long dt_h,
    long long b_b, long long b_s, long long c_b, long long c_s, int dtype,
    void* stream) {
  if (batch <= 0 || heads <= 0 || seqlen <= 0) return 0;
  if (pdim < 1 || pdim > kMaxDim || ndim < 1 || ndim > kMaxDim ||
      batch > 65535 || heads > 65535 || (chunk != 16 && chunk != 128))
    return (int)cudaErrorInvalidValue;
  // the plain version's chunk is min(chunk, S): a shorter S is one ragged
  // chunk here, masked, which is the same function
  const int nc = (seqlen + chunk - 1) / chunk;
  Args g{x, static_cast<const float*>(dt), static_cast<const float*>(a),
         bm, cm, dy, dx, static_cast<float*>(ddt), static_cast<float*>(da),
         db, dc, static_cast<float*>(states), static_cast<float*>(part),
         static_cast<float*>(part_a), batch, seqlen, heads, pdim, ndim, nc,
         Strides{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s}};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return chunk == 16 ? (int)run<float, 16>(g, st)
                       : (int)run<float, 128>(g, st);
  if (dtype == 1)
    return chunk == 16 ? (int)run<__nv_bfloat16, 16>(g, st)
                       : (int)run<__nv_bfloat16, 128>(g, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
