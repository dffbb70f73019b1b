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
// x and B with Q P N operations a chunk.
//
// Bound on this card: at mamba2-1.3b's training shape (B = 4, S = 512,
// H = 64, P = 64, N = 128, Q = 128, bf16) the function moves its inputs and
// outputs once, 70.3 MB (0.021 ms at 3.35 TB/s), and the products below,
// each float32 operand split into two bf16 terms, come to 33.4 GFLOP
// (0.034 ms at 989 TFLOP/s; chip_smoke.py's ssd_bwd_work): operations
// bound it.  At zamba2-7b's (H = 112, N = 64) bytes do (120.3 MB, 0.036 ms).
//
// Two bodies.  The bf16 path at Q = 128 and P <= 64 (mamba2's and zamba2's
// training calls) is the redesign below, on the tensor cores.  The float32
// path, Q = 16 and P > 64 keep the first design's body (the parity tests'
// and the smoke configs' calls, as ssd.cu keeps float32 on FMA).
//
// The redesign, four launches on the caller's stream, every product by
// `mma.sync.m16n8k16` (bf16 in, float32 accumulators; mma_sm90.cuh):
//   1. the chunk-state walks: a block of 8 warps owns (head, batch) and
//      walks the chunks forward (S) or back (G), the (P, N) state held as
//      the accumulators of (x o w)^T B (or (e^cs dy)^T C), the forward
//      kernel's state update, the next chunk's tiles loading meanwhile;
//      after each chunk it writes the state split into bf16 hi and lo
//      planes (the same bytes as float32) to a (2, B, H, NC, 2, P, N)
//      scratch, except the zero S_0 and G_last, 16 bytes a lane;
//   2. the chunk pass: a block of 8 warps owns (head, chunk, batch) with the
//      chunk's x and dy, then B and G, then C and S, in swizzled shared
//      memory (cp.async; 96 KB at N = 128, so two blocks share an SM).
//      C B^T is the heads' own: blocks of launch 1 take it once a (chunk,
//      batch), fragment by fragment into a scratch the chunk pass reads
//      back as accumulators.  Warp w owns key tile jt (w or 11 - w, so the
//      two warps of a scheduler walk 9 tiles together) and walks the query
//      tiles it >= jt: (x dy^T)^T into registers, the decay l = 2^((cs_i -
//      cs_j) log2 e) by `ex2` (cs from a float64 warp scan, kept as a float
//      pair), masked on the diagonal tile, W^T and the sums of T = W o
//      (dy . x) formed from the accumulators, W^T split into hi and lo A
//      fragments and multiplied by dy into dx.  Then, per key tile, B G^T
//      (dx's state term and x . G B) and C S^T (dy . S C), <G, S>, and warp
//      0 takes dcs, its reverse cumsum by a warp scan, ddt and the chunk's
//      term of dA;
//   3. dB and dC: the heads share B and C, so a block owns (a group of 8
//      heads taken in order, dB or dC, chunk and batch) and sums the group's
//      heads on chip: per head E (or E^T) from x dy^T tile by tile, added
//      into the warp's own tiles of a float32 sum in shared memory, and the
//      state term (x o w) G (or (dy o e^cs) S), both float32 operands split
//      (hi hi + hi lo + lo hi), into the accumulators; then the group's E,
//      split, times C (or B) once; one float32 partial a group leaves the
//      block, (2, B, H/8, S, N): an eighth of the first design's per-head
//      scratch;
//   4. the sums: dB and dC over the groups, dA over the batch and chunks,
//      each in order.
// No thread runs a serial section: every cumsum is a warp scan (in float64:
// ddt rests on differences of cs to a few parts in 1e6 of cs).  Every sum
// has one owner and a fixed order (no atomics): two runs give the same bits.
// Precision as the forward's: x, B, C and dy are exact in bf16; every
// float32 operand (W, E, the states, x o w, dy o e^cs) goes in as hi + lo
// (|v - hi - lo| <= 2^-16 |v|); tests/test_torch_ssm_bwd.py emulates this
// arithmetic on the CPU and shows that one bf16 rounding misses the limits.
//
// The first design (float32, Q = 16, P > 64): 1, 2. the chunk-start states
// and the chunk-end states' gradients, a block a (16 columns of P, head,
// batch), on FMA through shared memory; 3. the chunk pass, a block a (head,
// chunk, batch), Q x Q float32 products on FMA, the heads' terms of dB and
// dC to a (2, B, H, S, N) float32 scratch; 4. the sums.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py --times ssd_bwd; PERF.md row 6): 0.269 ms at mamba2's
// training shape (12.6% of its bound: walks 0.054, chunk pass 0.093, dB/dC
// 0.112, sums 0.007) and 0.339 ms at zamba2's (10.6%), against the first
// design's 1.92-1.93 and 2.33-2.35 ms in the same run.  dB/dC now takes
// the most: per head it recomputes x dy^T tile by tile, and its state term
// runs three split products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"
#include "mma_sm90.cuh"

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
                         // (the redesign: bf16 hi and lo planes, the same
                         // bytes)
  float* part;           // (2, b, ng, s, n): the groups' terms of dB, dC
  float* part_a;         // (b, nc, h): the chunks' terms of dA
  float* cb;             // the redesign: (b, nc, 36 tiles, 32 lanes, 8)
                         // C B^T's causal tiles in fragment order
  int b, s, h, p, n, nc;
  int ng;                // head groups of part (the first design: h)
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
  float* pb = g.part + ((long long)bi * g.ng + hi) * pstride;
  float* pc = pb + (long long)g.b * g.ng * pstride;
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
// 4. the sums: dB and dC over the head groups (blockIdx.y 0 and 1: one
// thread an element of (b, s, n)), dA over the batch and the chunks
// (blockIdx.y 2: one thread a head), each in order.
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
  const float* src = g.part + (long long)blockIdx.y * g.b * g.ng * per +
                     bi * g.ng * per + rest;
  float sum = 0.f;
  for (int q = 0; q < g.ng; ++q) sum += src[q * per];
  T* dst = static_cast<T*>(blockIdx.y == 0 ? g.db : g.dc);
  dst[e] = to_t<T>(sum);
}

// ---------------------------------------------------------------------------
// The redesign: the bf16 path at Q = 128 and P <= 64, on the tensor cores.
// Fragment layouts and the ldmatrix addressing are mma_sm90.cuh's; a tile
// stored [rows][k] feeds an A operand (or, as [n][k], a B operand) through
// plain ldmatrix, one stored [k][n] a B operand through ldmatrix.trans.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ex2;
using sm90::ldsm_x4;
using sm90::ldsm_x4_t;
using sm90::mma_bf16;
using sm90::pack_bf16;
using sm90::smem_u32;
using sm90::split_bf16;
using sm90::swz;

constexpr int kQ = 128;          // the chunk
constexpr int kRT = kQ / 16;     // its 16-row tiles
constexpr int kPC = 64;          // P, padded in shared memory
constexpr int kGroup = 8;        // heads a dB / dC partial sums
constexpr float kLog2e = 1.4426950408889634f;

// rows [0, rows) and 16-byte chunks [0, creal) of a (ROWS x 8 CPR) bf16
// tile, from rows `rs` elements apart, by cp.async into swizzled shared
// memory; the rest is zero-filled
template <int ROWS, int CPR, int THREADS>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src,
                                           long long rs, int rows,
                                           int creal) {
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < rows && c < creal;
    cp_async16(smem_u32(dst + swz<CPR>(r, c) * 8), ok ? src + r * rs + c * 8
                                                      : src, ok);
  }
}

// The chunk's cumsum of dt a (each product rounded to float32, as the
// plain version's) by one warp: lane l adds tokens 4l..4l+3 in order, then
// an inclusive scan over the lanes, in float64.  ddt rests on differences
// of cs across the chunk, to a few parts in 1e6 of cs's size: a float32
// scan of this shape alone used three fifths of ddt's limit (emulated on
// the CPU, tests/test_torch_ssm_bwd.py).  dt past `valid` reads 0.
// Returns cs of the chunk's last token.
__device__ __forceinline__ double warp_cumsum(const float* dt, long long ds,
                                              int valid, float a,
                                              float (&dtv)[4],
                                              double (&cs)[4]) {
  const int lane = threadIdx.x & 31;
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * 4 + e;
    dtv[e] = j < valid ? dt[j * ds] : 0.f;
    run += (double)__fmul_rn(dtv[e], a);
    cs[e] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += up;
  }
  double excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) cs[e] += excl;
  return __shfl_sync(0xffffffffu, cs[3], 31);
}

// cs as a float pair hi + lo, whose differences keep float32's relative
// precision: (hi_i - hi_j) + (lo_i - lo_j)
__device__ __forceinline__ void split_cs(double c, float& hi, float& lo) {
  hi = (float)c;
  lo = (float)(c - (double)hi);
}

// the decay l_ij = e^(cs_i - cs_j) from the pairs, by `ex2`
__device__ __forceinline__ float decay(float hi_i, float lo_i, float hi_j,
                                       float lo_j) {
  return ex2(((hi_i - hi_j) + (lo_i - lo_j)) * kLog2e);
}

__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the four A fragment registers of a 16 x 16 tile held as two 16 x 8
// accumulators (columns 0-7, 8-15), split into bf16 hi and lo
__device__ __forceinline__ void split_frag(const float (&s)[2][4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(s[0][0], s[0][1], hi[0], lo[0]);
  split_bf16(s[0][2], s[0][3], hi[1], lo[1]);
  split_bf16(s[1][0], s[1][1], hi[2], lo[2]);
  split_bf16(s[1][2], s[1][3], hi[3], lo[3]);
}

// an A fragment (rows g and g + 8) times a weight a row, split: the
// bf16 operand x of row g (or g + 8) scaled by w0 (or w1)
__device__ __forceinline__ void scale_split(const uint32_t (&x)[4], float w0,
                                            float w1, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x[q]));
    const float w = (q & 1) ? w1 : w0;
    split_bf16(f.x * w, f.y * w, hi[q], lo[q]);
  }
}

// the scratch plane of a state: which (0 S, 1 G), batch, head, chunk; hi
// at the returned pointer, lo p n elements after it
__device__ __forceinline__ bf16* state_plane(const Args& g, int which,
                                             int bi, int hi, int c) {
  return reinterpret_cast<bf16*>(g.states) +
         ((((long long)which * g.b + bi) * g.h + hi) * g.nc + c) * 2 *
             g.p * g.n;
}

// the key tile of warp w of 8: w or 11 - w, so that the two warps of a
// scheduler (w, w + 4) walk 9 of the causal tiles together
__device__ __forceinline__ int key_tile(int warp) {
  return warp < 4 ? warp : 11 - warp;
}

constexpr int kTri = kRT * (kRT + 1) / 2;   // the 16 x 16 tiles of j <= i

__device__ __forceinline__ int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// ---------------------------------------------------------------------------
// 1. the walks.  Block (head, batch) x {S, G} of 8 warps; warp w owns ST
// 16 x 8 tiles of the (P, N) state (rows mt, columns from nt0), the
// forward kernel's split of its state.
//   S: for c = 0 .. nc-2: S <- e^cs_last S + (x o w)^T B, write S_{c+1}
//   G: for c = nc-1 .. 1: G <- e^cs_last G + (dy o e^cs)^T C, write G_{c-1}
// The next chunk's tiles load (cp.async, two stages) while this one's are
// used; the state goes out split into its hi and lo planes, staged in the
// chunk's spent B (or C) tile so that rows leave 16 bytes a lane.
// Blocks (chunk, batch) of blockIdx.z 2 take C B^T instead, once for all
// heads: warp w its key tile jt = key_tile(w), (B C^T)^T over the query
// tiles it >= jt, each 16 x 16 tile's accumulators written as they lie in
// the registers (lane-major, 32 bytes a lane), the chunk pass's order.
// ---------------------------------------------------------------------------

template <int NC>
__device__ __forceinline__ void cb_block(const Args& g, bf16* bs, bf16* cs) {
  constexpr int CN = NC / 8, KN = NC / 16;
  const int c = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  const int t0 = c * kQ, valid = min(kQ, g.s - t0), ncr = g.n / 8;
  tile_async<kQ, CN, 256>(bs, static_cast<const bf16*>(g.bm) +
                                  bi * g.st.b_b + (long long)t0 * g.st.b_s,
                          g.st.b_s, valid, ncr);
  tile_async<kQ, CN, 256>(cs, static_cast<const bf16*>(g.cm) +
                                  bi * g.st.c_b + (long long)t0 * g.st.c_s,
                          g.st.c_s, valid, ncr);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int jt = key_tile(warp);
  float* out = g.cb + ((long long)bi * g.nc + c) * kTri * 256;
  for (int it = jt; it < kRT; ++it) {
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t a[4], b0, b1, b2, b3;
      ldsm_x4(smem_u32(bs + swz<CN>(jt * 16 + (lane & 15),
                                    2 * kk + (lane >> 4)) * 8),
              a[0], a[1], a[2], a[3]);
      ldsm_x4(smem_u32(cs + swz<CN>(it * 16 + (mi >> 1) * 8 + (lane & 7),
                                    2 * kk + (mi & 1)) * 8),
              b0, b1, b2, b3);
      mma_bf16(sc[0], a, b0, b1);
      mma_bf16(sc[1], a, b2, b3);
    }
    float4* o = reinterpret_cast<float4*>(out + (tri(it, jt) * 32 + lane) * 8);
    o[0] = make_float4(sc[0][0], sc[0][1], sc[0][2], sc[0][3]);
    o[1] = make_float4(sc[1][0], sc[1][1], sc[1][2], sc[1][3]);
  }
}

template <int NC>
constexpr int walk_smem() {
  return 2 * 2 * (kQ * kPC + kQ * NC) + 4 * 8 * kQ;
}

template <int NC>
__global__ void __launch_bounds__(256, 2) ssd_bwd_walk_kernel(Args g) {
  constexpr int CP = kPC / 8, CN = NC / 8;
  constexpr int ST = (kPC / 16) * CN / 8;
  static_assert(ST % 2 == 0 && CN % ST == 0, "state tiles");
  static_assert(2 * kPC * NC <= kQ * NC, "the staged state fits a B tile");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* rs = reinterpret_cast<bf16*>(smem_raw);   // [2][Q][PC] x or dy
  bf16* ys = rs + 2 * kQ * kPC;                    // [2][Q][NC] B or C
  float* wts = reinterpret_cast<float*>(ys + 2 * kQ * NC);   // [8][Q]
  if (blockIdx.z == 2) {
    if ((int)blockIdx.x < g.nc) cb_block<NC>(g, ys, ys + kQ * NC);
    return;
  }
  const int hi = blockIdx.x, bi = blockIdx.y;
  const bool grad = blockIdx.z == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const float a = g.a[hi];
  float* ww = wts + warp * kQ;
  const bf16* rb =
      grad ? static_cast<const bf16*>(g.dy) +
                 ((long long)bi * g.s * g.h + hi) * g.p
           : static_cast<const bf16*>(g.x) + bi * g.st.x_b + hi * g.st.x_h;
  const long long r_s = grad ? (long long)g.h * g.p : g.st.x_s;
  const bf16* yb = grad ? static_cast<const bf16*>(g.cm) + bi * g.st.c_b
                        : static_cast<const bf16*>(g.bm) + bi * g.st.b_b;
  const long long y_s = grad ? g.st.c_s : g.st.b_s;
  const float* dtb = g.dt + bi * g.st.dt_b + hi * g.st.dt_h;
  const int ncr = g.n / 8, pcr = g.p / 8;
  const int mt = warp * ST / CN, nt0 = warp * ST % CN;
  const int steps = g.nc - 1;
  auto chunk_of = [&](int step) { return grad ? g.nc - 1 - step : step; };
  auto fetch = [&](int step) {
    if (step < steps) {
      const int t0 = chunk_of(step) * kQ, valid = min(kQ, g.s - t0);
      tile_async<kQ, CP, 256>(rs + (step & 1) * kQ * kPC, rb + t0 * r_s,
                              r_s, valid, pcr);
      tile_async<kQ, CN, 256>(ys + (step & 1) * kQ * NC, yb + t0 * y_s, y_s,
                              valid, ncr);
    }
    cp_async_commit();
  };
  float sacc[ST][4];
#pragma unroll
  for (int i = 0; i < ST; ++i)
    sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;

  fetch(0);
  for (int step = 0; step < steps; ++step) {
    const int c = chunk_of(step);
    const int t0 = c * kQ, valid = min(kQ, g.s - t0);
    const bf16* xs = rs + (step & 1) * kQ * kPC;
    bf16* bs = ys + (step & 1) * kQ * NC;
    fetch(step + 1);
    float dtv[4];
    double cs[4];
    const double last =
        warp_cumsum(dtb + t0 * g.st.dt_s, g.st.dt_s, valid, a, dtv, cs);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ww[lane * 4 + e] = grad ? expf((float)cs[e])
                              : expf((float)(last - cs[e])) * dtv[e];
    cp_async_wait<1>();
    __syncthreads();              // this chunk's tiles and the weights

    const float dk = expf((float)last);
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      sacc[i][0] *= dk;
      sacc[i][1] *= dk;
      sacc[i][2] *= dk;
      sacc[i][3] *= dk;
    }
#pragma unroll
    for (int kk = 0; kk < kRT; ++kk) {
      // (x o w)^T as the A operand: rows p, k = the chunk's tokens
      uint32_t xr[4], ah[4], al[4];
      ldsm_x4_t(smem_u32(xs + swz<CP>(kk * 16 + (mi >> 1) * 8 + (lane & 7),
                                      2 * mt + (mi & 1)) * 8),
                xr[0], xr[1], xr[2], xr[3]);
      const int j0 = kk * 16 + 2 * tq;
      const float w0 = ww[j0], w1 = ww[j0 + 1];
      const float w2 = ww[j0 + 8], w3 = ww[j0 + 9];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xr[q]));
        split_bf16(f.x * (q < 2 ? w0 : w2), f.y * (q < 2 ? w1 : w3), ah[q],
                   al[q]);
      }
#pragma unroll
      for (int i = 0; i < ST; i += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(bs + swz<CN>(kk * 16 + (mi & 1) * 8 + (lane & 7),
                                        nt0 + i + (mi >> 1)) * 8),
                  b0, b1, b2, b3);
        mma_bf16(sacc[i], ah, b0, b1);
        mma_bf16(sacc[i + 1], ah, b2, b3);
        mma_bf16(sacc[i], al, b0, b1);
        mma_bf16(sacc[i + 1], al, b2, b3);
      }
    }
    __syncthreads();              // the B (or C) tile is spent
    // the state after this chunk, S_{c+1} or G_{c-1} (the gradient of the
    // state after chunk c - 1), split into hi and lo planes [2][PC][NC]
    const int pr = mt * 16 + g8;
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      uint32_t h, l;
      const int o0 = swz<CN>(pr, nt0 + i) * 8 + 2 * tq;
      const int o1 = swz<CN>(pr + 8, nt0 + i) * 8 + 2 * tq;
      split_bf16(sacc[i][0], sacc[i][1], h, l);
      *reinterpret_cast<uint32_t*>(bs + o0) = h;
      *reinterpret_cast<uint32_t*>(bs + kPC * NC + o0) = l;
      split_bf16(sacc[i][2], sacc[i][3], h, l);
      *reinterpret_cast<uint32_t*>(bs + o1) = h;
      *reinterpret_cast<uint32_t*>(bs + kPC * NC + o1) = l;
    }
    __syncthreads();
    bf16* out = state_plane(g, grad, bi, hi, grad ? c - 1 : c + 1);
    for (int idx = threadIdx.x; idx < 2 * g.p * ncr; idx += 256) {
      const int pl = idx / (g.p * ncr), r = idx % (g.p * ncr) / ncr,
                ch = idx % ncr;
      *reinterpret_cast<uint4*>(out + ((long long)pl * g.p + r) * g.n +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(bs + pl * kPC * NC +
                                          swz<CN>(r, ch) * 8);
    }
    __syncthreads();              // the staged state is out
  }
}

// ---------------------------------------------------------------------------
// 2. the chunk pass.  Block (head, chunk, batch) of 8 warps.  Warp w owns
// key tile jt = w (w < 4) or 11 - w: rows j of dx, of B G^T and (as query
// rows i) of C S^T.
// ---------------------------------------------------------------------------

// x and dy [Q][PC], one buffer of B [Q][NC] and G [PC][NC] hi, lo (then of C
// and S), and the float rows: 96 KB at N = 128, so two blocks share an SM
template <int NC>
constexpr int tc_chunk_smem() {
  return 2 * (2 * kQ * kPC + kQ * NC + 2 * kPC * NC) +
         4 * (5 * kQ + kRT * kQ + 3 * kQ + 8);
}

template <int NC>
__global__ void __launch_bounds__(256, 2) ssd_bwd_tc_chunk_kernel(Args g) {
  constexpr int CN = NC / 8, CX = kPC / 8;
  constexpr int KN = NC / 16, KP = kPC / 16, DP = kPC / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);     // [Q][PC] x
  bf16* dys = xs + kQ * kPC;                        // [Q][PC] dy
  bf16* ys = dys + kQ * kPC;                        // [Q][NC] B, then C
  bf16* sth = ys + kQ * NC;                         // [PC][NC] G, then S
  bf16* stl = sth + kPC * NC;                       //          (hi, lo)
  float* csh = reinterpret_cast<float*>(stl + kPC * NC);  // cs, hi + lo
  float* csl = csh + kQ;
  float* dts = csl + kQ;                                  // dt
  float* dec = dts + kQ;                                  // e^(cs_last - cs)
  float* ecs = dec + kQ;                                  // e^cs
  float* rowp = ecs + kQ;        // [kRT][Q] T's row sums, a key tile each
  float* cold = rowp + kRT * kQ; // sum_i (C_i . B_j) l_ij (dy_i . x_j)
  float* xgb = cold + kQ;        // x_j . G B_j
  float* rr = xgb + kQ;          // e^cs_i dy_i . S C_i
  float* red = rr + kQ;          // [8] <G, S> a warp

  const int hi = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int s = g.s, t0 = c * kQ, valid = min(kQ, s - t0);
  const bool has_s = c > 0, has_g = c < g.nc - 1;
  const long long dyr = (long long)g.h * g.p;       // dy's row stride
  const int ncr = g.n / 8, pcr = g.p / 8;
  const long long pn = (long long)g.p * g.n;
  // Y (B or C) and a state's planes (G or S) into the shared buffer
  auto fetch_ys = [&](const void* y, long long b_, long long s_, int which) {
    tile_async<kQ, CN, 256>(ys, static_cast<const bf16*>(y) + bi * b_ +
                                    (long long)t0 * s_,
                            s_, valid, ncr);
    const bf16* sp = state_plane(g, which, bi, hi, c);
    tile_async<kPC, CN, 256>(sth, sp, g.n, g.p, ncr);
    tile_async<kPC, CN, 256>(stl, sp + pn, g.n, g.p, ncr);
  };

  tile_async<kQ, CX, 256>(xs, static_cast<const bf16*>(g.x) + bi * g.st.x_b +
                                  hi * g.st.x_h + (long long)t0 * g.st.x_s,
                          g.st.x_s, valid, pcr);
  tile_async<kQ, CX, 256>(dys, static_cast<const bf16*>(g.dy) +
                                   ((long long)bi * s + t0) * dyr + hi * g.p,
                          dyr, valid, pcr);
  cp_async_commit();
  if (has_g) fetch_ys(g.bm, g.st.b_b, g.st.b_s, 1);
  cp_async_commit();
  if (warp == 0) {
    float dtv[4];
    double cs[4];
    const float* dtb = g.dt + bi * g.st.dt_b + hi * g.st.dt_h +
                       (long long)t0 * g.st.dt_s;
    const double last =
        warp_cumsum(dtb, g.st.dt_s, valid, g.a[hi], dtv, cs);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane * 4 + e;
      split_cs(cs[e], csh[j], csl[j]);
      dts[j] = dtv[e];
      dec[j] = expf((float)(last - cs[e]));
      ecs[j] = expf((float)cs[e]);
    }
  }
  cp_async_wait<1>();
  __syncthreads();                // x, dy and the scan

  // this warp's key tile: (B C^T)^T from the C B^T blocks' scratch and
  // (x dy^T)^T over the query tiles it >= jt; W^T, the sums of T, and dx
  // += W^T dy
  const int jt = key_tile(warp);
  const int j0 = jt * 16 + g8, j1 = j0 + 8;
  const float4* cbt = reinterpret_cast<const float4*>(
      g.cb + ((long long)bi * g.nc + c) * kTri * 256);
  uint32_t xa[KP][4];
#pragma unroll
  for (int kk = 0; kk < KP; ++kk)
    ldsm_x4(smem_u32(xs + swz<CX>(jt * 16 + (lane & 15),
                                  2 * kk + (lane >> 4)) * 8),
            xa[kk][0], xa[kk][1], xa[kk][2], xa[kk][3]);
  float dxa[DP][4];
#pragma unroll
  for (int d = 0; d < DP; ++d)
    dxa[d][0] = dxa[d][1] = dxa[d][2] = dxa[d][3] = 0.f;
  float cd0 = 0.f, cd1 = 0.f;
  const float hj0 = csh[j0], lj0 = csl[j0], hj1 = csh[j1], lj1 = csl[j1];
  const float dt0 = dts[j0], dt1 = dts[j1];
  float4 cbn0 = cbt[(tri(jt, jt) * 32 + lane) * 2];
  float4 cbn1 = cbt[(tri(jt, jt) * 32 + lane) * 2 + 1];
#pragma unroll 1
  for (int it = jt; it < kRT; ++it) {
    float sc[2][4] = {{cbn0.x, cbn0.y, cbn0.z, cbn0.w},
                      {cbn1.x, cbn1.y, cbn1.z, cbn1.w}};
    if (it + 1 < kRT) {           // the next tile's C B^T, early
      cbn0 = cbt[(tri(it + 1, jt) * 32 + lane) * 2];
      cbn1 = cbt[(tri(it + 1, jt) * 32 + lane) * 2 + 1];
    }
    float sd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t b0r, b1r, b2r, b3r;
      ldsm_x4(smem_u32(dys + swz<CX>(it * 16 + (mi >> 1) * 8 + (lane & 7),
                                     2 * kk + (mi & 1)) * 8),
              b0r, b1r, b2r, b3r);
      mma_bf16(sd[0], xa[kk], b0r, b1r);
      mma_bf16(sd[1], xa[kk], b2r, b3r);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = it * 16 + n * 8 + 2 * tq + q;
        const float hi_ = csh[i], li = csl[i];
        // l_ij, masked i < j on the diagonal tile (where exp could
        // overflow)
        const float l0 = it == jt && i < j0 ? 0.f : decay(hi_, li, hj0, lj0);
        const float l1 = it == jt && i < j1 ? 0.f : decay(hi_, li, hj1, lj1);
        const float e0 = sc[n][q] * l0 * sd[n][q];          // (C.B) l (dy.x)
        const float e1 = sc[n][2 + q] * l1 * sd[n][2 + q];
        cd0 += e0;
        cd1 += e1;
        // T_ij = dt_j e, summed over the tile's 16 rows j (lanes of a tq)
        float ts = fmaf(dt1, e1, dt0 * e0);
        ts += __shfl_xor_sync(0xffffffffu, ts, 4);
        ts += __shfl_xor_sync(0xffffffffu, ts, 8);
        ts += __shfl_xor_sync(0xffffffffu, ts, 16);
        if (g8 == 0) rowp[jt * kQ + i] = ts;
        sc[n][q] = sc[n][q] * l0 * dt0;                     // W^T_ji
        sc[n][2 + q] = sc[n][2 + q] * l1 * dt1;
      }
    }
    uint32_t wh[4], wl[4];
    split_frag(sc, wh, wl);
#pragma unroll
    for (int d = 0; d < DP; d += 2) {
      uint32_t b0r, b1r, b2r, b3r;
      ldsm_x4_t(smem_u32(dys + swz<CX>(it * 16 + (mi & 1) * 8 + (lane & 7),
                                       d + (mi >> 1)) * 8),
                b0r, b1r, b2r, b3r);
      mma_bf16(dxa[d], wh, b0r, b1r);
      mma_bf16(dxa[d + 1], wh, b2r, b3r);
      mma_bf16(dxa[d], wl, b0r, b1r);
      mma_bf16(dxa[d + 1], wl, b2r, b3r);
    }
  }
  cd0 += __shfl_xor_sync(0xffffffffu, cd0, 1);
  cd0 += __shfl_xor_sync(0xffffffffu, cd0, 2);
  cd1 += __shfl_xor_sync(0xffffffffu, cd1, 1);
  cd1 += __shfl_xor_sync(0xffffffffu, cd1, 2);
  if (tq == 0) {
    cold[j0] = cd0;
    cold[j1] = cd1;
  }

  // rows jt of Y S^T for the buffer's Y and state (B G^T, then C S^T), P
  // columns
  auto state_rows = [&](float (&t)[DP][4]) {
#pragma unroll
    for (int d = 0; d < DP; ++d) t[d][0] = t[d][1] = t[d][2] = t[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(ys + swz<CN>(jt * 16 + (lane & 15),
                                    2 * kk + (lane >> 4)) * 8),
              a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int d = 0; d < DP; d += 2) {
        const int o = swz<CN>(d * 8 + (mi >> 1) * 8 + (lane & 7),
                              2 * kk + (mi & 1)) * 8;
        uint32_t b0r, b1r, b2r, b3r;
        ldsm_x4(smem_u32(sth + o), b0r, b1r, b2r, b3r);
        mma_bf16(t[d], a, b0r, b1r);
        mma_bf16(t[d + 1], a, b2r, b3r);
        ldsm_x4(smem_u32(stl + o), b0r, b1r, b2r, b3r);
        mma_bf16(t[d], a, b0r, b1r);
        mma_bf16(t[d + 1], a, b2r, b3r);
      }
    }
  };
  // the dot of rows j0, j1 of t with the same rows of a [Q][PC] tile
  auto row_dots = [&](const float (&t)[DP][4], const bf16* v, float& d0,
                      float& d1) {
    d0 = d1 = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      const float2 f0 = __bfloat1622float2(*reinterpret_cast<const
          __nv_bfloat162*>(v + swz<CX>(j0, d) * 8 + 2 * tq));
      const float2 f1 = __bfloat1622float2(*reinterpret_cast<const
          __nv_bfloat162*>(v + swz<CX>(j1, d) * 8 + 2 * tq));
      d0 = fmaf(t[d][1], f0.y, fmaf(t[d][0], f0.x, d0));
      d1 = fmaf(t[d][3], f1.y, fmaf(t[d][2], f1.x, d1));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
  };

  cp_async_wait<0>();
  __syncthreads();                // B and G
  float t[DP][4];
  float q0 = 0.f, q1 = 0.f;
  if (has_g) {                    // dx_j += w_j G B_j; x_j . G B_j
    state_rows(t);
    row_dots(t, xs, q0, q1);
    const float w0 = dec[j0] * dt0, w1 = dec[j1] * dt1;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      dxa[d][0] = fmaf(w0, t[d][0], dxa[d][0]);
      dxa[d][1] = fmaf(w0, t[d][1], dxa[d][1]);
      dxa[d][2] = fmaf(w1, t[d][2], dxa[d][2]);
      dxa[d][3] = fmaf(w1, t[d][3], dxa[d][3]);
    }
  }
  if (tq == 0) {
    xgb[j0] = q0;
    xgb[j1] = q1;
  }
  {
    bf16* dx = static_cast<bf16*>(g.dx) + ((long long)bi * s + t0) * dyr +
               hi * g.p;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      const int p = d * 8 + 2 * tq;
      if (p >= g.p) continue;
      if (j0 < valid)
        *reinterpret_cast<uint32_t*>(dx + j0 * dyr + p) =
            pack_bf16(dxa[d][0], dxa[d][1]);
      if (j1 < valid)
        *reinterpret_cast<uint32_t*>(dx + j1 * dyr + p) =
            pack_bf16(dxa[d][2], dxa[d][3]);
    }
  }
  if (has_s) {                    // C and S into the buffer
    __syncthreads();              // B and G are read
    fetch_ys(g.cm, g.st.c_b, g.st.c_s, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  q0 = q1 = 0.f;
  if (has_s) {                    // dy_i . S C_i
    state_rows(t);
    row_dots(t, dys, q0, q1);
  }
  if (tq == 0) {
    rr[j0] = ecs[j0] * q0;
    rr[j1] = ecs[j1] * q1;
  }
  // <G, S>: S from the buffer, G from its scratch (read just now, in L2);
  // each thread's elements in order, a fixed tree in the warp
  float gs = 0.f;
  if (has_s && has_g) {
    const bf16* gp = state_plane(g, 1, bi, hi, c);
    for (int idx = threadIdx.x; idx < g.p * ncr; idx += 256) {
      const int pr = idx / ncr, ch = idx % ncr;
      const int o = swz<CN>(pr, ch) * 8;
      const long long go = (long long)pr * g.n + ch * 8;
      float fsh[8], fsl[8], fgh[8], fgl[8];
      unpack<bf16>(*reinterpret_cast<const uint4*>(sth + o), fsh);
      unpack<bf16>(*reinterpret_cast<const uint4*>(stl + o), fsl);
      unpack<bf16>(__ldg(reinterpret_cast<const uint4*>(gp + go)), fgh);
      unpack<bf16>(__ldg(reinterpret_cast<const uint4*>(gp + pn + go)), fgl);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        gs = fmaf(fgh[e] + fgl[e], fsh[e] + fsl[e], gs);
    }
  }
  gs = warp_total(gs);
  if (lane == 0) red[warp] = gs;
  __syncthreads();

  // dcs, its reverse cumsum da, ddt and the chunk's term of dA: warp 0,
  // lane l the tokens 4l..4l+3
  if (warp != 0) return;
  float gsum = red[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) gsum += red[w];
  float dcs[4], vs = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = lane * 4 + e;
    float rt = rowp[k];
    for (int q = 1; q <= k / 16; ++q) rt += rowp[q * kQ + k];
    const float v = dec[k] * dts[k] * xgb[k];
    dcs[e] = rt - dts[k] * cold[k] + rr[k] - v;
    vs += v;
  }
  vs = warp_total(vs);
  if (lane == 31) dcs[3] += vs + ecs[kQ - 1] * gsum;
  float run = 0.f;
#pragma unroll
  for (int e = 3; e >= 0; --e) {
    run += dcs[e];
    dcs[e] = run;                 // the suffix within the lane
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float dn = __shfl_down_sync(0xffffffffu, tot, off);
    if (lane + off < 32) tot += dn;
  }
  float excl = __shfl_down_sync(0xffffffffu, tot, 1);
  if (lane == 31) excl = 0.f;
  const float av = g.a[hi];
  float pa = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = lane * 4 + e;
    const float da = dcs[e] + excl;
    if (k < valid)
      g.ddt[((long long)bi * s + t0 + k) * g.h + hi] =
          fmaf(av, da, cold[k] + dec[k] * xgb[k]);
    pa = fmaf(dts[k], da, pa);
  }
  pa = warp_total(pa);
  if (lane == 0) g.part_a[((long long)bi * g.nc + c) * g.h + hi] = pa;
}

// ---------------------------------------------------------------------------
// 3. dB and dC.  Block (head group, dB or dC, batch x chunk) of 8 warps;
// warp w owns 16 rows r = key_tile(w) of the output, rows j of dB or i of
// dC (all N columns, summed over the group's heads in order):
//   dB_j = sum_h [sum_{i >= j} E_ij C_i + (x_j w_j) G]
//   dC_i = sum_h [sum_{j <= i} E_ij B_j + (dy_i e^cs_i) S]
// The warp's 16 x 16 tiles of E are summed over the group's heads in its
// own slots of shared memory (float32, in head order), and multiplied by C
// (or B) once a group; the state term goes into the accumulators head by
// head.
// ---------------------------------------------------------------------------

// the per-head tiles (x, dy, the state) in two stages at N = 128, the next
// head's loading while this one's are used; at N = 64 in one, so that two
// blocks share an SM
template <int NC>
constexpr int kBcStages = NC == 128 ? 2 : 1;

template <int NC>
constexpr int bc_smem() {
  return 2 * (kQ * NC + kBcStages<NC> * (2 * kQ * kPC + 2 * kPC * NC)) +
         4 * 4 * kQ + 4 * kTri * 256;
}

template <int NC>
__global__ void __launch_bounds__(256) ssd_bwd_bc_kernel(Args g) {
  constexpr int CN = NC / 8, CX = kPC / 8, KP = kPC / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int SG = kBcStages<NC>;
  constexpr int STAGE = 2 * kQ * kPC + 2 * kPC * NC;    // a head's tiles
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);     // [Q][NC] C (dB), B (dC)
  // [SG] stages of: x [Q][PC], dy [Q][PC], the state hi and lo [PC][NC]
  // (G for dB, S for dC)
  bf16* stage0 = ys + kQ * NC;
  float* csh = reinterpret_cast<float*>(stage0 + SG * STAGE);   // cs, hi + lo
  float* csl = csh + kQ;
  float* dts = csl + kQ;
  float* wts = dts + kQ;          // dB: w_j; dC: e^cs_i
  float* esum = wts + kQ;         // [kTri][32 lanes][8]: E summed over heads

  const int grp = blockIdx.x, bi = blockIdx.z / g.nc, c = blockIdx.z % g.nc;
  const bool dcb = blockIdx.y == 1;           // dC
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int s = g.s, t0 = c * kQ, valid = min(kQ, s - t0);
  const bool has_st = dcb ? c > 0 : c < g.nc - 1;
  const long long dyr = (long long)g.h * g.p;
  const int ncr = g.n / 8, pcr = g.p / 8;
  const int r = key_tile(warp);
  const int r0 = r * 16 + g8, r1 = r0 + 8;

  {
    const bf16* y0 = dcb ? static_cast<const bf16*>(g.bm) + bi * g.st.b_b +
                               (long long)t0 * g.st.b_s
                         : static_cast<const bf16*>(g.cm) + bi * g.st.c_b +
                               (long long)t0 * g.st.c_s;
    tile_async<kQ, CN, 256>(ys, y0, dcb ? g.st.b_s : g.st.c_s, valid, ncr);
  }
  float acc[CN][4];
#pragma unroll
  for (int d = 0; d < CN; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int h0 = grp * kGroup, h1 = min(g.h, h0 + kGroup);
  // the intra-chunk term over the other index's tiles: j <= i for dC,
  // i >= j for dB
  const int kt0 = dcb ? 0 : r, kt1 = dcb ? r : kRT - 1;
  // issue head h's tiles into its stage (a group, empty past the group)
  auto fetch = [&](int h) {
    if (h < h1) {
      bf16* xs = stage0 + (h - h0) % SG * STAGE;
      bf16* dys = xs + kQ * kPC;
      bf16* sth = dys + kQ * kPC;
      tile_async<kQ, CX, 256>(xs, static_cast<const bf16*>(g.x) +
                                      bi * g.st.x_b + h * g.st.x_h +
                                      (long long)t0 * g.st.x_s,
                              g.st.x_s, valid, pcr);
      tile_async<kQ, CX, 256>(dys, static_cast<const bf16*>(g.dy) +
                                       ((long long)bi * s + t0) * dyr +
                                       h * g.p,
                              dyr, valid, pcr);
      if (has_st) {
        const bf16* sp = state_plane(g, dcb ? 0 : 1, bi, h, c);
        tile_async<kPC, CN, 256>(sth, sp, g.n, g.p, ncr);
        tile_async<kPC, CN, 256>(sth + kPC * NC, sp + (long long)g.p * g.n,
                                 g.n, g.p, ncr);
      }
    }
    cp_async_commit();
  };
  fetch(h0);
  for (int hi = h0; hi < h1; ++hi) {
    const bf16* xs = stage0 + (hi - h0) % SG * STAGE;
    const bf16* dys = xs + kQ * kPC;
    const bf16* sth = dys + kQ * kPC;
    const bf16* stl = sth + kPC * NC;
    // the operand whose rows are the output's (dy for dC, x for dB) and the
    // other one
    const bf16* rows_s = dcb ? dys : xs;
    const bf16* cols_s = dcb ? xs : dys;
    if (SG == 2) fetch(hi + 1);
    if (warp == 0) {
      float dtv[4];
      double cs[4];
      const float* dtb = g.dt + bi * g.st.dt_b + hi * g.st.dt_h +
                         (long long)t0 * g.st.dt_s;
      const double last =
          warp_cumsum(dtb, g.st.dt_s, valid, g.a[hi], dtv, cs);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = lane * 4 + e;
        split_cs(cs[e], csh[j], csl[j]);
        dts[j] = dtv[e];
        wts[j] = dcb ? expf((float)cs[e])
                     : expf((float)(last - cs[e])) * dtv[e];
      }
    }
    if (SG == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    uint32_t ra[KP][4];           // the A fragments of this warp's rows
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      ldsm_x4(smem_u32(rows_s + swz<CX>(r * 16 + (lane & 15),
                                        2 * kk + (lane >> 4)) * 8),
              ra[kk][0], ra[kk][1], ra[kk][2], ra[kk][3]);
    const float hr0 = csh[r0], lr0 = csl[r0], hr1 = csh[r1], lr1 = csl[r1];
    const float dr0 = dts[r0], dr1 = dts[r1];
#pragma unroll 1
    for (int kt = kt0; kt <= kt1; ++kt) {
      float e[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        uint32_t b0r, b1r, b2r, b3r;
        ldsm_x4(smem_u32(cols_s + swz<CX>(kt * 16 + (mi >> 1) * 8 +
                                              (lane & 7),
                                          2 * kk + (mi & 1)) * 8),
                b0r, b1r, b2r, b3r);
        mma_bf16(e[0], ra[kk], b0r, b1r);
        mma_bf16(e[1], ra[kk], b2r, b3r);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = kt * 16 + n * 8 + 2 * tq + q;
          const float hc = csh[col], lc = csl[col];
          float v0, v1;
          if (dcb) {              // E_ij, i = r0 / r1, j = col
            const float dc_ = dts[col];
            v0 = kt == r && col > r0
                     ? 0.f : e[n][q] * decay(hr0, lr0, hc, lc) * dc_;
            v1 = kt == r && col > r1
                     ? 0.f : e[n][2 + q] * decay(hr1, lr1, hc, lc) * dc_;
          } else {                // E_ij, i = col, j = r0 / r1
            v0 = kt == r && col < r0
                     ? 0.f : e[n][q] * decay(hc, lc, hr0, lr0) * dr0;
            v1 = kt == r && col < r1
                     ? 0.f : e[n][2 + q] * decay(hc, lc, hr1, lr1) * dr1;
          }
          e[n][q] = v0;
          e[n][2 + q] = v1;
        }
      }
      float4* slot = reinterpret_cast<float4*>(
          esum + (tri(dcb ? r : kt, dcb ? kt : r) * 32 + lane) * 8);
      if (hi == h0) {
        slot[0] = make_float4(e[0][0], e[0][1], e[0][2], e[0][3]);
        slot[1] = make_float4(e[1][0], e[1][1], e[1][2], e[1][3]);
      } else {
        float4 u = slot[0], v = slot[1];
        u.x += e[0][0];
        u.y += e[0][1];
        u.z += e[0][2];
        u.w += e[0][3];
        v.x += e[1][0];
        v.y += e[1][1];
        v.z += e[1][2];
        v.w += e[1][3];
        slot[0] = u;
        slot[1] = v;
      }
    }
    // the state term: the rows' operand times their weight, split, times
    // the state split (hi hi + hi lo + lo hi)
    if (has_st) {
      const float w0 = wts[r0], w1 = wts[r1];
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        uint32_t ah[4], al[4];
        scale_split(ra[kk], w0, w1, ah, al);
#pragma unroll
        for (int d = 0; d < CN; d += 2) {
          const int o = swz<CN>(kk * 16 + (mi & 1) * 8 + (lane & 7),
                                d + (mi >> 1)) * 8;
          uint32_t h0, h1r, h2, h3, l0, l1, l2, l3;
          ldsm_x4_t(smem_u32(sth + o), h0, h1r, h2, h3);
          ldsm_x4_t(smem_u32(stl + o), l0, l1, l2, l3);
          mma_bf16(acc[d], ah, h0, h1r);
          mma_bf16(acc[d + 1], ah, h2, h3);
          mma_bf16(acc[d], ah, l0, l1);
          mma_bf16(acc[d + 1], ah, l2, l3);
          mma_bf16(acc[d], al, h0, h1r);
          mma_bf16(acc[d + 1], al, h2, h3);
        }
      }
    }
    __syncthreads();              // before the next head's tiles land
    if (SG == 1) fetch(hi + 1);
  }
  // the group's E times C (or B), split: one product a group
#pragma unroll 1
  for (int kt = kt0; kt <= kt1; ++kt) {
    const float4* slot = reinterpret_cast<const float4*>(
        esum + (tri(dcb ? r : kt, dcb ? kt : r) * 32 + lane) * 8);
    const float4 u = slot[0], v = slot[1];
    const float e[2][4] = {{u.x, u.y, u.z, u.w}, {v.x, v.y, v.z, v.w}};
    uint32_t eh[4], el[4];
    split_frag(e, eh, el);
#pragma unroll
    for (int d = 0; d < CN; d += 2) {
      uint32_t b0r, b1r, b2r, b3r;
      ldsm_x4_t(smem_u32(ys + swz<CN>(kt * 16 + (mi & 1) * 8 + (lane & 7),
                                      d + (mi >> 1)) * 8),
                b0r, b1r, b2r, b3r);
      mma_bf16(acc[d], eh, b0r, b1r);
      mma_bf16(acc[d + 1], eh, b2r, b3r);
      mma_bf16(acc[d], el, b0r, b1r);
      mma_bf16(acc[d + 1], el, b2r, b3r);
    }
  }

  float* out = g.part + ((((long long)blockIdx.y * g.b + bi) * g.ng + grp) *
                             s + t0) * g.n;
#pragma unroll
  for (int d = 0; d < CN; ++d) {
    const int n = d * 8 + 2 * tq;
    if (n >= g.n) continue;
    if (r0 < valid)
      *reinterpret_cast<float2*>(out + (long long)r0 * g.n + n) =
          make_float2(acc[d][0], acc[d][1]);
    if (r1 < valid)
      *reinterpret_cast<float2*>(out + (long long)r1 * g.n + n) =
          make_float2(acc[d][2], acc[d][3]);
  }
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

template <typename T>
cudaError_t launch_sums(const Args& g, cudaStream_t st) {
  const long long elems = (long long)g.b * g.s * g.n;
  long long blocks = (elems + kThreads - 1) / kThreads;
  const long long hblocks = (g.h + kThreads - 1) / kThreads;
  if (hblocks > blocks) blocks = hblocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_bwd_sum_kernel<T><<<dim3((unsigned)blocks, 3), kThreads, 0, st>>>(g);
  return cudaGetLastError();
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
  return launch_sums<T>(g, st);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) cudaGetLastError();   // not left to a later check
  return e;
}

// the redesign (bf16, Q = 128, P <= 64); N padded to NC = 64 or 128
template <int NC>
cudaError_t run_tc(const Args& g, cudaStream_t st) {
  cudaError_t e = allow_smem(ssd_bwd_walk_kernel<NC>, walk_smem<NC>());
  if (e == cudaSuccess)
    e = allow_smem(ssd_bwd_tc_chunk_kernel<NC>, tc_chunk_smem<NC>());
  if (e == cudaSuccess) e = allow_smem(ssd_bwd_bc_kernel<NC>, bc_smem<NC>());
  if (e != cudaSuccess) return e;
  // the walks (blockIdx.z 0, 1) and C B^T (blockIdx.z 2, x < nc)
  ssd_bwd_walk_kernel<NC><<<dim3(g.h > g.nc ? g.h : g.nc, g.b, 3), 256,
                            walk_smem<NC>(), st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_tc_chunk_kernel<NC><<<dim3(g.h, g.nc, g.b), 256,
                                tc_chunk_smem<NC>(), st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_bc_kernel<NC><<<dim3(g.ng, 2, g.b * g.nc), 256, bc_smem<NC>(),
                          st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_sums<bf16>(g, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC); dt, A, ddt
// and dA float32.  Strides of x, dt, B and C in elements (their last
// dimensions dense); dy, dx, ddt, dB and dC contiguous; scratch: states of
// (2, b, h, nc, p, n) float32's bytes, part (2, b, groups, s, n), part_a
// (b, nc, h) and, on the redesign, cb (b, nc, 36 x 256) float32, with nc =
// ceil(s / chunk) and groups = ceil(h / 8) on the redesign, h on the first
// design (ops.py::ssd_scan_bwd).  Returns cudaGetLastError() after the last
// launch (0 on success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* dy, void* dx, void* ddt, void* da, void* db,
    void* dc, void* states, void* part, void* part_a, void* cb, int batch,
    int seqlen, int heads, int pdim, int ndim, int chunk, int groups,
    long long x_b,
    long long x_s, long long x_h, long long dt_b, long long dt_s,
    long long dt_h, long long b_b, long long b_s, long long c_b,
    long long c_s, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || seqlen <= 0) return 0;
  if (pdim < 1 || pdim > kMaxDim || ndim < 1 || ndim > kMaxDim ||
      batch > 65535 || heads > 65535 || (chunk != 16 && chunk != 128))
    return (int)cudaErrorInvalidValue;
  // the plain version's chunk is min(chunk, S): a shorter S is one ragged
  // chunk here, masked, which is the same function
  const int nc = (seqlen + chunk - 1) / chunk;
  const bool tc = dtype == 1 && chunk == kQ && pdim <= kPC;
  if (groups != (tc ? (heads + kGroup - 1) / kGroup : heads) ||
      (long long)batch * nc > 65535 || (tc && cb == nullptr))
    return (int)cudaErrorInvalidValue;
  Args g{x, static_cast<const float*>(dt), static_cast<const float*>(a),
         bm, cm, dy, dx, static_cast<float*>(ddt), static_cast<float*>(da),
         db, dc, static_cast<float*>(states), static_cast<float*>(part),
         static_cast<float*>(part_a), static_cast<float*>(cb), batch, seqlen,
         heads, pdim, ndim, nc, groups,
         Strides{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s}};
  cudaStream_t st = (cudaStream_t)stream;
  if (tc) return ndim <= 64 ? (int)run_tc<64>(g, st) : (int)run_tc<128>(g, st);
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
