// Mamba2 SSD chunk scan (state-space duality, arXiv:2405.21060) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py `_ssd_kernel`,
// launched by `ssd_pallas` and wrapped by `ssd/ops.py` `ssd_scan`.
//
// Function, from a zero state, for each (batch b, head h), chunk by chunk of
// Q tokens in order, with the (P, N) float32 state carried across chunks:
//     cs      = cumsum(dt * A)                    over the chunk
//     y_i     = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//             + (C_i . state[p]) exp(cs_i)        for every column p
//     state <- state * exp(cs_last) + sum_j (x_j dt_j exp(cs_last - cs_j)) B_j
// x (B, S, H, P), dt (B, S, H) float32, A (H,) float32, B/C (B, S, N)
// shared by all heads; y (B, S, H, P) in x's type, the final state
// (B, H, P, N) float32.  x, dt, B and C are read in place through strides
// (the model hands views of its convolution output; the last dimension must
// be dense and every row 16-byte aligned), so no transposed or padded copy
// is made.  A ragged last chunk
// is masked in the kernel: steps past S read dt = x = B = C = 0, so they
// decay by 1, add nothing to the state, and write no output.
//
// Design for the GPU rather than a copy of the TPU blocks.  Pallas carried
// the state in VMEM scratch across a sequential grid axis; here one thread
// block owns one (b, h) and runs the chunk loop itself, the state living in
// shared memory for the whole sequence.  The TPU kept x, B, C, the state and
// the (Q, Q) mask in 0.35 MB of VMEM; a Hopper block has 227 KB, so the
// (Q, Q) matrix C B^T o L is never built.  Instead the intra-chunk term is
// computed like causal linear attention: two threads share a query row i,
// each holding one half of C_i and of the row's output in registers; for
// each key j the two half dot products C_i . B_j meet through one warp
// shuffle, and the weight is masked (j > i) before exp is taken, since
// above the diagonal cs_i - cs_j > 0 and exp could overflow into
// inf * 0 = NaN.  Shared memory holds the chunk's B (Q x N), dt_j x_j
// (Q x P) and the state (P x N) in float32: 129 KB at the mamba2-1.3b shape
// (Q = N = 128, P = 64), 194 KB at P = N = 128.  The inter-chunk term goes
// through the dt x buffer as scratch before the chunk's x is loaded, so it
// needs no room of its own.  Register arrays are sized by the size class of
// N and P (32, 64 or 128), padded rows and columns held at zero in shared
// memory, so no loop needs a guard.  Every read of shared memory in the
// products is 16 bytes wide, and the state update gives each thread 4 x 8
// tiles of the state, so three reads feed 32 FMAs.  Device memory is read
// and written 16 bytes at a time.
//
// Bound on this card: at the mamba2-1.3b prefill shape (B = 4, S = 512,
// H = 64, P = 64, N = 128, Q = 128, bf16 x/B/C) the function needs the
// causal halves of C B^T (2.16 GFLOP on bf16 inputs, 0.002 ms at the bf16
// rate) and of its product with x, C state^T past the first chunk and the
// state update (4.84 GFLOP with float32 operands, 0.072 ms at the float32
// rate), against 43.5 MB moved, 0.013 ms at 3.35 TB/s: operations bound
// it at 0.072 ms.  This kernel does scalar float32 FMA work (true float32,
// which the float32 tests need at 2e-4; TF32 would not meet it) with one
// block of 2Q threads per SM, so FMA issue and latency at that occupancy
// limit it; and a warp owns 16 consecutive query rows, so in the causal
// term the warp of the last rows walks all Q keys while the first walks 16,
// and the block waits for the slowest.  Moving the products onto the
// tensor cores, balancing the causal term across warps and splitting P
// across blocks for occupancy is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// 16 bytes of T as E floats, and E floats back (rounded to nearest even).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// Element strides of the inputs; every last dimension is dense.
struct Strides {
  long long x_b, x_s, x_h;
  long long dt_b, dt_s, dt_h;
  long long b_b, b_s;
  long long c_b, c_s;
};

template <int Q, int NC, int PC>
constexpr int smem_floats() {
  return Q * NC + Q * PC + PC * NC + 3 * Q;
}

template <typename T, int Q, int NC, int PC>
__global__ void __launch_bounds__(2 * Q)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ state, int seqlen, int heads, int pdim,
                int ndim, Strides st) {
  constexpr int kThreads = 2 * Q;
  constexpr int NH = NC / 2, PH = PC / 2;   // a thread's half of N and P
  constexpr int E = Vec<T>::E;              // elements per 16-byte access
  extern __shared__ float4 smem4[];         // 16-byte aligned rows
  float* smem = reinterpret_cast<float*>(smem4);
  float* bs = smem;               // [Q][NC]  the chunk's B
  float* vs = bs + Q * NC;        // [Q][PC]  dt_j x_j (first: y_off scratch)
  float* sts = vs + Q * PC;       // [PC][NC] the state
  float* cs = sts + PC * NC;      // [Q]      cumsum(dt * A)
  float* ws = cs + Q;             // [Q]      exp(cs_last - cs_j)
  float* dts = ws + Q;            // [Q]      dt_j

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = tid >> 1;       // query row of the chunk
  const int half = tid & 1;       // which half of N and of P
  // the warp's 16 rows end here: the causal key loop stops there, and the
  // bound is the same for every lane, as the shuffles need
  const int key_end = min(Q, ((tid >> 5) << 4) + 16);
  const float a = A[h];

  const T* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* bb = bm + b * st.b_b;
  const T* cb = cm + b * st.c_b;
  const long long y_row = (long long)heads * pdim;
  T* yb = y + ((long long)b * seqlen * heads + h) * pdim;

  // zero state; padded rows and columns stay zero throughout
  for (int e = tid; e < PC * NC; e += kThreads) sts[e] = 0.f;

  const int n_chunks = (seqlen + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int valid = min(Q, seqlen - t0);
    const bool live = row < valid;

    // dt of the chunk, and this thread's half of its C row
    if (tid < Q) dts[tid] = tid < valid ? dtb[(t0 + tid) * st.dt_s] : 0.f;
    float cr[NH];
    const T* crow = cb + (t0 + row) * st.c_s + half * NH;
#pragma unroll
    for (int v = 0; v < NH / E; ++v) {
      if (live && half * NH + v * E < ndim) {
        Vec<T>::load(crow + v * E, cr + v * E);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) cr[v * E + i] = 0.f;
      }
    }
    __syncthreads();
    if (tid == 0) {                 // in token order, as the plain cumsum
      float run = 0.f;
      for (int j = 0; j < Q; ++j) {
        run += __fmul_rn(dts[j], a);
        cs[j] = run;
      }
    }
    __syncthreads();
    const float cs_row = cs[row];
    const float decay = expf(cs[Q - 1]);
    if (tid < Q) ws[tid] = expf(cs[Q - 1] - cs[tid]);

    // inter-chunk term (C_i . state[p]) exp(cs_i), zero from a zero state;
    // both threads of a row get each full dot product, the owner of
    // column p keeps it, through the dt x buffer before x is loaded
    float acc[PH];
#pragma unroll
    for (int k = 0; k < PH; ++k) acc[k] = 0.f;
    if (c > 0) {
      const float e_row = expf(cs_row);
      for (int p = 0; p < pdim; ++p) {
        const float4* sr =
            reinterpret_cast<const float4*>(sts + p * NC + half * NH);
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);   // four FMA chains
#pragma unroll
        for (int m = 0; m < NH / 4; ++m) {
          const float4 v = sr[m];
          q.x = fmaf(cr[4 * m], v.x, q.x);
          q.y = fmaf(cr[4 * m + 1], v.y, q.y);
          q.z = fmaf(cr[4 * m + 2], v.z, q.z);
          q.w = fmaf(cr[4 * m + 3], v.w, q.w);
        }
        float part = (q.x + q.y) + (q.z + q.w);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (p / PH == half) vs[row * PC + p] = part * e_row;
      }
      __syncthreads();
      const float4* ar =
          reinterpret_cast<const float4*>(vs + row * PC + half * PH);
#pragma unroll
      for (int k = 0; k < PH / 4; ++k) {
        const float4 v = ar[k];
        acc[4 * k] = v.x;
        acc[4 * k + 1] = v.y;
        acc[4 * k + 2] = v.z;
        acc[4 * k + 3] = v.w;
      }
    }
    __syncthreads();

    // the chunk's B and dt_j x_j, zero past S, N and P; 16 bytes a load
#pragma unroll
    for (int r = 0; r < NC / (2 * E); ++r) {       // Q * NC / E in all
      const int e = tid + r * kThreads;
      const int j = e / (NC / E), n = (e % (NC / E)) * E;
      float f[E];
      if (j < valid && n < ndim) {
        Vec<T>::load(bb + (t0 + j) * st.b_s + n, f);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < E; i += 4) Vec<float>::store(bs + j * NC + n + i,
                                                       f + i);
    }
#pragma unroll
    for (int r = 0; r < PC / (2 * E); ++r) {       // Q * PC / E in all
      const int e = tid + r * kThreads;
      const int j = e / (PC / E), p = (e % (PC / E)) * E;
      float f[E];
      if (j < valid && p < pdim) {
        Vec<T>::load(xb + (t0 + j) * st.x_s + p, f);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < E; ++i) f[i] *= dts[j];
#pragma unroll
      for (int i = 0; i < E; i += 4) Vec<float>::store(vs + j * PC + p + i,
                                                       f + i);
    }
    __syncthreads();

    // intra-chunk term over keys j <= row
    for (int j = 0; j < key_end; ++j) {
      const float4* br =
          reinterpret_cast<const float4*>(bs + j * NC + half * NH);
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);     // four FMA chains
#pragma unroll
      for (int m = 0; m < NH / 4; ++m) {
        const float4 v = br[m];
        q.x = fmaf(cr[4 * m], v.x, q.x);
        q.y = fmaf(cr[4 * m + 1], v.y, q.y);
        q.z = fmaf(cr[4 * m + 2], v.z, q.z);
        q.w = fmaf(cr[4 * m + 3], v.w, q.w);
      }
      float g = (q.x + q.y) + (q.z + q.w);
      g += __shfl_xor_sync(0xffffffffu, g, 1);
      if (j <= row) {               // masked before exp (see the header)
        const float wgt = g * expf(cs_row - cs[j]);
        const float4* vr =
            reinterpret_cast<const float4*>(vs + j * PC + half * PH);
#pragma unroll
        for (int k = 0; k < PH / 4; ++k) {
          const float4 v = vr[k];
          acc[4 * k] = fmaf(wgt, v.x, acc[4 * k]);
          acc[4 * k + 1] = fmaf(wgt, v.y, acc[4 * k + 1]);
          acc[4 * k + 2] = fmaf(wgt, v.z, acc[4 * k + 2]);
          acc[4 * k + 3] = fmaf(wgt, v.w, acc[4 * k + 3]);
        }
      }
    }
    if (live) {
      T* yr = yb + (t0 + row) * y_row + half * PH;
#pragma unroll
      for (int v = 0; v < PH / E; ++v)
        if (half * PH + v * E < pdim) Vec<T>::store(yr + v * E, acc + v * E);
    }
    __syncthreads();

    // state <- state * exp(cs_last) + sum_j (dt_j x_j exp(cs_last - cs_j)) B_j
    for (int e = tid; e < Q * PC; e += kThreads) vs[e] *= ws[e / PC];
    __syncthreads();
    // each thread owns 4 x 8 tiles of the (padded) state: per key, three
    // 16-byte reads feed 32 FMAs
    constexpr int kTilesN = NC / 8;
    for (int t = tid; t < (PC / 4) * kTilesN; t += kThreads) {
      const int p0 = (t / kTilesN) * 4, n0 = (t % kTilesN) * 8;
      float s[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) s[u][w] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(vs + j * PC + p0);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + j * NC + n0);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + j * NC + n0 + 4);
        const float vv[4] = {v.x, v.y, v.z, v.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 8; ++w) s[u][w] = fmaf(vv[u], bv[w], s[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float* sp = sts + (p0 + u) * NC + n0;
#pragma unroll
        for (int w = 0; w < 8; ++w) sp[w] = sp[w] * decay + s[u][w];
      }
    }
    __syncthreads();
  }

  float* so = state + ((long long)b * heads + h) * pdim * ndim;
  for (int e = tid; e < pdim * ndim; e += kThreads) {
    const int p = e / ndim;
    so[e] = sts[p * NC + (e - p * ndim)];
  }
}

struct Args {
  const void* x;
  const void* dt;
  const void* a;
  const void* bm;
  const void* cm;
  void* y;
  void* state;
  int batch, seqlen, heads, pdim, ndim;
  Strides st;
};

template <typename T, int Q, int NC, int PC>
int launch(const Args& g, cudaStream_t stream) {
  const int smem = smem_floats<Q, NC, PC>() * (int)sizeof(float);
  auto kern = ssd_scan_kernel<T, Q, NC, PC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.heads, g.batch);
  kern<<<grid, 2 * Q, smem, stream>>>(
      (const T*)g.x, (const float*)g.dt, (const float*)g.a, (const T*)g.bm,
      (const T*)g.cm, (T*)g.y, (float*)g.state, g.seqlen, g.heads, g.pdim,
      g.ndim, g.st);
  return (int)cudaGetLastError();
}

// size class of N or P: the register arrays hold half of it
int size_class(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <typename T, int Q, int NC>
int dispatch_p(const Args& g, cudaStream_t s) {
  switch (size_class(g.pdim)) {
    case 32: return launch<T, Q, NC, 32>(g, s);
    case 64: return launch<T, Q, NC, 64>(g, s);
    default: return launch<T, Q, NC, 128>(g, s);
  }
}

template <typename T, int Q>
int dispatch_n(const Args& g, cudaStream_t s) {
  switch (size_class(g.ndim)) {
    case 32: return dispatch_p<T, Q, 32>(g, s);
    case 64: return dispatch_p<T, Q, 64>(g, s);
    default: return dispatch_p<T, Q, 128>(g, s);
  }
}

template <typename T>
int dispatch_q(const Args& g, int chunk, cudaStream_t s) {
  switch (chunk) {
    case 16: return dispatch_n<T, 16>(g, s);
    case 128: return dispatch_n<T, 128>(g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; chunk: 16 or 128 (the
// configs' chunk lengths); P, N <= 128.  x, B, C and y are accessed 16
// bytes at a time, so their pointers must be 16-byte aligned and P, N and
// their row strides multiples of 16 bytes.  Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               void* state, int batch, int seqlen, int heads,
                               int pdim, int ndim, int chunk, long long x_b,
                               long long x_s, long long x_h, long long dt_b,
                               long long dt_s, long long dt_h, long long b_b,
                               long long b_s, long long c_b, long long c_s,
                               int dtype, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (seqlen < 0 || pdim < 1 || pdim > 128 || ndim < 1 || ndim > 128 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  Args g{x, dt, a, bm, cm, y, state, batch, seqlen, heads, pdim, ndim,
         Strides{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s}};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_q<float>(g, chunk, st);
  if (dtype == 1) return dispatch_q<__nv_bfloat16>(g, chunk, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
