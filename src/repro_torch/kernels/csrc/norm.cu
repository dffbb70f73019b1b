// RMSNorm of any number of rows, with optional fused prologues, for Hopper
// (sm_90a).
//
//   y = v * rsqrt(mean(v^2) + eps) * w per row of D elements, where v is
//     plain     x;
//     residual  h' = r(h + delta), also written out: the dense block's
//               h + attention(...) before rms_norm(h, ln2);
//     gated     r(r(y + r(r(D_head) xh)) silu(z)), the mamba block's tail:
//               the skip D xh with D cast to y's type, the gate by SiLU of
//               z (silu.cuh), z and xh read in place from their slices.
// r rounds to the element type; each prologue op rounds where the plain
// chain's torch op does (kernels/decode/ref.py), so a fused form gives the
// bits of the plain form applied to its plain prologue's output.
//
// No TPU kernel of the reference does this: the JAX package leaves the norm
// and these element-wise ops to XLA (src/repro/models/layers.py:126 the
// norm, model.py:75-76 the residual, ssm.py:183-185 the gated tail).
//
// Row invariance.  The plan (threads a row T, 16-byte units a thread U,
// rows a block R) comes from D and the type alone
// (kernels/decode/ops.py::norm_plan), never from the number of rows: thread
// t of a row owns units t, t + T, ..., t + (U - 1) T of it (V = 16 / the
// element size elements each), its sum of squares an fmaf chain over them in
// that order; a fixed xor tree in the warp; the row's warps in order.  A
// row gets the same bits alone, in a decode batch of 4, or among a
// prefill's 2048 rows.  The loads are 16-byte ones where every operand's
// rows are whole aligned units, single elements otherwise; the arithmetic
// is the same.
//
// Bound on this card: bytes (each input read once, each output written
// once), and below a few hundred KB the launch itself.  The design reads
// each input once, holds the row's prologue output in registers (up to
// 8 units a thread, 512 threads a row: D up to 32768 bf16 elements), and
// gives a decode step's tiny rows one round trip to memory; fusing the
// prologues saves their launches and intermediate tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "silu.cuh"

namespace {

enum Mode { kPlain = 0, kResidual = 1, kGated = 2 };

// Elements [j, j + V) of a row as floats: one 16-byte load, or V single
// ones (each below n, zero past it).
template <typename T, bool VEC>
__device__ __forceinline__ void load(const T* row, int j, int n, float* f) {
  constexpr int V = Unit<T>::n;
  if constexpr (VEC) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + j));
    const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = to_f<T>(h[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = j + e < n ? to_f<T>(row[j + e]) : 0.f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store(T* row, int j, int n, const float* f) {
  constexpr int V = Unit<T>::n;
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(row + j) = pack<T>(f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (j + e < n) row[j + e] = from_f<T>(f[e]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct NormArgs {
  const void* x;     // plain: x; residual: h; gated: y
  long long xs;
  const void* a;     // residual: delta; gated: xh
  long long as;
  const void* z;     // gated: z
  long long zs;
  const float* dv;   // gated: D (heads,) float32
  int p;             // gated: elements a head
  const void* w;     // (D,)
  void* out;         // (M, D) contiguous
  void* hout;        // residual: (M, D) contiguous
  int m, d, tpr;     // rows, D, threads a row
  float eps;
};

template <typename T, int MODE, int U, bool VEC>
__global__ void __launch_bounds__(512)
rms_norm_rows_kernel(NormArgs g) {
  constexpr int V = Unit<T>::n;
  __shared__ float part[32];
  const int tpr = g.tpr;
  const int rpb = blockDim.x / tpr;               // rows a block
  const int lr = threadIdx.x / tpr;               // the row in the block
  const int t = threadIdx.x - lr * tpr;           // the thread in the row
  const int warps = tpr >> 5;
  const int row = blockIdx.x * rpb + lr;
  const bool live = row < g.m;
  const int units = (g.d + V - 1) / V;

  const T* w = static_cast<const T*>(g.w);
  float v[U][V];
  uint4 wr[VEC ? U : 1];          // the weight's units, loaded beside x's
  float ss = 0.f;
  if (live) {
    const T* x = static_cast<const T*>(g.x) + (long long)row * g.xs;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = t + k * tpr;
      if (u >= units) break;
      const int j = u * V;
      if constexpr (VEC) wr[k] = __ldg(reinterpret_cast<const uint4*>(w + j));
      load<T, VEC>(x, j, g.d, v[k]);
      if constexpr (MODE == kResidual) {
        float dl[V];
        load<T, VEC>(static_cast<const T*>(g.a) + (long long)row * g.as, j,
                     g.d, dl);
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = __fadd_rn(v[k][e], dl[e]);
        round_n<T, V>(v[k]);
        store<T, VEC>(static_cast<T*>(g.hout) + (long long)row * g.d, j, g.d,
                      v[k]);
      } else if constexpr (MODE == kGated) {
        float xh[V], zz[V];
        load<T, VEC>(static_cast<const T*>(g.a) + (long long)row * g.as, j,
                     g.d, xh);
        load<T, VEC>(static_cast<const T*>(g.z) + (long long)row * g.zs, j,
                     g.d, zz);
        silu_n<T, V>(zz);
        float dh[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          // VEC units never straddle a head (p a multiple of V)
          const int head = VEC ? j / g.p : (j + e) / g.p;
          dh[e] = j + e < g.d ? __ldg(g.dv + head) : 0.f;
        }
        round_n<T, V>(dh);                      // D cast to y's type
#pragma unroll
        for (int e = 0; e < V; ++e) xh[e] = __fmul_rn(dh[e], xh[e]);
        round_n<T, V>(xh);
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = __fadd_rn(v[k][e], xh[e]);
        round_n<T, V>(v[k]);
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = __fmul_rn(v[k][e], zz[e]);
        round_n<T, V>(v[k]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(v[k][e], v[k][e], ss);
    }
  }
  ss = warp_sum(ss);
  if ((t & 31) == 0) part[lr * warps + (t >> 5)] = ss;
  __syncthreads();
  if (!live) return;
  float s = part[lr * warps];
  for (int q = 1; q < warps; ++q) s += part[lr * warps + q];
  const float r = rsqrtf(s / (float)g.d + g.eps);

  T* o = static_cast<T*>(g.out) + (long long)row * g.d;
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int u = t + k * tpr;
    if (u >= units) break;
    const int j = u * V;
    float wv[V];
    if constexpr (VEC) {
      const T* h = reinterpret_cast<const T*>(&wr[k]);
#pragma unroll
      for (int e = 0; e < V; ++e) wv[e] = to_f<T>(h[e]);
    } else {
      load<T, VEC>(w, j, g.d, wv);
    }
#pragma unroll
    for (int e = 0; e < V; ++e)
      v[k][e] = __fmul_rn(__fmul_rn(v[k][e], r), wv[e]);
    store<T, VEC>(o, j, g.d, v[k]);
  }
}

template <typename T, int MODE, int U>
cudaError_t launch_u(const NormArgs& g, int threads, bool vec,
                     cudaStream_t st) {
  const int rpb = threads / g.tpr;
  const int blocks = (g.m + rpb - 1) / rpb;
  if (vec)
    rms_norm_rows_kernel<T, MODE, U, true><<<blocks, threads, 0, st>>>(g);
  else
    rms_norm_rows_kernel<T, MODE, U, false><<<blocks, threads, 0, st>>>(g);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_mode(const NormArgs& g, int upt, int threads, bool vec,
                        cudaStream_t st) {
  if (upt <= 1) return launch_u<T, MODE, 1>(g, threads, vec, st);
  if (upt <= 2) return launch_u<T, MODE, 2>(g, threads, vec, st);
  if (upt <= 4) return launch_u<T, MODE, 4>(g, threads, vec, st);
  return launch_u<T, MODE, 8>(g, threads, vec, st);
}

template <typename T>
cudaError_t launch_norm(const NormArgs& g, int mode, int upt, int threads,
                        bool vec, cudaStream_t st) {
  if (mode == kPlain) return launch_mode<T, kPlain>(g, upt, threads, vec, st);
  if (mode == kResidual)
    return launch_mode<T, kResidual>(g, upt, threads, vec, st);
  return launch_mode<T, kGated>(g, upt, threads, vec, st);
}

bool whole_units(const void* p, long long stride, int v) {
  return p == nullptr || ((uintptr_t)p % 16 == 0 && stride % v == 0);
}

}  // namespace

// mode: 0 plain, 1 residual, 2 gated; dtype: 0 = float32, 1 = bfloat16.
// x (plain x, residual h, gated y), a (residual delta, gated xh) and z
// (gated) are rows of d elements at their row strides, dense along the
// row; dv (gated D, float32) and p (its head size); w (d,); out and hout
// (residual h + delta) contiguous (m, d).  The plan (tpr threads a row,
// upt units a thread at most, threads a block) is ops.py::norm_plan's.
// Returns cudaGetLastError() after the launch.
extern "C" int rms_norm_rows_launch(
    int mode, const void* x, long long xs, const void* a, long long as,
    const void* z, long long zs, const float* dv, int p, const void* w,
    void* out, void* hout, int m, int d, int tpr, int upt, int threads,
    float eps, int dtype, void* stream) {
  if (m <= 0) return 0;
  const int v = dtype == 1 ? 8 : 4;
  const int units = (d + v - 1) / v;
  if (d <= 0 || mode < kPlain || mode > kGated || tpr < 32 || tpr % 32 ||
      threads % tpr || threads > 512 || upt < 1 || upt > 8 ||
      (long long)tpr * upt < units || (mode == kGated && p <= 0) ||
      (mode != kPlain && a == nullptr) || (mode == kGated && z == nullptr) ||
      (mode == kResidual && hout == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = d % v == 0 && whole_units(x, xs, v) &&
                   whole_units(a, as, v) && whole_units(z, zs, v) &&
                   whole_units(w, 0, v) && whole_units(out, 0, v) &&
                   whole_units(hout, 0, v) && (mode != kGated || p % v == 0);
  const NormArgs g{x, xs, a, as, z, zs, dv, p, w, out, hout, m, d, tpr, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_norm<float>(g, mode, upt, threads, vec,
                                                 st);
  if (dtype == 1)
    return (int)launch_norm<__nv_bfloat16>(g, mode, upt, threads, vec, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
