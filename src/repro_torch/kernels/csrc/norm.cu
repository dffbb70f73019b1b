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
// The gated form's backward (gated_rms_norm_bwd_launch) is three launches
// of this file's kernels; it replaces no TPU kernel either: the reference
// gets these gradients from JAX autodiff of the same expressions.
//   1. a row pass in the norm's plan: v = (y + D xh) silu(z) recomputed
//      with the forward's roundings, its sum of squares in the forward's
//      order (so r = rsqrt(mean v^2 + eps) is the forward's), then the
//      float32 sum of dn n (n = v r, dn = g w) in the same order, dv =
//      r (dn - n mean(dn n)) rounded to the type, and from it dy = r(dv
//      silu(z)), dxh = r(dy r(D)), dz = r(r(dv (y + D xh)) silu'(z)),
//      silu'(z) = s (1 + z (1 - s)) in float32; r is kept a row;
//   2. column partials of dw = sum g n and of dy xh over kRowsPart rows
//      each (v recomputed element by element, the same bits);
//   3. their sums over the row slices in order: dw, rounded to the type,
//      and dD a head, over its columns in order.
// Every sum has one owner and a fixed order: two runs give the same bits.
// Bound on this card: bytes, the row pass reading y, xh, z, g once and
// writing dy, dxh, dz; the column pass reads y, xh, z, g and dy again.
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

// ---------------------------------------------------------------------------
// the gated norm's backward
// ---------------------------------------------------------------------------

struct GatedBwdArgs {
  const void* y;
  long long ys;
  const void* xh;
  long long xs;
  const void* z;
  long long zs;
  const float* dv;   // D (heads,) float32
  int p;             // elements a head
  const void* w;     // (d,)
  const void* g;     // (m, d) contiguous
  void* dy;          // (m, d) contiguous, as dxh and dz
  void* dxh;
  void* dz;
  float* rinv;       // (m,)
  float* part;       // (slices, 2, d)
  void* dw;          // (d,)
  float* dD;         // (heads,)
  int m, d, tpr, rows, heads;
  float eps;
};

// The forward's prologue on V elements [j, j + V) of one row: yy = r(y +
// r(r(D) xh)) and sz = silu(z), their product v = r(yy sz).
template <typename T, bool VEC>
__device__ __forceinline__ void gated_prologue(const GatedBwdArgs& a,
                                               long long row, int j, float* yy,
                                               float* sz, float* v) {
  constexpr int V = Unit<T>::n;
  float xh[V], dh[V];
  load<T, VEC>(static_cast<const T*>(a.y) + row * a.ys, j, a.d, yy);
  load<T, VEC>(static_cast<const T*>(a.xh) + row * a.xs, j, a.d, xh);
  load<T, VEC>(static_cast<const T*>(a.z) + row * a.zs, j, a.d, sz);
  silu_n<T, V>(sz);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int head = VEC ? j / a.p : (j + e) / a.p;
    dh[e] = j + e < a.d ? __ldg(a.dv + head) : 0.f;
  }
  round_n<T, V>(dh);
#pragma unroll
  for (int e = 0; e < V; ++e) xh[e] = __fmul_rn(dh[e], xh[e]);
  round_n<T, V>(xh);
#pragma unroll
  for (int e = 0; e < V; ++e) yy[e] = __fadd_rn(yy[e], xh[e]);
  round_n<T, V>(yy);
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = __fmul_rn(yy[e], sz[e]);
  round_n<T, V>(v);
}

// gated_prologue's v for the one element j of a row, the same arithmetic
template <typename T>
__device__ __forceinline__ float gated_v(const GatedBwdArgs& a, long long row,
                                         int j) {
  float yy[1] = {to_f<T>(static_cast<const T*>(a.y)[row * a.ys + j])};
  float xh[1] = {to_f<T>(static_cast<const T*>(a.xh)[row * a.xs + j])};
  float sz[1] = {to_f<T>(static_cast<const T*>(a.z)[row * a.zs + j])};
  float dh[1] = {__ldg(a.dv + j / a.p)};
  silu_n<T, 1>(sz);
  round_n<T, 1>(dh);
  xh[0] = __fmul_rn(dh[0], xh[0]);
  round_n<T, 1>(xh);
  yy[0] = __fadd_rn(yy[0], xh[0]);
  round_n<T, 1>(yy);
  yy[0] = __fmul_rn(yy[0], sz[0]);
  round_n<T, 1>(yy);
  return yy[0];
}

// the row's total of v over its threads, in the forward's order
__device__ __forceinline__ float row_total(float v, float* part, int lr,
                                           int t, int warps) {
  v = warp_sum(v);
  if ((t & 31) == 0) part[lr * warps + (t >> 5)] = v;
  __syncthreads();
  float s = part[lr * warps];
  for (int q = 1; q < warps; ++q) s += part[lr * warps + q];
  __syncthreads();
  return s;
}

template <typename T, int U, bool VEC>
__global__ void __launch_bounds__(512)
gated_bwd_rows_kernel(GatedBwdArgs a) {
  constexpr int V = Unit<T>::n;
  __shared__ float part[32];
  const int tpr = a.tpr;
  const int rpb = blockDim.x / tpr;
  const int lr = threadIdx.x / tpr;
  const int t = threadIdx.x - lr * tpr;
  const int warps = tpr >> 5;
  const long long row = (long long)blockIdx.x * rpb + lr;
  const bool live = row < a.m;
  const int units = (a.d + V - 1) / V;
  const T* w = static_cast<const T*>(a.w);
  const T* g = static_cast<const T*>(a.g) + row * a.d;

  float v[U][V];
  float ss = 0.f;
  if (live) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = t + k * tpr;
      if (u >= units) break;
      float yy[V], sz[V];
      gated_prologue<T, VEC>(a, row, u * V, yy, sz, v[k]);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(v[k][e], v[k][e], ss);
    }
  }
  const float r = rsqrtf(row_total(ss, part, lr, t, warps) / (float)a.d +
                         a.eps);
  float dot = 0.f;
  if (live) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = t + k * tpr;
      if (u >= units) break;
      float gv[V], wv[V];
      load<T, VEC>(g, u * V, a.d, gv);
      load<T, VEC>(w, u * V, a.d, wv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        dot = fmaf(gv[e] * wv[e], v[k][e] * r, dot);
    }
  }
  const float mean = row_total(dot, part, lr, t, warps) / (float)a.d;
  if (!live) return;
  if (t == 0) a.rinv[row] = r;
  T* dy = static_cast<T*>(a.dy) + row * a.d;
  T* dxh = static_cast<T*>(a.dxh) + row * a.d;
  T* dz = static_cast<T*>(a.dz) + row * a.d;
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int u = t + k * tpr;
    if (u >= units) break;
    const int j = u * V;
    float yy[V], sz[V], vv[V], gv[V], wv[V], zr[V], dh[V];
    gated_prologue<T, VEC>(a, row, j, yy, sz, vv);
    load<T, VEC>(g, j, a.d, gv);
    load<T, VEC>(w, j, a.d, wv);
    load<T, VEC>(static_cast<const T*>(a.z) + row * a.zs, j, a.d, zr);
    float dvr[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float n = v[k][e] * r;
      dvr[e] = r * (gv[e] * wv[e] - n * mean);
    }
    round_n<T, V>(dvr);
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = __fmul_rn(dvr[e], sz[e]);  // dy
    round_n<T, V>(o);
    store<T, VEC>(dy, j, a.d, o);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int head = VEC ? j / a.p : (j + e) / a.p;
      dh[e] = j + e < a.d ? __ldg(a.dv + head) : 0.f;
    }
    round_n<T, V>(dh);
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = __fmul_rn(o[e], dh[e]);    // dxh
    round_n<T, V>(o);
    store<T, VEC>(dxh, j, a.d, o);
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = __fmul_rn(dvr[e], yy[e]);  // gate
    round_n<T, V>(o);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float s = 1.0f / (1.0f + expf(-zr[e]));
      o[e] = o[e] * (s * (1.0f + zr[e] * (1.0f - s)));
    }
    round_n<T, V>(o);
    store<T, VEC>(dz, j, a.d, o);
  }
}

// Column partials: thread j of block (x, slice) sums rows [slice R,
// slice R + R) of g n and dy xh at column j, in row order.
template <typename T>
__global__ void __launch_bounds__(256)
gated_bwd_cols_kernel(GatedBwdArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.d) return;
  const long long r0 = (long long)blockIdx.y * a.rows;
  const long long r1 = r0 + a.rows < a.m ? r0 + a.rows : a.m;
  const T* g = static_cast<const T*>(a.g);
  const T* dy = static_cast<const T*>(a.dy);
  const T* xh = static_cast<const T*>(a.xh);
  float sw = 0.f, sd = 0.f;
  for (long long row = r0; row < r1; ++row) {
    const float v = gated_v<T>(a, row, j);
    sw = fmaf(to_f<T>(g[row * a.d + j]), v * a.rinv[row], sw);
    sd = fmaf(to_f<T>(dy[row * a.d + j]), to_f<T>(xh[row * a.xs + j]), sd);
  }
  float* out = a.part + (long long)blockIdx.y * 2 * a.d;
  out[j] = sw;
  out[a.d + j] = sd;
}

// The sums over the slices: dw a column (blockIdx.y 0), dD a head over its
// columns in order (blockIdx.y 1).
template <typename T>
__global__ void __launch_bounds__(256)
gated_bwd_sum_kernel(GatedBwdArgs a, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.y == 0) {
    if (i >= a.d) return;
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += a.part[(long long)q * 2 * a.d + i];
    static_cast<T*>(a.dw)[i] = from_f<T>(s);
    return;
  }
  if (i >= a.heads) return;
  float s = 0.f;
  for (int j = i * a.p; j < (i + 1) * a.p && j < a.d; ++j) {
    float c = 0.f;
    for (int q = 0; q < slices; ++q)
      c += a.part[(long long)q * 2 * a.d + a.d + j];
    s += c;
  }
  a.dD[i] = s;
}

template <typename T, int U>
cudaError_t launch_gated_bwd_u(const GatedBwdArgs& a, int threads, bool vec,
                               cudaStream_t st) {
  const int rpb = threads / a.tpr;
  const int blocks = (a.m + rpb - 1) / rpb;
  if (vec)
    gated_bwd_rows_kernel<T, U, true><<<blocks, threads, 0, st>>>(a);
  else
    gated_bwd_rows_kernel<T, U, false><<<blocks, threads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gated_bwd(const GatedBwdArgs& a, int upt, int threads,
                             bool vec, cudaStream_t st) {
  cudaError_t e;
  if (upt <= 1) e = launch_gated_bwd_u<T, 1>(a, threads, vec, st);
  else if (upt <= 2) e = launch_gated_bwd_u<T, 2>(a, threads, vec, st);
  else if (upt <= 4) e = launch_gated_bwd_u<T, 4>(a, threads, vec, st);
  else e = launch_gated_bwd_u<T, 8>(a, threads, vec, st);
  if (e != cudaSuccess) return e;
  const int slices = (a.m + a.rows - 1) / a.rows;
  if (slices > 65535) return cudaErrorInvalidValue;
  gated_bwd_cols_kernel<T><<<dim3((a.d + 255) / 256, slices), 256, 0, st>>>(
      a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int cols = a.d > a.heads ? a.d : a.heads;
  gated_bwd_sum_kernel<T><<<dim3((cols + 255) / 256, 2), 256, 0, st>>>(
      a, slices);
  return cudaGetLastError();
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

// The gated norm's backward: y, xh and z rows of d elements at their row
// strides (dense along the row), D (heads,) float32 with p elements a head,
// w (d,), g (m, d) contiguous; dy, dxh, dz (m, d) contiguous in the type;
// rinv (m,) and part (ceil(m / rows), 2, d) float32 scratch; dw (d,) in
// the type, dD (heads,) float32.  The plan (tpr, upt, threads) is
// ops.py::norm_plan's.  Returns cudaGetLastError() after the last launch.
extern "C" int gated_rms_norm_bwd_launch(
    const void* y, long long ys, const void* xh, long long xs, const void* z,
    long long zs, const float* dv, int p, const void* w, const void* g,
    void* dy, void* dxh, void* dz, float* rinv, float* part, void* dw,
    float* dD, int m, int d, int tpr, int upt, int threads, int rows,
    float eps, int dtype, void* stream) {
  if (m <= 0) return 0;
  const int v = dtype == 1 ? 8 : 4;
  const int units = (d + v - 1) / v;
  if (d <= 0 || p <= 0 || d % p || rows <= 0 || tpr < 32 || tpr % 32 ||
      threads % tpr || threads > 512 || upt < 1 || upt > 8 ||
      (long long)tpr * upt < units)
    return (int)cudaErrorInvalidValue;
  const bool vec = d % v == 0 && p % v == 0 && whole_units(y, ys, v) &&
                   whole_units(xh, xs, v) && whole_units(z, zs, v) &&
                   whole_units(w, 0, v) && whole_units(g, 0, v) &&
                   whole_units(dy, 0, v) && whole_units(dxh, 0, v) &&
                   whole_units(dz, 0, v);
  const GatedBwdArgs a{y,  ys,   xh,   xs,  z,    zs, dv,  p, w,    g,
                       dy, dxh,  dz,   rinv, part, dw, dD, m, d,    tpr,
                       rows, d / p, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_gated_bwd<float>(a, upt, threads, vec, st);
  if (dtype == 1)
    return (int)launch_gated_bwd<__nv_bfloat16>(a, upt, threads, vec, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
