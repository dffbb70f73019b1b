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
// The gated form's backward (gated_rms_norm_bwd_launch) replaces no TPU
// kernel either: the reference gets these gradients from JAX autodiff of
// the same expressions.  Function: with v = (y + D xh) silu(z) recomputed
// with the forward's roundings and r = rsqrt(mean v^2 + eps) the forward's
// (its sum of squares in the forward's order), n = v r, dn = g w: dv =
// r (dn - n mean(dn n)) rounded to the type, dy = r(dv silu(z)), dxh =
// r(dy r(D)), dz = r(r(dv (y + D xh)) silu'(z)) (silu'(z) = s (1 + z (1 -
// s)) in float32), dw = sum over rows of g n rounded to the type, dD a
// head = sum of dy xh over its rows and columns.
// Bound on this card: bytes, y, xh, z, g read once and dy, dxh, dz written
// once (117.5 MB at mamba2's (2048, 4096): 0.035 ms at 3.35 TB/s).  Two
// launches:
//   1. one pass over the rows (gated_bwd_kernel): a block owns a slice of
//      GATED_BWD_ROWS rows (16: 128 slices of 2048 rows), one row at a
//      time in the norm's plan; it reads y, xh, z and g once, 16 bytes at a
//      time, the next rows' by cp.async while this one is computed, keeps
//      the prologue's yy, silu(z) and v in registers (no second prologue),
//      writes dy, dxh and dz, and accumulates each column's partials of
//      sum g n and sum dy xh over its rows, in row order, in registers; one
//      (2, d) float32 partial leaves the block;
//   2. the sums over the slices in a fixed order (each column's slices in
//      four interleaved runs, added in order): dw rounded to the type, and
//      dD a head, over its columns in order.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py --times gated_bwd; PERF.md row 8): 0.075 ms at (2048,
// 4096) and 0.111 ms at (2048, 7168), 47% and 55% of the bound, against the
// first design's 0.222 and 0.405 ms in the same run: the pass moves the
// bound's bytes at 1.7-1.9 TB/s, about the rate of the first design's row
// pass on the same reads and writes.
// r is the forward's r; mean(dn n) is taken as r sum(dn v) / d in the
// same exchange as the sum of squares (one exchange a row, not two), so
// dy, dxh and dz may differ from the first design's (three launches, whose
// column pass read every input again a 2-byte element at a time) in their
// last rounding, and dw and dD do (its column chains were 64 rows, these
// are 16).  Every sum has one owner and a fixed order: two runs give the
// same bits.
//
// The forward norms' bound on this card: bytes (each input read once, each
// output written once), and below a few hundred KB the launch itself.  The
// design reads each input once, holds the row's prologue output in
// registers (up to 8 units a thread, 512 threads a row: D up to 32768 bf16
// elements), and gives a decode step's tiny rows one round trip to memory;
// fusing the prologues saves their launches and intermediate tensors.

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
  float* part;       // (slices, 2, d)
  void* dw;          // (d,)
  float* dD;         // (heads,)
  int m, d, tpr, rows, heads;
  float eps;
  int stages;        // rows in the pass's ring (2 or 3; VEC only)
};

// the row's totals of u and v over its threads, each in the forward's
// order (a warp's xor tree, then the warps in order), in one exchange
__device__ __forceinline__ float2 row_totals(float u, float v, float* part,
                                             int t, int warps) {
  u = warp_sum(u);
  v = warp_sum(v);
  if ((t & 31) == 0) {
    part[t >> 5] = u;
    part[16 + (t >> 5)] = v;
  }
  __syncthreads();
  float su = part[0], sv = part[16];
  for (int q = 1; q < warps; ++q) {
    su += part[q];
    sv += part[16 + q];
  }
  __syncthreads();
  return make_float2(su, sv);
}

// One pass over the rows: block q owns rows [q R, q R + R) (R = a.rows)
// and takes them one at a time in the norm's plan (tpr threads a row,
// thread t the units t, t + tpr, ...: the forward's order, so r is the
// forward's r).  Each input is read once, 16 bytes at a time where the
// rows allow it (VEC): then each thread copies its units of y, xh, z and g
// two rows ahead by cp.async into its own slots of a three-stage ring in
// shared memory (two stages, one row ahead, for rows of more than 1200
// units: float32 beyond 4800 elements), so the next rows' loads are in
// flight behind this row's arithmetic.  The prologue's yy = r(y + r(r(D)
// xh)), sz = silu(z) and v = r(yy sz), and z, g and xh, stay in registers
// as 16-byte units for the rest of the row.  Each column's partials of sum
// g n and sum dy xh are accumulated over the block's rows in row order in
// registers, and leave the block once, as one (2, d) slice of the partials.
template <typename T, int U, bool VEC>
__global__ void __launch_bounds__(512)
gated_bwd_kernel(GatedBwdArgs a) {
  constexpr int V = Unit<T>::n;
  __shared__ float part[32];     // the exchange: [2][16 warps]
  // VEC: [stages][4 inputs][units] 16-byte units of a row
  extern __shared__ uint4 ring[];
  const int stages = a.stages;
  const int tpr = a.tpr;
  const int t = threadIdx.x, warps = tpr >> 5;
  const int units = (a.d + V - 1) / V;
  const long long r0 = (long long)blockIdx.x * a.rows;
  const long long r1 = r0 + a.rows < a.m ? r0 + a.rows : a.m;
  const T* w = static_cast<const T*>(a.w);

  float sw[U][V], sd[U][V];
#pragma unroll
  for (int k = 0; k < U; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) sw[k][e] = sd[k][e] = 0.f;
  // VEC: the thread's columns are the same every row: its units of w, and
  // r(D) of each unit's head (a unit never straddles a head)
  uint4 wu[VEC ? U : 1];
  float du[VEC ? U : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = t + k * tpr;
      if (u >= units) break;
      wu[k] = __ldg(reinterpret_cast<const uint4*>(w + u * V));
      float dh[1] = {__ldg(a.dv + u * V / a.p)};
      round_n<T, 1>(dh);
      du[k] = dh[0];
    }
  }
  // w and r(D) at the thread's unit k, elements [j, j + V)
  auto consts = [&](int k, int j, float* wv, float* dh) {
    if constexpr (VEC) {
      unpack<T>(wu[k], wv);
#pragma unroll
      for (int e = 0; e < V; ++e) dh[e] = du[k];
    } else {
      load<T, VEC>(w, j, a.d, wv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        dh[e] = j + e < a.d ? __ldg(a.dv + (j + e) / a.p) : 0.f;
      round_n<T, V>(dh);
    }
  };

  // issue the copies of row `row`'s units into its ring stage (a group,
  // empty past the block's rows, so that every row commits one)
  auto fetch = [&](long long row) {
    if (row < r1) {
      uint4* dst = ring + (int)((row - r0) % stages) * 4 * units;
      const T* y = static_cast<const T*>(a.y) + row * a.ys;
      const T* xh = static_cast<const T*>(a.xh) + row * a.xs;
      const T* z = static_cast<const T*>(a.z) + row * a.zs;
      const T* g = static_cast<const T*>(a.g) + row * a.d;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int u = t + k * tpr;
        if (u >= units) break;
        cp_async16(dst + u, y + u * V);
        cp_async16(dst + units + u, xh + u * V);
        cp_async16(dst + 2 * units + u, z + u * V);
        cp_async16(dst + 3 * units + u, g + u * V);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if constexpr (VEC) {
    for (int k = 0; k < stages - 1; ++k) fetch(r0 + k);
  }

  for (long long row = r0; row < r1; ++row) {
    const T* g = static_cast<const T*>(a.g) + row * a.d;
    const uint4* cur = ring + (int)((row - r0) % stages) * 4 * units;
    if constexpr (VEC) {
      fetch(row + stages - 1);
      if (stages == 3)
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    }
    uint4 pyy[U], psz[U], pv[U], pz[U], pg[U], px[U];
    float ss = 0.f, gwv = 0.f;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = t + k * tpr;
      if (u >= units) break;
      const int j = u * V;
      float yy[V], xh[V], zz[V], sz[V], dh[V], v[V], gv[V];
      if constexpr (VEC) {        // this thread's own copies: no barrier
        unpack<T>(cur[u], yy);
        unpack<T>(cur[units + u], xh);
        unpack<T>(cur[2 * units + u], zz);
        unpack<T>(cur[3 * units + u], gv);
      } else {
        load<T, VEC>(static_cast<const T*>(a.y) + row * a.ys, j, a.d, yy);
        load<T, VEC>(static_cast<const T*>(a.xh) + row * a.xs, j, a.d, xh);
        load<T, VEC>(static_cast<const T*>(a.z) + row * a.zs, j, a.d, zz);
        load<T, VEC>(g, j, a.d, gv);
      }
      px[k] = pack<T>(xh);
      pz[k] = pack<T>(zz);
      pg[k] = pack<T>(gv);
      float wv[V];
      consts(k, j, wv, dh);
#pragma unroll
      for (int e = 0; e < V; ++e) sz[e] = zz[e];
      silu_n<T, V>(sz);
#pragma unroll
      for (int e = 0; e < V; ++e) xh[e] = __fmul_rn(dh[e], xh[e]);
      round_n<T, V>(xh);
#pragma unroll
      for (int e = 0; e < V; ++e) yy[e] = __fadd_rn(yy[e], xh[e]);
      round_n<T, V>(yy);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = __fmul_rn(yy[e], sz[e]);
      round_n<T, V>(v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss = fmaf(v[e], v[e], ss);
        gwv = fmaf(gv[e] * wv[e], v[e], gwv);
      }
      pyy[k] = pack<T>(yy);
      psz[k] = pack<T>(sz);
      pv[k] = pack<T>(v);
    }
    // r from the sum of squares in the forward's order; mean(dn n) = r
    // sum(dn v) / d, its sum taken in the same exchange
    const float2 tot = row_totals(ss, gwv, part, t, warps);
    const float r = rsqrtf(tot.x / (float)a.d + a.eps);
    const float mean = r * tot.y / (float)a.d;
    T* dy = static_cast<T*>(a.dy) + row * a.d;
    T* dxh = static_cast<T*>(a.dxh) + row * a.d;
    T* dz = static_cast<T*>(a.dz) + row * a.d;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = t + k * tpr;
      if (u >= units) break;
      const int j = u * V;
      float gv[V], wv[V], v[V], yy[V], sz[V], zr[V], xh[V], dh[V];
      unpack<T>(pg[k], gv);
      unpack<T>(pv[k], v);
      unpack<T>(pyy[k], yy);
      unpack<T>(psz[k], sz);
      unpack<T>(pz[k], zr);
      unpack<T>(px[k], xh);
      consts(k, j, wv, dh);
      float dvr[V], o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float n = v[e] * r;
        dvr[e] = r * (gv[e] * wv[e] - n * mean);
        sw[k][e] = fmaf(gv[e], n, sw[k][e]);
      }
      round_n<T, V>(dvr);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = __fmul_rn(dvr[e], sz[e]);  // dy
      round_n<T, V>(o);
      store<T, VEC>(dy, j, a.d, o);
#pragma unroll
      for (int e = 0; e < V; ++e) sd[k][e] = fmaf(o[e], xh[e], sd[k][e]);
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
  float* out = a.part + (long long)blockIdx.x * 2 * a.d;
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int u = t + k * tpr;
    if (u >= units) break;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int j = u * V + e;
      if (j < a.d) {
        out[j] = sw[k][e];
        out[a.d + j] = sd[k][e];
      }
    }
  }
}

// The sums over the slices, in a fixed order: a block owns 64 columns (dw,
// blockIdx.y 0) or a head's columns (dD, blockIdx.y 1, 64 columns at a
// time); its thread (column c, quarter k) sums slices k, k + 4, ... in
// order, and the quarters are added in order: dw rounded to the type, dD
// the head's columns in order.
template <typename T>
__global__ void __launch_bounds__(256)
gated_bwd_sum_kernel(GatedBwdArgs a, int slices) {
  __shared__ float q4[4][64];
  const int c = threadIdx.x & 63, k = threadIdx.x >> 6;
  const bool dd = blockIdx.y == 1;
  if (dd && (int)blockIdx.x >= a.heads) return;
  const int base = dd ? blockIdx.x * a.p : blockIdx.x * 64;
  const int end = dd ? base + a.p : min(base + 64, a.d);
  const float* src = a.part + (dd ? a.d : 0);
  float head = 0.f;
  for (int j0 = base; j0 < end; j0 += 64) {
    const int j = j0 + c;
    float s = 0.f;
    if (j < end)
      for (int q = k; q < slices; q += 4) s += src[(long long)q * 2 * a.d + j];
    q4[k][c] = s;
    __syncthreads();
    if (k == 0 && j < end) {
      const float col = ((q4[0][c] + q4[1][c]) + q4[2][c]) + q4[3][c];
      if (dd) q4[0][c] = col;
      else static_cast<T*>(a.dw)[j] = from_f<T>(col);
    }
    __syncthreads();
    if (dd && threadIdx.x == 0)
      for (int i = 0; i < 64 && j0 + i < end; ++i) head += q4[0][i];
    __syncthreads();
  }
  if (dd && threadIdx.x == 0) a.dD[blockIdx.x] = head;
}

template <typename T, int U>
cudaError_t launch_gated_bwd_u(const GatedBwdArgs& a, int slices, bool vec,
                               cudaStream_t st) {
  if (vec) {
    const int bytes = a.stages * 4 * 16 * ((a.d + Unit<T>::n - 1) /
                                           Unit<T>::n);
    cudaError_t e = cudaFuncSetAttribute(
        gated_bwd_kernel<T, U, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();         // not left to the next launch's check
      return e;
    }
    gated_bwd_kernel<T, U, true><<<slices, a.tpr, bytes, st>>>(a);
  } else {
    gated_bwd_kernel<T, U, false><<<slices, a.tpr, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gated_bwd(const GatedBwdArgs& a, int upt, bool vec,
                             cudaStream_t st) {
  const long long sl = ((long long)a.m + a.rows - 1) / a.rows;
  if (sl > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int slices = (int)sl;
  cudaError_t e;
  if (upt <= 1) e = launch_gated_bwd_u<T, 1>(a, slices, vec, st);
  else if (upt <= 2) e = launch_gated_bwd_u<T, 2>(a, slices, vec, st);
  else if (upt <= 4) e = launch_gated_bwd_u<T, 4>(a, slices, vec, st);
  else e = launch_gated_bwd_u<T, 8>(a, slices, vec, st);
  if (e != cudaSuccess) return e;
  const int cols = (a.d + 63) / 64;
  gated_bwd_sum_kernel<T><<<dim3(cols > a.heads ? cols : a.heads, 2), 256,
                            0, st>>>(a, slices);
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
// part (ceil(m / rows), 2, d) float32 scratch; dw (d,) in the type, dD
// (heads,) float32.  tpr and upt are ops.py::norm_plan's (a block is one
// row's tpr threads).  Returns cudaGetLastError() after the last launch.
extern "C" int gated_rms_norm_bwd_launch(
    const void* y, long long ys, const void* xh, long long xs, const void* z,
    long long zs, const float* dv, int p, const void* w, const void* g,
    void* dy, void* dxh, void* dz, float* part, void* dw, float* dD, int m,
    int d, int tpr, int upt, int rows, float eps, int dtype, void* stream) {
  if (m <= 0) return 0;
  const int v = dtype == 1 ? 8 : 4;
  const int units = (d + v - 1) / v;
  if (d <= 0 || p <= 0 || d % p || rows <= 0 || tpr < 32 || tpr % 32 ||
      tpr > 512 || upt < 1 || upt > 8 || (long long)tpr * upt < units)
    return (int)cudaErrorInvalidValue;
  const bool vec = d % v == 0 && p % v == 0 && whole_units(y, ys, v) &&
                   whole_units(xh, xs, v) && whole_units(z, zs, v) &&
                   whole_units(w, 0, v) && whole_units(g, 0, v) &&
                   whole_units(dy, 0, v) && whole_units(dxh, 0, v) &&
                   whole_units(dz, 0, v) &&
                   2LL * 4 * 16 * units <= 225 * 1024;
  // the pass's ring: three rows where they fit in a block's shared memory
  // (227 KB), else two; rows beyond two stages take element loads
  const long long row_bytes = 4LL * 16 * units;
  const int stages = 3 * row_bytes <= 225 * 1024 ? 3 : 2;
  const GatedBwdArgs a{y,  ys,  xh,   xs, z,  zs, dv,  p,    w,    g,   dy,
                       dxh, dz, part, dw, dD, m,  d,   tpr,  rows, d / p,
                       eps, stages};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_gated_bwd<float>(a, upt, vec, st);
  if (dtype == 1)
    return (int)launch_gated_bwd<__nv_bfloat16>(a, upt, vec, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
