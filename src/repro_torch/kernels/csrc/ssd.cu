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
// is made.  A ragged last chunk is masked in the kernel: steps past S read
// dt = x = B = C = 0, so they decay by 1, add nothing to the state, and
// write no output.
//
// Bound on this card.  At the mamba2-1.3b prefill shape (B = 4, S = 512,
// H = 64, P = 64, N = 128, Q = 128, bf16 x/B/C) the function needs the
// causal halves of C B^T (2.16 GFLOP) and 4.84 GFLOP of products with a
// float32 operand (L o dt times x, C state^T, the state update).  Run on
// the bf16 tensor cores, with each float32 operand split into two bf16
// terms, that is (2.16 + 2 x 4.84) GFLOP, 0.012 ms at 989 TFLOP/s, against
// 43.5 MB moved, 0.013 ms at 3.35 TB/s: bytes bound it.  What stands in the
// way is latency: the chunk loop is sequential in each (b, h), a chunk's
// products form a chain (cumsum, C B^T, the weights, their product with x,
// the state update) with block barriers between them, and B and C, shared
// by all heads, are read from L2 by every block.
//
// The bf16 path (the one the model takes) does every product with
// `mma.sync.m16n8k16` (bf16 in, float32 accumulators; helpers and swizzles
// in mma_sm90.cuh, shared with the flash kernel):
//   * The grid is (P / 32) x H x B blocks of 4 warps.  Columns p of y and
//     rows p of the state depend only on columns p of x, so a block owns
//     32 columns of one (b, h) and needs no second pass; it recomputes
//     only C B^T and the cumsum.  The prefill shape runs 512 blocks, two
//     to an SM, in 1.94 waves; B = 1 runs 128 blocks, one to an SM, in one
//     wave (blocks of 16 columns, twice as many, were slower there: each
//     recomputes C B^T for half the work).
//   * The chunk is staged in bf16 with 16-byte `cp.async` (a source size
//     of 0 zero-fills rows past S and columns past N and P), in swizzled
//     shared memory that `ldmatrix` reads without bank conflicts: C and B
//     (Q x N), x (Q x 32, two buffers) and the split state (32 x N), 102 KB
//     at Q = N = 128, so two blocks share an SM.  The next chunk's
//     C and x load while the state update runs, its dt while the whole
//     chunk runs; its B waits for the update.
//   * Every warp takes the cumsum of its own copy by a warp scan (Q / 32
//     values a lane, then five shuffles), so no barrier waits on it, and
//     keeps each key's (cs log2 e, dt) and w = dt exp(cs_last - cs).
//   * A warp owns the 16-row tiles w and Q/16 - 1 - w of the chunk, so the
//     causal work is balanced: every warp walks 9 key tiles at Q = 128,
//     not 1 to 8.  For each key tile up to the
//     diagonal it forms S = C B^T, takes the weights S exp(cs_i - cs_j) dt_j
//     with `ex2` (masked j > i on the diagonal tile, where exp could
//     overflow into inf * 0), and keeps them in registers, packed from the
//     accumulators straight into A fragments for the product with x, as
//     flash keeps its probabilities.  Tiles above the diagonal are skipped.
//   * Precision: the state is float32 and held to 2e-4 even on this path,
//     and three products have a float32 operand (the weights, the state,
//     x o w).  TF32 misses that, and so does one bf16 rounding of any of
//     the three (tests/test_torch_ssm.py emulates each choice); each such
//     operand v is split into bf16 hi + lo (|v - hi - lo| <= 2^-16 |v|)
//     and multiplies an exact bf16 operand (C, B or x) twice, so the
//     products keep float32 accuracy at the bf16 rate.
//   * C state^T reads the state, split once a chunk into bf16 hi/lo in
//     shared memory; the state itself stays in registers, as the
//     accumulators of the update (x o w)^T B across all chunks, and x o w
//     is formed and split on its way from x to the A fragments.
//   * A warp's y tile goes out through its own rows of C, which no other
//     warp reads, 16 bytes a lane; the state once, 8 bytes a lane, at the
//     end.
// One launch per call.
//
// The float32 path (the parity tests', not the model's) stays on true
// float32 FMA, the first port's body: one block of 2Q threads owns a (b, h)
// with the state in shared memory, two threads a query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;

// Element strides of the inputs; every last dimension is dense.
struct Strides {
  long long x_b, x_s, x_h;
  long long dt_b, dt_s, dt_h;
  long long b_b, b_s;
  long long c_b, c_s;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreadsM = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPb = 32;          // columns of P a block owns

// rows [0, ROWS) of a (ROWS x 8 CPR) bf16 tile from rows of `src` `rs`
// elements apart, by 16-byte cp.async into swizzled shared memory; rows at
// or past `rows` and chunks at or past `creal` are zero
template <int ROWS, int CPR>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int rows, int creal,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += kThreadsM) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < rows && c < creal;
    cp_async16(smem_u32(dst + swz<CPR>(r, c) * 8),
               ok ? src + r * rs + c * 8 : src, ok);
  }
}

template <int Q, int NC>
constexpr int mma_smem_bytes() {
  return 2 * (2 * Q * NC + 2 * Q * kPb + 2 * kPb * NC) + 4 * kWarps * 3 * Q;
}

template <int Q, int NC>
__global__ void __launch_bounds__(kThreadsM)
ssd_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ A,
               const __nv_bfloat16* __restrict__ bm,
               const __nv_bfloat16* __restrict__ cm,
               __nv_bfloat16* __restrict__ y, float* __restrict__ state,
               int seqlen, int heads, int pdim, int ndim, Strides st) {
  constexpr int PB = kPb;
  constexpr int RT = Q / 16;      // 16-row tiles of a chunk
  constexpr int KN = NC / 16;     // k-steps over N
  constexpr int CN = NC / 8;      // 16-byte chunks of a row of N
  constexpr int CP = PB / 8;      // ... of a row of the P block; 8-wide tiles
  constexpr int ST = (PB / 16) * (NC / 8) / kWarps;  // state tiles a warp
  constexpr int VPL = Q >= 32 ? Q / 32 : 1;          // scan values a lane
  static_assert(CP % 2 == 0 && ST % 2 == 0 && (NC / 8) % ST == 0, "tiles");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* cs_ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [Q][NC] C
  auto* bs = cs_ + Q * NC;        // [Q][NC]  B
  auto* xbuf = bs + Q * NC;       // [2][Q][PB] x, double-buffered
  auto* sth = xbuf + 2 * Q * PB;  // [PB][NC] the state, hi and lo
  auto* stl = sth + PB * NC;
  // every warp's own copy of the chunk's (cs log2 e, dt) and of w
  float* scan = reinterpret_cast<float*>(stl + PB * NC);   // [kWarps][3][Q]

  const int npb = (pdim + PB - 1) / PB;
  const int pb = blockIdx.x % npb, h = blockIdx.x / npb, b = blockIdx.y;
  const int p0 = pb * PB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const float a = A[h];
  float2* kv = reinterpret_cast<float2*>(scan + warp * 3 * Q);  // [Q]
  float* ww = scan + warp * 3 * Q + 2 * Q;                      // [Q]

  const __nv_bfloat16* xb = x + b * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const __nv_bfloat16* bb = bm + b * st.b_b;
  const __nv_bfloat16* cb = cm + b * st.c_b;
  const long long y_row = (long long)heads * pdim;
  __nv_bfloat16* yb = y + ((long long)b * seqlen * heads + h) * pdim + p0;
  const int ncr = ndim / 8, pcr = min(CP, (pdim - p0) / 8);

  // this warp's state tiles: one 16-row tile of P, ST 8-wide tiles of N
  const int mt = warp * ST / (NC / 8), nt0 = warp * ST % (NC / 8);
  float sacc[ST][4];
#pragma unroll
  for (int i = 0; i < ST; ++i)
    sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;

  const int n_chunks = (seqlen + Q - 1) / Q;
  float dtv[VPL];                 // this lane's dt of the coming chunk
#pragma unroll
  for (int e = 0; e < VPL; ++e) {
    const int j = lane * VPL + e;
    dtv[e] = j < Q && j < seqlen ? dtb[j * st.dt_s] : 0.f;
  }
  if (n_chunks > 0) {
    load_tile<Q, CN>(cs_, cb, st.c_s, seqlen, ncr, tid);
    load_tile<Q, CN>(bs, bb, st.b_s, seqlen, ncr, tid);
    load_tile<Q, CP>(xbuf, xb, st.x_s, seqlen, pcr, tid);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int valid = min(Q, seqlen - t0);
    const __nv_bfloat16* xs = xbuf + (c & 1) * Q * PB;
    cp_async_wait<0>();
    __syncthreads();              // the chunk's tiles and the split state

    // cumsum of dt * A: Q / 32 values a lane in token order, then an
    // inclusive scan of the lanes' sums; w; then the next chunk's dt
    float cs_last;
    {
      float v[VPL], run = 0.f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        run += __fmul_rn(dtv[e], a);
        v[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) excl = 0.f;
      cs_last = __shfl_sync(0xffffffffu, excl + v[VPL - 1], (Q - 1) / VPL);
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        const int j = lane * VPL + e;
        const float csj = excl + v[e];
        if (j < Q) {
          kv[j] = make_float2(csj * kLog2e, dtv[e]);
          ww[j] = expf(cs_last - csj) * dtv[e];
        }
        const int t = t0 + Q + j;
        dtv[e] = j < Q && t < seqlen ? dtb[t * st.dt_s] : 0.f;
      }
    }
    __syncwarp();

    // y of this warp's row tiles: w and RT - 1 - w
#pragma unroll 1
    for (int k2 = 0; k2 < 2; ++k2) {
      const int r = k2 == 0 ? warp : RT - 1 - warp;
      if (r < 0 || r >= RT || (k2 == 1 && r == warp)) continue;
      uint32_t cf[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldsm_x4(smem_u32(cs_ + swz<CN>(r * 16 + (lane & 15),
                                       2 * kk + (lane >> 4)) * 8),
                cf[kk][0], cf[kk][1], cf[kk][2], cf[kk][3]);
      const int i0 = r * 16 + g, i1 = i0 + 8;
      const float c0 = kv[i0].x, c1 = kv[i1].x;   // cs_i log2 e
      float acc[CP][4];
#pragma unroll
      for (int d = 0; d < CP; ++d)
        acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

      // (C . state[p]) exp(cs_i), zero from the zero state; hi and lo go
      // to separate accumulators, twice the independent chains
      if (c > 0) {
        float lo[CP][4];
#pragma unroll
        for (int d = 0; d < CP; ++d)
          lo[d][0] = lo[d][1] = lo[d][2] = lo[d][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
          for (int d = 0; d < CP; d += 2) {
            const int o = swz<CN>(d * 8 + (mi >> 1) * 8 + (lane & 7),
                                  2 * kk + (mi & 1)) * 8;
            uint32_t b0, b1, b2, b3;
            ldsm_x4(smem_u32(sth + o), b0, b1, b2, b3);
            mma_bf16(acc[d], cf[kk], b0, b1);
            mma_bf16(acc[d + 1], cf[kk], b2, b3);
            ldsm_x4(smem_u32(stl + o), b0, b1, b2, b3);
            mma_bf16(lo[d], cf[kk], b0, b1);
            mma_bf16(lo[d + 1], cf[kk], b2, b3);
          }
        }
        const float e0 = ex2(c0), e1 = ex2(c1);
#pragma unroll
        for (int d = 0; d < CP; ++d) {
          acc[d][0] = (acc[d][0] + lo[d][0]) * e0;
          acc[d][1] = (acc[d][1] + lo[d][1]) * e0;
          acc[d][2] = (acc[d][2] + lo[d][2]) * e1;
          acc[d][3] = (acc[d][3] + lo[d][3]) * e1;
        }
      }

      // sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j, over the key
      // tiles up to the diagonal; tiles above it are skipped
#pragma unroll 1
      for (int kt = 0; kt <= r; ++kt) {
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(bs + swz<CN>(kt * 16 + (mi >> 1) * 8 + (lane & 7),
                                        2 * kk + (mi & 1)) * 8),
                  b0, b1, b2, b3);
          mma_bf16(s[0], cf[kk], b0, b1);
          mma_bf16(s[1], cf[kk], b2, b3);
        }
        // the weights (a key's log2-scaled cumsum and dt in one 8-byte
        // read), masked j > i on the diagonal tile, where exp could
        // overflow into inf * 0
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = kt * 16 + n * 8 + 2 * tq + q;
            const float2 k = kv[j];
            float w0 = s[n][q] * ex2(c0 - k.x) * k.y;
            float w1 = s[n][2 + q] * ex2(c1 - k.x) * k.y;
            if (kt == r) {
              if (j > i0) w0 = 0.f;
              if (j > i1) w1 = 0.f;
            }
            s[n][q] = w0;
            s[n][2 + q] = w1;
          }
        }
        // split into bf16 A fragments, times x_j
        uint32_t wh[4], wl[4];
        split_bf16(s[0][0], s[0][1], wh[0], wl[0]);
        split_bf16(s[0][2], s[0][3], wh[1], wl[1]);
        split_bf16(s[1][0], s[1][1], wh[2], wl[2]);
        split_bf16(s[1][2], s[1][3], wh[3], wl[3]);
#pragma unroll
        for (int d = 0; d < CP; d += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_u32(xs + swz<CP>(kt * 16 + (mi & 1) * 8 + (lane & 7),
                                          d + (mi >> 1)) * 8),
                    b0, b1, b2, b3);
          mma_bf16(acc[d], wh, b0, b1);
          mma_bf16(acc[d + 1], wh, b2, b3);
          mma_bf16(acc[d], wl, b0, b1);
          mma_bf16(acc[d + 1], wl, b2, b3);
        }
      }

      // the y tile goes out through this warp's own rows of C, which no
      // other warp reads: 16 bytes a lane, real rows and columns only
      __nv_bfloat16* ys = cs_ + r * 16 * NC;   // [16][PB], swizzled
#pragma unroll
      for (int d = 0; d < CP; ++d) {
        *reinterpret_cast<uint32_t*>(ys + swz<CP>(g, d) * 8 + 2 * tq) =
            pack_bf16(acc[d][0], acc[d][1]);
        *reinterpret_cast<uint32_t*>(ys + swz<CP>(g + 8, d) * 8 + 2 * tq) =
            pack_bf16(acc[d][2], acc[d][3]);
      }
      __syncwarp();
#pragma unroll
      for (int idx = lane; idx < 16 * CP; idx += 32) {
        const int row = idx / CP, ch = idx % CP;
        if (r * 16 + row < valid && ch < pcr)
          *reinterpret_cast<uint4*>(yb + (t0 + r * 16 + row) * y_row +
                                    ch * 8) =
              *reinterpret_cast<const uint4*>(ys + swz<CP>(row, ch) * 8);
      }
    }

    __syncthreads();              // C and the split state are read
    const bool more = c + 1 < n_chunks;
    const int t1 = t0 + Q;
    if (more) {                   // the next chunk's C and x load meanwhile
      load_tile<Q, CN>(cs_, cb + t1 * st.c_s, st.c_s, seqlen - t1, ncr, tid);
      load_tile<Q, CP>(xbuf + ((c + 1) & 1) * Q * PB, xb + t1 * st.x_s,
                       st.x_s, seqlen - t1, pcr, tid);
      cp_async_commit();
    }

    // state <- state exp(cs_last) + (x o w)^T B, the state in registers;
    // x o w is formed and split on its way from x to the A fragments
    const float decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      sacc[i][0] *= decay;
      sacc[i][1] *= decay;
      sacc[i][2] *= decay;
      sacc[i][3] *= decay;
    }
#pragma unroll
    for (int kk = 0; kk < RT; ++kk) {
      uint32_t xr[4], ah[4], al[4];
      ldsm_x4_t(smem_u32(xs + swz<CP>(kk * 16 + (mi >> 1) * 8 + (lane & 7),
                                      2 * mt + (mi & 1)) * 8),
                xr[0], xr[1], xr[2], xr[3]);
      // fragment k of lane (g, tq): xr[0], xr[1] at j = 16 kk + 2tq + {0,1},
      // xr[2], xr[3] at j + 8
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
    if (more) {
      // the state split into bf16 hi and lo for the next chunk's C state^T
#pragma unroll
      for (int i = 0; i < ST; ++i) {
        const int pr = mt * 16 + g;
        const int o0 = swz<CN>(pr, nt0 + i) * 8 + 2 * tq;
        const int o1 = swz<CN>(pr + 8, nt0 + i) * 8 + 2 * tq;
        uint32_t hi, lo;
        split_bf16(sacc[i][0], sacc[i][1], hi, lo);
        *reinterpret_cast<uint32_t*>(sth + o0) = hi;
        *reinterpret_cast<uint32_t*>(stl + o0) = lo;
        split_bf16(sacc[i][2], sacc[i][3], hi, lo);
        *reinterpret_cast<uint32_t*>(sth + o1) = hi;
        *reinterpret_cast<uint32_t*>(stl + o1) = lo;
      }
      __syncthreads();            // B is read
      load_tile<Q, CN>(bs, bb + t1 * st.b_s, st.b_s, seqlen - t1, ncr, tid);
      cp_async_commit();
    }
  }

  float* so = state + (((long long)b * heads + h) * pdim + p0) * ndim;
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    const int n = (nt0 + i) * 8 + 2 * tq;
    const int pr = mt * 16 + g;
    if (n >= ndim) continue;
    if (p0 + pr < pdim)
      *reinterpret_cast<float2*>(so + pr * ndim + n) =
          make_float2(sacc[i][0], sacc[i][1]);
    if (p0 + pr + 8 < pdim)
      *reinterpret_cast<float2*>(so + (pr + 8) * ndim + n) =
          make_float2(sacc[i][2], sacc[i][3]);
  }
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

// 16 bytes of float as 4 floats, and back
struct F4 {
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

template <int Q, int NC, int PC>
constexpr int smem_floats() {
  return Q * NC + Q * PC + PC * NC + 3 * Q;
}

template <int Q, int NC, int PC>
__global__ void __launch_bounds__(2 * Q)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ bm,
               const float* __restrict__ cm, float* __restrict__ y,
               float* __restrict__ state, int seqlen, int heads, int pdim,
               int ndim, Strides st) {
  constexpr int kThreads = 2 * Q;
  constexpr int NH = NC / 2, PH = PC / 2;   // a thread's half of N and P
  constexpr int E = F4::E;                 // elements per 16-byte access
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

  const float* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const float* bb = bm + b * st.b_b;
  const float* cb = cm + b * st.c_b;
  const long long y_row = (long long)heads * pdim;
  float* yb = y + ((long long)b * seqlen * heads + h) * pdim;

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
    const float* crow = cb + (t0 + row) * st.c_s + half * NH;
#pragma unroll
    for (int v = 0; v < NH / E; ++v) {
      if (live && half * NH + v * E < ndim) {
        F4::load(crow + v * E, cr + v * E);
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
        F4::load(bb + (t0 + j) * st.b_s + n, f);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < E; i += 4) F4::store(bs + j * NC + n + i,
                                                       f + i);
    }
#pragma unroll
    for (int r = 0; r < PC / (2 * E); ++r) {       // Q * PC / E in all
      const int e = tid + r * kThreads;
      const int j = e / (PC / E), p = (e % (PC / E)) * E;
      float f[E];
      if (j < valid && p < pdim) {
        F4::load(xb + (t0 + j) * st.x_s + p, f);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < E; ++i) f[i] *= dts[j];
#pragma unroll
      for (int i = 0; i < E; i += 4) F4::store(vs + j * PC + p + i,
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
      float* yr = yb + (t0 + row) * y_row + half * PH;
#pragma unroll
      for (int v = 0; v < PH / E; ++v)
        if (half * PH + v * E < pdim) F4::store(yr + v * E, acc + v * E);
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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

template <typename Kernel>
int allow_smem(Kernel kern, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int Q, int NC>
int launch_mma(const Args& g, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<Q, NC>();
  auto kern = ssd_mma_kernel<Q, NC>;
  if (int e = allow_smem(kern, smem)) return e;
  dim3 grid((g.pdim + kPb - 1) / kPb * g.heads, g.batch);
  kern<<<grid, kThreadsM, smem, stream>>>(
      (const __nv_bfloat16*)g.x, (const float*)g.dt, (const float*)g.a,
      (const __nv_bfloat16*)g.bm, (const __nv_bfloat16*)g.cm,
      (__nv_bfloat16*)g.y, (float*)g.state, g.seqlen, g.heads, g.pdim,
      g.ndim, g.st);
  return (int)cudaGetLastError();
}

template <int Q, int NC, int PC>
int launch_f32(const Args& g, cudaStream_t stream) {
  constexpr int smem = smem_floats<Q, NC, PC>() * (int)sizeof(float);
  auto kern = ssd_f32_kernel<Q, NC, PC>;
  if (int e = allow_smem(kern, smem)) return e;
  dim3 grid(g.heads, g.batch);
  kern<<<grid, 2 * Q, smem, stream>>>(
      (const float*)g.x, (const float*)g.dt, (const float*)g.a,
      (const float*)g.bm, (const float*)g.cm, (float*)g.y, (float*)g.state,
      g.seqlen, g.heads, g.pdim, g.ndim, g.st);
  return (int)cudaGetLastError();
}

// bf16: N padded to 64 or 128 in shared memory
template <int Q>
int dispatch_mma(const Args& g, cudaStream_t s) {
  return g.ndim <= 64 ? launch_mma<Q, 64>(g, s) : launch_mma<Q, 128>(g, s);
}

// float32: the size class of N or P (32, 64 or 128); the register arrays
// hold half of it
int size_class(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <int Q, int NC>
int dispatch_f32_p(const Args& g, cudaStream_t s) {
  switch (size_class(g.pdim)) {
    case 32: return launch_f32<Q, NC, 32>(g, s);
    case 64: return launch_f32<Q, NC, 64>(g, s);
    default: return launch_f32<Q, NC, 128>(g, s);
  }
}

template <int Q>
int dispatch_f32(const Args& g, cudaStream_t s) {
  switch (size_class(g.ndim)) {
    case 32: return dispatch_f32_p<Q, 32>(g, s);
    case 64: return dispatch_f32_p<Q, 64>(g, s);
    default: return dispatch_f32_p<Q, 128>(g, s);
  }
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; chunk: 16 or 128 (the
// configs' chunk lengths); P, N <= 128.  x, B, C and y are accessed 16
// bytes at a time, so their pointers must be 16-byte aligned and P, N and
// their row strides multiples of 16 bytes.  Returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
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
      batch > 65535 || (chunk != 16 && chunk != 128))
    return (int)cudaErrorInvalidValue;
  Args g{x, dt, a, bm, cm, y, state, batch, seqlen, heads, pdim, ndim,
         Strides{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s}};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return chunk == 16 ? dispatch_f32<16>(g, st) : dispatch_f32<128>(g, st);
  if (dtype == 1)
    return chunk == 16 ? dispatch_mma<16>(g, st) : dispatch_mma<128>(g, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
