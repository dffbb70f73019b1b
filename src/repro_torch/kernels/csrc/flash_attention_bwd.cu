// Backward of causal flash attention (GQA) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's TPU flash kernel has no
// backward.  It is the counterpart of the reference's flash-style custom
// VJP, src/repro/models/layers.py `_blocked_bwd_rule`, which recomputes
// score tiles from the saved (q, k, v, out, lse) instead of keeping every
// probability tile; the port's training forward runs the flash kernel, so
// its gradient is this kernel.
//
// Function: q, o, do (B, S, H, hd) and k, v (B, S, KV, hd) in the model's
// layout, read in place through their batch, row and head strides (each
// row of hd elements dense and on a 16-byte boundary; the wrapper checks),
// lse (B, H, S) float32 from the forward (natural log).  q head h reads kv
// head h / group.  Causal, every key below S valid.  Returns dq (B, S, H,
// hd) and dk, dv (B, S, KV, hd), contiguous, in bf16; dk and dv are summed
// over the group's q heads.  Arithmetic as `_blocked_bwd_rule`:
//   delta = rowsum(do * o)                     (float32)
//   P     = exp(scale q.k - lse)               (float32, here 2^x with
//                                               scale * log2 e folded in)
//   dP    = do . v
//   dS    = P (dP - delta) scale               (float32)
//   dv   += bf16(P)^T do,  dq += bf16(dS) k,  dk += bf16(dS)^T q
// with every product on the tensor cores (`mma.sync.m16n8k16`, bf16 in,
// float32 accumulators) and one rounding to bf16 at the end.
//
// Structure: FlashAttention-2's, three launches on the caller's stream:
//   1. delta: one warp a (batch, row, head), a fixed-order warp sum;
//   2. dk/dv: a block of 4 warps owns one (batch, kv head, 64-key tile),
//      16 keys a warp, with k and v in shared memory; it walks the group's
//      q heads and, for each, the query tiles from the key tile's diagonal
//      to the end (64 queries a tile at hd 64, 32 at hd 128, which keeps
//      the two float32 accumulators of 16 x hd and the transposed score
//      and dP tiles in registers), q and do double-buffered with 16-byte
//      `cp.async`, and accumulates dk and dv in float32 registers;
//   3. dq: a block owns one (batch, q head, 64-query tile) and walks the
//      key tiles up to its diagonal (k and v double-buffered), as the
//      forward does, accumulating dq in float32 registers.
// Every sum has one owner and a fixed order: no float32 `atomicAdd`, so
// two runs give the same bits.  Shared-memory tiles use the forward's
// XOR swizzle (`mma_sm90.cuh`), so `ldmatrix` and `ldmatrix.trans` read
// them without bank conflicts; the score tiles go from the accumulator
// layout straight into bf16 A fragments, as the forward's P does.
//
// Bound on this card: at granite's training shape (B=4, S=512, H=32, KV=8,
// hd 64) the backward does 2.5x the forward's causal operations (S, dP,
// dv, dk, dq: five products against the forward's two) and moves q, k, v,
// o, do, lse and dq, dk, dv once each; bytes and operations are close
// (42 MB in 12.6 us at 3.35 TB/s against 10.8 GFLOP in 10.9 us).  A
// simple kernel: `mma.sync` rather than `wgmma` with a TMA ring, and one
// block a kv head for dk/dv, which leaves llama3-405b's 8 kv heads at B=1
// only 64 blocks.
// Scope: bf16, hd 64 and 128; the wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;             // (b, h, s)
  float* delta;                 // (b, h, s), written by the first launch
  bf16* dq;                     // contiguous (b, s, h, hd)
  bf16* dk;                     // contiguous (b, s, kv, hd)
  bf16* dv;
  long long q_sb, q_ss, q_sh;   // strides in elements: batch, row, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long d_sb, d_ss, d_sh;   // do's
  int b, s, h, kv, group, hd;
  float scale;
};

constexpr int kTk = 64;           // keys a tile
constexpr int kTq = 64;           // queries a dq block
constexpr int kThreads = 128;     // 4 warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes from global to shared memory; zero when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// Rows [0, NR) of a tile whose row 0 is `base`, 16-byte chunks swizzled by
// row; rows at or past `rows` are zero-filled.
template <int HD, int NR>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long row_stride, int rows,
                                          int tid) {
  constexpr int CPR = HD / 8;
#pragma unroll
  for (int i = 0; i < NR * CPR / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < rows;
    const bf16* src = ok ? base + r * row_stride + c * 8 : base;
    cp_async16(smem_u32(dst + swz<CPR>(r, c) * 8), src, ok);
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(do * o), one warp a (batch, row, head)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const Args a) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= (long long)a.b * a.s * a.h) return;
  const int lane = threadIdx.x & 31;
  const int hi = (int)(row % a.h);
  const long long bs = row / a.h;
  const int si = (int)(bs % a.s), bi = (int)(bs / a.s);
  const bf16* o = a.o + bi * a.o_sb + si * a.o_ss + hi * a.o_sh;
  const bf16* d = a.dout + bi * a.d_sb + si * a.d_ss + hi * a.d_sh;
  float acc = 0.f;
  for (int j = 2 * lane; j < a.hd; j += 64) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + j));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(d + j));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) a.delta[((long long)bi * a.h + hi) * a.s + si] = acc;
}

// ---------------------------------------------------------------------------
// 2. dk, dv: one block a (batch, kv head, 64-key tile)
// ---------------------------------------------------------------------------

template <int HD, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Args a) {
  constexpr int CPR = HD / 8;     // 16-byte chunks a row
  constexpr int KQ = HD / 16;     // k-steps over hd
  constexpr int ND = HD / 8;      // 8-wide column tiles over hd
  constexpr int NQ = BQ / 8;      // 8-wide column tiles over the queries
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* sk = reinterpret_cast<bf16*>(smem_raw);   // [kTk][HD]
  auto* sv = sk + kTk * HD;                       // [kTk][HD]
  auto* sq = sv + kTk * HD;                       // [2][BQ][HD]
  auto* sdo = sq + 2 * BQ * HD;                   // [2][BQ][HD]
  auto* sl = reinterpret_cast<float*>(sdo + 2 * BQ * HD);  // [2][BQ] lse
  auto* sd = sl + 2 * BQ;                                  // [2][BQ] delta

  // key tiles from the first (the most query tiles) to the last
  const int bk = a.b * a.kv;
  const int kt = blockIdx.x / bk;
  const int bi = (blockIdx.x % bk) / a.kv, kvh = (blockIdx.x % bk) % a.kv;
  const int k0 = kt * kTk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const float sl2 = a.scale * kLog2e;

  const bf16* kg = a.k + bi * a.k_sb + kvh * a.k_sh + k0 * a.k_ss;
  const bf16* vg = a.v + bi * a.v_sb + kvh * a.v_sh + k0 * a.v_ss;
  load_rows<HD, kTk>(sk, kg, a.k_ss, a.s - k0, tid);
  load_rows<HD, kTk>(sv, vg, a.v_ss, a.s - k0, tid);

  const int j0 = k0 / BQ;                    // the first query tile >= k0
  const int per_head = (a.s + BQ - 1) / BQ - j0;
  const int n_iter = a.group * per_head;

  auto issue = [&](int it, int buf) {
    const int hi = kvh * a.group + it / per_head;
    const int q0 = (j0 + it % per_head) * BQ;
    load_rows<HD, BQ>(sq + buf * BQ * HD,
                      a.q + bi * a.q_sb + hi * a.q_sh + q0 * a.q_ss, a.q_ss,
                      a.s - q0, tid);
    load_rows<HD, BQ>(sdo + buf * BQ * HD,
                      a.dout + bi * a.d_sb + hi * a.d_sh + q0 * a.d_ss,
                      a.d_ss, a.s - q0, tid);
    if (tid < BQ) {
      const long long r = ((long long)bi * a.h + hi) * a.s + q0 + tid;
      const bool ok = q0 + tid < a.s;
      cp_async4(smem_u32(sl + buf * BQ + tid), ok ? a.lse + r : a.lse, ok);
      cp_async4(smem_u32(sd + buf * BQ + tid), ok ? a.delta + r : a.delta,
                ok);
    }
    cp_async_commit();
  };
  issue(0, 0);                    // one group with k and v

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  const int krow = k0 + warp * 16 + g;      // this thread's keys: +0, +8

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      issue(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1;
    const int q0 = (j0 + it % per_head) * BQ;
    const bf16* qs = sq + buf * BQ * HD;
    const bf16* dos = sdo + buf * BQ * HD;
    const float* ls = sl + buf * BQ;
    const float* ds = sd + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows the warp's 16 keys, columns the
    // tile's queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t ka[4], va[4];
      const int ar = swz<CPR>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4));
      ldsm_x4(smem_u32(sk + ar * 8), ka[0], ka[1], ka[2], ka[3]);
      ldsm_x4(smem_u32(sv + ar * 8), va[0], va[1], va[2], va[3]);
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        const int br = swz<CPR>(n * 8 + (mi >> 1) * 8 + (lane & 7),
                                2 * kk + (mi & 1));
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(qs + br * 8), b0, b1, b2, b3);
        mma_bf16(st[n], ka, b0, b1);
        mma_bf16(st[n + 1], ka, b2, b3);
        ldsm_x4(smem_u32(dos + br * 8), b0, b1, b2, b3);
        mma_bf16(dpt[n], va, b0, b1);
        mma_bf16(dpt[n + 1], va, b2, b3);
      }
    }

    // P^T = 2^(scale log2e s - lse log2e), masked above the diagonal;
    // dS^T = P^T (dP^T - delta) scale.  Query rows past S hold zeros in q,
    // do, lse and delta: their P is 1 and their dS and do are 0, so they
    // add nothing.
    const bool edge = q0 < k0 + kTk;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        float x = st[n][e] * sl2 - ls[col] * kLog2e;
        if (edge && krow + (e >> 1) * 8 > q0 + col) x = -INFINITY;
        const float p = ex2(x);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - ds[col]) * a.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: the score tiles 2kc and 2kc + 1 are
    // the A fragment of queries [16kc, 16kc + 16)
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
      const uint32_t da[4] = {
          pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]),
          pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]),
          pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
          pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        const int br = swz<CPR>(kc * 16 + (mi & 1) * 8 + (lane & 7),
                                d + (mi >> 1));
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(dos + br * 8), b0, b1, b2, b3);
        mma_bf16(dv[d], pa, b0, b1);
        mma_bf16(dv[d + 1], pa, b2, b3);
        ldsm_x4_t(smem_u32(qs + br * 8), b0, b1, b2, b3);
        mma_bf16(dk[d], da, b0, b1);
        mma_bf16(dk[d + 1], da, b2, b3);
      }
    }
    __syncthreads();              // every warp is done with this stage
  }

  // rows g and g + 8 of the warp's keys, columns 2tq, 2tq + 1 of each tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = krow + half * 8;
    if (kpos >= a.s) continue;
    const long long off = (((long long)bi * a.s + kpos) * a.kv + kvh) * HD;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int c = d * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(a.dk + off + c) =
          pack_bf16(dk[d][2 * half], dk[d][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + off + c) =
          pack_bf16(dv[d][2 * half], dv[d][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq: one block a (batch, q head, 64-query tile)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  constexpr int CPR = HD / 8;
  constexpr int KQ = HD / 16;
  constexpr int ND = HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* sq = reinterpret_cast<bf16*>(smem_raw);   // [kTq][HD]
  auto* sdo = sq + kTq * HD;                      // [kTq][HD]
  auto* sk = sdo + kTq * HD;                      // [2][kTk][HD]
  auto* sv = sk + 2 * kTk * HD;                   // [2][kTk][HD]

  // query tiles from the last (the most key tiles) to the first
  const int bh = a.b * a.h;
  const int nqt = (a.s + kTq - 1) / kTq;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / bh)) * kTq;
  const int bi = (blockIdx.x % bh) / a.h, hi = (blockIdx.x % bh) % a.h;
  const int kvh = hi / a.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const float sl2 = a.scale * kLog2e;

  const bf16* kg = a.k + bi * a.k_sb + kvh * a.k_sh;
  const bf16* vg = a.v + bi * a.v_sb + kvh * a.v_sh;
  load_rows<HD, kTq>(sq, a.q + bi * a.q_sb + hi * a.q_sh + q0 * a.q_ss,
                     a.q_ss, a.s - q0, tid);
  load_rows<HD, kTq>(sdo, a.dout + bi * a.d_sb + hi * a.d_sh + q0 * a.d_ss,
                     a.d_ss, a.s - q0, tid);
  load_rows<HD, kTk>(sk, kg, a.k_ss, a.s, tid);
  load_rows<HD, kTk>(sv, vg, a.v_ss, a.s, tid);
  cp_async_commit();

  // this thread's two query rows: qrow and qrow + 8
  const int qrow = q0 + warp * 16 + g;
  const long long lrow = ((long long)bi * a.h + hi) * a.s;
  const float lse0 = qrow < a.s ? a.lse[lrow + qrow] * kLog2e : 0.f;
  const float lse1 = qrow + 8 < a.s ? a.lse[lrow + qrow + 8] * kLog2e : 0.f;
  const float del0 = qrow < a.s ? a.delta[lrow + qrow] : 0.f;
  const float del1 = qrow + 8 < a.s ? a.delta[lrow + qrow + 8] : 0.f;

  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  const int n_tiles = (min(q0 + kTq, a.s) + kTk - 1) / kTk;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTk;
    if (j + 1 < n_tiles) {
      const int nxt = (j + 1) & 1;
      load_rows<HD, kTk>(sk + nxt * kTk * HD, kg + (k0 + kTk) * a.k_ss,
                         a.k_ss, a.s - k0 - kTk, tid);
      load_rows<HD, kTk>(sv + nxt * kTk * HD, vg + (k0 + kTk) * a.v_ss,
                         a.v_ss, a.s - k0 - kTk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = sk + (j & 1) * kTk * HD;
    const bf16* vs = sv + (j & 1) * kTk * HD;

    // S = Q K^T and dP = dO V^T: rows the warp's 16 queries, 64 keys
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t qa[4], da[4];
      const int ar = swz<CPR>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4));
      ldsm_x4(smem_u32(sq + ar * 8), qa[0], qa[1], qa[2], qa[3]);
      ldsm_x4(smem_u32(sdo + ar * 8), da[0], da[1], da[2], da[3]);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        const int br = swz<CPR>(n * 8 + (mi >> 1) * 8 + (lane & 7),
                                2 * kk + (mi & 1));
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(ks + br * 8), b0, b1, b2, b3);
        mma_bf16(sc[n], qa, b0, b1);
        mma_bf16(sc[n + 1], qa, b2, b3);
        ldsm_x4(smem_u32(vs + br * 8), b0, b1, b2, b3);
        mma_bf16(dp[n], da, b0, b1);
        mma_bf16(dp[n + 1], da, b2, b3);
      }
    }

    // P and dS; only the diagonal tile has keys after a query
    const bool edge = k0 == q0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi8 = e >> 1;
        float x = sc[n][e] * sl2 - (hi8 ? lse1 : lse0);
        if (edge && k0 + n * 8 + 2 * tq + (e & 1) > qrow + hi8 * 8)
          x = -INFINITY;
        const float p = ex2(x);
        dp[n][e] = p * (dp[n][e] - (hi8 ? del1 : del0)) * a.scale;
      }
    }

    // dQ += dS K: dS's tiles 2kc and 2kc + 1 are the A fragment of keys
    // [16kc, 16kc + 16)
#pragma unroll
    for (int kc = 0; kc < kTk / 16; ++kc) {
      const uint32_t sa[4] = {pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                              pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                              pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                              pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(ks + swz<CPR>(kc * 16 + (mi & 1) * 8 + (lane & 7),
                                         d + (mi >> 1)) * 8),
                  b0, b1, b2, b3);
        mma_bf16(dq[d], sa, b0, b1);
        mma_bf16(dq[d + 1], sa, b2, b3);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qrow + half * 8;
    if (qpos >= a.s) continue;
    const long long off = (((long long)bi * a.s + qpos) * a.h + hi) * HD;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<uint32_t*>(a.dq + off + d * 8 + 2 * tq) =
          pack_bf16(dq[d][2 * half], dq[d][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int run(Kernel kern, const Args& a, long long blocks, int threads, int smem,
        cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int HD, int BQ>
int run_all(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.b * a.s * a.h;
  int err = run(flash_bwd_delta_kernel, a, (rows + 7) / 8, 256, 0, st);
  if (err) return err;
  const long long kt = (a.s + kTk - 1) / kTk;
  err = run(flash_bwd_dkdv_kernel<HD, BQ>, a, kt * a.b * a.kv, kThreads,
            (2 * kTk + 4 * BQ) * HD * (int)sizeof(bf16) +
                4 * BQ * (int)sizeof(float),
            st);
  if (err) return err;
  const long long qt = (a.s + kTq - 1) / kTq;
  return run(flash_bwd_dq_kernel<HD>, a, qt * a.b * a.h, kThreads,
             (2 * kTq + 4 * kTk) * HD * (int)sizeof(bf16), st);
}

}  // namespace

// bf16 only; hd 64 or 128; causal with every key valid.  Strides are in
// elements; lse is a contiguous float32 (b, h, s) tensor, delta float32
// scratch of the same shape; dq, dk, dv contiguous.  Returns
// cudaGetLastError() after the last launch (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int s, int h, int kv, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long d_sb,
    long long d_ss, long long d_sh, float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (kv <= 0 || h % kv != 0) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q),  static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),  static_cast<const bf16*>(o),
               static_cast<const bf16*>(dout), lse, delta,
               static_cast<bf16*>(dq),       static_cast<bf16*>(dk),
               static_cast<bf16*>(dv),       q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, d_sb, d_ss, d_sh,
               b, s, h, kv, h / kv, hd, scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return run_all<64, 64>(a, st);
    case 128: return run_all<128, 32>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
