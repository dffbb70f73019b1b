// Forward flash attention (online softmax, GQA, causal) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py
// `_flash_kernel`, launched by `flash_attention_pallas`.
//
// Function: q (B, S, H, hd) and k/v (B, S, KV, hd) in the model's own
// layout, read in place through their batch, row and head strides (each
// row of hd elements dense and on a 16-byte boundary; the wrapper checks).
// q head h reads kv head h / group, so grouped-query attention never
// materialises repeated k/v.  Keys at or past `valid_len` (<= S) and, when
// causal, keys after the query position are masked.  Softmax statistics
// and the weighted sum are accumulated in float32; the output, a
// contiguous (B, S, H, hd) tensor in q's type, is written for the S real
// rows only.  A ragged S needs no padding: rows past S are zero-filled on
// load and never stored.  On request (a non-null `lse`, the training
// forward) each row's natural-log sum of exp(scale s) over its unmasked
// keys goes to a float32 (B, H, S) tensor, the backward's input
// (flash_attention_bwd.cu); the kernel keeps m and l in the log2 domain,
// so it writes (m + log2 l) ln 2.  Without it the kernel stores what it
// always stored.
//
// Bound on this card: at the main path's prefill shape (B=4, H=32, KV=8,
// S=512, hd=64, bf16) the least time is set by bytes, 21 MB of q, k, v and
// output in 6.3 us at 3.35 TB/s, against 4.3 GFLOP of causal QK^T and PV
// in 4.3 us at the bf16 tensor-core rate; from S of about 1k the
// operations set it (a 4096-token prompt: 69 GFLOP, 69 us).  So the kernel
// has to keep the tensor cores fed from few bytes: read every tile of k and
// v once per block, out of shared memory that the loads fill while the
// previous tile computes, and keep scores and probabilities in registers.
//
// The bf16 path (the one the model takes) is FlashAttention-2's shape on
// `mma.sync.m16n8k16` (bf16 in, float32 accumulators):
//   * a block of 4 warps owns one (batch, head, 64-query tile), 16 query
//     rows a warp, and walks 64-key tiles of k and v;
//   * q is loaded once, then held in registers as `ldmatrix` A-fragments;
//   * k and v tiles are double-buffered with 16-byte `cp.async` (a source
//     size of 0 zero-fills rows past S) into shared memory whose 16-byte
//     chunks are XOR-swizzled by row, so `ldmatrix` (k as the B operand of
//     QK^T) and `ldmatrix.trans` (v as the B operand of PV) are free of
//     bank conflicts; 40 KB a block at hd=64, so several blocks share an SM;
//   * S = QK^T stays in registers; scale * log2(e) is folded into one
//     multiply and the exponentials are `ex2`; row max and sum reduce over
//     the quad of lanes that shares a row (two xor-shuffles); the output
//     accumulator is rescaled once per key tile;
//   * P is repacked from the accumulator layout straight into bf16
//     A-fragments (no shared-memory round trip) and multiplies v;
//   * causal: only the diagonal tile is masked, tiles above it are never
//     loaded, and the query tiles with the most key tiles are scheduled
//     first, which shortens the tail across the 132 SMs; within a query
//     tile the q heads of one kv head are neighbours, so their k/v tiles
//     are read from L2;
//   * hd is a template over 16, 32, 64 and 128; hd = 8 runs as 16 with the
//     upper half zero-filled in shared memory, and hd = 112 (zamba2's
//     shared attention) as 128 with its last two 16-byte chunks
//     zero-filled, which is exact: the zero columns add nothing to QK^T,
//     give zero output columns, and are never stored (14% more tensor-core
//     work at 112, left for a kernel with a native 112 tile);
//   * the output tile is staged through the block's q buffer and stored 16
//     bytes a lane.
// `mma.sync` rather than `wgmma` with a TMA ring: at the prefill shape the
// bytes bound the work, not the tensor cores.  At long prompts, where the
// operations do, the chain inside a warp from QK^T through the softmax to
// PV is what `wgmma` with two warpgroups in ping-pong would overlap.
//
// The float32 path stays on true float32 FMA: the float32 tests hold the
// kernel to 2e-5, which TF32 tensor-core products (10-bit mantissas) miss.
// Its body is the first port's: two threads share a query row of a
// 128-query tile, each holding half of q and of the accumulator in
// registers, and 64-key tiles of k and v are staged in shared memory as
// float32; it takes the same strided layout and ragged S as the bf16 path,
// and is instantiated at every head dim it takes, 112 included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                   // (b, h, s) natural-log sum of exp, or null
  long long q_sb, q_ss, q_sh;   // strides in elements: batch, row, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int b, s, h, group, hd, causal, valid_len;
  float scale;
};

// The block's (batch, head, first query row): query tiles from the last
// (for causal attention the one with the most key tiles) to the first, and
// within a tile the B * H (batch, head) pairs in order.
struct Tile {
  int bi, hi, q0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int rows) {
  const int bh = a.b * a.h;
  const int nqt = (a.s + rows - 1) / rows;
  const int i = blockIdx.x % bh;
  Tile t;
  t.q0 = (nqt - 1 - (int)(blockIdx.x / bh)) * rows;
  t.bi = i / a.h;
  t.hi = i % a.h;
  return t;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTq = 64;           // query rows per block, 16 per warp
constexpr int kTk = 64;           // keys per tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Rows [0, 64) of a tile whose row 0 is `base`: cp.async of each 16-byte
// chunk, zero for rows at or past `rows` and chunks at or past `creal`
// (hd = 8 in a 16-wide tile, hd = 112 in a 128-wide one).
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int rows,
                                          int creal, int tid) {
  constexpr int CPR = HD / 8;
#pragma unroll
  for (int i = 0; i < kTk * CPR / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < rows && c < creal;
    const __nv_bfloat16* src = ok ? base + r * row_stride + c * 8 : base;
    cp_async16(smem_u32(dst + swz<CPR>(r, c) * 8), src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const Args a) {
  constexpr int CPR = HD / 8;     // 16-byte chunks a row
  constexpr int KQ = HD / 16;     // k-steps of QK^T
  constexpr int ND = HD / 8;      // 8-wide column tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTq][HD]
  auto* sk = sq + kTq * HD;                               // [2][kTk][HD]
  auto* sv = sk + 2 * kTk * HD;                           // [2][kTk][HD]

  const Tile t = tile_of(a, kTq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // row in the 8-row group, quad
  const int mi = lane >> 3;                 // ldmatrix: which 8x8 matrix
  const int kvh = t.hi / a.group;
  const int creal = a.hd / 8;
  const auto* qg = static_cast<const __nv_bfloat16*>(a.q) + t.bi * a.q_sb +
                   t.hi * a.q_sh + t.q0 * a.q_ss;
  const auto* kg =
      static_cast<const __nv_bfloat16*>(a.k) + t.bi * a.k_sb + kvh * a.k_sh;
  const auto* vg =
      static_cast<const __nv_bfloat16*>(a.v) + t.bi * a.v_sb + kvh * a.v_sh;

  const int kv_end = a.causal ? min(t.q0 + kTq, a.valid_len) : a.valid_len;
  const int n_tiles = (kv_end + kTk - 1) / kTk;

  load_tile<HD>(sq, qg, a.q_ss, a.s - t.q0, creal, tid);
  load_tile<HD>(sk, kg, a.k_ss, a.s, creal, tid);
  load_tile<HD>(sv, vg, a.v_ss, a.s, creal, tid);
  cp_async_commit();

  uint32_t qf[KQ][4];
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  // this thread's two query rows: qrow and qrow + 8
  const int qrow = t.q0 + warp * 16 + g;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTk;
    if (j + 1 < n_tiles) {        // the next tile loads while this computes
      const int nxt = (j + 1) & 1;
      load_tile<HD>(sk + nxt * kTk * HD, kg + (k0 + kTk) * a.k_ss, a.k_ss,
                    a.s - k0 - kTk, creal, tid);
      load_tile<HD>(sv + nxt * kTk * HD, vg + (k0 + kTk) * a.v_ss, a.v_ss,
                    a.s - k0 - kTk, creal, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        ldsm_x4(smem_u32(sq + swz<CPR>(warp * 16 + (lane & 15),
                                       2 * kk + (lane >> 4)) * 8),
                qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
    }
    const __nv_bfloat16* ks = sk + (j & 1) * kTk * HD;
    const __nv_bfloat16* vs = sv + (j & 1) * kTk * HD;

    // S = Q K^T: 8 column tiles of 8 keys, c0/c1 row g, c2/c3 row g + 8
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(ks + swz<CPR>(n * 8 + (mi >> 1) * 8 + (lane & 7),
                                       2 * kk + (mi & 1)) * 8),
                b0, b1, b2, b3);
        mma_bf16(sc[n], qf[kk], b0, b1);
        mma_bf16(sc[n + 1], qf[kk], b2, b3);
      }
    }

    // scale into the log2 domain; mask the diagonal tile and keys past
    // valid_len
    const bool edge =
        (a.causal && k0 == t.q0) || k0 + kTk > a.valid_len;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * sl2;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * tq + (e & 1);
          const int qpos = qrow + (e >> 1) * 8;
          if (kpos >= a.valid_len || (a.causal && kpos > qpos)) x = -INFINITY;
        }
        sc[n][e] = x;
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row with every key so far masked keeps a max of -inf: subtract 0
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float al0 = ex2(m0 - base0), al1 = ex2(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = ex2(sc[n][0] - base0);
      sc[n][1] = ex2(sc[n][1] - base0);
      sc[n][2] = ex2(sc[n][2] - base1);
      sc[n][3] = ex2(sc[n][3] - base1);
      l0 += sc[n][0] + sc[n][1];
      l1 += sc[n][2] + sc[n][3];
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= al0;
      acc[d][1] *= al0;
      acc[d][2] *= al1;
      acc[d][3] *= al1;
    }

    // O += P V: P's accumulator tiles 2kc and 2kc + 1 are the A fragment
    // of keys [16kc, 16kc + 16)
#pragma unroll
    for (int kc = 0; kc < kTk / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(vs + swz<CPR>(kc * 16 + (mi & 1) * 8 + (lane & 7),
                                         d + (mi >> 1)) * 8),
                  b0, b1, b2, b3);
        mma_bf16(acc[d], pa, b0, b1);
        mma_bf16(acc[d + 1], pa, b2, b3);
      }
    }
    __syncthreads();              // every warp is done with this stage
  }

  // the quad's partial row sums; l > 0 (key 0 is never masked)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (a.lse != nullptr && tq == 0) {
    // m is the log2-domain max of scale * log2(e) * s, l the sum of
    // 2^(x - m): ln(sum e^(scale s)) = (m + log2 l) ln 2
    float* lr = a.lse + ((long long)t.bi * a.h + t.hi) * a.s;
    if (qrow < a.s) lr[qrow] = (m0 + log2f(l0)) * kLn2;
    if (qrow + 8 < a.s) lr[qrow + 8] = (m1 + log2f(l1)) * kLn2;
  }

  // the warp's own 16 rows of the q buffer take its output tile, which then
  // goes out 16 bytes a lane, real rows and chunks only
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    *reinterpret_cast<uint32_t*>(sq + swz<CPR>(r0, d) * 8 + 2 * tq) =
        pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(sq + swz<CPR>(r0 + 8, d) * 8 + 2 * tq) =
        pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
  }
  __syncwarp();
  auto* og = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CPR, c = idx % CPR;
    const int qpos = t.q0 + warp * 16 + r;
    if (qpos < a.s && c < creal)
      *reinterpret_cast<uint4*>(
          og + (((long long)t.bi * a.s + qpos) * a.h + t.hi) * a.hd + c * 8) =
          *reinterpret_cast<const uint4*>(sq + swz<CPR>(warp * 16 + r, c) * 8);
  }
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

constexpr int kBQf = 128;         // query rows per block (two threads each)
constexpr int kBKf = 64;          // keys per shared-memory tile
constexpr int kChunk = 16;        // keys per online-softmax update
constexpr int kThreadsF = 2 * kBQf;
constexpr float kNeg = -1e30f;

template <int HD>
__global__ void __launch_bounds__(kThreadsF)
flash_f32_kernel(const Args a) {
  constexpr int kHalf = HD / 2;
  extern __shared__ float smem[];
  float* ks = smem;               // [kBKf][HD]
  float* vs = smem + kBKf * HD;   // [kBKf][HD]

  const Tile t = tile_of(a, kBQf);
  const int tid = threadIdx.x;
  const int row = tid >> 1;       // query row within the tile
  const int half = tid & 1;       // which interleaved half of hd
  const int qpos = t.q0 + row;
  const int kvh = t.hi / a.group;
  const float* q = static_cast<const float*>(a.q) + t.bi * a.q_sb +
                   t.hi * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + t.bi * a.k_sb +
                   kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + t.bi * a.v_sb +
                   kvh * a.v_sh;

  float qr[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    qr[i] = qpos < a.s ? q[qpos * a.q_ss + 2 * i + half] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const int kv_end = a.causal ? min(t.q0 + kBQf, a.valid_len) : a.valid_len;

  for (int k0 = 0; k0 < kv_end; k0 += kBKf) {
    __syncthreads();              // every thread is done with the last tile
    for (int e = tid; e < kBKf * HD; e += kThreadsF) {
      const int kpos = k0 + e / HD, d = e % HD;
      const bool in = kpos < a.s;
      ks[e] = in ? k[kpos * a.k_ss + d] : 0.f;
      vs[e] = in ? v[kpos * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < kBKf; c0 += kChunk) {
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
        float sv = part * a.scale;
        if ((a.causal && kpos > qpos) || kpos >= a.valid_len) sv = kNeg;
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

  if (qpos < a.s) {
    float* o = static_cast<float*>(a.o) +
               (((long long)t.bi * a.s + qpos) * a.h + t.hi) * HD;
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) o[2 * i + half] = acc[i] * inv_l;
    if (a.lse != nullptr && half == 0)
      a.lse[((long long)t.bi * a.h + t.hi) * a.s + qpos] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int run(Kernel kern, const Args& a, int rows, int threads, int smem,
        cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)((a.s + rows - 1) / rows) * a.b * a.h;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int run_mma(const Args& a, cudaStream_t st) {
  return run(flash_mma_kernel<HD>, a, kTq, kThreads,
             (kTq + 4 * kTk) * HD * (int)sizeof(__nv_bfloat16), st);
}

template <int HD>
int run_f32(const Args& a, cudaStream_t st) {
  return run(flash_f32_kernel<HD>, a, kBQf, kThreadsF,
             2 * kBKf * HD * (int)sizeof(float), st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; o is a
// contiguous (b, s, h, hd) tensor; lse, when not null, a contiguous float32
// (b, h, s) tensor that takes each row's natural-log sum of exp(scale s)
// over its unmasked keys (the backward's input), for the s real rows.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int b, int s,
    int h, int kv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int valid_len, float scale,
    int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (kv <= 0 || h % kv != 0 || valid_len <= 0 || valid_len > s)
    return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    o,    lse,  q_sb,   q_ss,   q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss,   v_sh,   b,
               s,    h,    h / kv, hd, causal, valid_len, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    switch (hd) {
      case 8:                     // zero-padded to 16 in shared memory
      case 16: return run_mma<16>(a, st);
      case 32: return run_mma<32>(a, st);
      case 64: return run_mma<64>(a, st);
      case 112:                   // zero-padded to 128 in shared memory
      case 128: return run_mma<128>(a, st);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 8: return run_f32<8>(a, st);
      case 16: return run_f32<16>(a, st);
      case 32: return run_f32<32>(a, st);
      case 64: return run_f32<64>(a, st);
      case 112: return run_f32<112>(a, st);
      case 128: return run_f32<128>(a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
