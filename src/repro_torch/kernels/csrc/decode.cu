// Row-invariant decode kernels for Hopper (sm_90a).
//
// A decode step of the port's models is a handful of products and
// reductions over one token per sequence (its RMSNorms are norm.cu's).
// The library calls it used before (cuBLAS GEMMs, torch's row reductions,
// a masked softmax over the kv bucket) pick their algorithm, and so the
// order of each sum, from the number of rows and from the padded length: a
// request served in a batch of four then rounded differently from the same
// request served alone.
// Here every output of row r is computed by the same sequence of float32
// operations whatever the other rows are, how many there are, and how far
// the cache is padded:
//
//   * rows_matmul      out (M, N) = x (M, K) @ w, w (K, N) row-major or the
//                      transposed view of an (N, K) matrix (a tied head's
//                      embed.T).  Replaces cuBLAS on a decode step's
//                      projections and LM head.
//   * decode_attention one query token per sequence against keys
//                      [0, kv_len[b]) of its cache, in fixed runs of 64
//                      keys over a cluster of blocks, merged in order.
//   * ssm_decode_step  the Mamba2 recurrence for one token: state <- state *
//                      exp(dt A) + dt B x, y = C . state.
//
// No TPU kernel of the reference does this: the JAX package leaves these
// products to XLA.  The plain PyTorch versions are in kernels/decode/ref.py.
//
// Invariance.  Each output is summed in an order fixed by the shapes and
// the row's own length, never by M or the bucket: explicit fmaf chains, a
// fixed xor-shuffle tree, warps in order through shared memory, and in bf16
// the tensor cores' m16n8k16 step, whose output element depends on its own
// row of A and column of B alone (a row of x past M, or a q head past the
// group, yields only its own, unwritten, outputs).  Rows come in chunks of
// 16 by gridDim.y.  rows_matmul's K-slices leave float32 partials in a
// workspace the wrapper allocates; the column tile's last block to finish,
// elected by a ticket (__threadfence, then atomicAdd on a counter the
// wrapper keeps at zero between launches; the counters assume one device's
// launches run in stream order), sums them in slice order and resets the
// counter: the atomic only elects, no sum goes through it.
// decode_attention's blocks of a (row, kv head) form a thread-block cluster
// and merge in rank order through distributed shared memory.  Build without
// --use_fast_math (no contraction or reassociation beyond the explicit
// fmaf).
//
// Bound on this card: bytes.  M <= 16 rows against a weight of K x N is
// 2 M FLOP per weight element, far below the 295 FLOP a byte where the
// tensor cores would bind; decode attention reads each key and value once
// for G <= 16 query heads.  Measured cold, what limits both is what a block
// spends a step and a split in instructions and latency, so the designs
// keep each short: rows_matmul's grid comes from (K, N) and the SM count
// (kernels/decode/ops.py::rows_plan) and streams 16 KB stages; attention
// merges without a round trip through global memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // every kernel but ssm_decode_step
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
// rows_matmul, w (K, N) with N contiguous: a grid planned from K and N
//
// The wrapper's plan (kernels/decode/ops.py::rows_plan, from K, N, the
// type and the SM count, never from M) gives a column tile of TN = 256,
// 128 or 64 columns and K-slices of ks rows, a multiple of 16: one block a
// (column tile, K-slice, chunk of 16 rows of x).  A block streams its
// slice through a ring of kStages stages of 16 KB: KB = 16384 / (TN *
// sizeof(T)) weight rows, one contiguous run of TN columns each, and the
// same KB columns of x's rows, by 16-byte cp.async into XOR-swizzled
// shared memory (dynamic, 68-80 KB: two blocks an SM); stages s + 1 .. s +
// 3 (48 KB) are in flight while stage s is consumed.  Each thread issues
// four weight copies and at most one of x a stage from addresses it works
// out once: a block's rate is set by what a stage costs in instructions
// more than by the memory's latency, so stages are large and cheap to
// issue.  (One bulk copy (TMA) a 128-512 byte row costs more a stage.)
//
//   bf16   the stage's KB / 16 k16 steps go one to a warp, and each warp
//          covers 64 columns: per stage a warp loads one A fragment (the
//          16 rows of x; a row past M gives only its own, unwritten,
//          outputs), four B fragments by ldmatrix.trans and runs eight
//          mma.sync m16n8k16 into float32 accumulators.  After the slice
//          the warps that share columns add their sums in warp order
//          through shared memory.  At M = 16 the tensor cores keep the
//          product far below the weight's bytes, where FMA would need 80%
//          of the card's float32 rate.
//   float  warp w owns TN / 8 columns as TN / 32 float4 groups; its lanes
//          split each stage's rows, four a lane; each thread keeps an fmaf
//          chain per (row, column) over its rows in increasing k, then a
//          fixed xor tree sums the lanes of a column group.
//
// With one slice the block writes the output; with several each writes
// float32 partials to the workspace (splits, M, N), and the last block of
// the column tile to finish (the ticket) sums them in slice order.  Weight
// rows and x columns past the slice are zeros (each adds exactly zero);
// columns past N feed only outputs that are not written.
//
// Which copies fill a stage depends on the addresses alone
// (ops.py::weight_copy; the same stage layout and consume step whatever
// fills it, so every output is the same products summed in the same
// order):
//   16    every row of w on the 16-byte grid and N whole vectors: each
//         thread copies 16-byte chunks at addresses it works out once;
//   8, 4  rows 8- or 4-byte aligned (bf16 with an even row stride and an
//         even N, as whisper's head of 51866 columns, rows 103,732 bytes
//         apart; any float32): a warp a row, its lanes copying the row's
//         consecutive units by cp.async, each unit the widest the row's
//         address allows (16, 8 or 4 bytes: whisper's rows cycle through
//         16, 4, 8, 4; on the H100 faster than 4-byte units throughout),
//         a shorter source size zero-filling past N; each warp instruction
//         reads one contiguous run of the row and nothing waits on a load;
//   0     an odd N in bf16 or rows off the 4-byte grid (N = 4099): each
//         element is loaded and stored alone, zeros past K and N.
// x takes 16-byte copies when its rows are on the 16-byte grid and K is
// whole vectors (whisper's K of 1280 is), and elements otherwise.
// ---------------------------------------------------------------------------

// The widest cp.async, 16, 8 or 4 bytes, that the address allows.
__device__ __forceinline__ int widest(const void* p) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  return (u & 15) == 0 ? 16 : (u & 7) == 0 ? 8 : 4;
}

// `cw` (16, 8 or 4) bytes from global to shared memory, of which the first
// `valid` are read and the rest zero-filled; with none valid, zeros are
// stored and nothing is read (the address may lie past the weight).
__device__ __forceinline__ void copy_narrow(uint32_t dst, const void* src,
                                            int cw, int valid) {
  if (valid == 0) {
    if (cw == 16)
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst),
                   "r"(0));
    else if (cw == 8)
      asm volatile("st.shared.v2.u32 [%0], {%1, %1};\n" ::"r"(dst), "r"(0));
    else
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(0));
  } else if (cw == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  } else if (cw == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  }
}

constexpr int kStageBytes = 16384;
constexpr int kStages = 4;

struct RowsArgs {
  const void* x;
  long long xs;
  const void* w;
  long long wsk;
  void* out;
  long long os;
  float* part;       // (splits, m, n) float32 partials when splits > 1
  int* counters;     // one a (column tile, row chunk); zero between launches
  int m, k, n, ks, splits;
  int w_copy;        // the weight's copy width: 16, 8, 4 or 0 (elements)
  int x_copies;      // x's rows on the 16-byte grid, K whole vectors
};

template <typename T, int TN>
struct RowsTile {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int KB = kStageBytes / (TN * (int)sizeof(T));
  static constexpr int WCH = TN / VEC;   // 16-byte chunks of a weight row
  static constexpr int XCH = KB / VEC;   // 16-byte chunks of a stage's x row
  static constexpr int WPT = KB * WCH / kThreads;   // weight copies a thread
  static constexpr int WST = KB * TN;                // elements a w stage
  static constexpr int XST = kRowsPerBlock * KB;     // elements an x stage
  static constexpr int SMEM = kStages * (WST + XST) * (int)sizeof(T);
};

template <typename T, int TN, int MT>
__global__ void __launch_bounds__(kThreads, 2)
rows_matmul_kn_kernel(const RowsArgs a) {
  using L = RowsTile<T, TN>;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  T* const wst = reinterpret_cast<T*>(ring_smem);
  T* const xst = wst + kStages * L::WST;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int splits = a.splits, tiles = gridDim.x / splits;
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int n0 = tile * TN, m0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, a.m - m0);
  const int k0 = split * a.ks, k1 = min(a.k, k0 + a.ks);
  const int nst = (k1 - k0 + L::KB - 1) / L::KB;
  const T* w = (const T*)a.w;
  const T* x = (const T*)a.x;
  T* out = (T*)a.out;

  // this thread's copies: weight chunk column wc of rows wr + j KB / WPT,
  // x chunk (xr, xc) when xr < rows
  const int wc = threadIdx.x % L::WCH, wr = threadIdx.x / L::WCH;
  const int xr = threadIdx.x / L::XCH, xc = threadIdx.x % L::XCH;
  const bool wcol = n0 + wc * L::VEC < a.n;
  const T* wsrc = w + (long long)(k0 + wr) * a.wsk + n0 + wc * L::VEC;
  const T* xsrc = x + (long long)(m0 + xr) * a.xs + k0 + xc * L::VEC;
  const long long wstep = (long long)L::KB * a.wsk;
  auto load = [&](int t) {
    const int slot = t % kStages, kb0 = k0 + t * L::KB;
    T* ws = wst + slot * L::WST;
    T* xs = xst + slot * L::XST;
    if (a.w_copy == 16) {
#pragma unroll
      for (int j = 0; j < L::WPT; ++j) {
        const int r = wr + j * (L::KB / L::WPT);
        const bool ok = wcol && kb0 + r < k1;
        sm90::cp_async16(
            sm90::smem_u32(ws + sm90::swz<L::WCH>(r, wc) * L::VEC),
            ok ? wsrc + t * wstep + (long long)j * (L::KB / L::WPT) * a.wsk
               : w,
            ok);
      }
    } else if (a.w_copy) {
      // a warp a row, in units of the widest copy the row's address allows
      // (cp.async needs source and destination on its size, and the stage
      // rows are on the 16-byte grid): unit u of `cw` bytes is bytes [u cw,
      // u cw + cw) of the row's TN columns, in chunk u cw / 16 of the
      // swizzled layout.  A stage costs in cp.async instructions more than
      // in bytes, so a row of 4-byte units costs 4x one of 16-byte units.
      // warp w takes rows [w KB / 8, (w + 1) KB / 8): consecutive rows mix
      // the classes of a stride off the grid (whisper's cycle through 16,
      // 4, 8, 4 bytes), so the warps issue about as many copies each
      constexpr int RB = TN * (int)sizeof(T), RW = L::KB / (kThreads / 32);
      for (int r = warp * RW; r < (warp + 1) * RW; ++r) {
        const int kk = kb0 + r;
        const char* grow = reinterpret_cast<const char*>(
            w + (long long)kk * a.wsk + n0);
        const int valid = kk < k1 ? (a.n - n0) * (int)sizeof(T) : 0;
        const int cw = widest(grow);
        for (int ub = lane * cw; ub < RB; ub += 32 * cw)
          copy_narrow(sm90::smem_u32(ws) +
                          sm90::swz<L::WCH>(r, ub >> 4) * 16 + (ub & 15),
                      grow + ub, cw, min(max(valid - ub, 0), cw));
      }
    } else {
      for (int i = threadIdx.x; i < L::KB * TN; i += kThreads) {
        const int r = i / TN, c = i % TN;
        const int kk = kb0 + r, col = n0 + c;
        ws[sm90::swz<L::WCH>(r, c / L::VEC) * L::VEC + c % L::VEC] =
            kk < k1 && col < a.n ? w[(long long)kk * a.wsk + col]
                                 : from_f32<T>(0.f);
      }
    }
    if (a.x_copies) {
      if (xr < rows) {
        const bool ok = kb0 + xc * L::VEC < k1;
        sm90::cp_async16(
            sm90::smem_u32(xs + sm90::swz<L::XCH>(xr, xc) * L::VEC),
            ok ? xsrc + t * L::KB : x, ok);
      }
    } else {
      for (int i = threadIdx.x; i < kRowsPerBlock * L::KB; i += kThreads) {
        const int r = i / L::KB, c = i % L::KB;
        xs[sm90::swz<L::XCH>(r, c / L::VEC) * L::VEC + c % L::VEC] =
            r < rows && kb0 + c < k1 ? x[(long long)(m0 + r) * a.xs + kb0 + c]
                                     : from_f32<T>(0.f);
      }
    }
  };
  // the ring: stage s is consumed while s + 1 .. s + kStages - 1 load
  auto ring = [&](auto&& consume) {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < nst) load(t);
      sm90::cp_async_commit();
    }
    for (int s = 0; s < nst; ++s) {
      sm90::cp_async_wait<kStages - 2>();
      __syncthreads();     // stage s is in; every warp is done with s - 1
      if (s + kStages - 1 < nst) load(s + kStages - 1);
      sm90::cp_async_commit();
      consume(wst + (s % kStages) * L::WST, xst + (s % kStages) * L::XST);
    }
  };
  // one output of row r: the result, or this slice's partial
  auto emit = [&](int r, int col, float v) {
    if (r >= rows || col >= a.n) return;
    if (splits == 1)
      out[(long long)(m0 + r) * a.os + col] = from_f32<T>(v);
    else
      a.part[((long long)split * a.m + m0 + r) * a.n + col] = v;
  };

  if constexpr (sizeof(T) == 2) {
    constexpr int WK = L::KB / 16;         // warps along k: a k16 step each
    constexpr int WN = 8 / WK;             // warps along n: 64 columns each
    static_assert(WK * WN == kThreads / 32 && TN == 64 * WN, "warp grid");
    const int wk = warp % WK, cb = (warp / WK) * 8, mi = lane >> 3;
    float acc[8][4] = {};
    ring([&](const T* ws, const T* xs) {
      uint32_t af[4];
      sm90::ldsm_x4(sm90::smem_u32(xs + sm90::swz<L::XCH>(
                                            lane & 15, 2 * wk + (lane >> 4)) *
                                            8),
                    af[0], af[1], af[2], af[3]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b0, b1, b2, b3;
        sm90::ldsm_x4_t(
            sm90::smem_u32(ws + sm90::swz<L::WCH>(
                                    wk * 16 + (mi & 1) * 8 + (lane & 7),
                                    cb + j + (mi >> 1)) *
                                    8),
            b0, b1, b2, b3);
        sm90::mma_bf16(acc[j], af, b0, b1);
        sm90::mma_bf16(acc[j + 1], af, b2, b3);
      }
    });
    // the WK warps of a column group, added in warp order
    sm90::cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(ring_smem);   // [WK][16][TN]
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* dst = red + (wk * kRowsPerBlock + g + 8 * half) * TN +
                     (cb + j) * 8 + 2 * tq;
        dst[0] = acc[j][2 * half];
        dst[1] = acc[j][2 * half + 1];
      }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * TN; i += kThreads) {
      const int r = i / TN, c = i % TN;
      float v = red[r * TN + c];
#pragma unroll
      for (int q = 1; q < WK; ++q) v += red[(q * kRowsPerBlock + r) * TN + c];
      emit(r, n0 + c, v);
    }
  } else {
    constexpr int CG = TN / 32;            // float4 column groups a warp
    constexpr int KL = 32 / CG;            // lanes splitting a stage's rows
    const int cg = lane % CG, kl = lane / CG, chunk = warp * CG + cg;
    float acc[MT][4] = {};
    ring([&](const T* ws, const T* xs) {
#pragma unroll
      for (int u = 0; u < L::KB / KL; ++u) {
        const int r = kl + u * KL;
        const float4 wv = *reinterpret_cast<const float4*>(
            ws + sm90::swz<L::WCH>(r, chunk) * 4);
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) {
          const float xv = xs[sm90::swz<L::XCH>(mm, r >> 2) * 4 + (r & 3)];
          acc[mm][0] = fmaf(xv, wv.x, acc[mm][0]);
          acc[mm][1] = fmaf(xv, wv.y, acc[mm][1]);
          acc[mm][2] = fmaf(xv, wv.z, acc[mm][2]);
          acc[mm][3] = fmaf(xv, wv.w, acc[mm][3]);
        }
      }
    });
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = acc[mm][e];
#pragma unroll
        for (int o = CG; o < 32; o <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (kl == 0) emit(mm, n0 + chunk * 4 + e, v);
      }
  }
  if (splits == 1) return;

  // the ticket: the column tile's last slice to finish sums the partials
  __threadfence();
  __syncthreads();
  int* ctr = a.counters + tile + tiles * blockIdx.y;
  int ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(ctr, 1);
  if (!__syncthreads_or(threadIdx.x == 0 && ticket == splits - 1)) return;
  __threadfence();
  const long long plane = (long long)a.m * a.n;
  for (int i = threadIdx.x; i < rows * TN; i += kThreads) {
    const int r = i / TN, col = n0 + i % TN;
    if (col >= a.n) continue;
    const float* p = a.part + (long long)(m0 + r) * a.n + col;
    float s = 0.f;
    for (int q0 = 0; q0 < splits; q0 += 8) {   // 8 loads in flight
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = q0 + q < splits ? __ldcg(p + (q0 + q) * plane) : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < splits) s = q0 + q == 0 ? v[q] : s + v[q];
    }
    out[(long long)(m0 + r) * a.os + col] = from_f32<T>(s);
  }
  if (threadIdx.x == 0) *ctr = 0;
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

template <typename T, int TN, int MT>
cudaError_t launch_rows_tile(const RowsArgs& a, cudaStream_t st) {
  constexpr int smem = RowsTile<T, TN>::SMEM;
  static bool allowed = false;           // the opt-in above 48 KB, once
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_matmul_kn_kernel<T, TN, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  const dim3 grid(((a.n + TN - 1) / TN) * a.splits,
                  (a.m + kRowsPerBlock - 1) / kRowsPerBlock);
  rows_matmul_kn_kernel<T, TN, MT><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int MT>
cudaError_t launch_rows_kn(const RowsArgs& a, int tn, cudaStream_t st) {
  if (tn == 256) return launch_rows_tile<T, 256, MT>(a, st);
  if (tn == 128) return launch_rows_tile<T, 128, MT>(a, st);
  if (tn == 64) return launch_rows_tile<T, 64, MT>(a, st);
  return cudaErrorInvalidValue;
}

template <typename T, int MT>
cudaError_t launch_rows_nk(const void* x, long long xs, const void* w,
                           long long wsn, void* out, long long os, int m,
                           int k, int n, cudaStream_t st) {
  const dim3 grid((n + kThreads / 32 - 1) / (kThreads / 32),
                  (m + kRowsPerBlock - 1) / kRowsPerBlock);
  rows_matmul_nk_kernel<T, MT><<<grid, kThreads, 0, st>>>(
      (const T*)x, xs, (const T*)w, wsn, (T*)out, os, m, k, n);
  return cudaGetLastError();
}

// The (K, N) path's bf16 kernel keeps 16 rows of x in A whatever M is;
// its float32 one and the (N, K) path keep MT rows of accumulators.
template <typename T>
cudaError_t dispatch_rows(const RowsArgs& a, long long wsn, int tn,
                          cudaStream_t st) {
  auto by_rows = [&](auto launch) {
    const int mt = a.m < kRowsPerBlock ? a.m : kRowsPerBlock;
    if (mt <= 1) return launch(std::integral_constant<int, 1>());
    if (mt <= 2) return launch(std::integral_constant<int, 2>());
    if (mt <= 4) return launch(std::integral_constant<int, 4>());
    if (mt <= 8) return launch(std::integral_constant<int, 8>());
    return launch(std::integral_constant<int, 16>());
  };
  if (wsn != 1)
    return by_rows([&](auto mt) {
      return launch_rows_nk<T, decltype(mt)::value>(
          a.x, a.xs, a.w, wsn, a.out, a.os, a.m, a.k, a.n, st);
    });
  if constexpr (sizeof(T) == 2)
    return launch_rows_kn<T, kRowsPerBlock>(a, tn, st);
  else
    return by_rows([&](auto mt) {
      return launch_rows_kn<T, decltype(mt)::value>(a, tn, st);
    });
}

// ---------------------------------------------------------------------------
// decode_attention: a cluster of C blocks a (row b, kv head)
//
// Row b's keys [0, len), len = min(kv_len[b], S), fall in splits of kSplit
// = 64 keys from key 0; block r of the cluster takes splits r, r + C, r +
// 2 C, ... below len, and a block without one leaves at once.  C (8, or 4
// past 8 kv heads: ops.py::attention_cluster) is a model constant, and
// the grid (C, kv heads, B) does not depend on the bucket S, so the bucket
// never moves a split.  A block, its G q heads together, for each of its
// splits in order:
//   load    k and v rows by 16-byte cp.async in their own type, each row
//           padded to an odd number of 16-byte units (distinct banks for
//           the eight rows an ldmatrix or the score loop reads);
//   scores  q . k rounded to q's type (the plain version's einsum output),
//           times the scale.  bf16 q and cache with hd a multiple of 16:
//           mma.sync m16n8k16, the G heads zero-padded to 16 rows of A and
//           the keys as B, four warps of 16 keys, float32 accumulators in
//           k16 steps of increasing d.  Otherwise one thread a (key, q
//           head), an fmaf chain over d in increasing order;
//   softmax one warp a q head: the split's max (exact), p = exp(s - m) for
//           its keys, their sum by a fixed xor tree; p rounded to q's type;
//   p . v   bf16 (as scores): mma.sync with p as A (16 rows, 64 keys) and v
//           through ldmatrix.trans as B, each warp 16 columns of d, in k16
//           steps of increasing key.  Otherwise KS groups of consecutive
//           keys (KS = 8, 4, 2 or 1, set by G and hd alone), each an fmaf
//           chain per (head, d) over its keys in order, the groups summed
//           in order;
//   fold    into the block's running (m, l, acc[G][hd]): m' = max(m, m_s),
//           acc <- acc exp(m - m') + acc_s exp(m_s - m'), l likewise.
// Then the cluster's blocks that have a split merge in rank order through
// distributed shared memory, each a share of the outputs: M = max_r m_r
// (exact), acc = sum_r acc_r exp(m_r - M), l = sum_r l_r exp(m_r - M)
// (fmaf chains in rank order), out = acc / l in q's type.  Which splits
// exist, which block and path takes each, and
// every sum's order follow from the shapes and len alone; a head's row of
// A, like a row of x in rows_matmul, yields its own outputs only.
//
// Bound by the cache's bytes: a split reads its 64 keys of k and v once.
// What costs time is latency, so the design shortens the chain: the merge
// reads its peers' shared memory after one cluster barrier, where a merge
// through global memory needs a fence, an elected last block and reads
// back from L2 (up to 2 us a split); on the tensor cores a split of
// llama3-405b's group (16 heads of 128) is 128 mma.sync against 2,000 FMA
// instructions a thread; 64 registers a thread keep four blocks an SM; and
// no block without a split holds a slot.
// ---------------------------------------------------------------------------

constexpr int kSplit = 64;            // keys a split
constexpr int kCluster = 8;           // the most blocks a (row, kv head)
constexpr int kPst = kSplit + 8;      // elements a padded row of bf16 p

__host__ __device__ inline bool attn_mma(int q_size, int kv_size, int hd) {
  return q_size == 2 && kv_size == 2 && hd % 16 == 0;
}

// Byte offsets of a block's shared memory: its running acc (float
// [G][hd]), q (float [G][hd], or bf16 [16][rst] on the mma path), scores
// (float [G][64]), p (bf16 [16][kPst], mma path), the key groups' partial
// sums (float, FMA path with KS > 1), k and v rows.
struct AttnLayout {
  int acc, q, sc, p, red, k, v, bytes;
  int rst;                            // elements a padded k, v (or q) row
  int ks;                             // key groups of the FMA p . v
  __host__ __device__ AttnLayout(int g, int hd, int q_size, int kv_size) {
    const int vch = hd * kv_size / 16;
    const bool mma = attn_mma(q_size, kv_size, hd);
    rst = (vch | 1) * 16 / kv_size;
    ks = 1;
    while (!mma && ks < 8 && 2 * ks * g * vch <= kThreads) ks *= 2;
    acc = 0;
    q = acc + 4 * g * hd;
    sc = q + (mma ? 2 * 16 * rst : 4 * g * hd);
    p = sc + 4 * g * kSplit;
    red = p + (mma ? 2 * 16 * kPst : 0);
    k = red + (ks > 1 ? 4 * ks * g * hd : 0);
    v = k + kSplit * rst * kv_size;
    bytes = v + kSplit * rst * kv_size;
  }
};

struct AttnArgs {
  const void* q;
  long long qsb, qsh;
  const void* k;
  const void* v;
  long long ksb, kss, ksh, vsb, vss, vsh;
  const int* kv_len;
  void* out;
  int s_max, h, kvh, hd;
  int cluster;       // blocks a (row, kv head): 1, 2, 4 or 8
  float scale;
};

// VEC consecutive elements from shared memory as floats: one 16-byte load.
template <typename T>
__device__ __forceinline__ void smem_vec(const T* p, float* out);
template <>
__device__ __forceinline__ void smem_vec<__nv_bfloat16>(
    const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void smem_vec<float>(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads, 4)
decode_attention_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Vec<TKV>::n;
  constexpr int kWarps = kThreads / 32;
  constexpr bool kBf16 = sizeof(TQ) == 2 && sizeof(TKV) == 2;
  const int G = a.h / a.kvh, hd = a.hd, vch = hd / V;
  const bool mma = attn_mma(sizeof(TQ), sizeof(TKV), hd);
  const AttnLayout L(G, hd, sizeof(TQ), sizeof(TKV));
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  TQ* ph = reinterpret_cast<TQ*>(smem + L.p);    // mma path: bf16 p
  TKV* kst = reinterpret_cast<TKV*>(smem + L.k);
  TKV* vst = reinterpret_cast<TKV*>(smem + L.v);
  // the block's running max and sum, and a split's rescale factors
  __shared__ float m_run[kMaxGroup], l_run[kMaxGroup];
  __shared__ float alpha[kMaxGroup], beta[kMaxGroup];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), g0 = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(a.kv_len[b], a.s_max);
  const int live = len > 0 ? (len + kSplit - 1) / kSplit : 0;
  TQ* orow = (TQ*)a.out + ((long long)b * a.h + (long long)g0 * G) * hd;
  if (live == 0) {                    // a row with no key: zeros
    for (int i = tid + rank * kThreads; i < G * hd; i += a.cluster * kThreads)
      orow[i] = from_f32<TQ>(0.f);
    return;                           // the whole cluster returns
  }
  // blocks past the row's splits leave at once (the cluster barrier waits
  // for threads that have not exited) and take no part in the merge
  const int active = min(live, a.cluster);
  if (rank >= active) return;
  for (int i = tid; i < G * hd; i += kThreads) acc[i] = 0.f;
  if (tid < G) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  {                                   // q, once
    const TQ* qb = (const TQ*)a.q + b * a.qsb + (long long)g0 * G * a.qsh;
    if (mma) {                        // bf16 [16][rst], rows past G zero
      TQ* qh = reinterpret_cast<TQ*>(smem + L.q);
      for (int i = tid; i < 16 * hd; i += kThreads) {
        const int g = i / hd, d = i % hd;
        qh[g * L.rst + d] = g < G ? qb[g * a.qsh + d] : from_f32<TQ>(0.f);
      }
      for (int i = tid; i < (16 - G) * kSplit; i += kThreads)
        ph[(G + i / kSplit) * kPst + i % kSplit] = from_f32<TQ>(0.f);
    } else {
      float* qs = reinterpret_cast<float*>(smem + L.q);
      for (int i = tid; i < G * hd; i += kThreads)
        qs[i] = to_f32(qb[(i / hd) * a.qsh + i % hd]);
    }
  }
  const int mi = lane >> 3, g8 = lane >> 2, tq = lane & 3;

  for (int split = rank; split < live; split += a.cluster) {
    const int c0 = split * kSplit, n_keys = min(kSplit, len - c0);
    const TKV* kb = (const TKV*)a.k + b * a.ksb + (long long)g0 * a.ksh +
                    (long long)c0 * a.kss;
    const TKV* vb = (const TKV*)a.v + b * a.vsb + (long long)g0 * a.vsh +
                    (long long)c0 * a.vss;
    __syncthreads();                  // the last split's readers are done
    for (int i = tid; i < kSplit * vch; i += kThreads) {
      const int j = i / vch, c = i % vch;
      const bool ok = j < n_keys;
      sm90::cp_async16(sm90::smem_u32(kst + j * L.rst + c * V),
                       ok ? kb + j * a.kss + c * V : kb, ok);
    }
    sm90::cp_async_commit();
    for (int i = tid; i < kSplit * vch; i += kThreads) {
      const int j = i / vch, c = i % vch;
      const bool ok = j < n_keys;
      sm90::cp_async16(sm90::smem_u32(vst + j * L.rst + c * V),
                       ok ? vb + j * a.vss + c * V : vb, ok);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();

    if constexpr (kBf16) {
      if (mma && warp < kSplit / 16) {  // scores: 16 keys a warp
        const TQ* qh = reinterpret_cast<const TQ*>(smem + L.q);
        float c[2][4] = {};
        for (int kk = 0; kk < hd / 16; ++kk) {
          uint32_t af[4], b0, b1, b2, b3;
          sm90::ldsm_x4(sm90::smem_u32(qh + (lane & 15) * L.rst + kk * 16 +
                                       (lane >> 4) * 8),
                        af[0], af[1], af[2], af[3]);
          sm90::ldsm_x4(sm90::smem_u32(kst + (warp * 16 + (mi >> 1) * 8 +
                                              (lane & 7)) * L.rst +
                                       kk * 16 + (mi & 1) * 8),
                        b0, b1, b2, b3);
          sm90::mma_bf16(c[0], af, b0, b1);
          sm90::mma_bf16(c[1], af, b2, b3);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int g = g8 + 8 * (e >> 1);
            const int j = warp * 16 + t * 8 + 2 * tq + (e & 1);
            if (g < G && j < n_keys)
              sc[g * kSplit + j] = to_f32(from_f32<TQ>(c[t][e])) * a.scale;
          }
      }
    }
    if (!mma) {  // scores: thread (key j, heads gb, gb + 4, ...)
      const float* qs = reinterpret_cast<const float*>(smem + L.q);
      const int j = tid % kSplit, gb = tid / kSplit;
      if (j < n_keys && gb < G) {
        float dot[kMaxGroup / 4] = {};
        const TKV* kr = kst + j * L.rst;
        for (int c = 0; c < vch; ++c) {
          float kf[V];
          smem_vec<TKV>(kr + c * V, kf);
#pragma unroll
          for (int u = 0; u < kMaxGroup / 4; ++u) {
            const int g = gb + 4 * u;
            if (g < G) {
              const float* qr = qs + g * hd + c * V;
#pragma unroll
              for (int e = 0; e < V; ++e) dot[u] = fmaf(qr[e], kf[e], dot[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kMaxGroup / 4; ++u) {
          const int g = gb + 4 * u;
          if (g < G)
            sc[g * kSplit + j] = to_f32(from_f32<TQ>(dot[u])) * a.scale;
        }
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* s = sc + g * kSplit;
      const float s0 = lane < n_keys ? s[lane] : -INFINITY;
      const float s1 = lane + 32 < n_keys ? s[lane + 32] : -INFINITY;
      const float m = warp_max(fmaxf(s0, s1));
      const float p0 = lane < n_keys ? expf(s0 - m) : 0.f;
      const float p1 = lane + 32 < n_keys ? expf(s1 - m) : 0.f;
      const float l = warp_sum(p0 + p1);
      if (mma) {
        ph[g * kPst + lane] = from_f32<TQ>(p0);
        ph[g * kPst + lane + 32] = from_f32<TQ>(p1);
      } else {
        s[lane] = to_f32(from_f32<TQ>(p0));
        s[lane + 32] = to_f32(from_f32<TQ>(p1));
      }
      if (lane == 0) {                // the fold's factors
        const float mn = fmaxf(m_run[g], m);
        alpha[g] = expf(m_run[g] - mn);
        beta[g] = expf(m - mn);
        l_run[g] = fmaf(l, beta[g], __fmul_rn(l_run[g], alpha[g]));
        m_run[g] = mn;
      }
    }
    sm90::cp_async_wait<0>();
    __syncthreads();

    // p . v, folded into acc by the thread that owns each (head, d)
    auto fold = [&](int g, int d, float v) {
      acc[g * hd + d] = fmaf(v, beta[g], __fmul_rn(acc[g * hd + d], alpha[g]));
    };
    if constexpr (kBf16) {
      if (mma && 2 * warp < hd / 8) {   // 16 columns of d a warp
        float o[2][4] = {};
#pragma unroll
        for (int kc = 0; kc < kSplit / 16; ++kc) {
          uint32_t pa[4], b0, b1, b2, b3;
          sm90::ldsm_x4(sm90::smem_u32(ph + (lane & 15) * kPst + kc * 16 +
                                       (lane >> 4) * 8),
                        pa[0], pa[1], pa[2], pa[3]);
          sm90::ldsm_x4_t(sm90::smem_u32(vst + (kc * 16 + (mi & 1) * 8 +
                                                (lane & 7)) * L.rst +
                                         (2 * warp + (mi >> 1)) * 8),
                          b0, b1, b2, b3);
          sm90::mma_bf16(o[0], pa, b0, b1);
          sm90::mma_bf16(o[1], pa, b2, b3);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int g = g8 + 8 * (e >> 1);
            if (g < G) fold(g, (2 * warp + t) * 8 + 2 * tq + (e & 1), o[t][e]);
          }
      }
    }
    if (!mma) {  // item (key group kq, head g, 16-byte unit c of d)
      float* red = reinterpret_cast<float*>(smem + L.red);
      const int work = G * vch, per = kSplit / L.ks;
      for (int it = tid; it < L.ks * work; it += kThreads) {
        const int kq = it / work, g = it % work / vch, c = it % vch;
        const int j1 = min(n_keys, (kq + 1) * per);
        float o[V] = {};
#pragma unroll 4
        for (int j = kq * per; j < j1; ++j) {
          const float p = sc[g * kSplit + j];
          float vf[V];
          smem_vec<TKV>(vst + j * L.rst + c * V, vf);
#pragma unroll
          for (int e = 0; e < V; ++e) o[e] = fmaf(p, vf[e], o[e]);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (L.ks > 1)
            red[(kq * G + g) * hd + c * V + e] = o[e];
          else
            fold(g, c * V + e, o[e]);
        }
      }
      if (L.ks > 1) {
        __syncthreads();
        for (int i = tid; i < G * hd; i += kThreads) {
          float s = red[i];
          for (int kq = 1; kq < L.ks; ++kq) s += red[kq * G * hd + i];
          fold(i / hd, i % hd, s);
        }
      }
    }
  }

  // the cluster's merge: block r the outputs [r P, (r + 1) P)
  cluster.sync();
  const int share = (G * hd + active - 1) / active;
  for (int i = rank * share + tid; i < min(G * hd, (rank + 1) * share);
       i += kThreads) {
    const int g = i / hd;
    float m[kCluster], l[kCluster], v[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      if (r < active) {
        m[r] = *cluster.map_shared_rank(m_run + g, r);
        l[r] = *cluster.map_shared_rank(l_run + g, r);
        v[r] = *cluster.map_shared_rank(acc + i, r);
      }
    }
    float top = m[0];
#pragma unroll
    for (int r = 1; r < kCluster; ++r)
      if (r < active) top = fmaxf(top, m[r]);
    float sum = 0.f, sl = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      if (r < active) {
        const float w = expf(m[r] - top);
        sum = fmaf(v[r], w, sum);
        sl = fmaf(l[r], w, sl);
      }
    }
    orow[i] = from_f32<TQ>(sum / sl);
  }
  cluster.sync();                     // no block leaves while read
}

template <typename TQ, typename TKV>
cudaError_t launch_attention(const AttnArgs& a, int b, cudaStream_t st) {
  const size_t smem =
      AttnLayout(a.h / a.kvh, a.hd, sizeof(TQ), sizeof(TKV)).bytes;
  static size_t allowed = 48 * 1024;   // raised once an instantiation grows
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.kvh, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_attention_kernel<TQ, TKV>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// tn and ks: the plan of the (K, N) path (ops.py::rows_plan): columns a
// block, 64, 128 or 256, and rows of K a slice, a multiple of 16.  With
// more than one slice, part holds (splits, m, n) float32 and counters one
// zero int a (column tile, chunk of 16 rows); both unused by the (N, K)
// path.
extern "C" int rows_matmul_launch(const void* x, long long xs, const void* w,
                                  long long wsk, long long wsn, void* out,
                                  long long os, float* part, int* counters,
                                  int m, int k, int n, int tn, int ks,
                                  int w_copy, int dtype,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || m > 65535 * kRowsPerBlock || (wsn != 1 && wsk != 1))
    return (int)cudaErrorInvalidValue;
  const int splits = wsn == 1 ? (ks > 0 ? (k + ks - 1) / ks : 0) : 1;
  if (wsn == 1 && (ks <= 0 || ks % 16 ||
                   (splits > 1 && (part == nullptr || counters == nullptr))))
    return (int)cudaErrorInvalidValue;
  const int vec = dtype == 1 ? 8 : 4, size = dtype == 1 ? 2 : 4;
  // the weight's copy width (ops.py::weight_copy), checked against the
  // addresses: each row's start and the bytes of N divisible by it
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const long long row_bytes = wsk * size, n_bytes = (long long)n * size;
  if (wsn == 1 && w_copy != 0 &&
      ((w_copy != 16 && w_copy != 8 && w_copy != 4) || wa % w_copy ||
       row_bytes % w_copy || n_bytes % (w_copy == 16 ? 16 : 4)))
    return (int)cudaErrorInvalidValue;
  RowsArgs a{x, xs, w, wsk, out, os, part, counters, m, k, n, ks, splits,
             w_copy,
             reinterpret_cast<uintptr_t>(x) % 16 == 0 && xs % vec == 0 &&
                 k % vec == 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch_rows<float>(a, wsn, tn, st);
  if (dtype == 1) return (int)dispatch_rows<__nv_bfloat16>(a, wsn, tn, st);
  return (int)cudaErrorInvalidValue;
}

// q_dtype / kv_dtype: (1, 1), (0, 1) (a bf16 cache under float32 params) or
// (0, 0).  out is (B, 1, H, hd) contiguous in q's type; cluster is the
// blocks a (row, kv head) (ops.py::attention_cluster).
extern "C" int decode_attention_launch(
    const void* q, long long qsb, long long qsh, const void* k,
    const void* v, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, const int* kv_len, void* out, int b,
    int s_max, int h, int kvh, int hd, int cluster, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  if (b <= 0) return 0;
  if (kvh <= 0 || h % kvh || h / kvh > kMaxGroup || hd <= 0 ||
      hd > kMaxHd || hd % (kv_dtype == 1 ? 8 : 4) || s_max <= 0 ||
      b > 65535 || kvh > 65535 || cluster < 1 || cluster > kCluster ||
      (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const AttnArgs a{q,   qsb,    qsh, k,     v,  ksb, kss, ksh,     vsb,
                   vss, vsh, kv_len, out, s_max, h, kvh, hd, cluster, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch_attention<__nv_bfloat16, __nv_bfloat16>(a, b, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch_attention<float, __nv_bfloat16>(a, b, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch_attention<float, float>(a, b, st);
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
