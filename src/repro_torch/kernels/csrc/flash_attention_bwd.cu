// Backward of flash attention (GQA), causal or not, for Hopper (sm_90a).
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
// head h / group.  Causal or not (whisper's encoder), every key below S
// valid.  Returns dq (B, S, H,
// hd) and dk, dv (B, S, KV, hd), contiguous, in bf16; dk and dv are summed
// over the group's q heads.  Arithmetic as `_blocked_bwd_rule`:
//   delta = rowsum(do * o)                     (float32)
//   P     = exp(scale q.k - lse)               (float32, here 2^x with
//                                               scale * log2 e folded in)
//   dP    = do . v
//   dS    = P (dP - delta) scale               (float32)
//   dv   += bf16(P)^T do,  dq += bf16(dS) k,  dk += bf16(dS)^T q
// with every product on the tensor cores (`wgmma`, bf16 in, float32
// accumulators) and one rounding to bf16 at the end.
//
// Bound on this card: at granite's training shape (B=4, S=512, H=32, KV=8,
// hd 64) the five products are 2.5x the forward's causal operations and
// the kernel moves q, k, v, o, do, lse and dq, dk, dv once each: 42 MB in
// 12.6 us at 3.35 TB/s against 10.8 GFLOP in 10.9 us, so bytes and
// operations are close and neither wins by much; at llama3-405b's group of
// 16 (B=1, H=128, KV=8, hd 128) 71.5 MB against 21.5 GFLOP (21.7 us of
// operations).  Three things keep a plain tiling of this function far from
// that bound: latency between small products, the causal imbalance of one
// wave (a key tile near the start walks every query tile after it), and too
// few blocks where B and the kv heads are few (64 at hd 128).  This design
// answers each below, and spends 2 of the 7 products it runs (S and dP once
// more in the dq pass) to keep every sum in one owner.  What holds it now is
// moving tiles, not the products: each pass reads 75-100 MB through L2
// (every query tile's q and do again for each key tile, every key tile's k
// and v again for each query tile), and with its products and softmax
// removed the dk/dv pass still took 60% of its time (measured on an H100;
// deeper rings, descriptor prefetch and a dq block of two heads sharing k
// and v did not move it).
//
// Structure: two launches on the caller's stream, each of warpgroups that
// run `wgmma` on 64-row tiles from shared memory filled by TMA (128-byte
// swizzled tiles, completion on `mbarrier`s).  One elected thread issues
// the copies: a block's first stages at its start, and each stage again,
// for the step after next of the warpgroup that read it, as soon as that
// warpgroup is done with it.  (A producer warp would cost a whole
// warpgroup's registers: ptxas gave a block of 2 warpgroups and a warp 168
// registers a thread, and the dk/dv pass spilled.)
//   1. dq and delta: a block owns (batch, q head, 64-query tile), query
//      tiles from the last (the most key tiles) to the first.  It loads q,
//      do and o once, computes delta = rowsum(do o) for its rows and writes
//      (lse log2 e, delta) for them to a (B, H, S64, 2) scratch, then walks
//      the key tiles up to its diagonal through two stages of k and v
//      tiles (o takes the second until delta is done): S = Q K^T and dP =
//      dO V^T from shared memory, P and dS in registers, dQ += bf16(dS) K
//      with dS as the register A operand.  Delta is folded in here rather
//      than given a launch of its own; the dk/dv pass reads the scratch
//      with its q tiles.  A separate dq pass recomputes S and dP (7 products
//      for the function's 5: 1.4x the operations, and q, do and k, v read
//      twice) so that dq, like dk and dv, is summed by one owner.
//   2. dk and dv: a block owns (batch, kv head, a pair of 64-key tiles i
//      and n - 1 - i, a chunk of at most 4 of the group's q heads): the
//      pair's query tiles number n + 1 a head whatever i is, so every
//      block has the same work and one wave ends together (alone, key
//      tile 0 of 8 would walk 8x what tile 7 does).  Two warpgroups
//      take the (head, query tile) steps in turn from a ring of 6 stages
//      (4 at hd 128) of q, do and (lse, delta) tiles: S^T = K Q^T and
//      dP^T = V dO^T from shared memory, P^T and dS^T in registers, then
//      dV += bf16(P^T) dO and dK += bf16(dS^T) Q with P^T and dS^T as
//      register A operands, running on while the warpgroup's next S^T and
//      dP^T are issued; at the end of a key tile the two warpgroups' sums
//      are added through shared memory, warpgroup 0's first.  A group of
//      more than 4 heads (llama3-405b's 16) is split into chunks, so B=1
//      with 8 kv heads still has 128 blocks of 2 warpgroups; the chunks
//      leave float32 partials in a workspace and the last block of a tile
//      to finish (a ticket, as rows_matmul's K-slices use) adds them in
//      chunk order.
// Non-causal (the encoder's blocks): a dq block walks every key tile and
// a dk/dv block every query tile, so the work of a key tile no longer
// depends on where it lies and a dk/dv block owns one key tile (a "unit";
// causal, a unit is the pair).  Where S is ragged (1500 frames), TMA fills
// the last key tile past S with zeros, whose scores are 0, not -inf: P =
// 2^(0 - lse) is not 0 there.  dq would add dS times those zero keys
// (nothing, but only as long as dS stays finite), so the dq pass masks
// keys at or past S explicitly, as the causal diagonal hides them from
// every valid query; the dk/dv pass computes rows for those keys and never
// stores them.  Query rows past S are zero in q, do, o and the scratch:
// their dS and do are 0, so they add nothing to dk or dv in either mode.
// Every sum has one owner and a fixed order: no float32 `atomicAdd`, so
// two runs give the same bits, and the plan (kernels/attention/ops.py
// ::bwd_plan) takes no batch size, so neither does any sum's order.
// Query tiles are 64 rows at hd 64 and 32 at hd 128, which keeps the two
// hd-wide float32 accumulators and the transposed score and dP tiles of a
// dk/dv thread in registers without a spill.
// Head dim 112 (zamba2's shared block) runs on the 128 tile: its tensor
// maps are 112 columns wide, so the second 64-column box of every q, k, v,
// o and do tile reads 48 columns and TMA fills the last 16 with zeros.
// Zero columns add nothing to S, dP or delta, and the products give zero
// in columns 112-127 of dq, dk and dv, which the stores skip.  That costs
// 16/112 more products than a native 112 would; a native tile would need a
// 48-column box, which the 128-byte swizzle that wgmma reads does not take
// (its rows are 64 bf16), so the pad is the simple choice, as in the
// forward (flash_attention.cu, the bf16 path at 112).
// Scope: bf16, hd 64, 112 and 128, causal or not, every key valid; the
// wrapper raises on anything else.

#include <cuda.h>           // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kTk = 64;           // keys a tile: a dk/dv warpgroup's rows
constexpr int kTq = 64;           // queries a dq block: its warpgroup's rows
constexpr int kDkdvThreads = 256; // dk/dv: two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

struct Maps {                     // TMA descriptors, by value in .param
  CUtensorMap q, k, v, o, dout;   // boxes of 64 columns by the tile's rows
  CUtensorMap stats;              // (lse log2 e, delta) rows: 2 BQ floats
};

struct Args {
  const float* lse;             // (b, h, s)
  float* stats;                 // (b, h, s64, 2), written by the dq pass
  float* part;                  // dk/dv partials when chunks > 1
  int* counters;                // one a (block group, key tile); zero
  bf16* dq;                     // contiguous (b, s, h, hd)
  bf16* dk;                     // contiguous (b, s, kv, hd)
  bf16* dv;
  int hd;                       // the rows' head dim: HD, or 112 on 128
  int b, s, h, kv, group, heads, chunks;
  int units;                    // dk/dv units a (batch, kv head): ops.bwd_plan
  int s64, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// mbarrier, TMA and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival, and `bytes` more for the barrier's phase to wait for
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` to complete.  A barrier that never
// completes (a lost copy) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// the R rows of a tile of HD columns, HD / 64 boxes of 64 columns
template <int HD, int R>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head,
                                         int batch) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
    tma_4d(dst + c * R * 64, map, bar, c * 64, row, head, batch);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// orders this thread's view of shared memory (read by the generic proxy)
// before a TMA copy (the async proxy) overwrites it
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// keeps the registers of an A operand untouched until the wait that ends
// the product reading them
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Tiles in shared memory are HD / 64 blocks of R rows by 64 columns, each
// row 128 bytes with its 16-byte chunks XORed by row % 8 (TMA's 128-byte
// swizzle; every block on a 1024-byte boundary).  Descriptors (wgmma's
// 128-byte swizzle mode) for the k16 step `ks` of such a tile:
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// the tile as an operand whose k runs along its columns (K-major): step
// ks is 16 columns, 32 bytes into a row of block ks / 4
template <int R>
__device__ __forceinline__ uint64_t kdesc(const bf16* tile, int ks) {
  return make_desc(smem_u32(tile) + (ks >> 2) * R * 128 + (ks & 3) * 32, 16,
                   1024);
}
// the tile as an operand whose k runs along its rows (MN-major, a
// transposed B): step ks is rows [16 ks, 16 ks + 16); the next 64 columns
// are the next block
template <int R>
__device__ __forceinline__ uint64_t mndesc(const bf16* tile, int ks) {
  return make_desc(smem_u32(tile) + ks * 2048, R * 128, 1024);
}

// d (64 x 32 float32) (+)= A (64 x 16, smem) B (16 x 32, smem); tnsp-b TB
template <int TB>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// d (64 x 64 float32) (+)= A (64 x 16, smem) B (16 x 64, smem); tnsp-b TB
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// d (64 x 64 float32) += A (64 x 16, registers) B (16 x 64, smem); tnsp-b TB
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// d (64 x 128 float32) += A (64 x 16, registers) B (16 x 128, smem); tnsp-b TB
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  if constexpr (N == 32) wgmma_ss_n32<0>(d, da, db, acc);
  else wgmma_ss_n64<0>(d, da, db, acc);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64<1>(d, a, db, 1);
  else wgmma_rs_n128<1>(d, a, db, 1);
}

// the A fragment of k16 step kc from an accumulator of the same rows:
// columns [16 kc, 16 kc + 16) are its n8 tiles 2 kc and 2 kc + 1
__device__ __forceinline__ void a_frag(uint32_t* a, const float* d, int kc) {
  a[0] = pack_bf16(d[8 * kc + 0], d[8 * kc + 1]);
  a[1] = pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
}

// ---------------------------------------------------------------------------
// 1. dq and delta: one block a (batch, q head, 64-query tile)
// ---------------------------------------------------------------------------

template <int HD>
struct DqSmem {
  static constexpr int ST = 2;                   // stages of k and v tiles
  static constexpr int TILE = kTq * HD;          // elements of q, do, o
  static constexpr int KT = kTk * HD;            // elements of a k or v tile
  static constexpr int BYTES =
      (2 * TILE + ST * 2 * KT) * 2 + kTq * 4 + (1 + ST) * 8;
};

template <int HD>
__global__ void __launch_bounds__(128, 2)
flash_bwd_dq_kernel(const __grid_constant__ Maps m, const Args a) {
  using L = DqSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  bf16* const sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* const sdo = sq + L::TILE;
  bf16* const sk = sdo + L::TILE;                 // [stage][k, v]
  // o is needed for delta alone: it takes stage 1's k tile until then
  bf16* const so = sk + 2 * L::KT;
  float* const sdelta = reinterpret_cast<float*>(sk + L::ST * 2 * L::KT);
  uint64_t* const qbar = reinterpret_cast<uint64_t*>(sdelta + kTq);
  uint64_t* const full = qbar + 1;

  // query tiles from the last (the most key tiles) to the first
  const int bh = a.b * a.h;
  const int nqt = (a.s + kTq - 1) / kTq;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / bh)) * kTq;
  const int bi = (blockIdx.x % bh) / a.h, hi = (blockIdx.x % bh) % a.h;
  const int kvh = hi / a.group;
  const int n_tiles =
      ((a.causal ? min(q0 + kTq, a.s) : a.s) + kTk - 1) / kTk;
  const int tid = threadIdx.x;
  // key tile j into its stage; thread 0 issues every copy
  auto issue = [&](int j) {
    const int slot = j % L::ST;
    mbar_expect(full + slot, 2 * L::KT * 2);
    bf16* kt = sk + slot * 2 * L::KT;
    tma_tile<HD, kTk>(kt, &m.k, full + slot, j * kTk, kvh, bi);
    tma_tile<HD, kTk>(kt + L::KT, &m.v, full + slot, j * kTk, kvh, bi);
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < L::ST; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(qbar, 3 * L::TILE * 2);
    tma_tile<HD, kTq>(sq, &m.q, qbar, q0, hi, bi);
    tma_tile<HD, kTq>(sdo, &m.dout, qbar, q0, hi, bi);
    tma_tile<HD, kTq>(so, &m.o, qbar, q0, hi, bi);
    issue(0);
  }
  __syncthreads();

  // thread t holds rows 16 (t / 32) + t % 32 / 4 and that + 8 of every
  // accumulator, columns 8 j + 2 (t % 4) + {0, 1}
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  mbar_wait(qbar, 0);

  // delta for row tid / 2: each of two threads sums half of the row's
  // columns in increasing order, then the halves are added
  {
    const int r = tid >> 1, half = tid & 1;
    float acc = 0.f;
#pragma unroll
    for (int c = half * HD / 16; c < (half + 1) * HD / 16; ++c) {
      const int off = (c >> 3) * kTq * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
      const uint4 ov = *reinterpret_cast<const uint4*>(so + off);
      const uint4 dv = *reinterpret_cast<const uint4*>(sdo + off);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(o2[e]);
        const float2 y = __bfloat1622float2(d2[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sdelta[r] = acc;
      const int row = q0 + r;
      const long long bhrow = (long long)bi * a.h + hi;
      const float l2 =
          row < a.s ? a.lse[bhrow * a.s + row] * kLog2e : 0.f;
      *reinterpret_cast<float2*>(a.stats + (bhrow * a.s64 + row) * 2) =
          make_float2(l2, acc);
    }
  }
  named_sync(1, 128);                             // o is read: stage 1 free
  if (tid == 0 && n_tiles > 1) {
    proxy_fence();
    issue(1);
  }

  const int r0 = warp * 16 + g;                   // rows r0 and r0 + 8
  const long long lrow = ((long long)bi * a.h + hi) * a.s + q0;
  const float lse0 = q0 + r0 < a.s ? a.lse[lrow + r0] * kLog2e : 0.f;
  const float lse1 = q0 + r0 + 8 < a.s ? a.lse[lrow + r0 + 8] * kLog2e : 0.f;
  const float del0 = sdelta[r0], del1 = sdelta[r0 + 8];
  const float sl2 = a.scale * kLog2e;

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % L::ST;
    mbar_wait(full + slot, (j / L::ST) & 1);
    const bf16* kt = sk + slot * 2 * L::KT;
    const bf16* vt = kt + L::KT;

    // S = Q K^T and dP = dO V^T: rows the queries, columns the keys
    float sc[kTk / 2], dp[kTk / 2];
#pragma unroll
    for (int i = 0; i < kTk / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<kTk>(sc, kdesc<kTq>(sq, ks), kdesc<kTk>(kt, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<kTk>(dp, kdesc<kTq>(sdo, ks), kdesc<kTk>(vt, ks), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<kTk / 2>(sc);
    fence_regs<kTk / 2>(dp);

    // P and dS; causal, only the diagonal tile has keys after a query;
    // non-causal, only a ragged last tile has keys past S
    const int k0 = j * kTk;
    const bool edge = a.causal && k0 == q0;
    const bool ragged = !a.causal && k0 + kTk > a.s;
#pragma unroll
    for (int n = 0; n < kTk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi8 = e >> 1;
        const int key = k0 + n * 8 + 2 * tq + (e & 1);
        float x = sc[4 * n + e] * sl2 - (hi8 ? lse1 : lse0);
        if ((edge && key > q0 + r0 + hi8 * 8) || (ragged && key >= a.s))
          x = -INFINITY;
        const float p = ex2(x);
        dp[4 * n + e] = p * (dp[4 * n + e] - (hi8 ? del1 : del0)) * a.scale;
      }
    }
    uint32_t da[kTk / 16][4];
#pragma unroll
    for (int kc = 0; kc < kTk / 16; ++kc) a_frag(da[kc], dp, kc);

    // dQ += dS K: K's rows are the keys, the k of this product
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTk / 16; ++kc)
      wgmma_rs<HD>(dq, da[kc], mndesc<kTk>(kt, kc));
    wgmma_commit();
    wgmma_wait0();
    fence_regs<HD / 2>(dq);
    fence_frags<kTk / 16>(da);
    named_sync(1, 128);                           // the stage is read
    if (tid == 0 && j + L::ST < n_tiles) {
      proxy_fence();
      issue(j + L::ST);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = q0 + r0 + half * 8;
    if (qpos >= a.s) continue;
    const long long off = (((long long)bi * a.s + qpos) * a.h + hi) * a.hd;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      if (n * 8 < a.hd)                  // hd 112: columns 112-127 are pad
        *reinterpret_cast<uint32_t*>(a.dq + off + n * 8 + 2 * tq) =
            pack_bf16(dq[4 * n + 2 * half], dq[4 * n + 2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// 2. dk, dv: one block a (batch, kv head, unit of key tiles, head chunk):
//    causal, a unit is the pair i and n - 1 - i; non-causal, one tile
// ---------------------------------------------------------------------------

template <int HD, int BQ>
struct DkdvSmem {
  static constexpr int ST = HD == 64 ? 6 : 4;    // stages of q tiles (even)
  static constexpr int KT = kTk * HD;            // a k or v tile
  static constexpr int QT = BQ * HD;             // a q or do tile
  static constexpr int RED = 128 * HD / 2;       // floats a warpgroup's tile
  static constexpr int BYTES = (4 * KT + ST * 2 * QT) * 2 +
                               ST * 2 * BQ * 4 + 2 * RED * 4 +
                               (ST + 2) * 8 + 16;
};

// The end of a dk/dv key tile for one warpgroup: `keep` is the sum it
// finishes (dk for warpgroup 0, dv for 1), `give` its share of the other.
// It hands `give` over through `out` and adds the other warpgroup's share
// of `keep` from `in`, warpgroup 0's term first.  With one chunk it writes
// `keep` to `dst` in bf16; with several it leaves its float32 partial in
// the workspace, and the tile's last block to finish adds them all in
// chunk order.
template <int HD>
__device__ __forceinline__ void finish_tile(
    float (&keep)[HD / 2], const float (&give)[HD / 2], bf16* dst,
    float* out, const float* in, const Args& a, long long tile_id, int chunk,
    int krow, int bi, int kvh, int* last, int wt, int tq) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x;
  float4* o4 = reinterpret_cast<float4*>(out);
  const float4* i4 = reinterpret_cast<const float4*>(in);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    o4[i * 128 + wt] = make_float4(give[4 * i], give[4 * i + 1],
                                   give[4 * i + 2], give[4 * i + 3]);
  named_sync(1, 256);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const float4 v = i4[i * 128 + wt];
    if (wg == 0) {
      keep[4 * i] += v.x;
      keep[4 * i + 1] += v.y;
      keep[4 * i + 2] += v.z;
      keep[4 * i + 3] += v.w;
    } else {
      keep[4 * i] = v.x + keep[4 * i];
      keep[4 * i + 1] = v.y + keep[4 * i + 1];
      keep[4 * i + 2] = v.z + keep[4 * i + 2];
      keep[4 * i + 3] = v.w + keep[4 * i + 3];
    }
  }
  named_sync(1, 256);                             // the buffers are free

  if (a.chunks > 1) {
    constexpr long long kTile = 32LL * HD;        // float4s: dk and dv
    float4* part = reinterpret_cast<float4*>(a.part) + tile_id * a.chunks *
                                                           kTile;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      part[chunk * kTile + i * 256 + tid] =
          make_float4(keep[4 * i], keep[4 * i + 1], keep[4 * i + 2],
                      keep[4 * i + 3]);
    __threadfence();
    named_sync(1, 256);
    if (tid == 0)
      *last = atomicAdd(a.counters + tile_id, 1) == a.chunks - 1;
    named_sync(1, 256);
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      float4 s = __ldcg(part + i * 256 + tid);
      for (int c = 1; c < a.chunks; ++c) {
        const float4 v = __ldcg(part + c * kTile + i * 256 + tid);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      keep[4 * i] = s.x;
      keep[4 * i + 1] = s.y;
      keep[4 * i + 2] = s.z;
      keep[4 * i + 3] = s.w;
    }
    if (tid == 0) a.counters[tile_id] = 0;
  }

  // rows g and g + 8 of the warp's keys, columns 2 tq, 2 tq + 1 of each
  // n8 tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = krow + half * 8;
    if (kpos >= a.s) continue;
    const long long off = (((long long)bi * a.s + kpos) * a.kv + kvh) * a.hd;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      if (n * 8 < a.hd)
        *reinterpret_cast<uint32_t*>(dst + off + n * 8 + 2 * tq) =
            pack_bf16(keep[4 * n + 2 * half], keep[4 * n + 2 * half + 1]);
  }
}

template <int HD, int BQ>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ Maps m, const Args a) {
  using L = DkdvSmem<HD, BQ>;
  extern __shared__ unsigned char smem_raw[];
  bf16* const skv = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // [pair tile][k, v], then the ring [stage][q, do]
  bf16* const sring = skv + 4 * L::KT;
  float* const sstat = reinterpret_cast<float*>(sring + L::ST * 2 * L::QT);
  float* const red = sstat + L::ST * 2 * BQ;     // [2][RED]
  uint64_t* const full = reinterpret_cast<uint64_t*>(red + 2 * L::RED);
  uint64_t* const kvfull = full + L::ST;         // [2]
  int* const last = reinterpret_cast<int*>(kvfull + 2);

  const int chunk = blockIdx.x % a.chunks;
  const int unit = blockIdx.x / a.chunks;        // (batch, kv head, unit)
  const int pair = unit % a.units;
  const int bi = unit / a.units / a.kv, kvh = unit / a.units % a.kv;
  const int n_kt = (a.s + kTk - 1) / kTk;
  const int n_qt = (a.s + BQ - 1) / BQ;
  const int tiles = a.causal && pair != n_kt - 1 - pair ? 2 : 1;
  const int h0 = kvh * a.group + chunk * a.heads;
  const int tid = threadIdx.x;
  // the first query tile a key tile reads: its diagonal's, or the first
  auto q_first = [&](int kt) { return a.causal ? kt * kTk / BQ : 0; };
  // the steps: tile 0's (head, query tile) pairs, then tile 1's
  const int first = a.heads * (n_qt - q_first(pair));
  const int steps =
      first + (tiles > 1 ? a.heads * (n_qt - q_first(n_kt - 1 - pair)) : 0);
  // step it's q, do and (lse, delta) tiles into stage it % ST
  auto issue = [&](int it) {
    const int tt = it >= first, rest = tt ? it - first : it;
    const int j0 = q_first(tt ? n_kt - 1 - pair : pair);
    const int hh = rest / (n_qt - j0), j = j0 + rest % (n_qt - j0);
    const int slot = it % L::ST;
    mbar_expect(full + slot, 2 * L::QT * 2 + 2 * BQ * 4);
    bf16* qt = sring + slot * 2 * L::QT;
    tma_tile<HD, BQ>(qt, &m.q, full + slot, j * BQ, h0 + hh, bi);
    tma_tile<HD, BQ>(qt + L::QT, &m.dout, full + slot, j * BQ, h0 + hh, bi);
    tma_2d(sstat + slot * 2 * BQ, &m.stats, full + slot, 2 * j * BQ,
           bi * a.h + h0 + hh);
  };

  if (tid == 0) {
    for (int i = 0; i < L::ST; ++i) mbar_init(full + i, 1);
    mbar_init(kvfull, 1);
    mbar_init(kvfull + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int tt = 0; tt < tiles; ++tt) {
      const int k0 = (tt ? n_kt - 1 - pair : pair) * kTk;
      mbar_expect(kvfull + tt, 2 * L::KT * 2);
      tma_tile<HD, kTk>(skv + 2 * tt * L::KT, &m.k, kvfull + tt, k0, kvh, bi);
      tma_tile<HD, kTk>(skv + (2 * tt + 1) * L::KT, &m.v, kvfull + tt, k0,
                        kvh, bi);
    }
    for (int it = 0; it < L::ST && it < steps; ++it) issue(it);
  }
  __syncthreads();

  // warpgroup wg takes the steps it with it % 2 == wg; a step's dV and dK
  // products run on while its next step's S and dP are issued, and its
  // stage is refilled (for the warpgroup's step ST later) once they are done
  const int wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const float sl2 = a.scale * kLog2e;
  uint32_t pa[BQ / 16][4] = {}, da[BQ / 16][4] = {};
  int pending = -1;                  // the step whose stage awaits its refill
  auto refill = [&]() {
    named_sync(2 + wg, 128);
    if (wt == 0 && pending + L::ST < steps) {
      proxy_fence();
      issue(pending + L::ST);
    }
    pending = -1;
  };
  int it = 0;
  for (int tt = 0; tt < tiles; ++tt) {
    const int kt = tt ? n_kt - 1 - pair : pair;
    const int k0 = kt * kTk, j0 = q_first(kt);
    const bf16* sk = skv + 2 * tt * L::KT;
    const bf16* sv = sk + L::KT;
    const int krow = k0 + warp * 16 + g;          // this thread's keys: +0, +8
    mbar_wait(kvfull + tt, 0);

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int hh = 0; hh < a.heads; ++hh)
      for (int j = j0; j < n_qt; ++j, ++it) {
        if ((it & 1) != wg) continue;
        const int slot = it % L::ST;
        mbar_wait(full + slot, (it / L::ST) & 1);
        const bf16* qs = sring + slot * 2 * L::QT;
        const bf16* dos = qs + L::QT;
        const float* st4 = sstat + slot * 2 * BQ;
        const int q0 = j * BQ;

        // S^T = K Q^T and dP^T = V dO^T: rows the keys, columns the queries
        float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks)
          wgmma_ss<BQ>(st, kdesc<kTk>(sk, ks), kdesc<BQ>(qs, ks), ks > 0);
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks)
          wgmma_ss<BQ>(dpt, kdesc<kTk>(sv, ks), kdesc<BQ>(dos, ks), ks > 0);
        wgmma_commit();
        wgmma_wait1();                            // S and the last dV, dK
        fence_regs<BQ / 2>(st);
        fence_frags<BQ / 16>(pa);
        fence_frags<BQ / 16>(da);
        if (pending >= 0) refill();

        // P^T = 2^(scale log2e s - lse log2e), masked above the diagonal
        // when causal; dS^T = P^T (dP^T - delta) scale.  Query rows past S
        // hold zeros in q, do and the scratch: their P is 1 and their dS
        // and do are 0, so they add nothing.
        const bool edge = a.causal && q0 < k0 + kTk;
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float4 sd = *reinterpret_cast<const float4*>(
              st4 + 2 * (n * 8 + 2 * tq));        // lse, delta of 2 columns
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + 2 * tq + (e & 1);
            float x = st[4 * n + e] * sl2 - ((e & 1) ? sd.z : sd.x);
            if (edge && krow + (e >> 1) * 8 > q0 + col) x = -INFINITY;
            st[4 * n + e] = ex2(x);
          }
        }
        wgmma_wait0();
        fence_regs<BQ / 2>(dpt);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float4 sd = *reinterpret_cast<const float4*>(
              st4 + 2 * (n * 8 + 2 * tq));        // lse, delta of 2 columns
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * n + e] = st[4 * n + e] *
                             (dpt[4 * n + e] - ((e & 1) ? sd.w : sd.y)) *
                             a.scale;
        }
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
          a_frag(pa[kc], st, kc);
          a_frag(da[kc], dpt, kc);
        }

        // dV += P^T dO and dK += dS^T Q: the queries are the k of both
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
          wgmma_rs<HD>(dv, pa[kc], mndesc<BQ>(dos, kc));
          wgmma_rs<HD>(dk, da[kc], mndesc<BQ>(qs, kc));
        }
        wgmma_commit();
        pending = it;
      }
    wgmma_wait0();
    fence_regs<HD / 2>(dv);
    fence_regs<HD / 2>(dk);
    fence_frags<BQ / 16>(pa);
    fence_frags<BQ / 16>(da);
    if (pending >= 0) refill();

    // the two warpgroups' sums, warpgroup 0's first: warpgroup 0 keeps dk,
    // warpgroup 1 dv
    if (wg == 0)
      finish_tile<HD>(dk, dv, a.dk, red + L::RED, red, a, unit * 2 + tt,
                      chunk, krow, bi, kvh, last, wt, tq);
    else
      finish_tile<HD>(dv, dk, a.dv, red, red + L::RED, a, unit * 2 + tt,
                      chunk, krow, bi, kvh, last, wt, tq);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, s, heads, b) bf16 through element strides (row, head, batch); a
// stride of 0 (a dimension of one) is given any multiple of 16 bytes
bool map_rows(CUtensorMap* map, const void* base, int hd, int s, int heads,
              int b, long long ss, long long sh, long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)s,
                              (cuuint64_t)heads, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                           (cuuint64_t)sb * 2};
  cuuint64_t prev = (cuuint64_t)hd * 2;
  for (int i = 0; i < 3; ++i) {
    if (strides[i] == 0) strides[i] = (prev + 15) / 16 * 16;
    prev = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Both kernels' shared memory, allowed by runtime calls that also make
// the device's primary context current on this thread: the driver's
// tensor-map encoder needs one, and a thread's first call may come before
// any other (autograd runs a backward on a thread of its own).
template <int HD, int BQ>
int allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqSmem<HD>::BYTES + 1024);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD, BQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkdvSmem<HD, BQ>::BYTES + 1024);
  return (int)e;
}

// the dq pass (its maps read q and do by 64 rows), then the dk/dv pass
template <int HD, int BQ>
int run_all(const Maps& mq, const Maps& m, const Args& a, cudaStream_t st) {
  const long long dq_blocks = (long long)(a.s64 / kTq) * a.b * a.h;
  const long long dkdv_blocks = (long long)a.b * a.kv * a.units * a.chunks;
  if (dq_blocks > 0x7fffffffLL || dkdv_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  flash_bwd_dq_kernel<HD><<<(unsigned)dq_blocks, 128,
                            DqSmem<HD>::BYTES + 1024, st>>>(mq, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<HD, BQ><<<(unsigned)dkdv_blocks, kDkdvThreads,
                                  DkdvSmem<HD, BQ>::BYTES + 1024, st>>>(m, a);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; hd 64, 112 (on the 128 tile) or 128; causal or not, with
// every key valid.  Strides are in
// elements; lse is a contiguous float32 (b, h, s) tensor; stats float32
// scratch (b, h, s64, 2) with s64 = s rounded up to 64; dq, dk, dv
// contiguous.  heads: q heads a dk/dv block (ops.py::bwd_plan), a divisor
// of the group; with fewer than the group, part holds (b kv units 2,
// group / heads, 128 hd) float32 and counters one zero int a (b kv units
// 2), units (n + 1) / 2 causal and n not, n the 64-key tiles.
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* stats, float* part,
    int* counters, void* dq, void* dk, void* dv, int b, int s, int h, int kv,
    int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long d_sb, long long d_ss, long long d_sh, float scale, int heads,
    int causal, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (kv <= 0 || h % kv != 0 || heads <= 0 || (h / kv) % heads != 0 ||
      (hd != 64 && hd != 112 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const int group = h / kv, chunks = group / heads;
  if (chunks > 1 && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const int allowed = hd == 64 ? allow_smem<64, 64>() : allow_smem<128, 32>();
  // hd 112 runs the 128 instantiation: the maps below are hd columns wide
  if (allowed) return allowed;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int bq = hd == 64 ? 64 : 32;
  const int n_kt = (s + kTk - 1) / kTk;
  const int s64 = n_kt * kTk;
  Maps m;
  bool ok = map_rows(&m.q, q, hd, s, h, b, q_ss, q_sh, q_sb, bq) &&
            map_rows(&m.dout, dout, hd, s, h, b, d_ss, d_sh, d_sb, bq) &&
            map_rows(&m.o, o, hd, s, h, b, o_ss, o_sh, o_sb, kTq) &&
            map_rows(&m.k, k, hd, s, kv, b, k_ss, k_sh, k_sb, kTk) &&
            map_rows(&m.v, v, hd, s, kv, b, v_ss, v_sh, v_sb, kTk);
  // the dq pass reads q and do by 64-row tiles, the dk/dv pass by bq
  Maps mq = m;
  ok = ok && map_rows(&mq.q, q, hd, s, h, b, q_ss, q_sh, q_sb, kTq) &&
       map_rows(&mq.dout, dout, hd, s, h, b, d_ss, d_sh, d_sb, kTq);
  {
    const cuuint64_t dims[2] = {(cuuint64_t)2 * s64, (cuuint64_t)b * h};
    const cuuint64_t strides[1] = {(cuuint64_t)2 * s64 * 4};
    const cuuint32_t box[2] = {(cuuint32_t)(2 * bq), 1};
    const cuuint32_t unit[2] = {1, 1};
    ok = ok && encode_tiled()(&m.stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                              stats, dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                   CUDA_SUCCESS;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  mq.stats = m.stats;
  const Args a{lse, stats, part, counters,
               static_cast<bf16*>(dq), static_cast<bf16*>(dk),
               static_cast<bf16*>(dv), hd, b, s, h, kv, group, heads, chunks,
               causal ? (n_kt + 1) / 2 : n_kt, s64, causal != 0, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return hd == 64 ? run_all<64, 64>(mq, m, a, st)
                  : run_all<128, 32>(mq, m, a, st);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
