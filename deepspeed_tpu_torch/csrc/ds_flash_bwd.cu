// FlashAttention-2 backward: dQ, dK and dV by recomputing the probabilities
// from the forward's saved logsumexp, never materialising the [S, S] scores.
//
// Replaces: deepspeed_tpu/ops/pallas/ds_flash_attention.py:_dkv_kernel and
// :_dq_kernel (launcher _bwd_calls).  Same semantics, with
//   P  = exp(q k^T * sm_scale - lse)   (0 where the pair is masked),
//   dP = dO v^T,  dS = P * (dP - delta) * sm_scale,
//   dV = P^T dO,  dK = dS^T q,  dQ = dS k,
// delta = rowsum(dO * O) computed by the caller.  Causal or bidirectional,
// grouped-query attention (the dK/dV of kv head g sum over query heads
// g * rep .. g * rep + rep - 1), optional segment ids, a row whose lse is
// -1e30 (it saw no key) contributes nothing.  Any S >= 1: the ragged last
// tile is masked, so no divisibility rule on S.
//
// What bounds it on an H100: operations.  At the GPT-2 760M training shape
// (S = 1024, head_dim 96, causal) the dK/dV pass does 4 and the dQ pass 3
// products of 2 * S^2 / 2 * head_dim flops per head over 4 * S * head_dim
// bytes of q/k/v/dO, far above the ~295 flops per byte where the tensor
// cores become the limit; only wgmma reaches their rate, and the
// elementwise step (an exp2 per score) must hide behind it.  What the bf16
// design does about it (namespace hbwd, kernel flash_bwd_bf16<HD, DKV>):
//   - two kernels, as the reference splits them, so each output tile is
//     summed by one CTA in a fixed order: no atomics, and dQ, dK, dV are
//     bit-identical from launch to launch and a row's bits do not depend
//     on B;
//   - dK/dV: a CTA owns 128 key rows of one (batch, kv head), k and v
//     resident in shared memory; it walks the group's rep query heads and
//     their 64-row query tiles (from the diagonal when causal), which a
//     producer warp streams by TMA through a three-stage ring with each
//     tile's lse (pre-scaled to log2 units) and delta rows.  Each of two
//     consumer warpgroups owns 64 keys and computes the scores transposed,
//     as the TPU kernel does: s^T = k q^T and dP^T = v dO^T by wgmma from
//     shared memory into registers; P^T and dS^T are then already in the
//     register layout of wgmma's A operand for dV += P^T dO and dK +=
//     dS^T q (dO and q read MN-major through the transpose bit), so
//     neither goes through shared memory;
//   - dQ: a CTA owns 128 query rows of one (batch, head), q and dO
//     resident; k and v stream through the ring (k and v on separate
//     barriers) up to the diagonal tile when causal; s = q k^T and dP =
//     dO v^T by wgmma, dS packed in registers as the A operand of dQ +=
//     dS k (k read MN-major); the forward with its online softmax replaced
//     by a second score product and the known lse;
//   - folds: P = 2^(s * sm_scale * log2(e) - lse * log2(e)), one FFMA and
//     an exp2; a row that saw no key (lse -1e30) gets lse +inf, so its P
//     is 0 without a branch; sm_scale of dS moves into the epilogues;
//   - the loop is software-pipelined: streamed tile i's score products
//     are issued before tile i - 1's accumulating products, so tile i's
//     elementwise step runs under tensor work (all but dK/dV at head dim
//     128, whose registers do not allow it); the two consumer warpgroups
//     issue independently;
//   - a persistent grid, one CTA per SM, walks output tiles by (batch,
//     head) in causal pairs of levels whose work adds up evenly, so the
//     CTAs running at once share few heads' streamed tensors in L2 (by
//     level where those units cannot fill the rounds);
//   - the mask (causal, ragged S, segment ids) is applied on the registers
//     only on tiles that need it; rows past S land as zeros by TMA and
//     their lse as +inf; no wgmma sits in a data-dependent branch;
//   - head dims 64 and 128 stage in 64-column chunks with 128-byte
//     swizzle, 80 and 96 in 32-column chunks with 64-byte swizzle (80's
//     third chunk half zero-filled by TMA), as csrc/ds_flash_fwd.cu.
// The fp32 kernels (dkv_f32, dq_f32) keep plain fp32 FMA, two threads per
// row, so fp32 results carry no TF32 rounding.
//
// Inputs may be strided views (q/k/v slices of one fused qkv tensor): the
// caller passes batch, sequence and head strides in elements for q, k, v
// and dO; the last dimension is contiguous and every stride and base
// address is 16-byte aligned (checked by the Python wrapper; the TMA maps
// need it).  lse and delta are contiguous [B, H, S] fp32, segment ids
// contiguous [B, S] int32 or null.  Outputs are contiguous: dq
// [B, S, H, HD], dk / dv [B, S, KV, HD], all in the input dtype.
#include <atomic>
#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the fp32 kernels' tiling
constexpr int BM = 64;   // query rows per tile
constexpr int BN = 64;   // key rows per tile (BM == BN: the diagonal tile
                         // of key tile t is query tile t)
constexpr int kThreads = 128;
constexpr float kNegInfLse = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* seg;
  void* dq;
  void* dk;
  void* dv;
  int S, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int causal;
  float sm_scale;
};

// P[q, k] is non-zero only for a visible pair of a row that saw a key.
__device__ __forceinline__ bool visible(const Args& a, int s_q, int s_k,
                                        int seg_q, int seg_k, float lse_q) {
  if (s_q >= a.S || s_k >= a.S) return false;
  if (a.causal && s_k > s_q) return false;
  if (a.seg != nullptr && seg_q != seg_k) return false;
  return lse_q > 0.5f * kNegInfLse;
}

__device__ __forceinline__ int seg_at(const Args& a, int b, int s) {
  return (a.seg != nullptr && s < a.S) ? a.seg[(size_t)b * a.S + s] : 0;
}

// Per-query rows of one tile: lse, delta and segment id (lse = -1e30 past
// S, so those columns drop out).
__device__ __forceinline__ void load_rows(float* lse_s, float* dlt_s,
                                          int* seg_s, const Args& a, int b,
                                          int h, int r0) {
  for (int c = threadIdx.x; c < BM; c += kThreads) {
    const int s = r0 + c;
    const bool in = s < a.S;
    const size_t row = ((size_t)b * a.H + h) * a.S + s;
    lse_s[c] = in ? a.lse[row] : kNegInfLse;
    dlt_s[c] = in ? a.delta[row] : 0.f;
    seg_s[c] = seg_at(a, b, s);
  }
}

// ------------------------------------------------------------------ bf16
// The Hopper backward: a CTA of three warpgroups per SM.  Warpgroup 0
// gives up its registers and one of its warps loads by TMA: the resident
// pair once per output tile (k and v for dK/dV, q and dO for dQ, 128 rows
// each) and the streamed pair (q and dO, or k and v, 64 rows each) through
// a three-stage ring.  Warpgroups 1 and 2 each own 64 output rows.
namespace hbwd {

constexpr int kRows = 128;      // output rows per CTA (two warpgroups of 64)
constexpr int kTile = 64;       // streamed rows per ring stage
constexpr int kStages = 3;      // ring depth
constexpr int kCtaThreads = 384;   // producer warpgroup + two consumer ones
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base: the resident pair
// [chunk][kRows][CH] each, the streamed pair [stage][chunk][kTile][CH]
// each (swizzled rows of CH columns), then per stage the streamed rows'
// lse in log2 units and delta (dK/dV), their segment ids and (min, max),
// then the barriers.
template <int HD>
struct Smem {
  // head dims that are a multiple of 64 stage in 64-column chunks
  // (128-byte swizzle), 80 and 96 in 32-column chunks (64-byte swizzle)
  static constexpr int CH = HD % 64 == 0 ? 64 : 32;
  static constexpr int ROW = CH * 2;         // bytes: the swizzle span
  static constexpr int SBO = 8 * ROW;        // 8-row group stride
  static constexpr int NCH = (HD + CH - 1) / CH;
  static constexpr int RES_CHUNK = kRows * ROW;
  static constexpr int STR_CHUNK = kTile * ROW;
  static constexpr int RES_BYTES = NCH * RES_CHUNK;   // one resident tensor
  static constexpr int STR_BYTES = NCH * STR_CHUNK;   // one streamed tile
  static constexpr int RES0 = 0;                      // k, or q
  static constexpr int RES1 = RES0 + RES_BYTES;       // v, or dO
  static constexpr int STR0 = RES1 + RES_BYTES;       // q, or k [stage]
  static constexpr int STR1 = STR0 + kStages * STR_BYTES;   // dO, or v
  static constexpr int LSE = STR1 + kStages * STR_BYTES;   // f32 [stage][kTile]
  static constexpr int DELTA = LSE + kStages * kTile * 4;  // f32 [stage][kTile]
  static constexpr int SEG = DELTA + kStages * kTile * 4;  // int [stage][kTile]
  static constexpr int SEG_RANGE = SEG + kStages * kTile * 4;  // int [stage][2]
  static constexpr int BAR = SEG_RANGE + kStages * 8;           // uint64
  static constexpr int N_BARS = 2 + 3 * kStages;
  static constexpr int ALLOC = BAR + N_BARS * 8 + 1024;   // + base alignment
};

struct Params {
  const float* lse;
  const float* delta;
  const int* seg;
  bf16* out0;          // dK, or dQ
  bf16* out1;          // dV (dK/dV only)
  int S, H, KV, rep;
  int n_rt;            // output row tiles (kRows) per head
  int n_st;            // streamed tiles (kTile) per head
  int bh_count;        // B * output heads (KV for dK/dV, H for dQ)
  int n_tiles;         // n_rt * bh_count output tiles
  int causal;
  int paired;          // tile order: 0 by level, 1 by (batch, head)
  float scale_log2;    // sm_scale * log2(e)
  float sm_scale;
};

// Output tile t = level * bh_count + (batch, head); level 0 holds the
// longest tile when causal: key tile 0 (every query tile sees it) for
// dK/dV, the last query tile for dQ.  Its streamed items: dK/dV walks the
// group's rep query heads, each over query tiles first .. n_st - 1; dQ the
// key tiles 0 .. per - 1.
struct Tile {
  int b, oh;           // batch, output head (kv head, or query head)
  int r0;              // first output row
  int first, per;      // first streamed tile, streamed tiles per head
  int n_items;         // streamed tiles in all
};

template <bool DKV>
__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  const int level = t / p.bh_count;
  const int bh = t - level * p.bh_count;
  const int heads = DKV ? p.KV : p.H;
  Tile w;
  w.b = bh / heads;
  w.oh = bh - w.b * heads;
  if (DKV) {
    w.r0 = level * kRows;
    w.first = p.causal ? w.r0 / kTile : 0;
    w.per = p.n_st - w.first;
    w.n_items = p.rep * w.per;
  } else {
    w.r0 = (p.n_rt - 1 - level) * kRows;
    w.first = 0;
    w.per = p.causal
                ? min(p.n_st, (min(p.S, w.r0 + kRows) + kTile - 1) / kTile)
                : p.n_st;
    w.n_items = w.per;
  }
  return w;
}

// The CTA's n-th output tile (p.n_tiles or more: none left), in the order
// the host picks (hopper::persistent_tile): by (batch, head), in causal
// pairs of levels L and n_rt - 1 - L whose streamed tiles add up to the
// same count for every L, or by level where those units cannot fill the
// rounds.
__device__ __forceinline__ int cta_tile(const Params& p, int n) {
  return hopper::persistent_tile(n, p.paired, p.causal, p.n_rt,
                                 p.n_tiles);
}

struct Bars {
  uint64_t* res_full;    // one arrival + bytes
  uint64_t* res_empty;   // one arrival per consumer warp
  uint64_t* s0_full;     // [kStages]; 32 arrivals (the producer warp) + bytes
  uint64_t* s1_full;     // [kStages]; one arrival + bytes
  uint64_t* empty;       // [kStages]; one arrival per consumer warp
};

// lse in log2 units; a row that saw no key (lse -1e30) gets +inf, so
// 2^(x - lse) is 0 for it without a branch
__device__ __forceinline__ float fold_lse(float lse) {
  return lse > 0.5f * kNegInfLse ? lse * kLog2e : INFINITY;
}

// The producer warp's per-stage rows: for dK/dV the streamed query rows'
// lse (log2 units, +inf past S) and delta; the streamed rows' segment ids
// and their (min, max) over rows below S.  Each lane's arrival on the
// stage's s0_full barrier releases these stores to the consumers.
template <int HD, bool DKV>
__device__ __forceinline__ void stage_rows(const Params& p, unsigned char* sm,
                                           int s, int b, int head, int r0,
                                           int lane) {
  using L = Smem<HD>;
  if (DKV) {
    float* l2 = reinterpret_cast<float*>(sm + L::LSE) + s * kTile;
    float* dl = reinterpret_cast<float*>(sm + L::DELTA) + s * kTile;
    for (int c = lane; c < kTile; c += 32) {
      const int r = r0 + c;
      const size_t row = ((size_t)b * p.H + head) * p.S + r;
      l2[c] = r < p.S ? fold_lse(p.lse[row]) : INFINITY;
      dl[c] = r < p.S ? p.delta[row] : 0.f;
    }
  }
  if (p.seg != nullptr) {
    int* seg = reinterpret_cast<int*>(sm + L::SEG) + s * kTile;
    int lo = INT_MAX, hi = INT_MIN;
    for (int c = lane; c < kTile; c += 32) {
      const int r = r0 + c;
      const int v = r < p.S ? p.seg[(size_t)b * p.S + r] : 0;
      seg[c] = v;
      if (r < p.S) {
        lo = min(lo, v);
        hi = max(hi, v);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      int* range = reinterpret_cast<int*>(sm + L::SEG_RANGE) + 2 * s;
      range[0] = lo;
      range[1] = hi;
    }
  }
}

// The producer warp: for each of the CTA's output tiles, the resident
// pair once (after the consumers have read the previous tile's), then
// the streamed tiles through the ring; the ring position runs on across
// output tiles, so the next tile's first streamed tiles load while the
// consumers finish.  Maps: tr0 / tr1 the resident pair, ts0 / ts1 the
// streamed one.
template <int HD, bool DKV>
__device__ __forceinline__ void produce(const CUtensorMap* tr0,
                                        const CUtensorMap* tr1,
                                        const CUtensorMap* ts0,
                                        const CUtensorMap* ts1,
                                        const Params& p, unsigned char* sm,
                                        const Bars& bar) {
  using L = Smem<HD>;
  const int lane = threadIdx.x & 31;
  int it = 0;   // ring position
  for (int n = 0;; ++n) {   // n: output tiles done
    const int t = cta_tile(p, n);
    if (t >= p.n_tiles) break;
    const Tile w = tile_of<DKV>(p, t);
    hopper::mbar_wait(bar.res_empty, (n & 1) ^ 1);
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(bar.res_full, 2 * L::RES_BYTES);
#pragma unroll
      for (int c = 0; c < L::NCH; ++c) {
        hopper::tma_load_4d(sm + L::RES0 + c * L::RES_CHUNK, tr0,
                            bar.res_full, c * L::CH, w.r0, w.oh, w.b);
        hopper::tma_load_4d(sm + L::RES1 + c * L::RES_CHUNK, tr1,
                            bar.res_full, c * L::CH, w.r0, w.oh, w.b);
      }
    }
    for (int i = 0; i < w.n_items; ++i, ++it) {
      const int s = it % kStages;
      const uint32_t parity = ((it / kStages) & 1) ^ 1;
      // dK/dV: query head oh * rep + j, its query tile first + i % per;
      // dQ: the kv head, key tile i
      const int j = DKV ? i / w.per : 0;
      const int head = DKV ? w.oh * p.rep + j : w.oh / p.rep;
      const int r0 = (w.first + i - j * w.per) * kTile;
      hopper::mbar_wait(bar.empty + s, parity);
      stage_rows<HD, DKV>(p, sm, s, w.b, head, r0, lane);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(bar.s0_full + s, L::STR_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          hopper::tma_load_4d(sm + L::STR0 + s * L::STR_BYTES +
                                  c * L::STR_CHUNK,
                              ts0, bar.s0_full + s, c * L::CH, r0, head, w.b);
        hopper::mbar_arrive_expect_tx(bar.s1_full + s, L::STR_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          hopper::tma_load_4d(sm + L::STR1 + s * L::STR_BYTES +
                                  c * L::STR_CHUNK,
                              ts1, bar.s1_full + s, c * L::CH, r0, head, w.b);
      } else {
        hopper::mbar_arrive(bar.s0_full + s);
      }
    }
  }
}

// the shared products (csrc/hopper.cuh) on this file's staging: the
// resident tile's chunks hold kRows rows, the streamed tile's kTile
template <int HD>
__device__ __forceinline__ void issue_ss(float (&d)[kTile / 2], uint64_t da,
                                         const unsigned char* b_tile) {
  using L = Smem<HD>;
  hopper::issue_ss<HD, L::CH, L::RES_CHUNK, L::STR_CHUNK>(d, da, b_tile);
}

template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&a)[kTile / 16][4],
                                         const unsigned char* b_tile) {
  using L = Smem<HD>;
  hopper::issue_rs<HD, L::CH, L::STR_CHUNK>(acc, a, b_tile);
}

// dK/dV's elementwise step on one query tile, transposed: sc holds s^T
// (rows: keys key0 / key0 + 8; columns: queries q0 + 8 j + cq + e) and
// becomes P^T = 2^(s c - lse2[query]), 0 where masked; dp holds dP^T and
// becomes dS^T / sm_scale = P^T (dP^T - delta[query]).  The per-query lse
// and delta come from the stage's rows.
template <int HD>
__device__ __forceinline__ void grad_dkv(float (&sc)[kTile / 2],
                                         float (&dp)[kTile / 2],
                                         const Params& p,
                                         const unsigned char* sm, int s,
                                         int q0, int r_lo, int key0,
                                         int segk0, int segk1, int cq) {
  using L = Smem<HD>;
  const float c = p.scale_log2;
  const float* l2 =
      reinterpret_cast<const float*>(sm + L::LSE) + s * kTile + cq;
  const float* dl =
      reinterpret_cast<const float*>(sm + L::DELTA) + s * kTile + cq;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j);
    sc[4 * j] = hopper::ex2(fmaf(sc[4 * j], c, -l.x));
    sc[4 * j + 1] = hopper::ex2(fmaf(sc[4 * j + 1], c, -l.y));
    sc[4 * j + 2] = hopper::ex2(fmaf(sc[4 * j + 2], c, -l.x));
    sc[4 * j + 3] = hopper::ex2(fmaf(sc[4 * j + 3], c, -l.y));
  }
  // causal: a key is seen by the queries at or after it
  if (p.causal && q0 < r_lo + 63) {
    const int lim0 = key0 - q0 - cq;   // columns below it are masked
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + e < lim0) sc[4 * j + e] = 0.f;
        if (8 * j + e < lim0 + 8) sc[4 * j + 2 + e] = 0.f;
      }
    }
  }
  // segment ids: only where the tile's queries do not all share the
  // keys' segment
  if (p.seg != nullptr) {
    const int* range =
        reinterpret_cast<const int*>(sm + L::SEG_RANGE) + 2 * s;
    const bool one = range[0] == range[1] && range[0] == segk0 &&
                     range[0] == segk1;
    if (__any_sync(0xffffffffu, !one)) {
      const int* sq =
          reinterpret_cast<const int*>(sm + L::SEG) + s * kTile + cq;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int2 v = *reinterpret_cast<const int2*>(sq + 8 * j);
        if (v.x != segk0) sc[4 * j] = 0.f;
        if (v.y != segk0) sc[4 * j + 1] = 0.f;
        if (v.x != segk1) sc[4 * j + 2] = 0.f;
        if (v.y != segk1) sc[4 * j + 3] = 0.f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j);
    dp[4 * j] = sc[4 * j] * (dp[4 * j] - d.x);
    dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - d.y);
    dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - d.x);
    dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - d.y);
  }
}

// dQ's elementwise step on one key tile: sc holds s (rows: queries row0 /
// row0 + 8 with lse2 / delta in registers; columns: keys k0 + 8 j + cq +
// e) and becomes P, 0 where masked; dp becomes dS / sm_scale.
template <int HD>
__device__ __forceinline__ void grad_dq(float (&sc)[kTile / 2],
                                        float (&dp)[kTile / 2],
                                        const Params& p,
                                        const unsigned char* sm, int s,
                                        int k0, int r_lo, int row0,
                                        const float (&l2)[2],
                                        const float (&dl)[2],
                                        const int (&segq)[2], int cq) {
  using L = Smem<HD>;
  const float c = p.scale_log2;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = hopper::ex2(fmaf(sc[4 * j + e], c, -l2[0]));
      sc[4 * j + 2 + e] = hopper::ex2(fmaf(sc[4 * j + 2 + e], c, -l2[1]));
    }
  }
  // causal and ragged S: a row sees the columns below its limit
  if (k0 + kTile > p.S || (p.causal && k0 + kTile - 1 > r_lo)) {
    int lim0 = p.S - k0, lim1 = lim0;
    if (p.causal) {
      lim0 = min(lim0, row0 + 1 - k0);
      lim1 = min(lim1, row0 + 9 - k0);
    }
    lim0 -= cq;   // against the compile-time part of the column
    lim1 -= cq;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + e >= lim0) sc[4 * j + e] = 0.f;
        if (8 * j + e >= lim1) sc[4 * j + 2 + e] = 0.f;
      }
    }
  }
  if (p.seg != nullptr) {
    const int* range =
        reinterpret_cast<const int*>(sm + L::SEG_RANGE) + 2 * s;
    const bool one = range[0] == range[1] && range[0] == segq[0] &&
                     range[0] == segq[1];
    if (__any_sync(0xffffffffu, !one)) {
      const int* sk =
          reinterpret_cast<const int*>(sm + L::SEG) + s * kTile + cq;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int2 v = *reinterpret_cast<const int2*>(sk + 8 * j);
        if (v.x != segq[0]) sc[4 * j] = 0.f;
        if (v.y != segq[0]) sc[4 * j + 1] = 0.f;
        if (v.x != segq[1]) sc[4 * j + 2] = 0.f;
        if (v.y != segq[1]) sc[4 * j + 3] = 0.f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dl[0]);
      dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl[1]);
    }
  }
}

// Both kernels' loops are software-pipelined: streamed tile i's score
// products are issued before tile i - 1's accumulating products, so tile
// i's elementwise step runs on the CUDA cores while those hold the tensor
// cores.  That keeps both tiles' registers live, which the dK/dV kernel at
// head dim 128 (dK and dV alone 128 floats a thread) cannot: it waits for
// each tile's products before the next tile's.
template <int HD>
constexpr bool kDkvPipelined = HD <= 96;

// One dK/dV output tile for one consumer warpgroup: its 64 keys against
// the tile's streamed query tiles, ring positions it .. it + n_items - 1.
// Per query tile: s^T and dP^T, the elementwise step, then dV += P^T dO
// and dK += dS^T q.
template <int HD>
__device__ __forceinline__ void consume_dkv(const Params& p,
                                            unsigned char* sm,
                                            const Bars& bar, const Tile& w,
                                            int it, uint32_t res_parity,
                                            int cw) {
  using L = Smem<HD>;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r_lo = w.r0 + cw * 64;   // the warpgroup's first key
  const int cq = (lane & 3) * 2;     // first column of each 8-column group
  const int key0 = r_lo + warp * 16 + (lane >> 2);
  int segk0 = 0, segk1 = 0;
  if (p.seg != nullptr) {
    if (key0 < p.S) segk0 = p.seg[(size_t)w.b * p.S + key0];
    if (key0 + 8 < p.S) segk1 = p.seg[(size_t)w.b * p.S + key0 + 8];
  }
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[kTile / 2], dp[kTile / 2];
  uint32_t pa[kTile / 16][4], ga[kTile / 16][4];

  // k and v: this warpgroup's 64 rows start 64 rows into each chunk
  const uint32_t res = hopper::smem_u32(sm) + cw * 64 * L::ROW;
  const uint64_t dk_a = hopper::smem_desc(res + L::RES0, 16, L::SBO, L::ROW);
  const uint64_t dv_a = hopper::smem_desc(res + L::RES1, 16, L::SBO, L::ROW);
  hopper::mbar_wait(bar.res_full, res_parity);

  if constexpr (kDkvPipelined<HD>) {
    {   // query tile 0's scores
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      hopper::mbar_wait(bar.s0_full + s, ph);
      hopper::wgmma_fence();
      issue_ss<HD>(sc, dk_a, sm + L::STR0 + s * L::STR_BYTES);
      hopper::mbar_wait(bar.s1_full + s, ph);
      issue_ss<HD>(dp, dv_a, sm + L::STR1 + s * L::STR_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      if (w.n_items == 1 && lane == 0) hopper::mbar_arrive(bar.res_empty);
      grad_dkv<HD>(sc, dp, p, sm, s, w.first * kTile, r_lo, key0, segk0,
                   segk1, cq);
      hopper::pack_a(pa, sc);
      hopper::pack_a(ga, dp);
    }
    for (int i = 1; i < w.n_items; ++i) {
      const int s = (it + i) % kStages;
      const int sp = (it + i - 1) % kStages;
      const uint32_t ph = ((it + i) / kStages) & 1;
      const int j = i / w.per;
      const int q0 = (w.first + i - j * w.per) * kTile;
      hopper::mbar_wait(bar.s0_full + s, ph);
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::wgmma_fence();
      issue_ss<HD>(sc, dk_a, sm + L::STR0 + s * L::STR_BYTES);
      hopper::mbar_wait(bar.s1_full + s, ph);
      issue_ss<HD>(dp, dv_a, sm + L::STR1 + s * L::STR_BYTES);
      hopper::wgmma_commit();
      issue_rs<HD>(dv, pa, sm + L::STR1 + sp * L::STR_BYTES);
      issue_rs<HD>(dk, ga, sm + L::STR0 + sp * L::STR_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // tile i's s^T and dP^T have landed
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      if (i == w.n_items - 1 && lane == 0)
        hopper::mbar_arrive(bar.res_empty);
      grad_dkv<HD>(sc, dp, p, sm, s, q0, r_lo, key0, segk0, segk1, cq);
      hopper::wgmma_wait<0>();   // tile i - 1's dV and dK have landed
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::fence_regs(pa);    // its A registers are free only now
      hopper::fence_regs(ga);
      if (lane == 0) hopper::mbar_arrive(bar.empty + sp);
      hopper::pack_a(pa, sc);
      hopper::pack_a(ga, dp);
    }
    {   // the last query tile's dV and dK
      const int sp = (it + w.n_items - 1) % kStages;
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::wgmma_fence();
      issue_rs<HD>(dv, pa, sm + L::STR1 + sp * L::STR_BYTES);
      issue_rs<HD>(dk, ga, sm + L::STR0 + sp * L::STR_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      if (lane == 0) hopper::mbar_arrive(bar.empty + sp);
    }
  } else {
    for (int i = 0; i < w.n_items; ++i) {
      const int s = (it + i) % kStages;
      const uint32_t ph = ((it + i) / kStages) & 1;
      const int j = i / w.per;
      const int q0 = (w.first + i - j * w.per) * kTile;
      const unsigned char* q_tile = sm + L::STR0 + s * L::STR_BYTES;
      const unsigned char* do_tile = sm + L::STR1 + s * L::STR_BYTES;
      hopper::mbar_wait(bar.s0_full + s, ph);
      hopper::wgmma_fence();
      issue_ss<HD>(sc, dk_a, q_tile);
      hopper::mbar_wait(bar.s1_full + s, ph);
      issue_ss<HD>(dp, dv_a, do_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      // the resident k and v are read for the last time: release them
      if (i == w.n_items - 1 && lane == 0)
        hopper::mbar_arrive(bar.res_empty);
      grad_dkv<HD>(sc, dp, p, sm, s, q0, r_lo, key0, segk0, segk1, cq);
      hopper::pack_a(pa, sc);
      hopper::pack_a(ga, dp);
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::wgmma_fence();
      issue_rs<HD>(dv, pa, do_tile);
      issue_rs<HD>(dk, ga, q_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::fence_regs(pa);   // the A registers are free only now
      hopper::fence_regs(ga);
      // the stage's q, dO and rows are read: release them
      if (lane == 0) hopper::mbar_arrive(bar.empty + s);
    }
  }
  hopper::store_rows<HD>(p.out0, dk, p.sm_scale, w.b, p.S, p.KV, w.oh, key0,
                         cq);
  hopper::store_rows<HD>(p.out1, dv, 1.f, w.b, p.S, p.KV, w.oh, key0, cq);
}

// One dQ output tile for one consumer warpgroup: its 64 queries against
// the tile's key tiles.  Per key tile: s and dP, the elementwise step,
// then dQ += dS k.
template <int HD>
__device__ __forceinline__ void consume_dq(const Params& p, unsigned char* sm,
                                           const Bars& bar, const Tile& w,
                                           int it, uint32_t res_parity,
                                           int cw) {
  using L = Smem<HD>;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r_lo = w.r0 + cw * 64;   // the warpgroup's first query
  const int cq = (lane & 3) * 2;
  const int row0 = r_lo + warp * 16 + (lane >> 2);
  float l2[2], dl[2];
  int segq[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + 8 * e;
    const size_t row = ((size_t)w.b * p.H + w.oh) * p.S + r;
    l2[e] = r < p.S ? fold_lse(p.lse[row]) : INFINITY;
    dl[e] = r < p.S ? p.delta[row] : 0.f;
    segq[e] = (p.seg != nullptr && r < p.S) ? p.seg[(size_t)w.b * p.S + r]
                                             : 0;
  }
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  float sc[kTile / 2], dp[kTile / 2];
  uint32_t ga[kTile / 16][4];

  // q and dO: this warpgroup's 64 rows start 64 rows into each chunk
  const uint32_t res = hopper::smem_u32(sm) + cw * 64 * L::ROW;
  const uint64_t dq_a = hopper::smem_desc(res + L::RES0, 16, L::SBO, L::ROW);
  const uint64_t do_a = hopper::smem_desc(res + L::RES1, 16, L::SBO, L::ROW);
  hopper::mbar_wait(bar.res_full, res_parity);

  {   // key tile 0's scores
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    hopper::mbar_wait(bar.s0_full + s, ph);
    hopper::wgmma_fence();
    issue_ss<HD>(sc, dq_a, sm + L::STR0 + s * L::STR_BYTES);
    hopper::mbar_wait(bar.s1_full + s, ph);
    issue_ss<HD>(dp, do_a, sm + L::STR1 + s * L::STR_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    if (w.n_items == 1 && lane == 0) hopper::mbar_arrive(bar.res_empty);
    grad_dq<HD>(sc, dp, p, sm, s, 0, r_lo, row0, l2, dl, segq, cq);
    hopper::pack_a(ga, dp);
  }
  for (int i = 1; i < w.n_items; ++i) {
    const int s = (it + i) % kStages;
    const int sp = (it + i - 1) % kStages;
    const uint32_t ph = ((it + i) / kStages) & 1;
    hopper::mbar_wait(bar.s0_full + s, ph);
    hopper::fence_regs(dq);
    hopper::wgmma_fence();
    issue_ss<HD>(sc, dq_a, sm + L::STR0 + s * L::STR_BYTES);
    hopper::mbar_wait(bar.s1_full + s, ph);
    issue_ss<HD>(dp, do_a, sm + L::STR1 + s * L::STR_BYTES);
    hopper::wgmma_commit();
    issue_rs<HD>(dq, ga, sm + L::STR0 + sp * L::STR_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // key tile i's s and dP have landed
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    if (i == w.n_items - 1 && lane == 0)
      hopper::mbar_arrive(bar.res_empty);
    grad_dq<HD>(sc, dp, p, sm, s, i * kTile, r_lo, row0, l2, dl, segq, cq);
    hopper::wgmma_wait<0>();   // key tile i - 1's dQ product has landed
    hopper::fence_regs(dq);
    hopper::fence_regs(ga);    // its A registers are free only now
    if (lane == 0) hopper::mbar_arrive(bar.empty + sp);
    hopper::pack_a(ga, dp);
  }
  {   // the last key tile's dQ product
    const int sp = (it + w.n_items - 1) % kStages;
    hopper::fence_regs(dq);
    hopper::wgmma_fence();
    issue_rs<HD>(dq, ga, sm + L::STR0 + sp * L::STR_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    if (lane == 0) hopper::mbar_arrive(bar.empty + sp);
  }
  hopper::store_rows<HD>(p.out0, dq, p.sm_scale, w.b, p.S, p.H, w.oh, row0,
                         cq);
}

template <int HD, bool DKV>
__device__ __forceinline__ void consume(const Params& p, unsigned char* sm,
                                        const Bars& bar, int cw) {
  int it = 0;   // ring position
  for (int n = 0;; ++n) {   // n: output tiles done
    const int t = cta_tile(p, n);
    if (t >= p.n_tiles) break;
    const Tile w = tile_of<DKV>(p, t);
    if constexpr (DKV)
      consume_dkv<HD>(p, sm, bar, w, it, n & 1, cw);
    else
      consume_dq<HD>(p, sm, bar, w, it, n & 1, cw);
    it += w.n_items;
  }
}

// A persistent grid: one CTA per SM walks the output tiles cta_tile(p, 0),
// cta_tile(p, 1), ..., so one tile's epilogue overlaps the next tile's
// loads.  DKV: the dK/dV kernel (resident k / v, streamed q / dO), else
// the dQ kernel (resident q / dO, streamed k / v).  The producer
// warpgroup keeps 40 registers, each consumer one takes 232.
template <int HD, bool DKV>
__global__ void __launch_bounds__(kCtaThreads, 1)
    flash_bwd_bf16(const __grid_constant__ CUtensorMap tm_r0,
                   const __grid_constant__ CUtensorMap tm_r1,
                   const __grid_constant__ CUtensorMap tm_s0,
                   const __grid_constant__ CUtensorMap tm_s1,
                   const Params p) {
  using L = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BAR);
  const Bars bar{bars, bars + 1, bars + 2, bars + 2 + kStages,
                 bars + 2 + 2 * kStages};
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar.res_full, 1);
    hopper::mbar_init(bar.res_empty, 8);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar.s0_full + s, 32);
      hopper::mbar_init(bar.s1_full + s, 1);
      hopper::mbar_init(bar.empty + s, 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // producer warpgroup; its warp 0 loads
    hopper::reg_dealloc<40>();
    if (threadIdx.x < 32)
      produce<HD, DKV>(&tm_r0, &tm_r1, &tm_s0, &tm_s1, p, sm, bar);
  } else {
    hopper::reg_alloc<232>();
    consume<HD, DKV>(p, sm, bar, threadIdx.x / 128 - 1);
  }
}

// The tile order of a launch of n_tiles output tiles, n_rt a (batch,
// head), on `grid` CTAs (see cta_tile): by (batch, head) when its units
// fill the rounds evenly, else by level.  Unlike the forward
// (csrc/ds_flash_fwd.cu paired_order, which keeps the level order while
// k / v fit in L2) the backward gained from it at every training shape
// measured on an H100, down to 12.6 MB of streamed tensors.
inline int paired_order(int n_rt, int n_tiles, bool causal, int grid) {
  const bool can = !causal || n_rt % 2 == 0;
  const long long units = causal ? (long long)n_tiles / 2 : n_tiles;
  const long long rounds = (units + grid - 1) / grid;
  return can && units * 100 >= rounds * grid * 85;
}

template <int HD, bool DKV>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using L = Smem<HD>;
  Params p{};
  p.lse = a.lse;
  p.delta = a.delta;
  p.seg = a.seg;
  p.out0 = static_cast<bf16*>(DKV ? a.dk : a.dq);
  p.out1 = static_cast<bf16*>(a.dv);
  p.S = a.S;
  p.H = a.H;
  p.KV = a.KV;
  p.rep = a.H / a.KV;
  p.n_rt = (a.S + kRows - 1) / kRows;
  p.n_st = (a.S + kTile - 1) / kTile;
  p.bh_count = B * (DKV ? a.KV : a.H);
  p.n_tiles = p.n_rt * p.bh_count;
  p.causal = a.causal;
  p.scale_log2 = a.sm_scale * kLog2e;
  p.sm_scale = a.sm_scale;
  // maps over the strided views as they are: dims {hd, S, heads, B},
  // strides {s, head, batch}; rows past S and head-dim columns past HD
  // read as zeros.  Resident tensors in boxes of kRows rows, streamed
  // ones of kTile.
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t qd[4] = {HD, (uint64_t)a.S, (uint64_t)a.H, (uint64_t)B};
  const uint64_t kd[4] = {HD, (uint64_t)a.S, (uint64_t)a.KV, (uint64_t)B};
  const long long qs[3] = {a.q_ss, a.q_sh, a.q_sb};
  const long long ks[3] = {a.k_ss, a.k_sh, a.k_sb};
  const long long vs[3] = {a.v_ss, a.v_sh, a.v_sb};
  const long long os[3] = {a.o_ss, a.o_sh, a.o_sb};
  const uint32_t q_rows = DKV ? kTile : kRows;
  const uint32_t k_rows = DKV ? kRows : kTile;
  const auto swz = L::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!hopper::make_map_bf16_4d(&tq, a.q, qd, qs, L::CH, q_rows, swz) ||
      !hopper::make_map_bf16_4d(&tdo, a.dout, qd, os, L::CH, q_rows, swz) ||
      !hopper::make_map_bf16_4d(&tk, a.k, kd, ks, L::CH, k_rows, swz) ||
      !hopper::make_map_bf16_4d(&tv, a.v, kd, vs, L::CH, k_rows, swz))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t e = hopper::opt_in_smem(
      reinterpret_cast<const void*>(flash_bwd_bf16<HD, DKV>), L::ALLOC,
      opted_in);
  if (e != cudaSuccess) return e;
  int n_sm = 0;
  e = hopper::sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  const int grid = min(p.n_tiles, n_sm);
  p.paired = paired_order(p.n_rt, p.n_tiles, p.causal, grid);
  // resident pair, then streamed pair
  flash_bwd_bf16<HD, DKV><<<grid, kCtaThreads, L::ALLOC, stream>>>(
      DKV ? tk : tq, DKV ? tv : tdo, DKV ? tq : tk, DKV ? tdo : tv, p);
  return cudaGetLastError();
}

}  // namespace hbwd

// ------------------------------------------------------------------ fp32
// Stage rows [r0, r0 + 64) of one head into a [64][HD + 1] shared tile.
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ss, int r0, int S) {
  constexpr int PER_ROW = HD / 4;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx - r * PER_ROW) * 4;
    const int s = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) val = *reinterpret_cast<const float4*>(src + s * ss + c);
    float* d = dst + r * (HD + 1) + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_f32(Args a) {
  constexpr int HH = HD / 2;
  constexpr int LD = HD + 1;
  const int kt = blockIdx.x;
  const int b = blockIdx.y / a.KV;
  const int g = blockIdx.y - b * a.KV;
  const int rep = a.H / a.KV;
  const int k0 = kt * BN;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BN][LD]
  float* Vs = Ks + BN * LD;                        // [BN][LD]
  float* Qs = Vs + BN * LD;                        // [BM][LD]
  float* Os = Qs + BM * LD;                        // dO [BM][LD]
  float* lseS = Os + BM * LD;                      // [BM]
  float* dltS = lseS + BM;                         // [BM]
  int* segQ = reinterpret_cast<int*>(dltS + BM);   // [BM]

  load_tile_f32<HD>(Ks,
                    static_cast<const float*>(a.k) + b * a.k_sb + g * a.k_sh,
                    a.k_ss, k0, a.S);
  load_tile_f32<HD>(Vs,
                    static_cast<const float*>(a.v) + b * a.v_sb + g * a.v_sh,
                    a.v_ss, k0, a.S);

  // two threads per key row, each owning half the head dim
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int s_k = k0 + r;
  const int seg_k = seg_at(a, b, s_k);
  float dk[HH], dv[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) {
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const float* kr = Ks + r * LD + half * HH;
  const float* vr = Vs + r * LD + half * HH;

  const int n_tiles = (a.S + BM - 1) / BM;
  const int qt0 = a.causal ? kt : 0;
  for (int j = 0; j < rep; ++j) {
    const int h = g * rep + j;
    const float* qb =
        static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* ob =
        static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();
      load_tile_f32<HD>(Qs, qb, a.q_ss, q0, a.S);
      load_tile_f32<HD>(Os, ob, a.o_ss, q0, a.S);
      load_rows(lseS, dltS, segQ, a, b, h, q0);
      __syncthreads();
      for (int c = 0; c < BM; ++c) {
        const float* qr = Qs + c * LD + half * HH;
        const float* orow = Os + c * LD + half * HH;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HH; ++d) {
          s += kr[d] * qr[d];
          dp += vr[d] * orow[d];
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const float p = visible(a, q0 + c, s_k, segQ[c], seg_k, lseS[c])
                            ? expf(s * a.sm_scale - lseS[c]) : 0.f;
        const float ds = p * (dp - dltS[c]) * a.sm_scale;
#pragma unroll
        for (int d = 0; d < HH; ++d) {
          dv[d] += p * orow[d];
          dk[d] += ds * qr[d];
        }
      }
    }
  }

  if (s_k < a.S) {
    const size_t base = (((size_t)b * a.S + s_k) * a.KV + g) * HD + half * HH;
    float* dkr = static_cast<float*>(a.dk) + base;
    float* dvr = static_cast<float*>(a.dv) + base;
#pragma unroll
    for (int d = 0; d < HH; ++d) {
      dkr[d] = dk[d];
      dvr[d] = dv[d];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dq_f32(Args a) {
  constexpr int HH = HD / 2;
  constexpr int LD = HD + 1;
  const int qt = blockIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * BM;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BM][LD]
  float* Os = Qs + BM * LD;                        // dO [BM][LD]
  float* Ks = Os + BM * LD;                        // [BN][LD]
  float* Vs = Ks + BN * LD;                        // [BN][LD]
  int* segK = reinterpret_cast<int*>(Vs + BN * LD);  // [BN]

  load_tile_f32<HD>(Qs,
                    static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh,
                    a.q_ss, q0, a.S);
  load_tile_f32<HD>(
      Os, static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh,
      a.o_ss, q0, a.S);
  const float* kb =
      static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb =
      static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // two threads per query row, each owning half the head dim
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int s_q = q0 + r;
  const bool in = s_q < a.S;
  const size_t row = ((size_t)b * a.H + h) * a.S + s_q;
  const float lse_q = in ? a.lse[row] : kNegInfLse;
  const float dlt_q = in ? a.delta[row] : 0.f;
  const int seg_q = seg_at(a, b, s_q);
  float dq[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) dq[d] = 0.f;
  const float* qr = Qs + r * LD + half * HH;
  const float* orow = Os + r * LD + half * HH;

  const int n_tiles = (a.S + BN - 1) / BN;
  const int kt_end = a.causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile_f32<HD>(Ks, kb, a.k_ss, k0, a.S);
    load_tile_f32<HD>(Vs, vb, a.v_ss, k0, a.S);
    for (int c = threadIdx.x; c < BN; c += kThreads)
      segK[c] = seg_at(a, b, k0 + c);
    __syncthreads();
    for (int c = 0; c < BN; ++c) {
      const float* kr = Ks + c * LD + half * HH;
      const float* vr = Vs + c * LD + half * HH;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) {
        s += qr[d] * kr[d];
        dp += orow[d] * vr[d];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = visible(a, s_q, k0 + c, seg_q, segK[c], lse_q)
                          ? expf(s * a.sm_scale - lse_q) : 0.f;
      const float ds = p * (dp - dlt_q) * a.sm_scale;
#pragma unroll
      for (int d = 0; d < HH; ++d) dq[d] += ds * kr[d];
    }
  }

  if (in) {
    float* dqr = static_cast<float*>(a.dq) +
                 (((size_t)b * a.S + s_q) * a.H + h) * HD + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) dqr[d] = dq[d];
  }
}

template <typename K>
cudaError_t launch_with(K kernel, dim3 grid, size_t smem,
                        cudaStream_t stream, const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const Args& a, int B, int is_bf16,
                       cudaStream_t stream) {
  if (is_bf16) return hbwd::launch<HD, true>(a, B, stream);
  const dim3 grid((a.S + BN - 1) / BN, B * a.KV);
  const size_t smem = (size_t)(2 * BN + 2 * BM) * (HD + 1) * sizeof(float) +
                      (size_t)BM * (2 * sizeof(float) + sizeof(int));
  return launch_with(dkv_f32<HD>, grid, smem, stream, a);
}

template <int HD>
cudaError_t launch_dq(const Args& a, int B, int is_bf16,
                      cudaStream_t stream) {
  if (is_bf16) return hbwd::launch<HD, false>(a, B, stream);
  const dim3 grid((a.S + BM - 1) / BM, B * a.H);
  const size_t smem = (size_t)(2 * BM + 2 * BN) * (HD + 1) * sizeof(float) +
                      (size_t)BN * sizeof(int);
  return launch_with(dq_f32<HD>, grid, smem, stream, a);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* seg, void* dq,
               void* dk, void* dv, int S, int H, int KV,
               const long long* st, int causal, float sm_scale) {
  return Args{q,      k,      v,      dout,
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const int*>(seg),
              dq,     dk,     dv,     S,      H,      KV,
              st[0],  st[1],  st[2],  st[3],  st[4],  st[5],
              st[6],  st[7],  st[8],  st[9],  st[10], st[11],
              causal, sm_scale};
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, dO in turn.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg, void* dk,
                                void* dv, int B, int S, int H, int KV,
                                int head_dim, const long long* strides,
                                int causal, float sm_scale, int is_bf16,
                                void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg, nullptr, dk, dv,
                           S, H, KV, strides, causal, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return (int)launch_dkv<64>(a, B, is_bf16, st);
    case 80: return (int)launch_dkv<80>(a, B, is_bf16, st);
    case 96: return (int)launch_dkv<96>(a, B, is_bf16, st);
    case 128: return (int)launch_dkv<128>(a, B, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* seg, void* dq,
                               int B, int S, int H, int KV, int head_dim,
                               const long long* strides, int causal,
                               float sm_scale, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg, dq, nullptr,
                           nullptr, S, H, KV, strides, causal, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return (int)launch_dq<64>(a, B, is_bf16, st);
    case 80: return (int)launch_dq<80>(a, B, is_bf16, st);
    case 96: return (int)launch_dq<96>(a, B, is_bf16, st);
    case 128: return (int)launch_dq<128>(a, B, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile order a bf16 launch of this shape takes on the current device:
// 1 by (batch, head), 0 by level (see cta_tile); a negative cudaError_t
// on bad arguments.  dkv: the dK/dV kernel's (tiles over the KV heads),
// else the dQ kernel's.
extern "C" int ds_flash_bwd_tile_order(int B, int S, int H, int KV,
                                       int causal, int dkv) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0)
    return -(int)cudaErrorInvalidValue;
  const int n_rt = (S + hbwd::kRows - 1) / hbwd::kRows;
  const int n_tiles = n_rt * B * (dkv ? KV : H);
  int n_sm = 0;
  const cudaError_t e = hopper::sm_count(&n_sm);
  if (e != cudaSuccess) return -(int)e;
  return hbwd::paired_order(n_rt, n_tiles, causal != 0, min(n_tiles, n_sm));
}
