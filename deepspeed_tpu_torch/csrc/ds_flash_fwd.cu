// FlashAttention-2 forward: o = softmax(q k^T * sm_scale + mask) v with the
// per-row logsumexp saved, never materialising the [S, S] scores.
//
// Replaces: deepspeed_tpu/ops/pallas/ds_flash_attention.py:_fwd_kernel
// (launcher _fwd).  Same semantics: causal or bidirectional, grouped-query
// attention (query head h reads kv head h / (H / KV)), optional segment
// ids (a pair attends only when seg[q] == seg[k]), lse = -1e30 and o = 0
// for a row that sees no key.  Any S >= 1: the ragged last tile is masked,
// so prompt buckets such as 272 need no divisibility rule.
//
// What bounds it on an H100: operations.  A causal prefill at S = 1024,
// head_dim 96 does 4 * S^2 / 2 * head_dim flops per head over only
// 4 * S * head_dim bytes of q/k/v/o, far above the ~295 flops per byte
// where the tensor cores become the limit; only wgmma reaches their rate,
// and the softmax's exp2 (16 a cycle per SM) must hide behind it.  At
// S 1024 the K/V re-reads can also hit device memory unless they stay in
// L2.  What the bf16 design does about it (flash_fwd_bf16, namespace hfwd):
//   - a persistent grid, one CTA per SM walking 128-row query tiles of
//     one (batch, head) in an order that keeps k / v in L2 and the CTAs'
//     key-tile counts even (cta_tile); the key loop inside the CTA takes
//     the place of the TPU's sequential grid dimension and stops at the
//     diagonal tile when causal;
//   - warp specialisation: one producer warp loads q and k / v tiles of
//     128 keys by TMA into a three-stage ring (mbarriers report bytes
//     landed and slots freed; k and v on separate ones) and hands its
//     warpgroup's registers to the two consumer warpgroups (setmaxnreg);
//   - each consumer warpgroup owns 64 query rows: s = q k^T by wgmma
//     m64n128k16 from shared memory into registers, the online softmax on
//     the registers (quad shuffles for row max / sum, exp2 with
//     sm_scale * log2(e) folded in), p packed to bf16 in registers as the
//     A operand of o += p v (v read MN-major through the transpose bit),
//     o and its rescale in registers until the epilogue;
//   - the softmax overlaps the tensor cores twice over: inside a
//     warpgroup the next key tile's q k^T is issued before this one's p v,
//     and the two warpgroups take turns issuing (named barriers), so one's
//     softmax runs under the other's products;
//   - the mask (causal, ragged S, segment ids) is applied on the score
//     registers only on tiles that need it: the diagonal, the ragged last
//     tile, and tiles whose keys span a segment boundary or differ from
//     the rows' segments; no wgmma sits in a data-dependent branch (the
//     compiler would serialise them all);
//   - head dims 64 and 128 are staged in 64-column chunks with 128-byte
//     swizzle, 80 and 96 (not multiples of 64) in 32-column chunks with
//     64-byte swizzle; 80's third chunk reads past the map's extent as
//     zeros;
//   - the tensor maps describe the strided [B, S, heads, hd] views as they
//     are (fused-QKV slices need no copy); rows past S land as zeros;
//   - deterministic: one CTA per output tile, no atomics, no split of the
//     keys, so a row's bits do not depend on B or on the other rows.
// The fp32 kernel (flash_fwd_f32) keeps plain fp32 FMA, two threads per
// query row, so fp32 results carry no TF32 rounding.
//
// Inputs may be strided views (q/k/v slices of one fused qkv tensor): the
// caller passes batch, sequence and head strides in elements; the last
// dimension is contiguous and every stride and base address is 16-byte
// aligned (checked by the Python wrapper).  Outputs are contiguous:
// o [B, S, H, HD] in the input dtype, lse [B, H, S] fp32.
#include <atomic>
#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInfLse = -1e30f;
// the fp32 kernel's tiling
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int kThreads = 128;

// ------------------------------------------------------------------ fp32
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;
  void* o;
  float* lse;
  int S, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  float sm_scale;
};

// Visible (query s_q, key s_k) pair.
__device__ __forceinline__ bool visible(const Args& a, int s_q, int s_k,
                                        int seg_q, const int* seg_k_s,
                                        int c) {
  if (s_k >= a.S) return false;
  if (a.causal && s_k > s_q) return false;
  if (a.seg != nullptr && seg_k_s[c] != seg_q) return false;
  return true;
}

// Stage rows [r0, r0 + 64) of one head of a [B, S, *, HD] view into a
// dense [64][HD] shared tile, zero past S.  VEC elements per 16 bytes.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss,
                                          int r0, int S) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx - r * PER_ROW) * VEC;
    const int s = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(src + s * ss + c);
    *reinterpret_cast<uint4*>(dst + r * HD + c) = val;
  }
}

__device__ __forceinline__ void load_seg(int* dst, const Args& a, int b,
                                         int r0) {
  if (a.seg == nullptr) return;
  for (int c = threadIdx.x; c < 64; c += kThreads) {
    const int s = r0 + c;
    dst[c] = s < a.S ? a.seg[(size_t)b * a.S + s] : 0;
  }
}


template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Args a) {
  constexpr int HH = HD / 2;
  const int qt = blockIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * BM;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BN][HD]
  float* Vs = Ks + BN * HD;                        // [BN][HD]
  float* Ss = Vs + BN * HD;                        // [BM][BN + 1]
  int* segK = reinterpret_cast<int*>(Ss + BM * (BN + 1));  // [BN]

  // two threads per query row, each owning half the head dim
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int s_q = q0 + r;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb =
      static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb =
      static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float qreg[HH], acc[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) {
    qreg[d] = s_q < a.S ? qb[s_q * a.q_ss + half * HH + d] : 0.f;
    acc[d] = 0.f;
  }
  const int seg_q = (a.seg != nullptr && s_q < a.S)
                        ? a.seg[(size_t)b * a.S + s_q] : 0;
  float m_i = -INFINITY;
  float l_i = 0.f;

  const int n_tiles = (a.S + BN - 1) / BN;
  const int kt_end = a.causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<float, HD>(Ks, kb, a.k_ss, k0, a.S);
    load_tile<float, HD>(Vs, vb, a.v_ss, k0, a.S);
    load_seg(segK, a, b, k0);
    __syncthreads();

    float* srow = Ss + r * (BN + 1);
    float mx = -INFINITY;
    for (int c = 0; c < BN; ++c) {
      const float* kr = Ks + c * HD + half * HH;
      float p = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) p += qreg[d] * kr[d];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      const float x = visible(a, s_q, k0 + c, seg_q, segK, c)
                          ? p * a.sm_scale : -INFINITY;
      if (half == 0) srow[c] = x;
      mx = fmaxf(mx, x);
    }
    __syncwarp();
    const float m_new = fmaxf(m_i, mx);
    const bool any = m_new != -INFINITY;
    const float alpha = any ? expf(m_i - m_new) : 1.f;
#pragma unroll
    for (int d = 0; d < HH; ++d) acc[d] *= alpha;
    float psum = 0.f;
    for (int c = 0; c < BN; ++c) {
      const float p = any ? expf(srow[c] - m_new) : 0.f;
      psum += p;
      const float* vr = Vs + c * HD + half * HH;
#pragma unroll
      for (int d = 0; d < HH; ++d) acc[d] += p * vr[d];
    }
    l_i = l_i * alpha + psum;
    m_i = m_new;
  }

  if (s_q < a.S) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    float* orow = static_cast<float*>(a.o) +
                  (((size_t)b * a.S + s_q) * a.H + h) * HD + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) orow[d] = acc[d] * inv;
    if (half == 0)
      a.lse[((size_t)b * a.H + h) * a.S + s_q] =
          l_i > 0.f ? m_i + logf(l_i) : kNegInfLse;
  }
}

// ------------------------------------------------------------------ bf16
// The Hopper forward: a CTA of three warpgroups per SM, each output tile a
// 128-row query tile of one (batch, head).  Warpgroup 0 gives up its
// registers and one of its warps loads by TMA: q per output tile, k and v
// tiles of 128 keys into a three-stage ring (k and v of a stage on
// separate barriers, so q k^T starts before v lands).  Warpgroups 1 and 2
// each own 64 query rows and, per key tile, run s = q k^T with wgmma
// (scores stay in registers), the online softmax on those registers, and
// o += p v with p as wgmma's register operand; o and its rescale stay in
// registers until the epilogue.
namespace hfwd {

// For A/Bs (scripts/torch_flash_fwd_ab.py) a build may force the tile
// order, -DDS_FLASH_FWD_ORDER=0 / 1 (where it can run; -1: chosen per
// call, paired_order), and scale the scores before the softmax instead
// of folding sm_scale into the exponent, -DDS_FLASH_FWD_FOLD=0.
#ifndef DS_FLASH_FWD_ORDER
#define DS_FLASH_FWD_ORDER -1
#endif
#ifndef DS_FLASH_FWD_FOLD
#define DS_FLASH_FWD_FOLD 1
#endif

constexpr int kBM = 128;        // query rows per CTA (two warpgroups of 64)
constexpr int kBN = 128;        // keys per tile
constexpr int kStages = 3;      // k / v ring depth
constexpr int kCtaThreads = 384;   // producer warpgroup + two consumer ones
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLn2 = 0.69314718055994531f;

// Shared memory, in bytes from a 1024-aligned base: q [chunk][kBM][CH],
// k and v [stage][chunk][kBN][CH] (swizzled rows of CH columns; head dim
// 80 reads its third chunk half past the map's extent, as zeros), the key
// tile's segment ids and their (min, max), then the barriers.
template <int HD>
struct Smem {
  // head dims that are a multiple of 64 stage in 64-column chunks
  // (128-byte swizzle), 80 and 96 in 32-column chunks (64-byte swizzle)
  static constexpr int CH = HD % 64 == 0 ? 64 : 32;
  static constexpr int ROW = CH * 2;         // bytes: the swizzle span
  static constexpr int SBO = 8 * ROW;        // 8-row group stride
  static constexpr int SLICES = CH / 16;     // k16 slices per chunk
  static constexpr int NCH = (HD + CH - 1) / CH;
  static constexpr int Q_CHUNK = kBM * ROW;
  static constexpr int KV_CHUNK = kBN * ROW;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;   // one k or v tile
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;
  static constexpr int V = K + kStages * KV_BYTES;
  static constexpr int SEG = V + kStages * KV_BYTES;         // int [stage][kBN]
  static constexpr int SEG_RANGE = SEG + kStages * kBN * 4;  // int [stage][2]
  static constexpr int BAR = SEG_RANGE + kStages * 8;        // uint64
  static constexpr int N_BARS = 2 + 4 * kStages;  // q, k, v: full / empty
  static constexpr int ALLOC = BAR + N_BARS * 8 + 1024;  // + base alignment
};

struct Params {
  const int* seg;
  bf16* o;
  float* lse;
  int S, H, KV, n_qt, causal;
  int n_tiles;        // n_qt * B * H output tiles
  int paired;         // tile order: 0 by level, 1 by (batch, head)
  float scale_log2;   // sm_scale * log2(e)
};

// Output tile t = level * (B * H) + (batch, head); level 0 holds the last
// query tile (the longest causal rows).
struct Tile {
  int b, h, kvh, q0, n_kt;
};

// The CTA's n-th output tile (p.n_tiles or more: none left), in the order
// the host picks (hopper::persistent_tile): by level for grids of about
// one round (a prefill); by (batch, head), in causal pairs of levels L
// and n_qt - 1 - L whose key tiles always add up to n_qt + 1, so the
// CTAs running at once share few heads' k and v in L2 (by level they
// would stream every head's k and v from device memory once per query
// tile).
__device__ __forceinline__ int cta_tile(const Params& p, int n) {
  return hopper::persistent_tile(n, p.paired, p.causal, p.n_qt,
                                 p.n_tiles);
}

__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  const int bh_count = p.n_tiles / p.n_qt;
  const int level = t / bh_count;
  const int bh = t - level * bh_count;
  Tile w;
  w.b = bh / p.H;
  w.h = bh - w.b * p.H;
  w.kvh = w.h / (p.H / p.KV);
  w.q0 = (p.n_qt - 1 - level) * kBM;
  const int n_kt_all = (p.S + kBN - 1) / kBN;
  w.n_kt = p.causal ? min(n_kt_all, (min(p.S, w.q0 + kBM) + kBN - 1) / kBN)
                    : n_kt_all;
  return w;
}

struct Bars {
  uint64_t* q_full;
  uint64_t* q_empty;   // one arrival per consumer warp
  uint64_t* k_full;    // [kStages]; 32 arrivals (the producer warp) + bytes
  uint64_t* v_full;    // [kStages]; one arrival + bytes
  uint64_t* k_empty;   // [kStages]; one arrival per consumer warp
  uint64_t* v_empty;   // [kStages]; one arrival per consumer warp
};

// The producer warp: for each of the CTA's output tiles, q once (after
// the consumers have read the previous tile's), then the key tiles
// through the ring; the ring position runs on across output tiles, so
// the next tile's q and first keys load while the consumers finish.
template <int HD>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Params& p, unsigned char* sm,
                                        const Bars& bar) {
  using L = Smem<HD>;
  const int lane = threadIdx.x & 31;
  int it = 0;   // ring position
  for (int n = 0;; ++n) {   // n: output tiles done
    const int t = cta_tile(p, n);
    if (t >= p.n_tiles) break;
    const Tile w = tile_of(p, t);
    hopper::mbar_wait(bar.q_empty, (n & 1) ^ 1);
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(bar.q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::NCH; ++c)
        hopper::tma_load_4d(sm + L::Q + c * L::Q_CHUNK, tq, bar.q_full,
                            c * L::CH, w.q0, w.h, w.b);
    }
    for (int i = 0; i < w.n_kt; ++i, ++it) {
      const int s = it % kStages;
      const uint32_t parity = ((it / kStages) & 1) ^ 1;
      hopper::mbar_wait(bar.k_empty + s, parity);
      const int k0 = i * kBN;
      if (p.seg != nullptr) {
        int* seg = reinterpret_cast<int*>(sm + L::SEG) + s * kBN;
        int lo = INT_MAX, hi = INT_MIN;
        for (int c = lane; c < kBN; c += 32) {
          const int key = k0 + c;
          const int v = key < p.S ? p.seg[(size_t)w.b * p.S + key] : 0;
          seg[c] = v;
          if (key < p.S) {
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
      // each lane's arrival releases its segment-id stores to the consumers
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(bar.k_full + s, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          hopper::tma_load_4d(sm + L::K + s * L::KV_BYTES + c * L::KV_CHUNK,
                              tk, bar.k_full + s, c * L::CH, k0, w.kvh, w.b);
      } else {
        hopper::mbar_arrive(bar.k_full + s);
      }
      hopper::mbar_wait(bar.v_empty + s, parity);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(bar.v_full + s, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          hopper::tma_load_4d(sm + L::V + s * L::KV_BYTES + c * L::KV_CHUNK,
                              tv, bar.v_full + s, c * L::CH, k0, w.kvh, w.b);
      }
    }
  }
}

// One consumer thread's view of its two rows (row0 = 16 w + l / 4 of the
// warpgroup's 64, and row0 + 8): running max in log2 units and its share
// of the row sums (the quad of lanes sharing a row sums at the end).
struct RowState {
  int row0, row1;     // absolute query positions
  int seg0, seg1;     // their segment ids (when the call has them)
  float m0, m1;
  float l0, l1;
};

// Mask (only where the tile needs it) and online-softmax one key tile's
// scores in place: sc becomes p = 2^(x - max) with x = s * sm_scale *
// log2(e); returns the factors by which each row's o must shrink.
template <int HD>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2],
                                             RowState& r, const Params& p,
                                             const unsigned char* sm, int s,
                                             int k0, int r_lo, int cq,
                                             float& alpha0, float& alpha1) {
  using L = Smem<HD>;
  // with sm_scale > 0 the row max of the raw scores is the max of the
  // scaled ones, and the scale folds into the exponent's FFMA; otherwise
  // the scores are scaled first
  float c = p.scale_log2;
  if (!DS_FLASH_FWD_FOLD || c <= 0.f) {
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) sc[j] *= c;
    c = 1.f;
  }
  // causal and ragged S: a row sees the columns below its limit
  if (k0 + kBN > p.S || (p.causal && k0 + kBN - 1 > r_lo)) {
    int lim0 = p.S - k0, lim1 = lim0;
    if (p.causal) {
      lim0 = min(lim0, r.row0 + 1 - k0);
      lim1 = min(lim1, r.row1 + 1 - k0);
    }
    lim0 -= cq;   // against the compile-time part of the column
    lim1 -= cq;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + e >= lim0) sc[4 * j + e] = -INFINITY;
        if (8 * j + e >= lim1) sc[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  // segment ids: only where the tile's keys do not all share the rows'
  // segment (the producer stored each tile's min and max)
  if (p.seg != nullptr) {
    const int* range =
        reinterpret_cast<const int*>(sm + L::SEG_RANGE) + 2 * s;
    const bool one = range[0] == range[1] && range[0] == r.seg0 &&
                     range[0] == r.seg1;
    if (__any_sync(0xffffffffu, !one)) {
      const int* segk = reinterpret_cast<const int*>(sm + L::SEG) + s * kBN;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int2 sk = *reinterpret_cast<const int2*>(segk + 8 * j + cq);
        if (sk.x != r.seg0) sc[4 * j] = -INFINITY;
        if (sk.y != r.seg0) sc[4 * j + 1] = -INFINITY;
        if (sk.x != r.seg1) sc[4 * j + 2] = -INFINITY;
        if (sk.y != r.seg1) sc[4 * j + 3] = -INFINITY;
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  mx0 = fmaxf(r.m0, mx0 * c);   // log2 units
  mx1 = fmaxf(r.m1, mx1 * c);
  // a row that has seen no key yet keeps base 0: its p and alpha are 0
  const float base0 = mx0 == -INFINITY ? 0.f : mx0;
  const float base1 = mx1 == -INFINITY ? 0.f : mx1;
  alpha0 = hopper::ex2(r.m0 - base0);
  alpha1 = hopper::ex2(r.m1 - base1);
  r.m0 = mx0;
  r.m1 = mx1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = hopper::ex2(fmaf(sc[4 * j + e], c, -base0));
      sc[4 * j + 2 + e] = hopper::ex2(fmaf(sc[4 * j + 2 + e], c, -base1));
      ls0 += sc[4 * j + e];
      ls1 += sc[4 * j + 2 + e];
    }
  }
  r.l0 = r.l0 * alpha0 + ls0;
  r.l1 = r.l1 * alpha1 + ls1;
}

// p in bf16, laid out as wgmma's register A operand (k16 slice kk)
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBN / 16][4],
                                       const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
}

template <int HD>
__device__ __forceinline__ void rescale_o(float (&o)[HD / 2], float alpha0,
                                          float alpha1) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// s = q k^T for one key tile: [64 x kBN] per warpgroup, HD / 16 k-slices
// (no wgmma sits in a branch: a data-dependent one makes the compiler
// serialise every wgmma of the kernel)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint64_t dq,
                                         const unsigned char* sm, int s) {
  using L = Smem<HD>;
  const uint64_t dk = hopper::smem_desc(
      hopper::smem_u32(sm + L::K + s * L::KV_BYTES), 16, L::SBO, L::ROW);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off_q =
        (kk / L::SLICES) * L::Q_CHUNK + (kk % L::SLICES) * 32;
    const uint32_t off_k =
        (kk / L::SLICES) * L::KV_CHUNK + (kk % L::SLICES) * 32;
    hopper::wgmma_m64n128k16_ss(sc, dq + (off_q >> 4), dk + (off_k >> 4),
                                kk > 0);
  }
  hopper::wgmma_commit();
}

// o += p v: v [kBN keys x HD] read MN-major, 16 keys a slice
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[kBN / 16][4],
                                         const unsigned char* sm, int s) {
  using L = Smem<HD>;
  const uint64_t dv = hopper::smem_desc(
      hopper::smem_u32(sm + L::V + s * L::KV_BYTES), L::KV_CHUNK, L::SBO,
      L::ROW);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    hopper::wgmma_m64k16_rs<HD>(o, pa[kk], dv + ((kk * 16 * L::ROW) >> 4),
                                1);
  hopper::wgmma_commit();
}

// Ping-pong between the two consumer warpgroups: each issues its products
// only on its turn (named barrier 1 + its index) and then hands the turn
// to the other, so one warpgroup's softmax runs while the other's
// products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int cw) {
  hopper::named_bar_sync(1 + cw, 256);
}
__device__ __forceinline__ void turn_pass(int cw) {
  hopper::named_bar_arrive(2 - cw, 256);
}

// One output tile for one consumer warpgroup: 64 query rows against the
// tile's keys, ring positions it .. it + n_kt - 1.  The loop is
// software-pipelined inside the warpgroup: key tile i's q k^T is issued
// before key tile i - 1's p v, so tile i's softmax runs on the CUDA cores
// while p v runs on the tensor cores.
template <int HD>
__device__ __forceinline__ void consume_tile(const Params& p,
                                             unsigned char* sm,
                                             const Bars& bar, const Tile& w,
                                             int it, uint32_t q_parity,
                                             int cw) {
  using L = Smem<HD>;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r_lo = w.q0 + cw * 64;   // the warpgroup's first row
  const int cq = (lane & 3) * 2;     // first column of each 8-column group
  RowState r;
  r.row0 = r_lo + warp * 16 + (lane >> 2);
  r.row1 = r.row0 + 8;
  r.seg0 = r.seg1 = 0;
  if (p.seg != nullptr) {
    if (r.row0 < p.S) r.seg0 = p.seg[(size_t)w.b * p.S + r.row0];
    if (r.row1 < p.S) r.seg1 = p.seg[(size_t)w.b * p.S + r.row1];
  }
  r.m0 = r.m1 = -INFINITY;
  r.l0 = r.l1 = 0.f;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float sc[kBN / 2];
  uint32_t pa[kBN / 16][4];
  float alpha0, alpha1;

  // q: this warpgroup's 64 rows start 64 rows into each chunk
  const uint64_t dq = hopper::smem_desc(
      hopper::smem_u32(sm + L::Q) + cw * 64 * L::ROW, 16, L::SBO, L::ROW);
  hopper::mbar_wait(bar.q_full, q_parity);

  {   // key tile 0
    const int s = it % kStages;
    hopper::mbar_wait(bar.k_full + s, (it / kStages) & 1);
    turn_wait(cw);
    hopper::wgmma_fence();
    issue_qk<HD>(sc, dq, sm, s);
    turn_pass(cw);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    if (w.n_kt == 1 && lane == 0) hopper::mbar_arrive(bar.q_empty);
    softmax_tile<HD>(sc, r, p, sm, s, 0, r_lo, cq, alpha0, alpha1);
    // the stage's k and its segment ids are read: release them
    if (lane == 0) hopper::mbar_arrive(bar.k_empty + s);
    pack_p(pa, sc);
  }
  for (int i = 1; i < w.n_kt; ++i) {
    const int s = (it + i) % kStages;
    const int sp = (it + i - 1) % kStages;
    hopper::mbar_wait(bar.k_full + s, ((it + i) / kStages) & 1);
    turn_wait(cw);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
    issue_qk<HD>(sc, dq, sm, s);
    hopper::mbar_wait(bar.v_full + sp, ((it + i - 1) / kStages) & 1);
    issue_pv<HD>(o, pa, sm, sp);
    turn_pass(cw);
    hopper::wgmma_wait<1>();   // q k^T of key tile i has landed
    hopper::fence_regs(sc);
    if (i == w.n_kt - 1 && lane == 0) hopper::mbar_arrive(bar.q_empty);
    softmax_tile<HD>(sc, r, p, sm, s, i * kBN, r_lo, cq, alpha0, alpha1);
    if (lane == 0) hopper::mbar_arrive(bar.k_empty + s);
    hopper::wgmma_wait<0>();   // p v of key tile i - 1 has landed
    hopper::fence_regs(o);
    hopper::fence_regs(pa);    // its p registers are free only now
    if (lane == 0) hopper::mbar_arrive(bar.v_empty + sp);
    rescale_o<HD>(o, alpha0, alpha1);
    pack_p(pa, sc);
  }
  {   // the last key tile's p v
    const int sp = (it + w.n_kt - 1) % kStages;
    hopper::mbar_wait(bar.v_full + sp, ((it + w.n_kt - 1) / kStages) & 1);
    turn_wait(cw);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
    issue_pv<HD>(o, pa, sm, sp);
    turn_pass(cw);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (lane == 0) hopper::mbar_arrive(bar.v_empty + sp);
  }

  // ---- epilogue: row sums across the quad, o / l in bf16, lse in ln units
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
    r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
  }
  const float inv0 = r.l0 > 0.f ? 1.f / r.l0 : 0.f;
  const float inv1 = r.l1 > 0.f ? 1.f / r.l1 : 0.f;
  if (r.row0 < p.S) {
    bf16* orow = p.o + (((size_t)w.b * p.S + r.row0) * p.H + w.h) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          hopper::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if ((lane & 3) == 0)
      p.lse[((size_t)w.b * p.H + w.h) * p.S + r.row0] =
          r.l0 > 0.f ? (r.m0 + log2f(r.l0)) * kLn2 : kNegInfLse;
  }
  if (r.row1 < p.S) {
    bf16* orow = p.o + (((size_t)w.b * p.S + r.row1) * p.H + w.h) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          hopper::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    if ((lane & 3) == 0)
      p.lse[((size_t)w.b * p.H + w.h) * p.S + r.row1] =
          r.l1 > 0.f ? (r.m1 + log2f(r.l1)) * kLn2 : kNegInfLse;
  }
}

template <int HD>
__device__ __forceinline__ void consume(const Params& p, unsigned char* sm,
                                        const Bars& bar, int cw) {
  if (cw == 1) turn_pass(cw);   // warpgroup 0 takes the first turn
  int it = 0;   // ring position
  for (int n = 0;; ++n) {   // n: output tiles done
    const int t = cta_tile(p, n);
    if (t >= p.n_tiles) break;
    const Tile w = tile_of(p, t);
    consume_tile<HD>(p, sm, bar, w, it, n & 1, cw);
    it += w.n_kt;
  }
}

// A persistent grid: one CTA per SM walks the output tiles cta_tile(p, 0),
// cta_tile(p, 1), ..., so one tile's softmax tail and epilogue overlap the
// next tile's loads.
template <int HD>
__global__ void __launch_bounds__(kCtaThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const Params p) {
  using L = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BAR);
  const Bars bar{bars,
                 bars + 1,
                 bars + 2,
                 bars + 2 + kStages,
                 bars + 2 + 2 * kStages,
                 bars + 2 + 3 * kStages};
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar.q_full, 1);
    hopper::mbar_init(bar.q_empty, 8);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar.k_full + s, 32);
      hopper::mbar_init(bar.v_full + s, 1);
      hopper::mbar_init(bar.k_empty + s, 8);
      hopper::mbar_init(bar.v_empty + s, 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // producer warpgroup; its warp 0 loads
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) produce<HD>(&tm_q, &tm_k, &tm_v, p, sm, bar);
  } else {
    hopper::reg_alloc<kConsumerRegs>();
    consume<HD>(p, sm, bar, threadIdx.x / 128 - 1);
  }
}

// The tile order of a launch on `grid` CTAs (see cta_tile): by (batch,
// head) when k and v would not stay in the 50 MB L2 anyway and its units
// fill the rounds evenly (they do for training batches), else by level.
// On an H100 the level order was 2 % faster at 33.6 MB of k and v and
// (batch, head) 12 % faster at 50.3 MB; with fewer units than CTAs (a
// B 1 prefill) (batch, head) was up to 1.7x slower.
inline int paired_order(const Params& p, int B, int HD, int grid) {
  const bool can = !p.causal || p.n_qt % 2 == 0;
  if (DS_FLASH_FWD_ORDER >= 0) return can && DS_FLASH_FWD_ORDER == 1;
  const double kv_bytes = 4.0 * B * p.KV * p.S * HD;
  const long long units = p.causal ? (long long)p.n_tiles / 2 : p.n_tiles;
  const long long rounds = (units + grid - 1) / grid;
  return kv_bytes > 40e6 && can && units >= grid &&
         units * 100 >= rounds * grid * 85;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Params& p, int B, const long long qs[3],
                   const long long ks[3], const long long vs[3],
                   cudaStream_t stream) {
  using L = Smem<HD>;
  // maps over the strided views as they are: dims {hd, S, heads, B},
  // strides {s, head, batch}; rows past S and head-dim columns past HD
  // read as zeros
  CUtensorMap tq, tk, tv;
  const uint64_t qd[4] = {HD, (uint64_t)p.S, (uint64_t)p.H, (uint64_t)B};
  const uint64_t kd[4] = {HD, (uint64_t)p.S, (uint64_t)p.KV, (uint64_t)B};
  const auto swz = L::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!hopper::make_map_bf16_4d(&tq, q, qd, qs, L::CH, kBM, swz) ||
      !hopper::make_map_bf16_4d(&tk, k, kd, ks, L::CH, kBN, swz) ||
      !hopper::make_map_bf16_4d(&tv, v, kd, vs, L::CH, kBN, swz))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t e = hopper::opt_in_smem(
      reinterpret_cast<const void*>(flash_fwd_bf16<HD>), L::ALLOC,
      opted_in);
  if (e != cudaSuccess) return e;
  int n_sm = 0;
  e = hopper::sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  const int grid = min(p.n_tiles, n_sm);
  Params pl = p;
  pl.paired = paired_order(p, B, HD, grid);
  flash_fwd_bf16<HD><<<grid, kCtaThreads, L::ALLOC, stream>>>(tq, tk, tv,
                                                               pl);
  return cudaGetLastError();
}

}  // namespace hfwd

inline hfwd::Params bf16_params(const Args& a, int B) {
  const int n_qt = (a.S + hfwd::kBM - 1) / hfwd::kBM;
  return hfwd::Params{a.seg,    static_cast<bf16*>(a.o),
                      a.lse,    a.S,
                      a.H,      a.KV,
                      n_qt,     a.causal,
                      n_qt * B * a.H,
                      0,        a.sm_scale * 1.4426950408889634f};
}

template <int HD>
cudaError_t launch_bf16(const Args& a, int B, cudaStream_t stream) {
  const long long qs[3] = {a.q_ss, a.q_sh, a.q_sb};
  const long long ks[3] = {a.k_ss, a.k_sh, a.k_sb};
  const long long vs[3] = {a.v_ss, a.v_sh, a.v_sb};
  return hfwd::launch<HD>(a.q, a.k, a.v, bf16_params(a, B), B, qs, ks, vs,
                          stream);
}

template <int HD>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((a.S + BM - 1) / BM, B * a.H);
  const size_t smem = (size_t)2 * BN * HD * sizeof(float) +
                      (size_t)BM * (BN + 1) * sizeof(float) +
                      BN * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_fwd_f32<HD><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Args& a, int B, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<HD>(a, B, stream) : launch_f32<HD>(a, B, stream);
}

}  // namespace

extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const void* seg, void* o, void* lse, int B, int S,
                            int H, int KV, int head_dim, long long q_sb,
                            long long q_ss, long long q_sh, long long k_sb,
                            long long k_ss, long long k_sh, long long v_sb,
                            long long v_ss, long long v_sh, int causal,
                            float sm_scale, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q,    k,    v,    static_cast<const int*>(seg),
         o,    static_cast<float*>(lse),
         S,    H,    KV,   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
         v_sb, v_ss, v_sh, causal, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return (int)launch<64>(a, B, is_bf16, st);
    case 80: return (int)launch<80>(a, B, is_bf16, st);
    case 96: return (int)launch<96>(a, B, is_bf16, st);
    case 128: return (int)launch<128>(a, B, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile order a bf16 launch of this shape takes on the current device:
// 1 by (batch, head), 0 by level (see cta_tile); a negative cudaError_t
// on bad arguments.
extern "C" int ds_flash_fwd_tile_order(int B, int S, int H, int KV,
                                       int head_dim, int causal) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 ||
      (head_dim != 64 && head_dim != 80 && head_dim != 96 &&
       head_dim != 128))
    return -(int)cudaErrorInvalidValue;
  Args a{};
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.causal = causal;
  const hfwd::Params p = bf16_params(a, B);
  int n_sm = 0;
  const cudaError_t e = hopper::sm_count(&n_sm);
  if (e != cudaSuccess) return -(int)e;
  return hfwd::paired_order(p, B, head_dim, min(p.n_tiles, n_sm));
}
