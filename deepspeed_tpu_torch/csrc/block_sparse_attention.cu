// Block-sparse attention: forward, dQ and dK/dV over the live blocks of a
// block layout only; masked blocks are never read or multiplied.
//
// Replaces: deepspeed_tpu/ops/pallas/block_sparse_attention.py:_kernel (the
// forward, launcher _call), :_dq_kernel and :_dkv_kernel (launcher
// _bwd_call).  Same semantics:
//   - the plan (the reference's _plan / _plan_transpose, built on the host):
//     idx [H, n, max_list] lists each block row's live blocks ascending,
//     cnt [H, n] how many; only the first cnt entries are read;
//   - forward: o = softmax(q k^T * sm_scale) v over the listed kv blocks,
//     the diagonal block masked causally when causal, lse = m + log(l)
//     saved when asked; a row with no live block gets o = 0, lse = +inf;
//   - dQ = sm_scale * sum_live dS k and, over the transposed plan, dV =
//     sum P^T dO, dK = sm_scale * sum dS^T q, with P = exp(q k^T * sm_scale
//     - lse) recomputed and dS = P (dO v^T - dsum), dsum = rowsum(dO * O)
//     from the caller.  A block with an empty list writes exact zeros.
//
// What bounds it on an H100: at the long sequences it exists for (S 16384,
// head_dim 96) the live blocks do 4 (forward), 6 (dQ) or 8 (dK/dV) x
// block^2 x head_dim flops each over q, k, v, dO and o read once, well above
// the ~295 flops per byte where the tensor cores become the limit for the
// Fixed layout (block 16); BigBird at block 64 has ~4 live blocks a row and
// is bound by bytes.  Only wgmma reaches the tensor cores' rate, and a
// 16-row block is too small for one: a product must span several blocks.
// As built, each consumer warpgroup streams its own gathered tiles, and at
// the Fixed layout the forward and dQ both read them at ~5 TB/s, near what
// L2 gives (PERF.md section 5).
//
// The bf16 forward, dQ and dK/dV (namespace hbsa, bsa_fwd_bf16<HD> and
// bsa_bwd_bf16<HD, DKV>; entry points bsa_fwd_h, bsa_dq_h and bsa_dkv_h)
// are persistent wgmma / TMA kernels on csrc/hopper.cuh, built on what
// csrc/ds_flash_fwd.cu and csrc/ds_flash_bwd.cu proved, over a tile plan
// the host builds once per layout (ops/kernels/block_sparse_attention.py
// TilePlan; the forward walks the dQ side's):
//   - the plan works in sub-blocks of kw = min(block, 64) rows (a block of
//     128 is 2 x 2 of them).  An own tile is up to 64 own rows, g = 64 / kw
//     sub-blocks: contiguous q blocks for the forward and dQ, whose lists
//     are nearly the same (the Fixed layout's global columns plus their
//     window); key blocks of like list length for dK/dV (a window's global
//     column would drag its local columns through ~1000 query blocks).
//     Its streamed tiles gather the sorted union of its members' lists g
//     sub-blocks at a time, each (streamed tile, own tile) pair with a live
//     word of its sub-block pairs and of the diagonal ones.  At the Fixed
//     and BigBird path layouts 93-100 % of the computed pairs are live;
//   - a CTA of three warpgroups per SM: warps 0 and 1 load by TMA, each for
//     one consumer warpgroup, which walks its own work items (an own tile,
//     or a segment of one) with its own ring: the own tile (q; q and dO,
//     or k and v, for the backward) once per item, the streamed pair (k
//     and v; q and dO for dK/dV) one box per gathered sub-block (an empty
//     slot a box wholly past S: zeros, never a stale or unlisted row), with
//     each tile's lse (log2 units) and dsum for dK/dV.  The forward keeps
//     one own tile, and the space of the second buys its ring a stage;
//   - the forward per streamed tile, as the flash forward: s = q k^T by SS
//     wgmma, the scores of every pair the plan does not list, and inside a
//     diagonal pair the keys after the query, -inf by selects before the
//     row max (a zero-filled slot scores 0, not -inf), the online softmax
//     in registers in log2 units (sm_scale * log2(e) folded into the
//     exponent's FFMA), o rescaled in registers and o += p v with p packed
//     in registers as the A operand (v read MN-major);
//   - the backward per streamed tile, as the flash backward: s (or s^T)
//     and dP (dP^T) by SS wgmma, P and dS / sm_scale (or their transposes)
//     from one FFMA and an exp2, then the mask by selects (a pair the plan
//     does not list, and inside a diagonal pair the causal triangle, give
//     exactly 0, whatever the scores held), packed in registers as the A
//     operand of dQ += dS k, or dV += P^T dO and dK += dS^T q;
//   - each loop software-pipelined (the next tile's score products issued
//     before this tile's accumulating ones; not dK/dV at head dim 128,
//     whose registers do not allow it); no wgmma sits in a data-dependent
//     branch;
//   - work items come longest first, handed out round robin (every other
//     round mirrored) over the 2 x SMs consumers and each batch row; a list
//     longer than the side's segment length (the plan's: at least 32
//     streamed tiles, and 1 / 512 of the side's tiles, so the Fixed path
//     layout's lists are not cut and BigBird's dK/dV column 0 is) is cut at
//     fixed positions into segments, each an item: each writes fp32
//     partials to a workspace (the forward: unnormalised o and each row's
//     max and sum), and the last to arrive at the unit (an int counter,
//     one acquire-release add, left 0) combines them in segment order and
//     stores the rows.  No float atomics: o, lse, dq, dk and dv are
//     bit-identical from launch to launch, and a row's bits follow the
//     layout and its own inputs only, not B, the SM count or which
//     consumer merges;
//   - head dims 64 and 128 stage in 64-column chunks with 128-byte swizzle,
//     80 and 96 in 32-column chunks with 64-byte swizzle.
//
// The fp32 kernels keep the first design, so fp32 results carry no TF32
// rounding: one CTA of four warps owns 64 rows as G = 64 / KW slots of KW
// = min(block, 64) rows (a block of 128 as two halves, each listed block
// swept as two 64-row sub-tiles), walking the slots' lists (the plan's idx
// / cnt, blocks taken in the plan's `order`, longest list first) in rounds
// between two CTA barriers; each CTA owns its output rows.  Causal: a
// sub-tile whose every pair is masked is skipped; inside the diagonal
// block the masked scores are -inf with the row max guarded, which
// contributes exactly what the reference's -1e30 does.  Plain FMA, two
// threads a row each owning half the head dim.  Head dims 64, 80, 96 and
// 128.
//
// q, k, v and dO may be strided [B, S, H, HD] views: the caller passes
// batch, sequence and head strides in elements; the last dimension is
// contiguous and every stride and base address is 16-byte aligned (checked
// by the Python wrapper).  lse and dsum are contiguous [B, H, S] fp32.
// Outputs are contiguous [B, S, H, HD] in the input dtype, lse [B, H, S].
#include <atomic>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 64;  // rows a CTA owns
constexpr int kThreads = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // dQ, dK/dV: the forward's lse
  const float* dsum;  // dQ, dK/dV
  float* lse_out;     // forward: lse, or null
  const int* idx;     // [H, nblk, max_list]: this side's plan
  const int* cnt;     // [H, nblk]
  const int* order;   // [H, nblk]: this side's blocks, longest list first
  void* out0;         // o, dq or dk
  void* out1;         // dv
  int S, H, nblk, block, max_list, kw;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int causal;
  float sm_scale;
};

// The CTA's slots: block, global row 0 and list length of each own slot
// (blk -1: past the last block), and the other side's row 0 met in the
// current round (double-buffered by round parity; -1: nothing to do).
struct Slots {
  int blk[4];
  int row[4];
  int cnt[4];
  int col[2][4];
};

// Slot g of CTA blockIdx.x.  Block <= 64: KW == block and slot g holds
// block order[t * G + g] whole; block 128: KW == 64, G == 1, and the CTA
// holds half t % 2 of block order[t / 2].
__device__ __forceinline__ void setup_slots(Slots& sl, const Args& a, int h) {
  const int KW = a.kw;
  const int G = TM / KW;
  const int nsub = a.block / KW;
  const int t = blockIdx.x;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    const int j = nsub > 1 ? t / nsub : t * G + g;
    const int half = nsub > 1 ? t - j * nsub : 0;
    int blk = -1, row = -1, cnt = 0;
    if (j < a.nblk) {
      blk = a.order[(size_t)h * a.nblk + j];
      row = blk * a.block + half * KW;
      cnt = a.cnt[(size_t)h * a.nblk + blk];
    }
    sl.blk[g] = blk;
    sl.row[g] = row;
    sl.cnt[g] = cnt;
  }
}

__device__ __forceinline__ int rounds_of(const Slots& sl, const Args& a) {
  int r = 0;
  for (int g = 0; g < TM / a.kw; ++g) r = max(r, sl.cnt[g]);
  return r * (a.block / a.kw);
}

// Round it meets entry it / nsub of each slot's list, sub-tile it % nsub.
// kv_side: the slot's own rows are keys and the listed rows queries (dK/dV).
// Causal: a sub-tile whose every pair is masked is skipped.
__device__ __forceinline__ void set_cols(Slots& sl, const Args& a, int h,
                                         int it, bool kv_side) {
  const int KW = a.kw;
  const int nsub = a.block / KW;
  if (threadIdx.x < TM / KW) {
    const int g = threadIdx.x;
    const int s = it / nsub;
    const int sub = it - s * nsub;
    int col = -1;
    if (sl.blk[g] >= 0 && s < sl.cnt[g]) {
      const int other =
          a.idx[((size_t)h * a.nblk + sl.blk[g]) * a.max_list + s];
      col = other * a.block + sub * KW;
      if (a.causal) {
        const int r0 = sl.row[g];
        if (kv_side ? col + KW - 1 < r0 : col > r0 + KW - 1) col = -1;
      }
    }
    sl.col[it & 1][g] = col;
  }
}

// Stage the KW-row slots of one head of a [B, S, *, HD] view into a dense
// [TM][HD] shared tile: slot g's rows from global row rows[g] on (left
// alone when rows[g] < 0).  VEC elements per 16 bytes.
template <typename T, int HD>
__device__ __forceinline__ void load_slots(T* dst, const T* src, long long ss,
                                           const int* rows, int KW) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < TM * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * VEC;
    const int g = r / KW;
    const int r0 = rows[g];
    if (r0 < 0) continue;
    *reinterpret_cast<uint4*>(dst + r * HD + c) =
        *reinterpret_cast<const uint4*>(src + (r0 + r - g * KW) * ss + c);
  }
}

// As load_slots, fp32 into [TM][HD + 1] (rows padded against bank
// conflicts of the row-per-thread loops).
template <int HD>
__device__ __forceinline__ void load_slots_pad(float* dst, const float* src,
                                               long long ss, const int* rows,
                                               int KW) {
  constexpr int PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < TM * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * 4;
    const int g = r / KW;
    const int r0 = rows[g];
    if (r0 < 0) continue;
    const float4 val =
        *reinterpret_cast<const float4*>(src + (r0 + r - g * KW) * ss + c);
    float* d = dst + r * (HD + 1) + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// lse and dsum of the query rows staged for this round (dK/dV).
__device__ __forceinline__ void load_row_vals(float* lseS, float* dsS,
                                              const Args& a, int b, int h,
                                              const int* cols) {
  for (int i = threadIdx.x; i < TM; i += kThreads) {
    const int g = i / a.kw;
    const int c0 = cols[g];
    if (c0 < 0) continue;
    const size_t row = ((size_t)b * a.H + h) * a.S + c0 + i - g * a.kw;
    lseS[i] = a.lse[row];
    dsS[i] = a.dsum[row];
  }
}

// ------------------------------------------------------------------ fp32
// Two threads per row (each owning half the head dim); a warp's 16 rows
// lie in one slot, since KW >= 16.
template <int HD>
__global__ void __launch_bounds__(kThreads) fwd_f32(Args a) {
  constexpr int HH = HD / 2;
  const int KW = a.kw;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [TM][HD]
  float* Vs = Ks + TM * HD;                        // [TM][HD]
  float* Ss = Vs + TM * HD;                        // [TM][TM + 1]
  __shared__ Slots sl;

  setup_slots(sl, a, h);
  __syncthreads();
  const int rounds = rounds_of(sl, a);
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int g = r / KW;
  const bool own = sl.blk[g] >= 0;
  const int s_q = sl.row[g] + r - g * KW;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  float qreg[HH], acc[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) {
    qreg[d] = own ? qb[s_q * a.q_ss + half * HH + d] : 0.f;
    acc[d] = 0.f;
  }
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int it = 0; it < rounds; ++it) {
    set_cols(sl, a, h, it, false);
    __syncthreads();
    load_slots<float, HD>(Ks, kb, a.k_ss, sl.col[it & 1], KW);
    load_slots<float, HD>(Vs, vb, a.v_ss, sl.col[it & 1], KW);
    __syncthreads();
    const int col0 = sl.col[it & 1][g];
    if (col0 < 0) continue;

    float* srow = Ss + r * (TM + 1);
    float mx = -INFINITY;
    for (int c = 0; c < KW; ++c) {
      const float* kr = Ks + (g * KW + c) * HD + half * HH;
      float p = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) p += qreg[d] * kr[d];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      const float x = (!a.causal || col0 + c <= s_q) ? p * a.sm_scale
                                                      : -INFINITY;
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
    for (int c = 0; c < KW; ++c) {
      const float p = any ? expf(srow[c] - m_new) : 0.f;
      psum += p;
      const float* vr = Vs + (g * KW + c) * HD + half * HH;
#pragma unroll
      for (int d = 0; d < HH; ++d) acc[d] += p * vr[d];
    }
    l_i = l_i * alpha + psum;
    m_i = m_new;
  }

  if (own) {
    float* orow = static_cast<float*>(a.out0) +
                  (((size_t)b * a.S + s_q) * a.H + h) * HD + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) orow[d] = l_i > 0.f ? acc[d] / l_i : 0.f;
    if (half == 0 && a.lse_out != nullptr)
      a.lse_out[((size_t)b * a.H + h) * a.S + s_q] =
          l_i > 0.f ? m_i + logf(l_i) : INFINITY;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dq_f32(Args a) {
  constexpr int HH = HD / 2;
  constexpr int LD = HD + 1;
  const int KW = a.kw;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [TM][LD]
  float* Os = Qs + TM * LD;                        // dO [TM][LD]
  float* Ks = Os + TM * LD;                        // [TM][LD]
  float* Vs = Ks + TM * LD;                        // [TM][LD]
  __shared__ Slots sl;

  setup_slots(sl, a, h);
  __syncthreads();
  const int rounds = rounds_of(sl, a);
  load_slots_pad<HD>(
      Qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
      sl.row, KW);
  load_slots_pad<HD>(
      Os, static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh,
      a.o_ss, sl.row, KW);
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int g = r / KW;
  const bool own = sl.blk[g] >= 0;
  const int s_q = sl.row[g] + r - g * KW;
  float lse_q = 0.f, dsum_q = 0.f;
  if (own) {
    const size_t row = ((size_t)b * a.H + h) * a.S + s_q;
    lse_q = a.lse[row];
    dsum_q = a.dsum[row];
  }
  float dq[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) dq[d] = 0.f;
  const float* qr = Qs + r * LD + half * HH;
  const float* orow = Os + r * LD + half * HH;

  for (int it = 0; it < rounds; ++it) {
    set_cols(sl, a, h, it, false);
    __syncthreads();
    load_slots_pad<HD>(Ks, kb, a.k_ss, sl.col[it & 1], KW);
    load_slots_pad<HD>(Vs, vb, a.v_ss, sl.col[it & 1], KW);
    __syncthreads();
    const int col0 = sl.col[it & 1][g];
    if (col0 < 0) continue;
    for (int c = 0; c < KW; ++c) {
      const float* kr = Ks + (g * KW + c) * LD + half * HH;
      const float* vr = Vs + (g * KW + c) * LD + half * HH;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) {
        s += qr[d] * kr[d];
        dp += orow[d] * vr[d];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = (!a.causal || col0 + c <= s_q)
                          ? expf(s * a.sm_scale - lse_q) : 0.f;
      const float ds = p * (dp - dsum_q);
#pragma unroll
      for (int d = 0; d < HH; ++d) dq[d] += ds * kr[d];
    }
  }

  if (own) {
    float* dqr = static_cast<float*>(a.out0) +
                 (((size_t)b * a.S + s_q) * a.H + h) * HD + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) dqr[d] = dq[d] * a.sm_scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_f32(Args a) {
  constexpr int HH = HD / 2;
  constexpr int LD = HD + 1;
  const int KW = a.kw;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [TM][LD] own
  float* Vs = Ks + TM * LD;                        // [TM][LD] own
  float* Qs = Vs + TM * LD;                        // [TM][LD] round
  float* Os = Qs + TM * LD;                        // dO [TM][LD] round
  float* lseS = Os + TM * LD;                      // [TM]
  float* dsS = lseS + TM;                          // [TM]
  __shared__ Slots sl;

  setup_slots(sl, a, h);
  __syncthreads();
  const int rounds = rounds_of(sl, a);
  load_slots_pad<HD>(
      Ks, static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh, a.k_ss,
      sl.row, KW);
  load_slots_pad<HD>(
      Vs, static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh, a.v_ss,
      sl.row, KW);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* ob =
      static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;

  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int g = r / KW;
  const bool own = sl.blk[g] >= 0;
  const int s_k = sl.row[g] + r - g * KW;
  float dk[HH], dv[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) {
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const float* kr = Ks + r * LD + half * HH;
  const float* vr = Vs + r * LD + half * HH;

  for (int it = 0; it < rounds; ++it) {
    set_cols(sl, a, h, it, true);
    __syncthreads();
    load_slots_pad<HD>(Qs, qb, a.q_ss, sl.col[it & 1], KW);
    load_slots_pad<HD>(Os, ob, a.o_ss, sl.col[it & 1], KW);
    load_row_vals(lseS, dsS, a, b, h, sl.col[it & 1]);
    __syncthreads();
    const int col0 = sl.col[it & 1][g];
    if (col0 < 0) continue;
    for (int c = 0; c < KW; ++c) {
      const int qc = g * KW + c;
      const float* qr = Qs + qc * LD + half * HH;
      const float* orow = Os + qc * LD + half * HH;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) {
        s += kr[d] * qr[d];
        dp += vr[d] * orow[d];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = (!a.causal || col0 + c >= s_k)
                          ? expf(s * a.sm_scale - lseS[qc]) : 0.f;
      const float ds = p * (dp - dsS[qc]);
#pragma unroll
      for (int d = 0; d < HH; ++d) {
        dv[d] += p * orow[d];
        dk[d] += ds * qr[d];
      }
    }
  }

  if (own) {
    const size_t base =
        (((size_t)b * a.S + s_k) * a.H + h) * HD + half * HH;
    float* dkr = static_cast<float*>(a.out0) + base;
    float* dvr = static_cast<float*>(a.out1) + base;
#pragma unroll
    for (int d = 0; d < HH; ++d) {
      dkr[d] = dk[d] * a.sm_scale;
      dvr[d] = dv[d];
    }
  }
}

// ------------------------------------------------- bf16 dQ and dK/dV (Hopper)
// The persistent wgmma / TMA backward over a host-built tile plan
// (ops/kernels/block_sparse_attention.py TilePlan).  A CTA of three
// warpgroups per SM: warpgroup 0 gives up its registers and its warps 0
// and 1 load by TMA, each for one consumer warpgroup; warpgroups 1 and 2
// each walk their own work items with their own shared-memory region and
// ring.  A work item is one segment of one own tile: up to 64 own rows
// (g own sub-blocks of kw = min(block, 64) rows, resident for the item)
// against the item's streamed tiles (each g gathered sub-blocks of the
// own tile's list, 64 rows, one TMA box a sub-block; an empty slot loads a
// box wholly past S, which lands as zeros).
namespace hbsa {

constexpr int kTile = 64;          // rows of an own tile and of a streamed one
constexpr int kCtaThreads = 384;   // producer warpgroup + two consumer ones
constexpr float kLog2e = 1.4426950408889634f;

// Which kernel a piece of the Hopper code serves.
enum Side { kFwdSide = 0, kDqSide = 1, kDkvSide = 2 };

// One consumer warpgroup's shared memory, in bytes from a 1024-aligned
// base: the resident tiles [chunk][kTile][CH] (the backward's pair; the
// forward's q alone), the streamed pair [stage][chunk][kTile][CH] each
// (swizzled rows of CH columns), per stage the streamed rows' lse in log2
// units and dsum (the backward's; read by dK/dV) and the tile's live word,
// the merge's last-arrival flag, then the barriers.  Head dims that are a
// multiple of 64 stage in 64-column chunks (128-byte swizzle), 80 and 96
// in 32-column chunks (64-byte swizzle), as csrc/ds_flash_bwd.cu.  The
// forward's second resident tile buys its ring a stage.
template <int HD, int SIDE = kDqSide>
struct Smem {
  static constexpr bool FWD = SIDE == kFwdSide;
  static constexpr int CH = HD % 64 == 0 ? 64 : 32;
  static constexpr int ROW = CH * 2;         // bytes: the swizzle span
  static constexpr int SBO = 8 * ROW;        // 8-row group stride
  static constexpr int NCH = (HD + CH - 1) / CH;
  static constexpr int STAGES = (HD == 128 ? 2 : 3) + (FWD ? 1 : 0);
  static constexpr int CHUNK = kTile * ROW;
  static constexpr int TILE = NCH * CHUNK;   // one 64-row tile of a tensor
  static constexpr int RES0 = 0;             // k, or q
  static constexpr int RES1 = TILE;          // v, or dO (not the forward)
  static constexpr int STR0 = (FWD ? 1 : 2) * TILE;    // q, or k [stage]
  static constexpr int STR1 = STR0 + STAGES * TILE;    // dO, or v
  static constexpr int ROWS = FWD ? 0 : STAGES * kTile * 4;
  static constexpr int LSE = STR1 + STAGES * TILE;     // f32 [stage][kTile]
  static constexpr int DSUM = LSE + ROWS;
  static constexpr int WORD = DSUM + ROWS;                 // u32 [stage]
  static constexpr int FLAG = WORD + STAGES * 4;           // int
  static constexpr int BAR = (FLAG + 4 + 7) / 8 * 8;       // uint64
  static constexpr int N_BARS = 2 + 3 * STAGES;
  static constexpr int REGION = (BAR + N_BARS * 8 + 1023) / 1024 * 1024;
  static constexpr int ALLOC = 2 * REGION + 1024;   // + base alignment
  static_assert(ALLOC <= 232448, "hbsa::Smem: over an H100 CTA's 227 KB");
};

struct Params {
  const float* lse;    // dQ, dK/dV: the forward's
  const float* dsum;   // dQ, dK/dV
  const int* items;    // [n_items][8]: see Item
  const int* own;      // [U][4]: own sub-blocks, -1 empty
  const int* tiles;    // [T][8]: streamed sub-blocks (-1 empty), live word
  float* ws;           // fp32 partials [B][n_partials]: see merge_split
  int* counters;       // [B][n_split] arrivals, 0 between launches
  bf16* out0;          // o, dQ or dK
  bf16* out1;          // dV (dK/dV only)
  int S, H, B, kw, g;
  int n_items, n_live;   // items, those with streamed tiles (the first)
  int n_split, n_partials;
  float scale_log2;    // sm_scale * log2(e)
  float sm_scale;
  float* lse_out;      // the forward's lse, or null (last: the backward's
                       // fields keep their places)
};

// A work item: own tile, head, first streamed tile and count, split unit
// (-1: none), segment, segments, first partial tile of the split unit.
struct Item {
  int own, head, first, count, split, seg, nseg, ws_base;
};

// Work item n of consumer c of C among `count` items (longest first),
// each repeated for every batch row: round robin, every other round
// mirrored; -> the item's index among them and its batch row, or -1 when
// none is left.
__device__ __forceinline__ int work_of(const Params& p, int n, int c, int C,
                                       int count, int& b) {
  const int wi = n * C + ((n & 1) ? C - 1 - c : c);
  if (wi >= count * p.B) return -1;
  const int i = wi / p.B;
  b = wi - i * p.B;
  return i;
}

__device__ __forceinline__ Item item_at(const Params& p, int i) {
  const int4 x = *reinterpret_cast<const int4*>(p.items + 8 * i);
  const int4 y = *reinterpret_cast<const int4*>(p.items + 8 * i + 4);
  return {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
}

__device__ __forceinline__ int slot_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

struct Bars {
  uint64_t* res_full;    // one arrival + bytes
  uint64_t* res_empty;   // one arrival per consumer warp
  uint64_t* s0_full;     // [STAGES]; 32 arrivals (the producer warp) + bytes
  uint64_t* s1_full;     // [STAGES]; one arrival + bytes
  uint64_t* empty;       // [STAGES]; one arrival per consumer warp
};

template <int HD, int SIDE = kDqSide>
__device__ __forceinline__ Bars bars_of(unsigned char* rg) {
  using L = Smem<HD, SIDE>;
  uint64_t* b = reinterpret_cast<uint64_t*>(rg + L::BAR);
  return Bars{b, b + 1, b + 2, b + 2 + L::STAGES, b + 2 + 2 * L::STAGES};
}

// One gathered 64-row tile of one tensor: slot j's sub-block (row
// blk * kw) of head `head`, batch b, by one box per chunk, slot j at row
// j * kw of each chunk; an empty slot's box starts at row S, wholly past
// the extent, and lands as zeros (its bytes count all the same).
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, const int4& blk,
                                          const Params& p, int head, int b) {
  using L = Smem<HD>;
  for (int j = 0; j < p.g; ++j) {
    const int sb = slot_of(blk, j);
    const int r = sb >= 0 ? sb * p.kw : p.S;
#pragma unroll
    for (int c = 0; c < L::NCH; ++c)
      hopper::tma_load_4d(dst + c * L::CHUNK + j * p.kw * L::ROW, map, bar,
                          c * L::CH, r, head, b);
  }
}

// The producer warp of consumer c: per item with streamed tiles, the own
// tiles once (after the consumer has read the previous item's: the pair,
// or the forward's q alone), then the streamed tiles through the ring,
// whose position runs on across items.  For dK/dV the lanes stage each
// streamed tile's lse (log2 units; +inf in an empty slot) and dsum; lane
// 0 its live word.  Each lane's arrival on the stage's s0_full barrier
// releases these stores to the consumer.
template <int HD, int SIDE>
__device__ __forceinline__ void produce(const CUtensorMap* tr0,
                                        const CUtensorMap* tr1,
                                        const CUtensorMap* ts0,
                                        const CUtensorMap* ts1,
                                        const Params& p, unsigned char* rg,
                                        const Bars& bar, int c, int C) {
  constexpr bool DKV = SIDE == kDkvSide, FWD = SIDE == kFwdSide;
  using L = Smem<HD, SIDE>;
  const int lane = threadIdx.x & 31;
  int it = 0;   // ring position
  for (int n = 0;; ++n) {
    int b = 0;
    const int i = work_of(p, n, c, C, p.n_live, b);
    if (i < 0) break;
    const Item w = item_at(p, i);
    const int4 own = *reinterpret_cast<const int4*>(p.own + 4 * w.own);
    hopper::mbar_wait(bar.res_empty, (n & 1) ^ 1);
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(bar.res_full, (FWD ? 1 : 2) * L::TILE);
      load_tile<HD>(rg + L::RES0, tr0, bar.res_full, own, p, w.head, b);
      if (!FWD)
        load_tile<HD>(rg + L::RES1, tr1, bar.res_full, own, p, w.head, b);
    }
    // the streamed tiles 32 at a time: lane i holds tile i's sub-blocks
    // and live word, read once for the 32 (no load latency per tile); for
    // dK/dV each lane's two rows' lse and dsum are read one tile ahead
    for (int t0 = 0; t0 < w.count; t0 += 32) {
      const int nt = min(32, w.count - t0);
      int4 mine = make_int4(-1, -1, -1, -1);
      int word_mine = 0;
      if (lane < nt) {
        const int* tile = p.tiles + 8 * (w.first + t0 + lane);
        mine = *reinterpret_cast<const int4*>(tile);
        word_mine = tile[4];
      }
      float lv[2], dv[2];
      auto tile_of = [&](int t) {
        return make_int4(__shfl_sync(0xffffffffu, mine.x, t),
                         __shfl_sync(0xffffffffu, mine.y, t),
                         __shfl_sync(0xffffffffu, mine.z, t),
                         __shfl_sync(0xffffffffu, mine.w, t));
      };
      auto fetch = [&](const int4& blk) {   // rows lane and lane + 32
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = lane + 32 * e;
          const int j = r >> (__ffs(p.kw) - 1);
          const int sb = slot_of(blk, j);
          lv[e] = INFINITY;
          dv[e] = 0.f;
          if (sb >= 0) {
            const size_t row = ((size_t)b * p.H + w.head) * p.S +
                               sb * p.kw + (r - j * p.kw);
            lv[e] = p.lse[row] * kLog2e;
            dv[e] = p.dsum[row];
          }
        }
      };
      int4 blk = tile_of(0);
      if (DKV) fetch(blk);
      for (int t = 0; t < nt; ++t, ++it) {
        const int s = it % L::STAGES;
        const uint32_t parity = ((it / L::STAGES) & 1) ^ 1;
        const int word = __shfl_sync(0xffffffffu, word_mine, t);
        hopper::mbar_wait(bar.empty + s, parity);
        if (DKV) {
          float* l2 = reinterpret_cast<float*>(rg + L::LSE) + s * kTile;
          float* ds = reinterpret_cast<float*>(rg + L::DSUM) + s * kTile;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            l2[lane + 32 * e] = lv[e];
            ds[lane + 32 * e] = dv[e];
          }
        }
        if (lane == 0) {
          reinterpret_cast<int*>(rg + L::WORD)[s] = word;
          hopper::mbar_arrive_expect_tx(bar.s0_full + s, L::TILE);
          load_tile<HD>(rg + L::STR0 + s * L::TILE, ts0, bar.s0_full + s,
                        blk, p, w.head, b);
          hopper::mbar_arrive_expect_tx(bar.s1_full + s, L::TILE);
          load_tile<HD>(rg + L::STR1 + s * L::TILE, ts1, bar.s1_full + s,
                        blk, p, w.head, b);
        } else {
          hopper::mbar_arrive(bar.s0_full + s);
        }
        if (t + 1 < nt) {
          blk = tile_of(t + 1);
          if (DKV) fetch(blk);
        }
      }
    }
  }
}

// the shared products (csrc/hopper.cuh) on this file's staging: own and
// streamed tiles alike hold kTile rows a chunk
template <int HD>
__device__ __forceinline__ void issue_ss(float (&d)[kTile / 2], uint64_t da,
                                         const unsigned char* b_tile) {
  using L = Smem<HD>;
  hopper::issue_ss<HD, L::CH, L::CHUNK, L::CHUNK>(d, da, b_tile);
}

template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&a)[kTile / 16][4],
                                         const unsigned char* b_tile) {
  using L = Smem<HD>;
  hopper::issue_rs<HD, L::CH, L::CHUNK>(acc, a, b_tile);
}

// P (sc) and dS / sm_scale (dp) of every pair the plan does not list set
// to 0, and inside a diagonal pair the causally masked ones (dQ: keys
// after the query, KEY_ROWS dK/dV: queries before the key), by selects, so
// nothing from a masked pair (a zero-filled slot, a neighbour's block)
// reaches a product.  The thread's fragment rows (row in its sub-block
// rin and rin + 8) lie in own slot os; column group j (8 columns) in
// streamed slot 8 j / kw.  `word`: the streamed tile's live word.
template <bool KEY_ROWS>
__device__ __forceinline__ void apply_mask(float (&sc)[kTile / 2],
                                           float (&dp)[kTile / 2],
                                           uint32_t word, int kw, int g,
                                           int os, int rin, int cq) {
  const uint32_t all = (1u << g) - 1;
  const uint32_t live = (word >> (os * g)) & all;
  const uint32_t diag = (word >> (16 + os * g)) & all;
  if (live == all && diag == 0) return;   // the warp's rows: all live
  const int sh = __ffs(kw) - 1;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int slot = (8 * j) >> sh;
    const bool lv = (live >> slot) & 1;
    const bool dg = (diag >> slot) & 1;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cin = (8 * j + cq + e) & (kw - 1);
      const bool m0 = KEY_ROWS ? cin < rin : cin > rin;
      const bool m1 = KEY_ROWS ? cin < rin + 8 : cin > rin + 8;
      if (!lv || (dg && m0)) sc[4 * j + e] = dp[4 * j + e] = 0.f;
      if (!lv || (dg && m1)) sc[4 * j + 2 + e] = dp[4 * j + 2 + e] = 0.f;
    }
  }
}

// dK/dV's elementwise step on one streamed query tile, transposed: sc
// holds s^T (rows: the own keys; columns: the tile's queries) and becomes
// P^T = 2^(s c - lse2[query]); dp holds dP^T and becomes dS^T / sm_scale
// = P^T (dP^T - dsum[query]); then the mask.
template <int HD>
__device__ __forceinline__ void grad_dkv(float (&sc)[kTile / 2],
                                         float (&dp)[kTile / 2],
                                         const Params& p,
                                         const unsigned char* rg, int s,
                                         int os, int rin, int cq) {
  using L = Smem<HD>;
  const float c = p.scale_log2;
  const float* l2 =
      reinterpret_cast<const float*>(rg + L::LSE) + s * kTile + cq;
  const float* dl =
      reinterpret_cast<const float*>(rg + L::DSUM) + s * kTile + cq;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j);
    const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j);
    sc[4 * j] = hopper::ex2(fmaf(sc[4 * j], c, -l.x));
    sc[4 * j + 1] = hopper::ex2(fmaf(sc[4 * j + 1], c, -l.y));
    sc[4 * j + 2] = hopper::ex2(fmaf(sc[4 * j + 2], c, -l.x));
    sc[4 * j + 3] = hopper::ex2(fmaf(sc[4 * j + 3], c, -l.y));
    dp[4 * j] = sc[4 * j] * (dp[4 * j] - d.x);
    dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - d.y);
    dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - d.x);
    dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - d.y);
  }
  apply_mask<true>(sc, dp, reinterpret_cast<const uint32_t*>(rg + L::WORD)[s],
                   p.kw, p.g, os, rin, cq);
}

// dQ's elementwise step on one streamed key tile: sc holds s (rows: the own
// queries, lse2 / dsum in registers; columns: the tile's keys) and becomes
// P; dp becomes dS / sm_scale; then the mask.
template <int HD>
__device__ __forceinline__ void grad_dq(float (&sc)[kTile / 2],
                                        float (&dp)[kTile / 2],
                                        const Params& p,
                                        const unsigned char* rg, int s,
                                        const float (&l2)[2],
                                        const float (&dl)[2], int os,
                                        int rin, int cq) {
  using L = Smem<HD>;
  const float c = p.scale_log2;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = hopper::ex2(fmaf(sc[4 * j + e], c, -l2[0]));
      sc[4 * j + 2 + e] = hopper::ex2(fmaf(sc[4 * j + 2 + e], c, -l2[1]));
      dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dl[0]);
      dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl[1]);
    }
  }
  apply_mask<false>(sc, dp,
                    reinterpret_cast<const uint32_t*>(rg + L::WORD)[s], p.kw,
                    p.g, os, rin, cq);
}

// Once this warpgroup's segment of a split unit has written its partial:
// one acquire-release add on the unit's counter after the warpgroup's
// barrier (as csrc/decode_attention.cu), the result shared through `flag`
// in shared memory -> whether it is the unit's last segment to arrive
// (which then combines the partials and returns the counter to 0).
__device__ __forceinline__ bool last_to_arrive(int* counter, int* flag,
                                               int nseg, int wg) {
  hopper::named_bar_sync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0)
    *flag = hopper::atom_add_acq_rel(counter, 1) == nseg - 1;
  hopper::named_bar_sync(1 + wg, 128);
  return *flag;
}

// A segment of a split unit writes its fp32 partials (NA accumulators) to
// the workspace, four floats a thread at a time ([k / 4][thread][4], so a
// warp's stores and loads are contiguous); the last of the unit's segments
// to arrive reads them back into acc summed in segment order and returns
// the counter to 0.  It reads its own back too: summed from its registers
// in order, its running sum would need registers beside acc, and they
// spill.  -> whether this warpgroup stores the unit's rows.
template <int HD, int NA>
__device__ __forceinline__ bool merge_split(float (&acc)[NA][HD / 2],
                                            const Params& p,
                                            unsigned char* rg, const Item& w,
                                            int b, int wg) {
  using L = Smem<HD>;
  constexpr int NP = NA * (HD / 2) * 128;   // floats of one partial
  const int tid = threadIdx.x & 127;
  float* base = p.ws + ((size_t)b * p.n_partials + w.ws_base) * NP + 4 * tid;
  float* mine = base + (size_t)w.seg * NP;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < HD / 2; i += 4)
      *reinterpret_cast<float4*>(mine + (a * (HD / 2) + i) * 128) =
          make_float4(acc[a][i], acc[a][i + 1], acc[a][i + 2], acc[a][i + 3]);
  int* counter = p.counters + (size_t)b * p.n_split + w.split;
  if (!last_to_arrive(counter, reinterpret_cast<int*>(rg + L::FLAG), w.nseg,
                      wg))
    return false;
  // the elements in NC chunks, so a chunk's loads in flight and acc fit
  // the registers (dK/dV at head dim 128: 128 accumulators a thread)
  constexpr int NE = NA * (HD / 2);
  constexpr int NC = NE > 96 ? 4 : 1;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    for (int s = 0; s < w.nseg; ++s) {
      const float* part = base + (size_t)s * NP;
#pragma unroll
      for (int k = c * (NE / NC); k < (c + 1) * (NE / NC); k += 4) {
        const int a = k / (HD / 2), i = k % (HD / 2);
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(part + k * 128));
        acc[a][i] = s == 0 ? x.x : acc[a][i] + x.x;
        acc[a][i + 1] = s == 0 ? x.y : acc[a][i + 1] + x.y;
        acc[a][i + 2] = s == 0 ? x.z : acc[a][i + 2] + x.z;
        acc[a][i + 3] = s == 0 ? x.w : acc[a][i + 3] + x.w;
      }
    }
  }
  if (tid == 0) *counter = 0;
  return true;
}

// The consumer's place in its 64 own rows: warp w's 16 rows lie in own
// slot os = 16 w / kw; its fragment rows are rin and rin + 8 of that
// sub-block.
struct Place {
  int os, rin, cq, lane;
};

__device__ __forceinline__ Place place_of(const Params& p) {
  const int tid = threadIdx.x & 127;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);   // warp-uniform
  const int lane = tid & 31;
  return {(16 * warp) / p.kw, (16 * warp) % p.kw + (lane >> 2),
          (lane & 3) * 2, lane};
}

// The software-pipelined walk of one item's streamed tiles, ring positions
// it .. it + count - 1: tile i's score products (SS) are issued before
// tile i - 1's accumulating ones (RS), so tile i's elementwise step runs
// on the CUDA cores while those hold the tensor cores.  NA accumulators
// (dQ: dq; dK/dV: dk, dv), fed by the packed A operands of ga (dS) and pa
// (P, dK/dV only).  The resident pair is released after the last tile's
// score products, each stage after its accumulating products.
template <int HD, bool DKV>
__device__ __forceinline__ void walk(float (&acc)[DKV ? 2 : 1][HD / 2],
                                     const Params& p, unsigned char* rg,
                                     const Bars& bar, int count, int it,
                                     uint64_t da0, uint64_t da1,
                                     const Place& pl, const float (&l2)[2],
                                     const float (&dl)[2]) {
  using L = Smem<HD>;
  float sc[kTile / 2], dp[kTile / 2];
  uint32_t pa[kTile / 16][4], ga[kTile / 16][4];
  auto grad = [&](int s) {
    if constexpr (DKV)
      grad_dkv<HD>(sc, dp, p, rg, s, pl.os, pl.rin, pl.cq);
    else
      grad_dq<HD>(sc, dp, p, rg, s, l2, dl, pl.os, pl.rin, pl.cq);
  };
  auto scores = [&](int s, uint32_t ph) {
    hopper::mbar_wait(bar.s0_full + s, ph);
    hopper::wgmma_fence();
    issue_ss<HD>(sc, da0, rg + L::STR0 + s * L::TILE);
    hopper::mbar_wait(bar.s1_full + s, ph);
    issue_ss<HD>(dp, da1, rg + L::STR1 + s * L::TILE);
    hopper::wgmma_commit();
  };
  // dV += P^T dO (streamed stage STR1) and dK += dS^T q (STR0); dQ += dS k
  auto accumulate = [&](int s) {
    if constexpr (DKV) {
      issue_rs<HD>(acc[1], pa, rg + L::STR1 + s * L::TILE);
      issue_rs<HD>(acc[0], ga, rg + L::STR0 + s * L::TILE);
    } else {
      issue_rs<HD>(acc[0], ga, rg + L::STR0 + s * L::TILE);
    }
    hopper::wgmma_commit();
  };
  auto pack = [&]() {
    if constexpr (DKV) hopper::pack_a(pa, sc);
    hopper::pack_a(ga, dp);
  };
  constexpr bool kPipelined = !DKV || HD <= 96;
  if constexpr (kPipelined) {
    {   // tile 0's scores
      const int s = it % L::STAGES;
      scores(s, (it / L::STAGES) & 1);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      if (count == 1 && pl.lane == 0) hopper::mbar_arrive(bar.res_empty);
      grad(s);
      pack();
    }
    for (int i = 1; i < count; ++i) {
      const int s = (it + i) % L::STAGES;
      const int sp = (it + i - 1) % L::STAGES;
      hopper::fence_regs(acc);
      scores(s, ((it + i) / L::STAGES) & 1);
      accumulate(sp);
      hopper::wgmma_wait<1>();   // tile i's scores have landed
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      if (i == count - 1 && pl.lane == 0) hopper::mbar_arrive(bar.res_empty);
      grad(s);
      hopper::wgmma_wait<0>();   // tile i - 1's products have landed
      hopper::fence_regs(acc);
      if constexpr (DKV) hopper::fence_regs(pa);   // its A registers are
      hopper::fence_regs(ga);                      // free only now
      if (pl.lane == 0) hopper::mbar_arrive(bar.empty + sp);
      pack();
    }
    {   // the last tile's products
      const int sp = (it + count - 1) % L::STAGES;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      accumulate(sp);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (pl.lane == 0) hopper::mbar_arrive(bar.empty + sp);
    }
  } else {
    // dK/dV at head dim 128: dK and dV alone take 128 floats a thread, so
    // each tile's products are waited for before the next tile's
    for (int i = 0; i < count; ++i) {
      const int s = (it + i) % L::STAGES;
      scores(s, ((it + i) / L::STAGES) & 1);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      if (i == count - 1 && pl.lane == 0) hopper::mbar_arrive(bar.res_empty);
      grad(s);
      pack();
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      accumulate(s);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::fence_regs(ga);
      if (pl.lane == 0) hopper::mbar_arrive(bar.empty + s);
    }
  }
}

// One consumer warpgroup's items: per item with streamed tiles, its own
// rows against them (every such item walks at least one, so no wgmma sits
// under a data-dependent branch), then the rows stored (sm_scale folded in
// here: dQ and dK times sm_scale, dV as it is), or a split unit's segment
// merged; then the own tiles with no list, as zeros.
template <int HD, bool DKV>
__device__ __forceinline__ void consume(const Params& p, unsigned char* rg,
                                        const Bars& bar, int c, int C,
                                        int wg) {
  using L = Smem<HD>;
  constexpr int NA = DKV ? 2 : 1;
  const Place pl = place_of(p);
  const uint32_t base = hopper::smem_u32(rg);
  const uint64_t da0 = hopper::smem_desc(base + L::RES0, 16, L::SBO, L::ROW);
  const uint64_t da1 = hopper::smem_desc(base + L::RES1, 16, L::SBO, L::ROW);
  int it = 0;   // ring position
  for (int n = 0;; ++n) {
    int b = 0;
    const int i = work_of(p, n, c, C, p.n_live, b);
    if (i < 0) break;
    int count, head, blk;
    {
      const Item w = item_at(p, i);
      count = w.count;
      head = w.head;
      blk = slot_of(*reinterpret_cast<const int4*>(p.own + 4 * w.own),
                    pl.os);
    }
    // dQ: the own query rows' lse (log2 units) and dsum
    float l2[2] = {INFINITY, INFINITY}, dl[2] = {0.f, 0.f};
    if (!DKV && blk >= 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const size_t row = ((size_t)b * p.H + head) * p.S + blk * p.kw +
                           pl.rin + 8 * e;
        l2[e] = p.lse[row] * kLog2e;
        dl[e] = p.dsum[row];
      }
    }
    float acc[NA][HD / 2];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int k = 0; k < HD / 2; ++k) acc[a][k] = 0.f;
    hopper::mbar_wait(bar.res_full, n & 1);
    walk<HD, DKV>(acc, p, rg, bar, count, it, da0, da1, pl, l2, dl);
    it += count;
    const Item w = item_at(p, i);
    if (w.split >= 0 && !merge_split<HD, NA>(acc, p, rg, w, b, wg)) continue;
    if (blk >= 0) {
      const int row0 = blk * p.kw + pl.rin;
      hopper::store_rows<HD>(p.out0, acc[0], p.sm_scale, b, p.S, p.H, head,
                             row0, pl.cq);
      if (DKV)
        hopper::store_rows<HD>(p.out1, acc[NA - 1], 1.f, b, p.S, p.H, head,
                               row0, pl.cq);
    }
  }
  float zero[HD / 2];
#pragma unroll
  for (int k = 0; k < HD / 2; ++k) zero[k] = 0.f;
  for (int n = 0;; ++n) {
    int b = 0;
    const int i = work_of(p, n, c, C, p.n_items - p.n_live, b);
    if (i < 0) break;
    const Item w = item_at(p, p.n_live + i);
    const int blk =
        slot_of(*reinterpret_cast<const int4*>(p.own + 4 * w.own), pl.os);
    if (blk >= 0) {
      const int row0 = blk * p.kw + pl.rin;
      hopper::store_rows<HD>(p.out0, zero, 1.f, b, p.S, p.H, w.head, row0,
                             pl.cq);
      if (DKV)
        hopper::store_rows<HD>(p.out1, zero, 1.f, b, p.S, p.H, w.head,
                               row0, pl.cq);
    }
  }
}

// ------------------------------------------------------- the bf16 forward
// One consumer thread's two rows (rin and rin + 8 of its sub-block): the
// running max in log2 units and the row sum (each lane of the row's quad
// sums its own 16 columns until the item ends).
struct Rows {
  float m0, m1, l0, l1;
};

constexpr float kLn2 = 0.6931471805599453f;

// The forward's mask on one streamed tile's raw scores: every pair the
// plan does not list, and inside a diagonal pair the keys after the
// query, -inf by selects, so that the row max never sees them (a
// zero-filled slot scores 0, not -inf).  The thread's place as in
// apply_mask.
__device__ __forceinline__ void mask_scores(float (&sc)[kTile / 2],
                                            uint32_t word, int kw, int g,
                                            const Place& pl) {
  const uint32_t all = (1u << g) - 1;
  const uint32_t live = (word >> (pl.os * g)) & all;
  const uint32_t diag = (word >> (16 + pl.os * g)) & all;
  if (live == all && diag == 0) return;   // the warp's rows: all live
  const int sh = __ffs(kw) - 1;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int slot = (8 * j) >> sh;
    const bool lv = (live >> slot) & 1;
    const bool dg = (diag >> slot) & 1;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cin = (8 * j + pl.cq + e) & (kw - 1);
      if (!lv || (dg && cin > pl.rin)) sc[4 * j + e] = -INFINITY;
      if (!lv || (dg && cin > pl.rin + 8)) sc[4 * j + 2 + e] = -INFINITY;
    }
  }
}

// One streamed tile's online softmax in place: the mask, the row max
// (quad shuffles) against the running one, sc becomes p = 2^(s c - m)
// with c = sm_scale * log2(e) folded into the exponent's FFMA (when c > 0;
// else the scores are scaled first), and the rows' sums grow; -> the
// factors by which each row's o must shrink.  A row that has seen no
// live key keeps base 0: its p and alpha are 0.
__device__ __forceinline__ void softmax_tile(float (&sc)[kTile / 2], Rows& r,
                                             float c, uint32_t word,
                                             const Params& p, const Place& pl,
                                             float& alpha0, float& alpha1) {
  if (c <= 0.f) {
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) sc[j] *= c;
    c = 1.f;
  }
  mask_scores(sc, word, p.kw, p.g, pl);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
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
  const float base0 = mx0 == -INFINITY ? 0.f : mx0;
  const float base1 = mx1 == -INFINITY ? 0.f : mx1;
  alpha0 = hopper::ex2(r.m0 - base0);
  alpha1 = hopper::ex2(r.m1 - base1);
  r.m0 = mx0;
  r.m1 = mx1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
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

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// The software-pipelined walk of one item's streamed tiles, ring positions
// it .. it + count - 1, as the flash forward's: tile i's q k^T (SS) is
// issued before tile i - 1's p v (RS), so tile i's softmax runs on the
// CUDA cores while p v holds the tensor cores; o is rescaled once p v has
// landed.  q is released after the last tile's scores, each stage after
// its p v.
template <int HD>
__device__ __forceinline__ void walk_fwd(float (&o)[HD / 2], Rows& r,
                                         const Params& p, unsigned char* rg,
                                         const Bars& bar, int count, int it,
                                         uint64_t da, const Place& pl) {
  using L = Smem<HD, kFwdSide>;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(rg + L::WORD);
  float sc[kTile / 2];
  uint32_t pa[kTile / 16][4];
  float alpha0, alpha1;
  auto scores = [&](int s, uint32_t ph) {
    hopper::mbar_wait(bar.s0_full + s, ph);
    hopper::wgmma_fence();
    issue_ss<HD>(sc, da, rg + L::STR0 + s * L::TILE);
    hopper::wgmma_commit();
  };
  auto values = [&](int s, uint32_t ph) {   // o += p v
    hopper::mbar_wait(bar.s1_full + s, ph);
    issue_rs<HD>(o, pa, rg + L::STR1 + s * L::TILE);
    hopper::wgmma_commit();
  };
  {   // tile 0's scores
    const int s = it % L::STAGES;
    scores(s, (it / L::STAGES) & 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    if (count == 1 && pl.lane == 0) hopper::mbar_arrive(bar.res_empty);
    softmax_tile(sc, r, p.scale_log2, words[s], p, pl, alpha0, alpha1);
    hopper::pack_a(pa, sc);
  }
  for (int i = 1; i < count; ++i) {
    const int s = (it + i) % L::STAGES;
    const int sp = (it + i - 1) % L::STAGES;
    hopper::fence_regs(o);
    scores(s, ((it + i) / L::STAGES) & 1);
    values(sp, ((it + i - 1) / L::STAGES) & 1);
    hopper::wgmma_wait<1>();   // tile i's scores have landed
    hopper::fence_regs(sc);
    if (i == count - 1 && pl.lane == 0) hopper::mbar_arrive(bar.res_empty);
    softmax_tile(sc, r, p.scale_log2, words[s], p, pl, alpha0, alpha1);
    hopper::wgmma_wait<0>();   // tile i - 1's p v has landed
    hopper::fence_regs(o);
    hopper::fence_regs(pa);    // its p registers are free only now
    if (pl.lane == 0) hopper::mbar_arrive(bar.empty + sp);
    rescale<HD>(o, alpha0, alpha1);
    hopper::pack_a(pa, sc);
  }
  {   // the last tile's p v
    const int sp = (it + count - 1) % L::STAGES;
    hopper::fence_regs(o);
    hopper::wgmma_fence();
    values(sp, ((it + count - 1) / L::STAGES) & 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (pl.lane == 0) hopper::mbar_arrive(bar.empty + sp);
  }
}

// A segment of a split unit writes its partial (unnormalised o, then the
// rows' max and sum as one float4 a thread: m0, m1, l0, l1) to the
// workspace, four floats a thread at a time ([k / 4][thread][4]); the last
// of the unit's segments to arrive combines them in segment order: M =
// the max of the segments' m, L = sum l 2^(m - M), o = sum o 2^(m - M),
// reading its own back too (no partial stays in registers beside o: they
// would spill), and returns the counter to 0.  -> whether this warpgroup
// stores the unit's rows (then o and r hold the combined ones).
template <int HD>
__device__ __forceinline__ bool merge_fwd(float (&o)[HD / 2], Rows& r,
                                          const Params& p, unsigned char* rg,
                                          const Item& w, int b, int wg) {
  using L = Smem<HD, kFwdSide>;
  constexpr int NO = HD / 2;                // o's floats a thread
  constexpr int NP = (NO + 4) * 128;        // floats of one partial
  const int tid = threadIdx.x & 127;
  float* base = p.ws + ((size_t)b * p.n_partials + w.ws_base) * NP + 4 * tid;
  float* mine = base + (size_t)w.seg * NP;
#pragma unroll
  for (int i = 0; i < NO; i += 4)
    *reinterpret_cast<float4*>(mine + i * 128) =
        make_float4(o[i], o[i + 1], o[i + 2], o[i + 3]);
  *reinterpret_cast<float4*>(mine + NO * 128) =
      make_float4(r.m0, r.m1, r.l0, r.l1);
  int* counter = p.counters + (size_t)b * p.n_split + w.split;
  if (!last_to_arrive(counter, reinterpret_cast<int*>(rg + L::FLAG), w.nseg,
                      wg))
    return false;
  auto rows_of = [&](int s) {
    return __ldcg(reinterpret_cast<const float4*>(base + (size_t)s * NP +
                                                  NO * 128));
  };
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int s = 0; s < w.nseg; ++s) {
    const float4 x = rows_of(s);
    m0 = fmaxf(m0, x.x);
    m1 = fmaxf(m1, x.y);
  }
  const float base0 = m0 == -INFINITY ? 0.f : m0;
  const float base1 = m1 == -INFINITY ? 0.f : m1;
  float l0 = 0.f, l1 = 0.f;
  for (int s = 0; s < w.nseg; ++s) {
    const float4 x = rows_of(s);
    const float w0 = hopper::ex2(x.x - base0);
    const float w1 = hopper::ex2(x.y - base1);
    l0 += x.z * w0;
    l1 += x.w * w1;
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      const float4 y =
          __ldcg(reinterpret_cast<const float4*>(base + (size_t)s * NP +
                                                 i * 128));
      o[i] = s == 0 ? y.x * w0 : fmaf(y.x, w0, o[i]);
      o[i + 1] = s == 0 ? y.y * w0 : fmaf(y.y, w0, o[i + 1]);
      o[i + 2] = s == 0 ? y.z * w1 : fmaf(y.z, w1, o[i + 2]);
      o[i + 3] = s == 0 ? y.w * w1 : fmaf(y.w, w1, o[i + 3]);
    }
  }
  r = Rows{m0, m1, l0, l1};
  if (tid == 0) *counter = 0;
  return true;
}

// One thread's two rows of o (row0 and row0 + 8, times 1 / l: 0 where l
// is 0) into the contiguous [B, S, H, HD] bf16 output and, when asked,
// their lse (natural log, +inf where l is 0) into [B, H, S] fp32 by the
// quad's first lane.
template <int HD>
__device__ __forceinline__ void store_fwd(const Params& p,
                                          const float (&o)[HD / 2],
                                          const Rows& r, int b, int head,
                                          int row0, const Place& pl) {
  const float inv0 = r.l0 > 0.f ? 1.f / r.l0 : 0.f;
  const float inv1 = r.l1 > 0.f ? 1.f / r.l1 : 0.f;
  bf16* o0 = p.out0 + (((size_t)b * p.S + row0) * p.H + head) * HD + pl.cq;
  bf16* o1 = o0 + (size_t)8 * p.H * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
        hopper::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
        hopper::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (p.lse_out != nullptr && (pl.lane & 3) == 0) {
    float* l = p.lse_out + ((size_t)b * p.H + head) * p.S + row0;
    l[0] = r.l0 > 0.f ? (r.m0 + log2f(r.l0)) * kLn2 : INFINITY;
    l[8] = r.l1 > 0.f ? (r.m1 + log2f(r.l1)) * kLn2 : INFINITY;
  }
}

// One consumer warpgroup's forward items: per item with streamed tiles,
// its own q rows against them (every such item walks at least one, so no
// wgmma sits under a data-dependent branch), the rows' sums across the
// quad, then the rows stored, or a split unit's segment merged; then the
// own tiles with no list: o = 0, lse = +inf.
template <int HD>
__device__ __forceinline__ void consume_fwd(const Params& p, unsigned char* rg,
                                            const Bars& bar, int c, int C,
                                            int wg) {
  using L = Smem<HD, kFwdSide>;
  const Place pl = place_of(p);
  const uint64_t da = hopper::smem_desc(hopper::smem_u32(rg) + L::RES0, 16,
                                        L::SBO, L::ROW);
  int it = 0;   // ring position
  for (int n = 0;; ++n) {
    int b = 0;
    const int i = work_of(p, n, c, C, p.n_live, b);
    if (i < 0) break;
    int count, head, blk;
    {
      const Item w = item_at(p, i);
      count = w.count;
      head = w.head;
      blk = slot_of(*reinterpret_cast<const int4*>(p.own + 4 * w.own),
                    pl.os);
    }
    float o[HD / 2];
#pragma unroll
    for (int k = 0; k < HD / 2; ++k) o[k] = 0.f;
    Rows r{-INFINITY, -INFINITY, 0.f, 0.f};
    hopper::mbar_wait(bar.res_full, n & 1);
    walk_fwd<HD>(o, r, p, rg, bar, count, it, da, pl);
    it += count;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
      r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
    }
    const Item w = item_at(p, i);
    if (w.split >= 0 && !merge_fwd<HD>(o, r, p, rg, w, b, wg)) continue;
    if (blk >= 0) store_fwd<HD>(p, o, r, b, head, blk * p.kw + pl.rin, pl);
  }
  float zero[HD / 2];
#pragma unroll
  for (int k = 0; k < HD / 2; ++k) zero[k] = 0.f;
  const Rows none{-INFINITY, -INFINITY, 0.f, 0.f};
  for (int n = 0;; ++n) {
    int b = 0;
    const int i = work_of(p, n, c, C, p.n_items - p.n_live, b);
    if (i < 0) break;
    const Item w = item_at(p, p.n_live + i);
    const int blk =
        slot_of(*reinterpret_cast<const int4*>(p.own + 4 * w.own), pl.os);
    if (blk >= 0)
      store_fwd<HD>(p, zero, none, b, w.head, blk * p.kw + pl.rin, pl);
  }
}

// ------------------------------------------------------------- the kernels
// A persistent grid, one CTA per SM: warpgroup 0 keeps 40 registers (its
// warps 0 and 1 load), the two consumer warpgroups 232 each.  Maps: r0 /
// r1 the own tiles (the forward: q, r1 unused), s0 / s1 the streamed pair.
template <int HD, int SIDE>
__device__ __forceinline__ void cta(const CUtensorMap* tm_r0,
                                    const CUtensorMap* tm_r1,
                                    const CUtensorMap* tm_s0,
                                    const CUtensorMap* tm_s1,
                                    const Params& p) {
  using L = Smem<HD, SIDE>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      const Bars bar = bars_of<HD, SIDE>(sm + w * L::REGION);
      hopper::mbar_init(bar.res_full, 1);
      hopper::mbar_init(bar.res_empty, 4);
      for (int s = 0; s < L::STAGES; ++s) {
        hopper::mbar_init(bar.s0_full + s, 32);
        hopper::mbar_init(bar.s1_full + s, 1);
        hopper::mbar_init(bar.empty + s, 4);
      }
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int C = 2 * gridDim.x;
  if (threadIdx.x < 128) {   // producer warpgroup; warps 0 and 1 load
    hopper::reg_dealloc<40>();
    const int w = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
    if (w < 2) {
      unsigned char* rg = sm + w * L::REGION;
      produce<HD, SIDE>(tm_r0, tm_r1, tm_s0, tm_s1, p, rg,
                        bars_of<HD, SIDE>(rg), 2 * blockIdx.x + w, C);
    }
  } else {
    hopper::reg_alloc<232>();
    // the warpgroup's index, warp-uniform to the compiler: control flow
    // that depends on a thread-divergent value around wgmma serialises it
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    unsigned char* rg = sm + wg * L::REGION;
    if constexpr (SIDE == kFwdSide)
      consume_fwd<HD>(p, rg, bars_of<HD, SIDE>(rg), 2 * blockIdx.x + wg, C,
                      wg);
    else
      consume<HD, SIDE == kDkvSide>(p, rg, bars_of<HD, SIDE>(rg),
                                    2 * blockIdx.x + wg, C, wg);
  }
}

// The forward: own q, streamed k / v.
template <int HD>
__global__ void __launch_bounds__(kCtaThreads, 1)
    bsa_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  cta<HD, kFwdSide>(&tm_q, &tm_q, &tm_k, &tm_v, p);
}

// DKV: the dK / dV kernel (own k / v, streamed q / dO), else dQ (own q /
// dO, streamed k / v).
template <int HD, bool DKV>
__global__ void __launch_bounds__(kCtaThreads, 1)
    bsa_bwd_bf16(const __grid_constant__ CUtensorMap tm_r0,
                 const __grid_constant__ CUtensorMap tm_r1,
                 const __grid_constant__ CUtensorMap tm_s0,
                 const __grid_constant__ CUtensorMap tm_s1, const Params p) {
  cta<HD, DKV ? kDkvSide : kDqSide>(&tm_r0, &tm_r1, &tm_s0, &tm_s1, p);
}

// q, k, v (and dO, not the forward): strided [B, S, H, HD] views
// (strides: batch, seq, head in elements, the tensors in that order);
// maps over them as they are, dims {hd, S, H, B}, boxes of {CH, kw} (one
// sub-block of one chunk).
template <int HD, int SIDE>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const long long* st, Params p,
                   cudaStream_t stream) {
  using L = Smem<HD, SIDE>;
  constexpr bool DKV = SIDE == kDkvSide;
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t dims[4] = {HD, (uint64_t)p.S, (uint64_t)p.H, (uint64_t)p.B};
  const long long qs[3] = {st[1], st[2], st[0]};
  const long long ks[3] = {st[4], st[5], st[3]};
  const long long vs[3] = {st[7], st[8], st[6]};
  const auto swz = L::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint32_t box = (uint32_t)p.kw;
  if (!hopper::make_map_bf16_4d(&tq, q, dims, qs, L::CH, box, swz) ||
      !hopper::make_map_bf16_4d(&tk, k, dims, ks, L::CH, box, swz) ||
      !hopper::make_map_bf16_4d(&tv, v, dims, vs, L::CH, box, swz))
    return cudaErrorInvalidValue;
  if (SIDE != kFwdSide) {
    const long long os[3] = {st[10], st[11], st[9]};
    if (!hopper::make_map_bf16_4d(&tdo, dout, dims, os, L::CH, box, swz))
      return cudaErrorInvalidValue;
  }
  const void* kernel;
  if constexpr (SIDE == kFwdSide)
    kernel = reinterpret_cast<const void*>(bsa_fwd_bf16<HD>);
  else
    kernel = reinterpret_cast<const void*>(bsa_bwd_bf16<HD, DKV>);
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t e = hopper::opt_in_smem(kernel, L::ALLOC, opted_in);
  if (e != cudaSuccess) return e;
  int n_sm = 0;
  e = hopper::sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  const int grid = min(n_sm, (p.n_items * p.B + 1) / 2);
  if constexpr (SIDE == kFwdSide)
    bsa_fwd_bf16<HD><<<grid, kCtaThreads, L::ALLOC, stream>>>(tq, tk, tv, p);
  else
    bsa_bwd_bf16<HD, DKV><<<grid, kCtaThreads, L::ALLOC, stream>>>(
        DKV ? tk : tq, DKV ? tv : tdo, DKV ? tq : tk, DKV ? tdo : tv, p);
  return cudaGetLastError();
}

template <int SIDE>
int run(const void* q, const void* k, const void* v, const void* dout,
        const long long* st, const Params& p, int head_dim, void* stream) {
  if (p.B < 1 || p.H < 1 || p.n_items < 1 || p.n_live > p.n_items ||
      (p.kw != 16 && p.kw != 32 && p.kw != 64) || p.S % p.kw != 0 ||
      (p.n_split > 0 && (p.ws == nullptr || p.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return (int)launch<64, SIDE>(q, k, v, dout, st, p, s);
    case 80: return (int)launch<80, SIDE>(q, k, v, dout, st, p, s);
    case 96: return (int)launch<96, SIDE>(q, k, v, dout, st, p, s);
    case 128: return (int)launch<128, SIDE>(q, k, v, dout, st, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params params(const void* lse, const void* dsum, const void* items,
              const void* own, const void* tiles, void* ws, void* counters,
              int B, int S, int H, int kw, int n_items, int n_live,
              int n_split, int n_partials, float sm_scale) {
  Params p{};
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.items = static_cast<const int*>(items);
  p.own = static_cast<const int*>(own);
  p.tiles = static_cast<const int*>(tiles);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.S = S;
  p.H = H;
  p.B = B;
  p.kw = kw;
  p.g = kw > 0 ? kTile / kw : 0;
  p.n_items = n_items;
  p.n_live = n_live;
  p.n_split = n_split;
  p.n_partials = n_partials;
  p.scale_log2 = sm_scale * kLog2e;
  p.sm_scale = sm_scale;
  return p;
}

}  // namespace hbsa

// ---------------------------------------------------------------- launch
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename K>
cudaError_t launch_with(K kernel, dim3 grid, size_t smem,
                        cudaStream_t stream, const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the fp32 kernels (the bf16 ones are bsa_fwd_h, bsa_dq_h and bsa_dkv_h)
template <int HD>
cudaError_t launch(Kind kind, const Args& a, int B, cudaStream_t st) {
  const int G = TM / a.kw;
  const int nsub = a.block / a.kw;
  const int tiles = nsub > 1 ? a.nblk * nsub : (a.nblk + G - 1) / G;
  const dim3 grid(tiles, B * a.H);
  const size_t pad = (size_t)TM * (HD + 1) * sizeof(float);
  switch (kind) {
    case kFwd:
      return launch_with(fwd_f32<HD>, grid,
                         (size_t)2 * TM * HD * sizeof(float) +
                             (size_t)TM * (TM + 1) * sizeof(float),
                         st, a);
    case kDq:
      return launch_with(dq_f32<HD>, grid, 4 * pad, st, a);
    default:
      return launch_with(dkv_f32<HD>, grid, 4 * pad + 2 * TM * sizeof(float),
                         st, a);
  }
}

// strides: (batch, seq, head) element strides of q, k, v and (dQ, dK/dV)
// dO in turn.
int run(Kind kind, Args a, int B, int S, int H, int head_dim, int block,
        int max_list, const long long* st, int causal, float sm_scale,
        void* stream) {
  if (B < 1 || H < 1 || max_list < 1 || S < block ||
      (block != 16 && block != 32 && block != 64 && block != 128) ||
      S % block != 0)
    return (int)cudaErrorInvalidValue;
  a.S = S;
  a.H = H;
  a.nblk = S / block;
  a.block = block;
  a.max_list = max_list;
  a.kw = block < TM ? block : TM;
  a.q_sb = st[0], a.q_ss = st[1], a.q_sh = st[2];
  a.k_sb = st[3], a.k_ss = st[4], a.k_sh = st[5];
  a.v_sb = st[6], a.v_ss = st[7], a.v_sh = st[8];
  if (kind != kFwd) a.o_sb = st[9], a.o_ss = st[10], a.o_sh = st[11];
  a.causal = causal;
  a.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return (int)launch<64>(kind, a, B, s);
    case 80: return (int)launch<80>(kind, a, B, s);
    case 96: return (int)launch<96>(kind, a, B, s);
    case 128: return (int)launch<128>(kind, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fp32 forward, dQ and dK/dV on the FMA kernels, over the plan's idx / cnt
// / order arrays (the forward plan, or the transposed one for dK/dV).
extern "C" int bsa_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* idx, const void* cnt,
                       const void* order, int B, int S, int H, int head_dim,
                       int block, int max_list, const long long* strides,
                       int causal, float sm_scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lse_out = static_cast<float*>(lse);
  a.idx = static_cast<const int*>(idx);
  a.cnt = static_cast<const int*>(cnt);
  a.order = static_cast<const int*>(order);
  a.out0 = o;
  return run(kFwd, a, B, S, H, head_dim, block, max_list, strides, causal,
             sm_scale, stream);
}

extern "C" int bsa_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      const void* idx, const void* cnt, const void* order,
                      void* dq, int B, int S, int H, int head_dim, int block,
                      int max_list, const long long* strides, int causal,
                      float sm_scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.idx = static_cast<const int*>(idx);
  a.cnt = static_cast<const int*>(cnt);
  a.order = static_cast<const int*>(order);
  a.out0 = dq;
  return run(kDq, a, B, S, H, head_dim, block, max_list, strides, causal,
             sm_scale, stream);
}

extern "C" int bsa_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       const void* q_idx, const void* q_cnt,
                       const void* k_order, void* dk, void* dv, int B, int S,
                       int H, int head_dim, int block, int max_list,
                       const long long* strides, int causal, float sm_scale,
                       void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.idx = static_cast<const int*>(q_idx);
  a.cnt = static_cast<const int*>(q_cnt);
  a.order = static_cast<const int*>(k_order);
  a.out0 = dk;
  a.out1 = dv;
  return run(kDkv, a, B, S, H, head_dim, block, max_list, strides, causal,
             sm_scale, stream);
}

// bf16 forward on the Hopper kernel, over the dQ side of the tile plan
// (arguments as bsa_dq_h's; lse null: none written); strides: (batch,
// seq, head) element strides of q, k and v in turn.  The workspace holds
// B * n_partials partials of 64 x (head_dim + 8) floats.
extern "C" int bsa_fwd_h(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* items,
                         const void* own, const void* tiles, void* ws,
                         void* counters, int B, int S, int H, int head_dim,
                         int kw, int n_items, int n_live, int n_split,
                         int n_partials, const long long* strides,
                         float sm_scale, void* stream) {
  hbsa::Params p = hbsa::params(nullptr, nullptr, items, own, tiles, ws,
                                counters, B, S, H, kw, n_items, n_live,
                                n_split, n_partials, sm_scale);
  p.out0 = static_cast<__nv_bfloat16*>(o);
  p.lse_out = static_cast<float*>(lse);
  return hbsa::run<hbsa::kFwdSide>(q, k, v, nullptr, strides, p, head_dim,
                                   stream);
}

// bf16 dQ and dK/dV on the Hopper kernels, over one side's tile plan
// (items [n_items][8], the first n_live with streamed tiles, own [U][4],
// tiles [T][8] int32), with the fp32
// workspace (B * n_partials partial tiles) and B * n_split counters (0,
// left 0) that a split unit's segments merge through; kw = min(block, 64).
// strides: (batch, seq, head) element strides of q, k, v and dO in turn.
extern "C" int bsa_dq_h(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dsum,
                        const void* items, const void* own,
                        const void* tiles, void* dq, void* ws,
                        void* counters, int B, int S, int H, int head_dim,
                        int kw, int n_items, int n_live, int n_split,
                        int n_partials, const long long* strides,
                        float sm_scale, void* stream) {
  hbsa::Params p = hbsa::params(lse, dsum, items, own, tiles, ws, counters,
                                B, S, H, kw, n_items, n_live, n_split,
                                n_partials, sm_scale);
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  return hbsa::run<hbsa::kDqSide>(q, k, v, dout, strides, p, head_dim,
                                   stream);
}

extern "C" int bsa_dkv_h(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dsum,
                         const void* items, const void* own,
                         const void* tiles, void* dk, void* dv, void* ws,
                         void* counters, int B, int S, int H, int head_dim,
                         int kw, int n_items, int n_live, int n_split,
                         int n_partials, const long long* strides,
                         float sm_scale, void* stream) {
  hbsa::Params p = hbsa::params(lse, dsum, items, own, tiles, ws, counters,
                                B, S, H, kw, n_items, n_live, n_split,
                                n_partials, sm_scale);
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  return hbsa::run<hbsa::kDkvSide>(q, k, v, dout, strides, p, head_dim,
                                    stream);
}
