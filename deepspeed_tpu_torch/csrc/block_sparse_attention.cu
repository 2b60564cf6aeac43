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
// is bound by bytes.  The design keeps every product on the tensor cores
// and every score tile on chip, and is the simple, right version (wgmma,
// TMA pipelines and a split of long lists across CTAs are later work):
//   - one CTA of four warps owns 64 rows: the forward and dQ of 64 query
//     rows, dK/dV of 64 key rows, as G = 64 / KW slots of KW = min(block,
//     64) rows.  Block <= 64: slot g holds one whole block with its own
//     list (block 16: four blocks, one a warp; 32: two, two warps each; 64:
//     one).  Block 128: the CTA holds one half of a block and sweeps each
//     listed block as two 64-row sub-tiles, so the score tile stays 64 x 64
//     and shared memory stays under 120 KB.  The CTA walks its lists in
//     rounds (round it: entry it / nsub of every slot), which takes the
//     place of the TPU's sequential grid axis; each CTA owns its output
//     rows, so there are no float atomics and the result is deterministic;
//   - each side's blocks are taken in the plan's `order` (list length
//     descending): a CTA's slots have lists of like length, so fewer warps
//     idle, and the longest CTAs start first (the Fixed layout's global
//     columns are attended by up to 1021 q blocks, most columns by ~4);
//   - causal: a sub-tile whose every pair is masked is skipped; inside the
//     diagonal block the masked scores are -inf with the row max guarded,
//     which contributes exactly what the reference's -1e30 does (the plan is
//     tril'd, so a row with a live block sees at least its own key);
//   - bf16: the products through nvcuda::wmma (bf16 in, fp32 accumulate),
//     the softmax and its gradient two lanes a row in fp32, P and dS back
//     to shared memory in bf16 as the A operand; fp32: plain FMA, two
//     threads a row each owning half the head dim, so fp32 results carry no
//     TF32 rounding;
//   - head_dim is a template parameter instantiated for 64, 96 and 128, the
//     bf16 slot width for 16, 32 and 64; shared memory above 48 KB is opted
//     into per launch.
//
// q, k, v and dO may be strided [B, S, H, HD] views: the caller passes
// batch, sequence and head strides in elements; the last dimension is
// contiguous and every stride and base address is 16-byte aligned (checked
// by the Python wrapper).  lse and dsum are contiguous [B, H, S] fp32.
// Outputs are contiguous [B, S, H, HD] in the input dtype, lse [B, H, S].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TM = 64;  // rows a CTA owns
constexpr int kThreads = 128;
// padded shared row strides (bank spread; wmma needs ldm % 8 == 0 for bf16
// and % 4 == 0 for fp32, and 32-byte aligned tile pointers, both kept)
constexpr int SLD = TM + 4;  // fp32 score-shaped tiles
constexpr int PLD = TM + 8;  // bf16 P / dS tiles

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

__device__ __forceinline__ void store_val(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }

// Own rows of an fp32 [TM][ld] stage, times mul, -> head h of a contiguous
// [B, S, H, HD] output (slots past the last block dropped).
template <typename T, int HD>
__device__ __forceinline__ void write_slots(void* dst, const float* stage,
                                            int ld, float mul, const Args& a,
                                            int b, int h, const int* rows) {
  T* out = static_cast<T*>(dst);
  for (int i = threadIdx.x; i < TM * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i - r * HD;
    const int g = r / a.kw;
    const int r0 = rows[g];
    if (r0 < 0) continue;
    store_val(out + (((size_t)b * a.S + r0 + r - g * a.kw) * a.H + h) * HD + c,
              stage[r * ld + c] * mul);
  }
}

// out[16][KW] (ld SLD) = A[16][HD] . B[KW][HD]^T, both dense (ld HD).
template <int HD, int KW>
__device__ __forceinline__ void mma_abt(float* out, const bf16* A,
                                        const bf16* B) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KW / 16];
#pragma unroll
  for (int n = 0; n < KW / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, A + kk, HD);
#pragma unroll
    for (int n = 0; n < KW / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, B + n * 16 * HD + kk, HD);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < KW / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], SLD, wmma::mem_row_major);
}

// ------------------------------------------------------------------ bf16
template <int HD, int KW>
__global__ void __launch_bounds__(kThreads) fwd_bf16(Args a) {
  constexpr int OLD = HD + 4;  // fp32 output accumulator row stride
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);         // [TM][HD]
  bf16* Ks = Qs + TM * HD;                              // [TM][HD]
  bf16* Vs = Ks + TM * HD;                              // [TM][HD]
  bf16* Ps = Vs + TM * HD;                              // [TM][PLD]
  float* Ss = reinterpret_cast<float*>(Ps + TM * PLD);  // [TM][SLD]
  float* Os = Ss + TM * SLD;                            // [TM][OLD]
  __shared__ Slots sl;

  setup_slots(sl, a, h);
  for (int i = threadIdx.x; i < TM * OLD; i += kThreads) Os[i] = 0.f;
  __syncthreads();
  const int rounds = rounds_of(sl, a);
  load_slots<bf16, HD>(
      Qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
      sl.row, KW);
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;

  // this lane's row (two lanes per row), its half of the columns, its slot
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int g = (warp * 16) / KW;
  const int s_q = sl.row[g] + r - g * KW;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int it = 0; it < rounds; ++it) {
    set_cols(sl, a, h, it, false);
    __syncthreads();  // columns visible, the previous round's K/V consumed
    load_slots<bf16, HD>(Ks, kb, a.k_ss, sl.col[it & 1], KW);
    load_slots<bf16, HD>(Vs, vb, a.v_ss, sl.col[it & 1], KW);
    __syncthreads();
    const int col0 = sl.col[it & 1][g];
    if (col0 < 0) continue;  // the whole warp: its slot has nothing here

    mma_abt<HD, KW>(Ss + warp * 16 * SLD, Qs + warp * 16 * HD,
                    Ks + g * KW * HD);
    __syncwarp();
    {
      float* srow = Ss + r * SLD;
      const int c0 = half * (KW / 2);
      float mx = -INFINITY;
      for (int c = c0; c < c0 + KW / 2; ++c) {
        const float x = (!a.causal || col0 + c <= s_q)
                            ? srow[c] * a.sm_scale : -INFINITY;
        srow[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const bool any = m_new != -INFINITY;
      const float alpha = any ? expf(m_i - m_new) : 1.f;
      float psum = 0.f;
      for (int c = c0; c < c0 + KW / 2; ++c) {
        const float p = any ? expf(srow[c] - m_new) : 0.f;
        Ps[r * PLD + c] = __float2bfloat16(p);
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l_i = l_i * alpha + psum;
      m_i = m_new;
      float* orow = Os + r * OLD + half * (HD / 2);
      for (int c = 0; c < HD / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O[16, HD] += P[16, KW] x V[KW, HD]
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + warp * 16 * OLD + n * 16, OLD,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KW; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ps + warp * 16 * PLD + kk, PLD);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Vs + (g * KW + kk) * HD + n * 16, HD);
        wmma::mma_sync(oacc, fa, fb, oacc);
      }
      wmma::store_matrix_sync(Os + warp * 16 * OLD + n * 16, oacc, OLD,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (sl.blk[g] >= 0) {
    const float* src = Os + r * OLD + half * (HD / 2);
    bf16* orow = static_cast<bf16*>(a.out0) +
                 (((size_t)b * a.S + s_q) * a.H + h) * HD + half * (HD / 2);
    for (int c = 0; c < HD / 2; ++c)
      orow[c] = __float2bfloat16(l_i > 0.f ? src[c] / l_i : 0.f);
    if (half == 0 && a.lse_out != nullptr)
      a.lse_out[((size_t)b * a.H + h) * a.S + s_q] =
          l_i > 0.f ? m_i + logf(l_i) : INFINITY;
  }
}

template <int HD, int KW>
__global__ void __launch_bounds__(kThreads) dq_bf16(Args a) {
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);         // [TM][HD]
  bf16* Os = Qs + TM * HD;                              // dO [TM][HD]
  bf16* Ks = Os + TM * HD;                              // [TM][HD]
  bf16* Vs = Ks + TM * HD;                              // [TM][HD]
  float* Ss = reinterpret_cast<float*>(Vs + TM * HD);   // scores [TM][SLD]
  float* Ds = Ss + TM * SLD;                            // dP [TM][SLD]
  bf16* Gs = reinterpret_cast<bf16*>(Ds + TM * SLD);    // dS [TM][PLD]
  __shared__ Slots sl;

  setup_slots(sl, a, h);
  __syncthreads();
  const int rounds = rounds_of(sl, a);
  load_slots<bf16, HD>(
      Qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
      sl.row, KW);
  load_slots<bf16, HD>(
      Os, static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh, a.o_ss,
      sl.row, KW);
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;

  // this lane's query row (two lanes per row), half of the columns, slot
  const int r = warp * 16 + (lane >> 1);
  const int c0 = (lane & 1) * (KW / 2);
  const int g = (warp * 16) / KW;
  const int s_q = sl.row[g] + r - g * KW;
  float lse_q = 0.f, dsum_q = 0.f;
  if (sl.blk[g] >= 0) {
    const size_t row = ((size_t)b * a.H + h) * a.S + s_q;
    lse_q = a.lse[row];
    dsum_q = a.dsum[row];
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  for (int it = 0; it < rounds; ++it) {
    set_cols(sl, a, h, it, false);
    __syncthreads();
    load_slots<bf16, HD>(Ks, kb, a.k_ss, sl.col[it & 1], KW);
    load_slots<bf16, HD>(Vs, vb, a.v_ss, sl.col[it & 1], KW);
    __syncthreads();
    const int col0 = sl.col[it & 1][g];
    if (col0 < 0) continue;

    // S = Q K^T and dP = dO V^T for this warp's 16 query rows
    mma_abt<HD, KW>(Ss + warp * 16 * SLD, Qs + warp * 16 * HD,
                    Ks + g * KW * HD);
    mma_abt<HD, KW>(Ds + warp * 16 * SLD, Os + warp * 16 * HD,
                    Vs + g * KW * HD);
    __syncwarp();
    {
      const float* srow = Ss + r * SLD;
      const float* drow = Ds + r * SLD;
      for (int c = c0; c < c0 + KW / 2; ++c) {
        const float p = (!a.causal || col0 + c <= s_q)
                            ? expf(srow[c] * a.sm_scale - lse_q) : 0.f;
        Gs[r * PLD + c] = __float2bfloat16(p * (drow[c] - dsum_q));
      }
    }
    __syncwarp();

    // dQ += dS K for this warp's 16 query rows
#pragma unroll
    for (int kk = 0; kk < KW; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fg;
      wmma::load_matrix_sync(fg, Gs + warp * 16 * PLD + kk, PLD);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Ks + (g * KW + kk) * HD + n * 16, HD);
        wmma::mma_sync(dq_acc[n], fg, fb, dq_acc[n]);
      }
    }
  }

  // epilogue: fragments -> fp32 stage (over the tiles) -> rows, x sm_scale
  float* stage = reinterpret_cast<float*>(smem_raw);  // [TM][HD + 4]
  __syncthreads();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * (HD + 4) + n * 16, dq_acc[n],
                            HD + 4, wmma::mem_row_major);
  __syncthreads();
  write_slots<bf16, HD>(a.out0, stage, HD + 4, a.sm_scale, a, b, h, sl.row);
}

template <int HD, int KW>
__global__ void __launch_bounds__(kThreads) dkv_bf16(Args a) {
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);         // [TM][HD] own
  bf16* Vs = Ks + TM * HD;                              // [TM][HD] own
  bf16* Qs = Vs + TM * HD;                              // [TM][HD] round
  bf16* Os = Qs + TM * HD;                              // dO [TM][HD] round
  float* St = reinterpret_cast<float*>(Os + TM * HD);   // scores^T [TM][SLD]
  float* Dt = St + TM * SLD;                            // dP^T [TM][SLD]
  bf16* Pt = reinterpret_cast<bf16*>(Dt + TM * SLD);    // P^T [TM][PLD]
  bf16* Gt = Pt + TM * PLD;                             // dS^T [TM][PLD]
  float* lseS = reinterpret_cast<float*>(Gt + TM * PLD);  // [TM]
  float* dsS = lseS + TM;                                 // [TM]
  __shared__ Slots sl;

  setup_slots(sl, a, h);
  __syncthreads();
  const int rounds = rounds_of(sl, a);
  load_slots<bf16, HD>(
      Ks, static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh, a.k_ss,
      sl.row, KW);
  load_slots<bf16, HD>(
      Vs, static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh, a.v_ss,
      sl.row, KW);
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* ob =
      static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh;

  // this lane's key row (two lanes per row), half of the columns, slot
  const int r = warp * 16 + (lane >> 1);
  const int c0 = (lane & 1) * (KW / 2);
  const int g = (warp * 16) / KW;
  const int s_k = sl.row[g] + r - g * KW;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[HD / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv_acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  for (int it = 0; it < rounds; ++it) {
    set_cols(sl, a, h, it, true);
    __syncthreads();  // rows visible, the previous round's Q / dO consumed
    load_slots<bf16, HD>(Qs, qb, a.q_ss, sl.col[it & 1], KW);
    load_slots<bf16, HD>(Os, ob, a.o_ss, sl.col[it & 1], KW);
    load_row_vals(lseS, dsS, a, b, h, sl.col[it & 1]);
    __syncthreads();
    const int col0 = sl.col[it & 1][g];
    if (col0 < 0) continue;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows
    mma_abt<HD, KW>(St + warp * 16 * SLD, Ks + warp * 16 * HD,
                    Qs + g * KW * HD);
    mma_abt<HD, KW>(Dt + warp * 16 * SLD, Vs + warp * 16 * HD,
                    Os + g * KW * HD);
    __syncwarp();
    {
      const float* srow = St + r * SLD;
      const float* drow = Dt + r * SLD;
      for (int c = c0; c < c0 + KW / 2; ++c) {
        const int qc = g * KW + c;
        const float p = (!a.causal || col0 + c >= s_k)
                            ? expf(srow[c] * a.sm_scale - lseS[qc]) : 0.f;
        Pt[r * PLD + c] = __float2bfloat16(p);
        Gt[r * PLD + c] = __float2bfloat16(p * (drow[c] - dsS[qc]));
      }
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q for this warp's 16 key rows
#pragma unroll
    for (int kk = 0; kk < KW; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fg;
      wmma::load_matrix_sync(fp, Pt + warp * 16 * PLD + kk, PLD);
      wmma::load_matrix_sync(fg, Gt + warp * 16 * PLD + kk, PLD);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Os + (g * KW + kk) * HD + n * 16, HD);
        wmma::mma_sync(dv_acc[n], fp, fb, dv_acc[n]);
        wmma::load_matrix_sync(fb, Qs + (g * KW + kk) * HD + n * 16, HD);
        wmma::mma_sync(dk_acc[n], fg, fb, dk_acc[n]);
      }
    }
  }

  // epilogue: fragments -> fp32 stage (over the tiles) -> rows
  float* stage = reinterpret_cast<float*>(smem_raw);  // [TM][HD + 4]
  __syncthreads();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * (HD + 4) + n * 16, dv_acc[n],
                            HD + 4, wmma::mem_row_major);
  __syncthreads();
  write_slots<bf16, HD>(a.out1, stage, HD + 4, 1.f, a, b, h, sl.row);
  __syncthreads();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * (HD + 4) + n * 16, dk_acc[n],
                            HD + 4, wmma::mem_row_major);
  __syncthreads();
  write_slots<bf16, HD>(a.out0, stage, HD + 4, a.sm_scale, a, b, h, sl.row);
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

template <int HD, int KW>
cudaError_t launch_bf16(Kind kind, const Args& a, dim3 grid,
                        cudaStream_t st) {
  const size_t tile = (size_t)TM * HD * sizeof(bf16);
  const size_t scores = (size_t)TM * SLD * sizeof(float);
  const size_t probs = (size_t)TM * PLD * sizeof(bf16);
  switch (kind) {
    case kFwd:
      return launch_with(fwd_bf16<HD, KW>, grid,
                         3 * tile + probs + scores +
                             (size_t)TM * (HD + 4) * sizeof(float),
                         st, a);
    case kDq:
      return launch_with(dq_bf16<HD, KW>, grid, 4 * tile + 2 * scores + probs,
                         st, a);
    default:
      return launch_with(dkv_bf16<HD, KW>, grid,
                         4 * tile + 2 * scores + 2 * probs +
                             2 * TM * sizeof(float),
                         st, a);
  }
}

template <int HD>
cudaError_t launch(Kind kind, const Args& a, int B, int is_bf16,
                   cudaStream_t st) {
  const int G = TM / a.kw;
  const int nsub = a.block / a.kw;
  const int tiles = nsub > 1 ? a.nblk * nsub : (a.nblk + G - 1) / G;
  const dim3 grid(tiles, B * a.H);
  if (!is_bf16) {
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
        return launch_with(dkv_f32<HD>, grid,
                           4 * pad + 2 * TM * sizeof(float), st, a);
    }
  }
  switch (a.kw) {
    case 16: return launch_bf16<HD, 16>(kind, a, grid, st);
    case 32: return launch_bf16<HD, 32>(kind, a, grid, st);
    default: return launch_bf16<HD, 64>(kind, a, grid, st);
  }
}

// strides: (batch, seq, head) element strides of q, k, v and (dQ, dK/dV)
// dO in turn.
int run(Kind kind, Args a, int B, int S, int H, int head_dim, int block,
        int max_list, const long long* st, int causal, float sm_scale,
        int is_bf16, void* stream) {
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
    case 64: return (int)launch<64>(kind, a, B, is_bf16, s);
    case 80: return (int)launch<80>(kind, a, B, is_bf16, s);
    case 96: return (int)launch<96>(kind, a, B, is_bf16, s);
    case 128: return (int)launch<128>(kind, a, B, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bsa_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* idx, const void* cnt,
                       const void* order, int B, int S, int H, int head_dim,
                       int block, int max_list, const long long* strides,
                       int causal, float sm_scale, int is_bf16,
                       void* stream) {
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
             sm_scale, is_bf16, stream);
}

extern "C" int bsa_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      const void* idx, const void* cnt, const void* order,
                      void* dq, int B, int S, int H, int head_dim, int block,
                      int max_list, const long long* strides, int causal,
                      float sm_scale, int is_bf16, void* stream) {
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
             sm_scale, is_bf16, stream);
}

extern "C" int bsa_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       const void* q_idx, const void* q_cnt,
                       const void* k_order, void* dk, void* dv, int B, int S,
                       int H, int head_dim, int block, int max_list,
                       const long long* strides, int causal, float sm_scale,
                       int is_bf16, void* stream) {
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
             sm_scale, is_bf16, stream);
}
