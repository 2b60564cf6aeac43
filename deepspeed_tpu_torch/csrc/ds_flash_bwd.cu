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
// cores become the limit.  The design keeps every product on the tensor
// cores and everything [S, S]-shaped on chip; it is the simple, right
// version (wgmma / TMA pipelines and register-resident softmax are later
// work):
//   - dK/dV: grid (ceil(S / 64), B * KV), one CTA per 64-row key tile of one
//     kv head.  It loops over the rep query heads of its group and, for
//     each, over the query tiles from the diagonal tile (causal) to the end.
//     dK and dV accumulate in fp32 wmma fragments for the whole group --
//     the counterpart of the TPU kernel's head-innermost grid, with no
//     atomics and a deterministic order -- and are written once, in the
//     input dtype.
//   - dQ: grid (ceil(S / 64), B * H), one CTA per 64-row query tile of one
//     head; the key loop stops at the diagonal tile when causal.  dQ
//     accumulates in fp32 fragments and is written in the input dtype.
//   - bf16: four warps of 16 rows each; the score-shaped products (q k^T,
//     dO v^T) land in fp32 shared tiles, the softmax-gradient elementwise
//     step runs two lanes per row in fp32, and P / dS go back to shared
//     memory in bf16 as the A operand of the accumulating products, all
//     through nvcuda::wmma (bf16 in, fp32 accumulate).
//   - fp32: the same tiling with plain fp32 FMA (two threads per row, each
//     owning half the head dim, rows padded by one float in shared memory
//     against bank conflicts), so fp32 results carry no TF32 rounding.
//   - head_dim is a template parameter instantiated for 64, 80, 96, 128.
//   - shared memory above 48 KB is opted into per launch.
//
// Inputs may be strided views (q/k/v slices of one fused qkv tensor): the
// caller passes batch, sequence and head strides in elements for q, k, v
// and dO; the last dimension is contiguous and every stride and base
// address is 16-byte aligned (checked by the Python wrapper).  lse and
// delta are contiguous [B, H, S] fp32, segment ids contiguous [B, S] int32
// or null.  Outputs are contiguous: dq [B, S, H, HD], dk / dv
// [B, S, KV, HD], all in the input dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;   // query rows per tile
constexpr int BN = 64;   // key rows per tile (BM == BN: the diagonal tile
                         // of key tile t is query tile t)
constexpr int kThreads = 128;
// padded shared row strides (bank spread; wmma needs ldm % 8 == 0 for bf16
// and % 4 == 0 for fp32, and 32-byte aligned tile pointers, both kept)
constexpr int SLD = BN + 4;  // fp32 score-shaped tiles
constexpr int PLD = BN + 8;  // bf16 P / dS tiles
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

__device__ __forceinline__ void store_val(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }

// ------------------------------------------------------------------ bf16
// Stage rows [r0, r0 + 64) of one head of a [B, S, *, HD] view into a
// dense [64][HD] shared tile, zero past S.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int S) {
  constexpr int VEC = 8;
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

// out[16][64] (ld SLD) = A[16][HD] . B[64][HD]^T, both dense (ld HD).
template <int HD>
__device__ __forceinline__ void mma_abt(float* out, const bf16* A,
                                        const bf16* B) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, A + kk, HD);
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, B + n * 16 * HD + kk, HD);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BN / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], SLD, wmma::mem_row_major);
}

// Rows [r0, r0 + 64) of an fp32 [64][HD + 4] shared stage -> head x of a
// contiguous [B, S, X, HD] output, rows past S dropped.
template <typename T, int HD>
__device__ __forceinline__ void write_rows(void* dst, const float* stage,
                                           int b, int S, int X, int x,
                                           int r0) {
  T* out = static_cast<T*>(dst);
  for (int idx = threadIdx.x; idx < 64 * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx - r * HD;
    const int s = r0 + r;
    if (s < S)
      store_val(out + (((size_t)b * S + s) * X + x) * HD + c,
                stage[r * (HD + 4) + c]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_bf16(Args a) {
  const int kt = blockIdx.x;
  const int b = blockIdx.y / a.KV;
  const int g = blockIdx.y - b * a.KV;
  const int rep = a.H / a.KV;
  const int k0 = kt * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BN][HD]
  bf16* Vs = Ks + BN * HD;                       // [BN][HD]
  bf16* Qs = Vs + BN * HD;                       // [BM][HD]
  bf16* Os = Qs + BM * HD;                       // dO [BM][HD]
  float* St = reinterpret_cast<float*>(Os + BM * HD);  // scores^T [BN][SLD]
  float* Dt = St + BN * SLD;                           // dP^T [BN][SLD]
  bf16* Pt = reinterpret_cast<bf16*>(Dt + BN * SLD);   // P^T [BN][PLD]
  bf16* Gt = Pt + BN * PLD;                            // dS^T [BN][PLD]
  float* lseS = reinterpret_cast<float*>(Gt + BN * PLD);  // [BM]
  float* dltS = lseS + BM;                                // [BM]
  int* segQ = reinterpret_cast<int*>(dltS + BM);          // [BM]

  load_tile<HD>(Ks, static_cast<const bf16*>(a.k) + b * a.k_sb + g * a.k_sh,
                a.k_ss, k0, a.S);
  load_tile<HD>(Vs, static_cast<const bf16*>(a.v) + b * a.v_sb + g * a.v_sh,
                a.v_ss, k0, a.S);

  // this lane's key row (two lanes per row) and its half of the columns
  const int r = warp * 16 + (lane >> 1);
  const int c0 = (lane & 1) * (BM / 2);
  const int s_k = k0 + r;
  const int seg_k = seg_at(a, b, s_k);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[HD / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv_acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int n_tiles = (a.S + BM - 1) / BM;
  const int qt0 = a.causal ? kt : 0;
  for (int j = 0; j < rep; ++j) {
    const int h = g * rep + j;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* ob =
        static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh;
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // previous tile's Q / dO fully consumed
      load_tile<HD>(Qs, qb, a.q_ss, q0, a.S);
      load_tile<HD>(Os, ob, a.o_ss, q0, a.S);
      load_rows(lseS, dltS, segQ, a, b, h, q0);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows
      mma_abt<HD>(St + warp * 16 * SLD, Ks + warp * 16 * HD, Qs);
      mma_abt<HD>(Dt + warp * 16 * SLD, Vs + warp * 16 * HD, Os);
      __syncwarp();

      {
        const float* srow = St + r * SLD;
        const float* drow = Dt + r * SLD;
        for (int c = c0; c < c0 + BM / 2; ++c) {
          const float p =
              visible(a, q0 + c, s_k, segQ[c], seg_k, lseS[c])
                  ? expf(srow[c] * a.sm_scale - lseS[c]) : 0.f;
          Pt[r * PLD + c] = __float2bfloat16(p);
          Gt[r * PLD + c] =
              __float2bfloat16(p * (drow[c] - dltS[c]) * a.sm_scale);
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q for this warp's 16 key rows
#pragma unroll
      for (int kk = 0; kk < BM; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fg;
        wmma::load_matrix_sync(fp, Pt + warp * 16 * PLD + kk, PLD);
        wmma::load_matrix_sync(fg, Gt + warp * 16 * PLD + kk, PLD);
#pragma unroll
        for (int n = 0; n < HD / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, Os + kk * HD + n * 16, HD);
          wmma::mma_sync(dv_acc[n], fp, fb, dv_acc[n]);
          wmma::load_matrix_sync(fb, Qs + kk * HD + n * 16, HD);
          wmma::mma_sync(dk_acc[n], fg, fb, dk_acc[n]);
        }
      }
    }
  }

  // epilogue: fragments -> fp32 stage (over the tiles) -> bf16 rows
  float* stage = reinterpret_cast<float*>(smem_raw);  // [BN][HD + 4]
  __syncthreads();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * (HD + 4) + n * 16, dv_acc[n],
                            HD + 4, wmma::mem_row_major);
  __syncthreads();
  write_rows<bf16, HD>(a.dv, stage, b, a.S, a.KV, g, k0);
  __syncthreads();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * (HD + 4) + n * 16, dk_acc[n],
                            HD + 4, wmma::mem_row_major);
  __syncthreads();
  write_rows<bf16, HD>(a.dk, stage, b, a.S, a.KV, g, k0);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dq_bf16(Args a) {
  const int qt = blockIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][HD]
  bf16* Os = Qs + BM * HD;                       // dO [BM][HD]
  bf16* Ks = Os + BM * HD;                       // [BN][HD]
  bf16* Vs = Ks + BN * HD;                       // [BN][HD]
  float* Ss = reinterpret_cast<float*>(Vs + BN * HD);  // scores [BM][SLD]
  float* Ds = Ss + BM * SLD;                           // dP [BM][SLD]
  bf16* Gs = reinterpret_cast<bf16*>(Ds + BM * SLD);   // dS [BM][PLD]
  int* segK = reinterpret_cast<int*>(Gs + BM * PLD);   // [BN]

  load_tile<HD>(Qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh,
                a.q_ss, q0, a.S);
  load_tile<HD>(Os,
                static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh,
                a.o_ss, q0, a.S);
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // this lane's query row (two lanes per row) and its half of the columns
  const int r = warp * 16 + (lane >> 1);
  const int c0 = (lane & 1) * (BN / 2);
  const int s_q = q0 + r;
  const bool in = s_q < a.S;
  const size_t row = ((size_t)b * a.H + h) * a.S + s_q;
  const float lse_q = in ? a.lse[row] : kNegInfLse;
  const float dlt_q = in ? a.delta[row] : 0.f;
  const int seg_q = seg_at(a, b, s_q);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  const int n_tiles = (a.S + BN - 1) / BN;
  const int kt_end = a.causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // previous tile's K / V fully consumed
    load_tile<HD>(Ks, kb, a.k_ss, k0, a.S);
    load_tile<HD>(Vs, vb, a.v_ss, k0, a.S);
    for (int c = threadIdx.x; c < BN; c += kThreads)
      segK[c] = seg_at(a, b, k0 + c);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 query rows
    mma_abt<HD>(Ss + warp * 16 * SLD, Qs + warp * 16 * HD, Ks);
    mma_abt<HD>(Ds + warp * 16 * SLD, Os + warp * 16 * HD, Vs);
    __syncwarp();

    {
      const float* srow = Ss + r * SLD;
      const float* drow = Ds + r * SLD;
      for (int c = c0; c < c0 + BN / 2; ++c) {
        const float p = visible(a, s_q, k0 + c, seg_q, segK[c], lse_q)
                            ? expf(srow[c] * a.sm_scale - lse_q) : 0.f;
        Gs[r * PLD + c] =
            __float2bfloat16(p * (drow[c] - dlt_q) * a.sm_scale);
      }
    }
    __syncwarp();

    // dQ += dS K for this warp's 16 query rows
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fg;
      wmma::load_matrix_sync(fg, Gs + warp * 16 * PLD + kk, PLD);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Ks + kk * HD + n * 16, HD);
        wmma::mma_sync(dq_acc[n], fg, fb, dq_acc[n]);
      }
    }
  }

  float* stage = reinterpret_cast<float*>(smem_raw);  // [BM][HD + 4]
  __syncthreads();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * (HD + 4) + n * 16, dq_acc[n],
                            HD + 4, wmma::mem_row_major);
  __syncthreads();
  write_rows<bf16, HD>(a.dq, stage, b, a.S, a.H, h, q0);
}

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
  const dim3 grid((a.S + BN - 1) / BN, B * a.KV);
  if (is_bf16) {
    const size_t smem = (size_t)(2 * BN + 2 * BM) * HD * sizeof(bf16) +
                        (size_t)2 * BN * SLD * sizeof(float) +
                        (size_t)2 * BN * PLD * sizeof(bf16) +
                        (size_t)BM * (2 * sizeof(float) + sizeof(int));
    return launch_with(dkv_bf16<HD>, grid, smem, stream, a);
  }
  const size_t smem = (size_t)(2 * BN + 2 * BM) * (HD + 1) * sizeof(float) +
                      (size_t)BM * (2 * sizeof(float) + sizeof(int));
  return launch_with(dkv_f32<HD>, grid, smem, stream, a);
}

template <int HD>
cudaError_t launch_dq(const Args& a, int B, int is_bf16,
                      cudaStream_t stream) {
  const dim3 grid((a.S + BM - 1) / BM, B * a.H);
  if (is_bf16) {
    const size_t smem = (size_t)(2 * BM + 2 * BN) * HD * sizeof(bf16) +
                        (size_t)2 * BM * SLD * sizeof(float) +
                        (size_t)BM * PLD * sizeof(bf16) +
                        (size_t)BN * sizeof(int);
    return launch_with(dq_bf16<HD>, grid, smem, stream, a);
  }
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
