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
// where the tensor cores become the limit.  The design keeps the products
// on the tensor cores and everything [S, S]-shaped on chip:
//   - grid (ceil(S / 64), B * H): one CTA per 64-row query tile of one
//     head; the key loop inside the CTA takes the place of the TPU's
//     sequential grid dimension and stops at the diagonal tile when causal;
//   - bf16: q, k, v tiles of 64 rows staged in shared memory, the two
//     products on the tensor cores through nvcuda::wmma (bf16 in, fp32
//     accumulate), four warps of 16 query rows each, row max / row sum in
//     fp32, the running output kept in fp32 shared memory;
//   - fp32: the same tiling with plain fp32 FMA (two threads per query
//     row, each owning half the head dim), so fp32 results carry no TF32
//     rounding;
//   - head_dim is a template parameter instantiated for 64, 80, 96, 128.
// wgmma and TMA pipelines are left for a later change.
//
// Inputs may be strided views (q/k/v slices of one fused qkv tensor): the
// caller passes batch, sequence and head strides in elements; the last
// dimension is contiguous and every stride and base address is 16-byte
// aligned (checked by the Python wrapper).  Outputs are contiguous:
// o [B, S, H, HD] in the input dtype, lse [B, H, S] fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int kThreads = 128;
// padded shared row strides (bank spread; wmma needs ldm % 8 == 0 for bf16
// and % 4 == 0 for fp32, and 32-byte aligned tile pointers, both kept)
constexpr int SLD = BN + 4;  // fp32 scores
constexpr int PLD = BN + 8;  // bf16 probabilities
constexpr float kNegInfLse = -1e30f;

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

// ------------------------------------------------------------------ bf16
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Args a) {
  constexpr int OLD = HD + 4;  // fp32 output accumulator row stride
  const int qt = blockIdx.x;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][HD]
  bf16* Ks = Qs + BM * HD;                       // [BN][HD]
  bf16* Vs = Ks + BN * HD;                       // [BN][HD]
  bf16* Ps = Vs + BN * HD;                       // [BM][PLD]
  float* Ss = reinterpret_cast<float*>(Ps + BM * PLD);  // [BM][SLD]
  float* Os = Ss + BM * SLD;                            // [BM][OLD]
  int* segK = reinterpret_cast<int*>(Os + BM * OLD);    // [BN]

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<bf16, HD>(Qs, qb, a.q_ss, q0, a.S);
  for (int i = threadIdx.x; i < BM * OLD; i += kThreads) Os[i] = 0.f;

  // this lane's row (two lanes per row) and its half of the columns
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int s_q = q0 + r;
  const int seg_q = (a.seg != nullptr && s_q < a.S)
                        ? a.seg[(size_t)b * a.S + s_q] : 0;
  float m_i = -INFINITY;
  float l_i = 0.f;

  const int n_tiles = (a.S + BN - 1) / BN;
  const int kt_end = a.causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // previous tile's K/V fully consumed
    load_tile<bf16, HD>(Ks, kb, a.k_ss, k0, a.S);
    load_tile<bf16, HD>(Vs, vb, a.v_ss, k0, a.S);
    load_seg(segK, a, b, k0);
    __syncthreads();

    // scores for this warp's 16 rows: Q [16, HD] x K^T [HD, 64]
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BN / 16];
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Qs + warp * 16 * HD + kk, HD);
#pragma unroll
        for (int n = 0; n < BN / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fb, Ks + n * 16 * HD + kk, HD);
          wmma::mma_sync(sacc[n], fa, fb, sacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BN / 16; ++n)
        wmma::store_matrix_sync(Ss + warp * 16 * SLD + n * 16, sacc[n], SLD,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this row's half of the tile
    {
      float* srow = Ss + r * SLD;
      const int c0 = half * (BN / 2);
      float mx = -INFINITY;
      for (int c = c0; c < c0 + BN / 2; ++c) {
        const float x = visible(a, s_q, k0 + c, seg_q, segK, c)
                            ? srow[c] * a.sm_scale : -INFINITY;
        srow[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const bool any = m_new != -INFINITY;
      const float alpha = any ? expf(m_i - m_new) : 1.f;
      float psum = 0.f;
      for (int c = c0; c < c0 + BN / 2; ++c) {
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

    // O[16, HD] += P[16, 64] x V[64, HD]
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + warp * 16 * OLD + n * 16, OLD,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ps + warp * 16 * PLD + kk, PLD);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Vs + kk * HD + n * 16, HD);
        wmma::mma_sync(oacc, fa, fb, oacc);
      }
      wmma::store_matrix_sync(Os + warp * 16 * OLD + n * 16, oacc, OLD,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (s_q < a.S) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    bf16* orow = static_cast<bf16*>(a.o) +
                 (((size_t)b * a.S + s_q) * a.H + h) * HD + half * (HD / 2);
    const float* src = Os + r * OLD + half * (HD / 2);
    for (int c = 0; c < HD / 2; ++c) orow[c] = __float2bfloat16(src[c] * inv);
    if (half == 0)
      a.lse[((size_t)b * a.H + h) * a.S + s_q] =
          l_i > 0.f ? m_i + logf(l_i) : kNegInfLse;
  }
}

// ------------------------------------------------------------------ fp32
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

template <int HD>
cudaError_t launch(const Args& a, int B, int is_bf16, cudaStream_t stream) {
  const dim3 grid((a.S + BM - 1) / BM, B * a.H);
  if (is_bf16) {
    const size_t smem = (size_t)(BM + 2 * BN) * HD * sizeof(bf16) +
                        (size_t)BM * PLD * sizeof(bf16) +
                        (size_t)BM * SLD * sizeof(float) +
                        (size_t)BM * (HD + 4) * sizeof(float) +
                        BN * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    flash_fwd_bf16<HD><<<grid, kThreads, smem, stream>>>(a);
  } else {
    const size_t smem = (size_t)2 * BN * HD * sizeof(float) +
                        (size_t)BM * (BN + 1) * sizeof(float) +
                        BN * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    flash_fwd_f32<HD><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
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
