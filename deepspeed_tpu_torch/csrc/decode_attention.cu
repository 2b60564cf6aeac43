// Decode attention: one query token per row attends to the first
// cache_len[b] positions of a dense KV cache.
//
// Replaces: deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel,
// the float cache and the int8 cache (``quantized=True``: int8 k/v with
// one fp32 scale per (position, kv head), dequantized in registers, the
// query, scores, softmax and accumulation in fp32 as the Pallas kernel
// does), each with the ALiBi variant (``alibi=True``: the score of key
// position s for query head h gets slopes[h] * s before the softmax) and
// the windowed variant (``windowed=True``: positions below a per-row
// floor min_pos[b] are masked).  Both extras are runtime pointers, null
// when off, so the two cache types stay the only template instances.
//
// What bounds it on an H100: bytes.  Each (row, kv head) streams
// cache_len[b] * 2 * head_dim values and does ~4 flops per value, far
// below the ~295 flops per byte the card needs before its arithmetic is
// the limit.  The design therefore reads every valid cache position once
// and nothing past it:
//   - one CTA per (kv head, row): the rep = H / KV query heads of a group
//     share each K/V load, the query vectors sit in shared memory;
//   - the CTA's warps stride over positions < cache_len[b] only (the TPU
//     kernel skipped whole blocks past the longest row; here a short row
//     stops at its own length), cache_len is read from device memory so
//     the host never synchronises;
//   - lanes own head-dim slots (coalesced 32-lane loads), each warp keeps
//     a private online softmax (m, l, acc) over four positions in flight,
//     and the warps merge through shared memory at the end.
// The TPU kernel's block-diagonal query matmul filled a 128-lane MXU and
// has no counterpart here.  A row with cache_len <= 0 returns zeros.
//
// An int8 cache halves the bytes each position streams; the scales add
// 8 bytes per (position, kv head) against 2 * head_dim bytes of codes.
// The window floor starts each row's loop at min_pos[b] instead of
// masking from position 0, so a sliding-window layer reads only the
// positions it attends (at most the window).  ALiBi adds one product and
// one sum per score, each rounded on its own (__fmul_rn / __fadd_rn, no
// contraction), as the fused layer kernel does, so the two agree.
//
// C interface (loaded with ctypes): ds_decode_attention and
// ds_decode_attention_int8 return the cudaError_t of the launch as an int;
// `slopes` ([H] fp32, query-head order) and `min_pos` ([B] int32) may be
// null.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRep = 8;
constexpr int kPos = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q [B, H, HD], k/v [B, S_max, KV, HD] (CT: T, or int8 with ks/vs
// [B, S_max, KV] fp32 scales), cache_len [B], out [B, H, HD]; all
// contiguous.  slopes [H] (ALiBi) and min_pos [B] (window floor) or null.
// Grid (KV, B), block kWarps * 32 threads.
template <typename T, typename CT, int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const CT* __restrict__ k,
                        const CT* __restrict__ v,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ cache_len,
                        const float* __restrict__ slopes,
                        const int* __restrict__ min_pos,
                        T* __restrict__ out, int H, int KV, int S_max,
                        float sm_scale) {
  constexpr int NI = (HD + 31) / 32;
  constexpr bool kQuant = sizeof(CT) == 1;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [rep][HD]
  float* acc_s = q_s + rep * HD;           // [kWarps][rep][HD]
  float* m_s = acc_s + kWarps * rep * HD;  // [kWarps][rep]
  float* l_s = m_s + kWarps * rep;         // [kWarps][rep]

  // the group's query heads kvh*rep .. kvh*rep+rep-1, pre-scaled
  const T* q_row = q + ((size_t)b * H + (size_t)kvh * rep) * HD;
  for (int i = threadIdx.x; i < rep * HD; i += blockDim.x)
    q_s[i] = to_f(q_row[i]) * sm_scale;
  __syncthreads();

  int len = cache_len[b];
  len = len < S_max ? len : S_max;
  int first = min_pos != nullptr ? min_pos[b] : 0;
  first = first > 0 ? first : 0;

  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][NI], qr[kMaxRep][NI];
  float slope[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    slope[r] = (slopes != nullptr && r < rep) ? slopes[kvh * rep + r] : 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      acc[r][i] = 0.f;
      qr[r][i] = (r < rep && d < HD) ? q_s[r * HD + d] : 0.f;
    }
  }

  const size_t pos_stride = (size_t)KV * HD;
  const CT* k_base = k + (size_t)b * S_max * pos_stride + (size_t)kvh * HD;
  const CT* v_base = v + (size_t)b * S_max * pos_stride + (size_t)kvh * HD;
  // per-position scales of this (row, kv head); unused for a float cache
  const float* ks_base = kQuant ? ks + (size_t)b * S_max * KV + kvh : ks;
  const float* vs_base = kQuant ? vs + (size_t)b * S_max * KV + kvh : vs;

  for (int s0 = first + warp * kPos; s0 < len; s0 += kWarps * kPos) {
    float kx[kPos][NI], vx[kPos][NI];
#pragma unroll
    for (int j = 0; j < kPos; ++j) {
      const int s = s0 + j;
      float kscale = 1.f, vscale = 1.f;
      if (kQuant && s < len) {
        kscale = __ldg(ks_base + (size_t)s * KV);
        vscale = __ldg(vs_base + (size_t)s * KV);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        const bool ok = s < len && d < HD;
        kx[j][i] =
            ok ? to_f(k_base[(size_t)s * pos_stride + d]) * kscale : 0.f;
        vx[j][i] =
            ok ? to_f(v_base[(size_t)s * pos_stride + d]) * vscale : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float sc[kPos];
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          float p = 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) p += qr[r][i] * kx[j][i];
          sc[j] = warp_sum(p);
          if (slopes != nullptr)
            sc[j] = __fadd_rn(sc[j], __fmul_rn(slope[r], (float)(s0 + j)));
        }
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < kPos; ++j)
          if (s0 + j < len) mx = fmaxf(mx, sc[j]);
        const float corr = expf(m[r] - mx);
        float pj[kPos];
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          pj[j] = (s0 + j < len) ? expf(sc[j] - mx) : 0.f;
          psum += pj[j];
        }
        l[r] = l[r] * corr + psum;
        m[r] = mx;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float a = acc[r][i] * corr;
#pragma unroll
          for (int j = 0; j < kPos; ++j) a += pj[j] * vx[j][i];
          acc[r][i] = a;
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) acc_s[(warp * rep + r) * HD + d] = acc[r][i];
      }
      if (lane == 0) {
        m_s[warp * rep + r] = m[r];
        l_s[warp * rep + r] = l[r];
      }
    }
  }
  __syncthreads();
  T* out_row = out + ((size_t)b * H + (size_t)kvh * rep) * HD;
  for (int idx = threadIdx.x; idx < rep * HD; idx += blockDim.x) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w * rep + r]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w * rep + r] - M);
      L += l_s[w * rep + r] * f;
      O += acc_s[(w * rep + r) * HD + d] * f;
    }
    out_row[idx] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename CT, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* cache_len,
                   const void* slopes, const void* min_pos, void* out, int B,
                   int H, int KV, int S_max, float sm_scale,
                   cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem =
      (size_t)(rep * HD + kWarps * rep * HD + 2 * kWarps * rep) *
      sizeof(float);
  const dim3 grid(KV, B);
  decode_attention_kernel<T, CT, HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(cache_len),
      static_cast<const float*>(slopes), static_cast<const int*>(min_pos),
      static_cast<T*>(out), H, KV, S_max, sm_scale);
  return cudaGetLastError();
}

// one entry point per cache type; CT = T (float cache) or int8_t
template <bool kInt8>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* cache_len, const void* slopes,
             const void* min_pos, void* out, int B, int H, int KV, int S_max,
             int head_dim, int is_bf16, float sm_scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxRep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  using CB = typename std::conditional<kInt8, int8_t, BF>::type;
  using CF = typename std::conditional<kInt8, int8_t, float>::type;
#define DS_DECODE_CASE(HDV)                                                \
  case HDV:                                                                \
    return is_bf16                                                         \
               ? (int)launch<BF, CB, HDV>(q, k, v, ks, vs, cache_len,      \
                                          slopes, min_pos, out, B, H, KV,  \
                                          S_max, sm_scale, st)             \
               : (int)launch<float, CF, HDV>(q, k, v, ks, vs, cache_len,   \
                                             slopes, min_pos, out, B, H,   \
                                             KV, S_max, sm_scale, st);
  switch (head_dim) {
    DS_DECODE_CASE(64)
    DS_DECODE_CASE(80)
    DS_DECODE_CASE(96)
    DS_DECODE_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DS_DECODE_CASE
}

}  // namespace

extern "C" int ds_decode_attention(const void* q, const void* k,
                                   const void* v, const void* cache_len,
                                   const void* slopes, const void* min_pos,
                                   void* out, int B, int H, int KV,
                                   int S_max, int head_dim, int is_bf16,
                                   float sm_scale, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, cache_len, slopes,
                         min_pos, out, B, H, KV, S_max, head_dim, is_bf16,
                         sm_scale, stream);
}

extern "C" int ds_decode_attention_int8(const void* q, const void* k,
                                        const void* v, const void* ks,
                                        const void* vs, const void* cache_len,
                                        const void* slopes,
                                        const void* min_pos, void* out,
                                        int B, int H, int KV, int S_max,
                                        int head_dim, int is_bf16,
                                        float sm_scale, void* stream) {
  return dispatch<true>(q, k, v, ks, vs, cache_len, slopes, min_pos, out, B,
                        H, KV, S_max, head_dim, is_bf16, sm_scale, stream);
}
