// One CTA's output tile of A @ W over a K range, with W streamed from
// device memory and, for int8 weights, dequantized right before its use:
// tile_mma ([up to 64 rows x 64 columns], a cp.async ring through shared
// memory, tensor cores for bf16) and, for the decode shape of at most 8
// rows, rows_mma ([8 x 256], weights straight into registers).  Shared by
// csrc/qgemm.cu (the fused-dequant GEMM), csrc/fused_decode.cu (the
// per-layer megakernel's projection phases) and csrc/grouped_gemm.cu (the
// grouped GEMMs, float and int8).
//
// Numerics are the reference's (deepspeed_tpu/ops/pallas/qgemm.py
// _qgemm_kernel): an int8 weight element becomes (float)q * scale and is
// rounded to the compute dtype T before the product; products accumulate
// in fp32 (wmma bf16 m16n16k16 for T = bf16, fmaf for T = fp32, so no
// TF32), in K order, so a row's result does not depend on the other rows.
//
// Layout: A [R, K] (row stride lda, T), W [K, N] (WT = T or int8),
// scales [K, nb] fp32 with group width qblock = ceil(N / nb).  Rows of A
// past R and columns of W past N enter as zeros.  A chunk of A and of W
// arrive together by cp.async (.cg: through L2, as the megakernel writes
// A earlier in the same launch); each chunk's scales load into registers
// while its copies land.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dstile {

constexpr int BN = 64;        // output columns per tile
constexpr int BK = 64;        // K per pipeline chunk
constexpr int STAGES = 3;     // A and W chunks in flight
constexpr int NT = 256;       // threads per CTA (8 warps)
constexpr int RPMAX = 64;     // rows per tile (A padded to 16-row frags)
constexpr int PAD = 8;        // row pad (elements) of the T tiles
constexpr int CPAD = 4;       // row pad (floats) of the result tile

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
template <>
__device__ __forceinline__ int8_t from_f<int8_t>(float x) {
  return (int8_t)(int)x;
}

// round x through T (the reference's .astype(compute_dtype))
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// One int8 weight element as the product sees it: (float)q * scale,
// rounded to the compute dtype T (the reference's qgemm dequant and
// grouped_gemm.py _dequant_tile).  Every int8 GEMM of the port (qgemm,
// the fused layer, both int8 grouped GEMMs) dequantizes through this
// one function, so the scale math cannot diverge between them.
template <typename T>
__device__ __forceinline__ T dequant_w(float q, float scale) {
  return from_f<T>(q * scale);
}

// L2-only loads: data another CTA wrote earlier in this launch
template <typename T>
__device__ __forceinline__ T ldcg_t(const T* p);
template <>
__device__ __forceinline__ float ldcg_t<float>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ __nv_bfloat16 ldcg_t<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared-memory carve-up of one tile computation (bytes, 128-aligned):
// STAGES raw weight chunks and A chunks in flight, the chunk's weights
// in T (dequantized), the fp32 result tile
template <typename T, typename WT>
struct TileSmem {
  static constexpr size_t wstage = (size_t)BK * BN * sizeof(WT);
  static constexpr size_t astage = (size_t)RPMAX * (BK + PAD) * sizeof(T);
  static constexpr size_t as = STAGES * wstage;
  static constexpr size_t wt = as + STAGES * astage;
  static constexpr size_t ct = wt + (size_t)BK * (BN + PAD) * sizeof(T);
  static constexpr size_t bytes =
      ct + (size_t)RPMAX * (BN + CPAD) * sizeof(float);
};

// whether rows of a [rows, ld] matrix of E can stream as aligned 16-byte
// vectors
template <typename E>
__device__ __forceinline__ bool vec_ok(const void* p, int ld) {
  return ((size_t)ld * sizeof(E)) % 16 == 0 && (uintptr_t)p % 16 == 0;
}

// One pipeline chunk: W rows [kc0, kc0 + BK) x columns [n0, n0 + BN) into
// `wdst` and A rows [0, RP) x columns [kc0, kc0 + BK) into `adst`
// (row stride BK + PAD), as one cp.async group; what lies past k_end, N
// or R arrives as zeros.  Without 16-byte alignment the copies are
// element-wise loads (then complete when this returns).
template <typename T, typename WT>
__device__ __forceinline__ void load_chunk(
    WT* wdst, const WT* W, int N, int n0, T* adst, const T* A, int lda,
    int R, int RP, int kc0, int k_end, bool wvec, bool avec) {
  if (wvec) {
    constexpr int VEC = 16 / sizeof(WT);
    constexpr int VPR = BN / VEC;
    for (int v = threadIdx.x; v < BK * VPR; v += NT) {
      const int kk = v / VPR, vv = v % VPR;
      const int k = kc0 + kk, n = n0 + vv * VEC;
      const bool ok = k < k_end && n < N;   // N % VEC == 0: whole vectors
      cp_async16(wdst + kk * BN + vv * VEC,
                 ok ? (const void*)(W + (size_t)k * N + n) : (const void*)W,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * BN; e += NT) {
      const int kk = e / BN, nn = e % BN;
      const int k = kc0 + kk, n = n0 + nn;
      wdst[e] = (k < k_end && n < N) ? W[(size_t)k * N + n]
                                     : from_f<WT>(0.f);
    }
  }
  if (avec) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = BK / VEC;
    for (int v = threadIdx.x; v < RP * VPR; v += NT) {
      const int r = v / VPR, vv = v % VPR;
      const int k = kc0 + vv * VEC;
      const int valid = r < R ? min(VEC, k_end - k) : 0;
      cp_async16(adst + r * (BK + PAD) + vv * VEC,
                 valid > 0 ? (const void*)(A + (size_t)r * lda + k)
                           : (const void*)A,
                 valid > 0 ? valid * (int)sizeof(T) : 0);
    }
  } else {
    for (int e = threadIdx.x; e < RP * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int k = kc0 + kk;
      adst[r * (BK + PAD) + kk] = (r < R && k < k_end)
                                      ? ldcg_t<T>(A + (size_t)r * lda + k)
                                      : from_f<T>(0.f);
    }
  }
  cp_async_commit();
}

// C[r][n] (fp32, smem, row stride BN + CPAD) = sum over k in [k_begin,
// k_end) of A[r][k] * W~[k][n0 + n], r < R (<= RPMAX), n < BN.  Leaves
// the result in the returned smem tile after a __syncthreads.
template <typename T, typename WT>
__device__ float* tile_mma(const T* __restrict__ A, int lda, int R,
                           const WT* __restrict__ W,
                           const float* __restrict__ scales, int nb,
                           int qblock, int N, int n0, int k_begin,
                           int k_end, unsigned char* smem) {
  using S = TileSmem<T, WT>;
  constexpr bool kQuant = sizeof(WT) == 1;
  constexpr bool kTensorCore = sizeof(T) == 2;
  T* wt = reinterpret_cast<T*>(smem + S::wt);
  float* ct = reinterpret_cast<float*>(smem + S::ct);
  const int RP = ((R + 15) / 16) * 16;
  const int nch = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int warp = threadIdx.x >> 5;
  const bool wvec = vec_ok<WT>(W, N), avec = vec_ok<T>(A, lda);
  auto wstage = [&](int s) {
    return reinterpret_cast<WT*>(smem + (size_t)s * S::wstage);
  };
  auto astage = [&](int s) {
    return reinterpret_cast<T*>(smem + S::as + (size_t)s * S::astage);
  };
  // this thread converts weight column tid % BN at rows tid / BN +
  // (NT / BN) i of every chunk: one column, so one scale group
  static_assert(NT % BN == 0 && (BK * BN) % NT == 0, "tile split");
  constexpr int WPT = BK * BN / NT;
  const int nn = threadIdx.x % BN, kk0 = threadIdx.x / BN;
  const int n = n0 + nn;
  const int g = (kQuant && n < N) ? n / qblock : 0;

  // bf16: warp -> column fragment warp % 4, row fragments warp / 4 + 2 i
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      facc[2];
  // fp32: thread -> column tid % 64, rows tid / 64 + 4 i
  float acc[RPMAX / 4];
  if constexpr (kTensorCore) {
    nvcuda::wmma::fill_fragment(facc[0], 0.f);
    nvcuda::wmma::fill_fragment(facc[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < RPMAX / 4; ++i) acc[i] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch)
      load_chunk<T, WT>(wstage(s), W, N, n0, astage(s), A, lda, R, RP,
                        k_begin + s * BK, k_end, wvec, avec);
    else
      cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    const int nc = c + STAGES - 1;
    if (nc < nch)
      load_chunk<T, WT>(wstage(nc % STAGES), W, N, n0, astage(nc % STAGES),
                        A, lda, R, RP, k_begin + nc * BK, k_end, wvec, avec);
    else
      cp_async_commit();
    // the chunk's scales, in flight while the copies land
    float sv[WPT];
    if constexpr (kQuant) {
#pragma unroll
      for (int i = 0; i < WPT; ++i) {
        const int k = k_begin + c * BK + kk0 + (NT / BN) * i;
        sv[i] = (k < k_end && n < N) ? __ldg(scales + (size_t)k * nb + g)
                                     : 0.f;
      }
    }
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    // columns past N and rows past k_end arrived as zeros
    const WT* src = wstage(c % STAGES);
    const T* at = astage(c % STAGES);
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int kk = kk0 + (NT / BN) * i;
      const float w = to_f(src[kk * BN + nn]);
      if constexpr (kQuant)
        wt[kk * (BN + PAD) + nn] = dequant_w<T>(w, sv[i]);
      else
        wt[kk * (BN + PAD) + nn] = from_f<T>(w);
    }
    __syncthreads();
    if constexpr (kTensorCore) {
      using namespace nvcuda;
      const int cf = warp & 3;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(
            fb, reinterpret_cast<const __nv_bfloat16*>(wt) +
                    ks * 16 * (BN + PAD) + cf * 16,
            BN + PAD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rf = (warp >> 2) + 2 * i;
          if (rf * 16 < RP) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::load_matrix_sync(
                fa, reinterpret_cast<const __nv_bfloat16*>(at) +
                        rf * 16 * (BK + PAD) + ks * 16,
                BK + PAD);
            wmma::mma_sync(facc[i], fa, fb, facc[i]);
          }
        }
      }
    } else {
      const int col = threadIdx.x & (BN - 1);
      const int rg = threadIdx.x / BN;
      for (int kk = 0; kk < BK; ++kk) {
        const float w = to_f(wt[kk * (BN + PAD) + col]);
#pragma unroll
        for (int i = 0; i < RPMAX / 4; ++i) {
          const int r = rg + 4 * i;
          if (r < RP) acc[i] = fmaf(to_f(at[r * (BK + PAD) + kk]), w, acc[i]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if constexpr (kTensorCore) {
    using namespace nvcuda;
    const int cf = warp & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rf = (warp >> 2) + 2 * i;
      if (rf * 16 < RP)
        wmma::store_matrix_sync(ct + rf * 16 * (BN + CPAD) + cf * 16,
                                facc[i], BN + CPAD, wmma::mem_row_major);
    }
  } else {
    const int col = threadIdx.x & (BN - 1);
    const int rg = threadIdx.x / BN;
#pragma unroll
    for (int i = 0; i < RPMAX / 4; ++i) {
      const int r = rg + 4 * i;
      if (r < RP) ct[r * (BN + CPAD) + col] = acc[i];
    }
  }
  __syncthreads();
  return ct;
}

// ---- the decode shape: R <= RROWS rows against a streamed weight
//
// A [64-row tile x 64 columns] spends most of its time on rows that are
// not there when R = 8, and its per-chunk barriers leave few bytes in
// flight.  For R <= RROWS, rows_mma streams W row by row instead: warp w
// reads weight rows k_begin + w, + kWarps, ..., lane l owns the 8
// columns n0 + 8 l .. + 7 of each (8 bytes int8, 16 bf16, 32 fp32).
// Each warp keeps a private cp.async ring of RSTAGES rounds of RU rows
// (and their scales): the copies are in flight together whatever the
// compiler schedules, up to 8 KB a warp, which is what keeps HBM busy
// with one CTA per SM.  A stages in shared memory as fp32
// [k][RROWS], so a weight row meets its 8 A values in two broadcast
// float4 loads; the element is dequantized and rounded to T as in
// tile_mma, then 8 fmaf (fp32 accumulation, products of T values
// exact).  The warps' partial sums add up in warp order through shared
// memory, so a row's result depends only on N, K and the K range, not
// on the other rows.
constexpr int RROWS = 8;      // rows of the decode path
constexpr int RBN = 256;      // its output columns per tile (32 lanes x 8)
constexpr int RKS = 2048;     // K rows of A staged per pass
constexpr int RSTAGES = 4;    // rounds of RU weight rows in flight a warp
static_assert(RKS * RROWS == (NT / 32) * RROWS * RBN,
              "the A stage and the warp partials share one region");

// shared-memory carve-up of rows_mma (bytes): the A stage (reused for the
// warp partials), each warp's weight ring [RSTAGES][RU][32 lanes][8 WT]
// and, for int8 weights, its scale ring [RSTAGES][RU][32 lanes]
template <typename WT>
struct RowsSmem {
  static constexpr int RU = 64 / (8 * (int)sizeof(WT));   // rows a round
  static constexpr size_t lane_bytes = 8 * sizeof(WT);
  static constexpr size_t w = (size_t)RKS * RROWS * sizeof(float);
  static constexpr size_t wwarp = (size_t)RSTAGES * RU * 32 * lane_bytes;
  static constexpr size_t s = w + (NT / 32) * wwarp;
  static constexpr size_t swarp =
      sizeof(WT) == 1 ? (size_t)RSTAGES * RU * 32 * sizeof(float) : 0;
  static constexpr size_t bytes = s + (NT / 32) * swarp;
};

// sum over s < nsplit (<= MAXS) of p[s * stride], in s order: the loads
// issue together (a chain of dependent L2 loads would cost one L2
// latency per split); the zeros past nsplit leave the sum unchanged
template <int MAXS>
__device__ __forceinline__ float sum_splits(const float* p, size_t stride,
                                            int nsplit) {
  float v[MAXS];
#pragma unroll
  for (int s = 0; s < MAXS; ++s)
    v[s] = s < nsplit ? __ldcg(p + s * stride) : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < MAXS; ++s) acc += v[s];
  return acc;
}

// whether an [R x K] @ [K x N] product (nb scale groups, 0 for float
// weights) takes rows_mma: the decode shape, with groups of at least 8
// columns so that a lane's 8 columns meet at most two of them
__host__ __device__ inline bool use_rows(int R, int N, int nb) {
  return R <= RROWS && (nb == 0 || (N + nb - 1) / nb >= 8);
}

// 4- and 8-byte asynchronous copies (through L1: .cg takes 16 bytes only)
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem,
                                            int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES), "r"(src_bytes));
}

// one weight row's 8 values of a lane, from its ring slot, as fp32
template <typename WT>
__device__ __forceinline__ void unpack8(const unsigned char* slot, float* w) {
  if constexpr (sizeof(WT) == 1) {
    const uint2 v = *reinterpret_cast<const uint2*>(slot);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      w[c] = (float)(int8_t)((c < 4 ? v.x : v.y) >> (8 * (c & 3)));
  } else if constexpr (sizeof(WT) == 2) {
    const uint4 v = *reinterpret_cast<const uint4*>(slot);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 8; ++c)
      w[c] = __bfloat162float(__ushort_as_bfloat16(
          (unsigned short)(words[c >> 1] >> (16 * (c & 1)))));
  } else {
    const float4 a = reinterpret_cast<const float4*>(slot)[0];
    const float4 b = reinterpret_cast<const float4*>(slot)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
}

// C[r][n] (fp32, smem, row stride RBN) = sum over k in [k_begin, k_end)
// of A[r][k] * W~[k][n0 + n], r < R <= RROWS, n < RBN.  Same arguments
// as tile_mma; needs RowsSmem<WT>::bytes of smem.  Leaves the result in
// the returned smem tile after a __syncthreads.
template <typename T, typename WT>
__device__ float* rows_mma(const T* __restrict__ A, int lda, int R,
                           const WT* __restrict__ W,
                           const float* __restrict__ scales, int nb,
                           int qblock, int N, int n0, int k_begin,
                           int k_end, unsigned char* smem) {
  using S = RowsSmem<WT>;
  constexpr bool kQuant = sizeof(WT) == 1;
  constexpr int kW = NT / 32, RU = S::RU;
  constexpr int LB = (int)S::lane_bytes;
  float* as = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wring = smem + S::w + warp * S::wwarp;
  float* sring = reinterpret_cast<float*>(smem + S::s + warp * S::swarp);
  const int n = n0 + lane * 8;
  const int valid = N - n;
  // lanes with 8 whole, aligned columns copy them asynchronously; a lane
  // at a ragged edge (or an unaligned W) loads element by element
  const bool fast = valid >= 8 && N % 8 == 0 &&
                    (uintptr_t)W % (sizeof(WT) == 1 ? 8 : 16) == 0;
  // the lane's 8 columns span scale groups g0 and g1 (equal unless a
  // group edge falls inside); bit c of `hi` marks columns of g1
  int g0 = 0, g1 = 0;
  unsigned hi = 0;
  if (kQuant && valid > 0) {
    g0 = n / qblock;
    g1 = min(n + 7, N - 1) / qblock;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < valid && (n + c) / qblock != g0) hi |= 1u << c;
  }
  float acc[RROWS][8];
#pragma unroll
  for (int r = 0; r < RROWS; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int kp = k_begin; kp < k_end; kp += RKS) {
    const int kn = min(RKS, k_end - kp);
    // round i of this warp: rows warp + (i RU + u) kW, u < RU, into ring
    // stage i % RSTAGES (rows past kn arrive as zeros), one commit group
    auto issue = [&](int i) {
      const int st = i % RSTAGES;
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int kk = warp + (i * RU + u) * kW;
        const bool in = kk < kn;
        const size_t k = (size_t)kp + (in ? kk : 0);
        const int slot = (st * RU + u) * 32 + lane;
        if (fast) {
          unsigned char* d = wring + (size_t)slot * LB;
          const WT* src = W + k * N + n;
          if constexpr (LB == 8) {
            cp_async_ca<8>(d, src, in ? 8 : 0);
          } else {
            cp_async16(d, src, in ? 16 : 0);
            if constexpr (LB == 32) cp_async16(d + 16, src + 4, in ? 16 : 0);
          }
        }
        if (kQuant && valid > 0)
          cp_async_ca<4>(sring + slot, scales + k * nb + g0, in ? 4 : 0);
      }
      cp_async_commit();
    };
    const int mine = warp < kn ? (kn - warp + kW - 1) / kW : 0;
    const int rounds = (mine + RU - 1) / RU;
    __syncthreads();   // the previous pass (or caller) is done with smem
#pragma unroll
    for (int i = 0; i < RSTAGES - 1; ++i) issue(i);
    // A rows [0, R) x [kp, kp + kn) -> as[kk][r] in fp32 (zeros past R),
    // kAPer values a thread at a time with their loads issued together
    constexpr int kAPer = 8;
    for (int e0 = threadIdx.x; e0 < RROWS * kn; e0 += kAPer * NT) {
      float v[kAPer];
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        const int e = e0 + j * NT;
        const int r = e / kn, kk = e - r * kn;
        v[j] = e < RROWS * kn && r < R
                   ? to_f(ldcg_t<T>(A + (size_t)r * lda + kp + kk))
                   : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        const int e = e0 + j * NT;
        const int r = e / kn, kk = e - r * kn;
        if (e < RROWS * kn) as[kk * RROWS + r] = v[j];
      }
    }
    __syncthreads();
    for (int i = 0; i < rounds; ++i) {
      issue(i + RSTAGES - 1);
      cp_async_wait<RSTAGES - 1>();   // round i has landed
      const int st = i % RSTAGES;
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int kk = warp + (i * RU + u) * kW;
        if (kk < kn) {
          const size_t k = (size_t)kp + kk;
          const int slot = (st * RU + u) * 32 + lane;
          float w[8];
          if (fast) {
            unpack8<WT>(wring + (size_t)slot * LB, w);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              w[c] = c < valid ? to_f(W[k * N + n + c]) : 0.f;
          }
          if constexpr (kQuant) {
            const float s0 = valid > 0 ? sring[slot] : 0.f;
            const float s1 = hi ? __ldg(scales + k * nb + g1) : s0;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              w[c] = to_f(dequant_w<T>(w[c], ((hi >> c) & 1u) ? s1 : s0));
          }
          const float4 a0 = *reinterpret_cast<const float4*>(as + kk * RROWS);
          const float4 a1 =
              *reinterpret_cast<const float4*>(as + kk * RROWS + 4);
          const float a[RROWS] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int r = 0; r < RROWS; ++r)
              acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
        }
      }
    }
    cp_async_wait<0>();
  }
  // the warps' partials, [kW][RROWS][RBN], summed in warp order in place
  __syncthreads();
  float* red = as;
#pragma unroll
  for (int r = 0; r < RROWS; ++r) {
    float4* p = reinterpret_cast<float4*>(
        red + ((size_t)warp * RROWS + r) * RBN + lane * 8);
    p[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    p[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * RBN; e += NT) {
    float s = red[e];
    for (int w = 1; w < kW; ++w) s += red[(size_t)w * RROWS * RBN + e];
    red[e] = s;
  }
  __syncthreads();
  return red;
}

// Multiprocessors of the current device (cached per device; 0 on error),
// for the launchers' split-K choice.
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return cached[dev];
}

}  // namespace dstile
