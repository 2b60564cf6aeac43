// Grouped GEMM for routed experts: rows against the stacked expert
// weights w [E, K, N] (bf16 or fp32, the rows' dtype), fp32 accumulation,
// output in the rows' dtype.  Two forward kernels, each with an
// int8-expert form, and the float backward pair:
//
// ds_ggemm — replaces deepspeed_tpu/ops/pallas/grouped_gemm.py
// _ggemm_kernel (:163, the forward form).  x [Mp, K] holds the routed
// rows sorted by expert and padded per expert to 64-row tiles (the
// wrapper's GroupPlan); M-tile i contracts against w[block_group_ids[i]],
// which the CTA loads itself.  One CTA per (M-tile, 64-column N-tile),
// the K loop inside the CTA (the Pallas grid's sequential K axis and its
// VMEM accumulator become layout_tile below: a cp.async ring of [64 x
// 64] chunks, wmma bf16 m16n16k16 or fmaf for fp32, no TF32).
// tile_rows[i] real rows are a prefix of the tile: the CTA loads only
// those, and a tile with none (an empty expert's tile, a trailing tile
// past the last group) writes zeros without a fetch, as the Pallas
// kernel's product over zero rows does.  M-tiles vary fastest in the
// grid, so the CTAs in flight share their weight columns in L2.
// What bounds it on an H100: at a long prefill (R = 1800 routed rows of
// a 900-token prompt, K 4096, N 14336) the distinct experts' weights,
// 0.94 GB (0.28 ms at 3.35 TB/s), against 211 GFLOP on the real rows
// (0.21 ms at 989 TFLOP/s): bytes and operations within a factor 1.3.
//
// ds_ggemm_slots — replaces grouped_gemm.py _slot_kernel (:433).  x
// [R <= 128, K] holds the raw routed rows (no padding).  The Pallas
// kernel walks slots innermost in a sequential grid and carries its
// accumulator across them; here each CTA owns a 128-column N-tile and a
// K range and loops over the slots itself.  For a valid slot s it
// streams w[active[s]]'s K x 128 tile once (a cp.async ring) and computes
// only the rows routed to that expert — row_order[slot_offsets[s] ..
// slot_offsets[s + 1]), gathered straight from x — with mma.sync
// m16n8k16 for bf16 (fmaf for fp32).  Every row belongs to exactly one
// slot, so a row's product comes from its own expert alone, and rows of
// other experts never enter it (the Pallas kernel's select).  A slot with
// valid == 0 (a repeated trailing id) is skipped without a fetch.  A
// skinny N leaves too few tiles for 132 SMs, so K splits across up to
// kSlotMaxSplit CTAs per tile; each writes an fp32 partial to a
// workspace and the last to arrive (an int atomic per tile, returned to
// 0 by that CTA) sums the partials in split order: no float atomics, the
// same bits every run, and the split depends only on N and K, so a row's
// result does not depend on the other rows.
// What bounds it: bytes.  At decode (batch 8, R = 16, ~8 distinct
// experts) one gate or in launch streams <= 8 x 4096 x 14336 x 2 B =
// 0.94 GB, 0.28 ms at 3.35 TB/s; its products are ~2 flops per weight
// byte.
//
// int8 experts (ds_ggemm_q, ds_ggemm_slots_q) — replace _ggemm_q_kernel
// (:200) and _slot_q_kernel (:452) under fp32 rows and for the bf16
// shapes the streaming kernels of csrc/grouped_gemm_stream.cu do not take
// (ops/kernels/grouped_gemm.py stream_route_q; none on the main paths).
// The same two kernels, instantiated
// with int8 weights q [E, K, N] and fp32 scales s [E, K, nb] in the
// block_quantize_int8 layout (group width qblock = ceil(N / nb) of the
// unpadded N).  Each weight element becomes dequant_w<T>(q, scale)
// (csrc/gemm_tile.cuh: (float)q * scale rounded to x's dtype, the
// reference's _dequant_tile) before its product; products accumulate in
// fp32 and the output rounds once to x's dtype.  ds_ggemm_q is
// ds_ggemm's CTA driving qgemm's int8 tile path (csrc/gemm_tile.cuh
// tile_mma<T, int8_t>, the expert's scales at s + e K nb).
// ds_ggemm_slots_q keeps the slot
// kernel's CTA layout; its cp.async ring carries the int8 [128 x 128]
// weight stage (16 KB, the bf16 stage's bytes at twice the K) and that
// stage's scale rows (the at most kSlotSG groups the 128 columns meet).
// For bf16 rows each warp dequantizes its 16 columns straight into the
// mma.sync m16n8k16 B fragments (the layout ldmatrix.trans gives the float
// kernel), so every weight of the stage is dequantized once per CTA, by
// one thread, with no extra shared-memory pass or barrier; for fp32 rows
// the CTA dequantizes the stage once into an fp32 tile that feeds fmaf,
// over the whole K in one range (no K split): each row is one fmaf chain
// in ascending K, as tile_mma's fp32 path sums it, so a row of the fp32
// slot form equals that row of ds_ggemm_q's fp32 form bit for bit (the
// parity path, not tuned).  No per-row dequantization in either.
// What bounds them: bytes, as the float forms, at half the weight bytes:
// a decode step's gate/in slot launch (batch 8, R 16 over 8 experts)
// streams 8 x 4096 x 14336 int8 codes + 7.3 MB of scales, 0.142 ms at
// 3.35 TB/s.
//
// The backward (ds_ggemm_t, ds_tgmm) — replaces _ggemm_kernel's
// transposed-RHS form (:163, transpose_rhs=True) and _tgmm_kernel
// (:222), the pair _ggemm_diff's VJP (:580-605) runs.  Both are one
// [64 x 64] wmma / fmaf tile over a 64-wide contraction walked in order
// (layout_tile below), each operand staged in its own memory layout and
// read by a fragment of that layout, so neither the expert stack nor the
// rows are ever transposed in memory.  ds_ggemm_t: dx [Mp, K] = dy
// [Mp, N] W[e]^T, one CTA per (M-tile, 64 columns of K), the loop over N
// inside; W[e]'s rows k0 .. k0 + 63 are read in place as a column-major
// B.  ds_tgmm: dW[e] [K, N] = the sum over expert e's rows of x_row^T
// dy_row, one CTA per (64 x 64 output tile, expert), the loop over the
// expert's contiguous run of rows inside (the Pallas kernel carries its
// accumulator across that run in a sequential grid and flushes on group
// change; here one CTA owns the whole run, so nothing crosses CTAs and
// no float atomic is needed: the same bits every run).  An expert with
// no rows writes zeros.
// What bounds them: operations.  At mixtral:1b-moe's training shape (R
// 16,384 routed rows, K 1024, N 3584) each does 2 R K N = 1.20e11 flop,
// 0.122 ms at 989 TFLOP/s, against ~214 MB moved (0.064 ms at 3.35
// TB/s).
//
// Which launches reach this file's float kernels: the bf16 forward, dx
// and dW of shapes whose K and N are multiples of 8 (on 16-byte aligned
// bases) run on the persistent wgmma / TMA kernels of
// csrc/grouped_gemm_hopper.cu instead, chosen by shape in the wrapper
// (ops/kernels/grouped_gemm.py hopper_route).  layout_tile serves the fp32
// forms (fmaf, no TF32 rounding) and the bf16 shapes TMA cannot address.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch as an int.
#include <type_traits>

#include "gemm_tile.cuh"

namespace {

using namespace dstile;

// ------------------------------------------------------- layout_tile
// The float forward and the backward's two forms share layout_tile: one
// CTA's [64 x 64] fp32 tile C(i, j) = sum over c < nc of A(i, c) B(c,
// j), each operand staged in its own memory layout (16-byte cp.async rows
// along the contiguous dim, a 3-deep ring for bf16) and read by wmma
// fragments of the matching layout, so no operand is transposed in
// memory and no weight chunk takes a second shared-memory pass:
//   A(i, c) = A_COL ? a[c lda + i] : a[i lda + c]
//   B(c, j) = B_COL ? b[j ldb + c] : b[c ldb + j]
// bf16: wmma m16n16k16 (fp32 accumulation); fp32: fmaf, no TF32.  The
// contraction walks in 64-wide chunks in order, so an output element's
// sum does not depend on the other rows of its tile.
constexpr int kBT = 64;    // tile rows, columns and contraction chunk
constexpr int kBPad = 8;   // row pad (elements) of a staged chunk
static_assert(kBT == RPMAX && kBT == BN, "the plan's tile is 64 rows");

template <typename T>
struct LayoutSmem {
  static constexpr int ST = sizeof(T) == 2 ? 3 : 2;   // chunks in flight
  static constexpr int LD = kBT + kBPad;
  static constexpr size_t chunk = (size_t)kBT * LD * sizeof(T);
  static constexpr size_t ct = 2 * ST * chunk;        // A, B per stage
  static constexpr size_t bytes =
      ct + (size_t)kBT * (kBT + CPAD) * sizeof(float);
};

// rows [0, kBT) x columns [0, kBT) of a row-major matrix at src (row
// stride ld) -> dst (row stride LayoutSmem::LD); rows past nrow and columns
// past ncol arrive as zeros.  No commit: the caller commits the group.
// Without 16-byte alignment the copies are element-wise loads (then
// complete when this returns).
template <typename T>
__device__ __forceinline__ void layout_load(T* dst, const T* __restrict__ src,
                                         size_t ld, int nrow, int ncol,
                                         bool vec) {
  constexpr int LD = LayoutSmem<T>::LD;
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = kBT / VEC;
    for (int v = threadIdx.x; v < kBT * VPR; v += NT) {
      const int r = v / VPR, c = (v - r * VPR) * VEC;
      const int valid = r < nrow ? min(VEC, ncol - c) : 0;
      cp_async16(dst + r * LD + c,
                 valid > 0 ? (const void*)(src + r * ld + c)
                           : (const void*)src,
                 valid > 0 ? valid * (int)sizeof(T) : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBT * kBT; i += NT) {
      const int r = i / kBT, c = i - r * kBT;
      dst[r * LD + c] =
          (r < nrow && c < ncol) ? src[r * ld + c] : from_f<T>(0.f);
    }
  }
}

// C over i < ni, j < nj (<= kBT) and the contraction c < nc (above);
// rows of A past ni and columns of B past nj are zeros.  Leaves the
// result in the returned smem tile (row stride kBT + CPAD) after a
// __syncthreads.
template <typename T, bool A_COL, bool B_COL>
__device__ float* layout_tile(const T* __restrict__ a, size_t lda, int ni,
                           const T* __restrict__ b, size_t ldb, int nj,
                           int nc, unsigned char* smem) {
  using S = LayoutSmem<T>;
  constexpr int LD = S::LD, ST = S::ST;
  constexpr bool kTensorCore = sizeof(T) == 2;
  float* ct = reinterpret_cast<float*>(smem + S::ct);
  const int RP = ((min(ni, kBT) + 15) / 16) * 16;
  const int nch = nc > 0 ? (nc + kBT - 1) / kBT : 0;
  const int warp = threadIdx.x >> 5;
  const bool avec = vec_ok<T>(a, (int)lda), bvec = vec_ok<T>(b, (int)ldb);
  auto achunk = [&](int s) {
    return reinterpret_cast<T*>(smem + (size_t)(2 * s) * S::chunk);
  };
  auto bchunk = [&](int s) {
    return reinterpret_cast<T*>(smem + (size_t)(2 * s + 1) * S::chunk);
  };
  // chunk ch (contraction [64 ch, 64 ch + 64)) into stage s, one group
  auto load = [&](int s, int ch) {
    const int c0 = ch * kBT, cn = nc - c0;
    if constexpr (A_COL)
      layout_load<T>(achunk(s), a + (size_t)c0 * lda, lda, cn, ni, avec);
    else
      layout_load<T>(achunk(s), a + c0, lda, ni, cn, avec);
    if constexpr (B_COL)
      layout_load<T>(bchunk(s), b + c0, ldb, nj, cn, bvec);
    else
      layout_load<T>(bchunk(s), b + (size_t)c0 * ldb, ldb, cn, nj, bvec);
    cp_async_commit();
  };

  // bf16: warp -> column fragment warp % 4, row fragments warp / 4 + 2 i
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      facc[2];
  // fp32: thread -> column tid % 64, rows tid / 64 + 4 i
  float acc[kBT / 4];
  if constexpr (kTensorCore) {
    nvcuda::wmma::fill_fragment(facc[0], 0.f);
    nvcuda::wmma::fill_fragment(facc[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < kBT / 4; ++i) acc[i] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nch)
      load(s, s);
    else
      cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    const int nx = ch + ST - 1;
    if (nx < nch)
      load(nx % ST, nx);
    else
      cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();
    const T* as = achunk(ch % ST);
    const T* bs = bchunk(ch % ST);
    if constexpr (kTensorCore) {
      using namespace nvcuda;
      using AL = std::conditional_t<A_COL, wmma::col_major, wmma::row_major>;
      using BL = std::conditional_t<B_COL, wmma::col_major, wmma::row_major>;
      const __nv_bfloat16* ab = reinterpret_cast<const __nv_bfloat16*>(as);
      const __nv_bfloat16* bb = reinterpret_cast<const __nv_bfloat16*>(bs);
      const int cf = warp & 3;
#pragma unroll
      for (int ks = 0; ks < kBT / 16; ++ks) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BL> fb;
        wmma::load_matrix_sync(
            fb, bb + (B_COL ? cf * 16 * LD + ks * 16 : ks * 16 * LD + cf * 16),
            LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rf = (warp >> 2) + 2 * i;
          if (rf * 16 < RP) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, AL> fa;
            wmma::load_matrix_sync(
                fa,
                ab + (A_COL ? ks * 16 * LD + rf * 16 : rf * 16 * LD + ks * 16),
                LD);
            wmma::mma_sync(facc[i], fa, fb, facc[i]);
          }
        }
      }
    } else {
      const int col = threadIdx.x & (kBT - 1);
      const int rg = threadIdx.x / kBT;
      for (int kk = 0; kk < kBT; ++kk) {
        const float bv = to_f(B_COL ? bs[col * LD + kk] : bs[kk * LD + col]);
#pragma unroll
        for (int i = 0; i < kBT / 4; ++i) {
          const int r = rg + 4 * i;
          if (r < RP)
            acc[i] = fmaf(to_f(A_COL ? as[kk * LD + r] : as[r * LD + kk]), bv,
                          acc[i]);
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
        wmma::store_matrix_sync(ct + rf * 16 * (kBT + CPAD) + cf * 16,
                                facc[i], kBT + CPAD, wmma::mem_row_major);
    }
  } else {
    const int col = threadIdx.x & (kBT - 1);
    const int rg = threadIdx.x / kBT;
#pragma unroll
    for (int i = 0; i < kBT / 4; ++i) {
      const int r = rg + 4 * i;
      if (r < RP) ct[r * (kBT + CPAD) + col] = acc[i];
    }
  }
  __syncthreads();
  return ct;
}

// ------------------------------------------------------ ds_ggemm(_q)
// grid (num M-tiles, N / BN); the plan's tile is RPMAX = 64 rows.  WT =
// T: float experts (scales null), through layout_tile (x and W[e] both
// row-major); WT = int8_t: int8 experts with scales s [E, K, nb], group
// width qblock, through tile_mma's dequantizing pass.  Both sum a row's
// products in the same order (64-wide K chunks, 16-wide wmma steps or
// fmaf, in order), so the float result is tile_mma's to the bit.
template <typename T, typename WT>
__global__ void __launch_bounds__(NT)
ggemm_kernel(const T* __restrict__ x, const WT* __restrict__ w,
             const float* __restrict__ s, const int* __restrict__ gids,
             const int* __restrict__ tile_rows, T* __restrict__ out, int K,
             int N, int E, int nb, int qblock) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int mt = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const size_t m0 = (size_t)mt * RPMAX;
  const int e = gids[mt];
  const int R = (e >= 0 && e < E) ? min(max(tile_rows[mt], 0), RPMAX) : 0;
  const float* ct = nullptr;
  if (R > 0) {   // uniform over the CTA
    if constexpr (sizeof(WT) == sizeof(T))
      ct = layout_tile<T, false, false>(x + m0 * K, K, R,
                                        w + (size_t)e * K * N + n0, N,
                                        min(BN, N - n0), K, smem);
    else
      ct = tile_mma<T, WT>(x + m0 * K, K, R, w + (size_t)e * K * N,
                           s + (size_t)e * K * nb, nb, qblock, N, n0, 0, K,
                           smem);
  }
  for (int i = threadIdx.x; i < RPMAX * BN; i += NT) {
    const int r = i / BN, n = i - r * BN;
    if (n0 + n < N)
      out[(m0 + r) * N + n0 + n] =
          r < R ? from_f<T>(ct[r * (BN + CPAD) + n]) : from_f<T>(0.f);
  }
}

template <typename T, typename WT>
cudaError_t launch_ggemm(const void* x, const void* w, const float* s,
                         const int* gids, const int* tile_rows, void* out,
                         int nblocks, int K, int N, int E, int nb,
                         cudaStream_t stream) {
  const size_t smem = sizeof(WT) == sizeof(T) ? LayoutSmem<T>::bytes
                                              : TileSmem<T, WT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ggemm_kernel<T, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int qblock = nb > 0 ? (N + nb - 1) / nb : 1;
  const dim3 grid(nblocks, (N + BN - 1) / BN);
  ggemm_kernel<T, WT><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const WT*>(w), s, gids,
      tile_rows, static_cast<T*>(out), K, N, E, nb, qblock);
  return cudaGetLastError();
}

// ---------------------------------------------------- ds_ggemm_slots(_q)
constexpr int kSlotBN = 128;      // output columns per CTA
constexpr int kSlotRows = 64;     // rows per pass (four m16 fragments)
constexpr int kSlotMaxSplit = 16;
constexpr int kSlotPad = 8;       // row pad (elements) of the T tiles
constexpr int kSlotSG = 4;        // int8: scale groups a column tile meets
static_assert(NT / 32 * 16 == kSlotBN, "a warp owns 16 columns");

// shared-memory carve-up (bytes) and K per pipeline stage (BK): ST raw
// weight stages (WT, rows padded to a 16-byte multiple), ST A stages, for
// int8 ST scale stages [BK][kSlotSG], for int8 weights with fp32 rows the
// stage's dequantized fp32 tile, the row ids.  int8 weights with bf16
// rows take BK = 128 (a 16 KB stage, as bf16's at 64) and dequantize in
// registers as the mma B fragments are built (no tile).
template <typename T, typename WT>
struct SlotSmem {
  static constexpr bool kQuant = sizeof(WT) == 1;
  static constexpr bool kTile = kQuant && sizeof(T) == 4;
  static constexpr int BK = kQuant && sizeof(T) == 2 ? 128 : 64;
  static constexpr int ST = sizeof(T) == 2 ? 4 : 3;   // stages in flight
  static constexpr int LDW = kSlotBN + (kQuant ? 16 : kSlotPad);
  static constexpr int LDA = BK + kSlotPad;
  static constexpr int LDT = kSlotBN + kSlotPad;   // float weights' stride
  static constexpr size_t wstage = (size_t)BK * LDW * sizeof(WT);
  static constexpr size_t astage = (size_t)kSlotRows * LDA * sizeof(T);
  static constexpr size_t sstage =
      kQuant ? (size_t)BK * kSlotSG * sizeof(float) : 0;
  static constexpr size_t a = ST * wstage;
  static constexpr size_t s = a + ST * astage;
  static constexpr size_t t = s + ST * sstage;
  static constexpr size_t idx =
      t + (kTile ? (size_t)BK * LDT * sizeof(T) : 0);
  static constexpr size_t bytes = idx + kSlotRows * sizeof(int);
  static_assert(kQuant || LDW == LDT, "float weights feed mma in place");
  static_assert(BK % (NT / 32) == 0, "the fp32 dequant pass's rows");
};

// one stage: W rows [kc0, kc0 + BK) x columns [n0, n0 + kSlotBN), for
// int8 the scales of those rows at groups [g0, g0 + kSlotSG), and the
// rows idx[r < nrow] of x at columns [kc0, kc0 + BK), rows [nrow,
// nrow_pad) as zeros, as one cp.async group; what lies past k_end, N or
// nb arrives as zeros (element-wise loads where 16-byte vectors do not
// fit, complete when this returns)
template <typename T, typename WT>
__device__ __forceinline__ void slot_load(
    WT* wdst, const WT* __restrict__ W, int N, int n0, float* sdst,
    const float* __restrict__ S, int nb, int g0, T* adst,
    const T* __restrict__ x, int K, const int* idx, int nrow, int nrow_pad,
    int kc0, int k_end, bool wvec, bool avec) {
  using SM = SlotSmem<T, WT>;
  constexpr int BK = SM::BK;
  if (wvec) {
    constexpr int VEC = 16 / sizeof(WT);
    constexpr int VPR = kSlotBN / VEC;
    for (int v = threadIdx.x; v < BK * VPR; v += NT) {
      const int kk = v / VPR, vv = v - kk * VPR;
      const int k = kc0 + kk, n = n0 + vv * VEC;
      const bool ok = k < k_end && n < N;   // N % VEC == 0: whole vectors
      cp_async16(wdst + kk * SM::LDW + vv * VEC,
                 ok ? (const void*)(W + (size_t)k * N + n) : (const void*)W,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BK * kSlotBN; i += NT) {
      const int kk = i / kSlotBN, nn = i - kk * kSlotBN;
      const int k = kc0 + kk, n = n0 + nn;
      wdst[kk * SM::LDW + nn] =
          (k < k_end && n < N) ? W[(size_t)k * N + n] : from_f<WT>(0.f);
    }
  }
  if constexpr (SM::kQuant) {
    for (int v = threadIdx.x; v < BK * kSlotSG; v += NT) {
      const int kk = v / kSlotSG, j = v - kk * kSlotSG;
      const int k = kc0 + kk, g = g0 + j;
      const bool ok = k < k_end && g < nb;
      cp_async_ca<4>(sdst + v,
                     ok ? (const void*)(S + (size_t)k * nb + g)
                        : (const void*)S,
                     ok ? 4 : 0);
    }
  }
  constexpr int VEC = 16 / sizeof(T);
  if (avec) {
    constexpr int VPR = BK / VEC;
    for (int v = threadIdx.x; v < nrow_pad * VPR; v += NT) {
      const int r = v / VPR, vv = v - r * VPR;
      const int k = kc0 + vv * VEC;
      const int valid = r < nrow ? min(VEC, k_end - k) : 0;
      cp_async16(adst + r * SM::LDA + vv * VEC,
                 valid > 0 ? (const void*)(x + (size_t)idx[r] * K + k)
                           : (const void*)x,
                 valid > 0 ? valid * (int)sizeof(T) : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrow_pad * BK; i += NT) {
      const int r = i / BK, kk = i - r * BK;
      const int k = kc0 + kk;
      adst[r * SM::LDA + kk] = (r < nrow && k < k_end)
                                   ? x[(size_t)idx[r] * K + k]
                                   : from_f<T>(0.f);
    }
  }
  cp_async_commit();
}

// int8 weights, fp32 rows: the landed stage's [BK x kSlotBN] codes and
// scales -> the dequantized fp32 tile (row stride LDT), each weight once.
// Thread t owns the 4 columns 4 (t % 32) .. + 3 (scale group offsets gi,
// fixed for the CTA) of rows t / 32 + 8 i: one 32-bit word of codes a row.
__device__ __forceinline__ void slot_dequant(float* wt, const int8_t* wq,
                                             const float* ss,
                                             const int* gi) {
  using SM = SlotSmem<float, int8_t>;
  const int c4 = threadIdx.x & 31, kr0 = threadIdx.x >> 5;
#pragma unroll 4
  for (int i = 0; i < SM::BK / (NT / 32); ++i) {
    const int kk = kr0 + (NT / 32) * i;
    const unsigned word =
        *reinterpret_cast<const unsigned*>(wq + kk * SM::LDW + c4 * 4);
    const float* sr = ss + kk * kSlotSG;
    float* dst = wt + kk * SM::LDT + c4 * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dst[c] = dequant_w<float>((float)(int8_t)(word >> (8 * c)),
                                sr[gi[c]]);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p,
                                        bool trans) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

// int8 weights, bf16 rows: the warp's two n8 B fragments of k block ks,
// dequantized from the int8 stage in registers, in the layout
// ldmatrix.trans gives the float kernel (b[2 jn + h] holds rows ks 16 +
// 8 h + 2 (lane % 4) and + 1 of column warp 16 + 8 jn + lane / 4, whose
// scale group offset is gj[jn]).  Each weight of the stage is
// dequantized by exactly one thread of the CTA.
__device__ __forceinline__ void slot_bfrag_q(unsigned* b, const int8_t* wq,
                                             const float* ss, int ks,
                                             int warp, int lane,
                                             const int* gj) {
  using SM = SlotSmem<__nv_bfloat16, int8_t>;
  const int t = lane & 3, g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = ks * 16 + 8 * h + 2 * t;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int n = warp * 16 + jn * 8 + g;
      __nv_bfloat162 v;
      v.x = dequant_w<__nv_bfloat16>((float)wq[k * SM::LDW + n],
                                     ss[k * kSlotSG + gj[jn]]);
      v.y = dequant_w<__nv_bfloat16>((float)wq[(k + 1) * SM::LDW + n],
                                     ss[(k + 1) * kSlotSG + gj[jn]]);
      b[2 * jn + h] = *reinterpret_cast<const unsigned*>(&v);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the pass's result for row r < nrow (position in the pass), column n of
// the tile: straight to out (no K split) or to this split's workspace
template <typename T>
__device__ __forceinline__ void slot_store(
    T* __restrict__ out, float* __restrict__ wsp, const int* idx, int r,
    int nrow, int n, int N, int R, int split, int nsplit, float v) {
  if (r >= nrow || n >= N) return;
  const size_t row = (size_t)idx[r];
  if (nsplit == 1)
    out[row * N + n] = from_f<T>(v);
  else
    wsp[((size_t)split * R + row) * N + n] = v;
}

// grid (N / kSlotBN, nsplit), K split in `kper` rows (a BK multiple);
// int8 experts under fp32 rows: grid (N / kSlotBN, S), the whole K, one
// slot a CTA (a row is one slot's).  WT = T: float experts (scales null);
// WT = int8_t: int8 experts with scales s [E, K, nb], group width qblock.
template <typename T, typename WT>
__global__ void __launch_bounds__(NT)
slot_kernel(const T* __restrict__ x, const WT* __restrict__ w,
            const float* __restrict__ scales,
            const int* __restrict__ active, const int* __restrict__ valid,
            const int* __restrict__ order, const int* __restrict__ offs,
            T* __restrict__ out, float* __restrict__ wsp,
            int* __restrict__ counters, int R, int K, int N, int E, int S,
            int nsplit, int kper, int nb, int qblock) {
  using SM = SlotSmem<T, WT>;
  constexpr int ST = SM::ST, BK = SM::BK;
  constexpr bool kTensorCore = sizeof(T) == 2;
  constexpr bool kQuant = SM::kQuant;
  constexpr bool kWholeK = SM::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  int* idx = reinterpret_cast<int*>(smem + SM::idx);
  auto wstage = [&](int s) {
    return reinterpret_cast<WT*>(smem + (size_t)s * SM::wstage);
  };
  auto astage = [&](int s) {
    return reinterpret_cast<T*>(smem + SM::a + (size_t)s * SM::astage);
  };
  auto sstage = [&](int s) {
    return reinterpret_cast<float*>(smem + SM::s + (size_t)s * SM::sstage);
  };
  const int n0 = blockIdx.x * kSlotBN;
  const int split = kWholeK ? 0 : blockIdx.y;
  const int k_begin = split * kper;
  const int k_end = min(K, k_begin + kper);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool avec = ((size_t)K * sizeof(T)) % 16 == 0 &&
                    (uintptr_t)x % 16 == 0;
  // int8: the tile's first scale group, and the group offsets from it of
  // this thread's columns: gi the fp32 dequant pass's 4, gj the bf16 B
  // fragments' 2 (columns past N hold zero codes; they read group 0)
  const int g0 = kQuant ? n0 / qblock : 0;
  int gi[4] = {0, 0, 0, 0}, gj[2] = {0, 0};
  if constexpr (kQuant) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + lane * 4 + c;
      gi[c] = n < N ? n / qblock - g0 : 0;
    }
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int n = n0 + warp * 16 + jn * 8 + (lane >> 2);
      gj[jn] = n < N ? n / qblock - g0 : 0;
    }
  }

  const int s_end = kWholeK ? (int)blockIdx.y + 1 : S;
  for (int s = kWholeK ? (int)blockIdx.y : 0; s < s_end; ++s) {
    if (!valid[s]) continue;                 // repeated slot: no fetch
    const int e = active[s];
    const bool live = e >= 0 && e < E;       // else its rows get zeros
    const int nch =
        live && k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
    const WT* We = w + (size_t)(live ? e : 0) * K * N;
    const float* Se =
        kQuant ? scales + (size_t)(live ? e : 0) * K * nb : nullptr;
    const bool wvec = ((size_t)N * sizeof(WT)) % 16 == 0 &&
                      (uintptr_t)We % 16 == 0;
    for (int rb = offs[s]; rb < offs[s + 1]; rb += kSlotRows) {
      const int nrow = min(kSlotRows, offs[s + 1] - rb);
      const int nfr = (nrow + 15) / 16;
      __syncthreads();   // the previous pass is done with idx and stages
      for (int i = threadIdx.x; i < nrow; i += NT) idx[i] = order[rb + i];
      __syncthreads();
      float acc[kSlotRows / 2];   // fp32: rows tid / kSlotBN + 2 i
      float mac[4][2][4];         // bf16: [row fragment][n8][c0..c3]
      if constexpr (kTensorCore) {
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) mac[f][j][c] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < kSlotRows / 2; ++i) acc[i] = 0.f;
      }
      auto load = [&](int c) {
        slot_load<T, WT>(wstage(c % ST), We, N, n0, sstage(c % ST), Se,
                         nb, g0, astage(c % ST), x, K, idx, nrow, nfr * 16,
                         k_begin + c * BK, k_end, wvec, avec);
      };
#pragma unroll
      for (int c = 0; c < ST - 1; ++c) {
        if (c < nch) load(c);
        else cp_async_commit();
      }
      for (int c = 0; c < nch; ++c) {
        if (c + ST - 1 < nch) load(c + ST - 1);
        else cp_async_commit();
        cp_async_wait<ST - 1>();
        __syncthreads();
        const WT* wst = wstage(c % ST);
        const T* as_ = astage(c % ST);
        if constexpr (kTensorCore) {
          const int j = lane >> 3, rr = lane & 7;
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            unsigned b[4];   // two n8 fragments of the warp's 16 columns
            if constexpr (kQuant)
              slot_bfrag_q(b, wst, sstage(c % ST), ks, warp, lane, gj);
            else
              ldsm_x4(b,
                      wst + (ks * 16 + (j & 1) * 8 + rr) * SM::LDT +
                          warp * 16 + (j >> 1) * 8,
                      true);
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              if (f < nfr) {
                unsigned a[4];
                ldsm_x4(a,
                        as_ + (f * 16 + (j & 1) * 8 + rr) * SM::LDA +
                            ks * 16 + (j >> 1) * 8,
                        false);
                mma_bf16(mac[f][0], a, b);
                mma_bf16(mac[f][1], a, b + 2);
              }
            }
          }
        } else {
          const T* ws_;   // the stage's weights in fp32, row stride LDT
          if constexpr (kQuant) {
            float* wt = reinterpret_cast<float*>(smem + SM::t);
            slot_dequant(wt, wst, sstage(c % ST), gi);
            __syncthreads();
            ws_ = wt;
          } else {
            ws_ = wst;
          }
          const int col = threadIdx.x % kSlotBN, rg = threadIdx.x / kSlotBN;
          for (int kk = 0; kk < BK; ++kk) {
            const float wv = to_f(ws_[kk * SM::LDT + col]);
#pragma unroll
            for (int i = 0; i < kSlotRows / 2; ++i) {
              const int r = rg + 2 * i;
              if (r < nrow)
                acc[i] = fmaf(to_f(as_[r * SM::LDA + kk]), wv, acc[i]);
            }
          }
        }
        __syncthreads();
      }
      cp_async_wait<0>();
      if constexpr (kTensorCore) {
        const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < 2; ++q)
                slot_store<T>(out, wsp, idx, f * 16 + g + 8 * h, nrow,
                              n0 + warp * 16 + jn * 8 + c2 + q, N, R, split,
                              nsplit, mac[f][jn][2 * h + q]);
      } else {
        const int col = threadIdx.x % kSlotBN, rg = threadIdx.x / kSlotBN;
#pragma unroll
        for (int i = 0; i < kSlotRows / 2; ++i)
          slot_store<T>(out, wsp, idx, rg + 2 * i, nrow, n0 + col, N, R,
                        split, nsplit, acc[i]);
      }
    }
  }
  if (nsplit == 1) return;
  // the last of the tile's nsplit CTAs sums the partials in split order
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counters + blockIdx.x, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int ncols = min(kSlotBN, N - n0);
  const size_t stride = (size_t)R * N;
  for (int i = threadIdx.x; i < R * ncols; i += NT) {
    const int r = i / ncols, n = n0 + (i - r * ncols);
    out[(size_t)r * N + n] = from_f<T>(
        sum_splits<kSlotMaxSplit>(wsp + (size_t)r * N + n, stride, nsplit));
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// K splits per N-tile at stage depth bk: enough CTAs for two per SM, no
// split without a bk chunk of work; depends on N and K only
int slot_splits(int K, int N, int bk, int* kper) {
  const int tiles = (N + kSlotBN - 1) / kSlotBN;
  const int kch = (K + bk - 1) / bk;
  const int sms = sm_count();
  if (sms <= 0) return 0;
  int nsplit = (2 * sms + tiles - 1) / tiles;
  nsplit = max(1, min(nsplit, min(kSlotMaxSplit, kch)));
  const int chunks = (kch + nsplit - 1) / nsplit;
  nsplit = (kch + chunks - 1) / chunks;
  if (kper) *kper = chunks * bk;
  return nsplit;
}

// the most scale groups any kSlotBN-column tile of an N-column weight
// with groups of qblock columns meets
int slot_groups(int N, int qblock) {
  int most = 0;
  for (int n0 = 0; n0 < N; n0 += kSlotBN)
    most = max(most, (min(n0 + kSlotBN, N) - 1) / qblock - n0 / qblock + 1);
  return most;
}

template <typename T, typename WT>
cudaError_t launch_slots(const void* x, const void* w, const float* scales,
                         const int* active, const int* valid,
                         const int* order, const int* offs, void* out,
                         void* wsp, void* counters, int R, int K, int N,
                         int E, int S, int nb, cudaStream_t stream) {
  // int8 experts under fp32 rows: the whole K in one range (one fmaf
  // chain a row, tile_mma's order: the bits of ds_ggemm_q's fp32 form)
  constexpr bool kWholeK = SlotSmem<T, WT>::kTile;
  int kper = 0;
  const int nsplit =
      kWholeK ? 1 : slot_splits(K, N, SlotSmem<T, WT>::BK, &kper);
  if (nsplit <= 0) return cudaErrorInvalidDevice;
  if (kWholeK) kper = (K + SlotSmem<T, WT>::BK - 1) / SlotSmem<T, WT>::BK *
                      SlotSmem<T, WT>::BK;
  const int qblock = nb > 0 ? (N + nb - 1) / nb : 1;
  if (nb > 0 && slot_groups(N, qblock) > kSlotSG)
    return cudaErrorInvalidValue;
  const size_t smem = SlotSmem<T, WT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      slot_kernel<T, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kSlotBN - 1) / kSlotBN, kWholeK ? S : nsplit);
  slot_kernel<T, WT><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const WT*>(w), scales, active,
      valid, order, offs, static_cast<T*>(out), static_cast<float*>(wsp),
      static_cast<int*>(counters), R, K, N, E, S, nsplit, kper, nb, qblock);
  return cudaGetLastError();
}

// ---------------------------------------------- ds_ggemm_t, ds_tgmm
// ds_ggemm_t: grid (num M-tiles, ceil(K / 64)).  dx's tile (M-tile mt,
// columns k0 ..) = dy's real rows of the tile [R, N] against W[e]^T,
// read in place: W[e] rows k0 .. k0 + 63 are the B operand in column-
// major (B_COL), contiguous along N.  Rows past the tile's real rows are
// written as zeros without a fetch (the layout's padding, where the
// backward's cotangent is zero).
template <typename T>
__global__ void __launch_bounds__(NT)
ggemm_t_kernel(const T* __restrict__ dy, const T* __restrict__ w,
               const int* __restrict__ gids,
               const int* __restrict__ tile_rows, T* __restrict__ dx, int K,
               int N, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int mt = blockIdx.x;
  const int k0 = blockIdx.y * kBT;
  const size_t m0 = (size_t)mt * RPMAX;
  const int e = gids[mt];
  const int R = (e >= 0 && e < E) ? min(max(tile_rows[mt], 0), RPMAX) : 0;
  const int nk = min(kBT, K - k0);
  const float* ct = nullptr;
  if (R > 0)   // uniform over the CTA
    ct = layout_tile<T, false, true>(dy + m0 * N, N, R,
                                  w + (size_t)e * K * N + (size_t)k0 * N, N,
                                  nk, N, smem);
  for (int i = threadIdx.x; i < RPMAX * kBT; i += NT) {
    const int r = i / kBT, c = i - r * kBT;
    if (c < nk)
      dx[(m0 + r) * K + k0 + c] =
          r < R ? from_f<T>(ct[r * (kBT + CPAD) + c]) : from_f<T>(0.f);
  }
}

// ds_tgmm: grid (ceil(N / 64), ceil(K / 64), E).  dW[e]'s tile (k0, n0)
// = x^T dy over expert e's real rows, the prefix counts[e] of its group
// (rows p0 .. p0 + counts[e], p0 the sum of the earlier groups' padded
// sizes): the CTA walks that contiguous run itself, 64 rows a chunk (the
// Pallas kernel's accumulate-then-flush over the run becomes the CTA's
// loop).  x's chunk [rows x 64 k] is the A operand in column-major
// (A_COL), dy's [rows x 64 n] the B operand in row-major.  An expert
// with no routed rows writes exact zeros.  Output in OT (x's dtype or
// fp32), rounded once from the fp32 sum.
template <typename T, typename OT>
__global__ void __launch_bounds__(NT)
tgmm_kernel(const T* __restrict__ x, const T* __restrict__ dy,
            const int* __restrict__ gsizes, const int* __restrict__ counts,
            OT* __restrict__ dw, int Mp, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kBT, k0 = blockIdx.y * kBT, e = blockIdx.z;
  long long p0 = 0;
  for (int g = 0; g < e; ++g) p0 += max(gsizes[g], 0);
  const int rows =
      (int)max(0LL, min((long long)min(max(counts[e], 0), max(gsizes[e], 0)),
                        (long long)Mp - p0));
  const int nk = min(kBT, K - k0), nn = min(kBT, N - n0);
  const float* ct = nullptr;
  if (rows > 0)   // uniform over the CTA
    ct = layout_tile<T, true, false>(x + (size_t)p0 * K + k0, K, nk,
                                  dy + (size_t)p0 * N + n0, N, nn, rows,
                                  smem);
  OT* out = dw + (size_t)e * K * N;
  for (int i = threadIdx.x; i < kBT * kBT; i += NT) {
    const int r = i / kBT, c = i - r * kBT;
    if (r < nk && c < nn)
      out[(size_t)(k0 + r) * N + n0 + c] =
          rows > 0 ? from_f<OT>(ct[r * (kBT + CPAD) + c]) : from_f<OT>(0.f);
  }
}

template <typename T>
cudaError_t launch_ggemm_t(const void* dy, const void* w, const int* gids,
                           const int* tile_rows, void* dx, int nblocks,
                           int K, int N, int E, cudaStream_t stream) {
  const size_t smem = LayoutSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ggemm_t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nblocks, (K + kBT - 1) / kBT);
  ggemm_t_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), gids, tile_rows,
      static_cast<T*>(dx), K, N, E);
  return cudaGetLastError();
}

template <typename T, typename OT>
cudaError_t launch_tgmm(const void* x, const void* dy, const int* gsizes,
                        const int* counts, void* dw, int Mp, int K, int N,
                        int E, cudaStream_t stream) {
  const size_t smem = LayoutSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      tgmm_kernel<T, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBT - 1) / kBT, (K + kBT - 1) / kBT, E);
  tgmm_kernel<T, OT><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gsizes, counts,
      static_cast<OT*>(dw), Mp, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ds_ggemm(const void* x, const void* w, const void* gids,
                        const void* tile_rows, void* out, int nblocks, int K,
                        int N, int E, int is_bf16, void* stream) {
  if (nblocks < 1 || K < 1 || N < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  const int* tr = static_cast<const int*>(tile_rows);
  return is_bf16 ? (int)launch_ggemm<__nv_bfloat16, __nv_bfloat16>(
                       x, w, nullptr, g, tr, out, nblocks, K, N, E, 0, st)
                 : (int)launch_ggemm<float, float>(x, w, nullptr, g, tr, out,
                                                   nblocks, K, N, E, 0, st);
}

// int8 experts q [E, K, N] with scales s [E, K, nb], 1 <= nb <= N
extern "C" int ds_ggemm_q(const void* x, const void* q, const void* s,
                          const void* gids, const void* tile_rows, void* out,
                          int nblocks, int K, int N, int E, int nb,
                          int is_bf16, void* stream) {
  if (nblocks < 1 || K < 1 || N < 1 || E < 1 || nb < 1 || nb > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  const int* g = static_cast<const int*>(gids);
  const int* tr = static_cast<const int*>(tile_rows);
  return is_bf16 ? (int)launch_ggemm<__nv_bfloat16, int8_t>(
                       x, q, sc, g, tr, out, nblocks, K, N, E, nb, st)
                 : (int)launch_ggemm<float, int8_t>(x, q, sc, g, tr, out,
                                                    nblocks, K, N, E, nb, st);
}

// the slot kernel's K splits at (K, N) on the current device for int8
// or float weights and bf16 or fp32 rows (the wrapper sizes its
// workspace by it; 1 for int8 weights under fp32 rows); 0 when the
// device is unknown
extern "C" int ds_ggemm_slots_splits(int K, int N, int is_int8,
                                     int is_bf16) {
  if (K < 1 || N < 1) return 0;
  if (is_int8 && !is_bf16) return 1;   // the whole K (launch_slots)
  const int bk = is_int8 ? SlotSmem<__nv_bfloat16, int8_t>::BK
                         : SlotSmem<float, float>::BK;
  return slot_splits(K, N, bk, nullptr);
}

extern "C" int ds_ggemm_slots(const void* x, const void* w,
                              const void* active, const void* valid,
                              const void* order, const void* offs, void* out,
                              void* wsp, void* counters, int R, int K, int N,
                              int E, int S, int is_bf16, void* stream) {
  if (R < 1 || R > 128 || K < 1 || N < 1 || E < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(active);
  const int* v = static_cast<const int*>(valid);
  const int* o = static_cast<const int*>(order);
  const int* f = static_cast<const int*>(offs);
  return is_bf16 ? (int)launch_slots<__nv_bfloat16, __nv_bfloat16>(
                       x, w, nullptr, a, v, o, f, out, wsp, counters, R, K,
                       N, E, S, 0, st)
                 : (int)launch_slots<float, float>(x, w, nullptr, a, v, o, f,
                                                   out, wsp, counters, R, K,
                                                   N, E, S, 0, st);
}

extern "C" int ds_ggemm_slots_q(const void* x, const void* q, const void* s,
                                const void* active, const void* valid,
                                const void* order, const void* offs,
                                void* out, void* wsp, void* counters, int R,
                                int K, int N, int E, int S, int nb,
                                int is_bf16, void* stream) {
  if (R < 1 || R > 128 || K < 1 || N < 1 || E < 1 || S < 1 || nb < 1 ||
      nb > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  const int* a = static_cast<const int*>(active);
  const int* v = static_cast<const int*>(valid);
  const int* o = static_cast<const int*>(order);
  const int* f = static_cast<const int*>(offs);
  return is_bf16 ? (int)launch_slots<__nv_bfloat16, int8_t>(
                       x, q, sc, a, v, o, f, out, wsp, counters, R, K, N, E,
                       S, nb, st)
                 : (int)launch_slots<float, int8_t>(x, q, sc, a, v, o, f,
                                                    out, wsp, counters, R, K,
                                                    N, E, S, nb, st);
}

// dx [Mp, K] = dy [Mp, N] against W [E, K, N] transposed, per M-tile
extern "C" int ds_ggemm_t(const void* dy, const void* w, const void* gids,
                          const void* tile_rows, void* dx, int nblocks,
                          int K, int N, int E, int is_bf16, void* stream) {
  if (nblocks < 1 || K < 1 || N < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  const int* tr = static_cast<const int*>(tile_rows);
  return is_bf16 ? (int)launch_ggemm_t<__nv_bfloat16>(dy, w, g, tr, dx,
                                                      nblocks, K, N, E, st)
                 : (int)launch_ggemm_t<float>(dy, w, g, tr, dx, nblocks, K,
                                              N, E, st);
}

// dW [E, K, N] = per-expert x [Mp, K]^T dy [Mp, N] over each group's real
// rows; out_f32: dW in fp32 (else in x's dtype; fp32 rows need it)
extern "C" int ds_tgmm(const void* x, const void* dy, const void* gsizes,
                       const void* counts, void* dw, int Mp, int K, int N,
                       int E, int is_bf16, int out_f32, void* stream) {
  if (Mp < 1 || K < 1 || N < 1 || E < 1 || E > 65535 ||
      (!is_bf16 && !out_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(gsizes);
  const int* c = static_cast<const int*>(counts);
  if (!is_bf16)
    return (int)launch_tgmm<float, float>(x, dy, gs, c, dw, Mp, K, N, E, st);
  return out_f32 ? (int)launch_tgmm<__nv_bfloat16, float>(x, dy, gs, c, dw,
                                                          Mp, K, N, E, st)
                 : (int)launch_tgmm<__nv_bfloat16, __nv_bfloat16>(
                       x, dy, gs, c, dw, Mp, K, N, E, st);
}
