// Fused per-layer decode step: one decoder layer's W-token window for B
// rows in ONE launch.  Specs: LayerNorm or RMSNorm; fused [D, 3D] QKV
// (thirds, or head-major: per head [q|k|v]) or split wq / wk / wv; each
// projection's bias optional; grouped-query attention (num_kv_heads
// dividing num_heads); no rotary, full or partial rotary (the first rot
// dims of each head, split-half pairing over rot / 2); ALiBi (slopes[h] *
// key position added to each score); MLP gelu_tanh / gelu_exact / relu,
// SwiGLU, or none (the layer ends after the attention-out residual: a
// mixture-of-experts layer runs its experts outside); serial or parallel
// residual (norm2 reads the layer input; out = (x + attn) + mlp).
//
// Replaces: deepspeed_tpu/ops/pallas/fused_decode.py:_fused_kernel (its
// GPT-2, Llama, Mixtral, GPT-NeoX and BLOOM specs; GPT-J's interleaved
// rotary is refused there too).
//
//   norm1 -> QKV (+bias) -> rotary -> new K/V (int8 quantize, or the
//   cache dtype) -> attention over the cache plus the window's own
//   tokens -> out-proj (+bias) + residual -> norm2 -> MLP-in (+bias) ->
//   activation (or silu(gate) * up) -> MLP-out (+bias) + residual
//
// What bounds it on an H100: bytes.  At decode shapes (B 8, W 1) the
// layer's weights (28.3 MB int8 or 56.6 MB bf16 for GPT-2 760M, 405 MB
// bf16 for Llama-2 7B) and the KV cache stream through once; everything
// else is a few KB.  The TPU kernel kept the whole layer resident in 96
// MiB of VMEM; Hopper has 227 KB of shared memory per block, so this
// kernel streams each weight byte once per call instead: it is ONE
// persistent cooperative launch (grid = the CTAs the card keeps
// co-resident) that walks the phases above, with a grid-wide barrier
// between phases.
//   - GEMM phases under bf16 compute run on the decode weight stream
//     (decode_stream.cuh: a TMA ring of [64 k x 256 n] weight stages,
//     swap-AB mma.sync, int8 codes dequantized into the A fragment), its
//     work units (projection, 32-row group, 256 columns, K split) fixed
//     at launch: CTA c takes units c, c + grid, ...  A producer warp
//     beside the eight compute warps walks the CTA's units of all four
//     GEMM phases in order and keeps the ring full across them: weights
//     depend on no earlier phase, so the next phase's first stages load
//     during the attention, epilogue and norm phases; only a phase's rows
//     (the activations, by TMA from the scratch) wait for the grid barrier
//     before it, which the producer reads from the barrier's generation.
//     The ring's shared memory lies apart from every other phase's.
//   - GEMM phases under fp32 compute run 8-row blocks of gemm_tile.cuh
//     rows_mma (fmaf, no TF32; [64 x 64] tile_mma above 128 rows).
//   - Both split K by N, K and the SM count only, as csrc/qgemm.cu does,
//     so a projection's products and split sums are the unfused qgemm's:
//     each item's fp32 partial goes to a small global scratch (L2-
//     resident) and the next phase reduces them in split order, so a
//     row's result does not depend on which other rows share the batch.
//   - Attention is split over the cache, as csrc/decode_attention.cu:
//     one work item per (chunk of kC positions at fixed absolute
//     boundaries, row, kv head, chunk of <= kQItem query vectors), only
//     the items with positions to attend, dealt out in turn to the CTAs'
//     two groups of four warps; each warp owns 16 positions of the chunk,
//     copies their cache rows into shared memory by 16-byte cp.async,
//     reads the window's own tokens (kw / vw) where they fall, and keeps
//     its own softmax state, so the rep query heads of a group share each
//     load and a warp meets the others once, when the group merges them
//     in warp order; a chunk's (max, sum, P V) go to a workspace in fp32
//     and the last item of a (row, kv head, query chunk) to arrive (an
//     int counter, no float atomics) merges them in chunk order.
// Activations between phases live in the same scratch and are read back
// through L2 (ld.global.cg): L1 is not coherent across SMs.  The spec's
// features are runtime fields of FusedArgs, not template parameters: one
// instantiation per (compute, weight, cache) dtype.
//
// Numerics are the reference's unfused composition (_ref_fused_layer):
// every product is rounded to the compute dtype T and its bias added in
// T; norm statistics and the activation run in fp32; rotary takes the
// unfused path's own frequency table (an input, rot / 2 entries), the
// angle position * frequency in fp32, cosf / sinf, and x1 cos - x2 sin
// without contraction, rounded to T; the ALiBi bias is added to the
// scaled score as one rounded product and one rounded sum, as the decode
// attention kernel does; each residual add rounds to T in the unfused
// order; the int8 weight element dequantizes as
// (float)q * scale, rounded to T before the product (gemm_tile.cuh);
// attention runs in fp32 with the new K/V as the cache would hold them
// (int8 codes times their scale, or rounded through the cache dtype).
//
// C interface (loaded with ctypes, csrc/fused_decode.cu): ds_fused_layer
// takes one argument block (FusedArgs) and returns the cudaError_t of the
// launch as an int; ds_fused_layer_args_size returns sizeof(FusedArgs) for
// the wrapper's layout check.
//
// The build: this header holds the kernel and its launch.  Each of the
// eight (compute, weight, cache) dtype instances is compiled on its own
// from csrc/fused_decode_layer.cu (ops/kernels/build.py PARTS), in
// parallel with the other sources, and linked with fused_decode.cu's
// entry points into one library: compiled together they set the whole
// build's wall.
#pragma once

#include <type_traits>

#include "decode_stream.cuh"
#include "gemm_tile.cuh"

// One projection of a GEMM phase: W [K, N] row-major (T, or int8 codes
// with [K, nb] fp32 scales), an optional [N] T bias, and its partial sums
// [split, R, N] in the scratch (part and split are set at launch).
// Declared outside the anonymous namespace, as FusedArgs.
struct Mat {
  const void* w;
  const float* s;
  const void* bias;            // null: no bias
  float* part;
  int nb, N, split;
};

// Everything one call needs; pointers are device pointers.  Matrices are
// row-major and contiguous; "rows" are the B*W window tokens, row
// r = b * W + j.  Declared outside the anonymous namespace: the C entry
// point takes it, and a parameter type of internal linkage would give
// that symbol internal linkage too.
struct FusedArgs {
  int B, W, D, H, KV, HD, S_max;
  int norm;                    // 0 LayerNorm (scale + bias), 1 RMSNorm
  int mlp;                     // 0 gelu_tanh 1 gelu_exact 2 relu 3 swiglu
                               // 4 none
  int nqkv;                    // 1: fused [D, (H + 2 KV) HD]; 3: wq wk wv
  int nmlp_in;                 // 1: w_in; 2: w_gate, w_up; 0 (mlp none)
  int headmajor;               // fused QKV packed per head [q|k|v] (KV == H)
  int rot;                     // rotary dims (rope set): even, <= HD
  int parallel;                // parallel residual
  float eps, sm_scale;
  const void* x;               // [R, D] T
  const int* lengths;          // [B] first window position per row
  const void *n1_s, *n1_b, *n2_s, *n2_b;  // [D] T (biases: LayerNorm)
  const float* rope;           // [rot / 2] frequencies, or null: no rotary
  const float* alibi;          // [H] ALiBi slopes, or null: no ALiBi
  Mat qkv[3], o, mlp_in[2], mlp_out;
  const void *k_cache, *v_cache;          // [B, S_max, KV, HD] CT
  const float *ks_cache, *vs_cache;       // [B, S_max, KV] (int8 cache)
  void* x_out;                 // [R, D] T
  void *new_k, *new_v;         // [R, KV * HD] CT
  float *new_ks, *new_vs;      // [R, KV] (int8 cache)
  // scratch
  void* abuf;                  // [R, max(D, H HD, M)] T: GEMM A operand
  void* xres;                  // [R, D] T: x + attention output
  float* part;                 // partial sums, part_floats of them
  long long part_floats;
  float* qf;                   // [R, H * HD] the queries
  float *kw, *vw;              // [R, KV * HD] the window's K/V, fp32
  unsigned* bar;               // [2] barrier count (0 between calls), gen
  // optional [12] %globaltimer readings of CTA 0 (null: none): the
  // start, the exit of each of the ten grid barriers, and CTA 0's end
  unsigned long long* stamps;
  // attention chunk partials (attn_floats of them, see attn_ws_floats)
  // and one int counter per (row, kv head, query chunk), all 0 (each
  // launch leaves them 0)
  float* attn_ws;
  long long attn_floats;
  int* attn_cnt;
};

// The stream's plan of one launch (bf16 compute): each projection's
// weight map and split (qkv[0..2], o, mlp_in[0..1], mlp_out), each GEMM
// phase's rows map over the scratch (QKV, out, MLP-in, MLP-out: row
// strides D, H HD, D, M) and its units.  A __grid_constant__ parameter,
// so the TMA units read the maps where they lie.
struct StreamPlan {
  CUtensorMap w[7];
  CUtensorMap x[4];
  dstream::Proj p[7];
  int units[4];
};

namespace {

using namespace dstile;

constexpr int kWarps = NT / 32;
constexpr int kHDMax = 128;    // head_dim <= 128
constexpr int kNI = kHDMax / 32;
constexpr int kMaxSplit = 16;  // K splits per GEMM
constexpr int kMlpSwiglu = 3, kMlpNone = 4;
constexpr float kNegInf = -1e30f;
static_assert(kMaxSplit == dstream::kMaxSplit, "one split rule");
static_assert(dstream::kConsumers == NT, "the compute warps consume");

// grid barriers before GEMM phase ph's rows are written (QKV, out,
// MLP-in, MLP-out): the producer waits for that many past its start
__device__ __forceinline__ int rows_ready_after(int ph) {
  return ph == 0 ? 1 : (ph == 1 ? 4 : (ph == 2 ? 7 : 9));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// e / d for 0 <= e < 2^32 / d^2 by the high word of one multiply (m =
// ceil(2^32 / d); 0 for d 1): the attention phase's index splits by a
// runtime divisor (head dim, rep, 16-byte units a row), without the
// integer divide's dependent chain
struct FastDiv {
  unsigned m;
  __device__ __forceinline__ explicit FastDiv(int d)
      : m(d > 1 ? (unsigned)((0xffffffffull + (unsigned)d) / (unsigned)d)
                : 0u) {}
  __device__ __forceinline__ int div(int e) const {
    return m ? (int)__umulhi((unsigned)e, m) : e;
  }
};

// the compute warps' barrier (named barrier 1): the producer warp of a
// stream instance never joins it
__device__ __forceinline__ void cta_sync() { hopper::named_bar_sync(1, NT); }

// the generic proxy's writes to global memory ordered before later
// async-proxy (TMA) reads, and the other way round
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Sense-free grid barrier over co-resident CTAs: bar[0] counts arrivals
// (the last one returns it to 0), bar[1] is a generation number the
// others wait on (and a stream instance's producer reads).  The fences
// make every write before the barrier visible to every CTA after it
// (readers use L2 loads, or TMA after a proxy fence).
template <bool kStream>
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  if constexpr (kStream) fence_proxy_global();
  cta_sync();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  cta_sync();
}

// phase boundaries of one call, read by the wrapper's `stamps` option
__device__ __forceinline__ void stamp(const FusedArgs& a, int i) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[i] = t;
  }
}

template <typename T>
__device__ __forceinline__ float ld_in(const void* p, size_t i) {
  return to_f(static_cast<const T*>(p)[i]);
}

__device__ __forceinline__ float activation(float v, int act) {
  if (act == 2) return fmaxf(v, 0.f);
  if (act == 1) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

// the sum of v over the compute warps, returned to each of their threads
// (warp sums added in warp order)
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[kWarps];
  v = warp_sum(v);
  cta_sync();   // a previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  cta_sync();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// LayerNorm (rms = false: (x - mean) * rstd * scale + bias) or RMSNorm
// (rms = true: x * rstd * scale, rstd from the mean square) of a row of D
// values at `src` (T; a kernel input or written earlier in this launch,
// so read through L2) into `dst` (T), by the compute warps: statistics in
// fp32, as the reference.  Up to kLnPer values a thread stay in
// registers, loaded together; a wider row reads src once per pass.
constexpr int kLnPer = 8;
template <typename T>
__device__ void norm_cta(const T* src, T* dst, const void* scale,
                         const void* bias, int D, float eps, bool rms) {
  float v[kLnPer];
  const bool held = D <= kLnPer * NT;
  float mu = 0.f;
  if (held) {
#pragma unroll
    for (int j = 0; j < kLnPer; ++j) {
      const int c = threadIdx.x + j * NT;
      v[j] = c < D ? to_f(ldcg_t<T>(src + c)) : 0.f;
    }
  }
  if (!rms) {
    float s = 0.f;
    if (held) {
#pragma unroll
      for (int j = 0; j < kLnPer; ++j) s += v[j];
    } else {
      for (int c = threadIdx.x; c < D; c += NT) s += to_f(ldcg_t<T>(src + c));
    }
    mu = block_sum(s) / D;
  }
  float q = 0.f;
  if (held) {
#pragma unroll
    for (int j = 0; j < kLnPer; ++j) {
      const float d = threadIdx.x + j * NT < D ? v[j] - mu : 0.f;
      q += d * d;
    }
  } else {
    for (int c = threadIdx.x; c < D; c += NT) {
      const float d = to_f(ldcg_t<T>(src + c)) - mu;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(q) / D + eps);
  auto out = [&](float xv, int c) {
    dst[c] = from_f<T>(
        rms ? __fmul_rn(__fmul_rn(xv, rstd), ld_in<T>(scale, c))
            : (xv - mu) * rstd * ld_in<T>(scale, c) + ld_in<T>(bias, c));
  };
  if (held) {
#pragma unroll
    for (int j = 0; j < kLnPer; ++j) {
      const int c = threadIdx.x + j * NT;
      if (c < D) out(v[j], c);
    }
  } else {
    for (int c = threadIdx.x; c < D; c += NT) out(to_f(ldcg_t<T>(src + c)), c);
  }
}

// ------------------------------------------------------------ GEMM phases
// The projections of GEMM phase `ph` (0 QKV, 1 out, 2 MLP-in, 3 MLP-out):
// their first index in StreamPlan order, their count, the phase's K
__device__ __forceinline__ void phase_mats(const FusedArgs& a, int ph,
                                           const Mat** mats, int* j0,
                                           int* n, int* K) {
  const int M = a.mlp_in[0].N;
  switch (ph) {
    case 0: *mats = a.qkv; *j0 = 0; *n = a.nqkv; *K = a.D; break;
    case 1: *mats = &a.o; *j0 = 3; *n = 1; *K = a.H * a.HD; break;
    case 2: *mats = a.mlp_in; *j0 = 4; *n = a.nmlp_in; *K = a.D; break;
    default: *mats = &a.mlp_out; *j0 = 6; *n = a.nmlp_in > 0; *K = M; break;
  }
}

// unit `u` of a phase as (projection, its local unit)
__device__ __forceinline__ int unit_mat(const StreamPlan& sp, int j0, int n,
                                        int R, int* u) {
  int j = 0;
  while (j + 1 < n && *u >= dstream::units_of(sp.p[j0 + j], R))
    *u -= dstream::units_of(sp.p[j0 + j++], R);
  return j0 + j;
}

// The stream instance's producer warp: every stage of the CTA's units of
// every GEMM phase, in the consumers' order.  A phase's weights go out as
// soon as the ring has room; its rows only once they are written
// (rows_ready_after grid barriers past g0), then with each stage.  Before
// the next phase's first weights, the rows of any stage of this phase
// still without them are issued, so no stage the ring waits on lacks them.
template <bool Q8>
__device__ void produce(const FusedArgs& a, const StreamPlan& sp,
                        unsigned char* ring, unsigned g0, int nphase) {
  using namespace dstream;
  constexpr int S = Ring<Q8>::kStages;
  const int R = a.B * a.W;
  volatile unsigned* gen = a.bar + 1;
  auto rows_ready = [&](int ph) {
    if ((threadIdx.x & 31) == 0)
      while ((int)(*gen - g0) < rows_ready_after(ph)) __nanosleep(256);
    __syncwarp();
    __threadfence();
    fence_proxy_global();
  };
  // the rows of this phase's stages [first, end) (stage counter values)
  auto issue_phase_rows = [&](int ph, int first, int end) {
    const Mat* mats;
    int j0, n, K;
    phase_mats(a, ph, &mats, &j0, &n, &K);
    int it = first;
    for (int u = blockIdx.x; u < sp.units[ph] && it < end; u += gridDim.x) {
      int local = u;
      const int j = unit_mat(sp, j0, n, R, &local);
      const Unit w = unit_of(sp.p[j], R, local);
      for (int c = 0; c < w.nch && it < end; ++c, ++it)
        issue_rows<Q8>(ring, &sp.x[ph], w, c, it);
    }
  };
  int it = 0, pend = -1, pend_first = 0, pend_end = 0;
  for (int ph = 0; ph < nphase; ++ph) {
    if (pend >= 0) {
      rows_ready(pend);
      issue_phase_rows(pend, pend_first, pend_end);
      pend = -1;
    }
    const Mat* mats;
    int j0, n, K;
    phase_mats(a, ph, &mats, &j0, &n, &K);
    const int first = it;
    bool ready = false;
    for (int u = blockIdx.x; u < sp.units[ph]; u += gridDim.x) {
      int local = u;
      const int j = unit_mat(sp, j0, n, R, &local);
      const Unit w = unit_of(sp.p[j], R, local);
      for (int c = 0; c < w.nch; ++c, ++it) {
        if (!ready && it - S >= first) {   // the ring waits on this phase
          rows_ready(ph);
          issue_phase_rows(ph, first, it);
          ready = true;
        }
        issue_weights<Q8>(ring, &sp.w[j], sp.p[j], w, c, it, row_bytes(w));
        if (ready) issue_rows<Q8>(ring, &sp.x[ph], w, c, it);
      }
    }
    if (!ready && it > first) {
      pend = ph;
      pend_first = first;
      pend_end = it;
    }
  }
  if (pend >= 0) {
    rows_ready(pend);
    issue_phase_rows(pend, pend_first, pend_end);
  }
}

// A stream instance's GEMM phase on the compute warps: each of the CTA's
// units' fp32 products into its split's partial sums.  `it` is the ring's
// stage counter, carried from phase to phase.
template <bool Q8>
__device__ void stream_phase(const FusedArgs& a, const StreamPlan& sp,
                             int ph, unsigned char* ring, int& it) {
  using namespace dstream;
  const Mat* mats;
  int j0, n, K;
  phase_mats(a, ph, &mats, &j0, &n, &K);
  const int R = a.B * a.W;
  Acc acc;
  for (int u = blockIdx.x; u < sp.units[ph]; u += gridDim.x) {
    int local = u;
    const int j = unit_mat(sp, j0, n, R, &local);
    const Proj& p = sp.p[j];
    const Unit w = unit_of(p, R, local);
    consume_unit<Q8>(ring, acc, p, w, it);
    float* part = mats[j - j0].part + (size_t)w.split * R * p.N;
    for_each_acc<Q8>(acc, p, w, R, [&](int r, int col, float v) {
      part[(size_t)r * p.N + col] = v;
    });
  }
}

// whether an fp32 phase's projection takes rows_mma's 8-row blocks: at
// most 128 rows, scale groups of 8 columns or more (csrc/qgemm.cu's rows
// form); else [64 x 64] tiles
__host__ __device__ inline bool rows_form(int R, int N, int nb) {
  return R <= 128 && use_rows(1, N, nb);
}

__host__ __device__ inline int mat_items(int R, int N, int nb, int nsplit) {
  const bool rows = rows_form(R, N, nb);
  const int bn = rows ? RBN : BN, rmax = rows ? RROWS : RPMAX;
  return ((N + bn - 1) / bn) * ((R + rmax - 1) / rmax) * nsplit;
}

// An fp32 GEMM phase: mats[j].part[split][r][n] = sum over the split's K
// range of A[r][k] * W~j[k][n] for all R rows, every (projection, row
// block, column tile, split) item taken by one CTA: [8 x 256] rows_mma
// blocks (csrc/qgemm.cu's rows form: the same splits, so the same sums),
// or [64 x 64] tile_mma tiles above 128 rows.
template <typename T, typename WT>
__device__ void gemm_phase(const T* A, int lda, int R, int K,
                           const Mat* mats, const dstream::Proj* projs,
                           int nmat, unsigned char* smem) {
  int items[3], total = 0;
  for (int j = 0; j < nmat; ++j) {
    items[j] = mat_items(R, mats[j].N, sizeof(WT) == 1 ? mats[j].nb : 0,
                         projs[j].nsplit);
    total += items[j];
  }
  for (int it = blockIdx.x; it < total; it += gridDim.x) {
    int j = 0, local = it;
    while (local >= items[j]) local -= items[j++];
    const Mat& m = mats[j];
    const int N = m.N, nb = sizeof(WT) == 1 ? m.nb : 0;
    const int nsplit = projs[j].nsplit, kper = projs[j].kper;
    const bool rows = rows_form(R, N, nb);
    const int bn = rows ? RBN : BN, rmax = rows ? RROWS : RPMAX;
    const int tn = (N + bn - 1) / bn;
    const int qblock = nb > 0 ? (N + nb - 1) / nb : 1;
    const int split = local % nsplit;
    const int rest = local / nsplit;
    const int tni = rest % tn, tmi = rest / tn;
    const int m0 = tmi * rmax;
    const int nrows = min(rmax, R - m0);
    const int n0 = tni * bn;
    const int kb = split * kper;
    const int ke = min(K, kb + kper);
    const WT* Wt = static_cast<const WT*>(m.w);
    const float* ct =
        rows ? rows_mma<T, WT>(A + (size_t)m0 * lda, lda, nrows, Wt, m.s, nb,
                               qblock, N, n0, kb, ke, smem)
             : tile_mma<T, WT>(A + (size_t)m0 * lda, lda, nrows, Wt, m.s, nb,
                               qblock, N, n0, kb, ke, smem);
    const int ldc = rows ? RBN : BN + CPAD;
    float* dst = m.part + ((size_t)split * R + m0) * N + n0;
    for (int e = threadIdx.x; e < nrows * bn; e += NT) {
      const int r = e / bn, n = e - r * bn;
      if (n0 + n < N) dst[(size_t)r * N + n] = ct[r * ldc + n];
    }
  }
}

// element (r, n) of a projection: its split partial sums added in split
// order, rounded to T, plus its bias in T (the reference's qdot + b)
template <typename T>
__device__ __forceinline__ float proj_value(const Mat& m, int R, int r,
                                            int n) {
  float p = round_t<T>(sum_splits<kMaxSplit>(m.part + (size_t)r * m.N + n,
                                             (size_t)R * m.N, m.split));
  if (m.bias != nullptr) p = round_t<T>(p + ld_in<T>(m.bias, n));
  return p;
}

// -------------------------------------------------------------- attention
// The attention phase's layout.  A work item is a chunk of kC positions
// of one (row, kv head, query chunk of <= kQItem queries); the CTA's two
// groups of four warps each take their own items, and warp w of a group
// owns the chunk's positions [16 w, 16 w + 16) (two lanes a position):
// it copies their K and V rows and its item's queries into its own shared
// memory, scores them, keeps its own (max, sum, P V), and meets the
// group's other warps once, when their states merge in warp order.
constexpr int kC = 64;                     // positions of an item
constexpr int kGroupWarps = 4;
constexpr int kGroups = kWarps / kGroupWarps;
constexpr int kWPos = kC / kGroupWarps;   // positions a warp owns
constexpr int kQItem = 4;                  // query vectors an item holds
constexpr int kBMax = 256;                 // rows the phase stages
static_assert(kWPos * 2 == 32, "two lanes a position");

// shared memory of the attention phase for cache type CT (bytes): each
// warp's K rows (padded to 2 x an odd number of 16-byte units, so the
// lanes' reads of eight rows meet eight bank groups), V rows, queries
// (fp32 as projected), P and int8 scales; each group's warp partials
// (P V, max, sum); the rows' lengths and their items' prefix.  The QKV
// epilogue's rotary rows reuse the start.
template <typename CT>
struct AttnSmem {
  static constexpr int kPiecesMax = kHDMax * (int)sizeof(CT) / 16;
  static constexpr int kUptMax = (kPiecesMax + 1) / 2;
  static constexpr int kRowK = 2 * (kUptMax | 1) * 16;
  static constexpr int kRowV = kPiecesMax * 16;
  // one warp
  static constexpr int k = 0;
  static constexpr int v = kWPos * kRowK;
  static constexpr int q = v + kWPos * kRowV;
  static constexpr int p = q + kQItem * kHDMax * 4;
  static constexpr int ks = p + kQItem * kWPos * 4;
  static constexpr int vs = ks + kWPos * 4;
  static constexpr int warp = vs + kWPos * 4;
  // one group
  static constexpr int red = kWarps * warp;
  static constexpr int mw = red + kGroupWarps * kQItem * kHDMax * 4;
  static constexpr int lw = mw + kGroupWarps * kQItem * 4;
  static constexpr int group = lw + kGroupWarps * kQItem * 4 - red;
  static constexpr int lens = red + kGroups * group;
  static constexpr int pre = lens + kBMax * 4;
  static constexpr int bytes = pre + (kBMax + 1) * 4;
  static_assert(kWarps * kHDMax * 4 <= kWPos * (kRowK + kRowV),
                "the rotary rows fit");
  static_assert(warp % 16 == 0 && group % 16 == 0, "16-byte copies");
};

// a 16-byte unit of a cached head vector as fp32 (int8: code * scale)
template <typename CT>
__device__ __forceinline__ void unpack16(uint4 u, float scale, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(uint4 u, float, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 u, float,
                                                        float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack16<int8_t>(uint4 u, float scale,
                                                 float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[4 * i + e] = (float)((int)(w[i] << (24 - 8 * e)) >> 24) * scale;
}

// elements 2c and 2c + 1 of a cached head vector row as fp32
template <typename CT>
__device__ __forceinline__ float2 pair_at(const unsigned char* row, int c,
                                          float scale);
template <>
__device__ __forceinline__ float2 pair_at<float>(const unsigned char* row,
                                                 int c, float) {
  return *reinterpret_cast<const float2*>(row + 8 * c);
}
template <>
__device__ __forceinline__ float2 pair_at<__nv_bfloat16>(
    const unsigned char* row, int c, float) {
  const unsigned w = *reinterpret_cast<const unsigned*>(row + 4 * c);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
template <>
__device__ __forceinline__ float2 pair_at<int8_t>(const unsigned char* row,
                                                  int c, float scale) {
  const char2 w = *reinterpret_cast<const char2*>(row + 2 * c);
  return make_float2((float)w.x * scale, (float)w.y * scale);
}

// floats of one launch's chunk partials: per (row, kv head, query chunk)
// one slot per chunk of the cache and the window, each the chunk's max
// and sum and P V of up to kQItem queries
__host__ __device__ inline long long attn_ws_floats(int B, int W, int H,
                                                    int KV, int HD,
                                                    int S_max) {
  const int nq = W * (H / KV);
  const int qmax = nq < kQItem ? nq : kQItem;
  const long long nqc = (nq + kQItem - 1) / kQItem;
  const long long zmax = (S_max + W + kC - 1) / kC;
  return (long long)B * KV * nqc * zmax * qmax * (HD + 2);
}

struct AttnShape {
  int rep, nq, nqc, zmax, pieces, upt, rowk, rowv, slotf, qmax;
};

// a query of an item: its window position and head
struct QHead {
  int j, h;
};

// One attention work item: chunk z of row b's positions for kv head kvh
// and query chunk qc (queries q0 .. q0 + qn - 1); the row's cache length
// len, its last chunk for these queries, this chunk's first position,
// its positions and how many of them are in the cache.
struct AttnItem {
  int z, b, kvh, qc, q0, qn, len, j_last, s_lo, n, ncache;
};

// chunks row b's query chunk qc attends (its last query sees len +
// its window position + 1 positions)
__device__ __forceinline__ int attn_chunks(const AttnShape& sh, int len,
                                           int qc) {
  const int q_last = min(sh.nq, qc * kQItem + kQItem) - 1;
  return (len + q_last / sh.rep + 1 + kC - 1) / kC;
}

// live item i (pre: each row's first item) as its fields; within a row
// the query chunk runs slowest, then the chunk, then the kv head: the
// items in flight together read whole cache rows ([KV, HD] a position),
// not one head's slice of positions a row apart
__device__ __forceinline__ AttnItem attn_item(const FusedArgs& a,
                                              const AttnShape& sh,
                                              const int* lens,
                                              const int* pre, int i) {
  int lo = 0, hi = a.B;   // the row: pre[lo] <= i < pre[lo + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= i) lo = mid; else hi = mid;
  }
  AttnItem it;
  it.b = lo;
  it.len = lens[lo];
  int rem = i - pre[lo];
  it.qc = 0;
  int nch = attn_chunks(sh, it.len, 0);
  while (rem >= a.KV * nch) {
    rem -= a.KV * nch;
    nch = attn_chunks(sh, it.len, ++it.qc);
  }
  it.z = rem / a.KV;
  it.kvh = rem - it.z * a.KV;
  it.j_last = nch - 1;
  it.q0 = it.qc * kQItem;
  it.qn = min(kQItem, sh.nq - it.q0);
  it.s_lo = it.z * kC;
  const int total = it.len + (it.q0 + it.qn - 1) / sh.rep + 1;
  it.n = min(kC, total - it.s_lo);
  it.ncache = max(0, min(it.n, it.len - it.s_lo));
  return it;
}

// The attention phase.  Query qi of an item is window position (q0 +
// qi) / rep of head kvh * rep + (q0 + qi) % rep and sees the cache's
// first len positions plus the window positions up to its own.  Group g
// of the CTA takes live items g', g' + groups, ... (g' = 2 blockIdx + g).
template <typename T, typename CT>
__device__ void attention_phase(const FusedArgs& a, unsigned char* sm) {
  using L = AttnSmem<CT>;
  constexpr bool kQCache = sizeof(CT) == 1;
  constexpr int VEC = 16 / (int)sizeof(CT);
  const int HD = a.HD, KV = a.KV, H = a.H, W = a.W;
  const int Dq = H * HD, Dk = KV * HD;
  AttnShape sh;
  sh.rep = H / KV;
  sh.nq = W * sh.rep;
  sh.qmax = sh.nq < kQItem ? sh.nq : kQItem;
  sh.nqc = (sh.nq + kQItem - 1) / kQItem;
  sh.zmax = (a.S_max + W + kC - 1) / kC;
  sh.pieces = HD * (int)sizeof(CT) / 16;
  sh.upt = (sh.pieces + 1) / 2;
  sh.rowk = 2 * (sh.upt | 1) * 16;
  sh.rowv = sh.pieces * 16;
  sh.slotf = sh.qmax * (HD + 2);
  const FastDiv by_pieces(sh.pieces), by_hd(HD), by_rep(sh.rep),
      by_qv(HD / 4);
  const int HP = HD / 2;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int grp = warp / kGroupWarps, gw = warp % kGroupWarps;
  // query qq of a row (window position, head) for kv head kvh
  auto qhead = [&](int qq, int kvh) {
    const int j = by_rep.div(qq);
    return QHead{j, kvh * sh.rep + (qq - j * sh.rep)};
  };
  const int gt = t - grp * kGroupWarps * 32;   // thread within the group
  const int pl = lane >> 1, h = lane & 1;      // the lane's position, half
  const int p0 = gw * kWPos;                   // the warp's first position
  unsigned char* wsm = sm + warp * L::warp;
  unsigned char* k_s = wsm + L::k;
  unsigned char* v_s = wsm + L::v;
  float* q_s = reinterpret_cast<float*>(wsm + L::q);    // [qn][kHDMax]
  float* p_s = reinterpret_cast<float*>(wsm + L::p);    // [qn][kWPos]
  float* ks_s = reinterpret_cast<float*>(wsm + L::ks);
  float* vs_s = reinterpret_cast<float*>(wsm + L::vs);
  unsigned char* gsm = sm + L::red + grp * L::group;
  float* red = reinterpret_cast<float*>(gsm);           // [w][qi][kHDMax]
  float* mw = reinterpret_cast<float*>(gsm + (L::mw - L::red));
  float* lw = reinterpret_cast<float*>(gsm + (L::lw - L::red));
  int* lens = reinterpret_cast<int*>(sm + L::lens);
  int* pre = reinterpret_cast<int*>(sm + L::pre);
  __shared__ int s_last[kGroups];
  T* abuf = static_cast<T*>(a.abuf);
  const CT* kc = static_cast<const CT*>(a.k_cache);
  const CT* vc = static_cast<const CT*>(a.v_cache);
  const float sm_scale = a.sm_scale;
  // the group's barrier (named barriers 2 and 3)
  auto group_sync = [&]() {
    hopper::named_bar_sync(2 + grp, kGroupWarps * 32);
  };

  cta_sync();   // the QKV epilogue's rotary rows are done with sm
  for (int b = t; b < a.B; b += NT) {
    const int l = a.lengths[b];
    lens[b] = l < 0 ? 0 : (l > a.S_max ? a.S_max : l);
  }
  cta_sync();
  if (t == 0) {
    int acc = 0;
    for (int b = 0; b < a.B; ++b) {
      pre[b] = acc;
      for (int qc = 0; qc < sh.nqc; ++qc)
        acc += KV * attn_chunks(sh, lens[b], qc);
    }
    pre[a.B] = acc;
  }
  cta_sync();
  const int total_items = pre[a.B];
  const int ngroups = gridDim.x * kGroups;

  // positions of the warp in an item: nw, nc of them cached
  auto warp_span = [&](const AttnItem& it, int* nw, int* nc) {
    *nw = max(0, min(kWPos, it.n - p0));
    *nc = max(0, min(*nw, it.ncache - p0));
  };
  // the copies of an item's part owned by this warp: its positions' cache
  // rows (16 bytes a copy), int8 scales, and the item's queries as
  // projected (fp32)
  auto issue = [&](const AttnItem& it) {
    int nw, nc;
    warp_span(it, &nw, &nc);
    for (int e = lane; e < nc * sh.pieces; e += 32) {
      const int r = by_pieces.div(e), u = e - r * sh.pieces;
      const size_t off = ((size_t)it.b * a.S_max + it.s_lo + p0 + r) * Dk +
                         (size_t)it.kvh * HD + u * VEC;
      cp_async16(k_s + r * sh.rowk + u * 16, kc + off, 16);
      cp_async16(v_s + r * sh.rowv + u * 16, vc + off, 16);
    }
    if (kQCache && lane < nc) {
      const size_t si =
          ((size_t)it.b * a.S_max + it.s_lo + p0 + lane) * KV + it.kvh;
      cp_async_ca<4>(ks_s + lane, a.ks_cache + si, 4);
      cp_async_ca<4>(vs_s + lane, a.vs_cache + si, 4);
    }
    const int qv = HD / 4;   // 16-byte units of a query vector
    for (int e = lane; e < it.qn * qv; e += 32) {
      const int qi = by_qv.div(e), u = e - qi * qv;
      const QHead q = qhead(it.q0 + qi, it.kvh);
      cp_async16(q_s + qi * kHDMax + u * 4,
                 a.qf + (size_t)(it.b * W + q.j) * Dq + q.h * HD + u * 4,
                 16);
    }
    cp_async_commit();
  };

  // the group's items: while one merges and publishes, the next one's
  // copies are in flight
  int i = blockIdx.x * kGroups + grp;
  if (i < total_items) issue(attn_item(a, sh, lens, pre, i));
  for (; i < total_items; i += ngroups) {
    const AttnItem it = attn_item(a, sh, lens, pre, i);
    const int qn = it.qn, len = it.len;
    int nw, nc;
    warp_span(it, &nw, &nc);
    cp_async_wait<0>();
    __syncwarp();

    // scores: position pl of the warp over its two lanes, fmaf along each
    // lane's units (h, h + 2, ...) in head-dim order, q * sm_scale as the
    // kernel scales its queries; the pair summed by one shuffle.  A cached
    // position reads shared memory; a window token (at most W of a row's
    // positions) its fp32 row in the scratch
    const int s = it.s_lo + p0 + pl;
    float sc[kQItem];
#pragma unroll
    for (int qi = 0; qi < kQItem; ++qi) sc[qi] = 0.f;
    auto dot = [&](const float (&kf)[VEC], int u) {
#pragma unroll
      for (int qi = 0; qi < kQItem; ++qi) {
        if (qi < qn) {
          const float4* qp =
              reinterpret_cast<const float4*>(q_s + qi * kHDMax + u * VEC);
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e) {
            const float4 qv = qp[e];
            sc[qi] = fmaf(qv.x * sm_scale, kf[4 * e], sc[qi]);
            sc[qi] = fmaf(qv.y * sm_scale, kf[4 * e + 1], sc[qi]);
            sc[qi] = fmaf(qv.z * sm_scale, kf[4 * e + 2], sc[qi]);
            sc[qi] = fmaf(qv.w * sm_scale, kf[4 * e + 3], sc[qi]);
          }
        }
      }
    };
    if (pl < nc) {
      const float ksc = kQCache ? ks_s[pl] : 1.f;
      const unsigned char* krow = k_s + pl * sh.rowk;
      for (int u = h; u < sh.pieces; u += 2) {
        float kf[VEC];
        unpack16<CT>(*reinterpret_cast<const uint4*>(krow + u * 16), ksc, kf);
        dot(kf, u);
      }
    } else if (pl < nw) {
      const float* wrow = a.kw + (size_t)(it.b * W + (s - len)) * Dk +
                          (size_t)it.kvh * HD;
      for (int u = h; u < sh.pieces; u += 2) {
        float kf[VEC];
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 f =
              __ldcg(reinterpret_cast<const float4*>(wrow + u * VEC) + e);
          kf[4 * e] = f.x;
          kf[4 * e + 1] = f.y;
          kf[4 * e + 2] = f.z;
          kf[4 * e + 3] = f.w;
        }
        dot(kf, u);
      }
    }
    // the warp's softmax state per query: ALiBi (one rounded product, one
    // rounded sum), the masks (past the chunk, past the query's own window
    // position), its max, P and its sum
    float m_own[kQItem], l_own[kQItem];
#pragma unroll
    for (int qi = 0; qi < kQItem; ++qi) {
      m_own[qi] = kNegInf;
      l_own[qi] = 0.f;
      sc[qi] += __shfl_xor_sync(0xffffffffu, sc[qi], 1);
      if (qi >= qn) continue;
      const QHead q = qhead(it.q0 + qi, it.kvh);
      if (a.alibi != nullptr)
        sc[qi] = __fadd_rn(sc[qi], __fmul_rn(__ldg(a.alibi + q.h), (float)s));
      const bool ok = pl < nw && s < len + q.j + 1;
      m_own[qi] = warp_max(ok ? sc[qi] : kNegInf);
      const float pv = ok ? expf(sc[qi] - m_own[qi]) : 0.f;
      if (h == 0) p_s[qi * kWPos + pl] = pv;
      l_own[qi] = warp_sum(h == 0 ? pv : 0.f);
    }
    __syncwarp();
    // P V over the warp's positions, lanes over column pairs: the cached
    // positions from shared memory, then the window's tokens
    float acc[kQItem][2][2];
#pragma unroll
    for (int qi = 0; qi < kQItem; ++qi)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[qi][c][0] = acc[qi][c][1] = 0.f;
    auto pv_add = [&](int r, int c, float2 v) {
#pragma unroll
      for (int qi = 0; qi < kQItem; ++qi) {
        if (qi < qn) {
          const float pv = p_s[qi * kWPos + r];
          acc[qi][c][0] = fmaf(pv, v.x, acc[qi][c][0]);
          acc[qi][c][1] = fmaf(pv, v.y, acc[qi][c][1]);
        }
      }
    };
#pragma unroll 4
    for (int r = 0; r < nc; ++r) {
      const float vsc = kQCache ? vs_s[r] : 1.f;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (lane + 32 * c < HP)
          pv_add(r, c, pair_at<CT>(v_s + r * sh.rowv, lane + 32 * c, vsc));
    }
    for (int r = nc; r < nw; ++r) {
      const float2* vrow = reinterpret_cast<const float2*>(
          a.vw + (size_t)(it.b * W + (it.s_lo + p0 + r - len)) * Dk +
          (size_t)it.kvh * HD);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (lane + 32 * c < HP) pv_add(r, c, __ldcg(vrow + lane + 32 * c));
    }
    __syncwarp();   // the warp is done with its copies: the next item's
    if (i + ngroups < total_items)   // go out under this one's merge
      issue(attn_item(a, sh, lens, pre, i + ngroups));
    group_sync();   // the previous item's readers of the group's partials
#pragma unroll
    for (int qi = 0; qi < kQItem; ++qi) {
      if (qi >= qn) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int pr = lane + 32 * c;
        if (pr < HP)
          *reinterpret_cast<float2*>(red + (gw * kQItem + qi) * kHDMax +
                                     2 * pr) =
              make_float2(acc[qi][c][0], acc[qi][c][1]);
      }
      if (lane == 0) {
        mw[gw * kQItem + qi] = m_own[qi];
        lw[gw * kQItem + qi] = l_own[qi];
      }
    }
    group_sync();
    // the group's warps merged in warp order: the output when the chunk is
    // the item's only one, else its partial (max, sum, P V)
    const bool direct = it.j_last == 0;
    float* slots = a.attn_ws + ((size_t)(it.b * KV + it.kvh) * sh.nqc + it.qc) *
                                   sh.zmax * sh.slotf;
    for (int e = gt; e < qn * HD + qn; e += kGroupWarps * 32) {
      // e < qn HD: an element; past it, the query's (max, sum)
      const bool elem = e < qn * HD;
      const int qi = elem ? by_hd.div(e) : e - qn * HD;
      float M = mw[qi];
#pragma unroll
      for (int w = 1; w < kGroupWarps; ++w) M = fmaxf(M, mw[w * kQItem + qi]);
      float Ls = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < kGroupWarps; ++w) {
        const float f = expf(mw[w * kQItem + qi] - M);
        Ls = fmaf(lw[w * kQItem + qi], f, Ls);
        if (elem)
          O = fmaf(red[(w * kQItem + qi) * kHDMax + (e - qi * HD)], f, O);
      }
      const QHead q = qhead(it.q0 + qi, it.kvh);
      if (direct) {
        if (elem)
          abuf[(size_t)(it.b * W + q.j) * Dq + q.h * HD + (e - qi * HD)] =
              from_f<T>(O / fmaxf(Ls, 1e-30f));
      } else {
        float* part = slots + (size_t)it.z * sh.slotf;
        if (elem) {
          part[2 * sh.qmax + e] = O;
        } else {
          part[qi] = M;
          part[sh.qmax + qi] = Ls;
        }
      }
    }
    if (direct) continue;
    // one acquire-release add after the group's barrier publishes the
    // partial and, for the last, makes the others' visible (as
    // csrc/decode_attention.cu); the last merges the chunks in order
    group_sync();
    int* cnt = a.attn_cnt + (size_t)(it.b * KV + it.kvh) * sh.nqc + it.qc;
    if (gt == 0) s_last[grp] = hopper::atom_add_acq_rel(cnt, 1) == it.j_last;
    group_sync();
    if (!s_last[grp]) continue;
    constexpr int kBatch = 8;   // partials whose loads issue together
    for (int e = gt; e < qn * HD; e += kGroupWarps * 32) {
      const int qi = by_hd.div(e);
      float M = kNegInf, Ls = 0.f, O = 0.f;
      for (int c0 = 0; c0 <= it.j_last; c0 += kBatch) {
        float mv[kBatch], lv[kBatch], av[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const float* pc = slots + (size_t)(c0 + j) * sh.slotf;
          const bool ok = c0 + j <= it.j_last;
          mv[j] = ok ? __ldcg(pc + qi) : kNegInf;
          lv[j] = ok ? __ldcg(pc + sh.qmax + qi) : 0.f;
          av[j] = ok ? __ldcg(pc + 2 * sh.qmax + e) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (c0 + j <= it.j_last) {
            const float Mn = fmaxf(M, mv[j]);
            const float f0 = expf(M - Mn), f1 = expf(mv[j] - Mn);
            Ls = Ls * f0 + lv[j] * f1;
            O = O * f0 + av[j] * f1;
            M = Mn;
          }
        }
      }
      const QHead q = qhead(it.q0 + qi, it.kvh);
      abuf[(size_t)(it.b * W + q.j) * Dq + q.h * HD + (e - qi * HD)] =
          from_f<T>(O / fmaxf(Ls, 1e-30f));
    }
    if (gt == 0) *cnt = 0;
  }
}

// ------------------------------------------------------------------ kernel
template <typename T>
__host__ __device__ constexpr bool stream_t() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// threads of an instance: the compute warps, and the producer warp of a
// stream instance
template <typename T>
__host__ __device__ constexpr int threads_of() {
  return stream_t<T>() ? dstream::kThreads : NT;
}

// shared memory of an instance (bytes): a stream instance's ring (1024-
// aligned) then the attention region; an fp32 instance's GEMM tiles and
// its attention region overlap (no phase uses both)
template <typename T, typename WT, typename CT>
__host__ __device__ constexpr int ring_bytes() {
  return stream_t<T>() ? dstream::Ring<sizeof(WT) == 1>::bytes : 0;
}
template <typename T, typename WT, typename CT>
size_t smem_bytes() {
  if constexpr (stream_t<T>()) {
    return 1024 + ((ring_bytes<T, WT, CT>() + 127) / 128) * 128 +
           AttnSmem<CT>::bytes;
  } else {
    constexpr size_t tile = TileSmem<T, WT>::bytes;
    constexpr size_t rows = RowsSmem<WT>::bytes;
    constexpr size_t gemm = tile > rows ? tile : rows;
    constexpr size_t attn = AttnSmem<CT>::bytes;
    return gemm > attn ? gemm : attn;
  }
}

template <typename T, typename WT, typename CT>
__global__ void __launch_bounds__(threads_of<T>(), 1)
fused_layer_kernel(const FusedArgs a, const __grid_constant__ StreamPlan sp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool kStream = stream_t<T>();
  constexpr bool kQ8 = sizeof(WT) == 1;
  constexpr bool kQCache = sizeof(CT) == 1;
  __shared__ unsigned s_g0;
  unsigned char* ring =
      kStream ? smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023)
              : smem_raw;
  unsigned char* sm =
      kStream ? ring + ((ring_bytes<T, WT, CT>() + 127) / 128) * 128
              : smem_raw;
  const int R = a.B * a.W;
  const int D = a.D, HD = a.HD, KV = a.KV, H = a.H;
  const int Dq = H * HD, Dk = KV * HD;
  const int M = a.mlp_in[0].N;
  const bool rms = a.norm == 1;
  const int nphase = a.mlp == kMlpNone ? 2 : 4;
  if constexpr (kStream) {
    if (threadIdx.x == 0) {
      s_g0 = *static_cast<volatile unsigned*>(a.bar + 1);
      dstream::init_ring<kQ8>(ring);
    }
    __syncthreads();
    if (threadIdx.x >= NT) {
      produce<kQ8>(a, sp, ring, s_g0, nphase);
      return;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int nthreads = gridDim.x * NT;
  T* abuf = static_cast<T*>(a.abuf);
  T* xres = static_cast<T*>(a.xres);
  const T* x = static_cast<const T*>(a.x);
  int it = 0;   // the stream's stage counter
  auto gemm = [&](int ph, const T* A, int lda, int K, const Mat* mats,
                  int j0, int n) {
    if constexpr (kStream)
      stream_phase<kQ8>(a, sp, ph, ring, it);
    else
      gemm_phase<T, WT>(A, lda, R, K, mats, sp.p + j0, n, smem_raw);
  };
  stamp(a, 0);

  // ---- norm1: one CTA per row
  for (int r = blockIdx.x; r < R; r += gridDim.x)
    norm_cta<T>(x + (size_t)r * D, abuf + (size_t)r * D, a.n1_s, a.n1_b, D,
                a.eps, rms);
  grid_sync<kStream>(a.bar);
  stamp(a, 1);

  // ---- QKV projection partials (one fused matrix, or wq / wk / wv)
  gemm(0, abuf, D, D, a.qkv, 0, a.nqkv);
  grid_sync<kStream>(a.bar);
  stamp(a, 2);

  // ---- QKV epilogue: one warp per (row, head segment of q | k | v);
  // bias in T, rotary on the first rot dims of q and k at position
  // lengths[b] + j, the new K/V as the cache holds them
  {
    const int nseg = H + 2 * KV;
    const int half = a.rot / 2;
    float* rbuf = reinterpret_cast<float*>(sm) + warp * kHDMax;
    for (int wi = gwarp; wi < R * nseg; wi += nwarps) {
      const int r = wi / nseg, seg = wi - r * nseg;
      // the segment's projection and its first column there: thirds
      // [q heads | k heads | v heads] across one or three matrices, or
      // head-major (head h's q, k, v at h * 3 HD + {0, 1, 2} HD)
      int mi = 0, c0 = seg * HD;
      if (a.headmajor) {
        const int kind = seg < H ? 0 : (seg < H + KV ? 1 : 2);
        c0 = (seg - kind * H) * 3 * HD + kind * HD;
      }
      while (mi + 1 < a.nqkv && c0 >= a.qkv[mi].N) c0 -= a.qkv[mi++].N;
      const Mat& m = a.qkv[mi];
      float val[kNI];
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int d = lane + 32 * i;
        val[i] = d < HD ? proj_value<T>(m, R, r, c0 + d) : 0.f;
      }
      if (a.rope != nullptr && seg < H + KV) {
        const float pos = (float)(a.lengths[r / a.W] + r % a.W);
#pragma unroll
        for (int i = 0; i < kNI; ++i)
          if (lane + 32 * i < HD) rbuf[lane + 32 * i] = val[i];
        __syncwarp();
#pragma unroll
        for (int i = 0; i < kNI; ++i) {
          const int d = lane + 32 * i;
          if (d >= a.rot) continue;    // past the rotary dims: as projected
          const int f = d < half ? d : d - half;
          const float x1 = rbuf[f], x2 = rbuf[f + half];
          const float ang = __fmul_rn(pos, __ldg(a.rope + f));
          const float cs = cosf(ang), sn = sinf(ang);
          val[i] = round_t<T>(
              d < half ? __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn))
                       : __fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs)));
        }
        __syncwarp();   // every lane has read rbuf before the next item
      }
      if (seg < H) {
#pragma unroll
        for (int i = 0; i < kNI; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) a.qf[(size_t)r * Dq + seg * HD + d] = val[i];
        }
        continue;
      }
      const bool is_k = seg < H + KV;
      const int kvh = seg - H - (is_k ? 0 : KV);
      CT* nout = static_cast<CT*>(is_k ? a.new_k : a.new_v);
      float* win = is_k ? a.kw : a.vw;
      const size_t base = (size_t)r * Dk + (size_t)kvh * HD;
      float scale = 1.f;
      if constexpr (kQCache) {
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < kNI; ++i) amax = fmaxf(amax, fabsf(val[i]));
        amax = warp_max(amax);
        scale = amax > 0.f ? amax / 127.f : 1.f;
        if (lane == 0) (is_k ? a.new_ks : a.new_vs)[(size_t)r * KV + kvh] =
            scale;
      }
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int d = lane + 32 * i;
        if (d >= HD) continue;
        if constexpr (kQCache) {
          const float code = fminf(fmaxf(rintf(val[i] / scale), -127.f),
                                   127.f);
          nout[base + d] = (int8_t)(int)code;
          win[base + d] = code * scale;
        } else {
          nout[base + d] = from_f<CT>(val[i]);
          win[base + d] = to_f(from_f<CT>(val[i]));
        }
      }
    }
  }
  grid_sync<kStream>(a.bar);
  stamp(a, 3);

  // ---- attention over the cache and the window, split over the cache
  attention_phase<T, CT>(a, sm);
  grid_sync<kStream>(a.bar);
  stamp(a, 4);

  // ---- attention-out projection partials (A = the attention rows)
  gemm(1, abuf, Dq, Dq, &a.o, 3, 1);
  grid_sync<kStream>(a.bar);
  stamp(a, 5);

  // ---- (+ bias), + residual; mlp "none" ends the layer here
  T* xo = static_cast<T*>(a.x_out);
  const bool last = a.mlp == kMlpNone;
  for (int e = gtid; e < R * D; e += nthreads) {
    const int r = e / D, c = e - r * D;
    const T y = from_f<T>(to_f(x[e]) + proj_value<T>(a.o, R, r, c));
    (last ? xo : xres)[e] = y;
  }
  if (last) {
    for (int i = 6; i < 12; ++i) stamp(a, i);
    return;
  }
  grid_sync<kStream>(a.bar);
  stamp(a, 6);

  // ---- norm2: one CTA per row, over x + attn (serial residual) or the
  // layer input x (parallel residual)
  const T* n2_src = a.parallel ? x : xres;
  for (int r = blockIdx.x; r < R; r += gridDim.x)
    norm_cta<T>(n2_src + (size_t)r * D, abuf + (size_t)r * D, a.n2_s,
                a.n2_b, D, a.eps, rms);
  grid_sync<kStream>(a.bar);
  stamp(a, 7);

  // ---- MLP-in partials (w_in, or w_gate and w_up)
  gemm(2, abuf, D, D, a.mlp_in, 4, a.nmlp_in);
  grid_sync<kStream>(a.bar);
  stamp(a, 8);

  // ---- (+ bias) and the activation in fp32, or silu(gate) in fp32
  // rounded to T times up in T; the result rounded to T
  for (int e = gtid; e < R * M; e += nthreads) {
    const int r = e / M, c = e - r * M;
    const float h = proj_value<T>(a.mlp_in[0], R, r, c);
    float y;
    if (a.mlp == kMlpSwiglu) {
      const float up = proj_value<T>(a.mlp_in[1], R, r, c);
      y = __fmul_rn(round_t<T>(h / (1.f + expf(-h))), up);
    } else {
      y = activation(h, a.mlp);
    }
    abuf[e] = from_f<T>(y);
  }
  grid_sync<kStream>(a.bar);
  stamp(a, 9);

  // ---- MLP-out partials (A = the activations, row stride M)
  gemm(3, abuf, M, M, &a.mlp_out, 6, 1);
  grid_sync<kStream>(a.bar);
  stamp(a, 10);

  // ---- (+ bias), + residual: (x + attn) + mlp in both residual forms
  for (int e = gtid; e < R * D; e += nthreads) {
    const int r = e / D, c = e - r * D;
    xo[e] = from_f<T>(to_f(ldcg_t<T>(xres + e)) +
                      proj_value<T>(a.mlp_out, R, r, c));
  }
  stamp(a, 11);
}

// co-resident CTAs of the cooperative grid (at most two per SM), or a
// negative cudaError_t; worked out once per device
template <typename T, typename WT, typename CT>
int grid_for() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return -(int)cudaErrorInvalidDevice;
  if (cached[dev] > 0) return cached[dev];
  const size_t smem = smem_bytes<T, WT, CT>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_layer_kernel<T, WT, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, fused_layer_kernel<T, WT, CT>, threads_of<T>(), smem);
  if (err != cudaSuccess) return -(int)err;
  const int sms = sm_count();
  if (occ < 1 || sms < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  cached[dev] = sms * (occ < 2 ? occ : 2);
  return cached[dev];
}

// Each projection of a phase (all over the same K): its split by the
// decode forms' rule (N, K and the SM count) and, for a stream instance,
// its weight map and units; its partial sums then take split * R * N
// floats of the scratch from the phase's base.  Returns false when the
// scratch (part_floats) is too small or a map is refused.
template <bool kStream, bool Q8>
bool plan_phase(Mat* mats, dstream::Proj* projs, CUtensorMap* maps, int n,
                int R, int K, int sms, const FusedArgs& a, int* units) {
  long long off = 0;
  *units = 0;
  for (int j = 0; j < n; ++j) {
    projs[j] = dstream::make_proj(Q8 ? mats[j].s : nullptr, mats[j].N, K,
                                  Q8 ? mats[j].nb : 0, sms);
    mats[j].split = projs[j].nsplit;
    mats[j].part = a.part + off;
    off += (long long)projs[j].nsplit * R * mats[j].N;
    if constexpr (kStream) {
      if (!dstream::stream_ok(K, mats[j].N, Q8 ? mats[j].nb : 0, Q8, a.abuf,
                              mats[j].w) ||
          !dstream::weight_map(maps + j, mats[j].w, K, mats[j].N, Q8))
        return false;
      *units += dstream::units_of(projs[j], R);
    }
  }
  return off <= a.part_floats;
}

template <typename T, typename WT, typename CT>
int launch(FusedArgs a, cudaStream_t stream) {
  constexpr bool kStream = stream_t<T>();
  constexpr bool kQ8 = sizeof(WT) == 1;
  const int grid = grid_for<T, WT, CT>();
  if (grid < 0) return -grid;
  const int sms = sm_count();
  const int R = a.B * a.W;
  const int M = a.mlp_in[0].N;
  const int Dq = a.H * a.HD;
  if (a.HD % 4 || (a.HD * (int)sizeof(CT)) % 16 || a.B > kBMax ||
      a.attn_ws == nullptr || a.attn_cnt == nullptr ||
      a.attn_floats < attn_ws_floats(a.B, a.W, a.H, a.KV, a.HD, a.S_max) ||
      (uintptr_t)a.k_cache % 16 || (uintptr_t)a.v_cache % 16)
    return (int)cudaErrorInvalidValue;
  StreamPlan sp{};
  // every phase's partial sums start at the scratch's base: the phases
  // are separated by grid barriers
  const int nmlp = a.nmlp_in;
  bool ok = plan_phase<kStream, kQ8>(a.qkv, sp.p, sp.w, a.nqkv, R, a.D, sms,
                                     a, &sp.units[0]) &&
            plan_phase<kStream, kQ8>(&a.o, sp.p + 3, sp.w + 3, 1, R, Dq, sms,
                                     a, &sp.units[1]) &&
            plan_phase<kStream, kQ8>(a.mlp_in, sp.p + 4, sp.w + 4, nmlp, R,
                                     a.D, sms, a, &sp.units[2]) &&
            plan_phase<kStream, kQ8>(&a.mlp_out, sp.p + 6, sp.w + 6,
                                     nmlp > 0, R, M, sms, a, &sp.units[3]);
  if (kStream && ok) {
    const int ks[4] = {a.D, Dq, a.D, M};
    for (int ph = 0; ph < (nmlp > 0 ? 4 : 2) && ok; ++ph)
      ok = dstream::rows_map(sp.x + ph, a.abuf, R, ks[ph], ks[ph]);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  void* params[] = {&a, &sp};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)fused_layer_kernel<T, WT, CT>, dim3(grid),
      dim3(threads_of<T>()), params, smem_bytes<T, WT, CT>(), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One instance's launch, with external linkage: each is instantiated in
// its own compilation of csrc/fused_decode_layer.cu and only declared
// (extern template) where csrc/fused_decode.cu dispatches to it.
template <typename T, typename WT, typename CT>
int ds_fused_launch(const FusedArgs& a, cudaStream_t stream) {
  return launch<T, WT, CT>(a, stream);
}
