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
// layer's weights (28.3 MB int8 or 56.6 MB bf16 for GPT-2 760M, 202 MB
// bf16 for Llama-2 7B) and the KV cache stream through once; everything
// else is a few KB.  The TPU kernel kept the whole layer resident in 96
// MiB of VMEM; Hopper has 227 KB of shared memory per block, so this
// kernel streams each weight byte once per call instead: it is ONE
// persistent cooperative launch (grid = the CTAs the card keeps
// co-resident) that walks the phases above, with a grid-wide barrier
// between phases.  In a GEMM phase the work items are (projection,
// column tile, K split) triples over all B*W rows: a phase's projections
// (wq / wk / wv, or w_gate / w_up) share one item space, so the split
// projections fill the grid together.  At decode (B*W <= 8) a
// 256-column tile's weight rows stream straight into registers
// (gemm_tile.cuh rows_mma), else 64-row x 64-column tiles go through
// shared memory (tile_mma).  Every weight tile is read by one CTA only;
// its fp32 partial sums go to a small global scratch (L2-resident) and
// the next phase reduces them in split order, so a row's result does not
// depend on which other rows share the batch.  Activations between phases
// live in the same scratch and are read back through L2 (ld.global.cg):
// L1 is not coherent across SMs.  Grouped-query attention indexes KV
// head h / rep: one work item holds up to kQMax query vectors of one KV
// head, so each cache position is read once per group (the Pallas
// kernel's selector matmuls are a TPU layout device, not needed here).
// The spec's features are runtime fields of FusedArgs, not template
// parameters: one instantiation per (compute, weight, cache) dtype.
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
};

namespace {

using namespace dstile;

constexpr int kWarps = NT / 32;
constexpr int kQMax = 8;       // query vectors per attention work item
constexpr int kPos = 4;        // cache positions per warp iteration
constexpr int kHDMax = 128;    // head_dim <= 128
constexpr int kNI = kHDMax / 32;
constexpr int kMaxSplit = 16;  // K splits per GEMM
constexpr int kMlpSwiglu = 3, kMlpNone = 4;
constexpr float kNegInf = -1e30f;

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

// Sense-free grid barrier over co-resident CTAs: bar[0] counts arrivals
// (the last one returns it to 0), bar[1] is a generation number the
// others wait on.  The fences make every write before the barrier visible
// to every CTA after it (readers use L2 loads).
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
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
  __syncthreads();
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

// the sum of v over the CTA, returned to every thread (warp sums added in
// warp order)
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[kWarps];
  v = warp_sum(v);
  __syncthreads();   // a previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// LayerNorm (rms = false: (x - mean) * rstd * scale + bias) or RMSNorm
// (rms = true: x * rstd * scale, rstd from the mean square) of a row of D
// values at `src` (T; a kernel input or written earlier in this launch,
// so read through L2) into `dst` (T), by the whole CTA: statistics in
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

// work items of one projection: (row tile, column tile, K split) triples
__host__ __device__ inline int mat_tiles(int R, int N, int nb) {
  const bool rows = use_rows(R, N, nb);
  const int bn = rows ? RBN : BN, rmax = rows ? RROWS : RPMAX;
  return ((N + bn - 1) / bn) * ((R + rmax - 1) / rmax);
}

// One GEMM phase over `nmat` projections sharing A and K:
// mats[j].part[split][r][n] = sum over the split's K range of A[r][k] *
// W~j[k][n] for all R rows, every (projection, row tile, column tile,
// split) item taken by one CTA: [8 x 256] decode tiles (rows_mma) for
// R <= 8, else [64 x 64] tiles (tile_mma).
template <typename T, typename WT>
__device__ void gemm_phase(const T* A, int lda, int R, int K,
                           const Mat* mats, int nmat, unsigned char* smem) {
  const int kch = (K + BK - 1) / BK;
  int items[3], total = 0;
  for (int j = 0; j < nmat; ++j) {
    items[j] = mat_tiles(R, mats[j].N, sizeof(WT) == 1 ? mats[j].nb : 0) *
               mats[j].split;
    total += items[j];
  }
  for (int it = blockIdx.x; it < total; it += gridDim.x) {
    int j = 0, local = it;
    while (local >= items[j]) local -= items[j++];
    const Mat& m = mats[j];
    const int N = m.N, nb = sizeof(WT) == 1 ? m.nb : 0, nsplit = m.split;
    const bool rows = use_rows(R, N, nb);
    const int bn = rows ? RBN : BN, rmax = rows ? RROWS : RPMAX;
    const int tn = (N + bn - 1) / bn;
    const int chunks = (kch + nsplit - 1) / nsplit;
    const int qblock = nb > 0 ? (N + nb - 1) / nb : 1;
    const int split = local % nsplit;
    const int rest = local / nsplit;
    const int tni = rest % tn, tmi = rest / tn;
    const int m0 = tmi * rmax;
    const int nrows = min(rmax, R - m0);
    const int n0 = tni * bn;
    const int kb = split * chunks * BK;
    const int ke = min(K, kb + chunks * BK);
    const WT* Wt = static_cast<const WT*>(m.w);
    const float* ct =
        rows ? rows_mma<T, WT>(A, lda, R, Wt, m.s, nb, qblock, N, n0, kb, ke,
                               smem)
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

template <typename T, typename WT, typename CT>
__global__ void __launch_bounds__(NT)
fused_layer_kernel(const FusedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kQCache = sizeof(CT) == 1;
  const int R = a.B * a.W;
  const int D = a.D, HD = a.HD, KV = a.KV, H = a.H;
  const int Dq = H * HD, Dk = KV * HD;
  const int M = a.mlp_in[0].N;
  const bool rms = a.norm == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int nthreads = gridDim.x * NT;
  T* abuf = static_cast<T*>(a.abuf);
  T* xres = static_cast<T*>(a.xres);
  const T* x = static_cast<const T*>(a.x);
  stamp(a, 0);

  // ---- norm1: one CTA per row
  for (int r = blockIdx.x; r < R; r += gridDim.x)
    norm_cta<T>(x + (size_t)r * D, abuf + (size_t)r * D, a.n1_s, a.n1_b, D,
                a.eps, rms);
  grid_sync(a.bar);
  stamp(a, 1);

  // ---- QKV projection partials (one fused matrix, or wq / wk / wv)
  gemm_phase<T, WT>(abuf, D, R, D, a.qkv, a.nqkv, smem);
  grid_sync(a.bar);
  stamp(a, 2);

  // ---- QKV epilogue: one warp per (row, head segment of q | k | v);
  // bias in T, rotary on the first rot dims of q and k at position
  // lengths[b] + j, the new K/V as the cache holds them
  {
    const int nseg = H + 2 * KV;
    const int half = a.rot / 2;
    float* rbuf = reinterpret_cast<float*>(smem) + warp * kHDMax;
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
  grid_sync(a.bar);
  stamp(a, 3);

  // ---- attention: one CTA per (row b, kv head, chunk of <= kQMax
  // queries); query qi is window position qi / rep of head kvh * rep +
  // qi % rep and sees the cache's first len positions plus window
  // positions <= its own
  {
    const int rep = H / KV;
    const int nq = a.W * rep;
    const int nqc = (nq + kQMax - 1) / kQMax;
    float* q_s = reinterpret_cast<float*>(smem);        // [kQMax][kHDMax]
    float* acc_s = q_s + kQMax * kHDMax;                // [kWarps][kQMax][kHDMax]
    float* m_s = acc_s + kWarps * kQMax * kHDMax;       // [kWarps][kQMax]
    float* l_s = m_s + kWarps * kQMax;                  // [kWarps][kQMax]
    const size_t pos_stride = (size_t)Dk;
    for (int it = blockIdx.x; it < a.B * KV * nqc; it += gridDim.x) {
      const int b = it / (KV * nqc);
      const int kvh = (it / nqc) % KV;
      const int q0 = (it % nqc) * kQMax;
      const int qn = min(kQMax, nq - q0);
      int len = a.lengths[b];
      len = len < 0 ? 0 : (len > a.S_max ? a.S_max : len);
      __syncthreads();    // the previous item's smem reads are done
      for (int e = threadIdx.x; e < qn * HD; e += NT) {
        const int qi = e / HD, d = e - qi * HD;
        const int qq = q0 + qi;
        const int j = qq / rep, h = kvh * rep + qq % rep;
        q_s[qi * kHDMax + d] =
            __ldcg(a.qf + (size_t)(b * a.W + j) * Dq + h * HD + d) *
            a.sm_scale;
      }
      __syncthreads();
      int lim[kQMax];
      float slope[kQMax];
#pragma unroll
      for (int qi = 0; qi < kQMax; ++qi) {
        lim[qi] = qi < qn ? len + (q0 + qi) / rep + 1 : 0;
        slope[qi] = (a.alibi != nullptr && qi < qn)
                        ? __ldg(a.alibi + kvh * rep + (q0 + qi) % rep)
                        : 0.f;
      }
      const int total = len + (q0 + qn - 1) / rep + 1;
      float mx_[kQMax], l[kQMax], acc[kQMax][kNI];
#pragma unroll
      for (int qi = 0; qi < kQMax; ++qi) {
        mx_[qi] = kNegInf;
        l[qi] = 0.f;
#pragma unroll
        for (int i = 0; i < kNI; ++i) acc[qi][i] = 0.f;
      }
      const CT* kb_ = static_cast<const CT*>(a.k_cache) +
                      (size_t)b * a.S_max * pos_stride + (size_t)kvh * HD;
      const CT* vb_ = static_cast<const CT*>(a.v_cache) +
                      (size_t)b * a.S_max * pos_stride + (size_t)kvh * HD;
      for (int s0 = warp * kPos; s0 < total; s0 += kWarps * kPos) {
        float kx[kPos][kNI], vx[kPos][kNI];
#pragma unroll
        for (int jp = 0; jp < kPos; ++jp) {
          const int s = s0 + jp;
          float ksc = 1.f, vsc = 1.f;
          if constexpr (kQCache) {
            if (s < len) {
              ksc = __ldg(a.ks_cache + ((size_t)b * a.S_max + s) * KV + kvh);
              vsc = __ldg(a.vs_cache + ((size_t)b * a.S_max + s) * KV + kvh);
            }
          }
#pragma unroll
          for (int i = 0; i < kNI; ++i) {
            const int d = lane + 32 * i;
            float kv_k = 0.f, kv_v = 0.f;
            if (d < HD) {
              if (s < len) {
                kv_k = to_f(kb_[(size_t)s * pos_stride + d]) * ksc;
                kv_v = to_f(vb_[(size_t)s * pos_stride + d]) * vsc;
              } else if (s < total) {
                const size_t w = (size_t)(b * a.W + (s - len)) * Dk +
                                 (size_t)kvh * HD + d;
                kv_k = __ldcg(a.kw + w);
                kv_v = __ldcg(a.vw + w);
              }
            }
            kx[jp][i] = kv_k;
            vx[jp][i] = kv_v;
          }
        }
#pragma unroll
        for (int qi = 0; qi < kQMax; ++qi) {
          if (qi < qn) {
            float sc[kPos];
#pragma unroll
            for (int jp = 0; jp < kPos; ++jp) {
              float p = 0.f;
#pragma unroll
              for (int i = 0; i < kNI; ++i) {
                const int d = lane + 32 * i;
                if (d < HD) p += q_s[qi * kHDMax + d] * kx[jp][i];
              }
              sc[jp] = warp_sum(p);
              // ALiBi: position s0 + jp (a cache position, or the window
              // token at lengths[b] + (s - len))
              if (a.alibi != nullptr)
                sc[jp] = __fadd_rn(sc[jp],
                                   __fmul_rn(slope[qi], (float)(s0 + jp)));
            }
            float mx = mx_[qi];
#pragma unroll
            for (int jp = 0; jp < kPos; ++jp)
              if (s0 + jp < lim[qi]) mx = fmaxf(mx, sc[jp]);
            const float corr = expf(mx_[qi] - mx);
            float pj[kPos];
            float psum = 0.f;
#pragma unroll
            for (int jp = 0; jp < kPos; ++jp) {
              pj[jp] = (s0 + jp < lim[qi]) ? expf(sc[jp] - mx) : 0.f;
              psum += pj[jp];
            }
            l[qi] = l[qi] * corr + psum;
            mx_[qi] = mx;
#pragma unroll
            for (int i = 0; i < kNI; ++i) {
              float t = acc[qi][i] * corr;
#pragma unroll
              for (int jp = 0; jp < kPos; ++jp) t += pj[jp] * vx[jp][i];
              acc[qi][i] = t;
            }
          }
        }
      }
      // merge the warps' partial softmax states
#pragma unroll
      for (int qi = 0; qi < kQMax; ++qi) {
        if (qi < qn) {
#pragma unroll
          for (int i = 0; i < kNI; ++i) {
            const int d = lane + 32 * i;
            if (d < HD) acc_s[(warp * kQMax + qi) * kHDMax + d] = acc[qi][i];
          }
          if (lane == 0) {
            m_s[warp * kQMax + qi] = mx_[qi];
            l_s[warp * kQMax + qi] = l[qi];
          }
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < qn * HD; e += NT) {
        const int qi = e / HD, d = e - qi * HD;
        float Mx = kNegInf;
        for (int w = 0; w < kWarps; ++w) Mx = fmaxf(Mx, m_s[w * kQMax + qi]);
        float L = 0.f, O = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          const float f = expf(m_s[w * kQMax + qi] - Mx);
          L += l_s[w * kQMax + qi] * f;
          O += acc_s[(w * kQMax + qi) * kHDMax + d] * f;
        }
        const int qq = q0 + qi;
        const int j = qq / rep, h = kvh * rep + qq % rep;
        abuf[(size_t)(b * a.W + j) * Dq + h * HD + d] =
            from_f<T>(O / fmaxf(L, 1e-30f));
      }
    }
  }
  grid_sync(a.bar);
  stamp(a, 4);

  // ---- attention-out projection partials (A = the attention rows)
  gemm_phase<T, WT>(abuf, Dq, R, Dq, &a.o, 1, smem);
  grid_sync(a.bar);
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
  grid_sync(a.bar);
  stamp(a, 6);

  // ---- norm2: one CTA per row, over x + attn (serial residual) or the
  // layer input x (parallel residual)
  const T* n2_src = a.parallel ? x : xres;
  for (int r = blockIdx.x; r < R; r += gridDim.x)
    norm_cta<T>(n2_src + (size_t)r * D, abuf + (size_t)r * D, a.n2_s,
                a.n2_b, D, a.eps, rms);
  grid_sync(a.bar);
  stamp(a, 7);

  // ---- MLP-in partials (w_in, or w_gate and w_up)
  gemm_phase<T, WT>(abuf, D, R, D, a.mlp_in, a.nmlp_in, smem);
  grid_sync(a.bar);
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
  grid_sync(a.bar);
  stamp(a, 9);

  // ---- MLP-out partials (A = the activations, row stride M)
  gemm_phase<T, WT>(abuf, M, R, M, &a.mlp_out, 1, smem);
  grid_sync(a.bar);
  stamp(a, 10);

  // ---- (+ bias), + residual: (x + attn) + mlp in both residual forms
  for (int e = gtid; e < R * D; e += nthreads) {
    const int r = e / D, c = e - r * D;
    xo[e] = from_f<T>(to_f(ldcg_t<T>(xres + e)) +
                      proj_value<T>(a.mlp_out, R, r, c));
  }
  stamp(a, 11);
}

template <typename T, typename WT>
size_t smem_bytes() {
  constexpr size_t attn =
      (size_t)(kQMax * kHDMax + kWarps * kQMax * kHDMax + 2 * kWarps * kQMax) *
      sizeof(float);
  constexpr size_t tile = TileSmem<T, WT>::bytes;
  constexpr size_t rows = RowsSmem<WT>::bytes;
  constexpr size_t gemm = tile > rows ? tile : rows;
  return gemm > attn ? gemm : attn;
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
  const size_t smem = smem_bytes<T, WT>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_layer_kernel<T, WT, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, fused_layer_kernel<T, WT, CT>, NT, smem);
  if (err != cudaSuccess) return -(int)err;
  const int sms = sm_count();
  if (occ < 1 || sms < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  cached[dev] = sms * (occ < 2 ? occ : 2);
  return cached[dev];
}

// K splits of a phase's projections (all over the same K) on `grid`
// CTAs: as many as keep their items together within one wave, at most
// kMaxSplit, none without a BK chunk of work; each projection's partial
// sums then take split * R * N floats of the scratch from `*used` on.
// Returns false when the scratch (part_floats) is too small.
bool plan_phase(Mat* mats, int n, int grid, int R, int K, bool q8,
                const FusedArgs& a, long long* used) {
  int tiles = 0;
  for (int j = 0; j < n; ++j) tiles += mat_tiles(R, mats[j].N,
                                                 q8 ? mats[j].nb : 0);
  if (n == 0) return true;
  const int kch = (K + BK - 1) / BK;
  int s = grid / tiles;
  s = s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s);
  s = s > kch ? kch : s;
  const int chunks = (kch + s - 1) / s;
  s = (kch + chunks - 1) / chunks;
  long long off = 0;
  for (int j = 0; j < n; ++j) {
    mats[j].split = s;
    mats[j].part = a.part + off;
    off += (long long)s * R * mats[j].N;
  }
  *used = off > *used ? off : *used;
  return off <= a.part_floats;
}

template <typename T, typename WT, typename CT>
int launch(FusedArgs a, cudaStream_t stream) {
  const int grid = grid_for<T, WT, CT>();
  if (grid < 0) return -grid;
  const int R = a.B * a.W;
  const bool q8 = sizeof(WT) == 1;
  const int M = a.mlp_in[0].N;
  long long used = 0;
  // every phase's partial sums start at the scratch's base: the phases
  // are separated by grid barriers
  if (!plan_phase(a.qkv, a.nqkv, grid, R, a.D, q8, a, &used) ||
      !plan_phase(&a.o, 1, grid, R, a.H * a.HD, q8, a, &used) ||
      !plan_phase(a.mlp_in, a.nmlp_in, grid, R, a.D, q8, a, &used) ||
      !plan_phase(&a.mlp_out, a.nmlp_in > 0, grid, R, M, q8, a, &used))
    return (int)cudaErrorInvalidValue;
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)fused_layer_kernel<T, WT, CT>, dim3(grid), dim3(NT),
      params, smem_bytes<T, WT>(), stream);
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
