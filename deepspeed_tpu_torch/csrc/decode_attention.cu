// Decode attention: one query token per row attends to the first
// cache_len[b] positions of a dense KV cache.
//
// Replaces: deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel,
// the float cache and the int8 cache (``quantized=True``: int8 k/v with
// one fp32 scale per (position, kv head), dequantized as code * scale in
// fp32, the query, scores, softmax and accumulation in fp32 as the Pallas
// kernel does), each with the ALiBi variant (``alibi=True``: the score of
// key position s for query head h gets slopes[h] * s before the softmax)
// and the windowed variant (``windowed=True``: positions below a per-row
// floor min_pos[b] are masked).  Both extras are runtime pointers, null
// when off, so the two cache types stay the only template instances.
//
// What bounds it on an H100: bytes.  Each (row, kv head) streams its
// attended positions' 2 * head_dim values once and does ~4 flops per
// value, far below the ~295 flops per byte the card needs before its
// arithmetic is the limit.  A decode step's cache is small (15.5 MB for a
// BLOOM-560m layer at B 8), so the time is set by how many bytes are in
// flight at once and by the latency each CTA adds after they land, not by
// a long stream.  The design ("flash-decoding", split over the sequence):
//   - each row's positions split into chunks of C positions at fixed
//     absolute boundaries ([jC, jC + C)), C a compile-time constant per
//     head dim and cache type (chunk_positions: the largest of 64 / 128 /
//     256 whose K and V fit 96 KB); one CTA per (chunk,
//     kv head, row).  The grid's chunk index counts from the row's first
//     live chunk and runs slowest, so the CTAs past a row's live chunks
//     come last and exit at once.  The rep = H / KV query heads of a
//     group share each K/V load;
//   - each of the 8 warps owns C / 8 positions of the chunk: it copies
//     their K and V rows into shared memory by 16-byte cp.async (both
//     issued before any wait; positions below the floor or at / past
//     min(cache_len, S_max) are never read), scores them as soon as its
//     own K rows land (256 / C lanes a position, fmaf in head-dim order,
//     summed by shuffles), keeps its own softmax state (max, sum) and
//     P V (lanes over column pairs), and meets the other warps once, when
//     their states merge in warp order.  Rows are padded to an odd
//     number of 16-byte units, so a quarter-warp's reads meet eight bank
//     groups.  Two CTAs an SM (the register cap), each of 256 threads;
//   - one launch a call: a row whose live positions fit one chunk writes
//     its output directly; otherwise each chunk writes (m, l, acc) in
//     fp32 to the workspace, and the last CTA of the (row, kv head) to
//     arrive (an int counter per (row, kv head), one acquire-release add
//     by one thread, returned to 0 by that CTA; no float atomics) merges
//     the partials in chunk order.
// A row's bits therefore follow only its own q, cache, length, floor and
// sm_scale: the chunks, their sums and the merge order depend on nothing
// else (not B, S_max, the other rows or the number of SMs).  The TPU
// kernel's block-diagonal query matmul filled a 128-lane MXU and has no
// counterpart here.  A row with nothing to attend returns exact zeros.
//
// ALiBi adds one product and one sum per score, each rounded on its own
// (__fmul_rn / __fadd_rn, no contraction), as the fused layer kernel
// does, so the two agree.
//
// C interface (loaded with ctypes): ds_decode_attention and
// ds_decode_attention_int8 return the cudaError_t of the launch as an int;
// `slopes` ([H] fp32, query-head order) and `min_pos` ([B] int32) may be
// null.  `ws` holds B * KV * ceil(S_max / 64) * rep * (head_dim + 2)
// floats and `counters` B * KV ints, all 0 (each launch leaves them 0);
// q, k and v must be 16-byte aligned.  ds_decode_attention_chunk gives an
// instance's C.
#include <type_traits>

#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace {

using dstile::cp_async16;
using dstile::cp_async_commit;
using dstile::cp_async_wait;
using dstile::from_f;
using dstile::to_f;

constexpr int kMaxRep = 8;
constexpr int kThreads = 256;
// CTAs an SM must hold at once: the register cap (128 a thread) the
// compiler keeps to, with 0 spills
constexpr int kMinBlocks = 2;
// K + V bytes of a chunk at most (the chunk's positions follow from it)
constexpr int kChunkBytes = 98304;
// the smallest chunk of any instance: the workspace holds ceil(S_max /
// kMinChunk) partials per (row, kv head) (the wrapper's MIN_CHUNK)
constexpr int kMinChunk = 64;
constexpr int kMaxChunk = 256;
constexpr int kMergeBatch = 8;   // partials the merge loads at once
constexpr float kNegInf = -1e30f;

// positions per chunk for head vectors of HD elements of SZ bytes: the
// largest power of two in [kMinChunk, kMaxChunk] whose K and V fit
// kChunkBytes (else kMinChunk)
__host__ __device__ constexpr int chunk_positions(int hd, int sz) {
  int c = kMaxChunk;
  while (c > kMinChunk && 2 * c * hd * sz > kChunkBytes) c >>= 1;
  return c;
}

template <typename CT, int HD>
struct Cfg {
  static constexpr int SZ = sizeof(CT);
  static constexpr int C = chunk_positions(HD, SZ);
  static constexpr int TPP = kThreads / C;      // threads a position
  static constexpr int NW = kThreads / 32;
  static constexpr int PIECES = HD * SZ / 16;   // 16-byte units a vector
  static constexpr int VEC = 16 / SZ;           // elements a unit
  static constexpr int UPT = (PIECES + TPP - 1) / TPP;  // units a thread
  // a row is TPP times an odd number of units: a quarter-warp's reads of
  // 8 / TPP rows, TPP adjacent units each, meet eight bank groups
  static constexpr int ROWB = TPP * (UPT | 1) * 16;
  static constexpr int NPAIR = (HD / 2 + 31) / 32;      // pairs a lane
  static_assert(HD * SZ % 16 == 0, "head vectors are whole 16-byte units");
  static_assert(kThreads % C == 0 && C >= kMinChunk, "a thread a position");
  static_assert(HD % 4 == 0 && VEC % 4 == 0, "float4 query reads");
};

// shared memory (byte offsets) for rep query heads a group: K rows, V
// rows, the scaled queries, P, the V scales, the warps' P V sums
struct Layout {
  int v, q, p, vs, red, bytes;
};
template <typename CT, int HD>
__host__ __device__ inline Layout layout_of(int rep) {
  using G = Cfg<CT, HD>;
  Layout o;
  o.v = G::C * G::ROWB;
  o.q = o.v + G::C * G::ROWB;
  o.p = o.q + rep * HD * 4;
  o.vs = o.p + rep * G::C * 4;
  o.red = o.vs + G::C * 4;
  o.bytes = o.red + G::NW * rep * HD * 4;
  return o;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// q [B, H, HD], k/v [B, S_max, KV, HD] (CT: T, or int8 with ks/vs
// [B, S_max, KV] fp32 scales), cache_len [B], out [B, H, HD]; all
// contiguous.  slopes [H] (ALiBi) and min_pos [B] (window floor) or null.
// ws / counters: see the C interface.  Grid (KV, B, ceil(S_max / C)): z
// counts chunks from the row's first live one, slowest, so that the CTAs
// past the rows' live chunks come last; kThreads threads.  RMAX >= rep
// bounds the per-query registers.
template <typename T, typename CT, int HD, int RMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_split_kernel(const T* __restrict__ q, const CT* __restrict__ k,
                    const CT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ cache_len,
                    const float* __restrict__ slopes,
                    const int* __restrict__ min_pos, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int H, int KV, int S_max, float sm_scale) {
  using G = Cfg<CT, HD>;
  constexpr int C = G::C, TPP = G::TPP, NW = G::NW, PW = C / NW;
  constexpr bool kQuant = sizeof(CT) == 1;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int rep = H / KV;

  // the group's queries, loaded while the row's length is read
  constexpr int QPT = (RMAX * HD + kThreads - 1) / kThreads;
  const T* q_row = q + ((size_t)b * H + (size_t)kvh * rep) * HD;
  T qv[QPT];
#pragma unroll
  for (int e = 0; e < QPT; ++e) {
    const int i = t + e * kThreads;
    qv[e] = i < rep * HD ? q_row[i] : from_f<T>(0.f);
  }
  int len = cache_len[b];
  len = len < S_max ? len : S_max;
  int first = min_pos != nullptr ? min_pos[b] : 0;
  first = first > 0 ? first : 0;
  T* out_g = out + ((size_t)b * H + (size_t)kvh * rep) * HD;
  if (first >= len) {   // nothing to attend: zeros, written once
    if (z == 0)
      for (int i = t; i < rep * HD; i += kThreads) out_g[i] = from_f<T>(0.f);
    return;
  }
  const int j_first = first / C, j_last = (len - 1) / C;
  const int j = j_first + z;
  if (j > j_last) return;
  const int s_lo = j * C > first ? j * C : first;
  const int s_hi = j * C + C < len ? j * C + C : len;
  const int n = s_hi - s_lo;     // 1..C positions from s_lo

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_w[NW * RMAX], l_w[NW * RMAX];
  const Layout lay = layout_of<CT, HD>(rep);
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + lay.v;
  float* q_s = reinterpret_cast<float*>(smem + lay.q);    // [rep][HD]
  float* p_s = reinterpret_cast<float*>(smem + lay.p);    // [rep][C]
  float* vs_s = reinterpret_cast<float*>(smem + lay.vs);  // [C]
  float* red = reinterpret_cast<float*>(smem + lay.red);  // [NW][rep][HD]

  // warp w owns positions [w PW, w PW + PW) of the chunk: it copies their
  // K and V rows, scores them (kTPP lanes a position), keeps its own
  // softmax state and P V, and meets the other warps once, at the end
  const int p0 = warp * PW;
  const int nw = n - p0 < PW ? (n - p0 > 0 ? n - p0 : 0) : PW;
  const size_t pos_stride = (size_t)KV * HD;
  const size_t base = ((size_t)b * S_max + s_lo + p0) * pos_stride +
                      (size_t)kvh * HD;
  for (int i = lane; i < nw * G::PIECES; i += 32) {
    const int r = i / G::PIECES, u = i - r * G::PIECES;
    cp_async16(k_s + (p0 + r) * G::ROWB + u * 16,
               k + base + r * pos_stride + u * G::VEC, 16);
  }
  cp_async_commit();
  for (int i = lane; i < nw * G::PIECES; i += 32) {
    const int r = i / G::PIECES, u = i - r * G::PIECES;
    cp_async16(v_s + (p0 + r) * G::ROWB + u * 16,
               v + base + r * pos_stride + u * G::VEC, 16);
  }
  cp_async_commit();
  // while they land: the scales of the thread's position (int8), the
  // group's queries pre-scaled, the slopes.  Thread t scores position
  // pos over units tp, tp + TPP, ...
  const int pos = t / TPP, tp = t - pos * TPP;
  float kscale = 1.f;
  if (kQuant && pos < n) {
    const size_t si = ((size_t)b * S_max + s_lo + pos) * KV + kvh;
    kscale = __ldg(ks + si);
    if (tp == 0) vs_s[pos] = __ldg(vs + si);
  }
#pragma unroll
  for (int e = 0; e < QPT; ++e) {
    const int i = t + e * kThreads;
    if (i < rep * HD) q_s[i] = to_f(qv[e]) * sm_scale;
  }
  float slope[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    slope[r] = (slopes != nullptr && r < rep) ? __ldg(slopes + kvh * rep + r)
                                              : 0.f;
  __syncthreads();   // the queries
  cp_async_wait<1>();
  __syncwarp();      // the warp's K rows

  // scores: fmaf along the thread's units, then summed over the
  // position's TPP adjacent lanes (every lane gets the same bits)
  float sc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) sc[r] = 0.f;
  if (pos < n) {
    const unsigned char* krow = k_s + pos * G::ROWB;
#pragma unroll
    for (int i = 0; i < G::UPT; ++i) {
      const int u = tp + TPP * i;
      if (u < G::PIECES) {
        float kf[G::VEC];
        unpack16<CT>(*reinterpret_cast<const uint4*>(krow + u * 16), kscale,
                     kf);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < rep) {
            const float4* qv4 =
                reinterpret_cast<const float4*>(q_s + r * HD + u * G::VEC);
#pragma unroll
            for (int e = 0; e < G::VEC / 4; ++e) {
              const float4 qq = qv4[e];
              sc[r] = fmaf(qq.x, kf[4 * e], sc[r]);
              sc[r] = fmaf(qq.y, kf[4 * e + 1], sc[r]);
              sc[r] = fmaf(qq.z, kf[4 * e + 2], sc[r]);
              sc[r] = fmaf(qq.w, kf[4 * e + 3], sc[r]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o < TPP; o <<= 1)
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
  if (pos < n) {
    if (slopes != nullptr) {
      const float fp = (float)(s_lo + pos);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        sc[r] = __fadd_rn(sc[r], __fmul_rn(slope[r], fp));
    }
  } else {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) sc[r] = kNegInf;
  }

  // the warp's softmax state: its max and sum over its positions
  float m_own[RMAX], l_own[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m_own[r] = kNegInf;
    l_own[r] = 0.f;
    if (r < rep) {
      m_own[r] = warp_max(sc[r]);
      const float p = pos < n ? expf(sc[r] - m_own[r]) : 0.f;
      if (tp == 0) p_s[r * C + pos] = p;
      l_own[r] = warp_sum(tp == 0 ? p : 0.f);
    }
  }
  cp_async_wait<0>();
  __syncwarp();      // the warp's V rows, its P and V scales

  // P V over the warp's positions, lanes over column pairs
  float acc[RMAX][G::NPAIR][2];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int c = 0; c < G::NPAIR; ++c) acc[r][c][0] = acc[r][c][1] = 0.f;
#pragma unroll 4
  for (int i = p0; i < p0 + nw; ++i) {
    const unsigned char* vrow = v_s + i * G::ROWB;
    const float vscale = kQuant ? vs_s[i] : 1.f;
    float p[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) p[r] = r < rep ? p_s[r * C + i] : 0.f;
#pragma unroll
    for (int c = 0; c < G::NPAIR; ++c) {
      const int col = lane + 32 * c;
      if (col < HD / 2) {
        const float2 x = pair_at<CT>(vrow, col, vscale);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < rep) {
            acc[r][c][0] = fmaf(p[r], x.x, acc[r][c][0]);
            acc[r][c][1] = fmaf(p[r], x.y, acc[r][c][1]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < rep) {
#pragma unroll
      for (int c = 0; c < G::NPAIR; ++c) {
        const int col = lane + 32 * c;
        if (col < HD / 2)
          *reinterpret_cast<float2*>(red + (warp * rep + r) * HD + 2 * col) =
              make_float2(acc[r][c][0], acc[r][c][1]);
      }
      if (lane == 0) {
        m_w[warp * RMAX + r] = m_own[r];
        l_w[warp * RMAX + r] = l_own[r];
      }
    }
  }
  __syncthreads();

  // the warps' states merged in warp order: the output, or the chunk's
  // partial (m, l, acc)
  const bool direct = j_first == j_last;
  const int slot_f = rep * (HD + 2);
  const size_t nslot = (size_t)(S_max + kMinChunk - 1) / kMinChunk;
  float* row_ws = ws + ((size_t)b * KV + kvh) * nslot * slot_f;
  float* part = row_ws + (size_t)j * slot_f;   // m [rep], l [rep], acc
  for (int i = t; i < rep * HD + rep; i += kThreads) {
    // i < rep * HD: an output element; past it, thread i - rep * HD writes
    // its query's (m, l) into the partial
    const bool elem = i < rep * HD;
    const int r = elem ? i / HD : i - rep * HD;
    float M = m_w[r];
#pragma unroll
    for (int w = 1; w < NW; ++w) M = fmaxf(M, m_w[w * RMAX + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(m_w[w * RMAX + r] - M);
      L = fmaf(l_w[w * RMAX + r], f, L);
      if (elem) O = fmaf(red[(w * rep + r) * HD + (i - r * HD)], f, O);
    }
    if (direct) {
      if (elem) out_g[i] = from_f<T>(O / fmaxf(L, 1e-30f));
    } else if (elem) {
      part[2 * rep + i] = O;
    } else {
      part[r] = M;
      part[rep + r] = L;
    }
  }
  if (direct) return;

  // the last chunk to arrive merges the partials in chunk order: one
  // acquire-release add after the CTA's barrier publishes its partial and,
  // for the last, makes the others' visible (the CTA barrier orders the
  // other threads' stores and loads around it)
  __shared__ int s_last;
  __syncthreads();
  int* counter = counters + (size_t)b * KV + kvh;
  if (t == 0)
    s_last = hopper::atom_add_acq_rel(counter, 1) == j_last - j_first;
  __syncthreads();
  if (!s_last) return;
  // online over the chunks, their loads issued kMergeBatch at a time
  for (int i = t; i < rep * HD; i += kThreads) {
    const int r = i / HD;
    float M = kNegInf, L = 0.f, O = 0.f;
    for (int c0 = j_first; c0 <= j_last; c0 += kMergeBatch) {
      float mv[kMergeBatch], lv[kMergeBatch], av[kMergeBatch];
#pragma unroll
      for (int e = 0; e < kMergeBatch; ++e) {
        const float* pc = row_ws + (size_t)(c0 + e) * slot_f;
        const bool ok = c0 + e <= j_last;
        mv[e] = ok ? __ldcg(pc + r) : kNegInf;
        lv[e] = ok ? __ldcg(pc + rep + r) : 0.f;
        av[e] = ok ? __ldcg(pc + 2 * rep + i) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kMergeBatch; ++e) {
        if (c0 + e <= j_last) {
          const float Mn = fmaxf(M, mv[e]);
          const float a = expf(M - Mn), f = expf(mv[e] - Mn);
          L = L * a + lv[e] * f;
          O = O * a + av[e] * f;
          M = Mn;
        }
      }
    }
    out_g[i] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
  if (t == 0) *counter = 0;
}

template <typename T, typename CT, int HD, int RMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* cache_len,
                   const void* slopes, const void* min_pos, void* out,
                   void* ws, void* counters, int B, int H, int KV, int S_max,
                   float sm_scale, cudaStream_t stream) {
  using G = Cfg<CT, HD>;
  auto kern = decode_split_kernel<T, CT, HD, RMAX>;
  const int smem = layout_of<CT, HD>(H / KV).bytes;
  if (layout_of<CT, HD>(RMAX).bytes > 48 * 1024) {
    // the opt-in above 48 KB, once per device
    static unsigned done = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 32 || !(done & (1u << dev))) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               layout_of<CT, HD>(RMAX).bytes);
      if (e != cudaSuccess) return e;
      if (dev < 32) done |= 1u << dev;
    }
  }
  const int chunks = S_max > 0 ? (S_max + G::C - 1) / G::C : 1;
  const dim3 grid(KV, B, chunks);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(cache_len),
      static_cast<const float*>(slopes), static_cast<const int*>(min_pos),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), H, KV, S_max, sm_scale);
  return cudaGetLastError();
}

// the instance for rep query heads a group: the per-query registers
// bounded by the next of 1, 4, 8 (the arithmetic is the same in each; three
// instances a head dim and type keep the build short)
template <typename T, typename CT, int HD>
cudaError_t launch_rep(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* cache_len,
                       const void* slopes, const void* min_pos, void* out,
                       void* ws, void* counters, int B, int H, int KV,
                       int S_max, float sm_scale, cudaStream_t stream) {
  const int rep = H / KV;
#define DS_DECODE_REP(R)                                                    \
  if (rep <= R)                                                             \
    return launch<T, CT, HD, R>(q, k, v, ks, vs, cache_len, slopes,         \
                                min_pos, out, ws, counters, B, H, KV,       \
                                S_max, sm_scale, stream);
  DS_DECODE_REP(1)
  DS_DECODE_REP(4)
#undef DS_DECODE_REP
  return launch<T, CT, HD, kMaxRep>(q, k, v, ks, vs, cache_len, slopes,
                                    min_pos, out, ws, counters, B, H, KV,
                                    S_max, sm_scale, stream);
}

// one entry point per cache type; CT = T (float cache) or int8_t
template <bool kInt8>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* cache_len, const void* slopes,
             const void* min_pos, void* out, void* ws, void* counters, int B,
             int H, int KV, int S_max, int head_dim, int is_bf16,
             float sm_scale, void* stream) {
  // grid (KV, B, chunks): each at most 65535
  if (B < 1 || KV < 1 || S_max < 0 || H % KV != 0 || H / KV > kMaxRep ||
      B > 65535 || KV > 65535 || S_max > 65535 * kMinChunk ||
      ((uintptr_t)k | (uintptr_t)v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  using CB = typename std::conditional<kInt8, int8_t, BF>::type;
  using CF = typename std::conditional<kInt8, int8_t, float>::type;
#define DS_DECODE_CASE(HDV)                                                \
  case HDV:                                                                \
    return is_bf16 ? (int)launch_rep<BF, CB, HDV>(                         \
                         q, k, v, ks, vs, cache_len, slopes, min_pos, out, \
                         ws, counters, B, H, KV, S_max, sm_scale, st)      \
                   : (int)launch_rep<float, CF, HDV>(                      \
                         q, k, v, ks, vs, cache_len, slopes, min_pos, out, \
                         ws, counters, B, H, KV, S_max, sm_scale, st);
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
                                   void* out, void* ws, void* counters,
                                   int B, int H, int KV, int S_max,
                                   int head_dim, int is_bf16, float sm_scale,
                                   void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, cache_len, slopes,
                         min_pos, out, ws, counters, B, H, KV, S_max,
                         head_dim, is_bf16, sm_scale, stream);
}

extern "C" int ds_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* cache_len, const void* slopes,
    const void* min_pos, void* out, void* ws, void* counters, int B, int H,
    int KV, int S_max, int head_dim, int is_bf16, float sm_scale,
    void* stream) {
  return dispatch<true>(q, k, v, ks, vs, cache_len, slopes, min_pos, out, ws,
                        counters, B, H, KV, S_max, head_dim, is_bf16,
                        sm_scale, stream);
}

// positions per chunk of the instance for head_dim and a cache element of
// cache_bytes (4 fp32, 2 bf16, 1 int8); -1 for none
extern "C" int ds_decode_attention_chunk(int head_dim, int cache_bytes) {
  const bool hd_ok = head_dim == 64 || head_dim == 80 || head_dim == 96 ||
                     head_dim == 128;
  const bool sz_ok = cache_bytes == 1 || cache_bytes == 2 || cache_bytes == 4;
  return hd_ok && sz_ok ? chunk_positions(head_dim, cache_bytes) : -1;
}
