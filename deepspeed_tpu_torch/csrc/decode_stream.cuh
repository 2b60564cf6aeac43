// The decode weight stream: at most 8 activation rows a pass against a
// [K, N] weight streamed once through a TMA ring, on the tensor cores.
// Shared by csrc/qgemm.cu (bf16 rows, int8 weights) and the fused decode
// layer's GEMM phases under bf16 compute (csrc/fused_decode.cuh, bf16 or
// int8 weights), so a projection's products and sums are the same in both.
//
// What bounds it on an H100: bytes.  A decode projection does ~2 flops a
// weight byte against the ~295 a byte the card needs before its
// arithmetic is the limit; the weight has to stream from device memory at
// the card's rate, with enough bytes in flight (some 7 MB across the card:
// 3.35 TB/s times the ~2 us a load takes).  The design (after the bf16
// slot kernel of csrc/grouped_gemm_stream.cu):
//   - a unit of work is (row group, 256 columns, K split): 512 contiguous
//     bytes a weight row and stage in bf16 (4 TMA boxes of [64 k x 64 n],
//     128-byte swizzle), 256 in int8 (2 boxes of [64 k x 128 n]) with the
//     stage's [64 k x G groups] of fp32 scales beside them (cp.async by the
//     producer's lanes, completing on the same barrier);
//   - one producer warp keeps a ring of such stages full (bf16: 3 of 32
//     KB, int8: 5 of 16 KB) for eight consumer warps of 32 columns each,
//     full / empty mbarriers, running ahead across unit boundaries; the
//     rows arrive by TMA too, [8 rows x 64 k] boxes, so past K and past
//     the last row everything lands as zeros;
//   - swap-AB mma.sync m16n8k16: W^T on the M side (bf16: ldmatrix.trans
//     from the swizzled boxes; int8: each code dequantized straight into
//     the A fragment, (float)q * scale rounded to bf16 as gemm_tile.cuh
//     dequant_w does, the code made fp32 by a byte permute and one exact
//     add), 8 rows a pass on the N side, up to 4 passes (a 32-row group)
//     against each A fragment, fp32 accumulation.  For int8 a lane's A
//     rows g and g + 8 of its two 16-column tiles are four adjacent
//     columns, so one 32-bit shared load brings its codes of a k row;
//   - K splits by a count that depends on N, K and the SM count only
//     (splits(); the same rule as the fp32 decode form of gemm_tile.cuh
//     rows_mma in csrc/qgemm.cu); each split's fp32 partial is summed in
//     split order by its caller.
// A row's bits follow only its own inputs: every product of a row runs in
// K order over a K range and unit shape fixed by (K, N, SMs), and a
// product's column (an activation row) never meets another's.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace dstream {

constexpr int kBN = 256;                 // output columns a unit
constexpr int kBK = 64;                  // K rows a stage
constexpr int kPass = 8;                 // rows a pass (the mma's n8)
constexpr int kPassMax = 4;              // passes a unit: a 32-row group
constexpr int kGroupRows = kPass * kPassMax;
constexpr int kMaxSplit = 16;
constexpr int kGMax = 8;                 // scale groups a unit's columns meet
constexpr int kConsumerWarps = 8;        // 32 columns each
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kXBox = kPass * kBK * 2;   // [8 rows x 64 k] bf16: 1 KB
constexpr int kWBox = 8192;              // one weight box
static_assert(kBN == kConsumerWarps * 32, "a consumer warp owns 32 columns");

// the ring's shared memory (bytes from a 1024-aligned base): weights, rows,
// scales (int8), then the full and empty barriers
template <bool Q8>
struct Ring {
  static constexpr int kStages = Q8 ? 5 : 3;
  static constexpr int kW = Q8 ? kBK * kBN : kBK * kBN * 2;
  static constexpr int kBoxes = kW / kWBox;
  static constexpr int kBoxN = Q8 ? 128 : 64;   // a box's columns
  static constexpr int kX = kPassMax * kXBox;
  static constexpr int kS = Q8 ? kBK * kGMax * 4 : 0;
  static constexpr int off_x = kStages * kW;
  static constexpr int off_s = off_x + kStages * kX;
  static constexpr int off_bar = off_s + kStages * kS;
  static constexpr int bytes = off_bar + 2 * kStages * 8;
  // a stage's full barrier: the producer's arrival with the byte count,
  // and for int8 each lane's arrival once its scale copies land
  static constexpr int kFullCount = Q8 ? 33 : 1;
};

// One projection as the stream sees it: N columns over K, int8 scales
// [K, nb] with groups of qblock columns (G: the most groups a 256-column
// unit meets), nsplit K ranges of kper rows.
struct Proj {
  const float* s;
  int N, K, nb, qblock, G, nsplit, kper, ntiles;
};

struct Unit {
  int rg, ntile, split, kbeg, nch, rows, npass;
};

// K splits of an N-column projection over K on `sms` multiprocessors: one
// unit a multiprocessor where N alone gives too few, at most kMaxSplit, no
// split without a 64-row stage (the same rule in ops/kernels/qgemm.py
// stream_splits)
__host__ __device__ inline void splits(int K, int N, int sms, int* nsplit,
                                       int* kper) {
  const int tiles = (N + kBN - 1) / kBN;
  const int kch = (K + kBK - 1) / kBK;
  int s = sms / tiles;
  s = s < 1 ? 1 : s;
  s = s > kMaxSplit ? kMaxSplit : s;
  s = s > kch ? kch : s;
  const int chunks = (kch + s - 1) / s;
  *nsplit = (kch + chunks - 1) / chunks;
  *kper = chunks * kBK;
}

// the most scale groups of qblock columns any 256-column unit of an
// N-column weight meets
__host__ __device__ inline int groups_met(int N, int qblock) {
  int most = 0;
  for (int n0 = 0; n0 < N; n0 += kBN) {
    const int e = (n0 + kBN < N ? n0 + kBN : N) - 1;
    const int g = e / qblock - n0 / qblock + 1;
    most = g > most ? g : most;
  }
  return most;
}

__host__ __device__ inline Proj make_proj(const float* s, int N, int K,
                                          int nb, int sms) {
  Proj p;
  p.s = s;
  p.N = N;
  p.K = K;
  p.nb = nb;
  p.qblock = nb > 0 ? (N + nb - 1) / nb : 1;
  p.G = nb > 0 ? groups_met(N, p.qblock) : 0;
  p.ntiles = (N + kBN - 1) / kBN;
  splits(K, N, sms, &p.nsplit, &p.kper);
  return p;
}

// units of a projection over R rows: row group fastest (the groups of one
// weight tile are in flight together, so only the first reads it from
// device memory), then the 256-column tile, then the K split
__host__ __device__ inline int units_of(const Proj& p, int R) {
  return (R + kGroupRows - 1) / kGroupRows * p.ntiles * p.nsplit;
}

__device__ __forceinline__ Unit unit_of(const Proj& p, int R, int local) {
  const int nrg = (R + kGroupRows - 1) / kGroupRows;
  Unit w;
  w.rg = local % nrg;
  const int rest = local / nrg;
  w.ntile = rest % p.ntiles;
  w.split = rest / p.ntiles;
  w.kbeg = w.split * p.kper;
  const int kend = min(p.K, w.kbeg + p.kper);
  w.nch = (kend - w.kbeg + kBK - 1) / kBK;
  w.rows = min(kGroupRows, R - w.rg * kGroupRows);
  w.npass = (w.rows + kPass - 1) / kPass;
  return w;
}

// ------------------------------------------------------------ barriers
template <bool Q8>
__device__ __forceinline__ uint64_t* full_bar(unsigned char* ring, int s) {
  return reinterpret_cast<uint64_t*>(ring + Ring<Q8>::off_bar) + s;
}
template <bool Q8>
__device__ __forceinline__ uint64_t* empty_bar(unsigned char* ring, int s) {
  return reinterpret_cast<uint64_t*>(ring + Ring<Q8>::off_bar) +
         Ring<Q8>::kStages + s;
}

// by one thread, before the CTA's first barrier
template <bool Q8>
__device__ __forceinline__ void init_ring(unsigned char* ring) {
  for (int s = 0; s < Ring<Q8>::kStages; ++s) {
    hopper::mbar_init(full_bar<Q8>(ring, s), Ring<Q8>::kFullCount);
    hopper::mbar_init(empty_bar<Q8>(ring, s), kConsumerWarps);
  }
  hopper::fence_barrier_init();
}

// --------------------------------------------------------- the producer
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the barrier's phase waits for this thread's cp.async copies so far (one
// of its expected arrivals)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// Stage `s` of unit `w` (chunk c), by the producer warp: waits for the
// stage to be free, then lane 0 announces its weight bytes and `xbytes`
// of rows and loads the weight boxes; for int8 every lane copies its
// share of the stage's scales (zeros past K and past nb) first.
template <bool Q8>
__device__ __forceinline__ void issue_weights(unsigned char* ring,
                                              const CUtensorMap* tw,
                                              const Proj& p, const Unit& w,
                                              int c, int it, uint32_t xbytes) {
  using L = Ring<Q8>;
  const int lane = threadIdx.x & 31;
  const int s = it % L::kStages;
  hopper::mbar_wait(empty_bar<Q8>(ring, s), ((it / L::kStages) & 1) ^ 1);
  const int k0 = w.kbeg + c * kBK;
  uint64_t* full = full_bar<Q8>(ring, s);
  if constexpr (Q8) {
    float* sd = reinterpret_cast<float*>(ring + L::off_s + s * L::kS);
    const int g0 = w.ntile * kBN / p.qblock;
    for (int e = lane; e < kBK * p.G; e += 32) {
      const int r = e / p.G, gi = e - r * p.G;
      const bool ok = k0 + r < p.K && g0 + gi < p.nb;
      cp_async4(sd + r * kGMax + gi,
                ok ? p.s + (size_t)(k0 + r) * p.nb + g0 + gi : p.s,
                ok ? 4 : 0);
    }
    cp_async_mbar_arrive(full);
    __syncwarp();
  }
  if (lane == 0) {
    hopper::mbar_arrive_expect_tx(full, L::kW + xbytes);
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b)
      hopper::tma_load_4d(ring + s * L::kW + b * kWBox, tw, full,
                          w.ntile * kBN + b * L::kBoxN, k0, 0, 0);
  }
}

// the rows of stage `it` (unit w, chunk c): one [8 rows x 64 k] box a pass
template <bool Q8>
__device__ __forceinline__ void issue_rows(unsigned char* ring,
                                           const CUtensorMap* tx,
                                           const Unit& w, int c, int it) {
  using L = Ring<Q8>;
  if ((threadIdx.x & 31) != 0) return;
  const int s = it % L::kStages;
  for (int q = 0; q < w.npass; ++q)
    hopper::tma_load_4d(ring + L::off_x + s * L::kX + q * kXBox, tx,
                        full_bar<Q8>(ring, s), w.kbeg + c * kBK,
                        w.rg * kGroupRows + q * kPass, 0, 0);
}

__host__ __device__ inline uint32_t row_bytes(const Unit& w) {
  return (uint32_t)w.npass * kXBox;
}

// --------------------------------------------------------- the consumers
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 code (a byte of v, biased by 128 through v ^ 0x8080) as fp32:
// 2^23 + (q + 128) exactly, less 2^23 + 128
__device__ __forceinline__ float code_f(uint32_t biased, uint32_t sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}

// A consumer warp's accumulators: [pass][16-column tile][fragment]
struct Acc {
  float v[kPassMax][2][4];
};

// The column of the unit (0..255) that accumulator element (m, e) of this
// lane holds, and the row of its pass (0..7): bf16 maps tile m's mma rows
// g / g + 8 to the warp's columns 16 m + g / 16 m + g + 8; int8 to 4 g +
// 2 m / 4 g + 2 m + 1, so a lane's four columns are adjacent and one
// 32-bit shared load brings its codes of a k row.
template <bool Q8>
__device__ __forceinline__ int acc_col(int warp, int m, int e, int lane) {
  const int g = lane >> 2;
  return warp * 32 +
         (Q8 ? 4 * g + 2 * m + (e >> 1) : m * 16 + g + 8 * (e >> 1));
}
__device__ __forceinline__ int acc_row(int e, int lane) {
  return 2 * (lane & 3) + (e & 1);
}

// this lane's scale offsets in a stage's [64][kGMax] block for each of its
// four columns (int8): the column's group less the unit's first; `one`
// when all four share a group (a group edge inside them is the rare case)
struct ScaleCols {
  int col[4];
  bool one;
};

__device__ __forceinline__ ScaleCols scale_cols(const Proj& p, const Unit& w,
                                                int warp, int lane) {
  ScaleCols sc;
  const int g0 = w.ntile * kBN / p.qblock;
  const int c0 = w.ntile * kBN + warp * 32 + 4 * (lane >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    sc.col[j] = min(max(min(c0 + j, p.N - 1) / p.qblock - g0, 0), kGMax - 1);
  sc.one = sc.col[0] == sc.col[3];
  return sc;
}

// The products of stage `it` into acc (npass passes), then the stage is
// released.  Every consumer warp calls this for every stage of its units.
template <bool Q8>
__device__ __forceinline__ void consume_stage(unsigned char* ring, Acc& acc,
                                              const Unit& w,
                                              const ScaleCols& sc, int it) {
  using L = Ring<Q8>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int jm = lane >> 3, rm = lane & 7;
  const int s = it % L::kStages;
  hopper::mbar_wait(full_bar<Q8>(ring, s), (it / L::kStages) & 1);
  const uint32_t wst = hopper::smem_u32(ring + s * L::kW);
  const uint32_t xst = hopper::smem_u32(ring + L::off_x + s * L::kX);
  // int8: the stage's codes of this lane (rows 16 ks + 2t + {0, 1, 8, 9},
  // columns 4g .. 4g + 3 of the warp's 32: box warp / 4, 16-byte chunk
  // 2 (warp % 4) + g / 4), loaded together (their latency paid once a
  // stage), biased by 128
  uint32_t words[kBK / 16][4];
  const float* sst = nullptr;
  if constexpr (Q8) {
    const unsigned char* qst = ring + s * L::kW + (warp >> 2) * kWBox;
    sst = reinterpret_cast<const float*>(ring + L::off_s + s * L::kS);
    const int chunk = 2 * (warp & 3) + (g >> 2);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 16 * ks + 8 * (j >> 1) + 2 * t + (j & 1);
        words[ks][j] = *reinterpret_cast<const uint32_t*>(
                           qst + k * 128 + ((chunk ^ (k & 7)) << 4) +
                           4 * (g & 3)) ^
                       0x80808080u;
      }
  }
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    uint32_t a[2][4];
    if constexpr (Q8) {
      // tile m's rows g / g + 8 are bytes 2m / 2m + 1 of a lane's word
      float lo[2][4], hi[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* sr =
            sst + (16 * ks + 8 * (j >> 1) + 2 * t + (j & 1)) * kGMax;
        float s4[4];   // the row's scale of each of the lane's columns
        if (sc.one) {
          s4[0] = s4[1] = s4[2] = s4[3] = sr[sc.col[0]];
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) s4[c] = sr[sc.col[c]];
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          lo[m][j] = code_f(words[ks][j], 0x7440u + 2 * m) * s4[2 * m];
          hi[m][j] = code_f(words[ks][j], 0x7441u + 2 * m) * s4[2 * m + 1];
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        a[m][0] = hopper::pack_bf16(lo[m][0], lo[m][1]);
        a[m][1] = hopper::pack_bf16(hi[m][0], hi[m][1]);
        a[m][2] = hopper::pack_bf16(lo[m][2], lo[m][3]);
        a[m][3] = hopper::pack_bf16(hi[m][2], hi[m][3]);
      }
    } else {
      // W^T fragments by ldmatrix.trans: the warp's 32 columns are 16-
      // column groups 2 (warp % 2) + m of box warp / 2
      const int k = ks * 16 + (jm >> 1) * 8 + rm;
      const uint32_t box = wst + (warp >> 1) * kWBox + k * 128;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int grp = 2 * (warp & 1) + m;
        ldsm_x4_trans(a[m], box + (((2 * grp + (jm & 1)) ^ (k & 7)) << 4));
      }
    }
#pragma unroll
    for (int q = 0; q < kPassMax; ++q) {
      if (q < w.npass) {
        uint32_t b[2];
        ldsm_x2(b, xst + q * kXBox + rm * 128 +
                       (((2 * ks + (jm & 1)) ^ rm) << 4));
        mma16816(acc.v[q][0], a[0], b);
        mma16816(acc.v[q][1], a[1], b);
      }
    }
  }
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty_bar<Q8>(ring, s));
}

// A unit's products: acc zeroed, then every stage; `it` advances by the
// unit's stages.
template <bool Q8>
__device__ __forceinline__ void consume_unit(unsigned char* ring, Acc& acc,
                                             const Proj& p, const Unit& w,
                                             int& it) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kPassMax; ++q)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[q][m][e] = 0.f;
  ScaleCols sc{};
  if constexpr (Q8) sc = scale_cols(p, w, warp, lane);
  for (int c = 0; c < w.nch; ++c, ++it) consume_stage<Q8>(ring, acc, w, sc, it);
}

// Each of acc's values with its row (of the R rows) and column (of N):
// f(row, col, value) for the real ones.
template <bool Q8, typename F>
__device__ __forceinline__ void for_each_acc(const Acc& acc, const Proj& p,
                                             const Unit& w, int R, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kPassMax; ++q) {
    if (q >= w.npass) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w.rg * kGroupRows + q * kPass + acc_row(e, lane);
        const int col = w.ntile * kBN + acc_col<Q8>(warp, m, e, lane);
        if (r < R && col < p.N) f(r, col, acc.v[q][m][e]);
      }
  }
}

// -------------------------------------------------------------- host side
// whether the stream takes an [R, K] @ [K, N] product of bf16 rows (x and
// w 16-byte aligned; int8: nb scale groups): TMA row strides of whole 16
// bytes, and for int8 at most kGMax groups a unit
inline bool stream_ok(int K, int N, int nb, bool q8, const void* x,
                      const void* w) {
  if (K < 1 || N < 1 || K % 8 || (uintptr_t)x % 16 || (uintptr_t)w % 16)
    return false;
  if (!q8) return N % 8 == 0;
  if (N % 16 || nb < 1 || nb > N) return false;
  return groups_met(N, (N + nb - 1) / nb) <= kGMax;
}

// tensor maps: a [K, N] weight (bf16 boxes [64 k x 64 n], int8 [64 k x
// 128 n]) and [R, K] bf16 rows of row stride ld ([8 rows x 64 k] boxes),
// all with the 128-byte swizzle
inline bool weight_map(CUtensorMap* map, const void* w, int K, int N,
                       bool q8) {
  const uint64_t dims[4] = {(uint64_t)N, (uint64_t)K, 1, 1};
  const long long strides[3] = {N, (long long)K * N, (long long)K * N};
  const CUtensorMapDataType type = q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return hopper::cached_map_4d(map, type, q8 ? 1 : 2, w, dims, strides,
                               q8 ? 128 : 64, kBK,
                               CU_TENSOR_MAP_SWIZZLE_128B);
}

inline bool rows_map(CUtensorMap* map, const void* x, int R, int K, int ld) {
  const uint64_t dims[4] = {(uint64_t)K, (uint64_t)R, 1, 1};
  const long long strides[3] = {ld, (long long)R * ld, (long long)R * ld};
  return hopper::cached_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                               dims, strides, kBK, kPass,
                               CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace dstream
