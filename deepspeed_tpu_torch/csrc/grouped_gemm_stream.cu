// The decode-side expert GEMMs on Hopper: bf16 ds_ggemm_slots and the
// int8-expert / bf16-row ds_ggemm_q as persistent kernels that stream the
// expert stack through a TMA ring.  The fp32 forms, ds_ggemm_slots_q and
// the bf16 shapes TMA cannot address stay in csrc/grouped_gemm.cu.
//
// Replaces: deepspeed_tpu/ops/pallas/grouped_gemm.py _slot_kernel (:433)
// and _ggemm_q_kernel (:200).  Same semantics as the plain versions
// (ggemm_slots_plain, ggemm_q_plain in ops/kernels/grouped_gemm.py):
//   ds_ggemm_slots  out[r] = x[r] W[e_r], x [R <= 128, K] the raw routed
//                   rows, the plan's slots naming each distinct expert; a
//                   slot with no rows fetches nothing, a row of an expert
//                   id outside [0, E) gets exact zeros
//   ds_ggemm_q      out[Mp, N] = x[Mp, K] against dequant(q[e], s[e]) per
//                   64-row plan tile (e its group's expert), each weight
//                   (float)q * s[e, k, n / qblock] rounded to bf16 before
//                   its product; rows past tile_rows and tiles with none
//                   are exact zeros, written without a fetch
// with fp32 accumulation and one rounding to bf16.
//
// What bounds them on an H100: bytes.  A decode step's gate/in slot launch
// (R 16 over 8 experts, K 4096, N 14336) reads 0.94 GB of bf16 weights
// (0.281 ms at 3.35 TB/s) for ~2 flops a weight byte; the int8 launch of
// the 96-sequence arm (R 192 in 11 tiles) reads 470 MB of codes and 7.3 MB
// of scales (0.149 ms).  What the designs do about it:
//   - one persistent CTA per SM; one producer warp (int8: one thread of a
//     producer warpgroup that hands its registers to the two consumer
//     warpgroups by setmaxnreg) draws work units from a counter in device
//     memory and keeps TMA boxes of the expert stack in flight through a
//     ring (slots: 6 stages of 32 KB; int8: up to 8 of 24 KB and the
//     stage's scales, 7 at Mixtral's), full / empty mbarriers, running
//     ahead across unit boundaries, so no unit pays a fill and a drain;
//   - N-tiles vary fastest in both unit orders, so the CTAs at work read
//     whole rows of an expert's stack at once (a unit's stage holds 512
//     contiguous bytes a weight row, 256 a code row), and the units of
//     one expert's several blocks or plan tiles are in flight together:
//     its weights come from device memory once and from L2 after;
//   - K splits by a count that depends on N, K (int8: and E) and the SM
//     count only (ops/kernels/grouped_gemm.py slot_stream_splits,
//     ggemm_q_stream_splits); each split writes an fp32 partial and the
//     last of a tile's splits to arrive sums them in split order (no
//     float atomics);
//   - slots, swap-AB: out^T = W^T x^T with W's columns on the tensor
//     cores' M side (mma.sync m16n8k16, A = W^T by ldmatrix.trans from the
//     128-byte swizzled boxes) and the slot's rows on the N side, 8 a pass;
//     a unit is (256 columns, block, K range), a block at most 16 rows of
//     one slot; each stage carries its K range of the block's rows, one
//     cp.async.bulk a row;
//   - int8, swap-AB on wgmma: W^T dequantized by each consumer thread
//     straight into the register A fragments (m64n64k16, A from registers,
//     B = the tile's 64 rows of x, K-major by TMA), no shared-memory pass
//     and no barrier between dequantization and product; the columns of a
//     thread's two A rows are adjacent (one 16-bit load of codes, a
//     stage's loaded together), a code becomes fp32 by a byte permute and
//     one exact add (I2F runs at a quarter of the FMA rate); a unit is
//     (256 columns, plan tile, K range), two consumer warpgroups on 128
//     columns each, so x and the scales cross L2 once per 256 columns (at
//     128 the stream was L2-bound); the epilogue stages the bf16 tile in
//     shared memory for 16-byte row stores.  What holds it on an H100
//     (R 192, Mixtral gate/in): data movement alone takes 0.18 ms and
//     dequantization or the products alone add 0.01-0.05, but together
//     they run at 0.30: a warpgroup's dequantization and its register-
//     operand wgmma serialize;
//   - deterministic and row-independent: every unit's products run in K
//     order over a K range, tile and unit shape that depend on no data
//     value and not on R, and a product's column (a row of x) never meets
//     another's, so a row's bits do not depend on the rows around it.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch as an int.
#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSplit = 16;   // slot K splits (the wrapper's SLOT_MAX_SPLIT)

// ------------------------------------------------------------ helpers
// `bytes` (a multiple of 16) from global to shared memory, completing on
// the barrier's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

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

// D[64 x 64] += A[64 x 16] (registers) B[16 x 64], B K-major in shared
// memory (no transpose)
__device__ __forceinline__ void wgmma_rs_k64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_REG32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOPPER_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The CTA's barriers and unit slots: the producer draws each unit from
// the launch's counter (which CTA takes a unit varies, what the unit
// computes does not) and passes it to the consumers through two slots.
struct Sync {
  uint64_t* full;    // [stages] a stage's bytes landed
  uint64_t* empty;   // [stages] a stage read by every consumer warp
  uint64_t* ufull;   // [2] a unit slot written
  uint64_t* uempty;  // [2] a unit slot read by every consumer warp
  int* units;        // [2]
};

__device__ __forceinline__ Sync sync_at(unsigned char* bars, int stages) {
  uint64_t* b = reinterpret_cast<uint64_t*>(bars);
  return Sync{b, b + stages, b + 2 * stages, b + 2 * stages + 2,
              reinterpret_cast<int*>(b + 2 * stages + 4)};
}

__device__ __forceinline__ void init_sync(const Sync& sy, int stages,
                                          int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(sy.full + s, 1);
      hopper::mbar_init(sy.empty + s, consumer_warps);
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(sy.ufull + s, 1);
      hopper::mbar_init(sy.uempty + s, consumer_warps);
    }
    hopper::fence_barrier_init();
  }
}

// the producer's next unit (one thread draws it; the lanes that call
// this get it by shuffle when `warp` is set)
__device__ __forceinline__ int draw_unit(const Sync& sy, int* counter, int n,
                                         bool warp) {
  const int slot = n & 1;
  hopper::mbar_wait(sy.uempty + slot, ((n >> 1) & 1) ^ 1);
  int u = 0;
  if (!warp || (threadIdx.x & 31) == 0) {
    u = atomicAdd(counter, 1);
    sy.units[slot] = u;
    hopper::mbar_arrive(sy.ufull + slot);   // releases the slot's write
  }
  return warp ? __shfl_sync(0xffffffffu, u, 0) : u;
}

// a consumer warp's next unit
__device__ __forceinline__ int take_unit(const Sync& sy, int n) {
  const int slot = n & 1;
  hopper::mbar_wait(sy.ufull + slot, (n >> 1) & 1);
  const int u = sy.units[slot];
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(sy.uempty + slot);
  return u;
}

// every CTA has drawn its last unit once all have come here: the last
// returns the draw counters to 0 for the next launch
__device__ __forceinline__ void reset_draw(int* counters) {
  if (atomicAdd(counters + 1, 1) == (int)gridDim.x - 1) {
    atomicExch(counters, 0);
    atomicExch(counters + 1, 0);
  }
}

// ------------------------------------------------------ ds_ggemm_slots
namespace slots {

constexpr int kBN = 256;                 // output columns a unit
constexpr int kBK = 64;                  // K rows a stage
constexpr int kBoxN = 64;                // columns a TMA box (128 bytes)
constexpr int kRows = 16;                // rows a block: two 8-row passes
constexpr int kStages = 6;
constexpr int kThreads = 160;            // 4 consumer warps + a producer
constexpr int kBox = kBK * kBoxN * 2;    // one [64 k x 64 n] box: 8 KB
constexpr int kWBytes = kBN / kBoxN * kBox;   // a stage's weights: 32 KB
constexpr int kXLd = kBK * 2 + 16;       // a staged row of x (bytes)
constexpr int kXBytes = kRows * kXLd;
constexpr int kMaxBlocks = 128;          // blocks <= R <= 128
constexpr int kX = kStages * kWBytes;
constexpr int kBar = kX + kStages * kXBytes;
constexpr int kBlk = kBar + (2 * kStages + 4) * 8 + 16;
constexpr int kScan = kBlk + kMaxBlocks * 16;
constexpr int kMisc = kScan + 128 * 4;   // nblk, the merge's last flag
constexpr int kAlloc = kMisc + 16 + 1024;
static_assert(kBN / kBoxN == 4, "a consumer warp owns one box's columns");

struct Params {
  const bf16* x;
  const int* active;
  const int* valid;
  const int* order;
  const int* offs;
  bf16* out;
  float* wsp;     // [nsplit][R][N] partials
  int* counters;  // [2] unit draw, then [nblk_max][n_tiles] merges
  int R, K, N, E, S, nsplit, kper, n_tiles;
};

// blocks of the plan (the same table in every CTA): slot s's rows
// order[offs[s] ..) cut into blocks of at most kRows rows, slots in order;
// {expert (-1 outside [0, E)), first row in order, rows, slot}
__device__ __forceinline__ void build_blocks(const Params& p, int4* blk,
                                             int* scan, int* nblk) {
  const int t = threadIdx.x;
  int c = 0, e = -1, r0 = 0;
  if (t < p.S) {
    r0 = p.offs[t];
    c = p.valid[t] ? max(p.offs[t + 1] - r0, 0) : 0;
    e = p.active[t];
    if (e < 0 || e >= p.E) e = -1;
    scan[t] = (c + kRows - 1) / kRows;
  }
  __syncthreads();
  if (t < p.S) {
    int start = 0;
    for (int j = 0; j < t; ++j) start += scan[j];
    const int nb = scan[t];
    for (int b = 0; b < nb; ++b)
      blk[start + b] =
          make_int4(e, r0 + b * kRows, min(kRows, c - b * kRows), t);
    if (t == p.S - 1) *nblk = start + nb;
  }
  __syncthreads();
}

struct Unit {
  int e, r0, nrow, blk, split, ntile, kbeg, kend, nch;
};

// unit u: N-tile fastest (the CTAs at work sweep whole weight rows), then
// the block, then the K split
__device__ __forceinline__ Unit unit_of(const Params& p, const int4* blk,
                                        int nblk, int u) {
  Unit w;
  w.ntile = u % p.n_tiles;
  const int rest = u / p.n_tiles;
  w.blk = rest % nblk;
  w.split = rest / nblk;
  const int4 b = blk[w.blk];
  w.e = b.x;
  w.r0 = b.y;
  w.nrow = b.z;
  w.kbeg = w.split * p.kper;
  w.kend = min(p.K, w.kbeg + p.kper);
  w.nch = w.e >= 0 ? (w.kend - w.kbeg + kBK - 1) / kBK : 0;
  return w;
}

// The producer warp: for every unit and stage, lane 0 announces the
// stage's bytes and loads W[e]'s four [64 k x 64 n] boxes by TMA (rows
// past K land as zeros); lane i < rows copies row i of the block's K range.
__device__ __forceinline__ void produce(const CUtensorMap* tw, const Params& p,
                                        unsigned char* sm, const Sync& sy,
                                        const int4* blk, int nblk) {
  const int lane = threadIdx.x & 31;
  const int n_units = p.n_tiles * p.nsplit * nblk;
  int it = 0;
  for (int n = 0;; ++n) {
    const int u = draw_unit(sy, p.counters, n, true);
    if (u >= n_units) break;
    const Unit w = unit_of(p, blk, nblk, u);
    const int rid = lane < w.nrow ? p.order[w.r0 + lane] : 0;
    for (int c = 0; c < w.nch; ++c, ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(sy.empty + s, ((it / kStages) & 1) ^ 1);
      const int k = w.kbeg + c * kBK;
      const uint32_t xb = (uint32_t)min(kBK, w.kend - k) * 2;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(sy.full + s, kWBytes + w.nrow * xb);
#pragma unroll
        for (int q = 0; q < kBN / kBoxN; ++q)
          hopper::tma_load_4d(sm + s * kWBytes + q * kBox, tw, sy.full + s,
                              w.ntile * kBN + q * kBoxN, k, w.e, 0);
      }
      __syncwarp();
      if (lane < w.nrow)
        bulk_load(sm + kX + s * kXBytes + lane * kXLd,
                  p.x + (size_t)rid * p.K + k, xb, sy.full + s);
    }
  }
  if (lane == 0) reset_draw(p.counters);
}

// The four consumer warps, one box (64 columns) each: per k16 slice four
// W^T fragments (ldmatrix.trans from the swizzled box) against the
// block's one or two 8-row passes; a stage's last slice past the K range
// reads its k 8..15 as zeros (the staged row holds stale values there).
__device__ __forceinline__ void consume(const Params& p, unsigned char* sm,
                                        const Sync& sy, const int4* blk,
                                        int nblk, int* s_last) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int jm = lane >> 3, rm = lane & 7;   // ldmatrix: matrix, row
  const int n_units = p.n_tiles * p.nsplit * nblk;
  const uint32_t wbase = hopper::smem_u32(sm) + warp * kBox;
  const uint32_t xbase = hopper::smem_u32(sm + kX);
  int it = 0;
  for (int n = 0;; ++n) {
    const int u = take_unit(sy, n);
    if (u >= n_units) break;
    const Unit w = unit_of(p, blk, nblk, u);
    const int npass = (w.nrow + 7) >> 3;
    float acc[2][4][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][m][e] = 0.f;
    for (int c = 0; c < w.nch; ++c, ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(sy.full + s, (it / kStages) & 1);
      const int kv = min(kBK, w.kend - (w.kbeg + c * kBK));
      const uint32_t ws = wbase + s * kWBytes, xs = xbase + s * kXBytes;
      for (int ks = 0; ks * 16 < kv; ++ks) {
        const int k = ks * 16 + (jm >> 1) * 8 + rm;
        uint32_t a[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          ldsm_x4_trans(a[m], ws + k * 128 +
                                  (((2 * m + (jm & 1)) ^ (k & 7)) << 4));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q < npass) {
            uint32_t b[2];
            ldsm_x2(b, xs + (q * 8 + rm) * kXLd + (ks * 16 + (jm & 1) * 8) * 2);
            if (kv - ks * 16 < 16) b[1] = 0u;
#pragma unroll
            for (int m = 0; m < 4; ++m) mma16816(acc[q][m], a[m], b);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(sy.empty + s);
    }
    // ---- epilogue: acc[q][m][e] is out[row i = 8 q + 2 t + (e & 1)]
    // [column warp 64 + m 16 + g + 8 (e >> 1)] of the unit's tile;
    // straight to out, or the split's partial, merged by the split that
    // arrives last
    int rid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = (j >> 1) * 8 + 2 * t + (j & 1);
      rid[j] = i < w.nrow ? p.order[w.r0 + i] : -1;
    }
    const int col0 = w.ntile * kBN + warp * kBoxN + g;
    const bool split = p.nsplit > 1;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rid[q * 2 + (e & 1)];
          const int col = col0 + 16 * m + 8 * (e >> 1);
          if (r >= 0 && col < p.N) {
            if (split)
              p.wsp[((size_t)w.split * p.R + r) * p.N + col] = acc[q][m][e];
            else
              p.out[(size_t)r * p.N + col] = __float2bfloat16(acc[q][m][e]);
          }
        }
    if (!split) continue;
    int* cnt = p.counters + 2 + w.blk * p.n_tiles + w.ntile;
    __threadfence();
    hopper::named_bar_sync(1, 128);
    if (tid == 0) *s_last = hopper::atom_add_acq_rel(cnt, 1) == p.nsplit - 1;
    hopper::named_bar_sync(1, 128);
    if (!*s_last) continue;
    __threadfence();
    for (int i = tid; i < w.nrow * kBN; i += 128) {
      const int col = w.ntile * kBN + (i % kBN);
      if (col >= p.N) continue;
      const int row = p.order[w.r0 + i / kBN];
      const float* src = p.wsp + (size_t)row * p.N + col;
      const size_t stride = (size_t)p.R * p.N;
      float v[kMaxSplit];
#pragma unroll
      for (int sp = 0; sp < kMaxSplit; ++sp)
        v[sp] = sp < p.nsplit ? __ldcg(src + sp * stride) : 0.f;
      float sum = v[0];
#pragma unroll
      for (int sp = 1; sp < kMaxSplit; ++sp)
        if (sp < p.nsplit) sum += v[sp];
      p.out[(size_t)row * p.N + col] = __float2bfloat16(sum);
    }
    if (tid == 0) *cnt = 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    slot_stream(const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const Sync sy = sync_at(sm + kBar, kStages);
  int4* blk = reinterpret_cast<int4*>(sm + kBlk);
  int* misc = reinterpret_cast<int*>(sm + kMisc);
  init_sync(sy, kStages, 4);
  build_blocks(p, blk, reinterpret_cast<int*>(sm + kScan), misc);
  const int nblk = misc[0];
  if (threadIdx.x >= 128)
    produce(&tm_w, p, sm, sy, blk, nblk);
  else
    consume(p, sm, sy, blk, nblk, misc + 1);
}

}  // namespace slots

// ---------------------------------------------------------- ds_ggemm_q
namespace q8 {

constexpr int kTile = 64;                // the plan's M-tile
constexpr int kBN = 256;                 // output columns a unit
constexpr int kBK = 64;                  // K rows a stage
constexpr int kBoxN = 128;               // codes box columns (128 bytes)
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40;        // setmaxnreg: the producer's ...
constexpr int kConsumerRegs = 232;       // ... registers go to consumers
constexpr int kXBytes = kBK * kTile * 2; // x box [64 rows x 64 k]: 8 KB
constexpr int kQBox = kBK * kBoxN;       // codes box [64 k x 128 n]: 8 KB
constexpr int kQBytes = kBN / kBoxN * kQBox;
constexpr int kEpiLd = kBN * 2 + 16;     // a staged output row (bytes)
constexpr int kEpiBytes = kTile * kEpiLd;
constexpr int kMaxStages = 8;
constexpr int kSmem = 232448;            // a CTA's dynamic shared memory
static_assert(kBN / kBoxN == 2, "a consumer warpgroup owns one codes box");

struct Params {
  const int* gids;
  const int* rows;
  bf16* out;
  float* wsp;      // [nsplit][Mp][N] partials (nsplit > 1)
  int* counters;   // [2] unit draw, then [nblocks][n_tiles] merges
  int nblocks, K, N, E, qblock, G, n_tiles, stages, nsplit, kper;
  int off_q, off_s, off_epi, off_bar, s_bytes;
};

// unit u: the N-tile fastest (the CTAs at work sweep whole rows of
// codes; an expert's several tiles are n_tiles units apart, together in
// flight, so its codes come from device memory once), then the plan tile,
// then the K split
struct Unit {
  int tile, split, ntile, e, rows, kbeg, nch;
};

__device__ __forceinline__ Unit unit_of(const Params& p, int u);

__device__ __forceinline__ int tile_of(const Params& p, int t, int* e) {
  *e = p.gids[t];
  return (*e >= 0 && *e < p.E) ? min(max(p.rows[t], 0), kTile) : 0;
}

// the first scale group of N-tile `ntile`'s box: the tile's first group,
// rounded down to 4 (a TMA box starts on a 16-byte boundary)
__device__ __forceinline__ int group0(const Params& p, int ntile) {
  return (ntile * kBN / p.qblock) & ~3;
}

__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
  Unit w;
  w.ntile = u % p.n_tiles;
  const int rest = u / p.n_tiles;
  w.tile = rest % p.nblocks;
  w.split = rest / p.nblocks;
  w.rows = tile_of(p, w.tile, &w.e);
  w.kbeg = w.split * p.kper;
  const int kend = min(p.K, w.kbeg + p.kper);
  w.nch = w.rows > 0 ? (kend - w.kbeg + kBK - 1) / kBK : 0;
  return w;
}

// One thread: for every unit and stage, the tile's x box [64 k x 64
// rows], W[e]'s codes [64 k x 256 n] as two boxes and their scales [64 k
// x G groups, from group0].
__device__ __forceinline__ void produce(const CUtensorMap* tx,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* ts, const Params& p,
                                        unsigned char* sm, const Sync& sy) {
  const int n_units = p.nblocks * p.nsplit * p.n_tiles;
  int it = 0;
  for (int n = 0;; ++n) {
    const int u = draw_unit(sy, p.counters, n, false);
    if (u >= n_units) break;
    const Unit w = unit_of(p, u);
    const int g0 = group0(p, w.ntile);
    for (int c = 0; c < w.nch; ++c, ++it) {
      const int s = it % p.stages;
      const int k = w.kbeg + c * kBK;
      hopper::mbar_wait(sy.empty + s, ((it / p.stages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(sy.full + s,
                                    kXBytes + kQBytes + p.s_bytes);
      hopper::tma_load_4d(sm + s * kXBytes, tx, sy.full + s, k,
                          w.tile * kTile, 0, 0);
#pragma unroll
      for (int b = 0; b < kBN / kBoxN; ++b)
        hopper::tma_load_4d(sm + p.off_q + s * kQBytes + b * kQBox, tq,
                            sy.full + s, w.ntile * kBN + b * kBoxN, k, w.e,
                            0);
      hopper::tma_load_4d(sm + p.off_s + s * p.s_bytes, ts, sy.full + s, g0,
                          k, w.e, 0);
    }
  }
  reset_draw(p.counters);
}

// A thread's codes of one stage, loaded together (their latency paid once
// a stage, not once a slice): for half h (64 columns) and slice kk, rows
// 16 kk + 2t, + 1, + 8, + 9 (entry 16 h + 4 kk + j).  The thread's wgmma
// rows m and m + 8 are the adjacent columns c and c + 1: one 16-bit load
// of codes a k row.
struct StageRegs {
  uint32_t code[32];
};

// offset[h][j & 1] of the code of row 2t + (j & 1) in half h: rows 16 kk
// + 8 (j >> 1) + 2t + (j & 1) share its swizzle (k & 7 = 2t + (j & 1)), so
// every load of a stage is this offset plus a constant
__device__ __forceinline__ void load_stage(StageRegs& r,
                                           const unsigned char* qst,
                                           const int (&offset)[2][2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = i >> 4, kk = (i >> 2) & 3, j = i & 3;
    r.code[i] = *reinterpret_cast<const uint16_t*>(
        qst + offset[h][j & 1] + (16 * kk + 8 * (j >> 1)) * 128);
  }
}

// int8 code (a byte of v, biased by 128 through v ^ 0x8080) as fp32:
// 2^23 + (q + 128) exactly, less 2^23 + 128 (one exact add; I2F runs at a
// quarter of the FMA pipe's rate)
__device__ __forceinline__ float code_f(uint32_t biased, uint32_t sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) -
         8388736.f;
}

// half h, slice kk's A fragment: each code times its scale in fp32, rounded
// to bf16 (gemm_tile.cuh dequant_w); sl / sh point at the scale of row 2t
// at the low and the high column's group (the same one unless a group
// edge falls between the thread's two columns), G scales a row
__device__ __forceinline__ void dequant(uint32_t (&a)[4], const StageRegs& r,
                                        int h, int kk, const float* sl,
                                        const float* sh, int G) {
  float lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = 16 * kk + 8 * (j >> 1) + (j & 1);   // past 2t
    const uint32_t v = r.code[16 * h + 4 * kk + j] ^ 0x8080u;
    lo[j] = code_f(v, 0x7440u) * sl[row * G];
    hi[j] = code_f(v, 0x7441u) * sh[row * G];
  }
  a[0] = hopper::pack_bf16(lo[0], lo[1]);
  a[1] = hopper::pack_bf16(hi[0], hi[1]);
  a[2] = hopper::pack_bf16(lo[2], lo[3]);
  a[3] = hopper::pack_bf16(hi[2], hi[3]);
}

// One consumer warpgroup (cw 0 / 1): the unit's columns 128 cw .. + 127
// as two 64-column halves (two accumulators), all 64 rows of the tile.
// Slice kk of a stage waits only for slice kk of the stage before (its A
// registers), so dequantization runs under the products in flight; a
// stage is released when its last slice's products are done (its codes
// and scales were read by then).
__device__ __forceinline__ void consume(const Params& p, unsigned char* sm,
                                        const Sync& sy, int cw) {
  const int G = p.G;
  const int tid = threadIdx.x;
  const int wl = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            t = lane & 3;
  const int n_units = p.nblocks * p.nsplit * p.n_tiles;
  unsigned char* epi = sm + p.off_epi;
  int offset[2][2];   // see load_stage
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 2 * t + j;
      offset[h][j] = k * 128 + (((4 * h + wl) ^ k) << 4) + 2 * g;
    }
  int* s_last = reinterpret_cast<int*>(sm + p.off_bar) + 4 * p.stages + 10;
  float acc[2][32];
  uint32_t a[2][4][4];
  int it = 0;
  for (int n = 0;; ++n) {
    const int u = take_unit(sy, n);
    if (u >= n_units) break;
    const Unit w = unit_of(p, u);
    const int tile = w.tile, ntile = w.ntile, rows = w.rows, nch = w.nch;
    const int g0 = group0(p, ntile);
    // this thread's columns c, c + 1 of each half: their scales' offsets
    // in a stage's scale box (row 2t, each column's group)
    int sl[2], sh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ntile * kBN + 128 * cw + 64 * h + 16 * wl + 2 * g;
      sl[h] = 2 * t * G +
              min(max(min(c, p.N - 1) / p.qblock - g0, 0), G - 1);
      sh[h] = 2 * t * G +
              min(max(min(c + 1, p.N - 1) / p.qblock - g0, 0), G - 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    hopper::fence_regs(acc);
    int prev = -1;
    for (int c = 0; c < nch; ++c, ++it) {
      const int s = it % p.stages;
      hopper::mbar_wait(sy.full + s, (it / p.stages) & 1);
      const unsigned char* qst = sm + p.off_q + s * kQBytes + cw * kQBox;
      const float* sst =
          reinterpret_cast<const float*>(sm + p.off_s + s * p.s_bytes);
      const uint64_t db =
          hopper::smem_desc(hopper::smem_u32(sm + s * kXBytes), 16, 1024, 128);
      StageRegs r;
      load_stage(r, qst, offset);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_wait<3>();   // slice kk of the stage before is done
        if (kk == 3 && prev >= 0 && lane == 0)
          hopper::mbar_arrive(sy.empty + prev);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dequant(a[h][kk], r, h, kk, sst + sl[h], sst + sh[h], G);
          hopper::fence_regs(a[h][kk]);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_rs_k64(acc[h], a[h][kk], db + ((kk * 32) >> 4));
        hopper::wgmma_commit();
      }
      prev = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (prev >= 0 && lane == 0) hopper::mbar_arrive(sy.empty + prev);
    // ---- epilogue: acc[h][4 j + q] is row 8 j + 2 t + q at the half's
    // column lc, acc[h][4 j + 2 + q] the same row at lc + 1; rows past the
    // tile's real rows are zeros.  With a K split, each split writes its
    // real rows' fp32 partial and the last of the (tile, N-tile)'s splits
    // to arrive sums them in split order (no float atomics)
    if (p.nsplit > 1) {
      const size_t m0 = (size_t)tile * kTile;
      if (rows > 0) {
        float* part = p.wsp + (size_t)w.split * p.nblocks * kTile * p.N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = ntile * kBN + 128 * cw + 64 * h + 16 * wl + 2 * g;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int r = 8 * j + 2 * t + q;
              if (r < rows && col < p.N)
                *reinterpret_cast<float2*>(part + (m0 + r) * p.N + col) =
                    make_float2(acc[h][4 * j + q], acc[h][4 * j + 2 + q]);
            }
        }
      }
      int* cnt = p.counters + 2 + tile * p.n_tiles + ntile;
      __threadfence();
      hopper::named_bar_sync(1, 256);
      if (tid == 0)
        *s_last = hopper::atom_add_acq_rel(cnt, 1) == p.nsplit - 1;
      hopper::named_bar_sync(1, 256);
      if (!*s_last) continue;
      __threadfence();
      const size_t stride = (size_t)p.nblocks * kTile * p.N;
      for (int i = tid; i < kTile * (kBN / 4); i += 256) {
        const int r = i / (kBN / 4), col = ntile * kBN + 4 * (i % (kBN / 4));
        if (col >= p.N) continue;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows) {
          const float* src = p.wsp + (m0 + r) * p.N + col;
          v = __ldcg(reinterpret_cast<const float4*>(src));
          for (int sp = 1; sp < p.nsplit; ++sp) {
            const float4 o =
                __ldcg(reinterpret_cast<const float4*>(src + sp * stride));
            v.x += o.x;
            v.y += o.y;
            v.z += o.z;
            v.w += o.w;
          }
        }
        uint2 b;
        b.x = hopper::pack_bf16(v.x, v.y);
        b.y = hopper::pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(p.out + (m0 + r) * p.N + col) = b;
      }
      if (tid == 0) *cnt = 0;
      continue;
    }
    hopper::named_bar_sync(1, 256);   // the last unit's rows are stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lc = 128 * cw + 64 * h + 16 * wl + 2 * g;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = 8 * j + 2 * t + q;
          const bool real = r < rows;
          *reinterpret_cast<uint32_t*>(epi + r * kEpiLd + lc * 2) =
              hopper::pack_bf16(real ? acc[h][4 * j + q] : 0.f,
                                real ? acc[h][4 * j + 2 + q] : 0.f);
        }
    }
    hopper::named_bar_sync(1, 256);
    for (int i = tid; i < kTile * (kBN / 8); i += 256) {
      const int r = i / (kBN / 8), ch = i % (kBN / 8);
      const int col = ntile * kBN + ch * 8;
      if (col < p.N)
        *reinterpret_cast<uint4*>(p.out + ((size_t)tile * kTile + r) * p.N +
                                  col) =
            *reinterpret_cast<const uint4*>(epi + r * kEpiLd + ch * 16);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ggemm_q_stream(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_s, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const Sync sy = sync_at(sm + p.off_bar, p.stages);
  init_sync(sy, p.stages, 8);
  __syncthreads();
  if (threadIdx.x >= 256) {   // the producer warpgroup; one thread loads
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) produce(&tm_x, &tm_q, &tm_s, p, sm, sy);
  } else {
    hopper::reg_alloc<kConsumerRegs>();
    // the warpgroup index, warp-uniform by shuffle (taken straight from
    // threadIdx.x, ptxas may read the loop as divergent and serialise
    // every wgmma: C7520)
    consume(p, sm, sy, __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0));
  }
}

// the most scale groups any kBN-column tile of an N-column weight with
// groups of qblock columns meets
int groups_met(int N, int qblock) {
  int most = 0;
  for (int n0 = 0; n0 < N; n0 += kBN)
    most = max(most, (min(n0 + kBN, N) - 1) / qblock - n0 / qblock + 1);
  return most;
}

}  // namespace q8

// [e, rows, cols] row-major of `type` elements, boxes box0 x box1
bool map3(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
          const void* base, long long e, long long rows, long long cols,
          uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[4] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)e, 1};
  const long long strides[3] = {cols, rows * cols, e * rows * cols};
  return hopper::cached_map_4d(map, type, elem_bytes, base, dims, strides,
                               box0, box1, swizzle);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// bf16 rows x [R, K] against bf16 experts w [E, K, N] through a slot plan
// (active, valid [S], row_order [R], slot_offsets [S + 1]); K split into
// nsplit ranges of kper rows (a multiple of 64).  wsp: nsplit R N floats
// (nsplit > 1); counters: 2 + blocks n_tiles ints, 0 (each launch leaves
// them 0), blocks = min(R, (R + 15 S) / 16), n_tiles = ceil(N / 256).
extern "C" int ds_ggemm_slots_s(const void* x, const void* w,
                                const void* active, const void* valid,
                                const void* order, const void* offs,
                                void* out, void* wsp, void* counters, int R,
                                int K, int N, int E, int S, int nsplit,
                                int kper, void* stream) {
  using namespace slots;
  if (R < 1 || R > 128 || S < 1 || S > R || E < 1 || K < 8 || N < 8 ||
      K % 8 || N % 8 || nsplit < 1 || nsplit > kMaxSplit || kper < kBK ||
      kper % kBK || (long long)nsplit * kper < K ||
      (long long)(nsplit - 1) * kper >= K || counters == nullptr ||
      (nsplit > 1 && wsp == nullptr) || !aligned16(x) || !aligned16(w))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tw;
  if (!map3(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, E, K, N, kBoxN,
            kBK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = hopper::opt_in_smem(
      reinterpret_cast<const void*>(slot_stream), kAlloc, opted_in);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = hopper::sm_count(&n_sm);
  if (err != cudaSuccess) return (int)err;
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.active = static_cast<const int*>(active);
  p.valid = static_cast<const int*>(valid);
  p.order = static_cast<const int*>(order);
  p.offs = static_cast<const int*>(offs);
  p.out = static_cast<bf16*>(out);
  p.wsp = static_cast<float*>(wsp);
  p.counters = static_cast<int*>(counters);
  p.R = R;
  p.K = K;
  p.N = N;
  p.E = E;
  p.S = S;
  p.nsplit = nsplit;
  p.kper = kper;
  p.n_tiles = (N + kBN - 1) / kBN;
  const int blocks = min(R, (R + 15 * S) / kRows);
  const int grid = min(n_sm, p.n_tiles * nsplit * blocks);
  slot_stream<<<grid, kThreads, kAlloc, static_cast<cudaStream_t>(stream)>>>(
      tw, p);
  return (int)cudaGetLastError();
}

// bf16 rows x [Mp, K] (the group plan's 64-row tiles) against int8 experts
// q [E, K, N] with fp32 scales s [E, K, nb] (group width ceil(N / nb)) per
// tile; K a multiple of 8, N of 16, nb of 4 with groups of two columns or
// more, bases 16-byte aligned.  K split into nsplit ranges of kper rows (a
// multiple of 64); wsp: nsplit Mp N floats (nsplit > 1); counters: 2 +
// nblocks ceil(N / 256) ints, 0 (each launch leaves them 0).
extern "C" int ds_ggemm_q_s(const void* x, const void* q, const void* s,
                            const void* gids, const void* tile_rows,
                            void* out, void* wsp, void* counters, int nblocks,
                            int K, int N, int E, int nb, int nsplit, int kper,
                            void* stream) {
  using namespace q8;
  if (nblocks < 1 || E < 1 || K < 8 || N < 16 || K % 8 || N % 16 || nb < 4 ||
      nb > N || nb % 4 || nsplit < 1 || kper < kBK || kper % kBK ||
      (long long)nsplit * kper < K || (long long)(nsplit - 1) * kper >= K ||
      counters == nullptr || (nsplit > 1 && wsp == nullptr) ||
      !aligned16(x) || !aligned16(q) || !aligned16(s) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int qblock = (N + nb - 1) / nb;
  // the groups a 256-column tile meets, from its first group rounded down
  // to 4 (group0), in a box of whole 16 bytes
  const int G = min(nb, (groups_met(N, qblock) + 3 + 3) / 4 * 4);
  if (G > 256) return (int)cudaErrorInvalidValue;   // a TMA box's most
  const long long Mp = (long long)nblocks * kTile;
  CUtensorMap tx, tq, ts;
  if (!map3(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, 1, Mp, K, kBK, kTile,
            CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map3(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, E, K, N, kBoxN, kBK,
            CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map3(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, s, E, K, nb, G, kBK,
            CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.gids = static_cast<const int*>(gids);
  p.rows = static_cast<const int*>(tile_rows);
  p.out = static_cast<bf16*>(out);
  p.wsp = static_cast<float*>(wsp);
  p.counters = static_cast<int*>(counters);
  p.nblocks = nblocks;
  p.K = K;
  p.N = N;
  p.E = E;
  p.qblock = qblock;
  p.G = G;
  p.n_tiles = (N + kBN - 1) / kBN;
  p.nsplit = nsplit;
  p.kper = kper;
  p.s_bytes = kBK * G * 4;
  // as many stages as fit beside the epilogue tile and the barriers
  const int fixed = 1024 + kEpiBytes + (2 * kMaxStages + 4) * 8 + 16;
  p.stages = min(kMaxStages, (kSmem - fixed) / (kXBytes + kQBytes + p.s_bytes));
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  p.off_q = p.stages * kXBytes;
  p.off_s = p.off_q + p.stages * kQBytes;
  p.off_epi = p.off_s + p.stages * p.s_bytes;
  p.off_bar = p.off_epi + kEpiBytes;
  const int alloc = p.off_bar + (2 * p.stages + 4) * 8 + 16 + 1024;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = hopper::opt_in_smem(
      reinterpret_cast<const void*>(ggemm_q_stream), kSmem, opted_in);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = hopper::sm_count(&n_sm);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(n_sm, nblocks * nsplit * p.n_tiles);
  ggemm_q_stream<<<grid, kThreads, alloc,
                   static_cast<cudaStream_t>(stream)>>>(tx, tq, ts, p);
  return (int)cudaGetLastError();
}
