// Grouped GEMM for routed experts on Hopper: the bf16 forms of ds_ggemm
// (forward), ds_ggemm_t (dx) and ds_tgmm (dW) as persistent wgmma / TMA
// kernels on csrc/hopper.cuh.  The fp32 forms, bf16 shapes that TMA cannot
// address (K or N not a multiple of 8, a base not 16-byte aligned), the
// int8 experts and the slot kernels stay in csrc/grouped_gemm.cu.
//
// Replaces: deepspeed_tpu/ops/pallas/grouped_gemm.py _ggemm_kernel (:163;
// its forward form and its transpose_rhs=True form) and _tgmm_kernel
// (:222), the products of the MoE layer's forward and of _ggemm_diff's VJP
// (:580-605).  Same semantics as the plain versions (ggemm_plain,
// ggemm_t_plain, tgmm_plain in ops/kernels/grouped_gemm.py):
//   forward  out[Mp, N] = x[Mp, K] W[gid(tile)]          (x K-major, W
//            [E, K, N] read MN-major through the transpose bit)
//   dx       dx[Mp, K]  = dy[Mp, N] W[gid(tile)]^T       (dy K-major, W's
//            rows k0.. contiguous along the contraction: K-major)
//   dW       dW[e][K, N] = the sum over expert e's run of rows of
//            x_row^T dy_row                            (both MN-major: the
//            contraction runs down the rows)
// with fp32 accumulation and one rounding to the output type.  Rows past
// a tile's real rows (tile_rows) and tiles without any (an empty expert's
// tile, the trailing tiles past the last group) are written as exact
// zeros by the epilogue's row mask, whatever the input's padding holds; an
// expert with no routed rows gets an exact-zero dW and fetches nothing.
//
// What bounds them on an H100: operations at training shapes.  At
// mixtral:1b-moe's (R 16,384 routed rows, K 1024, N 3584) each form does
// 2 R K N = 1.20e11 flop, 0.122 ms at 989 TFLOP/s, against ~214 MB moved
// (0.064 ms at 3.35 TB/s); Mixtral-8x7B's prefill forward (R 1800, K 4096,
// N 14336) is bound by the distinct experts' weights, 0.94 GB (0.28 ms).
// What the design does about it:
//   - a CTA of three warpgroups, one CTA per SM (persistent): warpgroup 0
//     hands its registers to the others (setmaxnreg) and one thread of it
//     draws work units from a counter in device memory (a unit's work
//     depends on the routing, so a fixed share per CTA would leave the
//     CTAs that drew split pairs or long experts finishing last) and
//     loads by TMA; warpgroups 1 and 2 each own 64 output rows x 256
//     columns, wgmma m64n256k16 from shared memory into 128 fp32
//     registers a thread;
//   - a 128 x 256 output tile: one 64-row tile would read its weight tile
//     from L2 for every 64 rows, and at the tensor cores' rate that
//     traffic (80 bytes a clock an SM) is more than L2 gives.  The plan's
//     tile stays 64 rows (DEFAULT_BLOCK_M), so the forward and dx pair
//     M-tiles 2p and 2p + 1: when both belong to one expert (all but at
//     most E - 1 pairs) one pass serves both; a pair split between two
//     experts runs two passes over the contraction, one for each
//     expert's weights, the warpgroup whose tile the pass is not for
//     only releasing the ring's stages (no wgmma in a data-dependent
//     branch: the decision is a loop count);
//   - the contraction in 64-wide chunks through a 4-stage ring of [128 x
//     64] A and [64 x 256] B boxes (48 KB a stage, 128-byte swizzle),
//     full / empty mbarriers; the producer runs ahead across work units,
//     so the next unit's loads overlap this one's epilogue;
//   - the unit order keeps what is re-read in L2: for the forward and dx
//     the column blocks of one pair run together while one expert's
//     weights (K N 2 bytes) fit in L2 with room to spare, else the pairs
//     of one column block (each expert's weight block streams once from
//     device memory for all its tiles: the prefill's case); dW walks one
//     expert's units together (its run of x and dy stays in L2);
//   - deterministic and row-independent: one CTA owns an output tile's
//     whole contraction, chunks in order, no float atomics (which CTA
//     takes a unit varies, what the unit computes does not); the tile,
//     the chunking and the pairing depend on no data value and not on R,
//     so a row's forward or dx bits do not depend on the rows around it,
//     and dW has the same bits every run;
//   - dW contracts over whole 64-row boxes of the expert's run (its real
//     rows rounded up to the tile): the rows past them are the layout's
//     zero padding, as tgmm_plain's product over the padded group
//     assumes; the run starts on a 64-row boundary, so no box reaches into
//     the next expert;
//   - the epilogue stages each warpgroup's tile through swizzled shared
//     memory in 128-byte-wide subtiles (two buffers) and stores them by
//     TMA, so the stores drain while the next unit's products run;
//   - tensor maps are cached by (address, shape, box) on the host (the
//     expert stacks are the same tensors every step), so a launch
//     seldom encodes one.
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

constexpr int kTileRows = 64;   // the plan's M-tile (DEFAULT_BLOCK_M)
constexpr int kBM = 128;        // output rows a CTA tile: two warpgroups
constexpr int kBN = 256;        // output columns a CTA tile
constexpr int kBK = 64;         // contraction a stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kThreads = 384;   // producer warpgroup + two consumer ones
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBox = 64 * kBK * 2;      // one [64][64] bf16 box: 8 KB
constexpr int kABytes = kBM * kBK * 2;  // 16 KB
constexpr int kBBytes = kBK * kBN * 2;  // 32 KB
constexpr int kStage = kABytes + kBBytes;
// the epilogue's staging: per consumer warpgroup two buffers of [64 rows]
// x 128 bytes (64 bf16 or 32 fp32 columns), 128-byte swizzled
constexpr int kEpiBuf = 64 * 128;
constexpr int kEpi = kStages * kStage;
constexpr int kBar = kEpi + 4 * kEpiBuf;
// barriers: a stage's full / empty, a unit slot's full / empty; then the
// two unit slots
constexpr int kUnits = kBar + (2 * kStages + 4) * 8;
constexpr int kAlloc = kUnits + 2 * 4 + 1024;   // + base alignment
constexpr int kSBO = 8 * 128;           // 8 swizzled 128-byte rows
// one expert's weights up to this many bytes stay in L2 across its tiles
constexpr double kL2Keep = 16e6;

enum Kind { kFwd = 0, kDx = 1, kDw = 2 };

struct Params {
  const int* tile_e;   // forward / dx: expert per M-tile; dW: group_sizes
  const int* rows;     // forward / dx: real rows per M-tile; dW: counts
  int nblocks;         // forward / dx: M-tiles of the plan
  int Mp, K, N, E;
  int n_mb, n_nb;      // units: forward / dx pairs (dW K blocks) x column
                       // blocks
  int n_units;
  int* counters;       // [2]: units handed out, CTAs done; 0 between
                       // launches (the last CTA returns them to 0)
  int pairs_fastest;   // forward / dx unit order (see the header)
  int nch;             // forward / dx chunks of the contraction
  int ncols;           // output columns
};

// One work unit as the producer and both consumer warpgroups see it.
struct Work {
  int mb, nb;          // forward / dx: pair, column block; dW: K, N blocks
  int npass;           // 0 (nothing to fetch), 1 or 2 (a split pair)
  int e[2];            // the expert of each pass
  int own[2];          // bit w: warpgroup w accumulates in that pass
  int nch;             // chunks a pass
  int rows[2];         // forward / dx: real rows of each warpgroup's tile
  int p0;              // dW: the expert's first row; its id is e[0]
};

__device__ __forceinline__ int tile_rows_of(const Params& p, int t, int* e) {
  if (t >= p.nblocks) {
    *e = -1;
    return 0;
  }
  *e = p.tile_e[t];
  return (*e >= 0 && *e < p.E) ? min(max(p.rows[t], 0), kTileRows) : 0;
}

template <int KIND>
__device__ __forceinline__ Work work_of(const Params& p, int u) {
  Work w;
  if constexpr (KIND == kDw) {
    const int per = p.n_mb * p.n_nb;
    const int e = u / per;
    const int r = u - e * per;
    w.mb = r / p.n_nb;
    w.nb = r - w.mb * p.n_nb;
    long long p0 = 0;
    for (int g = 0; g < e; ++g) p0 += max(p.tile_e[g], 0);
    const long long run = min((long long)min(max(p.rows[e], 0),
                                             max(p.tile_e[e], 0)),
                              (long long)p.Mp - p0);
    const int rows = (int)max(0LL, run);
    w.p0 = (int)min(p0, (long long)p.Mp);
    w.nch = (rows + kBK - 1) / kBK;
    w.npass = w.nch > 0 ? 1 : 0;
    w.e[0] = w.e[1] = e;
    w.own[0] = w.own[1] = 3;
    w.rows[0] = w.rows[1] = 0;
  } else {
    if (p.pairs_fastest) {
      w.nb = u / p.n_mb;
      w.mb = u - w.nb * p.n_mb;
    } else {
      w.mb = u / p.n_nb;
      w.nb = u - w.mb * p.n_nb;
    }
    int ea, eb;
    const int ra = tile_rows_of(p, 2 * w.mb, &ea);
    const int rb = tile_rows_of(p, 2 * w.mb + 1, &eb);
    w.rows[0] = ra;
    w.rows[1] = rb;
    w.p0 = 0;
    w.nch = p.nch;
    if (ra > 0 && rb > 0 && ea != eb) {
      w.npass = 2;
      w.e[0] = ea;
      w.e[1] = eb;
      w.own[0] = 1;
      w.own[1] = 2;
    } else {
      w.npass = (ra > 0 || rb > 0) ? 1 : 0;
      w.e[0] = w.e[1] = ra > 0 ? ea : eb;
      w.own[0] = w.own[1] = (ra > 0 ? 1 : 0) | (rb > 0 ? 2 : 0);
    }
  }
  return w;
}

// The CTA's barriers and unit slots.  Units are handed out at run time
// (an atomic counter), so a CTA that drew short units (empty tiles, small
// experts) takes more: the work of a unit depends on the routing.  The
// producer draws each unit and passes its index to both consumer
// warpgroups through two slots.
struct Sync {
  uint64_t* full;    // [kStages] a stage's bytes landed
  uint64_t* empty;   // [kStages] a stage read by every consumer warp
  uint64_t* ufull;   // [2] a unit slot written
  uint64_t* uempty;  // [2] a unit slot read by every consumer warp
  int* units;        // [2]
};

// The producer (one thread): for every unit, pass and chunk, wait for the
// stage to be free, announce its bytes and load A and B into it.  Boxes
// past a tensor's extent land as zeros and count toward the bytes.
template <int KIND>
__device__ __forceinline__ void produce(const CUtensorMap* ta,
                                        const CUtensorMap* tb,
                                        const Params& p, unsigned char* sm,
                                        const Sync& sy) {
  uint64_t* full = sy.full;
  uint64_t* empty = sy.empty;
  int it = 0;
  for (int n = 0;; ++n) {
    const int slot = n & 1;
    hopper::mbar_wait(sy.uempty + slot, ((n >> 1) & 1) ^ 1);
    const int u = atomicAdd(p.counters, 1);
    sy.units[slot] = u;
    hopper::mbar_arrive(sy.ufull + slot);   // releases the slot's write
    if (u >= p.n_units) break;
    const Work w = work_of<KIND>(p, u);
    for (int pass = 0; pass < w.npass; ++pass) {
      const int e = pass ? w.e[1] : w.e[0];
      for (int c = 0; c < w.nch; ++c, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        unsigned char* a = sm + s * kStage;
        unsigned char* b = a + kABytes;
        hopper::mbar_arrive_expect_tx(full + s, kStage);
        if constexpr (KIND == kFwd) {
          // x [128 rows x 64 k]; W[e] [64 k x 256 n] as four 64-column boxes
          hopper::tma_load_4d(a, ta, full + s, c * kBK, w.mb * kBM, 0, 0);
#pragma unroll
          for (int q = 0; q < kBN / 64; ++q)
            hopper::tma_load_4d(b + q * kBox, tb, full + s,
                                w.nb * kBN + q * 64, c * kBK, e, 0);
        } else if constexpr (KIND == kDx) {
          // dy [128 rows x 64 n]; W[e] rows [256 k x 64 n]
          hopper::tma_load_4d(a, ta, full + s, c * kBK, w.mb * kBM, 0, 0);
          hopper::tma_load_4d(b, tb, full + s, c * kBK, w.nb * kBN, e, 0);
        } else {
          // x [64 rows x 128 k] as two 64-column boxes; dy [64 rows x 256
          // n] as four
          const int r0 = w.p0 + c * kBK;
#pragma unroll
          for (int q = 0; q < kBM / 64; ++q)
            hopper::tma_load_4d(a + q * kBox, ta, full + s,
                                w.mb * kBM + q * 64, r0, 0, 0);
#pragma unroll
          for (int q = 0; q < kBN / 64; ++q)
            hopper::tma_load_4d(b + q * kBox, tb, full + s,
                                w.nb * kBN + q * 64, r0, 0, 0);
        }
      }
    }
  }
  // every CTA has drawn its last unit once all have come here: the last
  // returns the counters to 0 for the next launch
  if (atomicAdd(p.counters + 1, 1) == (int)gridDim.x - 1) {
    atomicExch(p.counters, 0);
    atomicExch(p.counters + 1, 0);
  }
}

// The k16 slice kk of a 64-wide chunk: K-major operands step 32 bytes
// along the swizzled row, MN-major ones 16 rows (2048 bytes).
template <int KIND>
__device__ __forceinline__ void issue_chunk(float (&acc)[128], uint64_t da,
                                            uint64_t db) {
  constexpr int TA = KIND == kDw ? 1 : 0;
  constexpr int TB = KIND == kDx ? 0 : 1;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t oa = TA ? kk * 16 * 128 : kk * 32;
    const uint32_t ob = TB ? kk * 16 * 128 : kk * 32;
    hopper::wgmma_m64n256k16_ss<TA, TB>(acc, da + (oa >> 4), db + (ob >> 4),
                                        1);
  }
  hopper::wgmma_commit();
}

template <typename OT>
__device__ __forceinline__ void store2(OT* dst, float lo, float hi) {
  if constexpr (sizeof(OT) == 2)
    *reinterpret_cast<uint32_t*>(dst) = hopper::pack_bf16(lo, hi);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

// One consumer warpgroup (cw 0 / 1): its 64 rows of every unit.
template <int KIND, typename OT>
__device__ __forceinline__ void consume(const CUtensorMap* tc,
                                        const Params& p, unsigned char* sm,
                                        const Sync& sy, int cw) {
  constexpr int TA = KIND == kDw ? 1 : 0;
  constexpr int TB = KIND == kDx ? 0 : 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t base = hopper::smem_u32(sm);
  // A: this warpgroup's 64 rows (K-major: rows 64 cw.. of the [128][64]
  // box; MN-major: the cw-th 64-column box); B: the whole stage
  const uint32_t a_off = TA ? cw * kBox : cw * 64 * 128;
  const uint32_t lbo_a = TA ? kBox : 16, lbo_b = TB ? kBox : 16;
  unsigned char* epi = sm + kEpi + cw * 2 * kEpiBuf;
  uint64_t* full = sy.full;
  uint64_t* empty = sy.empty;
  float acc[128];
  int it = 0;
  int n_st = 0;   // subtiles stored: the staging buffer alternates
  for (int n = 0;; ++n) {
    const int slot = n & 1;
    hopper::mbar_wait(sy.ufull + slot, (n >> 1) & 1);
    const int u = sy.units[slot];
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(sy.uempty + slot);
    if (u >= p.n_units) break;
    const Work w = work_of<KIND>(p, u);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    hopper::fence_regs(acc);
    for (int pass = 0; pass < w.npass; ++pass) {
      // the pass's products are this warpgroup's when it owns the pass;
      // else it only frees the stages (a loop count, not a branch)
      const int own = pass ? w.own[1] : w.own[0];
      const int n_mma = (own >> cw) & 1 ? w.nch : 0;
      int prev = -1;
      for (int c = 0; c < n_mma; ++c, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(full + s, (it / kStages) & 1);
        const uint32_t sa = base + s * kStage;
        const uint64_t da = hopper::smem_desc(sa + a_off, lbo_a, kSBO, 128);
        const uint64_t db = hopper::smem_desc(sa + kABytes, lbo_b, kSBO, 128);
        hopper::wgmma_fence();
        issue_chunk<KIND>(acc, da, db);
        hopper::wgmma_wait<1>();   // the previous chunk's products are done
        if (prev >= 0 && lane == 0) hopper::mbar_arrive(empty + prev);
        prev = s;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(empty + prev);
      for (int c = n_mma; c < w.nch; ++c, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(full + s, (it / kStages) & 1);
        if (lane == 0) hopper::mbar_arrive(empty + s);
      }
    }
    // ---- epilogue: the warpgroup's [64 x 256] in subtiles of SC
    // columns (128 bytes a row), each written to one of its two staging
    // buffers and stored by TMA while the next one is written (and while
    // the next unit's products run); rows without products are zeros, and
    // what lies past the output's extent is not written
    constexpr int SC = 128 / (int)sizeof(OT);
    int c0, row, e3;   // the store's coordinates
    int lim;           // rows of the warpgroup's 64 that hold products
    bool store;
    if constexpr (KIND == kDw) {
      c0 = w.nb * kBN;
      row = w.mb * kBM + cw * 64;
      e3 = w.e[0];
      lim = kTileRows;
      store = row < p.K;
    } else {
      const int t = 2 * w.mb + cw;
      c0 = w.nb * kBN;
      row = t * kTileRows;
      e3 = 0;
      lim = cw ? w.rows[1] : w.rows[0];
      store = t < p.nblocks;
    }
    const int r0 = warp * 16 + (lane >> 2);
    if (store) {
#pragma unroll
      for (int js = 0; js < kBN / SC; ++js) {
        if (c0 + js * SC < p.ncols) {
          unsigned char* buf = epi + (n_st & 1) * kEpiBuf;
          if (tid == 0) hopper::bulk_wait_read<1>();   // buf's last store
          hopper::named_bar_sync(1 + cw, 128);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            const bool real = r < lim;
#pragma unroll
            for (int jj = 0; jj < SC / 8; ++jj) {
              const int j = js * (SC / 8) + jj;
              const int bo = (8 * jj + 2 * (lane & 3)) * (int)sizeof(OT);
              const int at = r * 128 + ((((bo >> 4) ^ (r & 7))) << 4) +
                             (bo & 15);
              store2<OT>(reinterpret_cast<OT*>(buf + at),
                         real ? acc[4 * j + 2 * h] : 0.f,
                         real ? acc[4 * j + 2 * h + 1] : 0.f);
            }
          }
          hopper::fence_proxy_async();
          hopper::named_bar_sync(1 + cw, 128);
          if (tid == 0) {
            hopper::tma_store_4d(tc, buf, c0 + js * SC, row, e3, 0);
            hopper::bulk_commit();
          }
          ++n_st;
        }
      }
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();
}

template <int KIND, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    ggemm_hopper(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + kBar);
  const Sync sy{bars, bars + kStages, bars + 2 * kStages,
                bars + 2 * kStages + 2, reinterpret_cast<int*>(sm + kUnits)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(sy.full + s, 1);
      hopper::mbar_init(sy.empty + s, 8);   // one arrival a consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(sy.ufull + s, 1);
      hopper::mbar_init(sy.uempty + s, 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {   // producer warpgroup; one thread loads
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) produce<KIND>(&tm_a, &tm_b, p, sm, sy);
  } else {
    hopper::reg_alloc<kConsumerRegs>();
    consume<KIND, OT>(&tm_c, p, sm, sy, threadIdx.x / 128 - 1);
  }
}

// ------------------------------------------------------------ host side
// a row-major [rows, cols] matrix, or [e, rows, cols], of bf16 (or fp32),
// 128-byte swizzled boxes; maps cached by every field they encode
// (hopper::cached_map_4d)
bool map_of(CUtensorMap* map, const void* base, long long e, long long rows,
            long long cols, uint32_t box0, uint32_t box1, bool f32 = false) {
  const uint64_t dims[4] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)e, 1};
  const long long strides[3] = {cols, rows * cols, e * rows * cols};
  return hopper::cached_map_4d(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      f32 ? 4 : 2, base, dims, strides, box0, box1,
      CU_TENSOR_MAP_SWIZZLE_128B);
}
// the output's map: subtiles of 128 bytes x 64 rows (see the epilogue)
template <typename OT>
bool out_map(CUtensorMap* map, void* out, long long e, long long rows,
             long long cols) {
  return map_of(map, out, e, rows, cols, 128 / sizeof(OT), 64,
                sizeof(OT) == 4);
}

template <int KIND, typename OT>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const CUtensorMap& tc, Params p, cudaStream_t stream) {
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t e = hopper::opt_in_smem(
      reinterpret_cast<const void*>(ggemm_hopper<KIND, OT>), kAlloc,
      opted_in);
  if (e != cudaSuccess) return e;
  int n_sm = 0;
  e = hopper::sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  p.n_units = p.n_mb * p.n_nb * (KIND == kDw ? p.E : 1);
  const int grid = min(p.n_units, n_sm);
  ggemm_hopper<KIND, OT><<<grid, kThreads, kAlloc, stream>>>(ta, tb, tc,
                                                              p);
  return cudaGetLastError();
}

// forward / dx: M-tile pairs x column blocks of `cols` output columns;
// pairs fastest when one expert's weights do not stay in L2
Params pair_params(const void* gids, const void* tile_rows, void* counters,
                   int nblocks, int K, int N, int E, int cols, int nch) {
  Params p{};
  p.tile_e = static_cast<const int*>(gids);
  p.rows = static_cast<const int*>(tile_rows);
  p.counters = static_cast<int*>(counters);
  p.nblocks = nblocks;
  p.Mp = nblocks * kTileRows;
  p.K = K;
  p.N = N;
  p.E = E;
  p.n_mb = (nblocks + 1) / 2;
  p.n_nb = (cols + kBN - 1) / kBN;
  p.pairs_fastest = 2.0 * K * N > kL2Keep;
  p.nch = nch;
  p.ncols = cols;
  return p;
}

bool args_ok(int a, int K, int N, int E) {
  return a >= 1 && K >= 8 && N >= 8 && E >= 1 && K % 8 == 0 && N % 8 == 0;
}

}  // namespace

// forward: out [Mp, N] = x [Mp, K] against w [E, K, N] per M-tile (bf16;
// K and N multiples of 8, bases 16-byte aligned).  counters: 2 ints, 0
// (each launch leaves them 0), for the launch's work-unit draw.
extern "C" int ds_ggemm_h(const void* x, const void* w, const void* gids,
                          const void* tile_rows, void* out, void* counters,
                          int nblocks, int K, int N, int E, void* stream) {
  if (!args_ok(nblocks, K, N, E) || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long Mp = (long long)nblocks * kTileRows;
  CUtensorMap ta, tb, tc;
  if (!map_of(&ta, x, 1, Mp, K, kBK, kBM) ||
      !map_of(&tb, w, E, K, N, 64, kBK) || !out_map<bf16>(&tc, out, 1, Mp, N))
    return (int)cudaErrorInvalidValue;
  const Params p = pair_params(gids, tile_rows, counters, nblocks, K, N, E,
                               N, (K + kBK - 1) / kBK);
  return (int)launch<kFwd, bf16>(ta, tb, tc, p,
                                 static_cast<cudaStream_t>(stream));
}

// dx [Mp, K] = dy [Mp, N] against w [E, K, N] transposed, per M-tile
extern "C" int ds_ggemm_t_h(const void* dy, const void* w, const void* gids,
                            const void* tile_rows, void* dx, void* counters,
                            int nblocks, int K, int N, int E, void* stream) {
  if (!args_ok(nblocks, K, N, E) || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long Mp = (long long)nblocks * kTileRows;
  CUtensorMap ta, tb, tc;
  if (!map_of(&ta, dy, 1, Mp, N, kBK, kBM) ||
      !map_of(&tb, w, E, K, N, kBK, kBN) || !out_map<bf16>(&tc, dx, 1, Mp, K))
    return (int)cudaErrorInvalidValue;
  const Params p = pair_params(gids, tile_rows, counters, nblocks, K, N, E,
                               K, (N + kBK - 1) / kBK);
  return (int)launch<kDx, bf16>(ta, tb, tc, p,
                                static_cast<cudaStream_t>(stream));
}

// dW [E, K, N] = per expert, x [Mp, K]^T dy [Mp, N] over its run of rows
// (group_sizes, counts); out_f32: dW in fp32, else bf16
extern "C" int ds_tgmm_h(const void* x, const void* dy, const void* gsizes,
                         const void* counts, void* dw, void* counters, int Mp,
                         int K, int N, int E, int out_f32, void* stream) {
  if (!args_ok(Mp, K, N, E) || Mp % kTileRows != 0 || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tc;
  if (!map_of(&ta, x, 1, Mp, K, 64, kBK) ||
      !map_of(&tb, dy, 1, Mp, N, 64, kBK) ||
      !(out_f32 ? out_map<float>(&tc, dw, E, K, N)
                : out_map<bf16>(&tc, dw, E, K, N)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.tile_e = static_cast<const int*>(gsizes);
  p.rows = static_cast<const int*>(counts);
  p.counters = static_cast<int*>(counters);
  p.Mp = Mp;
  p.K = K;
  p.N = N;
  p.E = E;
  p.n_mb = (K + kBM - 1) / kBM;
  p.n_nb = (N + kBN - 1) / kBN;
  p.ncols = N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? (int)launch<kDw, float>(ta, tb, tc, p, st)
                 : (int)launch<kDw, bf16>(ta, tb, tc, p, st);
}
