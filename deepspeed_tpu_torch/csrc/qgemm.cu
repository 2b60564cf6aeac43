// Fused-dequant int8 GEMM: out [M, N] = x [M, K] @ dequant(q [K, N],
// scales [K, nb]), out in x's dtype.
//
// Replaces: deepspeed_tpu/ops/pallas/qgemm.py:_qgemm_kernel.
//
// What bounds it on an H100: bytes at the decode shapes (M = 8 rows
// against K x N int8 weights: ~2 flops per weight byte), operations only
// at prefill-sized M.  The weight stays int8 in device memory.  Every
// form dequantizes an element as (float)q * scale rounded to x's dtype
// (the reference's cast point) and accumulates in fp32; the caller picks
// the form by ops/kernels/qgemm.py qgemm_route (the `route` argument):
//  - 0, stream: bf16 rows, M <= 128, TMA-aligned shapes (decode_stream.cuh
//    stream_ok): a persistent launch over (32-row group, 256 columns, K
//    split) units; a producer warp streams the codes and their scales
//    through a TMA ring, eight consumer warps dequantize each code into
//    an mma.sync A fragment (swap-AB: W^T on the M side, 8 rows a pass);
//  - 1, rows: M <= 128 otherwise (fp32 rows: fmaf, no TF32), in 8-row
//    blocks of gemm_tile.cuh rows_mma ([8 x 256], weight rows straight
//    into registers);
//  - 2, tile: M > 128 (and scale groups under 8 columns), tile_mma's
//    [64 x 64] cp.async chunks into wmma bf16 m16n16k16 (fmaf for fp32).
// K splits across up to kMaxSplit CTAs per tile; each writes its fp32
// partial to a workspace and the last to arrive (an atomic per-tile
// counter, reset by that CTA) sums the partials in split order and writes
// the tile: one launch, deterministic.  The stream and rows forms split K
// by N, K and the SM count alone (decode_stream.cuh splits), and neither
// lets one row meet another in a sum, so a row's bits are the same at
// every M from 1 to 128.  Columns past N and the ragged last scale group
// enter as zeros.
//
// C interface (loaded with ctypes): ds_qgemm returns the cudaError_t of
// the launch as an int.
#include <atomic>

#include "decode_stream.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace dstile;
constexpr int kMaxSplit = 8;       // K splits of the tile path
constexpr int kRowsMaxSplit = 16;  // K splits of the decode forms
constexpr int kStreamMaxRows = 128;
static_assert(kMaxSplit <= kRowsMaxSplit, "sum_splits bound");
static_assert(kRowsMaxSplit == dstream::kMaxSplit, "one split rule");

// The CTA's [R x bn] result tile `ct` (row stride ldc) into out, or, when
// K is split, into its slot of the workspace; the last of the tile's
// nsplit CTAs to arrive (an atomic counter that it returns to 0) sums
// the slots in split order and writes the tile.  A workspace slot holds
// rmax x bn floats (the path's full tile).
template <typename T>
__device__ void finish_tile(const float* ct, int ldc, int R, int rmax,
                            int bn, int m0, int n0, int N,
                            T* __restrict__ out, float* __restrict__ ws,
                            int* __restrict__ counters, int tile, int split,
                            int nsplit) {
  __shared__ int s_last;
  if (nsplit == 1) {
    for (int e = threadIdx.x; e < R * bn; e += NT) {
      const int r = e / bn, n = e - r * bn;
      if (n0 + n < N)
        out[(size_t)(m0 + r) * N + n0 + n] = from_f<T>(ct[r * ldc + n]);
    }
    return;
  }
  const size_t slot = (size_t)rmax * bn;
  float* part = ws + (size_t)tile * nsplit * slot;
  for (int e = threadIdx.x; e < R * bn; e += NT) {
    const int r = e / bn, n = e - r * bn;
    part[(size_t)split * slot + e] = ct[r * ldc + n];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counters + tile, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // four elements a thread at a time: their nsplit loads each issue
  // together, so the sum costs a few L2 latencies, not one per split
  constexpr int kE = 4;
  for (int e0 = threadIdx.x; e0 < R * bn; e0 += kE * NT) {
    float v[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = e0 + j * NT;
      v[j] = e < R * bn ? sum_splits<kRowsMaxSplit>(part + e, slot, nsplit)
                        : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = e0 + j * NT;
      const int r = e / bn, n = e - r * bn;
      if (e < R * bn && n0 + n < N)
        out[(size_t)(m0 + r) * N + n0 + n] = from_f<T>(v[j]);
    }
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

// tile path: grid (N / BN, M / RPMAX, nsplit), K split in `kper` rows
template <typename T>
__global__ void __launch_bounds__(NT)
qgemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ s, T* __restrict__ out,
             float* __restrict__ ws, int* __restrict__ counters, int M,
             int N, int K, int nb, int qblock, int nsplit, int kper) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * RPMAX;
  const int split = blockIdx.z;
  const int R = min(RPMAX, M - m0);
  const int k_begin = split * kper;
  const int k_end = min(K, k_begin + kper);
  const float* ct = tile_mma<T, int8_t>(x + (size_t)m0 * K, K, R, q, s, nb,
                                        qblock, N, n0, k_begin, k_end, smem);
  finish_tile<T>(ct, BN + CPAD, R, RPMAX, BN, m0, n0, N, out, ws, counters,
                 blockIdx.y * gridDim.x + blockIdx.x, split, nsplit);
}

// rows form (M <= 128): grid (N / RBN, ceil(M / RROWS), nsplit), each CTA
// one 8-row block's [8 x 256] tile over its K range
template <typename T>
__global__ void __launch_bounds__(NT)
qgemm_rows_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ s, T* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int M,
                  int N, int K, int nb, int qblock, int nsplit, int kper) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * RBN;
  const int m0 = blockIdx.y * RROWS;
  const int split = blockIdx.z;
  const int k_begin = split * kper;
  const int k_end = min(K, k_begin + kper);
  const int R = min(RROWS, M - m0);
  const float* ct = rows_mma<T, int8_t>(x + (size_t)m0 * K, K, R, q, s, nb,
                                        qblock, N, n0, k_begin, k_end, smem);
  finish_tile<T>(ct, RBN, R, RROWS, RBN, m0, n0, N, out, ws, counters,
                 blockIdx.y * gridDim.x + blockIdx.x, split, nsplit);
}

// stream form: a persistent grid over the units of decode_stream.cuh;
// warp 8 produces, warps 0-7 (32 columns each) consume and store
// (nsplit 1) or write their split's partial [nsplit][M][N], the last split
// of a (row group, column tile) to arrive summing them in split order
struct StreamParams {
  __nv_bfloat16* out;
  float* ws;
  int* counters;   // [row groups][column tiles]
  int M;
  dstream::Proj p;
};

__global__ void __launch_bounds__(dstream::kThreads, 1)
qgemm_stream(const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap tx,
             const StreamParams prm) {
  using namespace dstream;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ int s_last;
  const Proj& p = prm.p;
  const int M = prm.M, N = p.N;
  if (threadIdx.x == 0) init_ring<true>(ring);
  __syncthreads();
  const int total = units_of(p, M);
  if (threadIdx.x >= kConsumers) {
    int it = 0;
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      const Unit w = unit_of(p, M, u);
      for (int c = 0; c < w.nch; ++c, ++it) {
        issue_weights<true>(ring, &tw, p, w, c, it, row_bytes(w));
        issue_rows<true>(ring, &tx, w, c, it);
      }
    }
    return;
  }
  const int tid = threadIdx.x;
  int it = 0;
  Acc acc;
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    const Unit w = unit_of(p, M, u);
    consume_unit<true>(ring, acc, p, w, it);
    if (p.nsplit == 1) {
      for_each_acc<true>(acc, p, w, M, [&](int r, int col, float v) {
        prm.out[(size_t)r * N + col] = __float2bfloat16(v);
      });
      continue;
    }
    float* part = prm.ws + (size_t)w.split * M * N;
    for_each_acc<true>(acc, p, w, M, [&](int r, int col, float v) {
      part[(size_t)r * N + col] = v;
    });
    // one acquire-release add after the consumers' barrier publishes the
    // partial and, for the last, makes the others' visible
    int* cnt = prm.counters + w.rg * p.ntiles + w.ntile;
    hopper::named_bar_sync(1, kConsumers);
    if (tid == 0) s_last = hopper::atom_add_acq_rel(cnt, 1) == p.nsplit - 1;
    hopper::named_bar_sync(1, kConsumers);
    if (!s_last) continue;
    // 8 columns a thread; the loads of 8 splits issue together, summed in
    // split order
    const size_t stride = (size_t)M * N;
    constexpr int kB = 8;
    for (int e = tid; e < w.rows * (kBN / 8); e += kConsumers) {
      const int r = w.rg * kGroupRows + e / (kBN / 8);
      const int col = w.ntile * kBN + (e % (kBN / 8)) * 8;
      if (col >= N) continue;   // N % 16 == 0: whole groups of 8
      const float* src = prm.ws + (size_t)r * N + col;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      for (int s0 = 0; s0 < p.nsplit; s0 += kB) {
        float4 v[kB][2];
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          if (s0 + j < p.nsplit) {
            const float4* q4 =
                reinterpret_cast<const float4*>(src + (s0 + j) * stride);
            v[j][0] = __ldcg(q4);
            v[j][1] = __ldcg(q4 + 1);
          }
        }
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          if (s0 + j >= p.nsplit) continue;
          if (s0 + j == 0) {
            lo = v[j][0];
            hi = v[j][1];
          } else {
            lo.x += v[j][0].x; lo.y += v[j][0].y;
            lo.z += v[j][0].z; lo.w += v[j][0].w;
            hi.x += v[j][1].x; hi.y += v[j][1].y;
            hi.z += v[j][1].z; hi.w += v[j][1].w;
          }
        }
      }
      uint4 o;
      o.x = hopper::pack_bf16(lo.x, lo.y);
      o.y = hopper::pack_bf16(lo.z, lo.w);
      o.z = hopper::pack_bf16(hi.x, hi.y);
      o.w = hopper::pack_bf16(hi.z, hi.w);
      *reinterpret_cast<uint4*>(prm.out + (size_t)r * N + col) = o;
    }
    if (tid == 0) *cnt = 0;
  }
}

cudaError_t launch_stream(const void* x, const void* q, const void* s,
                          void* out, void* ws, void* counters, int M, int N,
                          int K, int nb, cudaStream_t stream) {
  using namespace dstream;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  StreamParams prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.ws = static_cast<float*>(ws);
  prm.counters = static_cast<int*>(counters);
  prm.M = M;
  prm.p = make_proj(static_cast<const float*>(s), N, K, nb, sms);
  CUtensorMap tw, tx;
  if (!weight_map(&tw, q, K, N, true) || !rows_map(&tx, x, M, K, K))
    return cudaErrorInvalidValue;
  const int alloc = Ring<true>::bytes + 1024;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = hopper::opt_in_smem(
      reinterpret_cast<const void*>(qgemm_stream), alloc, opted_in);
  if (err != cudaSuccess) return err;
  const int total = units_of(prm.p, M);
  const int grid = total < sms ? total : sms;
  qgemm_stream<<<grid, kThreads, alloc, stream>>>(tw, tx, prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   void* ws, void* counters, int M, int N, int K, int nb,
                   bool rows, cudaStream_t stream) {
  const int qblock = (N + nb - 1) / nb;
  const int tn = rows ? (N + RBN - 1) / RBN : (N + BN - 1) / BN;
  const int tm = rows ? (M + RROWS - 1) / RROWS : (M + RPMAX - 1) / RPMAX;
  const int kch = (K + BK - 1) / BK;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  int nsplit, kper;
  if (rows) {
    // the stream's rule: N, K and the SM count, never M
    dstream::splits(K, N, sms, &nsplit, &kper);
  } else {
    // enough CTAs for two per SM
    nsplit = (2 * sms + tn * tm - 1) / (tn * tm);
    nsplit = max(1, min(nsplit, min(kMaxSplit, kch)));
    const int chunks = (kch + nsplit - 1) / nsplit;
    nsplit = (kch + chunks - 1) / chunks;
    kper = chunks * BK;
  }
  auto kernel = rows ? qgemm_rows_kernel<T> : qgemm_kernel<T>;
  const size_t smem =
      rows ? RowsSmem<int8_t>::bytes : TileSmem<T, int8_t>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tn, tm, nsplit);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), M, N, K, nb,
      qblock, nsplit, kper);
  return cudaGetLastError();
}

}  // namespace

// route: 0 stream (bf16 x, M <= 128, decode_stream.cuh stream_ok), 1 rows
// (M <= 128, scale groups of 8 columns or more), 2 tile; a route the shape
// does not allow is refused.  ws / counters: the wrapper's sizes per route
// (ops/kernels/qgemm.py _scratch_sizes), the counters 0.
extern "C" int ds_qgemm(const void* x, const void* q, const void* s,
                        void* out, void* ws, void* counters, int M, int N,
                        int K, int nb, int is_bf16, int route, void* stream) {
  if (M < 1 || N < 1 || K < 1 || nb < 1 || nb > N || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (!is_bf16 || M > kStreamMaxRows ||
        !dstream::stream_ok(K, N, nb, true, x, q))
      return (int)cudaErrorInvalidValue;
    return (int)launch_stream(x, q, s, out, ws, counters, M, N, K, nb, st);
  }
  const bool rows = route == 1;
  if (rows && (M > kStreamMaxRows || !use_rows(1, N, nb)))
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? (int)launch<__nv_bfloat16>(x, q, s, out, ws, counters, M,
                                              N, K, nb, rows, st)
                 : (int)launch<float>(x, q, s, out, ws, counters, M, N, K,
                                      nb, rows, st);
}
