// Fused-dequant int8 GEMM: out [M, N] = x [M, K] @ dequant(q [K, N],
// scales [K, nb]), out in x's dtype.
//
// Replaces: deepspeed_tpu/ops/pallas/qgemm.py:_qgemm_kernel.
//
// What bounds it on an H100: bytes at the decode shapes (M = 8 rows
// against K x N int8 weights: ~2 flops per weight byte), operations only
// at prefill-sized M.  The weight stays int8 in device memory and is read
// once per row tile.  Two paths (csrc/gemm_tile.cuh), both dequantizing
// an element as (float)q * scale rounded to x's dtype (the reference's
// cast point) and accumulating in fp32:
//  - decode, M <= 8 (rows_mma): the int8 rows stream straight into
//    registers, 8 bytes a lane and 8 rows in flight per warp, against x
//    staged in shared memory; fmaf, no tensor cores (a [8 x K] @ [K x N]
//    product does ~2 flops per weight byte);
//  - otherwise (tile_mma): [64 x 64] int8 chunks land in shared memory by
//    cp.async with their x chunk (three in flight), are dequantized
//    there and feed wmma bf16 m16n16k16 (fmaf for fp32 x: no TF32); rows
//    pad to 16.
// A skinny problem has too few output tiles to keep enough bytes in
// flight, so K splits across up to kMaxSplit (tile) or kRowsMaxSplit
// (decode) CTAs per tile; each writes its fp32 partial to a workspace
// and the last to arrive (an atomic per-tile counter, reset by that CTA)
// sums the partials in split order and writes the tile: one launch,
// deterministic, and the split depends only on N, K and the path, so a
// row's result is the same at M = 1 and M = 8.  Columns past N and the
// ragged last scale group enter as zeros.
//
// C interface (loaded with ctypes): ds_qgemm returns the cudaError_t of
// the launch as an int.
#include "gemm_tile.cuh"

namespace {

using namespace dstile;
constexpr int kMaxSplit = 8;       // K splits of the tile path
constexpr int kRowsMaxSplit = 16;  // K splits of the decode (rows) path
static_assert(kMaxSplit <= kRowsMaxSplit, "sum_splits bound");

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

// decode path (M <= RROWS): grid (N / RBN, 1, nsplit)
template <typename T>
__global__ void __launch_bounds__(NT)
qgemm_rows_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ s, T* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int M,
                  int N, int K, int nb, int qblock, int nsplit, int kper) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * RBN;
  const int split = blockIdx.z;
  const int k_begin = split * kper;
  const int k_end = min(K, k_begin + kper);
  const float* ct = rows_mma<T, int8_t>(x, K, M, q, s, nb, qblock, N, n0,
                                        k_begin, k_end, smem);
  finish_tile<T>(ct, RBN, M, RROWS, RBN, 0, n0, N, out, ws, counters,
                 blockIdx.x, split, nsplit);
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   void* ws, void* counters, int M, int N, int K, int nb,
                   cudaStream_t stream) {
  const int qblock = (N + nb - 1) / nb;
  const bool rows = use_rows(M, N, nb);
  const int tn = rows ? (N + RBN - 1) / RBN : (N + BN - 1) / BN;
  const int tm = rows ? 1 : (M + RPMAX - 1) / RPMAX;
  const int kch = (K + BK - 1) / BK;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  // enough CTAs for two per SM on the tile path, one wave of one per SM
  // on the decode path (its registers allow one), no split without a BK
  // chunk of work; the split depends on N, K and the path only, so a
  // row's result does not depend on the other rows
  int nsplit = rows ? sms / (tn * tm) : (2 * sms + tn * tm - 1) / (tn * tm);
  nsplit = max(1, min(nsplit, min(rows ? kRowsMaxSplit : kMaxSplit, kch)));
  const int chunks = (kch + nsplit - 1) / nsplit;
  nsplit = (kch + chunks - 1) / chunks;
  const int kper = chunks * BK;
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

extern "C" int ds_qgemm(const void* x, const void* q, const void* s,
                        void* out, void* ws, void* counters, int M, int N,
                        int K, int nb, int is_bf16, void* stream) {
  if (M < 1 || N < 1 || K < 1 || nb < 1 || nb > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)launch<__nv_bfloat16>(x, q, s, out, ws, counters,
                                              M, N, K, nb, st)
                 : (int)launch<float>(x, q, s, out, ws, counters, M, N, K,
                                      nb, st);
}
