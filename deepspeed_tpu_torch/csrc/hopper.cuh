// Hopper (sm_90a) building blocks shared by the port's kernels: shared
// memory addresses, mbarriers, TMA tensor loads and stores and the
// host-side tensor map encoder and its cache, a persistent grid's tile
// order and launch set-up, wgmma matrix descriptors, the wgmma fence /
// commit / wait trio, register hand-off between warpgroups (setmaxnreg)
// and the wgmma instructions themselves (bf16 or fp16 in, fp32
// accumulate; the element type a template argument, bf16 by default).  Raw
// PTX, written from the PTX ISA's descriptions of these instructions;
// used by csrc/ds_flash_fwd.cu, csrc/ds_flash_bwd.cu,
// csrc/grouped_gemm_hopper.cu, csrc/grouped_gemm_stream.cu and
// csrc/block_sparse_attention.cu, and (its acquire-release add only) by
// csrc/decode_attention.cu.
//
// Layout convention (what smem_desc's users assume): a bf16 operand tile
// is staged by TMA in chunks of W columns (W * 2 bytes = the swizzle span:
// W 64 with CU_TENSOR_MAP_SWIZZLE_128B, W 32 with _64B), one chunk after
// another, each chunk [rows][W] with W * 2-byte rows and every chunk
// 1024-byte aligned.
//   - K-major operand (the contracted dim is the chunked one, e.g. q and k
//     in q k^T): 8-row groups are 8 * W * 2 bytes apart (SBO); the k16
//     slices of a chunk start 32 bytes apart; the next chunk carries the
//     next W of the contracted dim.
//   - MN-major operand (rows are the contracted dim, e.g. v in p v, read
//     through the descriptor's transpose bit): 8-row groups of the
//     contracted dim are SBO apart as above, the W-column chunks of the
//     output dim one chunk apart (LBO), and a k16 slice is 16 rows.
#pragma once
#include <cuda.h>   // CUtensorMap and its enums (types only; no libcuda link)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <type_traits>

namespace hopper {

// The 16-bit element types the wgmma helpers take: bf16 and fp16 share
// every layout and differ in the instruction's type string, the packing
// conversion and the tensor map's data type.
template <typename T>
constexpr bool kIsF16 = std::is_same<T, __half>::value;
template <typename T>
constexpr CUtensorMapDataType kMapType =
    kIsF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// ------------------------------------------------------------ addresses
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make barrier inits visible to the async proxy (TMA) and other threads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and announce `bytes` of TMA traffic that completes this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed; a phase that has
// not completed after 10 s (a lost TMA byte count, a missing arrival)
// traps, so the launch fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint32_t spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 1023) == 0) {
      const uint64_t t = globaltimer_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 10000000000ull) __trap();
    }
  }
}

// ------------------------------------------------------------------ TMA
// One box of a 4-D tensor map into shared memory; the barrier's
// transaction count drops by the box's bytes when it lands (elements past
// an extent land as zeros and count too).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, fetched from the driver at run time so that the
// library needs no link against libcuda
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a strided 4-D view of `type` elements of `elem_bytes`
// bytes: dims[0] contiguous, strides of dims 1-3 in elements (each a
// multiple of 16 bytes, the base 16-byte aligned), boxes of box0 x box1 x
// 1 x 1.  Returns false when the driver refuses it.
inline bool make_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                        int elem_bytes, const void* base,
                        const uint64_t dims[4], const long long strides[3],
                        uint32_t box0, uint32_t box1,
                        CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  cuuint64_t gstride[3];
  for (int i = 0; i < 3; ++i) {
    if (strides[i] < 0) return false;
    gstride[i] = static_cast<cuuint64_t>(strides[i]) * elem_bytes;
  }
  cuuint32_t box[4] = {box0, box1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(base), gdim, gstride, box,
             estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make_map_4d through a cache keyed by every field the map encodes: the
// expert stacks (one per projection and layer) and, through the caching
// allocator, the activations come back at the same addresses, and
// encoding a map costs host time on every launch.  Direct-mapped: a slot
// holds the last key that hashed to it.  One cache per library.
inline bool cached_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                          int elem_bytes, const void* base,
                          const uint64_t dims[4], const long long strides[3],
                          uint32_t box0, uint32_t box1,
                          CUtensorMapSwizzle swizzle) {
  struct Key {
    const void* base;
    long long fields[12];   // type, swizzle, dims, strides, boxes
  };
  constexpr int kSlots = 1024;   // a power of two
  static std::mutex mu;
  static Key keys[kSlots];
  static bool full[kSlots];
  static CUtensorMap maps[kSlots];
  Key k{base,
        {(long long)type, (long long)swizzle, (long long)dims[0],
         (long long)dims[1], (long long)dims[2], (long long)dims[3],
         strides[0], strides[1], strides[2], (long long)box0,
         (long long)box1, elem_bytes}};
  uint64_t h = reinterpret_cast<uint64_t>(base);
  for (long long f : k.fields)
    h = (h ^ static_cast<uint64_t>(f)) * 0x9E3779B97F4A7C15ull;
  const int slot = (int)((h ^ (h >> 29)) & (kSlots - 1));
  std::lock_guard<std::mutex> lock(mu);
  bool hit = full[slot] && keys[slot].base == base;
  for (int i = 0; hit && i < 12; ++i) hit = keys[slot].fields[i] == k.fields[i];
  if (hit) {
    *map = maps[slot];
    return true;
  }
  if (!make_map_4d(map, type, elem_bytes, base, dims, strides, box0, box1,
                   swizzle))
    return false;
  keys[slot] = k;
  maps[slot] = *map;
  full[slot] = true;
  return true;
}

// the same over bf16 elements
inline bool make_map_bf16_4d(CUtensorMap* map, const void* base,
                             const uint64_t dims[4],
                             const long long strides[3], uint32_t box0,
                             uint32_t box1, CUtensorMapSwizzle swizzle) {
  return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                     strides, box0, box1, swizzle);
}

// the same over 16-bit elements of type T (bf16 or fp16)
template <typename T>
inline bool make_map_16_4d(CUtensorMap* map, const void* base,
                           const uint64_t dims[4], const long long strides[3],
                           uint32_t box0, uint32_t box1,
                           CUtensorMapSwizzle swizzle) {
  return make_map_4d(map, kMapType<T>, 2, base, dims, strides, box0, box1,
                     swizzle);
}

// One box from shared memory to a 4-D tensor map, as a bulk async-group
// of this thread (elements past an extent are not written); the writes
// into `src` must be fenced to the async proxy first (fence_proxy_async).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// at most N of this thread's bulk groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// at most N of this thread's bulk groups not yet complete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- persistent launches
// SMs of the current device, looked up once per device
inline cudaError_t sm_count(int* n_sm) {
  static std::atomic<int> sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  *n_sm = sms[dev & 63].load();
  if (*n_sm == 0) {
    e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms[dev & 63].store(*n_sm);
  }
  return cudaSuccess;
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device
// (the call costs host time); `opted_in` is the kernel's own bit set of
// devices done.
inline cudaError_t opt_in_smem(const void* kernel, int bytes,
                               std::atomic<unsigned long long>& opted_in) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted_in.load() & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    opted_in.fetch_or(bit);
  }
  return cudaSuccess;
}

// The n-th output tile of this CTA in a persistent grid over n_tiles =
// n_levels x bh_count tiles, t = level * bh_count + (batch, head) with
// level 0 the longest (n_tiles or more: none left), in one of two orders:
//   - by level (paired 0): in round n the CTAs take the next gridDim.x
//     tiles, in odd rounds in mirrored order, so the work each CTA walks
//     evens out.  For grids of about one round, where every SM should
//     start on a long tile;
//   - by (batch, head) (paired 1): units of work go round robin; a unit
//     is one tile, or when causal the pair of levels L and n_levels - 1 -
//     L, whose work adds up the same for every L (causal needs n_levels
//     even).  Units of one head are adjacent, so the CTAs running at
//     once share few heads' streamed tensors, and those stay in L2.
__device__ __forceinline__ int persistent_tile(int n, int paired,
                                               int causal, int n_levels,
                                               int n_tiles) {
  const int g = gridDim.x;
  const int c = blockIdx.x;
  if (!paired) return n * g + ((n & 1) ? g - 1 - c : c);
  const int bh_count = n_tiles / n_levels;
  const int per = causal ? 2 : 1;
  const int units = causal ? n_levels / 2 : n_levels;   // per (b, head)
  const int k = n / per;
  const int u = c + k * g;
  const int bh = u / units;
  if (bh >= bh_count) return n_tiles;
  const int l = u - bh * units;
  const int level = (n - k * per) == 0 ? l : n_levels - 1 - l;
  return level * bh_count + bh;
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a tile staged with a `swizzle`-byte
// swizzle (128, 64 or 32: layout types 1, 2, 3): start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of a wgmma operand
// register across the asynchronous product (CUTLASS's fence_operand).
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}
template <typename T, int N, int M>
__device__ __forceinline__ void fence_regs(T (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

// named barriers (ids 1-15; 0 is __syncthreads): sync waits for
// `threads` arrivals including its own, arrive only counts
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// hand registers from this warpgroup to the others / take them
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// 2^x on the special function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// two floats as an fp16 pair, the first in the low half (round to
// nearest; beyond 65504 inf, as a cast to fp16 gives)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the pair in T (bf16 or fp16)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<T>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// wgmma instructions, m64nNk16, bf16 (or, where a helper takes T, fp16)
// inputs, fp32 accumulators.  The
// accumulator fragment of thread t (warp w = t / 32 of the warpgroup, lane
// l): d[4 j + e] holds (row 16 w + l / 4, column 8 j + 2 (l % 4) + e) for
// e < 2 and row + 8 for e >= 2.  scale_d = 0 overwrites D.  A register A
// operand of one k16 slice is that same fragment of a [64 x 16] tile
// packed in pairs of the input type: {d[0,1], d[2,3], d[4,5], d[6,7]} of
// columns 0-15.
//
// An m64nN instruction takes N / 2 accumulators a thread, operands %0 ..
// %(N / 2 - 1) of the asm; the operands after them are numbered by hand
// in each use below.
#define HOPPER_ACC8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC32 \
  HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
#define HOPPER_ACC40 HOPPER_ACC32, HOPPER_ACC8(32)
#define HOPPER_ACC48 HOPPER_ACC40, HOPPER_ACC8(40)
#define HOPPER_ACC64 HOPPER_ACC48, HOPPER_ACC8(48), HOPPER_ACC8(56)
#define HOPPER_ACC128                                                  \
  HOPPER_ACC64, HOPPER_ACC8(64), HOPPER_ACC8(72), HOPPER_ACC8(80),     \
      HOPPER_ACC8(88), HOPPER_ACC8(96), HOPPER_ACC8(104), HOPPER_ACC8(112), \
      HOPPER_ACC8(120)
#define HOPPER_REG32                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, " \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_REG40 HOPPER_REG32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define HOPPER_REG48 HOPPER_REG40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_REG64                                            \
  HOPPER_REG48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
               "%57, %58, %59, %60, %61, %62, %63"
#define HOPPER_REG128 HOPPER_REG64 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75" \
  ", %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87" \
  ", %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99" \
  ", %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111" \
  ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123" \
  ", %124, %125, %126, %127"

// D[64 x N] (+)= A[64 x 16] B[16 x N]: NACC = N / 2 accumulators, then
// a[0..3] as operands A .. A + 3, db as A + 4 and scale_d as A + 5 (A =
// NACC); A in registers, B MN-major in shared memory (read through the
// descriptor's transpose bit); TY the input type's string ("bf16", "f16")
#define HOPPER_WGMMA_RS(N, NACC, A0, A1, A2, A3, DB, SC, TY)               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N                     \
               "k16.f32." TY "." TY " {" HOPPER_REG##NACC "}, {%" #A0       \
               ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB                     \
               ", p, 1, 1, 1;\n}\n"                                       \
               : HOPPER_ACC##NACC                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(scale_d))

// D[64 x N] (+)= A[64 x 16] B[16 x N], both K-major in shared memory:
// NACC = N / 2 accumulators, then da, db and scale_d as operands NACC ..
// NACC + 2
#define HOPPER_WGMMA_SS(N, NACC, DA, DB, SC, TY)                           \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " {" HOPPER_REG##NACC "}, %" #DA ", %" #DB                 \
               ", p, 1, 1, 0, 0;\n}\n"                                    \
               : HOPPER_ACC##NACC                                         \
               : "l"(da), "l"(db), "r"(scale_d))

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both K-major in shared memory
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                  uint64_t da, uint64_t db,
                                                  int scale_d) {
  if constexpr (kIsF16<T>)
    HOPPER_WGMMA_SS(128, 64, 64, 65, 66, "f16");
  else
    HOPPER_WGMMA_SS(128, 64, 64, 65, 66, "bf16");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both K-major in shared memory
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  if constexpr (kIsF16<T>)
    HOPPER_WGMMA_SS(64, 32, 32, 33, 34, "f16");
  else
    HOPPER_WGMMA_SS(64, 32, 32, 33, 34, "bf16");
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], both in shared memory; TA /
// TB 1: that operand MN-major, read through the descriptor's transpose
// bit (0: K-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128],
                                                  uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" HOPPER_REG128
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : HOPPER_ACC128
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] for N = 64, 80, 96, 128 (the head
// dims), A in registers, B MN-major in shared memory, inputs in T
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 80 || N == 96 || N == 128,
                "wgmma_m64k16_rs: N is 64, 80, 96 or 128");
  constexpr bool h = kIsF16<T>;
  if constexpr (N == 64) {
    if constexpr (h) HOPPER_WGMMA_RS(64, 32, 32, 33, 34, 35, 36, 37, "f16");
    else HOPPER_WGMMA_RS(64, 32, 32, 33, 34, 35, 36, 37, "bf16");
  } else if constexpr (N == 80) {
    if constexpr (h) HOPPER_WGMMA_RS(80, 40, 40, 41, 42, 43, 44, 45, "f16");
    else HOPPER_WGMMA_RS(80, 40, 40, 41, 42, 43, 44, 45, "bf16");
  } else if constexpr (N == 96) {
    if constexpr (h) HOPPER_WGMMA_RS(96, 48, 48, 49, 50, 51, 52, 53, "f16");
    else HOPPER_WGMMA_RS(96, 48, 48, 49, 50, 51, 52, 53, "bf16");
  } else {
    if constexpr (h) HOPPER_WGMMA_RS(128, 64, 64, 65, 66, 67, 68, 69, "f16");
    else HOPPER_WGMMA_RS(128, 64, 64, 65, 66, 67, 68, 69, "bf16");
  }
}

// ---------------------------------------- attention backward products
// A consumer warpgroup's products against one 64-row streamed tile, head
// dim HD staged in CH-column chunks (CH * 2-byte swizzled rows, as above);
// shared by csrc/ds_flash_bwd.cu and csrc/block_sparse_attention.cu.

// d[64 x 64] = A[64 resident rows] B[64 streamed rows]^T, both K-major,
// HD / 16 k-slices, A's chunks A_CHUNK bytes apart and B's B_CHUNK (no
// wgmma may sit in a data-dependent branch: ptxas then serialises every
// wgmma of the kernel, C7520)
template <int HD, int CH, int A_CHUNK, int B_CHUNK,
          typename T = __nv_bfloat16>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint64_t da,
                                         const unsigned char* b_tile) {
  constexpr int ROW = CH * 2, SLICES = CH / 16;
  const uint64_t db = smem_desc(smem_u32(b_tile), 16, 8 * ROW, ROW);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off_a = (kk / SLICES) * A_CHUNK + (kk % SLICES) * 32;
    const uint32_t off_b = (kk / SLICES) * B_CHUNK + (kk % SLICES) * 32;
    wgmma_m64n64k16_ss<T>(d, da + (off_a >> 4), db + (off_b >> 4), kk > 0);
  }
}

// acc[64 x HD] += A (registers, [64 x 64]) B[streamed tile: 64 rows x HD],
// B read MN-major, 16 rows a slice, its chunks B_CHUNK bytes apart
template <int HD, int CH, int B_CHUNK, typename T = __nv_bfloat16>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* b_tile) {
  constexpr int ROW = CH * 2;
  const uint64_t db = smem_desc(smem_u32(b_tile), B_CHUNK, 8 * ROW, ROW);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64k16_rs<HD, T>(acc, a[kk], db + ((kk * 16 * ROW) >> 4), 1);
}

// a [64 x 64] tile's fp32 fragment in T (bf16 by default), laid out as
// wgmma's register A operand (k16 slice kk)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack2<T>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

// One thread's two fragment rows (row0 = 16 w + l / 4 of the warpgroup's
// 64, and row0 + 8) of a [64 x HD] fp32 accumulator, times mul, into
// head `head` of a contiguous [B, S, heads, HD] output of 16-bit T (bf16
// or fp16); rows past S dropped.
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[HD / 2],
                                           float mul, int b, int S,
                                           int heads, int head, int row0,
                                           int cq) {
  if (row0 < S) {
    T* o = out + (((size_t)b * S + row0) * heads + head) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack2<T>(acc[4 * j] * mul, acc[4 * j + 1] * mul);
  }
  if (row0 + 8 < S) {
    T* o = out + (((size_t)b * S + row0 + 8) * heads + head) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack2<T>(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// ------------------------------------------------------ split merges
// *p += v at gpu scope with acquire-release order -> the old value: a
// split's pieces each write their partial, then add one to the counter;
// the one that reads (count - 1) saw every other piece's writes
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

}  // namespace hopper
