// Int8 block quantization: x [R, C] -> q int8 [R, C], scales fp32 [R, nb].
//
// Replaces: deepspeed_tpu/ops/pallas/quantization.py:_quant_kernel (and,
// in the same kernel, the ragged layout of _ref_quantize: nb =
// ceil(C / block) groups of width gw = ceil(C / nb), the last ragged).
//
// Per group: scale = amax / 127 (1.0 where amax == 0), q = clip(rint(x /
// scale), -127, 127).  True division and rintf (round half to even, as
// jnp.round) keep the bytes identical to the reference's.
//
// What bounds it on an H100: bytes (read 2 or 4, write 1 + 4/gw per
// element, a handful of flops).  Design: one warp per (row, group); lane
// i owns the 8 consecutive elements [8i, 8i + 8) of the group (gw <= 256
// = 32 x 8), loaded as one 16-byte (bf16) or two 16-byte (fp32) vectors
// when the group is whole and aligned, element by element otherwise; the
// amax is a __shfl_xor_sync butterfly, and the 8 codes leave as one
// 8-byte store.
//
// C interface (loaded with ctypes): ds_block_quantize_int8 returns the
// cudaError_t of the launch as an int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPerLane = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v);
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(b[i]);
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long R, int C, int nb, int gw,
                bool vec) {
  const long long warp_id =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp_id >= R * nb) return;
  const int lane = threadIdx.x & 31;
  const long long row = warp_id / nb;
  const int g = (int)(warp_id - row * nb);
  const int c0 = g * gw;
  const int c_end = min(c0 + gw, C);
  const int first = c0 + lane * kPerLane;    // this lane's first column
  const T* xr = x + row * (long long)C;

  float v[kPerLane];
  if (vec && first + kPerLane <= c_end) {
    load8<T>(xr + first, v);
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      v[i] = (first + i < c_end) ? to_f(xr[first + i]) : 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = amax > 0.f ? amax / 127.f : 1.f;

  int8_t codes[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float r = fminf(fmaxf(rintf(v[i] / scale), -127.f), 127.f);
    codes[i] = (int8_t)(int)r;
  }
  int8_t* qr = q + row * (long long)C;
  if (vec && first + kPerLane <= c_end) {
    *reinterpret_cast<uint2*>(qr + first) =
        *reinterpret_cast<const uint2*>(codes);
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (first + i < c_end) qr[first + i] = codes[i];
  }
  if (lane == 0) s[row * nb + g] = scale;
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* s, long long R, int C,
                   int block, cudaStream_t stream) {
  const int nb = (C + block - 1) / block;
  const int gw = (C + nb - 1) / nb;
  // whole 8-element runs are aligned when every group starts on an
  // 8-element boundary of an aligned row (x 16 B, q 8 B)
  const bool vec = (C % kPerLane == 0) && (gw % kPerLane == 0) &&
                   ((uintptr_t)x % 16 == 0) && ((uintptr_t)q % 8 == 0);
  const long long warps = R * nb;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), R, C, nb, gw, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ds_block_quantize_int8(const void* x, void* q, void* s,
                                      long long R, int C, int block,
                                      int is_bf16, void* stream) {
  if (R < 1 || C < 1 || block < 1 || block > 32 * kPerLane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)launch<__nv_bfloat16>(x, q, s, R, C, block, st)
                 : (int)launch<float>(x, q, s, R, C, block, st);
}
