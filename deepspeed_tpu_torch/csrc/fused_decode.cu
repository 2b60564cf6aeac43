// Fused per-layer decode step: the C entry points.  The kernel, its
// launch and what it computes are in csrc/fused_decode.cuh; its eight
// (compute, weight, cache) dtype instances are compiled on their own from
// csrc/fused_decode_layer.cu and linked with this file into one library
// (ops/kernels/build.py PARTS).
//
// Replaces: deepspeed_tpu/ops/pallas/fused_decode.py:_fused_kernel.
#include "fused_decode.cuh"

#define DS_FUSED_INSTANCE(T, WT, CT)                                   \
  extern template int ds_fused_launch<T, WT, CT>(const FusedArgs&, \
                                                 cudaStream_t);
DS_FUSED_INSTANCE(float, float, float)
DS_FUSED_INSTANCE(float, float, int8_t)
DS_FUSED_INSTANCE(float, int8_t, float)
DS_FUSED_INSTANCE(float, int8_t, int8_t)
DS_FUSED_INSTANCE(__nv_bfloat16, __nv_bfloat16, __nv_bfloat16)
DS_FUSED_INSTANCE(__nv_bfloat16, __nv_bfloat16, int8_t)
DS_FUSED_INSTANCE(__nv_bfloat16, int8_t, __nv_bfloat16)
DS_FUSED_INSTANCE(__nv_bfloat16, int8_t, int8_t)
#undef DS_FUSED_INSTANCE

namespace {

template <typename T>
int dispatch_t(const FusedArgs& a, int w_int8, int c_int8, cudaStream_t st) {
  if (w_int8)
    return c_int8 ? ds_fused_launch<T, int8_t, int8_t>(a, st)
                  : ds_fused_launch<T, int8_t, T>(a, st);
  return c_int8 ? ds_fused_launch<T, T, int8_t>(a, st)
                : ds_fused_launch<T, T, T>(a, st);
}

// the projections' shapes agree with the spec fields
bool shapes_ok(const FusedArgs& a) {
  const int Dq = a.H * a.HD, Dk = a.KV * a.HD;
  if (a.nqkv == 1) {
    if (a.qkv[0].N != Dq + 2 * Dk) return false;
  } else if (a.nqkv != 3 || a.qkv[0].N != Dq || a.qkv[1].N != Dk ||
             a.qkv[2].N != Dk) {
    return false;
  }
  if (a.headmajor && (a.nqkv != 1 || a.KV != a.H)) return false;
  if (a.o.N != a.D) return false;
  const int want_in = a.mlp == kMlpNone ? 0 : (a.mlp == kMlpSwiglu ? 2 : 1);
  if (a.nmlp_in != want_in) return false;
  if (want_in == 0) return true;
  if (a.mlp_in[0].N < 1 || a.mlp_out.N != a.D) return false;
  return want_in == 1 || a.mlp_in[1].N == a.mlp_in[0].N;
}

}  // namespace

extern "C" int ds_fused_layer_args_size() { return (int)sizeof(FusedArgs); }

extern "C" int ds_fused_layer(const FusedArgs* args, int is_bf16, int w_int8,
                              int c_int8, void* stream) {
  const FusedArgs& a = *args;
  if (a.B < 1 || a.W < 1 || a.KV < 1 || a.H % a.KV != 0 || a.HD < 1 ||
      a.HD > kHDMax || a.D < 1 || a.S_max < 1 || a.norm < 0 || a.norm > 1 ||
      a.mlp < 0 || a.mlp > kMlpNone ||
      (a.rope != nullptr && (a.rot < 2 || a.rot > a.HD || a.rot % 2)) ||
      !shapes_ok(a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_t<__nv_bfloat16>(a, w_int8, c_int8, st)
                 : dispatch_t<float>(a, w_int8, c_int8, st);
}
