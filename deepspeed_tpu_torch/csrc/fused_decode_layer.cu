// One instance of the fused decode layer (csrc/fused_decode.cuh), chosen
// by -DDS_FUSED_BF16, -DDS_FUSED_W8 and -DDS_FUSED_C8 (0 or 1: bf16 rather
// than fp32 compute, int8 weights, an int8 cache): ops/kernels/build.py
// compiles this file once per instance, in parallel, and links the eight
// with csrc/fused_decode.cu's entry points into one library.
#include <type_traits>

#include "fused_decode.cuh"

#if !defined(DS_FUSED_BF16) || !defined(DS_FUSED_W8) || !defined(DS_FUSED_C8)
#error "fused_decode_layer.cu: set DS_FUSED_BF16, DS_FUSED_W8 and DS_FUSED_C8"
#endif

using DsFusedT =
    std::conditional_t<DS_FUSED_BF16 != 0, __nv_bfloat16, float>;
template int ds_fused_launch<
    DsFusedT, std::conditional_t<DS_FUSED_W8 != 0, int8_t, DsFusedT>,
    std::conditional_t<DS_FUSED_C8 != 0, int8_t, DsFusedT>>(
    const FusedArgs&, cudaStream_t);
