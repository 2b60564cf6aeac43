"""Fused-dequant int8 GEMM (port of ``deepspeed_tpu/ops/pallas/qgemm.py``
``ds_qgemm``): ``x @ dequant(q, scales)`` with the weight kept int8 in
device memory.

``q`` int8 [K, N] and ``scales`` fp32 [K, ceil(N / qblock)] are the
``block_quantize_int8`` layout of a [K, N] weight (one scale per group of
``qblock`` lanes along N, the last group possibly ragged; the group width
is ``ceil(N / nb)``).  Each weight tile is dequantized in fp32 and
rounded to ``x``'s dtype before the product, the product accumulates in
fp32, and the result is rounded to ``x``'s dtype — the reference's
``_ref_qgemm`` and its Pallas kernel.

:func:`qgemm` launches the CUDA kernel in ``csrc/qgemm.cu`` for CUDA
tensors and takes :func:`qgemm_plain` for CPU tensors.
"""
import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels.quantization import \
    block_dequantize_int8

_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's split-K workspace holds this many fp32 partial tiles per
#: output tile: [64 x 64] tiles (csrc/qgemm.cu kMaxSplit) or, for the
#: decode path of at most 8 rows, [8 x 256] tiles (kRowsMaxSplit)
MAX_SPLIT = 8
ROWS_MAX_SPLIT = 16


def qgemm_plain(x, q, scales):
    """Plain PyTorch version (the reference's ``_ref_qgemm``): dequantize
    in fp32, round to x's dtype, matmul."""
    return x @ block_dequantize_int8(q, scales).to(x.dtype)


def _lib():
    fn = build.load("qgemm").ds_qgemm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def qgemm_cuda(x, q, scales):
    """Launch the CUDA kernel; raises on anything it does not take."""
    if q.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"qgemm: expects a 2-D quantized weight (q "
                         f"{tuple(q.shape)}, scales {tuple(scales.shape)})")
    K, N = q.shape
    nb = scales.shape[1]
    if x.shape[-1] != K or scales.shape[0] != K or not 1 <= nb <= N:
        raise ValueError(f"qgemm: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scales {tuple(scales.shape)}")
    if x.dtype not in _DTYPES or q.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise ValueError(f"qgemm: dtypes x {x.dtype}, q {q.dtype}, scales "
                         f"{scales.dtype}; need x in {_DTYPES}, int8, fp32")
    for name, t in (("x", x), ("q", q), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"qgemm: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"qgemm: {name} must be contiguous")
    lead = x.shape[:-1]
    M = x.numel() // K if K else 0
    out = torch.empty((*lead, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    # workspace bound over both paths, and one counter per output tile
    tiles = -(-N // 64) * -(-M // 64)
    ws, counters = build.scratch(
        x.device, max(MAX_SPLIT * tiles * 64 * 64,
                      ROWS_MAX_SPLIT * -(-N // 256) * 8 * 256), tiles)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib()(x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), counters.data_ptr(), M,
                    N, K, nb, int(x.dtype == torch.bfloat16), stream)
    build.check(rc, "qgemm")
    qgemm.launches += 1
    return out


def qgemm(x, q, scales):
    """``x [..., K] @ dequant(q [K, N], scales)`` -> [..., N] in x's
    dtype: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cuda":
        return qgemm_cuda(x, q, scales)
    if x.device.type == "cpu":
        return qgemm_plain(x, q, scales)
    raise ValueError(f"qgemm: unsupported device {x.device}")


#: kernel launches since the count was last set to 0
qgemm.launches = 0
