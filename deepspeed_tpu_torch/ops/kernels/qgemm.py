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
tensors and takes :func:`qgemm_plain` for CPU tensors.  The kernel has
three forms, picked by :func:`qgemm_route` from the shape alone: the
decode weight stream (``csrc/decode_stream.cuh``: bf16 rows, M <= 128,
TMA-aligned shapes), 8-row blocks of the register-streamed decode tile
(fp32 rows or off the stream's alignment, M <= 128), and the [64 x 64]
tile (M > 128, counted apart in ``qgemm.tile_launches``).  The first two
split K by N, K and the SM count only (:func:`stream_splits`) and never
add one row into another, so a row's bits are the same at every M up to
128; :func:`qgemm_stream_walk` walks that decomposition in plain torch.
"""
import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels.quantization import \
    block_dequantize_int8

_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's split-K workspace holds this many fp32 partial tiles per
#: output tile: [64 x 64] tiles (csrc/qgemm.cu kMaxSplit) or, for the
#: decode forms, [8 x 256] tiles (kRowsMaxSplit, decode_stream.cuh
#: kMaxSplit)
MAX_SPLIT = 8
ROWS_MAX_SPLIT = 16
#: the decode forms' shape (csrc/decode_stream.cuh): 256 columns and 64 K
#: rows a stage, 8 rows a pass, 32-row groups, at most 8 scale groups a
#: 256-column unit; M above STREAM_MAX_ROWS takes the tile form
STREAM_BN, STREAM_BK, STREAM_PASS, STREAM_GROUP_ROWS = 256, 64, 8, 32
STREAM_GMAX = 8
STREAM_MAX_ROWS = 128
#: C route codes of ds_qgemm
ROUTES = {"stream": 0, "rows": 1, "tile": 2}


def stream_splits(K, N, sms):
    """(nsplit, kper) of an N-column projection over K on ``sms``
    multiprocessors: the decode forms' K split (``decode_stream.cuh``
    splits), by N, K and the SM count only."""
    tiles = -(-N // STREAM_BN)
    kch = -(-K // STREAM_BK)
    s = max(1, min(sms // tiles, ROWS_MAX_SPLIT, kch))
    chunks = -(-kch // s)
    return -(-kch // chunks), chunks * STREAM_BK


def groups_met(N, qblock):
    """The most scale groups of ``qblock`` columns a 256-column unit of an
    N-column weight meets."""
    return max((min(n0 + STREAM_BN, N) - 1) // qblock - n0 // qblock + 1
               for n0 in range(0, N, STREAM_BN))


def stream_ok(K, N, nb, int8=True, aligned=True):
    """Whether the decode weight stream takes a [*, K] @ [K, N] product of
    bf16 rows (``decode_stream.cuh`` stream_ok): 16-byte row strides for
    TMA, 16-byte aligned bases, int8 with at most STREAM_GMAX scale groups
    a 256-column unit."""
    if K < 1 or N < 1 or K % 8 or not aligned:
        return False
    if not int8:
        return N % 8 == 0
    if N % 16 or not 1 <= nb <= N:
        return False
    return groups_met(N, -(-N // nb)) <= STREAM_GMAX


def qgemm_route(M, K, N, nb, dtype, aligned=True):
    """The form ``ds_qgemm`` runs for M rows of ``dtype`` against a [K, N]
    int8 weight with ``nb`` scale groups: "stream" (bf16, M <= 128, the
    stream's shapes), "rows" (M <= 128, groups of 8 columns or more) or
    "tile"."""
    if M > STREAM_MAX_ROWS:
        return "tile"
    if dtype == torch.bfloat16 and stream_ok(K, N, nb, True, aligned):
        return "stream"
    if -(-N // nb) >= 8:
        return "rows"
    return "tile"


def _scratch_sizes(route, M, K, N):
    """(workspace floats, counters) a launch of ``route`` needs."""
    if route == "stream":
        groups = -(-M // STREAM_GROUP_ROWS)
        return ROWS_MAX_SPLIT * M * N, groups * -(-N // STREAM_BN)
    if route == "rows":
        tiles = -(-N // STREAM_BN) * -(-M // STREAM_PASS)
        return ROWS_MAX_SPLIT * tiles * STREAM_PASS * STREAM_BN, tiles
    tiles = -(-N // 64) * -(-M // 64)
    return MAX_SPLIT * tiles * 64 * 64, tiles


def qgemm_plain(x, q, scales):
    """Plain PyTorch version (the reference's ``_ref_qgemm``): dequantize
    in fp32, round to x's dtype, matmul."""
    return x @ block_dequantize_int8(q, scales).to(x.dtype)


def _lib():
    fn = build.load("qgemm").ds_qgemm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(device, *args):
    """ds_qgemm on ``device``'s current stream -> its cudaError_t."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return _lib()(*args, stream)


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
    aligned = x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    route = qgemm_route(M, K, N, nb, x.dtype, aligned)
    ws, counters = build.scratch(x.device, *_scratch_sizes(route, M, K, N))
    rc = _launch(x.device, x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), counters.data_ptr(), M, N, K,
                 nb, int(x.dtype == torch.bfloat16), ROUTES[route])
    build.check(rc, "qgemm")
    qgemm.launches += 1
    if route == "tile":
        qgemm.tile_launches += 1
    return out


def qgemm_stream_walk(x, q, scales, sms):
    """The decode forms' decomposition of qgemm in plain torch (x [M, K],
    M <= 128): :func:`decode_walk` against the weights dequantized and
    rounded to x's dtype."""
    return decode_walk(x, block_dequantize_int8(q, scales).to(x.dtype), sms)


def decode_walk(x, w, sms):
    """The decode forms' decomposition in plain torch (x [M, K], w [K, N]
    as the products see it): each K split's products over its range, for
    every 8-row pass as a fixed [8, kper] @ [kper, 256] product of fp32
    values, the splits' partials added in split order from the first,
    then rounded to x's dtype.  Shapes do not change with M, so neither
    do a row's bits."""
    M, K = x.shape
    N = w.shape[1]
    nsplit, kper = stream_splits(K, N, sms)
    w = w.float()
    xf = x.float()
    out = torch.zeros(M, N, dtype=torch.float32)
    for r0 in range(0, M, STREAM_PASS):
        rows = xf.new_zeros(STREAM_PASS, K)
        rows[:min(STREAM_PASS, M - r0)] = xf[r0:r0 + STREAM_PASS]
        for n0 in range(0, N, STREAM_BN):
            wt = w.new_zeros(K, STREAM_BN)
            wt[:, :min(STREAM_BN, N - n0)] = w[:, n0:n0 + STREAM_BN]
            acc = None
            for sp in range(nsplit):
                k0, k1 = sp * kper, min(K, (sp + 1) * kper)
                part = rows[:, k0:k1] @ wt[k0:k1]
                acc = part if acc is None else acc + part
            n = min(STREAM_BN, N - n0)
            out[r0:r0 + STREAM_PASS, n0:n0 + n] = \
                acc[:min(STREAM_PASS, M - r0), :n]
    return out.to(x.dtype)


def qgemm(x, q, scales):
    """``x [..., K] @ dequant(q [K, N], scales)`` -> [..., N] in x's
    dtype: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cuda":
        return qgemm_cuda(x, q, scales)
    if x.device.type == "cpu":
        return qgemm_plain(x, q, scales)
    raise ValueError(f"qgemm: unsupported device {x.device}")


#: kernel launches since the count was last set to 0, and those of the
#: tile form (M > 128; none on a decode path)
qgemm.launches = 0
qgemm.tile_launches = 0
