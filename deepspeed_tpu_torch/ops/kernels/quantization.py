"""Int8 block quantization (port of
``deepspeed_tpu/ops/pallas/quantization.py``).

Symmetric per-group quantization over the last dimension: each group of
lanes shares one fp32 scale ``amax / 127`` (1.0 where the group is all
zeros), values round half-to-even and clip to +-127.  When ``BLOCK``
divides ``C`` the groups are ``BLOCK`` wide; otherwise the row splits into
``nb = ceil(C / BLOCK)`` near-equal groups of width ``ceil(C / nb)`` (the
last one ragged) — the reference's layout, so every consumer recovers the
group width from the shapes as ``ceil(C / scales.shape[-1])``.

:func:`block_quantize_int8` launches the CUDA kernel in
``csrc/quantization.cu`` for CUDA tensors (every layout, ragged included)
and takes the plain PyTorch version for CPU tensors.
:func:`block_dequantize_int8` is plain PyTorch on both: the serving path
only dequantizes outside a kernel in prefill, where a layer's weights are
rebuilt once for a torch matmul.
"""
import ctypes
import itertools

import torch

from deepspeed_tpu_torch.ops.kernels import build

BLOCK = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _layout(C: int, block: int):
    """(groups per row, group width) of the reference layout."""
    nb = -(-C // block)
    return nb, -(-C // nb)


def true_div127(amax):
    """``amax / 127`` correctly rounded on every device: PyTorch's CUDA
    division multiplies by the reciprocal of a Python-scalar divisor,
    which can land one ulp away; a tensor divisor divides."""
    return amax / torch.full_like(amax, 127.0)


def block_quantize_int8_plain(x, block: int = BLOCK):
    """Plain PyTorch version (the reference's ``_ref_quantize``): x [..., C]
    -> (q int8 [..., C], scales fp32 [..., nb])."""
    *lead, C = x.shape
    nb, gw = _layout(C, block)
    xf = x.float()
    pad = nb * gw - C
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    xb = xf.reshape(*lead, nb, gw)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, true_div127(amax), torch.ones_like(amax))
    # torch.round is half-to-even, as jnp.round
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(*lead, nb * gw)[..., :C].contiguous(), scale[..., 0]


def block_dequantize_int8(q, scales):
    """Inverse of :func:`block_quantize_int8` in fp32 (the reference's
    ``_ref_dequantize``); the group width comes from the shapes."""
    *lead, C = q.shape
    nb = scales.shape[-1]
    gw = -(-C // nb)
    qf = q.float()
    pad = nb * gw - C
    if pad:
        qf = torch.nn.functional.pad(qf, (0, pad))
    out = qf.reshape(*lead, nb, gw) * scales.float().reshape(*lead, nb, 1)
    return out.reshape(*lead, nb * gw)[..., :C]


def _lib():
    fn = build.load("quantization").ds_block_quantize_int8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def block_quantize_int8_cuda(x, block: int = BLOCK):
    """Launch the CUDA kernel; raises on anything it does not take."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"block_quantize_int8: dtype {x.dtype}; need one "
                         f"of {_DTYPES}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"block_quantize_int8: shape {tuple(x.shape)}")
    if not 1 <= block <= 256:
        raise ValueError(f"block_quantize_int8: block {block} (the kernel "
                         "takes groups of at most 256 lanes)")
    if not x.is_contiguous():
        raise ValueError("block_quantize_int8: x must be contiguous")
    *lead, C = x.shape
    nb, _ = _layout(C, block)
    R = x.numel() // C
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*lead, nb), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib()(x.data_ptr(), q.data_ptr(), s.data_ptr(), R, C, block,
                    int(x.dtype == torch.bfloat16), stream)
    build.check(rc, "block_quantize_int8")
    block_quantize_int8.launches += 1
    return q, s


def block_quantize_int8(x, block: int = BLOCK):
    """x [..., C] -> (q int8 [..., C], scales fp32 [..., ceil(C/block)]):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return block_quantize_int8_cuda(x, block)
    if x.device.type == "cpu":
        return block_quantize_int8_plain(x, block)
    raise ValueError(f"block_quantize_int8: unsupported device {x.device}")


def block_quantize_stack(shape, slice_fn, device):
    """``block_quantize_int8`` of a stacked [..., K, N] weight built one
    [K, N] slice at a time (the groups run along the last dim, so this is
    the whole stack's quantization): ``slice_fn(index)`` gives the slice
    at ``index`` (a tuple over the leading dims, visited in order) in the
    compute dtype.  Returns (q int8, scales fp32) stacks on ``device``;
    the peak is the int8 stack plus one slice."""
    nb = _layout(shape[-1], BLOCK)[0]
    q = torch.empty(shape, dtype=torch.int8, device=device)
    s = torch.empty(tuple(shape[:-1]) + (nb,), dtype=torch.float32,
                    device=device)
    for idx in itertools.product(*map(range, shape[:-2])):
        qi, si = block_quantize_int8(slice_fn(idx))
        q[idx].copy_(qi)
        s[idx].copy_(si)
    return q, s


#: kernel launches since the count was last set to 0
block_quantize_int8.launches = 0
