"""FlashAttention-2 forward with segment ids and grouped-query attention.

Port of ``deepspeed_tpu/ops/pallas/ds_flash_attention.py`` forward
(``_fwd_kernel``, launcher ``_fwd``, public ``ds_flash_attention`` and
``chunk_fwd``).  :func:`flash_attention_fwd` launches the CUDA kernel in
``csrc/ds_flash_fwd.cu`` for CUDA tensors and takes the plain PyTorch
version :func:`flash_attention_fwd_plain` for CPU tensors.  The backward
kernels belong to the training slice and are not here.

Layouts (the reference's public ones): q [B, S, H, hd], k/v
[B, S, KV, hd] (KV divides H), segment_ids None or [B, S] (a pair attends
only within one segment) -> o [B, S, H, hd] in the input dtype and
lse [B, H, S] fp32 (-1e30 for a row that sees no key).  Any S >= 1.
"""
import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 96, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_fwd_plain(q, k, v, segment_ids=None, causal=True,
                              sm_scale=None):
    """Plain PyTorch version: fp32 einsum + masked softmax, returning
    (o, lse) like the kernel."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"ds_flash_attention: q heads {H} not a multiple "
                         f"of kv heads {KV}")
    rep = H // KV
    sm = hd ** -0.5 if sm_scale is None else sm_scale
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    mask = mask[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(q.device)
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, vf)
    lse = torch.where(l > 0, m + torch.log(l_safe),
                      torch.full_like(l, NEG_INF))[..., 0]
    return o.to(q.dtype), lse


def _lib():
    lib = build.load("ds_flash_fwd")
    fn = lib.ds_flash_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd_cuda(q, k, v, segment_ids=None, causal=True,
                             sm_scale=None):
    """Launch the CUDA kernel; raises on anything it does not take.
    q/k/v may be strided views (e.g. slices of one fused qkv tensor) as
    long as the head dim is contiguous and every stride and base address
    is 16-byte aligned."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"ds_flash_attention: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"ds_flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if H % KV:
        raise ValueError(f"ds_flash_attention: q heads {H} not a multiple "
                         f"of kv heads {KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"ds_flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"ds_flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; need one of {_DTYPES}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"ds_flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"ds_flash_attention: {name} strides {t.stride()} need a "
                f"contiguous head dim and 16-byte aligned rows")
    seg_ptr = None
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()
        if segment_ids.shape != (B, S):
            raise ValueError("ds_flash_attention: segment_ids must be "
                             f"[B, S] = {(B, S)}")
        seg_ptr = segment_ids.data_ptr()
    sm = hd ** -0.5 if sm_scale is None else sm_scale
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr,
                    o.data_ptr(), lse.data_ptr(), B, S, H, KV, hd,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    int(bool(causal)), float(sm),
                    int(q.dtype == torch.bfloat16), stream)
    build.check(rc, "ds_flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, segment_ids=None, causal=True,
                        sm_scale=None):
    """(o, lse): CUDA kernel for CUDA tensors, the plain version for CPU
    tensors (the counterpart of the reference's ``chunk_fwd`` / ``_fwd``
    forward, segment ids included)."""
    if q.device.type == "cuda":
        return flash_attention_fwd_cuda(q, k, v, segment_ids, causal,
                                        sm_scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, segment_ids, causal,
                                         sm_scale)
    raise ValueError(f"ds_flash_attention: unsupported device {q.device}")


#: kernel launches since the count was last set to 0
flash_attention_fwd.launches = 0


def ds_flash_attention(q, k, v, segment_ids=None, causal=True,
                       sm_scale=None):
    """q [B, S, H, hd], k/v [B, S, KV, hd] -> o [B, S, H, hd] (forward
    only; the reference's public entry point)."""
    return flash_attention_fwd(q, k, v, segment_ids, causal, sm_scale)[0]
