"""FlashAttention-2 forward and backward with segment ids and grouped-query
attention.

Port of ``deepspeed_tpu/ops/pallas/ds_flash_attention.py``: the forward
``_fwd_kernel`` (launcher ``_fwd``) and the backward ``_dkv_kernel`` /
``_dq_kernel`` (launcher ``_bwd_calls``, rule ``_bwd_rule``).
:func:`flash_attention_fwd` launches the CUDA kernel in
``csrc/ds_flash_fwd.cu`` and :func:`flash_attention_bwd` the two kernels in
``csrc/ds_flash_bwd.cu`` for CUDA tensors; for CPU tensors both take their
plain PyTorch versions.  :class:`DSFlashAttention` is the autograd Function
around them (the reference's ``jax.custom_vjp``): its forward saves q, k, v,
o and lse, its backward computes delta = rowsum(dO * O) and calls
:func:`flash_attention_bwd`.

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


def _repeat_kv(k, v, rep):
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    return kf, vf


def _mask(S, causal, segment_ids, device):
    """[1 or B, 1, S, S] visibility of (query, key) pairs."""
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask = torch.tril(mask)
    mask = mask[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(device)
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    return mask


def flash_attention_fwd_plain(q, k, v, segment_ids=None, causal=True,
                              sm_scale=None):
    """Plain PyTorch version: fp32 einsum + masked softmax, returning
    (o, lse) like the kernel."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"ds_flash_attention: q heads {H} not a multiple "
                         f"of kv heads {KV}")
    sm = hd ** -0.5 if sm_scale is None else sm_scale
    kf, vf = _repeat_kv(k, v, H // KV)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm
    s = s.masked_fill(~_mask(S, causal, segment_ids, q.device),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, vf)
    lse = torch.where(l > 0, m + torch.log(l_safe),
                      torch.full_like(l, NEG_INF))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, do, lse, delta, segment_ids=None,
                              causal=True, sm_scale=None):
    """Plain PyTorch version of the two backward kernels (the reference's
    ``_bwd_calls`` given lse and delta [B, H, S]) in fp32: returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    sm = hd ** -0.5 if sm_scale is None else sm_scale
    kf, vf = _repeat_kv(k, v, rep)
    qf, dof = q.float(), do.float()
    lse4 = lse.float()[..., None]
    s = torch.einsum("bqhd,bkhd->bhqk", qf * sm, kf)
    visible = _mask(S, causal, segment_ids, q.device) \
        & (lse4 > 0.5 * NEG_INF)
    p = torch.where(visible, torch.exp(s - lse4), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None]) * sm
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    if rep > 1:     # query heads of one group sum into their kv head
        dk = dk.unflatten(2, (KV, rep)).sum(3)
        dv = dv.unflatten(2, (KV, rep)).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(q, k, v):
    """The kernels' argument rules; returns (B, S, H, KV, hd)."""
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_strided(name, t, q)
    return B, S, H, KV, hd


def _check_strided(name, t, q):
    vec = 16 // q.element_size()
    if t.device != q.device:
        raise ValueError(f"ds_flash_attention: {name} on {t.device}, "
                         f"q on {q.device}")
    if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(
            f"ds_flash_attention: {name} strides {t.stride()} need a "
            f"contiguous head dim and 16-byte aligned rows")


def _segments(segment_ids, q, B, S):
    """int32 [B, S] on q's device (or None) for the kernels."""
    if segment_ids is None:
        return None
    segment_ids = segment_ids.to(device=q.device,
                                 dtype=torch.int32).contiguous()
    if segment_ids.shape != (B, S):
        raise ValueError("ds_flash_attention: segment_ids must be "
                         f"[B, S] = {(B, S)}")
    return segment_ids


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _fwd_lib():
    return bind_fwd(build.load("ds_flash_fwd"))


def bind_fwd(lib):
    """``lib``'s ``ds_flash_fwd`` (a build of csrc/ds_flash_fwd.cu) with
    its C signature set."""
    fn = lib.ds_flash_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    return bind_bwd(build.load("ds_flash_bwd"))


def bind_bwd(lib):
    """``lib`` (a build of csrc/ds_flash_bwd.cu) with the C signatures of
    ``ds_flash_bwd_dkv`` and ``ds_flash_bwd_dq`` set."""
    if lib.ds_flash_bwd_dq.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p] * 7          # q, k, v, dO, lse, delta, segment ids
        tail = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), i,
                ctypes.c_float, i, p]
        lib.ds_flash_bwd_dkv.argtypes = head + [p, p] + tail
        lib.ds_flash_bwd_dq.argtypes = head + [p] + tail
        lib.ds_flash_bwd_dkv.restype = ctypes.c_int
        lib.ds_flash_bwd_dq.restype = ctypes.c_int
    return lib


def flash_attention_fwd_cuda(q, k, v, segment_ids=None, causal=True,
                             sm_scale=None):
    """Launch the CUDA kernel; raises on anything it does not take.
    q/k/v may be strided views (e.g. slices of one fused qkv tensor) as
    long as the head dim is contiguous and every stride and base address
    is 16-byte aligned."""
    B, S, H, KV, hd = _check_qkv(q, k, v)
    seg = _segments(segment_ids, q, B, S)
    sm = hd ** -0.5 if sm_scale is None else sm_scale
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _fwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        None if seg is None else seg.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), B, S, H, KV, hd,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        int(bool(causal)), float(sm),
                        int(q.dtype == torch.bfloat16), _stream(q.device))
    build.check(rc, "ds_flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, segment_ids, causal, sm_scale):
    """Validate the backward kernels' inputs; returns the C arguments
    around the output pointers: (head, tail, (B, S, H, KV, hd))."""
    B, S, H, KV, hd = _check_qkv(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"ds_flash_attention: dO {tuple(do.shape)} "
                         f"{do.dtype} vs q {tuple(q.shape)} {q.dtype}")
    _check_strided("dO", do, q)
    rows = []
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"ds_flash_attention: {name} must be fp32 "
                             f"[B, H, S] = {(B, H, S)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
        rows.append(t.contiguous())
    seg = _segments(segment_ids, q, B, S)
    sm = hd ** -0.5 if sm_scale is None else sm_scale
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *do.stride()[:3])
    # the tensors are held by the tuples until the launch returns
    head = (q, k, v, do, *rows, seg)
    tail = (B, S, H, KV, hd, strides, int(bool(causal)), float(sm),
            int(q.dtype == torch.bfloat16))
    return head, tail, (B, S, H, KV, hd)


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _launch_dkv(head, tail, dims):
    B, S, H, KV, hd = dims
    q = head[0]
    dk = torch.empty((B, S, KV, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        rc = _bwd_lib().ds_flash_bwd_dkv(*_ptrs(head), dk.data_ptr(),
                                         dv.data_ptr(), *tail,
                                         _stream(q.device))
    build.check(rc, "ds_flash_bwd_dkv")
    flash_attention_bwd.dkv_launches += 1
    return dk, dv


def _launch_dq(head, tail, dims):
    B, S, H, KV, hd = dims
    q = head[0]
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _bwd_lib().ds_flash_bwd_dq(*_ptrs(head), dq.data_ptr(), *tail,
                                        _stream(q.device))
    build.check(rc, "ds_flash_bwd_dq")
    flash_attention_bwd.dq_launches += 1
    return dq


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, segment_ids=None,
                                 causal=True, sm_scale=None):
    """Launch the dK/dV kernel alone -> (dk, dv) in the input dtype."""
    return _launch_dkv(*_bwd_args(q, k, v, do, lse, delta, segment_ids,
                                  causal, sm_scale))


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, segment_ids=None,
                                causal=True, sm_scale=None):
    """Launch the dQ kernel alone -> dq in the input dtype."""
    return _launch_dq(*_bwd_args(q, k, v, do, lse, delta, segment_ids,
                                 causal, sm_scale))


def flash_attention_bwd_cuda(q, k, v, do, lse, delta, segment_ids=None,
                             causal=True, sm_scale=None):
    """Launch the dK/dV kernel, then the dQ kernel; raises on anything
    they do not take.  q/k/v/do follow the forward wrapper's stride rules;
    lse and delta are [B, H, S] fp32.  Returns (dq, dk, dv) in the input
    dtype."""
    args = _bwd_args(q, k, v, do, lse, delta, segment_ids, causal, sm_scale)
    dk, dv = _launch_dkv(*args)
    return _launch_dq(*args), dk, dv


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


def flash_attention_bwd(q, k, v, do, lse, delta, segment_ids=None,
                        causal=True, sm_scale=None):
    """(dq, dk, dv): the two CUDA kernels for CUDA tensors, the plain
    version for CPU tensors (the counterpart of the reference's
    ``_bwd_calls``)."""
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, do, lse, delta,
                                        segment_ids, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                         segment_ids, causal, sm_scale)
    raise ValueError(f"ds_flash_attention: unsupported device {q.device}")


#: kernel launches since the counts were last set to 0
flash_attention_fwd.launches = 0
flash_attention_bwd.dkv_launches = 0
flash_attention_bwd.dq_launches = 0


class DSFlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``_ds_flash``
    custom VJP): forward through :func:`flash_attention_fwd`, backward
    through :func:`flash_attention_bwd`.  Segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, segment_ids, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        # delta = rowsum(dO * O), [B, H, S] fp32: a plain torch op, as it
        # is an XLA op (not a Pallas kernel) in the reference
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, do.contiguous(), lse,
                                         delta, segment_ids, ctx.causal,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None, None


def ds_flash_attention(q, k, v, segment_ids=None, causal=True,
                       sm_scale=None):
    """q [B, S, H, hd], k/v [B, S, KV, hd] -> o [B, S, H, hd], the
    reference's public entry point; differentiable in q, k, v."""
    return DSFlashAttention.apply(q, k, v, segment_ids, causal, sm_scale)
